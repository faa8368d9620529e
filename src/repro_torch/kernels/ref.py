"""Plain PyTorch versions of the hand-written kernels.

Each function is the semantic ground truth its CUDA kernel is checked
against (on the card by ``chip_smoke.py``, on the CPU by the tests against
the JAX reference), and the lowering a kernel wrapper takes for a tensor
that lies on the CPU.  They compute in fp32 and round once, like the
reference's ``jnp`` oracles (``src/repro/kernels/ref.py``).
"""

from __future__ import annotations

from typing import Optional

import torch

__all__ = ["gemm_ref", "decode_attention_ref"]

_NEG_INF = -1e30


def gemm_ref(a: torch.Tensor, b: torch.Tensor, *,
             out_dtype: Optional[torch.dtype] = None) -> torch.Tensor:
    """C = A @ B over the last two dims, fp32 accumulation, one rounding."""
    out_dtype = out_dtype or torch.promote_types(a.dtype, b.dtype)
    return torch.matmul(a.float(), b.float()).to(out_dtype)


def decode_attention_ref(
    q: torch.Tensor,
    k: torch.Tensor,
    v: torch.Tensor,
    lo: torch.Tensor,
    hi: torch.Tensor,
    *,
    sm_scale: Optional[float] = None,
) -> torch.Tensor:
    """One query token per (b, q head) against the cache, masked to slots
    ``[lo[b], hi[b])``.  q: (B, Hq, D); k, v: (B, Hkv, S, D); lo, hi: (B,)
    int.  GQA maps q head h to kv head ``h // (Hq // Hkv)``.  A row with no
    valid slot outputs 0.  Returns (B, Hq, D) in ``q.dtype``."""
    b, hq, d = q.shape
    _, hkv, s, _ = k.shape
    group = hq // hkv
    scale = sm_scale if sm_scale is not None else d ** -0.5
    qf = q.float().reshape(b, hkv, group, d)
    scores = torch.einsum("bhgd,bhsd->bhgs", qf, k.float()) * scale
    pos = torch.arange(s, device=k.device)
    mask = (pos >= lo.reshape(-1, 1)) & (pos < hi.reshape(-1, 1))   # (B, S)
    mask = mask[:, None, None, :]
    scores = torch.where(mask, scores, torch.full_like(scores, _NEG_INF))
    p = torch.softmax(scores, dim=-1)
    p = torch.where(mask.any(dim=-1, keepdim=True), p, torch.zeros_like(p))
    out = torch.einsum("bhgs,bhsd->bhgd", p, v.float())
    return out.reshape(b, hq, d).to(q.dtype)
