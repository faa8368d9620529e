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

__all__ = ["gemm_ref", "gemm_batched_ref", "moe_gemm_ref", "attention_ref",
           "decode_attention_ref", "ssd_chunk_diag_ref"]

_NEG_INF = -1e30


def gemm_ref(a: torch.Tensor, b: torch.Tensor, *,
             out_dtype: Optional[torch.dtype] = None) -> torch.Tensor:
    """C = A @ B over the last two dims, fp32 accumulation, one rounding."""
    out_dtype = out_dtype or torch.promote_types(a.dtype, b.dtype)
    return torch.matmul(a.float(), b.float()).to(out_dtype)


def gemm_batched_ref(a: torch.Tensor, b: torch.Tensor, *,
                     out_dtype: Optional[torch.dtype] = None) -> torch.Tensor:
    """C[z] = A[z] @ B[z] for (Z, m, k) @ (Z, k, n), fp32 accumulation, one
    rounding (the reference's ``gemm_batched_ref``)."""
    if a.ndim != 3 or b.ndim != 3 or a.shape[0] != b.shape[0]:
        raise ValueError(
            f"gemm_batched_ref: bad shapes {tuple(a.shape)} @ {tuple(b.shape)}")
    out_dtype = out_dtype or torch.promote_types(a.dtype, b.dtype)
    return torch.bmm(a.float(), b.float()).to(out_dtype)


def moe_gemm_ref(x: torch.Tensor, w: torch.Tensor, *,
                 out_dtype: Optional[torch.dtype] = None) -> torch.Tensor:
    """(E, C, d) @ (E, d, f) — the capacity-grouped expert GEMM (the
    reference's ``moe_gemm_ref``): the batched GEMM with experts as the
    batch."""
    return gemm_batched_ref(x, w, out_dtype=out_dtype)


def attention_ref(
    q: torch.Tensor,
    k: torch.Tensor,
    v: torch.Tensor,
    *,
    causal: bool = True,
    window: Optional[int] = None,
    sm_scale: Optional[float] = None,
) -> torch.Tensor:
    """Masked softmax attention with GQA and an fp32 softmax — the
    semantics of the flash-attention kernel.  q: (B, Hq, Sq, D); k, v:
    (B, Hkv, Skv, D).  Queries are right-aligned (position Skv - Sq + row);
    ``window`` keeps keys with ``q_pos - kv_pos < window``; GQA repeats
    each kv head over its ``Hq // Hkv`` q heads; a row with no live key
    outputs 0.  Returns ``q.dtype``."""
    b, hq, sq, d = q.shape
    _, hkv, skv, _ = k.shape
    group = hq // hkv
    scale = sm_scale if sm_scale is not None else d ** -0.5
    kr = k.repeat_interleave(group, dim=1).float()
    vr = v.repeat_interleave(group, dim=1).float()
    s = torch.einsum("bhqd,bhkd->bhqk", q.float(), kr) * scale
    q_pos = (skv - sq) + torch.arange(sq, device=q.device)[:, None]
    kv_pos = torch.arange(skv, device=q.device)[None, :]
    mask = torch.ones((sq, skv), dtype=torch.bool, device=q.device)
    if causal:
        mask &= kv_pos <= q_pos
    if window is not None:
        mask &= (q_pos - kv_pos) < window
    s = torch.where(mask[None, None], s, torch.full_like(s, _NEG_INF))
    p = torch.softmax(s, dim=-1)
    p = torch.where(mask.any(dim=-1)[None, None, :, None], p,
                    torch.zeros_like(p))
    return torch.einsum("bhqk,bhkd->bhqd", p, vr).to(q.dtype)


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


def ssd_chunk_diag_ref(x: torch.Tensor, dt_a: torch.Tensor, b: torch.Tensor,
                       c: torch.Tensor) -> torch.Tensor:
    """Y_diag = (L ∘ (C B^T)) X per (bh, chunk); L[i,j] = exp(Σa_i - Σa_j)·[j<=i].

    x: (BH, C, Q, P); dt_a: (BH, C, Q) cumulative log-decay within each
    chunk; b, c: (BH, C, Q, N).  fp32 throughout, one rounding to
    ``x.dtype``.  Masked pairs are selected to 0, never multiplied by a 0/1
    mask: their exponent is positive and may overflow to inf."""
    xf, af, bf, cf = x.float(), dt_a.float(), b.float(), c.float()
    s = torch.einsum("zcqn,zckn->zcqk", cf, bf)
    q = x.shape[2]
    pos = torch.arange(q, device=x.device)
    causal = pos[None, :] <= pos[:, None]
    l_mask = torch.where(causal, torch.exp(af[..., :, None] - af[..., None, :]),
                         torch.zeros((), device=x.device))
    y = torch.einsum("zcqk,zckp->zcqp", s * l_mask, xf)
    return y.to(x.dtype)
