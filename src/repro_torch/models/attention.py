"""GQA attention block: QKV projections (BLAS seam) + RoPE/M-RoPE + KV cache.

Every contraction and the attention math itself dispatch through registered
``OffloadOp`` descriptors — ``qkv_project`` (fused 3-way input projection),
``decode_attention`` and ``matmul``.  Placement, cost and residency are
stamped on every record by the one dispatch path in
``repro_torch.core.dispatch``.

``attention_block`` (training / prefill) runs the whole sequence through
the ``attention`` descriptor, whose kernel lowering is the flash-attention
kernel.  ``causal=cfg.causal`` reaches it too: an encoder (hubert) attends
both ways.  qwen2-vl rotates by M-RoPE on (3, B, S) positions;
``cfg.position_embedding == "nope"`` (granite-4.0-h) rotates nothing, and
``cfg.attention_multiplier``, where set, is the softmax scale of both the
prefill and the decode kernel (else ``head_dim ** -0.5``).
"""

from __future__ import annotations

import os
from typing import Tuple

import torch

from repro_torch.core import blas
from repro_torch.models import layers as L
from repro_torch.obs.spans import measured

__all__ = ["init_attention", "split_qkv", "rotate_qk", "attention_block",
           "decode_attention_block"]


def init_attention(gen: torch.Generator, cfg, dtype, *, device):
    d, hd = cfg.d_model, cfg.head_dim
    hq, hkv = cfg.num_heads, cfg.num_kv_heads
    p = {
        "wq": L.init_dense(gen, d, hq * hd, dtype, device=device),
        "wk": L.init_dense(gen, d, hkv * hd, dtype, device=device),
        "wv": L.init_dense(gen, d, hkv * hd, dtype, device=device),
        "wo": L.init_dense(gen, hq * hd, d, dtype, device=device),
    }
    if cfg.qkv_bias:
        p["bq"] = torch.zeros(hq * hd, dtype=dtype, device=device)
        p["bk"] = torch.zeros(hkv * hd, dtype=dtype, device=device)
        p["bv"] = torch.zeros(hkv * hd, dtype=dtype, device=device)
    return p


def split_qkv(qkv: torch.Tensor, cfg):
    """Split the fused (..., (Hq+2·Hkv)·hd) projection into per-head q/k/v."""
    hq, hkv, hd = cfg.num_heads, cfg.num_kv_heads, cfg.head_dim
    nq, nk = hq * hd, hkv * hd
    lead = qkv.shape[:-1]
    q = qkv[..., :nq].reshape(*lead, hq, hd)
    k = qkv[..., nq: nq + nk].reshape(*lead, hkv, hd)
    v = qkv[..., nq + nk:].reshape(*lead, hkv, hd)
    return q, k, v


def _project_qkv(p, x, cfg, positions, rope_theta):
    """Fused input projection (one seam dispatch) + rotary embedding (none
    for a NoPE layer)."""
    qkv = blas.qkv_project(
        x, p["wq"], p["wk"], p["wv"],
        bq=p.get("bq"), bk=p.get("bk"), bv=p.get("bv"),
    )
    q, k, v = split_qkv(qkv, cfg)
    if cfg.position_embedding == "nope":
        return q, k, v
    return (*rotate_qk(q, k, cfg, positions, rope_theta), v)


def _sm_scale(cfg):
    """The softmax scale the descriptors take: None for ``head_dim **
    -0.5``, else ``cfg.attention_multiplier``."""
    return cfg.attention_multiplier or None


def rotate_qk(q, k, cfg, positions, rope_theta):
    """RoPE on q and k — M-RoPE on (3, B, S) positions for qwen2-vl; other
    archs take (B, S) positions, or the first stream of (3, B, S) ones.
    Under ``torch.profiler`` the pair is one ``glue:rope`` range."""
    with measured("glue", "rope"):
        if cfg.mrope:
            return (L.mrope(q, positions, rope_theta),
                    L.mrope(k, positions, rope_theta))
        pos2d = positions if positions.ndim == 2 else positions[0]
        return L.rope(q, pos2d, rope_theta), L.rope(k, pos2d, rope_theta)


def attention_block(
    p,
    x: torch.Tensor,
    cfg,
    *,
    positions: torch.Tensor,
    window=None,
    rope_theta=None,
) -> torch.Tensor:
    """Full-sequence attention (training / prefill). x: (B, S, D);
    positions: (B, S) int, or (3, B, S) for M-RoPE.  q/k/v reach the
    ``attention`` descriptor as (B, H, S, hd) transposed views (the kernel
    reads them in place).

    Under an ambient model-parallel mesh the seam resolves the TP forms as
    descriptor plans: ``qkv_project`` sequence-shards the input projection
    (one all-gather of the qkv activations), the attention runs unsharded,
    and the output projection's ``tp_mode="row"`` psums once."""
    b, s, _ = x.shape
    rope_theta = rope_theta if rope_theta is not None else cfg.rope_theta
    q, k, v = _project_qkv(p, x, cfg, positions, rope_theta)
    out = blas.attention(q.transpose(1, 2), k.transpose(1, 2),
                         v.transpose(1, 2), causal=cfg.causal, window=window,
                         sm_scale=_sm_scale(cfg))
    out = out.transpose(1, 2).reshape(b, s, cfg.num_heads * cfg.head_dim)
    # The kill-switch disables both TP forms of this block (the
    # qkv_project plan honors it inside the seam).
    tp_mode = None if os.environ.get("REPRO_DISABLE_TP_ATTN") else "row"
    return blas.matmul(out, p["wo"], tp_mode=tp_mode)


def decode_attention_block(
    p,
    x: torch.Tensor,
    cache: Tuple[torch.Tensor, torch.Tensor],
    cache_index: int,
    cfg,
    *,
    window=None,
    rope_theta=None,
) -> Tuple[torch.Tensor, Tuple[torch.Tensor, torch.Tensor]]:
    """One-token decode with a (rolling, for SWA) KV cache.

    x: (B, 1, D); cache: k/v each (B, Hkv, S_cache, hd); cache_index: int —
    number of tokens already in the cache (also the position of the new
    token).  For SWA archs ``S_cache`` is the window size and writes wrap
    (rolling buffer); positions stay absolute so RoPE is correct either way.

    Unlike the reference (a functional ``dynamic_update_slice``), the new
    k/v are written into ``cache`` in place: the caches are views into the
    stacked per-model cache, so no copy of the cache is made per step.  The
    same tensors are returned.
    """
    b, s1, _ = x.shape
    if s1 != 1:
        raise ValueError(f"decode takes one token, got x {tuple(x.shape)}")
    cache_index = int(cache_index)
    k_cache, v_cache = cache
    s_cache = k_cache.shape[2]
    rope_theta = rope_theta if rope_theta is not None else cfg.rope_theta
    lead = (3, b, 1) if cfg.mrope else (b, 1)
    positions = torch.full(lead, cache_index, dtype=torch.int32,
                           device=x.device)
    q, k, v = _project_qkv(p, x, cfg, positions, rope_theta)
    qh = q.transpose(1, 2)                             # (B, Hq, 1, hd)
    slot = cache_index % s_cache                       # rolling for SWA
    k_cache[:, :, slot, :] = k[:, 0]
    v_cache[:, :, slot, :] = v[:, 0]
    # Slot validity as a [lo, hi) range: before the first wrap only slots
    # < cache_index + 1 hold data (and a per-layer window bounds lo); after
    # wrapping every slot holds one of the most recent s_cache tokens.
    hi = min(cache_index + 1, s_cache)
    lo = 0
    if window is not None:
        unwrapped_lo = max(cache_index - int(window) + 1, 0)
        lo = 0 if cache_index >= s_cache else unwrapped_lo
    out = blas.decode_attention(qh, k_cache, v_cache, lo, hi,
                                sm_scale=_sm_scale(cfg))
    out = out.transpose(1, 2).reshape(b, 1, cfg.num_heads * cfg.head_dim)
    return blas.matmul(out, p["wo"]), (k_cache, v_cache)
