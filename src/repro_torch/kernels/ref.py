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
import torch.nn.functional as F

__all__ = ["gemm_ref", "gemm_batched_ref", "gemm_grouped_ref", "moe_gemm_ref",
           "attention_ref", "decode_attention_ref", "ssd_chunk_diag_ref",
           "ssd_scan_ref", "causal_conv_silu_ref"]

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


def gemm_grouped_ref(a: torch.Tensor, b: torch.Tensor, offsets: torch.Tensor,
                     *, out_dtype: Optional[torch.dtype] = None
                     ) -> torch.Tensor:
    """C[r] = A[r] @ B[e] for the rows ``offsets[e]:offsets[e+1]`` of A
    (rows sorted by expert), (R, k) @ (E, k, n) -> (R, n), fp32
    accumulation, one rounding: the ragged grouped GEMM's semantics, one
    product an expert (the offsets read on the host)."""
    if a.ndim != 2 or b.ndim != 3 or a.shape[1] != b.shape[1] \
            or tuple(offsets.shape) != (b.shape[0] + 1,):
        raise ValueError(
            f"gemm_grouped_ref: bad shapes {tuple(a.shape)} @ "
            f"{tuple(b.shape)}, offsets {tuple(offsets.shape)}")
    out_dtype = out_dtype or torch.promote_types(a.dtype, b.dtype)
    out = torch.zeros((a.shape[0], b.shape[2]), dtype=out_dtype,
                      device=a.device)
    bounds = offsets.tolist()
    for e, (lo, hi) in enumerate(zip(bounds[:-1], bounds[1:])):
        if hi > lo:
            out[lo:hi] = (a[lo:hi].float() @ b[e].float()).to(out_dtype)
    return out


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


def ssd_scan_ref(xh, dt, a, bh, ch, d_skip, chunk, diag_fn=ssd_chunk_diag_ref):
    """The chunked Mamba-2 SSD core: (B, S, H, P) -> (B, S, H, P) fp32.

    bh, ch: (B, S, H, N) per head or (B, S, G, N) once a group of H / G
    heads, which are repeated per head first (the same values, so both give
    the same bits).  ``diag_fn`` computes the within-chunk quadratic term
    (this plain version or the chunk kernel); the (N, P)-state inter-chunk
    recurrence is a loop over chunks.  Reads shapes only, never values, so
    it also runs on meta tensors."""
    bsz, s, h, pdim = xh.shape
    if bh.shape[2] != h:
        rep = h // bh.shape[2]
        bh, ch = (t.repeat_interleave(rep, dim=2) for t in (bh, ch))
    n = bh.shape[-1]
    q = min(int(chunk), s)
    nc = s // q
    da = dt * a                                               # (B, S, H)
    xdt = xh * dt[..., None]

    def to_bh(t):
        t = t.reshape(bsz, nc, q, h, -1).permute(0, 3, 1, 2, 4)
        return t.reshape(bsz * h, nc, q, t.shape[-1])

    cum_c = torch.cumsum(da.reshape(bsz, nc, q, h), dim=2)    # (B, C, Q, H)
    cum_bh = cum_c.permute(0, 3, 1, 2).reshape(bsz * h, nc, q)

    x_bh = to_bh(xdt).float()
    b_bh = to_bh(bh).float()
    c_bh = to_bh(ch).float()

    y_diag = diag_fn(x_bh, cum_bh, b_bh, c_bh)

    decay_to_end = torch.exp(cum_bh[:, :, -1:] - cum_bh)
    states = torch.einsum("zcq,zcqn,zcqp->zcnp", decay_to_end, b_bh, x_bh)
    chunk_decay = torch.exp(cum_bh[:, :, -1])                 # (BH, C)

    # State entering each chunk: h_c = decay_{c-1} · h_{c-1} + states_{c-1}.
    prev = torch.zeros((bsz * h, n, pdim), dtype=torch.float32,
                       device=xh.device)
    entering = []
    for ci in range(nc):
        entering.append(prev)
        prev = chunk_decay[:, ci, None, None] * prev + states[:, ci]
    prev_states = torch.stack(entering, dim=1)                # (BH, C, N, P)

    y_off = torch.einsum("zcqn,zcnp,zcq->zcqp", c_bh, prev_states,
                         torch.exp(cum_bh))
    y = y_diag.float() + y_off
    y = y.reshape(bsz, h, s, pdim).permute(0, 2, 1, 3)
    return y + xh.float() * d_skip[None, None, :, None]


def _causal_conv(u: torch.Tensor, w: torch.Tensor, b: torch.Tensor):
    """Depthwise causal conv along S via stacked shifts, fp32 sums, one
    rounding to ``u.dtype``.  u: (B, S, F); w: (K, F)."""
    k, s = w.shape[0], u.shape[1]
    out = torch.zeros(u.shape, dtype=torch.float32, device=u.device)
    for i in range(k):
        shift = k - 1 - i
        ui = F.pad(u, (0, 0, shift, 0))[:, :s, :]
        out = out + ui.float() * w[i].float()
    return (out + b.float()).to(u.dtype)


def causal_conv_silu_ref(x: torch.Tensor, b: torch.Tensor, c: torch.Tensor,
                         w: torch.Tensor, bias: torch.Tensor, *,
                         silu: bool = True) -> torch.Tensor:
    """SiLU of the depthwise causal conv of the Mamba-2 mixer's x (B, S, di),
    B and C (B, S, G·N) projections side by side: (B, S, di + 2·G·N) fp32.
    w: (K, F) taps, tap K − 1 on the current position; bias: (F,).  Rows
    before a sequence's start are 0; the products are summed in fp32, tap 0
    first, then the bias, rounded once to the projections' dtype, and the
    SiLU is taken in fp32 (``silu=False``: the pre-activation, in f32)."""
    u = torch.cat([x, b, c], dim=-1)
    pre = _causal_conv(u, w, bias).float()
    return F.silu(pre) if silu else pre
