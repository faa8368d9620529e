"""The BLAS seam — OpenBLAS analogue (paper Fig. 2, box 3), as a declarative
op registry.

One stable linear-algebra API that *all* higher layers call instead of raw
torch contractions.  Every op here is an :class:`~repro_torch.core.dispatch.
OffloadOp` descriptor — its cost function, kernel-eligibility predicate,
plain-torch lowering and hand-written-kernel lowering — registered with
:mod:`repro_torch.core.dispatch` at import time.  The public functions are
thin wrappers over the single :func:`~repro_torch.core.dispatch.dispatch`
path, which scores the call, resolves routing (explicit-TP plan -> kernel
-> host), threads the chosen ``device_id`` into the trace record, and runs
the winning lowering.

Backends (the reference's semantics, ``src/repro/core/blas.py``):

Host path    : plain torch on the operands' own device, fp32 accumulation.
Device path  : the same plain torch lowering, accounted as an offload with
               the three-region breakdown — a residency and accounting
               distinction, not a different chip or different math.
Kernel path  : the hand-written CUDA kernels of :mod:`repro_torch.kernels`
               (backend ``"device-kernel"``, the reference's
               ``"device-pallas"``), selected when the policy enables them
               (``use_kernels``) and the shape is eligible.  A kernel wrapper
               takes its plain version only for CPU tensors.

The descriptors carry no tensor-parallel ``plan`` yet (the reference's
shard_map forms): the distributed layer is ported last.  Ops of the
reference not yet here (``gemm_batched``, ``linear``, ``expert_matmul``,
``moe_expert_ffn``, ``ssd_scan``, ``attention``, ``syrk``,
``gemv``/``dot``/``axpy``/``scal``/``nrm2``) are listed in ROADMAP.md.
"""

from __future__ import annotations

import contextlib
from typing import Optional

import torch
import torch.nn.functional as F

from repro_torch.core import cost_model as cm
from repro_torch.core.dispatch import OffloadOp, dispatch, register
from repro_torch.core.hero import DeviceHandle, engine  # noqa: F401 (re-export seam)

__all__ = [
    "gemm",
    "matmul",
    "mlp_block",
    "qkv_project",
    "attention_math",
    "decode_attention",
    "reduce_sum",
    "reduce_mean",
    "relu",
    "silu",
    "rmsnorm_scale",
]

_KERNEL_DTYPES = (torch.float32, torch.bfloat16)
# Host attention: direct masked einsum up to this kv length (the reference's
# chunked online-softmax form beyond it belongs to full-sequence attention,
# which arrives with the flash-attention kernel).
_DIRECT_ATTN_MAX_KV = 8192
_NEG_INF = -1e30


def _kops():
    from repro_torch.kernels import ops as kops  # lazy: avoid import cycle

    return kops


def _kernel_gemm_eligible(m: int, n: int, k: int, dtype) -> bool:
    """Eligibility for the hand-written GEMM kernel — the reference's gate
    (``blas.py:93-99``) kept exactly, so trace records route identically."""
    if dtype not in _KERNEL_DTYPES:
        return False
    return min(m, n, k) >= 8


def _result_dtype(a: torch.Tensor, b: torch.Tensor, out_dtype):
    return out_dtype or torch.promote_types(a.dtype, b.dtype)


_HOST_K_PARTS = 1


@contextlib.contextmanager
def host_k_split(parts: int):
    """Within the block, the plain lowering sums each GEMM's k products as
    ``parts`` fp32 partial sums added in order: an equally valid summation
    order, for measuring how far a result moves when only the order of its
    fp32 sums changes.  The kernel lowering is untouched."""
    global _HOST_K_PARTS
    if parts < 1:
        raise ValueError(f"host_k_split needs parts >= 1, got {parts}")
    saved, _HOST_K_PARTS = _HOST_K_PARTS, parts
    try:
        yield
    finally:
        _HOST_K_PARTS = saved


def _accum_mm(a: torch.Tensor, b: torch.Tensor, out_dtype) -> torch.Tensor:
    """(..., k) @ (k, n) with fp32 accumulation and one rounding."""
    if _HOST_K_PARTS == 1:
        return torch.matmul(a.float(), b.float()).to(out_dtype)
    k = b.shape[0]
    cuts = [k * i // _HOST_K_PARTS for i in range(_HOST_K_PARTS + 1)]
    acc = torch.matmul(a[..., :cuts[1]].float(), b[:cuts[1]].float())
    for lo, hi in zip(cuts[1:-1], cuts[2:]):
        acc = acc + torch.matmul(a[..., lo:hi].float(), b[lo:hi].float())
    return acc.to(out_dtype)


def _lead(x: torch.Tensor) -> int:
    m = 1
    for d in x.shape[:-1]:
        m *= d
    return m


# ---------------------------------------------------------------------------
# Level-3 descriptors
# ---------------------------------------------------------------------------

def _gemm_dims(a, b, transpose_a, transpose_b):
    if a.ndim != 2 or b.ndim != 2:
        raise ValueError(
            f"gemm takes 2-D operands, got {tuple(a.shape)} @ {tuple(b.shape)}")
    m, k = (a.shape[1], a.shape[0]) if transpose_a else a.shape
    kb, n = (b.shape[1], b.shape[0]) if transpose_b else b.shape
    if k != kb:
        raise ValueError(
            f"gemm contraction mismatch: {tuple(a.shape)} @ {tuple(b.shape)}")
    return m, n, k


def _gemm_cost(a, b, *, transpose_a=False, transpose_b=False, out_dtype=None):
    m, n, k = _gemm_dims(a, b, transpose_a, transpose_b)
    return cm.gemm_cost(m, n, k, a.element_size())


def _gemm_eligible(a, b, *, transpose_a=False, transpose_b=False, out_dtype=None):
    m, n, k = _gemm_dims(a, b, transpose_a, transpose_b)
    return _kernel_gemm_eligible(m, n, k, a.dtype)


def _gemm_host(a, b, *, transpose_a=False, transpose_b=False, out_dtype=None):
    aa = a.T if transpose_a else a
    bb = b.T if transpose_b else b
    return _accum_mm(aa, bb, _result_dtype(a, b, out_dtype))


def _gemm_kernel(a, b, *, transpose_a=False, transpose_b=False, out_dtype=None):
    # A transpose is a stride swap: the kernel reads either layout in place.
    aa = a.T if transpose_a else a
    bb = b.T if transpose_b else b
    return _kops().kernel_lowering("gemm")(
        aa, bb, out_dtype=_result_dtype(a, b, out_dtype))


register(OffloadOp(
    name="gemm",
    cost=_gemm_cost,
    host=_gemm_host,
    kernel=_gemm_kernel,
    eligible=_gemm_eligible,
))


def _matmul_dims(x, w):
    if w.ndim != 2:
        raise ValueError(f"matmul expects 2-D rhs, got {tuple(w.shape)}")
    if x.shape[-1] != w.shape[0]:
        raise ValueError(
            f"matmul contraction mismatch: {tuple(x.shape)} @ {tuple(w.shape)}")
    k, n = w.shape
    return _lead(x), k, n


def _matmul_cost(x, w, *, out_dtype=None):
    m, k, n = _matmul_dims(x, w)
    return cm.gemm_cost(m, n, k, x.element_size())


def _matmul_eligible(x, w, *, out_dtype=None):
    m, k, n = _matmul_dims(x, w)
    return _kernel_gemm_eligible(m, n, k, x.dtype)


def _matmul_host(x, w, *, out_dtype=None):
    return _accum_mm(x, w, _result_dtype(x, w, out_dtype))


def _matmul_kernel(x, w, *, out_dtype=None):
    m, k, n = _matmul_dims(x, w)
    out = _kops().kernel_lowering("matmul")(
        x.reshape(m, k), w, out_dtype=_result_dtype(x, w, out_dtype))
    return out.reshape(*x.shape[:-1], n)


register(OffloadOp(
    name="matmul",
    cost=_matmul_cost,
    host=_matmul_host,
    kernel=_matmul_kernel,
    eligible=_matmul_eligible,
))


# ---------------------------------------------------------------------------
# mlp_block — the whole dense FFN behind one descriptor.
# ---------------------------------------------------------------------------

def _mlp_dims(x, w_up, w_down, gate, kind):
    if x.ndim < 2:
        raise ValueError(f"mlp_block needs batched input, got {tuple(x.shape)}")
    if kind not in ("swiglu", "gelu"):
        raise ValueError(f"mlp_block: unknown kind {kind!r}")
    d = x.shape[-1]
    if w_up.ndim != 2 or w_up.shape[0] != d:
        raise ValueError(
            f"mlp_block: bad up projection {tuple(x.shape)} @ {tuple(w_up.shape)}")
    d_ff = w_up.shape[1]
    if tuple(w_down.shape) != (d_ff, d):
        raise ValueError(
            f"mlp_block: bad down projection {tuple(w_down.shape)}, "
            f"want {(d_ff, d)}")
    if kind == "swiglu" and (gate is None or tuple(gate.shape) != (d, d_ff)):
        raise ValueError("mlp_block: swiglu needs a (d, d_ff) gate")
    return _lead(x), d, d_ff


def _mlp_cost(x, w_up, w_down, gate=None, b_up=None, b_down=None, *,
              kind="swiglu"):
    m, d, d_ff = _mlp_dims(x, w_up, w_down, gate, kind)
    n_mats = 3 if kind == "swiglu" else 2
    return cm.gemm_cost(m, d_ff * n_mats, d, x.element_size(), op="mlp_block")


def _mlp_eligible(x, w_up, w_down, gate=None, b_up=None, b_down=None, *,
                  kind="swiglu"):
    m, d, d_ff = _mlp_dims(x, w_up, w_down, gate, kind)
    return _kernel_gemm_eligible(m, d_ff, d, x.dtype)


def _swiglu_glue(g, u, dtype):
    # The reference's cast points (blas.py:452-455, 474): SiLU in fp32,
    # rounded to the activation dtype before the multiply.
    return F.silu(g.float()).to(dtype) * u


def _gelu_glue(h, dtype):
    return F.gelu(h.float(), approximate="tanh").to(dtype)


def _mlp_host(x, w_up, w_down, gate=None, b_up=None, b_down=None, *,
              kind="swiglu"):
    if kind == "swiglu":
        g = _accum_mm(x, gate, x.dtype)
        u = _accum_mm(x, w_up, x.dtype)
        return _accum_mm(_swiglu_glue(g, u, x.dtype), w_down, x.dtype)
    h = _accum_mm(x, w_up, x.dtype)
    if b_up is not None:
        h = h + b_up.to(h.dtype)
    y = _accum_mm(_gelu_glue(h, x.dtype), w_down, x.dtype)
    if b_down is not None:
        y = y + b_down.to(y.dtype)
    return y


def _mlp_kernel(x, w_up, w_down, gate=None, b_up=None, b_down=None, *,
                kind="swiglu"):
    m, d, d_ff = _mlp_dims(x, w_up, w_down, gate, kind)
    mm = _kops().kernel_lowering("matmul")
    xm = x.reshape(m, d)
    if kind == "swiglu":
        g = mm(xm, gate, out_dtype=x.dtype)
        u = mm(xm, w_up, out_dtype=x.dtype)
        y = mm(_swiglu_glue(g, u, x.dtype), w_down, out_dtype=x.dtype)
    else:
        h = mm(xm, w_up, out_dtype=x.dtype)
        if b_up is not None:
            h = h + b_up.to(h.dtype)
        y = mm(_gelu_glue(h, x.dtype), w_down, out_dtype=x.dtype)
        if b_down is not None:
            y = y + b_down.to(y.dtype)
    return y.reshape(*x.shape[:-1], d)


register(OffloadOp(
    name="mlp_block",
    cost=_mlp_cost,
    host=_mlp_host,
    kernel=_mlp_kernel,
    eligible=_mlp_eligible,
))


# ---------------------------------------------------------------------------
# qkv_project — the fused 3-way attention input projection.
# ---------------------------------------------------------------------------

def _qkv_dims(x, wq, wk, wv, *, bq=None, bk=None, bv=None):
    if x.ndim < 2:
        raise ValueError(f"qkv_project needs batched input, got {tuple(x.shape)}")
    d = x.shape[-1]
    for name, w in (("wq", wq), ("wk", wk), ("wv", wv)):
        if w.ndim != 2 or w.shape[0] != d:
            raise ValueError(
                f"qkv_project: bad {name} {tuple(w.shape)} for input "
                f"{tuple(x.shape)}")
    for name, w, b in (("bq", wq, bq), ("bk", wk, bk), ("bv", wv, bv)):
        if b is not None and tuple(b.shape) != (w.shape[1],):
            raise ValueError(f"qkv_project: bad bias {name} {tuple(b.shape)}")
    n = wq.shape[1] + wk.shape[1] + wv.shape[1]
    return _lead(x), d, n


def _qkv_cost(x, wq, wk, wv, *, bq=None, bk=None, bv=None):
    m, d, n = _qkv_dims(x, wq, wk, wv, bq=bq, bk=bk, bv=bv)
    return cm.gemm_cost(m, n, d, x.element_size(), op="qkv_project")


def _qkv_eligible(x, wq, wk, wv, *, bq=None, bk=None, bv=None):
    m, d, n = _qkv_dims(x, wq, wk, wv, bq=bq, bk=bk, bv=bv)
    return _kernel_gemm_eligible(m, n, d, x.dtype)


def _qkv_concat(x, wq, wk, wv, bq, bk, bv):
    # Concatenated per call, as in the reference (blas.py:538-563): exact,
    # and one GEMM instead of three.
    w = torch.cat([wq, wk, wv], dim=1)
    if bq is None and bk is None and bv is None:
        return w, None
    parts = [
        b if b is not None else torch.zeros(wt.shape[1], dtype=x.dtype,
                                            device=x.device)
        for b, wt in ((bq, wq), (bk, wk), (bv, wv))
    ]
    return w, torch.cat(parts)


def _qkv_host(x, wq, wk, wv, *, bq=None, bk=None, bv=None):
    w, b = _qkv_concat(x, wq, wk, wv, bq, bk, bv)
    y = _accum_mm(x, w, x.dtype)
    return y if b is None else y + b.to(y.dtype)


def _qkv_kernel(x, wq, wk, wv, *, bq=None, bk=None, bv=None):
    m, d, n = _qkv_dims(x, wq, wk, wv, bq=bq, bk=bk, bv=bv)
    w, b = _qkv_concat(x, wq, wk, wv, bq, bk, bv)
    y = _kops().kernel_lowering("qkv_project")(
        x.reshape(m, d), w, out_dtype=x.dtype)
    if b is not None:
        y = y + b.to(y.dtype)
    return y.reshape(*x.shape[:-1], n)


register(OffloadOp(
    name="qkv_project",
    cost=_qkv_cost,
    host=_qkv_host,
    kernel=_qkv_kernel,
    eligible=_qkv_eligible,
))


# ---------------------------------------------------------------------------
# decode_attention — one-token attention against a (possibly rolling) KV
# cache with a [lo, hi) valid-slot range.  The masked math is the host
# lowering, the flash-decode kernel (one pass over the cache) the device
# kernel lowering.
# ---------------------------------------------------------------------------

def _decode_attn_cost(q, k, v, lo, hi):
    if q.ndim != 4 or q.shape[2] != 1:
        raise ValueError(
            f"decode_attention: q must be (B, Hq, 1, D), got {tuple(q.shape)}")
    b, hq, _, d = q.shape
    if k.ndim != 4 or v.shape != k.shape or k.shape[0] != b or k.shape[3] != d:
        raise ValueError(
            f"decode_attention: bad cache {tuple(k.shape)} / {tuple(v.shape)}")
    skv = k.shape[2]
    return cm.attention_cost(b, 1, skv, hq, d, q.element_size())


def _decode_attn_eligible(q, k, v, lo, hi):
    return q.shape[-1] >= 8 and q.dtype in _KERNEL_DTYPES


def _bounds(x, b: int, device) -> torch.Tensor:
    """A scalar or (B,) slot bound as a (B,) int32 tensor on ``device``."""
    if isinstance(x, torch.Tensor):
        return x.to(device=device, dtype=torch.int32).expand(b).contiguous()
    return torch.full((b,), int(x), dtype=torch.int32, device=device)


def _decode_attn_host(q, k, v, lo, hi):
    b = q.shape[0]
    slots = torch.arange(k.shape[2], dtype=torch.int32, device=k.device)
    lo_b = _bounds(lo, b, k.device)[:, None]
    hi_b = _bounds(hi, b, k.device)[:, None]
    kv_valid = (slots >= lo_b) & (slots < hi_b)          # (B, S)
    return attention_math(q, k, v, causal=False, kv_mask=kv_valid)


def _decode_attn_kernel(q, k, v, lo, hi):
    b = q.shape[0]
    out = _kops().kernel_lowering("decode_attention")(
        q[:, :, 0, :], k, v, _bounds(lo, b, q.device), _bounds(hi, b, q.device)
    )
    return out[:, :, None, :]


register(OffloadOp(
    name="decode_attention",
    cost=_decode_attn_cost,
    host=_decode_attn_host,
    kernel=_decode_attn_kernel,
    eligible=_decode_attn_eligible,
))


# ---------------------------------------------------------------------------
# Light reductions / elementwise ops — host-only descriptors so the auto
# policy can score them and the trace sees them.
# ---------------------------------------------------------------------------

def _light_cost(op_name, flops_per_elem=2.0):
    def cost(x, *rest, **kwargs):
        return cm.vector_cost(
            op_name, x.numel(), x.element_size(), flops_per_elem
        )

    return cost


def _reduce(fn, x, axis, keepdims):
    if axis is None:                       # numpy semantics: every axis
        out = fn(x)
        return out.reshape((1,) * x.ndim) if keepdims else out
    return fn(x, dim=axis, keepdim=keepdims)


def _sum_host(x, *, axis=None, keepdims=False):
    return _reduce(torch.sum, x, axis, keepdims)


def _mean_host(x, *, axis=None, keepdims=False):
    return _reduce(torch.mean, x, axis, keepdims)


def _relu_host(x):
    return torch.relu(x)


def _silu_host(x):
    return F.silu(x.float()).to(x.dtype)


def _rmsnorm_cost(x, scale, *, eps=1e-6):
    if x.shape[-1] != scale.shape[-1]:
        raise ValueError(
            f"rmsnorm_scale: scale {tuple(scale.shape)} does not match "
            f"{tuple(x.shape)}")
    return cm.vector_cost("rmsnorm_scale", x.numel(), x.element_size(), 4.0)


def _rmsnorm_host(x, scale, *, eps=1e-6):
    xf = x.float()
    var = torch.mean(xf * xf, dim=-1, keepdim=True)
    y = xf * torch.rsqrt(var + eps)
    return (y * scale.float()).to(x.dtype)


register(OffloadOp(name="sum", cost=_light_cost("sum", 1.0), host=_sum_host,
                   host_only=True, note="light reduction (host-only)"))
register(OffloadOp(name="mean", cost=_light_cost("mean", 1.0), host=_mean_host,
                   host_only=True, note="light reduction (host-only)"))
register(OffloadOp(name="relu", cost=_light_cost("relu", 1.0), host=_relu_host,
                   host_only=True, note="light elementwise (host-only)"))
register(OffloadOp(name="silu", cost=_light_cost("silu", 4.0), host=_silu_host,
                   host_only=True, note="light elementwise (host-only)"))
register(OffloadOp(name="rmsnorm_scale", cost=_rmsnorm_cost,
                   host=_rmsnorm_host, host_only=True,
                   note="norm epilogue (host-only)"))


# ---------------------------------------------------------------------------
# Public API — thin wrappers over dispatch()
# ---------------------------------------------------------------------------

def gemm(
    a: torch.Tensor,
    b: torch.Tensor,
    *,
    transpose_a: bool = False,
    transpose_b: bool = False,
    out_dtype=None,
    handle: Optional[DeviceHandle] = None,
) -> torch.Tensor:
    """C = op(A) @ op(B) for 2-D operands, routed through the offload seam."""
    return dispatch(
        "gemm", a, b, transpose_a=transpose_a, transpose_b=transpose_b,
        out_dtype=out_dtype, handle=handle,
    )


def matmul(
    x: torch.Tensor,
    w: torch.Tensor,
    *,
    out_dtype=None,
    handle: Optional[DeviceHandle] = None,
) -> torch.Tensor:
    """General (leading-batch, k) @ (k, n) — the framework's workhorse.

    Collapses leading dims into the GEMM ``m`` dimension, exactly how a BLAS
    binding flattens a NumPy ``ndarray @ matrix``.  (The reference's
    ``tp_mode`` arrives with the distributed layer.)
    """
    return dispatch("matmul", x, w, out_dtype=out_dtype, handle=handle)


def mlp_block(
    x: torch.Tensor,
    w_up: torch.Tensor,
    w_down: torch.Tensor,
    *,
    gate: Optional[torch.Tensor] = None,
    b_up: Optional[torch.Tensor] = None,
    b_down: Optional[torch.Tensor] = None,
    kind: str = "swiglu",
    handle: Optional[DeviceHandle] = None,
) -> torch.Tensor:
    """Whole dense FFN (SwiGLU / GELU) through the offload seam: one
    dispatch for the block; the kernel path runs the projections on the
    hand-written GEMM kernel."""
    return dispatch(
        "mlp_block", x, w_up, w_down, gate, b_up, b_down, kind=kind,
        handle=handle,
    )


def qkv_project(
    x: torch.Tensor,
    wq: torch.Tensor,
    wk: torch.Tensor,
    wv: torch.Tensor,
    *,
    bq: Optional[torch.Tensor] = None,
    bk: Optional[torch.Tensor] = None,
    bv: Optional[torch.Tensor] = None,
    handle: Optional[DeviceHandle] = None,
) -> torch.Tensor:
    """Fused q/k/v input projection through the offload seam.

    Returns the concatenated ``(..., (Hq + 2·Hkv)·hd)`` projection; callers
    split and reshape into heads.  The kernel path runs one GEMM over the
    concatenated weights."""
    return dispatch(
        "qkv_project", x, wq, wk, wv, bq=bq, bk=bk, bv=bv, handle=handle
    )


def decode_attention(
    q: torch.Tensor,
    k_cache: torch.Tensor,
    v_cache: torch.Tensor,
    lo,
    hi,
    *,
    handle: Optional[DeviceHandle] = None,
) -> torch.Tensor:
    """One-token decode attention against a KV cache through the seam.

    q: (B, Hq, 1, D); caches: (B, Hkv, S_cache, D); ``lo``/``hi`` (ints, or
    scalar / (B,) int tensors) bound the valid cache slots.  Host form is
    the masked math; the kernel form streams the cache once
    (``flash_decode``).  ``handle`` pins the call to the device-resident
    cache so affinity scheduling routes decode to the data."""
    return dispatch(
        "decode_attention", q, k_cache, v_cache, lo, hi, handle=handle
    )


def attention_math(
    q: torch.Tensor,
    k: torch.Tensor,
    v: torch.Tensor,
    *,
    causal: bool = True,
    window=None,
    sm_scale: Optional[float] = None,
    kv_mask: Optional[torch.Tensor] = None,
) -> torch.Tensor:
    """Raw masked-softmax attention math (no dispatch/accounting).

    q: (B, Hq, Sq, D); k, v: (B, Hkv, Skv, D); fp32 softmax; queries align
    to the end of kv; ``kv_mask`` is (Skv,) or (B, Skv) slot validity.
    Fully masked rows output 0.  The reference's chunked form for
    Skv > 8192 with Sq > 1 arrives with full-sequence attention."""
    b, hq, sq, d = q.shape
    _, hkv, skv, _ = k.shape
    if skv > _DIRECT_ATTN_MAX_KV and sq > 1:
        raise NotImplementedError(
            "chunked host attention arrives with the flash-attention slice")
    scale = sm_scale if sm_scale is not None else d ** -0.5
    group = hq // hkv
    qf = q.float()
    kf = (k.repeat_interleave(group, dim=1) if group > 1 else k).float()
    vf = (v.repeat_interleave(group, dim=1) if group > 1 else v).float()
    s = torch.einsum("bhqd,bhkd->bhqk", qf, kf) * scale
    q_pos = (skv - sq) + torch.arange(sq, device=q.device)[:, None]
    kv_pos = torch.arange(skv, device=q.device)[None, :]
    mask = torch.ones((sq, skv), dtype=torch.bool, device=q.device)
    if causal:
        mask &= kv_pos <= q_pos
    if window is not None:
        mask &= (q_pos - kv_pos) < int(window)
    s = torch.where(mask[None, None], s, _NEG_INF)
    if kv_mask is not None:
        km = kv_mask if kv_mask.ndim == 2 else kv_mask[None]
        s = torch.where(km[:, None, None, :], s, _NEG_INF)
    p = torch.softmax(s, dim=-1)
    # fully-masked rows contribute zeros (matches the kernel semantics)
    p = torch.where(s.amax(dim=-1, keepdim=True) <= _NEG_INF * 0.5, 0.0, p)
    out = torch.einsum("bhqk,bhkd->bhqd", p, vf)
    return out.to(q.dtype)


def reduce_sum(x: torch.Tensor, *, axis=None, keepdims: bool = False) -> torch.Tensor:
    """Scored + traced sum reduction (host-only descriptor)."""
    return dispatch("sum", x, axis=axis, keepdims=keepdims)


def reduce_mean(x: torch.Tensor, *, axis=None, keepdims: bool = False) -> torch.Tensor:
    """Scored + traced mean reduction (host-only descriptor)."""
    return dispatch("mean", x, axis=axis, keepdims=keepdims)


def relu(x: torch.Tensor) -> torch.Tensor:
    return dispatch("relu", x)


def silu(x: torch.Tensor) -> torch.Tensor:
    return dispatch("silu", x)


def rmsnorm_scale(x: torch.Tensor, scale: torch.Tensor, *,
                  eps: float = 1e-6) -> torch.Tensor:
    """RMSNorm (fp32 internals) through the seam — the norm epilogue every
    block pays, visible to the trace and scoreable by the auto policy."""
    return dispatch("rmsnorm_scale", x, scale, eps=eps)
