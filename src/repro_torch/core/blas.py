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
shard_map forms, ``moe_expert_ffn``'s expert-parallel plan among them):
the distributed layer is ported last, and without a mesh the reference
takes none either.
"""

from __future__ import annotations

import contextlib
from typing import Optional

import torch
import torch.nn.functional as F

from repro_torch.core import cost_model as cm
from repro_torch.core.dispatch import (OffloadOp, dispatch, dispatch_placed,
                                       register)
from repro_torch.core.hero import DeviceHandle, engine  # noqa: F401 (re-export seam)

__all__ = [
    "gemm",
    "matmul",
    "gemm_batched",
    "linear",
    "mlp_block",
    "qkv_project",
    "attention",
    "attention_math",
    "decode_attention",
    "ssd_scan",
    "moe_expert_ffn",
    "moe_expert_ffn_placed",
    "expert_matmul",
    "syrk",
    "gemv",
    "dot",
    "axpy",
    "scal",
    "nrm2",
    "reduce_sum",
    "reduce_mean",
    "relu",
    "silu",
    "rmsnorm_scale",
]

_KERNEL_DTYPES = (torch.float32, torch.bfloat16)
# Host attention: direct masked einsum up to this kv length, chunked
# online-softmax loop beyond it (keeps memory linear in Skv).
_DIRECT_ATTN_MAX_KV = 8192
_CHUNKED_ATTN_BLOCK = 1024
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
    """``torch.matmul(a, b)`` ((..., k) @ (k, n), (Z, m, k) @ (Z, k, n) or
    (m, k) @ (k,)) with fp32 accumulation (f64 operands: f64, the paper's
    dtype) and one rounding."""
    acc_t = torch.promote_types(torch.promote_types(a.dtype, b.dtype),
                                torch.float32)
    if _HOST_K_PARTS == 1:
        return torch.matmul(a.to(acc_t), b.to(acc_t)).to(out_dtype)
    k_axis = b.ndim - 2 if b.ndim > 1 else 0
    k = b.shape[k_axis]
    cuts = [k * i // _HOST_K_PARTS for i in range(_HOST_K_PARTS + 1)]
    acc = None
    for lo, hi in zip(cuts[:-1], cuts[1:]):
        part = torch.matmul(a[..., lo:hi].to(acc_t),
                            b.narrow(k_axis, lo, hi - lo).to(acc_t))
        acc = part if acc is None else acc + part
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


def _gemm_batched_dims(a, b):
    if a.ndim != 3 or b.ndim != 3 or a.shape[0] != b.shape[0]:
        raise ValueError(
            f"gemm_batched: bad shapes {tuple(a.shape)} @ {tuple(b.shape)}")
    bsz, m, k = a.shape
    _, kb, n = b.shape
    if k != kb:
        raise ValueError(
            f"gemm_batched contraction mismatch: {tuple(a.shape)} @ "
            f"{tuple(b.shape)}")
    return bsz, m, n, k


def _gemm_batched_cost(a, b, *, out_dtype=None):
    bsz, m, n, k = _gemm_batched_dims(a, b)
    return cm.gemm_cost(m, n, k, a.element_size(), batch=bsz,
                        op="gemm_batched")


def _gemm_batched_eligible(a, b, *, out_dtype=None):
    _, m, n, k = _gemm_batched_dims(a, b)
    return _kernel_gemm_eligible(m, n, k, a.dtype)


def _gemm_batched_host(a, b, *, out_dtype=None):
    return _accum_mm(a, b, _result_dtype(a, b, out_dtype))


def _gemm_batched_kernel(a, b, *, out_dtype=None):
    return _kops().kernel_lowering("gemm_batched")(
        a, b, out_dtype=_result_dtype(a, b, out_dtype))


register(OffloadOp(
    name="gemm_batched",
    cost=_gemm_batched_cost,
    host=_gemm_batched_host,
    kernel=_gemm_batched_kernel,
    eligible=_gemm_batched_eligible,
))


# ---------------------------------------------------------------------------
# expert_matmul — (E, ..., d) @ (E, d, f), experts the batch.
# ---------------------------------------------------------------------------

def _expert_dims(x, w):
    if w.ndim != 3 or x.shape[0] != w.shape[0] or x.shape[-1] != w.shape[1]:
        raise ValueError(
            f"expert_matmul: bad shapes {tuple(x.shape)} @ {tuple(w.shape)}")
    e = x.shape[0]
    m = 1
    for dim in x.shape[1:-1]:
        m *= dim
    return e, m, w.shape[1], w.shape[2]


def _expert_cost(x, w, *, out_dtype=None):
    e, m, k, n = _expert_dims(x, w)
    return cm.gemm_cost(m, n, k, x.element_size(), batch=e, op="moe_gemm")


def _expert_eligible(x, w, *, out_dtype=None):
    e, m, k, n = _expert_dims(x, w)
    return _kernel_gemm_eligible(m, n, k, x.dtype)


def _expert_host(x, w, *, out_dtype=None):
    e, m, k, n = _expert_dims(x, w)
    y = _accum_mm(x.reshape(e, m, k), w, _result_dtype(x, w, out_dtype))
    return y.reshape(*x.shape[:-1], n)


def _expert_kernel(x, w, *, out_dtype=None):
    e, m, k, n = _expert_dims(x, w)
    # The free dims fold into the GEMM's m: a copy where they are a view
    # that does not fold (the grouped MoE's transposed (E, G, C, d) buffer).
    out = _kops().kernel_lowering("moe_gemm")(
        x.reshape(e, m, k), w, out_dtype=out_dtype or x.dtype)
    return out.reshape(*x.shape[:-1], n)


register(OffloadOp(
    name="expert_matmul",
    cost=_expert_cost,
    host=_expert_host,
    kernel=_expert_kernel,
    eligible=_expert_eligible,
))


# ---------------------------------------------------------------------------
# moe_expert_ffn — the whole grouped expert FFN (gate/up/silu/down) behind
# one descriptor: the cost model sees the expert block at once.  (The
# reference's expert-parallel shard_map plan arrives with the distributed
# layer.)
# ---------------------------------------------------------------------------

def _moe_ffn_dims(x, wg, wu, wd):
    if x.ndim < 3 or wg.ndim != 3 or wu.ndim != 3 or wd.ndim != 3:
        raise ValueError(
            f"moe_expert_ffn: bad ranks {tuple(x.shape)} {tuple(wg.shape)} "
            f"{tuple(wu.shape)} {tuple(wd.shape)}")
    e, d = x.shape[0], x.shape[-1]
    f = wg.shape[2]
    if tuple(wg.shape[:2]) != (e, d) or wu.shape != wg.shape:
        raise ValueError(
            f"moe_expert_ffn: bad gate/up {tuple(wg.shape)} {tuple(wu.shape)}")
    if tuple(wd.shape) != (e, f, d):
        raise ValueError(
            f"moe_expert_ffn: bad down {tuple(wd.shape)}, want {(e, f, d)}")
    m = 1
    for dim in x.shape[1:-1]:
        m *= dim
    return e, m, d, f


def _moe_ffn_cost(x, wg, wu, wd):
    e, m, d, f = _moe_ffn_dims(x, wg, wu, wd)
    return cm.gemm_cost(m, 3 * f, d, x.element_size(), batch=e,
                        op="moe_expert_ffn")


def _moe_ffn_eligible(x, wg, wu, wd):
    e, m, d, f = _moe_ffn_dims(x, wg, wu, wd)
    return _kernel_gemm_eligible(m, f, d, x.dtype)


def _moe_ffn_host(x, wg, wu, wd):
    """The expert FFN math itself, fp32 accumulation, with the reference's
    cast points (``_moe_ffn_local``)."""
    e, m, d, f = _moe_ffn_dims(x, wg, wu, wd)
    xe = x.reshape(e, m, d)
    g = _accum_mm(xe, wg, x.dtype)
    u = _accum_mm(xe, wu, x.dtype)
    y = _accum_mm(_swiglu_glue(g, u, x.dtype), wd, x.dtype)
    return y.reshape(x.shape)


def _moe_ffn_kernel(x, wg, wu, wd):
    """Three launches of the batched GEMM kernel (gate, up, down), the
    SiLU·up product between them."""
    e, m, d, f = _moe_ffn_dims(x, wg, wu, wd)
    mm = _kops().kernel_lowering("moe_expert_ffn")
    xe = x.reshape(e, m, d)   # copies a transposed (E, G, C, d) view
    g = mm(xe, wg, out_dtype=x.dtype)
    u = mm(xe, wu, out_dtype=x.dtype)
    y = mm(_swiglu_glue(g, u, x.dtype), wd, out_dtype=x.dtype)
    return y.reshape(x.shape)


register(OffloadOp(
    name="moe_expert_ffn",
    cost=_moe_ffn_cost,
    host=_moe_ffn_host,
    kernel=_moe_ffn_kernel,
    eligible=_moe_ffn_eligible,
))


# ---------------------------------------------------------------------------
# syrk — host-only, as in the paper's build.
# ---------------------------------------------------------------------------

def _syrk_cost(a, *, out_dtype=None):
    if a.ndim != 2:
        raise ValueError(f"syrk takes a 2-D operand, got {tuple(a.shape)}")
    n, k = a.shape
    return cm.syrk_cost(n, k, a.element_size())


def _syrk_host(a, *, out_dtype=None):
    return _accum_mm(a, a.T, out_dtype or a.dtype)


register(OffloadOp(
    name="syrk",
    cost=_syrk_cost,
    host=_syrk_host,
    host_only=True,
    note="host-only (syrk.c compiled for host, per paper)",
))


# ---------------------------------------------------------------------------
# attention — full-sequence attention (training / prefill).  The masked
# math is the host lowering, the flash-attention kernel the device kernel
# lowering.
# ---------------------------------------------------------------------------

def _static_window(window) -> bool:
    """A window the kernel can take: None or a Python int.  A tensor window
    (the reference's traced per-layer scalar) takes the host path."""
    return window is None or (isinstance(window, int)
                              and not isinstance(window, bool))


def _attention_cost(q, k, v, *, causal=True, window=None, sm_scale=None,
                    kv_mask=None):
    if q.ndim != 4 or k.ndim != 4 or v.shape != k.shape:
        raise ValueError(
            f"attention: bad shapes q {tuple(q.shape)}, k {tuple(k.shape)}, "
            f"v {tuple(v.shape)}")
    b, hq, sq, d = q.shape
    _, hkv, skv, _ = k.shape
    static_window = window if _static_window(window) else None
    return cm.attention_cost(
        b, sq, skv, hq, d, q.element_size(),
        window=static_window if static_window and static_window < skv else None,
    )


def _attention_eligible(q, k, v, *, causal=True, window=None, sm_scale=None,
                        kv_mask=None):
    return (
        _static_window(window)
        and kv_mask is None
        and q.shape[-1] >= 8
        and q.dtype in _KERNEL_DTYPES
    )


def _attention_host(q, k, v, *, causal=True, window=None, sm_scale=None,
                    kv_mask=None):
    return attention_math(q, k, v, causal=causal, window=window,
                          sm_scale=sm_scale, kv_mask=kv_mask)


def _attention_kernel(q, k, v, *, causal=True, window=None, sm_scale=None,
                      kv_mask=None):
    skv = k.shape[2]
    eff_window = None if (window is None or window >= skv) else window
    return _kops().kernel_lowering("attention")(
        q, k, v, causal=causal, window=eff_window, sm_scale=sm_scale)


register(OffloadOp(
    name="attention",
    cost=_attention_cost,
    host=_attention_host,
    kernel=_attention_kernel,
    eligible=_attention_eligible,
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
# ssd_scan — the whole Mamba-2 SSD core (chunked quadratic term + inter-chunk
# state recurrence + D skip) behind one descriptor.  The within-chunk term
# is the SSD chunk kernel's work; the inter-chunk recurrence over (N, P)
# states, a loop over chunks, stays plain torch in every lowering, as the
# reference keeps its ``lax.scan`` outside the Pallas kernel.
# ---------------------------------------------------------------------------

def _ssd_dims(xh, dt, a, bh, ch, d_skip, *, chunk):
    if xh.ndim != 4:
        raise ValueError(
            f"ssd_scan: x must be (B, S, H, P), got {tuple(xh.shape)}")
    bsz, s, h, pdim = xh.shape
    n = bh.shape[-1]
    if tuple(dt.shape) != (bsz, s, h):
        raise ValueError(f"ssd_scan: dt {tuple(dt.shape)} != {(bsz, s, h)}")
    if tuple(a.shape) != (h,) or tuple(d_skip.shape) != (h,):
        raise ValueError(f"ssd_scan: a/d_skip must be ({h},)")
    if tuple(bh.shape) != (bsz, s, h, n) or tuple(ch.shape) != (bsz, s, h, n):
        raise ValueError(
            f"ssd_scan: bad B/C {tuple(bh.shape)} {tuple(ch.shape)}")
    q = min(int(chunk), s)
    if s % q:
        raise ValueError(f"ssd_scan: seq {s} not divisible by chunk {q}")
    return bsz, s, h, pdim, n, q


def _ssd_cost(xh, dt, a, bh, ch, d_skip, *, chunk):
    bsz, s, h, pdim, n, q = _ssd_dims(xh, dt, a, bh, ch, d_skip, chunk=chunk)
    return cm.gemm_cost(bsz * s, 2 * n + pdim, q, xh.element_size(), batch=h,
                        op="ssd_scan")


def _ssd_eligible(xh, dt, a, bh, ch, d_skip, *, chunk):
    bsz, s, h, pdim, n, q = _ssd_dims(xh, dt, a, bh, ch, d_skip, chunk=chunk)
    return min(pdim, n, q) >= 8 and xh.dtype in _KERNEL_DTYPES


def _ssd_scan_math(xh, dt, a, bh, ch, d_skip, chunk, diag_fn):
    """Chunked SSD core: (B, S, H, P) -> (B, S, H, P) fp32.  ``diag_fn``
    computes the within-chunk quadratic term (plain version or kernel);
    the (N, P)-state inter-chunk recurrence is a loop over chunks.  Reads
    shapes only, never values, so it also runs on meta tensors."""
    bsz, s, h, pdim = xh.shape
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


def _ssd_host(xh, dt, a, bh, ch, d_skip, *, chunk):
    from repro_torch.kernels import ref as kref  # lazy: avoid import cycle

    return _ssd_scan_math(xh, dt, a, bh, ch, d_skip, chunk,
                          kref.ssd_chunk_diag_ref)


def _ssd_kernel(xh, dt, a, bh, ch, d_skip, *, chunk):
    kernel = _kops().kernel_lowering("ssd_scan")

    def diag(x_bh, cum_bh, b_bh, c_bh):
        # The kernel takes one dtype; the log-decays are fp32 in the kernel
        # whatever they arrive in, as in the reference's Pallas kernel.
        return kernel(x_bh.contiguous(), cum_bh.float().contiguous(),
                      b_bh.contiguous(), c_bh.contiguous())

    return _ssd_scan_math(xh, dt, a, bh, ch, d_skip, chunk, diag)


register(OffloadOp(
    name="ssd_scan",
    cost=_ssd_cost,
    host=_ssd_host,
    kernel=_ssd_kernel,
    eligible=_ssd_eligible,
))


# ---------------------------------------------------------------------------
# Level-2 / Level-1 descriptors (host lowering only; still scored + routed,
# so traces show whether the decision model would offload them)
# ---------------------------------------------------------------------------

def _gemv_cost(a, x, *, out_dtype=None):
    if a.ndim != 2 or x.ndim != 1 or a.shape[1] != x.shape[0]:
        raise ValueError(
            f"gemv: bad shapes {tuple(a.shape)} @ {tuple(x.shape)}")
    m, n = a.shape
    return cm.gemv_cost(m, n, a.element_size())


def _gemv_host(a, x, *, out_dtype=None):
    return _accum_mm(a, x, _result_dtype(a, x, out_dtype))


register(OffloadOp(name="gemv", cost=_gemv_cost, host=_gemv_host))


def _dot_cost(x, y):
    if x.shape != y.shape or x.ndim != 1:
        raise ValueError(f"dot: bad shapes {tuple(x.shape)}, {tuple(y.shape)}")
    return cm.vector_cost("dot", x.shape[0], x.element_size())


def _dot_host(x, y):
    return torch.sum(x.float() * y.float()).to(x.dtype)


register(OffloadOp(name="dot", cost=_dot_cost, host=_dot_host))


def _axpy_cost(alpha, x, y):
    return cm.vector_cost("axpy", x.numel(), x.element_size())


def _axpy_host(alpha, x, y):
    return alpha * x + y


register(OffloadOp(name="axpy", cost=_axpy_cost, host=_axpy_host))


def _scal_cost(alpha, x):
    return cm.vector_cost("scal", x.numel(), x.element_size(), 1.0)


def _scal_host(alpha, x):
    return alpha * x


register(OffloadOp(name="scal", cost=_scal_cost, host=_scal_host))


def _nrm2_cost(x):
    return cm.vector_cost("nrm2", x.numel(), x.element_size())


def _nrm2_host(x):
    return torch.sqrt(torch.sum(torch.square(x.float()))).to(x.dtype)


register(OffloadOp(name="nrm2", cost=_nrm2_cost, host=_nrm2_host))


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


def gemm_batched(
    a: torch.Tensor,
    b: torch.Tensor,
    *,
    out_dtype=None,
    handle: Optional[DeviceHandle] = None,
) -> torch.Tensor:
    """(B, m, k) @ (B, k, n) batched GEMM — the hnp scheduler's stacked
    GEMMs; one launch of the batched GEMM kernel on the kernel path."""
    return dispatch("gemm_batched", a, b, out_dtype=out_dtype, handle=handle)


def linear(
    x: torch.Tensor,
    w: torch.Tensor,
    b: Optional[torch.Tensor] = None,
    *,
    out_dtype=None,
) -> torch.Tensor:
    """y = x @ w (+ b) — convenience wrapper used by every model layer."""
    y = matmul(x, w, out_dtype=out_dtype)
    if b is not None:
        y = y + b.to(y.dtype)
    return y


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


def ssd_scan(
    xh: torch.Tensor,
    dt: torch.Tensor,
    a: torch.Tensor,
    bh: torch.Tensor,
    ch: torch.Tensor,
    d_skip: torch.Tensor,
    *,
    chunk: int,
    handle: Optional[DeviceHandle] = None,
) -> torch.Tensor:
    """Whole Mamba-2 SSD core through the offload seam.

    xh: (B, S, H, P); dt: (B, S, H) fp32; a, d_skip: (H,); bh, ch:
    (B, S, H, N).  Returns the fp32 (B, S, H, P) mixer output (within-chunk
    quadratic term + inter-chunk state recurrence + D skip).  The kernel
    path runs the within-chunk term on the hand-written SSD chunk kernel
    (``ssd_chunk_diag``)."""
    return dispatch(
        "ssd_scan", xh, dt, a, bh, ch, d_skip, chunk=chunk, handle=handle
    )


def moe_expert_ffn(
    x: torch.Tensor,
    wg: torch.Tensor,
    wu: torch.Tensor,
    wd: torch.Tensor,
    *,
    handle: Optional[DeviceHandle] = None,
) -> torch.Tensor:
    """Whole grouped expert FFN (E, ..., d) -> (E, ..., d) through the seam.

    One dispatch for gate/up/silu/down across all experts (wg, wu: (E, d,
    f); wd: (E, f, d)); the kernel path runs the three GEMMs on the
    batched GEMM kernel, experts as the batch.  Keeps all free dims."""
    return dispatch("moe_expert_ffn", x, wg, wu, wd, handle=handle)


def moe_expert_ffn_placed(
    x: torch.Tensor,
    wg: torch.Tensor,
    wu: torch.Tensor,
    wd: torch.Tensor,
    *,
    placement,
):
    """Grouped expert FFN with per-expert placed accounting.

    Same op, same math, same single dispatch as :func:`moe_expert_ffn`,
    but ``placement`` (a
    :class:`~repro_torch.core.placement.ExpertDispatchPlan`) fans the
    accounting out into one handle-affine sub-launch per expert copy,
    charged on the lane its weights live on.  Returns ``(out, launch)`` so
    callers can read the busiest lane back."""
    return dispatch_placed("moe_expert_ffn", x, wg, wu, wd,
                           placement=placement)


def expert_matmul(
    x: torch.Tensor,
    w: torch.Tensor,
    *,
    out_dtype=None,
    handle: Optional[DeviceHandle] = None,
) -> torch.Tensor:
    """(E, ..., d) @ (E, d, f) -> (E, ..., f) — expert-batched contraction
    (all free dims kept); the kernel path is one batched GEMM launch."""
    return dispatch("expert_matmul", x, w, out_dtype=out_dtype, handle=handle)


def syrk(a: torch.Tensor, *, out_dtype=None) -> torch.Tensor:
    """C = A @ A.T — host-only, as in the paper's build."""
    return dispatch("syrk", a, out_dtype=out_dtype)


def attention(
    q: torch.Tensor,
    k: torch.Tensor,
    v: torch.Tensor,
    *,
    causal: bool = True,
    window=None,
    sm_scale: Optional[float] = None,
    kv_mask: Optional[torch.Tensor] = None,
    handle: Optional[DeviceHandle] = None,
) -> torch.Tensor:
    """Fused attention through the offload seam.

    q: (B, Hq, Sq, D); k, v: (B, Hkv, Skv, D).  ``window`` is None, a
    Python int, or a 0-d tensor; the flash-attention kernel takes only the
    first two (and no ``kv_mask``), so a tensor window takes the masked
    host path, as the reference's traced windows do.  Queries align to the
    end of kv when Sq < Skv.  ``handle`` pins the call to a device-resident
    buffer (e.g. a KV cache)."""
    return dispatch(
        "attention", q, k, v, causal=causal, window=window,
        sm_scale=sm_scale, kv_mask=kv_mask, handle=handle,
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
    """Raw masked/online-softmax attention math (no dispatch/accounting).

    q: (B, Hq, Sq, D); k, v: (B, Hkv, Skv, D); fp32 softmax; queries align
    to the end of kv; ``kv_mask`` is (Skv,) or (B, Skv) slot validity.
    Fully masked rows output 0.  Up to ``_DIRECT_ATTN_MAX_KV`` keys (or for
    one query) the scores are one masked einsum; beyond, an online-softmax
    loop over kv chunks keeps memory linear in Skv (the reference's
    ``lax.scan`` form)."""
    b, hq, sq, d = q.shape
    _, hkv, skv, _ = k.shape
    scale = sm_scale if sm_scale is not None else d ** -0.5
    group = hq // hkv
    qf = q.float()
    kf = (k.repeat_interleave(group, dim=1) if group > 1 else k).float()
    vf = (v.repeat_interleave(group, dim=1) if group > 1 else v).float()

    def mask_for(q_pos, kv_pos):
        m = torch.ones(torch.broadcast_shapes(q_pos.shape, kv_pos.shape),
                       dtype=torch.bool, device=q.device)
        if causal:
            m &= kv_pos <= q_pos
        if window is not None:
            m &= (q_pos - kv_pos) < window
        return m

    q_pos = (skv - sq) + torch.arange(sq, device=q.device)[:, None]
    if skv <= _DIRECT_ATTN_MAX_KV or sq == 1:
        s = torch.einsum("bhqd,bhkd->bhqk", qf, kf) * scale
        kv_pos = torch.arange(skv, device=q.device)[None, :]
        s = torch.where(mask_for(q_pos, kv_pos)[None, None], s, _NEG_INF)
        if kv_mask is not None:
            km = kv_mask if kv_mask.ndim == 2 else kv_mask[None]
            s = torch.where(km[:, None, None, :], s, _NEG_INF)
        p = torch.softmax(s, dim=-1)
        # fully-masked rows contribute zeros (matches the kernel semantics)
        p = torch.where(s.amax(dim=-1, keepdim=True) <= _NEG_INF * 0.5, 0.0, p)
        out = torch.einsum("bhqk,bhkd->bhqd", p, vf)
        return out.to(q.dtype)

    if kv_mask is not None:
        raise NotImplementedError("kv_mask only supported on the direct path")
    bkv = min(_CHUNKED_ATTN_BLOCK, skv)
    while skv % bkv:
        bkv //= 2
    m_run = torch.full((b, hq, sq, 1), _NEG_INF, device=q.device)
    l_run = torch.zeros((b, hq, sq, 1), device=q.device)
    acc = torch.zeros((b, hq, sq, d), device=q.device)
    for j in range(skv // bkv):
        sl = slice(j * bkv, (j + 1) * bkv)
        s = torch.einsum("bhqd,bhkd->bhqk", qf, kf[:, :, sl]) * scale
        kv_pos = j * bkv + torch.arange(bkv, device=q.device)[None, :]
        mask = mask_for(q_pos, kv_pos)[None, None]
        s = torch.where(mask, s, _NEG_INF)
        m_new = torch.maximum(m_run, s.amax(dim=-1, keepdim=True))
        pj = torch.where(mask, torch.exp(s - m_new), 0.0)
        corr = torch.exp(m_run - m_new)
        l_run = corr * l_run + pj.sum(dim=-1, keepdim=True)
        acc = corr * acc + torch.einsum("bhqk,bhkd->bhqd", pj, vf[:, :, sl])
        m_run = m_new
    return (acc / torch.clamp(l_run, min=1e-30)).to(q.dtype)


def gemv(
    a: torch.Tensor,
    x: torch.Tensor,
    *,
    out_dtype=None,
    handle: Optional[DeviceHandle] = None,
) -> torch.Tensor:
    return dispatch("gemv", a, x, out_dtype=out_dtype, handle=handle)


def dot(x: torch.Tensor, y: torch.Tensor) -> torch.Tensor:
    return dispatch("dot", x, y)


def axpy(alpha, x: torch.Tensor, y: torch.Tensor) -> torch.Tensor:
    return dispatch("axpy", alpha, x, y)


def scal(alpha, x: torch.Tensor) -> torch.Tensor:
    return dispatch("scal", alpha, x)


def nrm2(x: torch.Tensor) -> torch.Tensor:
    return dispatch("nrm2", x)


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
