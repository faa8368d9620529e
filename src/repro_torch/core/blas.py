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
               takes its plain version only for CPU tensors.  Under grad
               each launch runs inside an autograd Function whose backward
               launches the GEMM kernel again (attention and the SSD term:
               recompute their plain versions).

Tensor-parallel plans.  Under an ambient mesh with a ``model`` axis of
more than one device (:mod:`repro_torch.sharding.spmd`), five descriptors
take a ``plan`` that wins over the kernel, as in the reference:
``matmul`` with ``tp_mode="row"`` / ``"col"``, ``mlp_block`` (one psum a
block, in :func:`psum_cast_dtype`), ``qkv_project`` (each shard projects
its slice of the sequence, then an all-gather), ``moe_expert_ffn``
(experts sharded over ``model``, nothing exchanged) and ``ssd_scan``
(heads sharded over ``model``).  Their ``plan_lower`` runs the reference's
``shard_map`` body on the emulated mesh.  Where the reference's bodies
run raw ``lax.dot_general`` and the SSD term's plain version, each body
here runs the lowering the unsharded op would take at the *local* shape:
the GEMM kernel (``gemm`` / ``gemm_batched``) or the SSD kernel when the
policy runs kernels (``use_kernels``, mode not ``"host"``) and the local
shape is eligible, the plain version otherwise.  The bodies call the
kernel wrappers directly, so the only record is the one ``dispatch``
writes before ``plan_lower`` (note ``tp-plan``).
"""

from __future__ import annotations

import contextlib
import os
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
    "local_matmul",
    "mlp_block",
    "qkv_project",
    "attention",
    "attention_math",
    "decode_attention",
    "psum_cast_dtype",
    "ssd_scan",
    "causal_conv_silu",
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


def _lowering(name: str):
    """Row ``name`` of the kernel lowering table, differentiable under
    grad (:mod:`repro_torch.kernels.autograd`)."""
    from repro_torch.kernels import autograd  # lazy: avoid import cycle

    return autograd.lowering(name)


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
    return _lowering("gemm")(
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


def _matmul_cost(x, w, *, out_dtype=None, tp_mode=None):
    m, k, n = _matmul_dims(x, w)
    return cm.gemm_cost(m, n, k, x.element_size())


def _matmul_eligible(x, w, *, out_dtype=None, tp_mode=None):
    m, k, n = _matmul_dims(x, w)
    return _kernel_gemm_eligible(m, n, k, x.dtype)


def _matmul_host(x, w, *, out_dtype=None, tp_mode=None):
    return _accum_mm(x, w, _result_dtype(x, w, out_dtype))


def _matmul_kernel(x, w, *, out_dtype=None, tp_mode=None):
    m, k, n = _matmul_dims(x, w)
    out = _lowering("matmul")(
        x.reshape(m, k), w, out_dtype=_result_dtype(x, w, out_dtype))
    return out.reshape(*x.shape[:-1], n)


# ---------------------------------------------------------------------------
# Tensor-parallel plans: the shared prologue and the bodies' lowering.
# ---------------------------------------------------------------------------

def _tp_mesh_info():
    """Ambient model-parallel topology, or None when no TP plan can apply.

    Returns ``(mesh, n_model, dp_axes, n_dp)`` — the shared applicability
    prologue of every descriptor's TP ``plan`` (pure inspection).  A
    single-device model axis counts as "no topology"; so does a
    ``shard_map`` body, which has no ambient mesh."""
    from repro_torch.sharding.annotate import _ambient_mesh

    mesh = _ambient_mesh()
    if mesh is None or "model" not in getattr(mesh, "axis_names", ()):
        return None
    n_model = mesh.shape["model"]
    if n_model <= 1:
        return None
    dp = tuple(a for a in ("pod", "data") if a in mesh.axis_names)
    n_dp = 1
    for a in dp:
        n_dp *= mesh.shape[a]
    return mesh, n_model, dp, n_dp


def _plan_kernels() -> bool:
    """Whether a plan body's local work runs on the kernels: the policy
    enables them and does not keep the call on the host."""
    pol = engine().policy
    return bool(pol.use_kernels) and pol.mode != "host"


def _local_mm(x, w, out_dtype, kernels: bool):
    """(..., k) @ (k, n) in a plan body: the lowering the unsharded
    ``matmul`` takes at this local shape (the GEMM kernel when ``kernels``
    and eligible, else the plain version), fp32 accumulation, one
    rounding to ``out_dtype``."""
    m, k, n = _matmul_dims(x, w)
    if kernels and _kernel_gemm_eligible(m, n, k, x.dtype):
        return _matmul_kernel(x, w, out_dtype=out_dtype)
    return _matmul_host(x, w, out_dtype=out_dtype)


def local_matmul(x, w, *, out_dtype=None):
    """(..., k) @ (k, n) inside a ``shard_map`` body, with no dispatch and
    no record (the reference's bodies run raw dot products): the lowering
    the unsharded ``matmul`` takes at this local shape under the current
    policy."""
    return _local_mm(x, w, _result_dtype(x, w, out_dtype), _plan_kernels())


def _tp_plan(x, w, mode: str):
    """``(mesh, dp_axes)`` when the explicit-TP shard_map path applies,
    else None.  Pure inspection, so the dispatcher resolves routing before
    it records a backend."""
    if mode not in ("row", "col"):
        return None
    info = _tp_mesh_info()
    if info is None or x.ndim != 3:
        return None
    mesh, n_model, dp, n_dp = info
    if x.shape[0] % n_dp:
        return None
    if x.shape[-1] != w.shape[0]:
        return None
    if mode == "row" and w.shape[0] % n_model:
        return None
    if mode == "col" and w.shape[1] % n_model:
        return None
    return mesh, dp


def _tp_shard_map_matmul(x, w, mode: str, out_dtype, plan):
    """Explicit tensor-parallel matmul: local matmul with fp32
    accumulation -> cast -> psum in the output dtype.  ``row``: w's first
    (contracting) dim is model-sharded, psum in forward; ``col``: w's last
    dim is model-sharded, no collective forward (the backward's dX sum is
    autograd's, over the gathered graph)."""
    from repro_torch.sharding.spmd import P, psum, shard_map

    mesh, dp = plan
    out_dtype = _result_dtype(x, w, out_dtype)
    kernels = _plan_kernels()
    if mode == "row":

        def local(xl, wl):
            y = _local_mm(xl, wl, out_dtype, kernels)
            return psum(y, "model")

        return shard_map(
            local,
            mesh=mesh,
            in_specs=(P(dp, None, "model"), P("model", None)),
            out_specs=P(dp, None, None),
        )(x, w)

    def local_col(xl, wl):
        return _local_mm(xl, wl, out_dtype, kernels)

    return shard_map(
        local_col,
        mesh=mesh,
        in_specs=(P(dp, None, None), P(None, "model")),
        out_specs=P(dp, None, "model"),
    )(x, w)


def _matmul_plan(x, w, *, out_dtype=None, tp_mode=None):
    # A tensor-parallel matmul runs the shard_map path, so routing must
    # resolve before the record is written.
    return _tp_plan(x, w, tp_mode) if tp_mode in ("row", "col") else None


def _matmul_plan_lower(plan, x, w, *, out_dtype=None, tp_mode=None):
    return _tp_shard_map_matmul(x, w, tp_mode, out_dtype, plan)


register(OffloadOp(
    name="matmul",
    cost=_matmul_cost,
    host=_matmul_host,
    kernel=_matmul_kernel,
    eligible=_matmul_eligible,
    plan=_matmul_plan,
    plan_lower=_matmul_plan_lower,
))


def psum_cast_dtype(dtype, device):
    """Reduction dtype for TP psums: the dtype itself on the card (bf16
    halves the bytes); f32 for a bf16 operand on the CPU, as the
    reference's rule for its CPU backend gives."""
    if torch.device(device).type == "cpu" and dtype == torch.bfloat16:
        return torch.float32
    return dtype


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
    mm = _lowering("matmul")
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


def _mlp_plan(x, w_up, w_down, gate=None, b_up=None, b_down=None, *,
              kind="swiglu"):
    """Whole-block tensor-parallel applicability (pure inspection):
    ``(mesh, dp_axes)`` when the d_ff column / row slices can stay local
    under an ambient model-parallel mesh, else None."""
    if os.environ.get("REPRO_DISABLE_TP_MLP"):
        return None
    info = _tp_mesh_info()
    if info is None or x.ndim != 3:
        return None
    mesh, n_model, dp, n_dp = info
    d_ff = w_up.shape[1]
    if x.shape[0] % n_dp or d_ff % n_model:
        return None
    return mesh, dp


def _mlp_plan_lower(plan, x, w_up, w_down, gate=None, b_up=None, b_down=None,
                    *, kind="swiglu"):
    """The whole MLP under one shard_map: the d_ff column / row slices stay
    local, one psum forward."""
    from repro_torch.sharding.spmd import P, psum, shard_map

    mesh, dp = plan
    kernels = _plan_kernels()
    f32 = torch.float32
    if kind == "swiglu":

        def local(xl, wg, wu, wd):
            g = _local_mm(xl, wg, f32, kernels)
            u = _local_mm(xl, wu, f32, kernels)
            h = (F.silu(g) * u).to(xl.dtype)
            y = _local_mm(h, wd, f32, kernels)
            y = psum(y.to(psum_cast_dtype(xl.dtype, xl.device)), "model")
            return y.to(xl.dtype)

        fn = shard_map(
            local, mesh=mesh,
            in_specs=(P(dp, None, None), P(None, "model"), P(None, "model"),
                      P("model", None)),
            out_specs=P(dp, None, None),
        )
        return fn(x, gate, w_up, w_down)

    def local_gelu(xl, wu, bu, wd, bd):
        h = _local_mm(xl, wu, f32, kernels) + bu
        h = F.gelu(h, approximate="tanh").to(xl.dtype)
        y = _local_mm(h, wd, f32, kernels)
        y = psum(y.to(psum_cast_dtype(xl.dtype, xl.device)), "model")
        return y.to(xl.dtype) + bd.to(xl.dtype)

    fn = shard_map(
        local_gelu, mesh=mesh,
        in_specs=(P(dp, None, None), P(None, "model"), P("model"),
                  P("model", None), P(None)),
        out_specs=P(dp, None, None),
    )
    return fn(x, w_up, b_up, w_down, b_down)


register(OffloadOp(
    name="mlp_block",
    cost=_mlp_cost,
    host=_mlp_host,
    kernel=_mlp_kernel,
    eligible=_mlp_eligible,
    plan=_mlp_plan,
    plan_lower=_mlp_plan_lower,
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
    y = _lowering("qkv_project")(
        x.reshape(m, d), w, out_dtype=x.dtype)
    if b is not None:
        y = y + b.to(y.dtype)
    return y.reshape(*x.shape[:-1], n)


def _qkv_plan(x, wq, wk, wv, *, bq=None, bk=None, bv=None):
    """Sequence-sharded TP applicability (pure inspection): each model
    shard projects its sequence slice and the small qkv activations are
    all-gathered — replicated compute would pay n_model x the FLOPs."""
    if os.environ.get("REPRO_DISABLE_TP_ATTN"):
        return None
    info = _tp_mesh_info()
    if info is None or x.ndim != 3:
        return None
    mesh, n_model, dp, n_dp = info
    if x.shape[0] % n_dp or x.shape[1] % n_model:
        return None
    return mesh, dp


def _qkv_plan_lower(plan, x, wq, wk, wv, *, bq=None, bk=None, bv=None):
    from repro_torch.sharding.spmd import P, all_gather, axis_index, shard_map

    mesh, dp = plan
    n_model = mesh.shape["model"]
    kernels = _plan_kernels()
    w, b = _qkv_concat(x, wq, wk, wv, bq, bk, bv)
    if b is None:
        b = torch.zeros(w.shape[1], dtype=x.dtype, device=x.device)

    def local(xl, wl, bl):
        s = xl.shape[1]
        seg = s // n_model
        idx = axis_index("model")
        xs = xl.narrow(1, idx * seg, seg)
        y = _local_mm(xs, wl, xl.dtype, kernels) + bl.to(xl.dtype)
        return all_gather(y, "model", dim=1)

    fn = shard_map(
        local,
        mesh=mesh,
        in_specs=(P(dp, None, None), P(None, None), P(None)),
        out_specs=P(dp, None, None),
    )
    return fn(x, w, b)


register(OffloadOp(
    name="qkv_project",
    cost=_qkv_cost,
    host=_qkv_host,
    kernel=_qkv_kernel,
    eligible=_qkv_eligible,
    plan=_qkv_plan,
    plan_lower=_qkv_plan_lower,
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
    return _lowering("gemm_batched")(
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
    out = _lowering("moe_gemm")(
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
# one descriptor: the cost model sees the expert block at once, and the
# expert-parallel shard_map — experts model-sharded, every GEMM local,
# zero collectives — is its ``plan``.  With ``offsets`` it is the dropless
# route: x is (R, d) rows sorted by expert, expert e's rows
# ``offsets[e]:offsets[e+1]`` (int32, on x's device), and the kernel path is
# three launches of the ragged grouped GEMM (``kernels/gemm.py::
# gemm_grouped``), which reads the offsets on the card.
# ---------------------------------------------------------------------------

def _moe_ffn_dims(x, wg, wu, wd, offsets=None):
    if offsets is not None:
        if x.ndim != 2 or wg.ndim != 3 or wu.shape != wg.shape \
                or wd.ndim != 3 or x.shape[1] != wg.shape[1] \
                or tuple(wd.shape) != (wg.shape[0], wg.shape[2], wg.shape[1]):
            raise ValueError(
                f"moe_expert_ffn: bad ragged shapes {tuple(x.shape)} "
                f"{tuple(wg.shape)} {tuple(wu.shape)} {tuple(wd.shape)}")
        if tuple(offsets.shape) != (wg.shape[0] + 1,) \
                or offsets.dtype != torch.int32:
            raise ValueError(
                f"moe_expert_ffn: offsets must be ({wg.shape[0] + 1},) int32, "
                f"got {tuple(offsets.shape)} {offsets.dtype}")
        return wg.shape[0], x.shape[0], x.shape[1], wg.shape[2]
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


def _moe_ffn_cost(x, wg, wu, wd, *, offsets=None):
    e, m, d, f = _moe_ffn_dims(x, wg, wu, wd, offsets)
    # Ragged: the R rows once, each through its own expert.
    return cm.gemm_cost(m, 3 * f, d, x.element_size(),
                        batch=1 if offsets is not None else e,
                        op="moe_expert_ffn")


def _moe_ffn_eligible(x, wg, wu, wd, *, offsets=None):
    e, m, d, f = _moe_ffn_dims(x, wg, wu, wd, offsets)
    return _kernel_gemm_eligible(m, f, d, x.dtype)


def _moe_ffn_ragged_host(x, wg, wu, wd, offsets):
    """The dropless route's plain math: each expert's rows through its own
    FFN (the ragged GEMM's plain version, which reads the offsets on the
    host), with the capped route's cast points.  On meta tensors (a dry
    run's shapes, no counts) one product a projection over all R rows
    stands in: the same shapes out and the same dot FLOPs, 2·R·d·f a
    projection, whatever the routing."""
    if x.device.type == "meta":
        g = _accum_mm(x, wg[0], x.dtype)
        u = _accum_mm(x, wu[0], x.dtype)
        return _accum_mm(_swiglu_glue(g, u, x.dtype), wd[0], x.dtype)
    from repro_torch.kernels.ref import gemm_grouped_ref  # lazy: import cycle

    g = gemm_grouped_ref(x, wg, offsets, out_dtype=x.dtype)
    u = gemm_grouped_ref(x, wu, offsets, out_dtype=x.dtype)
    return gemm_grouped_ref(_swiglu_glue(g, u, x.dtype), wd, offsets,
                            out_dtype=x.dtype)


def _moe_ffn_host(x, wg, wu, wd, *, offsets=None):
    """The expert FFN math itself, fp32 accumulation, with the reference's
    cast points (``_moe_ffn_local``)."""
    if offsets is not None:
        return _moe_ffn_ragged_host(x, wg, wu, wd, offsets)
    e, m, d, f = _moe_ffn_dims(x, wg, wu, wd)
    xe = x.reshape(e, m, d)
    g = _accum_mm(xe, wg, x.dtype)
    u = _accum_mm(xe, wu, x.dtype)
    y = _accum_mm(_swiglu_glue(g, u, x.dtype), wd, x.dtype)
    return y.reshape(x.shape)


def _moe_ffn_kernel(x, wg, wu, wd, *, offsets=None):
    """Three launches of the batched GEMM kernel (gate, up, down), the
    SiLU·up product between them; with ``offsets``, three launches of the
    ragged grouped GEMM (no gradient: it serves prefill and decode)."""
    if offsets is not None:
        from repro_torch.kernels.gemm import gemm_grouped  # lazy: kernels

        if torch.is_grad_enabled() and any(
                t.requires_grad for t in (x, wg, wu, wd)):
            raise RuntimeError(
                "moe_expert_ffn: the ragged grouped GEMM has no gradient; "
                "call the dropless route under torch.no_grad()")
        g = gemm_grouped(x, wg, offsets, out_dtype=x.dtype)
        u = gemm_grouped(x, wu, offsets, out_dtype=x.dtype)
        return gemm_grouped(_swiglu_glue(g, u, x.dtype), wd, offsets,
                            out_dtype=x.dtype)
    e, m, d, f = _moe_ffn_dims(x, wg, wu, wd)
    mm = _lowering("moe_expert_ffn")
    xe = x.reshape(e, m, d)   # copies a transposed (E, G, C, d) view
    g = mm(xe, wg, out_dtype=x.dtype)
    u = mm(xe, wu, out_dtype=x.dtype)
    y = mm(_swiglu_glue(g, u, x.dtype), wd, out_dtype=x.dtype)
    return y.reshape(x.shape)


def _moe_ffn_plan(x, wg, wu, wd, *, offsets=None):
    """Expert-parallel applicability: experts shard over the model axis and
    every GEMM stays local (zero collectives inside the plan).  The first
    free dim also shards over the data axes when it divides.  The ragged
    route has no plan."""
    info = _tp_mesh_info()
    if info is None or offsets is not None:
        return None
    mesh, n_model, dp, n_dp = info
    if x.shape[0] % n_model:
        return None
    shard_free = bool(dp) and x.ndim >= 3 and x.shape[1] % n_dp == 0
    return mesh, (dp if shard_free else ())


def _moe_ffn_plan_lower(plan, x, wg, wu, wd):
    from repro_torch.sharding.spmd import P, shard_map

    mesh, dp = plan
    kernels = _plan_kernels()

    def local(xl, wgl, wul, wdl):
        if kernels and _moe_ffn_eligible(xl, wgl, wul, wdl):
            return _moe_ffn_kernel(xl, wgl, wul, wdl)
        return _moe_ffn_host(xl, wgl, wul, wdl)

    free = (dp if dp else None,) + (None,) * (x.ndim - 2)
    spec_x = P("model", *free)
    spec_w = P("model", None, None)
    fn = shard_map(
        local,
        mesh=mesh,
        in_specs=(spec_x, spec_w, spec_w, spec_w),
        out_specs=spec_x,
    )
    return fn(x, wg, wu, wd)


register(OffloadOp(
    name="moe_expert_ffn",
    cost=_moe_ffn_cost,
    host=_moe_ffn_host,
    kernel=_moe_ffn_kernel,
    eligible=_moe_ffn_eligible,
    plan=_moe_ffn_plan,
    plan_lower=_moe_ffn_plan_lower,
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
    return _lowering("attention")(
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

def _decode_attn_cost(q, k, v, lo, hi, *, sm_scale=None):
    if q.ndim != 4 or q.shape[2] != 1:
        raise ValueError(
            f"decode_attention: q must be (B, Hq, 1, D), got {tuple(q.shape)}")
    b, hq, _, d = q.shape
    if k.ndim != 4 or v.shape != k.shape or k.shape[0] != b or k.shape[3] != d:
        raise ValueError(
            f"decode_attention: bad cache {tuple(k.shape)} / {tuple(v.shape)}")
    skv = k.shape[2]
    return cm.attention_cost(b, 1, skv, hq, d, q.element_size())


def _decode_attn_eligible(q, k, v, lo, hi, *, sm_scale=None):
    return q.shape[-1] >= 8 and q.dtype in _KERNEL_DTYPES


def _bounds(x, b: int, device) -> torch.Tensor:
    """A scalar or (B,) slot bound as a (B,) int32 tensor on ``device``."""
    if isinstance(x, torch.Tensor):
        return x.to(device=device, dtype=torch.int32).expand(b).contiguous()
    return torch.full((b,), int(x), dtype=torch.int32, device=device)


def _decode_attn_host(q, k, v, lo, hi, *, sm_scale=None):
    b = q.shape[0]
    slots = torch.arange(k.shape[2], dtype=torch.int32, device=k.device)
    lo_b = _bounds(lo, b, k.device)[:, None]
    hi_b = _bounds(hi, b, k.device)[:, None]
    kv_valid = (slots >= lo_b) & (slots < hi_b)          # (B, S)
    return attention_math(q, k, v, causal=False, kv_mask=kv_valid,
                          sm_scale=sm_scale)


def _decode_attn_kernel(q, k, v, lo, hi, *, sm_scale=None):
    b = q.shape[0]
    out = _lowering("decode_attention")(
        q[:, :, 0, :], k, v, _bounds(lo, b, q.device), _bounds(hi, b, q.device),
        sm_scale=sm_scale,
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
# state recurrence + D skip) behind one descriptor.  B and C come per head
# (B, S, H, N), as the reference passes them, or once a group (B, S, G, N)
# of H / G heads, as the models pass them.  The host lowering is the plain
# composition (``kernels/ref.py::ssd_scan_ref``, B and C repeated per head);
# the kernel lowering runs the whole core on hand-written kernels
# (``kernels/ssd_scan.py::ssd_scan``: B and C read once a group, or, for
# operands those kernels do not take, the composition around the SSD chunk
# kernel).
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
    g = bh.shape[2] if bh.ndim == 4 else 0
    if bh.ndim != 4 or tuple(bh.shape[:2]) != (bsz, s) or g < 1 or h % g \
            or tuple(ch.shape) != tuple(bh.shape):
        raise ValueError(
            f"ssd_scan: bad B/C {tuple(bh.shape)} {tuple(ch.shape)}: want "
            f"(B, S, H, N) or (B, S, G, N) with H % G == 0, H {h}")
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


def _ssd_host(xh, dt, a, bh, ch, d_skip, *, chunk):
    from repro_torch.kernels import ref as kref  # lazy: avoid import cycle

    return kref.ssd_scan_ref(xh, dt, a, bh, ch, d_skip, chunk)


def _ssd_kernel(xh, dt, a, bh, ch, d_skip, *, chunk):
    return _lowering("ssd_scan")(xh, dt, a, bh, ch, d_skip, chunk=chunk)


def _ssd_plan(xh, dt, a, bh, ch, d_skip, *, chunk):
    """Head-sharded TP applicability: every piece of the SSD math is
    per-head and therefore local under a model-sharded head axis."""
    info = _tp_mesh_info()
    if info is None or xh.ndim != 4:
        return None
    mesh, n_model, dp, n_dp = info
    bsz, s, h, _ = xh.shape
    if h % n_model or bsz % n_dp or s % min(int(chunk), s):
        return None
    return mesh, dp


def _ssd_plan_lower(plan, xh, dt, a, bh, ch, d_skip, *, chunk):
    from repro_torch.sharding.spmd import P, shard_map

    mesh, dp = plan
    kernels = _plan_kernels()
    h, g = xh.shape[2], bh.shape[2]
    n_model = mesh.shape["model"]
    # B and C once a group: groups shard with their heads where the model
    # axis splits them; one group serves every shard whole; any other count
    # is repeated per head first, so that each shard's heads find theirs.
    if g % n_model == 0:
        bc = P(dp, None, "model", None)
    elif g == 1:
        bc = P(dp, None, None, None)
    else:
        bh, ch = (t.repeat_interleave(h // g, dim=2) for t in (bh, ch))
        bc = P(dp, None, "model", None)

    def local(xl, dtl, al, bl, cl, dl):
        if kernels and _ssd_eligible(xl, dtl, al, bl, cl, dl, chunk=chunk):
            return _ssd_kernel(xl, dtl, al, bl, cl, dl, chunk=chunk)
        return _ssd_host(xl, dtl, al, bl, cl, dl, chunk=chunk)

    fn = shard_map(
        local,
        mesh=mesh,
        in_specs=(
            P(dp, None, "model", None), P(dp, None, "model"), P("model"),
            bc, bc, P("model"),
        ),
        out_specs=P(dp, None, "model", None),
    )
    return fn(xh, dt, a, bh, ch, d_skip)


register(OffloadOp(
    name="ssd_scan",
    cost=_ssd_cost,
    host=_ssd_host,
    kernel=_ssd_kernel,
    eligible=_ssd_eligible,
    plan=_ssd_plan,
    plan_lower=_ssd_plan_lower,
))


def causal_conv_silu(x, b, c, w, bias):
    """SiLU of the Mamba-2 mixer's depthwise causal conv of its x (B, S, di),
    B and C (B, S, G·N) projections side by side: (B, S, F) fp32, the
    ``ssd_scan`` operands before they are split.  w: (K, F); bias: (F,).

    Not a registered op (no descriptor, record or ``dispatch:`` range).
    Under a policy that runs kernels on the device (``use_kernels``, mode
    ``"device"``) the conv kernel's wrapper runs, as a lowering row would:
    on CUDA tensors the kernel (``kernels/ssd_scan.py::causal_conv_silu``,
    which copies a view it cannot read in place and raises on operands it
    cannot take), on CPU tensors its plain version, and under grad inside
    an ``autograd.Function`` whose backward recomputes the plain version
    (``kernels/autograd.py``).  Every other policy runs the plain version,
    ``causal_conv_silu_ref``.  Both give the same pre-activation bit for
    bit."""
    from repro_torch.kernels import autograd, ref  # lazy: import cycle

    pol = engine().policy
    if pol.use_kernels and pol.mode == "device":
        return autograd.causal_conv_silu(x, b, c, w, bias)
    return ref.causal_conv_silu_ref(x, b, c, w, bias)


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
    tp_mode: Optional[str] = None,
    handle: Optional[DeviceHandle] = None,
) -> torch.Tensor:
    """General (leading-batch, k) @ (k, n) — the framework's workhorse.

    Collapses leading dims into the GEMM ``m`` dimension, exactly how a BLAS
    binding flattens a NumPy ``ndarray @ matrix``.

    ``tp_mode`` ("row" / "col") opts into the explicit tensor-parallel
    shard_map form when an ambient mesh has a model axis (a 3-D ``x``):
    "row" shards w's contracting dim and psums the output once, "col"
    shards w's output dim.  Ignored without a mesh.
    """
    return dispatch("matmul", x, w, out_dtype=out_dtype, tp_mode=tp_mode,
                    handle=handle)


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
    sm_scale: Optional[float] = None,
    handle: Optional[DeviceHandle] = None,
) -> torch.Tensor:
    """One-token decode attention against a KV cache through the seam.

    q: (B, Hq, 1, D); caches: (B, Hkv, S_cache, D); ``lo``/``hi`` (ints, or
    scalar / (B,) int tensors) bound the valid cache slots.  Host form is
    the masked math; the kernel form streams the cache once
    (``flash_decode``).  ``sm_scale`` is the softmax scale (None:
    ``D ** -0.5``).  ``handle`` pins the call to the device-resident
    cache so affinity scheduling routes decode to the data."""
    scale = {} if sm_scale is None else {"sm_scale": sm_scale}
    return dispatch(
        "decode_attention", q, k_cache, v_cache, lo, hi, handle=handle,
        **scale,
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
    (B, S, H, N) per head, or (B, S, G, N) once a group of H / G heads
    (head h reads group h // (H / G)).  Returns the fp32 (B, S, H, P) mixer
    output (within-chunk quadratic term + inter-chunk state recurrence + D
    skip).  The kernel path runs the whole core on the hand-written kernels
    (``kernels/ssd_scan.py::ssd_scan``)."""
    return dispatch(
        "ssd_scan", xh, dt, a, bh, ch, d_skip, chunk=chunk, handle=handle
    )


def moe_expert_ffn(
    x: torch.Tensor,
    wg: torch.Tensor,
    wu: torch.Tensor,
    wd: torch.Tensor,
    *,
    offsets: Optional[torch.Tensor] = None,
    handle: Optional[DeviceHandle] = None,
) -> torch.Tensor:
    """Whole grouped expert FFN (E, ..., d) -> (E, ..., d) through the seam.

    One dispatch for gate/up/silu/down across all experts (wg, wu: (E, d,
    f); wd: (E, f, d)); the kernel path runs the three GEMMs on the
    batched GEMM kernel, experts as the batch.  Keeps all free dims.

    With ``offsets`` ((E+1,) int32 on x's device) the dropless route: x is
    (R, d), rows sorted by expert, expert e's rows ``offsets[e]`` to
    ``offsets[e+1]``; the kernel path runs the three GEMMs on the ragged
    grouped GEMM, which reads the offsets on the card (no host read)."""
    ragged = {} if offsets is None else {"offsets": offsets}
    return dispatch("moe_expert_ffn", x, wg, wu, wd, handle=handle,
                    **ragged)


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
