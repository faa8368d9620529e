"""Hand-written CUDA GEMM (``csrc/gemm.cu``) and its wrapper.

Replaces the reference's Pallas TPU kernel ``gemm_kernel`` via
``pallas_gemm`` (``src/repro/kernels/gemm.py``): ``C = A @ B`` with an fp32
accumulator and one rounding to ``out_dtype``.

The source holds three kernels, and :func:`gemm_route` names the one a call
runs, by shape, dtype, layout and alignment, before the launch:

* ``"wgmma"`` — bf16 operands with m > 16 (the forward's and hnp's GEMMs):
  Hopper tensor cores fed by TMA, bound by bf16 FLOPs
  (``csrc/gemm_wgmma.cuh``);
* ``"skinny"`` — m <= 16 (serving: m = batch), bound by the bytes of B
  (``csrc/gemm_skinny.cuh``): B read once in 16-byte copies, all rows in
  one block, k split across warps and across the blocks of a cluster,
  split partials summed in split order through distributed shared memory
  (no workspace, no atomics); bf16 on the tensor cores, f32 on the CUDA
  cores; :func:`skinny_plan` fixes the launch from shape, dtype, strides
  and alignment — never from the batch count;
* ``"tiled"`` — anything else (fp32 operands, a column-major A, k % 8 != 0
  or a misaligned operand): fp32 FMAs on the CUDA cores, no TF32.

The route is not a fallback: a launch that fails raises, and is never
retried on another kernel.

:func:`gemm` launches the kernel for CUDA tensors and takes the plain
version, :func:`repro_torch.kernels.ref.gemm_ref`, only for CPU tensors.
There is no fallback: a CUDA tensor the kernel does not take raises.
``gemm.launches`` counts kernel launches (never plain-version calls), and
``gemm.route_launches[route]`` the launches of each route.

:func:`gemm_batched` replaces ``pallas_gemm_batched`` (same source file,
the same ``gemm_kernel`` with the batch as the outermost parallel grid
axis): ``C[z] = A[z] @ B[z]``, launched as one grid over ``blockIdx.z``
with the operands' own batch strides.  It has its own counter,
``gemm_batched.launches``, so a stacked launch is told apart from a
single one, and its own ``gemm_batched.route_launches``.
"""

from __future__ import annotations

import ctypes
import functools
from typing import NamedTuple, Optional

import torch

from repro_torch.kernels import _build
from repro_torch.kernels.ref import gemm_batched_ref, gemm_ref

__all__ = ["ROUTES", "SkinnyPlan", "gemm", "gemm_batched", "gemm_batched_ref",
           "gemm_ref", "gemm_route", "skinny_plan"]

_DTYPE_CODE = {torch.float32: 0, torch.bfloat16: 1}
ROUTES = ("skinny", "tiled", "wgmma")       # index = the C side's route code
# TMA addresses 16-byte units: base pointers and every stride but the unit
# one must be multiples of 16 bytes, i.e. of 8 bf16 elements.
_TMA_ALIGN = 16
_TMA_ELEMS = _TMA_ALIGN // 2


def gemm_route(m: int, n: int, k: int, batch: int, dtype: torch.dtype,
               a_strides, b_strides, a_ptr: int, b_ptr: int) -> str:
    """The kernel that runs ``C[z] = A[z] @ B[z]`` for these operands.

    ``a_strides`` are A's (batch, row, k) strides and ``b_strides`` B's
    (batch, k, column), in elements (batch stride 0: one matrix or a
    broadcast); ``a_ptr``/``b_ptr`` the operands' addresses.  m <= 16 takes
    ``"skinny"``.  bf16 operands with a row-major A, a B with unit k- or
    n-stride, and the 16-byte alignment TMA needs take ``"wgmma"``;
    anything else ``"tiled"``."""
    if m <= 16:
        return "skinny"
    sa_b, sa_m, sa_k = a_strides
    sb_b, sb_k, sb_n = b_strides
    if dtype != torch.bfloat16 or sa_k != 1 or k % _TMA_ELEMS:
        return "tiled"
    if sb_n == 1:              # row-major [k, n]: MN-major for wgmma
        b_row = sb_k
    elif sb_k == 1:            # K-major, e.g. a tied embedding's transpose
        b_row = sb_n
    else:
        return "tiled"
    strides = (sa_m, b_row) + ((sa_b, sb_b) if batch > 1 else ())
    if any(s % _TMA_ELEMS for s in strides) or a_ptr % _TMA_ALIGN \
            or b_ptr % _TMA_ALIGN:
        return "tiled"
    return "wgmma"


# The skinny kernels' launch geometry, as csrc/gemm_skinny.cuh fixes it
# (needed here only to pick the splits), all 256-thread blocks (8 warps),
# k split across the blocks of a cluster (at most 8):
# * tensor cores (bf16, 16-byte B vectors): an MN-major block owns 64
#   columns and its warps take 16-row items of k in turn (one item a warp
#   at least); a K-major block owns 128 columns (16 a warp) and each warp
#   walks k in 64-deep items;
# * CUDA cores (f32, or B the 16-byte copies cannot read): an MN-major
#   block owns tn threads' columns (tn * vec) and walks k rows in 256 / tn
#   groups; a K-major block owns 32 columns.
# Splits: the fewest that give every one of the H100's 132 SMs a block.
_SK_THREADS = 256
_SK_WARPS = 8
_SK_SMS = 132
_SK_MAX_SPLITS = 8
_SK_TC_MN_COLS, _SK_TC_MN_ITEM = 64, 16
_SK_TC_K_COLS, _SK_TC_K_ITEM = 128, 64
_SK_K_COLS = 32


class SkinnyPlan(NamedTuple):
    """Launch plan of the skinny route (see :func:`skinny_plan`), every
    field passed to the kernel's entry point."""

    layout: str         # "mn": B row-major (n-stride 1); "k": k-stride 1
    vec: int            # B elements per load: 16 bytes' worth, or 1
    splits: int         # blocks along k: the cluster's size, at most 8
    kc: int             # k rows per split (a multiple of 8)
    tn: int             # CUDA-core "mn": threads per k row; else 0
    a_vec: int          # A elements per load while staging: 16 bytes, or 1


def skinny_plan(m: int, n: int, k: int, dtype: torch.dtype, a_strides,
                b_strides, a_ptr: int, b_ptr: int) -> SkinnyPlan:
    """The launch of the skinny kernels for ``C[z] = A[z] @ B[z]`` with
    m <= 16 rows.

    A function of shape, dtype, strides (``a_strides`` A's (batch, row,
    k), ``b_strides`` B's (batch, k, column), in elements) and addresses
    alone: it never sees the batch count, so a stacked launch runs each
    matrix exactly as its single launch does, nor m, since every m <= 16
    rows live in one block.  ``layout`` follows B's unit stride; ``vec``
    is 16 bytes of elements when B's address and non-unit strides are
    16-byte multiples and the vector dimension (n for "mn", k for "k") is
    a multiple of it, else 1; bf16 with ``vec`` 8 runs on the tensor
    cores, the rest on the CUDA cores.  ``a_vec`` is the same for A's
    rows, which the kernels stage into shared memory: 16-byte loads when A
    has unit k-stride, k and A's other strides are multiples of the vector
    and its address is 16-byte aligned, else one element at a time
    through its strides."""
    if not 1 <= m <= 16:
        raise ValueError(f"skinny_plan: m = {m} is not in [1, 16]")
    sb_b, sb_k, sb_n = b_strides
    item = torch.finfo(dtype).bits // 8
    full = 16 // item
    layout = "mn" if sb_n == 1 or n == 1 else "k"
    unit, other, along = ((sb_n, sb_k, n) if layout == "mn"
                          else (sb_k, sb_n, k))
    vec = full if (unit == 1 and along % full == 0 and other % full == 0
                   and sb_b % full == 0 and b_ptr % 16 == 0) else 1
    sa_b, sa_m, sa_k = a_strides
    a_vec = full if (sa_k == 1 and k % full == 0 and sa_m % full == 0
                     and sa_b % full == 0 and a_ptr % 16 == 0) else 1
    tensor = dtype == torch.bfloat16 and vec == 8
    tn = 0
    if tensor and layout == "mn":
        block_cols, k_unit = _SK_TC_MN_COLS, _SK_TC_MN_ITEM * _SK_WARPS
    elif tensor:
        block_cols, k_unit = _SK_TC_K_COLS, _SK_TC_K_ITEM
    elif layout == "mn":
        tn = min(32, 1 << max(0, (-(-n // vec) - 1).bit_length()))
        block_cols, k_unit = tn * vec, _SK_THREADS // tn
    else:
        block_cols, k_unit = _SK_K_COLS, 32 * vec
    col_blocks = -(-n // block_cols)
    most = max(1, min(k // k_unit, _SK_MAX_SPLITS))
    splits = min(most, -(-_SK_SMS // col_blocks))
    kc = 8 * -(-max(k, 1) // (8 * splits))
    splits = -(-max(k, 1) // kc)
    return SkinnyPlan(layout, vec, splits, kc, tn, a_vec)


@functools.lru_cache(maxsize=None)
def _fn():
    fn = _build.library("gemm").repro_gemm
    fn.restype = ctypes.c_int
    fn.argtypes = (
        [ctypes.c_void_p] * 3
        + [ctypes.c_int] * 4
        + [ctypes.c_longlong] * 8
        + [ctypes.c_int] * 3 + [ctypes.c_void_p]
    )
    return fn


def _unit_stride_2d(t: torch.Tensor) -> bool:
    """One unit stride: row-major with a row stride of at least its width,
    or column-major (a transposed view) with a column stride of at least
    its height; the stride of a size-1 dimension is free.  The kernels
    read any such operand in place through its strides (a column slice
    ``x[:, :k]`` included)."""
    rows, cols = t.shape
    s0, s1 = t.stride()
    row_major = (cols <= 1 or s1 == 1) and (rows <= 1 or s0 >= cols)
    col_major = (rows <= 1 or s0 == 1) and (cols <= 1 or s1 >= rows)
    return row_major or col_major


def _check_kernel_operands(name, a, b, out_dtype, mats) -> None:
    if a.device.type != "cuda":
        raise ValueError(f"{name}: no kernel for device {a.device}")
    if a.dtype != b.dtype or a.dtype not in _DTYPE_CODE:
        raise TypeError(f"{name} kernel takes f32 or bf16 pairs, got "
                        f"{a.dtype}, {b.dtype}")
    if out_dtype not in _DTYPE_CODE:
        raise TypeError(f"{name} kernel writes f32 or bf16, not {out_dtype}")
    if not all(_unit_stride_2d(t) for t in mats):
        raise ValueError(
            f"{name} kernel takes matrices with one unit stride (row- or "
            f"column-major, rows or columns possibly spaced wider), got "
            f"strides {a.stride()} and {b.stride()}")


@functools.lru_cache(maxsize=None)
def _skinny_fn():
    fn = _build.library("gemm").repro_gemm_skinny
    fn.restype = ctypes.c_int
    fn.argtypes = (
        [ctypes.c_void_p] * 3
        + [ctypes.c_int] * 4
        + [ctypes.c_longlong] * 8
        + [ctypes.c_int] * 8 + [ctypes.c_void_p]
    )
    return fn


def _launch_skinny(a, b, c, m, n, k, batch, a_strides, b_strides,
                   c_strides, stream) -> int:
    plan = skinny_plan(m, n, k, a.dtype, a_strides, b_strides, a.data_ptr(),
                       b.data_ptr())
    return _skinny_fn()(
        a.data_ptr(), b.data_ptr(), c.data_ptr(), m, n, k, batch,
        *a_strides, *b_strides, *c_strides,
        _DTYPE_CODE[a.dtype], _DTYPE_CODE[c.dtype], int(plan.layout == "k"),
        plan.vec, plan.splits, plan.kc,
        plan.tn.bit_length() - 1 if plan.tn else 0, plan.a_vec, stream,
    )


def _launch(a, b, c, m, n, k, batch, a_strides, b_strides, c_strides) -> str:
    """Launch the route :func:`gemm_route` names; returns the route."""
    route = gemm_route(m, n, k, batch, a.dtype, a_strides, b_strides,
                       a.data_ptr(), b.data_ptr())
    with torch.cuda.device(a.device):
        stream = torch.cuda.current_stream().cuda_stream
        if route == "skinny":
            err = _launch_skinny(a, b, c, m, n, k, batch, a_strides,
                                 b_strides, c_strides, stream)
        else:
            err = _fn()(
                a.data_ptr(), b.data_ptr(), c.data_ptr(), m, n, k, batch,
                *a_strides,         # A strides: batch, row, k
                *b_strides,         # B strides: batch, k, column
                *c_strides,         # C strides: batch, row
                _DTYPE_CODE[a.dtype], _DTYPE_CODE[c.dtype],
                ROUTES.index(route), stream,
            )
    if err:
        raise RuntimeError(
            f"gemm kernel launch failed ({route} route): cudaError {err}")
    return route


def gemm(a: torch.Tensor, b: torch.Tensor, *,
         out_dtype: Optional[torch.dtype] = None) -> torch.Tensor:
    """C[m, n] = A[m, k] @ B[k, n] with fp32 accumulation.

    A and B must share one dtype (float32 or bfloat16) and one device, and
    each have one unit stride (row-major, or column-major as a transposed
    view; a slice such as ``x[:, :k]`` is read in place); ``out_dtype`` is
    float32 or bfloat16 (default: the input dtype)."""
    if a.ndim != 2 or b.ndim != 2 or a.shape[1] != b.shape[0]:
        raise ValueError(f"gemm: bad shapes {tuple(a.shape)} @ {tuple(b.shape)}")
    if a.device != b.device:
        raise ValueError(f"gemm: operands on {a.device} and {b.device}")
    out_dtype = out_dtype or torch.promote_types(a.dtype, b.dtype)
    if a.device.type == "cpu":
        return gemm_ref(a, b, out_dtype=out_dtype)
    _check_kernel_operands("gemm", a, b, out_dtype, (a, b))
    m, k = a.shape
    n = b.shape[1]
    c = torch.empty((m, n), dtype=out_dtype, device=a.device)
    route = _launch(a, b, c, m, n, k, 1, (0, *a.stride()), (0, *b.stride()),
                    (0, n))
    gemm.launches += 1
    gemm.route_launches[route] += 1
    return c


gemm.launches = 0
gemm.route_launches = dict.fromkeys(ROUTES, 0)


def gemm_batched(a: torch.Tensor, b: torch.Tensor, *,
                 out_dtype: Optional[torch.dtype] = None) -> torch.Tensor:
    """C[z] = A[z] @ B[z] for (Z, m, k) @ (Z, k, n), fp32 accumulation, in
    one launch.

    Each A[z] and B[z] must have one unit stride, as for :func:`gemm`; the
    batch stride is free (a stack, or a broadcast operand with
    batch stride 0).  Dtypes as for :func:`gemm`."""
    if a.ndim != 3 or b.ndim != 3 or a.shape[0] != b.shape[0] \
            or a.shape[2] != b.shape[1]:
        raise ValueError(
            f"gemm_batched: bad shapes {tuple(a.shape)} @ {tuple(b.shape)}")
    if a.device != b.device:
        raise ValueError(f"gemm_batched: operands on {a.device} and {b.device}")
    out_dtype = out_dtype or torch.promote_types(a.dtype, b.dtype)
    if a.device.type == "cpu":
        return gemm_batched_ref(a, b, out_dtype=out_dtype)
    z, m, k = a.shape
    n = b.shape[2]
    c = torch.empty((z, m, n), dtype=out_dtype, device=a.device)
    if z == 0:
        return c
    _check_kernel_operands("gemm_batched", a, b, out_dtype, (a[0], b[0]))
    route = _launch(a, b, c, m, n, k, z, a.stride(), b.stride(), (m * n, n))
    gemm_batched.launches += 1
    gemm_batched.route_launches[route] += 1
    return c


gemm_batched.launches = 0
gemm_batched.route_launches = dict.fromkeys(ROUTES, 0)
