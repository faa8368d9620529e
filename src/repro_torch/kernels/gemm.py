"""Hand-written CUDA GEMM (``csrc/gemm.cu``) and its wrapper.

Replaces the reference's Pallas TPU kernel ``gemm_kernel`` via
``pallas_gemm`` (``src/repro/kernels/gemm.py``): ``C = A @ B`` with an fp32
accumulator and one rounding to ``out_dtype``.  On the H100 the serving
shapes (m = batch) are bound by the bytes of B over 3.35 TB/s; the kernel's
design and its bound are described in the CUDA source.

:func:`gemm` launches the kernel for CUDA tensors and takes the plain
version, :func:`repro_torch.kernels.ref.gemm_ref`, only for CPU tensors.
There is no fallback: a CUDA tensor the kernel does not take raises.
``gemm.launches`` counts kernel launches (never plain-version calls).

:func:`gemm_batched` replaces ``pallas_gemm_batched`` (same source file,
the same ``gemm_kernel`` with the batch as the outermost parallel grid
axis): ``C[z] = A[z] @ B[z]``, launched as one grid over ``blockIdx.z``
with the operands' own batch strides.  It has its own counter,
``gemm_batched.launches``, so a stacked launch is told apart from a
single one.
"""

from __future__ import annotations

import ctypes
import functools
from typing import Optional

import torch

from repro_torch.kernels import _build
from repro_torch.kernels.ref import gemm_batched_ref, gemm_ref

__all__ = ["gemm", "gemm_batched", "gemm_ref", "gemm_batched_ref"]

_DTYPE_CODE = {torch.float32: 0, torch.bfloat16: 1}


@functools.lru_cache(maxsize=None)
def _fn():
    fn = _build.library("gemm").repro_gemm
    fn.restype = ctypes.c_int
    fn.argtypes = (
        [ctypes.c_void_p] * 3
        + [ctypes.c_int] * 4
        + [ctypes.c_longlong] * 8
        + [ctypes.c_int, ctypes.c_int, ctypes.c_void_p]
    )
    return fn


def _dense_2d(t: torch.Tensor) -> bool:
    """Row-major or column-major (a transposed view) — the two layouts the
    kernel reads in place through its strides."""
    rows, cols = t.shape
    s0, s1 = t.stride()
    return (s1 == 1 and (rows <= 1 or s0 == cols)) or (
        s0 == 1 and (cols <= 1 or s1 == rows))


def _check_kernel_operands(name, a, b, out_dtype, mats) -> None:
    if a.device.type != "cuda":
        raise ValueError(f"{name}: no kernel for device {a.device}")
    if a.dtype != b.dtype or a.dtype not in _DTYPE_CODE:
        raise TypeError(f"{name} kernel takes f32 or bf16 pairs, got "
                        f"{a.dtype}, {b.dtype}")
    if out_dtype not in _DTYPE_CODE:
        raise TypeError(f"{name} kernel writes f32 or bf16, not {out_dtype}")
    if not all(_dense_2d(t) for t in mats):
        raise ValueError(
            f"{name} kernel takes contiguous (or transposed contiguous) "
            f"matrices, got strides {a.stride()} and {b.stride()}")


def _launch(a, b, c, m, n, k, batch, a_strides, b_strides, c_strides):
    with torch.cuda.device(a.device):
        stream = torch.cuda.current_stream().cuda_stream
        err = _fn()(
            a.data_ptr(), b.data_ptr(), c.data_ptr(), m, n, k, batch,
            *a_strides,         # A strides: batch, row, k
            *b_strides,         # B strides: batch, k, column
            *c_strides,         # C strides: batch, row
            _DTYPE_CODE[a.dtype], _DTYPE_CODE[c.dtype], stream,
        )
    if err:
        raise RuntimeError(f"gemm kernel launch failed: cudaError {err}")


def gemm(a: torch.Tensor, b: torch.Tensor, *,
         out_dtype: Optional[torch.dtype] = None) -> torch.Tensor:
    """C[m, n] = A[m, k] @ B[k, n] with fp32 accumulation.

    A and B must share one dtype (float32 or bfloat16) and one device, and
    each be contiguous or the transpose of a contiguous matrix; ``out_dtype``
    is float32 or bfloat16 (default: the input dtype)."""
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
    _launch(a, b, c, m, n, k, 1, (0, *a.stride()), (0, *b.stride()), (0, n))
    gemm.launches += 1
    return c


gemm.launches = 0


def gemm_batched(a: torch.Tensor, b: torch.Tensor, *,
                 out_dtype: Optional[torch.dtype] = None) -> torch.Tensor:
    """C[z] = A[z] @ B[z] for (Z, m, k) @ (Z, k, n), fp32 accumulation, in
    one launch.

    Each A[z] and B[z] must be contiguous or a transposed contiguous
    matrix; the batch stride is free (a stack, or a broadcast operand with
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
    _launch(a, b, c, m, n, k, z, a.stride(), b.stride(), (m * n, n))
    gemm_batched.launches += 1
    return c


gemm_batched.launches = 0
