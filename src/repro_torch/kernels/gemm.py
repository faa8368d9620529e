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
"""

from __future__ import annotations

import ctypes
import functools
from typing import Optional

import torch

from repro_torch.kernels import _build
from repro_torch.kernels.ref import gemm_ref

__all__ = ["gemm", "gemm_ref"]

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
    if a.device.type != "cuda":
        raise ValueError(f"gemm: no kernel for device {a.device}")
    if a.dtype != b.dtype or a.dtype not in _DTYPE_CODE:
        raise TypeError(f"gemm kernel takes f32 or bf16 pairs, got {a.dtype}, {b.dtype}")
    if out_dtype not in _DTYPE_CODE:
        raise TypeError(f"gemm kernel writes f32 or bf16, not {out_dtype}")
    if not (_dense_2d(a) and _dense_2d(b)):
        raise ValueError(
            f"gemm kernel takes contiguous (or transposed contiguous) "
            f"operands, got strides {a.stride()} and {b.stride()}")
    m, k = a.shape
    n = b.shape[1]
    c = torch.empty((m, n), dtype=out_dtype, device=a.device)
    with torch.cuda.device(a.device):
        stream = torch.cuda.current_stream().cuda_stream
        err = _fn()(
            a.data_ptr(), b.data_ptr(), c.data_ptr(), m, n, k, 1,
            0, *a.stride(),     # A strides: batch, row, k
            0, *b.stride(),     # B strides: batch, k, column
            0, n,               # C strides: batch, row
            _DTYPE_CODE[a.dtype], _DTYPE_CODE[out_dtype], stream,
        )
    if err:
        raise RuntimeError(f"gemm kernel launch failed: cudaError {err}")
    gemm.launches += 1
    return c


gemm.launches = 0
