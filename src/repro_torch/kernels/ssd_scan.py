"""Hand-written CUDA SSD chunk kernel (``csrc/ssd_scan.cu``) and its wrapper.

Replaces the reference's Pallas TPU kernel ``_ssd_chunk_kernel`` via
``ssd_chunk_diag`` (``src/repro/kernels/ssd_scan.py``): the Mamba-2
within-chunk (diagonal-block) term ``Y = (L ∘ C Bᵀ) X`` for every
(batch·head, chunk) cell, ``L[i, j] = exp(dta_i − dta_j)·[j ≤ i]``.  The
kernel's design and its bound are described in the CUDA source.

:func:`ssd_chunk_diag` launches the kernel for CUDA tensors and takes the
plain version, :func:`repro_torch.kernels.ref.ssd_chunk_diag_ref`, only for
CPU tensors.  There is no fallback: a CUDA tensor the kernel does not take
raises.  ``ssd_chunk_diag.launches`` counts kernel launches.
"""

from __future__ import annotations

import ctypes
import functools

import torch

from repro_torch.kernels import _build
from repro_torch.kernels.ref import ssd_chunk_diag_ref

__all__ = ["ssd_chunk_diag", "ssd_chunk_diag_ref"]

_DTYPE_CODE = {torch.float32: 0, torch.bfloat16: 1}
# The kernel's widest head dim P (16 accumulator columns per thread).
_MAX_P = 256
_MAX_CELLS = 2 ** 31 - 1


@functools.lru_cache(maxsize=None)
def _fn():
    fn = _build.library("ssd_scan").repro_ssd_chunk_diag
    fn.restype = ctypes.c_int
    fn.argtypes = (
        [ctypes.c_void_p] * 5
        + [ctypes.c_longlong]
        + [ctypes.c_int] * 4
        + [ctypes.c_void_p]
    )
    return fn


def ssd_chunk_diag(x: torch.Tensor, dt_a: torch.Tensor, b: torch.Tensor,
                   c: torch.Tensor) -> torch.Tensor:
    """x: (BH, C, Q, P); dt_a: (BH, C, Q); b, c: (BH, C, Q, N).

    Returns (BH, C, Q, P) in ``x.dtype``.  On the card the four operands
    must be contiguous and share one dtype, f32 or bf16; the kernel
    computes in fp32 and rounds once."""
    if x.ndim != 4 or b.ndim != 4 or c.shape != b.shape:
        raise ValueError(f"ssd_chunk_diag: bad shapes x {tuple(x.shape)}, "
                         f"b {tuple(b.shape)}, c {tuple(c.shape)}")
    bh, nc, q, p = x.shape
    if tuple(b.shape[:3]) != (bh, nc, q):
        raise ValueError(f"ssd_chunk_diag: b/c {tuple(b.shape)} do not fit "
                         f"x {tuple(x.shape)}")
    if tuple(dt_a.shape) != (bh, nc, q):
        raise ValueError(f"dt_a shape {tuple(dt_a.shape)} != {(bh, nc, q)}")
    if x.device.type == "cpu":
        return ssd_chunk_diag_ref(x, dt_a, b, c)
    if x.device.type != "cuda":
        raise ValueError(f"ssd_chunk_diag: no kernel for device {x.device}")
    ops = (x, dt_a, b, c)
    if any(t.device != x.device for t in ops):
        raise ValueError("ssd_chunk_diag: all operands must be on one device")
    if x.dtype not in _DTYPE_CODE or any(t.dtype != x.dtype for t in ops):
        raise TypeError(f"ssd_chunk_diag kernel takes one of f32/bf16, got "
                        f"{[str(t.dtype) for t in ops]}")
    if not all(t.is_contiguous() for t in ops):
        raise ValueError("ssd_chunk_diag kernel takes contiguous operands")
    n = b.shape[3]
    if not (1 <= p <= _MAX_P) or n < 1:
        raise ValueError(f"ssd_chunk_diag kernel takes 1 <= P <= {_MAX_P} "
                         f"and N >= 1, got P {p}, N {n}")
    if bh * nc > _MAX_CELLS:
        raise ValueError(f"ssd_chunk_diag kernel takes < 2^31 cells, got "
                         f"{bh * nc}")
    out = torch.empty_like(x)
    if out.numel() == 0:
        return out
    with torch.cuda.device(x.device):
        stream = torch.cuda.current_stream().cuda_stream
        err = _fn()(
            x.data_ptr(), dt_a.data_ptr(), b.data_ptr(), c.data_ptr(),
            out.data_ptr(), bh * nc, q, p, n, _DTYPE_CODE[x.dtype], stream,
        )
    if err:
        raise RuntimeError(f"ssd_chunk_diag kernel launch failed: cudaError "
                           f"{err}")
    ssd_chunk_diag.launches += 1
    return out


ssd_chunk_diag.launches = 0
