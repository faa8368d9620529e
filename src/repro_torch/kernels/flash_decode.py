"""Hand-written CUDA flash decode (``csrc/flash_decode.cu``) and its wrapper.

Replaces the reference's Pallas TPU kernel ``_decode_kernel`` via
``flash_decode`` (``src/repro/kernels/flash_decode.py``): one query token
per (batch, q head) against a KV cache, attending the slots in
``[lo[b], hi[b])`` with fp32 online softmax and GQA.  On the H100 it is
bound by the bytes of the valid K and V slots over 3.35 TB/s; the design
is described in the CUDA source.

:func:`flash_decode` launches the kernel for CUDA tensors and takes the
plain version, :func:`repro_torch.kernels.ref.decode_attention_ref`, only
for CPU tensors.  ``flash_decode.launches`` counts kernel launches.
"""

from __future__ import annotations

import ctypes
import functools
from typing import Optional

import torch

from repro_torch.kernels import _build
from repro_torch.kernels.ref import decode_attention_ref

__all__ = ["flash_decode", "decode_attention_ref", "smem_bytes"]

_DTYPE_CODE = {torch.float32: 0, torch.bfloat16: 1}
_CHUNK = 32                      # csrc/flash_decode.cu CHUNK
_MAX_SMEM = 232_448              # what one block may use on an H100


def smem_bytes(group: int, d: int) -> int:
    """Dynamic shared memory of one block (mirrors ``smem_bytes`` in the
    CUDA source)."""
    return 4 * (2 * group * d + _CHUNK * d + group * _CHUNK + 3 * group) + 4 * _CHUNK


@functools.lru_cache(maxsize=None)
def _fn():
    fn = _build.library("flash_decode").repro_flash_decode
    fn.restype = ctypes.c_int
    fn.argtypes = (
        [ctypes.c_void_p] * 6
        + [ctypes.c_int] * 5
        + [ctypes.c_float, ctypes.c_int, ctypes.c_void_p]
    )
    return fn


def flash_decode(
    q: torch.Tensor,
    k: torch.Tensor,
    v: torch.Tensor,
    lo: torch.Tensor,
    hi: torch.Tensor,
    *,
    sm_scale: Optional[float] = None,
) -> torch.Tensor:
    """q: (B, Hq, D); k, v: (B, Hkv, S, D); lo, hi: (B,) int32 -> (B, Hq, D)."""
    if q.ndim != 3 or k.ndim != 4 or v.shape != k.shape:
        raise ValueError(f"flash_decode: bad shapes q {tuple(q.shape)}, "
                         f"k {tuple(k.shape)}, v {tuple(v.shape)}")
    b, hq, d = q.shape
    _, hkv, s, dk = k.shape
    if k.shape[0] != b or dk != d or hkv == 0 or hq % hkv:
        raise ValueError(f"flash_decode: q {tuple(q.shape)} does not fit "
                         f"cache {tuple(k.shape)}")
    if lo.shape != (b,) or hi.shape != (b,):
        raise ValueError(f"flash_decode: lo/hi must be ({b},), got "
                         f"{tuple(lo.shape)}, {tuple(hi.shape)}")
    if q.device.type == "cpu":
        return decode_attention_ref(q, k, v, lo, hi, sm_scale=sm_scale)
    if q.device.type != "cuda":
        raise ValueError(f"flash_decode: no kernel for device {q.device}")
    if any(t.device != q.device for t in (k, v, lo, hi)):
        raise ValueError("flash_decode: all operands must be on one device")
    if q.dtype not in _DTYPE_CODE or k.dtype != q.dtype or v.dtype != q.dtype:
        raise TypeError(f"flash_decode kernel takes one of f32/bf16, got "
                        f"{q.dtype}, {k.dtype}, {v.dtype}")
    if lo.dtype != torch.int32 or hi.dtype != torch.int32:
        raise TypeError("flash_decode: lo/hi must be int32")
    if not (8 <= d <= 256):
        raise ValueError(f"flash_decode kernel takes 8 <= D <= 256, got {d}")
    if smem_bytes(hq // hkv, d) > _MAX_SMEM:
        raise ValueError(f"flash_decode: group {hq // hkv} x D {d} needs more "
                         f"shared memory than one block has")
    if not all(t.is_contiguous() for t in (q, k, v, lo, hi)):
        raise ValueError("flash_decode kernel takes contiguous operands")
    scale = sm_scale if sm_scale is not None else d ** -0.5
    out = torch.empty_like(q)
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream().cuda_stream
        err = _fn()(
            q.data_ptr(), k.data_ptr(), v.data_ptr(), lo.data_ptr(),
            hi.data_ptr(), out.data_ptr(), b, hq, hkv, s, d, float(scale),
            _DTYPE_CODE[q.dtype], stream,
        )
    if err:
        raise RuntimeError(f"flash_decode kernel launch failed: cudaError {err}")
    flash_decode.launches += 1
    return out


flash_decode.launches = 0
