"""Hand-written CUDA flash attention (``csrc/flash_attention.cu``) and its
wrapper.

Replaces the reference's Pallas TPU kernel ``_attn_kernel`` via
``flash_attention`` (``src/repro/kernels/flash_attention.py``): full-sequence
online-softmax attention, causal / sliding-window / bidirectional, GQA,
queries right-aligned to the end of the keys, fully masked rows 0.  The
kernel's design and its bound are described in the CUDA source.

:func:`flash_attention` launches the kernel for CUDA tensors and takes the
plain version, :func:`repro_torch.kernels.ref.attention_ref`, only for CPU
tensors.  There is no fallback: a CUDA tensor the kernel does not take
raises.  ``flash_attention.launches`` counts kernel launches.
"""

from __future__ import annotations

import ctypes
import functools
from typing import Optional

import torch

from repro_torch.kernels import _build
from repro_torch.kernels.ref import attention_ref

__all__ = ["flash_attention", "attention_ref"]

_DTYPE_CODE = {torch.float32: 0, torch.bfloat16: 1}
# The kernel's widest head dim; a block then needs 148 KB of shared
# memory, within the H100's 227 KB.
_MAX_D = 256


@functools.lru_cache(maxsize=None)
def _fn():
    fn = _build.library("flash_attention").repro_flash_attention
    fn.restype = ctypes.c_int
    fn.argtypes = (
        [ctypes.c_void_p] * 4
        + [ctypes.c_int] * 9
        + [ctypes.c_float]
        + [ctypes.c_longlong] * 12
        + [ctypes.c_int, ctypes.c_void_p]
    )
    return fn


def flash_attention(
    q: torch.Tensor,
    k: torch.Tensor,
    v: torch.Tensor,
    *,
    causal: bool = True,
    window: Optional[int] = None,
    sm_scale: Optional[float] = None,
) -> torch.Tensor:
    """q: (B, Hq, Sq, D); k, v: (B, Hkv, Skv, D); Hq % Hkv == 0, Skv >= Sq.

    Returns (B, Hq, Sq, D) in ``q.dtype``.  q, k and v may be strided views
    (a transposed head / sequence layout) as long as the head dimension is
    contiguous; ``sm_scale`` defaults to ``D ** -0.5``.  ``window`` keeps
    keys with ``q_pos - kv_pos < window``; a window that leaves a row no
    key (0 or less) makes that row 0, as in the reference."""
    if q.ndim != 4 or k.ndim != 4 or v.shape != k.shape:
        raise ValueError(f"flash_attention: bad shapes q {tuple(q.shape)}, "
                         f"k {tuple(k.shape)}, v {tuple(v.shape)}")
    b, hq, sq, d = q.shape
    _, hkv, skv, dk = k.shape
    if k.shape[0] != b or dk != d or hkv == 0 or hq % hkv:
        raise ValueError(f"flash_attention: q {tuple(q.shape)} does not fit "
                         f"k/v {tuple(k.shape)}")
    if skv < sq:
        raise ValueError(f"flash_attention: kv shorter than q: {skv} < {sq}")
    if q.device.type == "cpu":
        return attention_ref(q, k, v, causal=causal, window=window,
                             sm_scale=sm_scale)
    if q.device.type != "cuda":
        raise ValueError(f"flash_attention: no kernel for device {q.device}")
    if k.device != q.device or v.device != q.device:
        raise ValueError("flash_attention: all operands must be on one device")
    if q.dtype not in _DTYPE_CODE or k.dtype != q.dtype or v.dtype != q.dtype:
        raise TypeError(f"flash_attention kernel takes one of f32/bf16, got "
                        f"{q.dtype}, {k.dtype}, {v.dtype}")
    if not (1 <= d <= _MAX_D):
        raise ValueError(f"flash_attention kernel takes 1 <= D <= {_MAX_D}, "
                         f"got {d}")
    if any(t.stride(3) != 1 for t in (q, k, v) if t.numel()):
        raise ValueError("flash_attention kernel needs a contiguous head dim")
    scale = sm_scale if sm_scale is not None else d ** -0.5
    out = torch.empty((b, hq, sq, d), dtype=q.dtype, device=q.device)
    if out.numel() == 0:
        return out
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream().cuda_stream
        err = _fn()(
            q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
            b, hq, hkv, sq, skv, d, int(bool(causal)),
            int(window is not None), 0 if window is None else int(window),
            float(scale),
            *q.stride()[:3], *k.stride()[:3], *v.stride()[:3],
            *out.stride()[:3], _DTYPE_CODE[q.dtype], stream,
        )
    if err:
        raise RuntimeError(
            f"flash_attention kernel launch failed: cudaError {err}")
    flash_attention.launches += 1
    return out


flash_attention.launches = 0
