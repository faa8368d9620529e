"""Hand-written CUDA flash attention (``csrc/flash_attention.cu``) and its
wrapper.

Replaces the reference's Pallas TPU kernel ``_attn_kernel`` via
``flash_attention`` (``src/repro/kernels/flash_attention.py``): full-sequence
online-softmax attention, causal / sliding-window / bidirectional, GQA,
queries right-aligned to the end of the keys, fully masked rows 0.

The source holds three kernels, and :func:`flash_attention_route` names
the one a call runs, by dtype, head dim, strides and alignment, before the
launch:

* ``"wgmma"`` — bf16 with D 64, 80 or 128 and operands TMA can address
  (the models' forward attention): Hopper tensor cores fed by TMA
  (``csrc/attn_wgmma.cuh``; D 80 on the 128-wide tile, zero-filled);
* ``"tf32x3"`` — f32 with D a multiple of 8 up to 128 and 16-byte-aligned
  operands (the f32 checks): 3xTF32 ``mma.sync`` on the tensor cores,
  fp32-accurate (``csrc/attn_tf32x3.cuh``);
* ``"simt"`` — anything else (bf16 D 32 and other head dims, f32 D not a
  multiple of 8 or over 128, misaligned or broadcast operands): fp32 FMAs
  on the CUDA cores, no TF32.

The route is not a fallback: a launch that fails raises, and is never
retried on the other kernel.  Each kernel's design and bound are described
in its source.

:func:`flash_attention` launches the kernel for CUDA tensors and takes the
plain version, :func:`repro_torch.kernels.ref.attention_ref`, only for CPU
tensors.  There is no fallback: a CUDA tensor the kernel does not take
raises.  ``flash_attention.launches`` counts kernel launches and
``flash_attention.route_launches[route]`` the launches of each route.
"""

from __future__ import annotations

import ctypes
import functools
from typing import Optional

import torch

from repro_torch.kernels import _build
from repro_torch.kernels.gemm import _TMA_ALIGN
from repro_torch.kernels.ref import attention_ref
from repro_torch.obs.spans import measured

__all__ = ["ROUTES", "attention_ref", "flash_attention",
           "flash_attention_route"]

_DTYPE_CODE = {torch.float32: 0, torch.bfloat16: 1}
ROUTES = ("simt", "wgmma", "tf32x3")   # index = the C side's route code
# The CUDA-core kernel's widest head dim; a block then needs 148 KB of
# shared memory, within the H100's 227 KB.
_MAX_D = 256
# The bf16 tensor-core kernel's head dims: the 64- and 128-wide tiles, and
# D 80 on the 128-wide one (TMA zero-fills columns 80-127).  The f32 one
# takes D a multiple of its 8-deep k step, up to 128.
_WGMMA_D = (64, 80, 128)
_TF32X3_MAX_D = 128


def flash_attention_route(dtype: torch.dtype, d: int, strides, ptrs) -> str:
    """The kernel that runs attention on these operands.

    ``strides`` holds the (batch, head, sequence, head-dim) strides in
    elements of q, k, v and the output, ``ptrs`` their addresses.  Both
    tensor-core kernels need a contiguous head dim and 16-byte alignment
    (every base address; every batch, head and sequence stride a positive
    multiple of 16 bytes, so no broadcast).  Then bf16 with D 64, 80 or
    128 takes ``"wgmma"``, f32 with D a multiple of 8 up to 128
    ``"tf32x3"``; anything else ``"simt"``."""
    if dtype == torch.bfloat16 and d in _WGMMA_D:
        route = "wgmma"
    elif dtype == torch.float32 and d % 8 == 0 and d <= _TF32X3_MAX_D:
        route = "tf32x3"
    else:
        return "simt"
    elems = _TMA_ALIGN // dtype.itemsize
    if any(st[3] != 1 or any(x <= 0 or x % elems for x in st[:3])
           for st in strides):
        return "simt"
    if any(p % _TMA_ALIGN for p in ptrs):
        return "simt"
    return route


@functools.lru_cache(maxsize=None)
def _fn():
    fn = _build.library("flash_attention").repro_flash_attention
    fn.restype = ctypes.c_int
    fn.argtypes = (
        [ctypes.c_void_p] * 4
        + [ctypes.c_int] * 9
        + [ctypes.c_float]
        + [ctypes.c_longlong] * 12
        + [ctypes.c_int] * 2 + [ctypes.c_void_p]
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
    out = torch.empty((b, hq, sq, d), dtype=q.dtype, device=q.device)
    operands = (q, k, v, out)
    # The route reads the output's address; under a profiler the rest of
    # the card path is one range, checks to count.
    route = flash_attention_route(q.dtype, d, [t.stride() for t in operands],
                                  [t.data_ptr() for t in operands])
    with measured("kernel", "flash_attention", route):
        if k.device != q.device or v.device != q.device:
            raise ValueError(
                "flash_attention: all operands must be on one device")
        if q.dtype not in _DTYPE_CODE or k.dtype != q.dtype \
                or v.dtype != q.dtype:
            raise TypeError(f"flash_attention kernel takes one of f32/bf16, "
                            f"got {q.dtype}, {k.dtype}, {v.dtype}")
        if not (1 <= d <= _MAX_D):
            raise ValueError(f"flash_attention kernel takes 1 <= D <= "
                             f"{_MAX_D}, got {d}")
        if any(t.stride(3) != 1 for t in (q, k, v) if t.numel()):
            raise ValueError(
                "flash_attention kernel needs a contiguous head dim")
        if out.numel() == 0:
            return out
        scale = sm_scale if sm_scale is not None else d ** -0.5
        with torch.cuda.device(q.device):
            stream = torch.cuda.current_stream().cuda_stream
            err = _fn()(
                q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
                b, hq, hkv, sq, skv, d, int(bool(causal)),
                int(window is not None), 0 if window is None else int(window),
                float(scale),
                *q.stride()[:3], *k.stride()[:3], *v.stride()[:3],
                *out.stride()[:3], _DTYPE_CODE[q.dtype], ROUTES.index(route),
                stream,
            )
        if err:
            raise RuntimeError(f"flash_attention kernel launch failed "
                               f"({route} route): cudaError {err}")
        _build.count_launch(flash_attention, route)
    return out


flash_attention.launches = 0
flash_attention.route_launches = dict.fromkeys(ROUTES, 0)
