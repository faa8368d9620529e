"""Hand-written CUDA flash decode (``csrc/flash_decode.cu``) and its wrapper.

Replaces the reference's Pallas TPU kernel ``_decode_kernel`` via
``flash_decode`` (``src/repro/kernels/flash_decode.py``): one query token
per (batch, q head) against a KV cache, attending the slots in
``[lo[b], hi[b])`` with fp32 online softmax and GQA.  On the H100 it is
bound by the bytes of the valid K and V slots over 3.35 TB/s; the design
(the cache split across a thread-block cluster sized to the card, TMA
copies into per-warp rings, the GQA group scored on the tensor cores) is
described in the CUDA source.

The source holds two kernels, and :func:`flash_decode_route` names the one
a call runs, by dtype, head dim and alignment, before the launch:

* ``"mma"`` — bf16 with D a multiple of 16 and 16-byte-aligned operands
  (the serving path): ``mma.sync`` on the tensor cores, fp32 softmax and
  accumulators;
* ``"simt"`` — anything else (f32, other head dims, misaligned operands):
  fp32 FMAs on the CUDA cores, no TF32, so f32 stays true fp32.

:func:`decode_plan` fixes the launch (splits of the cache, slots per
split, slots per warp step) from the shapes, the dtype, the route and the
card's cluster capacity (:func:`cluster_capacity`), never from ``lo`` /
``hi``.  The route is not a fallback: a launch that fails raises, and is
never retried on the other kernel.

:func:`flash_decode` launches the kernel for CUDA tensors and takes the
plain version, :func:`repro_torch.kernels.ref.decode_attention_ref`, only
for CPU tensors.  ``flash_decode.launches`` counts kernel launches and
``flash_decode.route_launches[route]`` the launches of each route.
"""

from __future__ import annotations

import ctypes
import functools
from typing import NamedTuple, Optional

import torch

from repro_torch.kernels import _build
from repro_torch.kernels.ref import decode_attention_ref
from repro_torch.obs.spans import measured

__all__ = ["ROUTES", "DecodePlan", "cluster_capacity", "decode_attention_ref",
           "decode_plan", "flash_decode", "flash_decode_route", "smem_bytes"]

_DTYPE_CODE = {torch.float32: 0, torch.bfloat16: 1}
ROUTES = ("simt", "mma")         # index = the C side's route code
_MAX_SMEM = 232_448              # what one block may use on an H100
# csrc/flash_decode.cu's geometry: 4 warps a block, each with a ring of 3
# steps; a block serves at most 8 q heads (one head group); the splits of
# the cache form a cluster of at most 8 blocks.
_WARPS, _STAGES, _HEADS, _MAX_SPLITS = 4, 3, 8, 8
_MMA_STEP = 16                   # slots per warp step on the mma route
# A split holds at least 256 slots, so its pipeline runs long against its
# share of the merge.
_MIN_SPLIT = 256


def flash_decode_route(dtype: torch.dtype, d: int, ptrs) -> str:
    """The kernel that runs decode attention on these operands: ``"mma"``
    for bf16 with D a multiple of 16 (at most 256) and every address in
    ``ptrs`` (q, k, v) a multiple of 16 bytes, else ``"simt"``."""
    if dtype == torch.bfloat16 and d % 16 == 0 and d <= 256 \
            and all(p % 16 == 0 for p in ptrs):
        return "mma"
    return "simt"


def _ceil(a: int, b: int) -> int:
    return -(-a // b)


def _row_bytes(d: int, itemsize: int) -> int:
    """Shared-memory row stride of a cache row (mirrors ``row_bytes``):
    its 16-byte chunks plus one or two, an odd count."""
    nc = _ceil(d * itemsize, 16)
    return (nc + 1 + (nc & 1)) * 16


class DecodePlan(NamedTuple):
    """Launch plan of flash decode (see :func:`decode_plan`), every field
    passed to the kernel's entry point."""

    splits: int         # blocks along the cache: the cluster's size, <= 8
    per: int            # cache slots per split (a multiple of 16)
    step: int           # slots per warp step: 16 (mma), 16 or 8 (simt)


def _step(d: int, dtype: torch.dtype, route: str) -> int:
    """Slots per warp step: 16, or 8 on the CUDA-core route when a cache
    row's shared-memory stride exceeds 544 bytes (f32 D > 128)."""
    if route == "simt" and _row_bytes(d, dtype.itemsize) > 544:
        return 8
    return _MMA_STEP


def decode_plan(b: int, hq: int, hkv: int, s: int, d: int,
                dtype: torch.dtype, route: str, clusters) -> DecodePlan:
    """The launch of flash decode for q (B, Hq, D) against a (B, Hkv, S,
    D) cache.

    A function of shapes, dtype, route and the card — never of the
    per-row bounds, which live on the device — so the same cache shape
    always runs the same schedule.  The launch runs one cluster per (b,
    kv head, head group of 8 q heads); ``clusters[n - 1]`` is how many
    clusters of n blocks the card holds at once
    (:func:`cluster_capacity`).  ``splits`` is the most, up to 8 (a
    portable cluster) and S // 256, whose clusters all fit on the card at
    once — a second wave of a few clusters would double the time — and 1
    if none does.  ``per`` rounds S / splits up to 16 slots, and trailing
    splits that would start past S are dropped."""
    pairs = b * hkv * _ceil(hq // hkv, _HEADS)
    top = max(1, min(_MAX_SPLITS, s // _MIN_SPLIT))
    splits = max([n for n in range(1, top + 1) if pairs <= clusters[n - 1]],
                 default=1)
    per = max(16, _ceil(_ceil(s, splits), 16) * 16)
    return DecodePlan(max(1, _ceil(s, per)), per, _step(d, dtype, route))


def smem_bytes(route: str, d: int, itemsize: int, step: int) -> int:
    """Dynamic shared memory of one block (mirrors ``smem_bytes`` in the
    CUDA source): the warps' rings, or the merge's states where larger,
    on the CUDA-core route q as fp32 and the probability tiles, and an
    mbarrier per ring stage."""
    ring = _WARPS * _STAGES * 2 * step * _row_bytes(d, itemsize)
    combine = (_WARPS + 1) * _HEADS * (d + 2) * 4 + _HEADS * _WARPS * 4
    extra = 0
    if route == "simt":
        nc = _ceil(d * itemsize, 16)
        extra = _HEADS * nc * (16 // itemsize) * 4 + _WARPS * step * _HEADS * 4
    return max(ring, combine) + extra + _WARPS * _STAGES * 8


@functools.lru_cache(maxsize=None)
def _fn():
    fn = _build.library("flash_decode").repro_flash_decode
    fn.restype = ctypes.c_int
    fn.argtypes = (
        [ctypes.c_void_p] * 6
        + [ctypes.c_int] * 5
        + [ctypes.c_float]
        + [ctypes.c_int] * 6
        + [ctypes.c_void_p]
    )
    return fn


@functools.lru_cache(maxsize=None)
def cluster_capacity(route: str, dtype: torch.dtype, d: int,
                     device: int) -> tuple:
    """Clusters of 1..8 blocks of the (route, dtype, D) kernel that card
    ``device`` holds at once (``cudaOccupancyMaxActiveClusters``), asked
    once per key."""
    fn = _build.library("flash_decode").repro_flash_decode_clusters
    fn.restype = ctypes.c_int
    fn.argtypes = [ctypes.c_int] * 5
    step = _step(d, dtype, route)
    with torch.cuda.device(device):
        caps = tuple(fn(ROUTES.index(route), _DTYPE_CODE[dtype], d, step, n)
                     for n in range(1, _MAX_SPLITS + 1))
    if min(caps) < 0:
        raise RuntimeError(f"flash_decode: cluster occupancy query failed: "
                           f"cudaError {-min(caps)}")
    return caps


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
    ptrs = (q.data_ptr(), k.data_ptr(), v.data_ptr())
    route = flash_decode_route(q.dtype, d, ptrs)
    # Under a profiler the wrapper's card path is one range, checks to count.
    with measured("kernel", "flash_decode", route):
        if any(t.device != q.device for t in (k, v, lo, hi)):
            raise ValueError(
                "flash_decode: all operands must be on one device")
        if q.dtype not in _DTYPE_CODE or k.dtype != q.dtype \
                or v.dtype != q.dtype:
            raise TypeError(f"flash_decode kernel takes one of f32/bf16, got "
                            f"{q.dtype}, {k.dtype}, {v.dtype}")
        if lo.dtype != torch.int32 or hi.dtype != torch.int32:
            raise TypeError("flash_decode: lo/hi must be int32")
        if not (8 <= d <= 256):
            raise ValueError(
                f"flash_decode kernel takes 8 <= D <= 256, got {d}")
        if b > 65535:
            raise ValueError(f"flash_decode kernel takes B <= 65535, got {b}")
        if not all(t.is_contiguous() for t in (q, k, v, lo, hi)):
            raise ValueError("flash_decode kernel takes contiguous operands")
        plan = decode_plan(b, hq, hkv, s, d, q.dtype, route,
                           cluster_capacity(route, q.dtype, d,
                                            q.device.index))
        isz = q.element_size()
        if smem_bytes(route, d, isz, plan.step) > _MAX_SMEM:
            raise ValueError(f"flash_decode: D {d} needs more shared memory "
                             f"than one block has")
        vec16 = int((d * isz) % 16 == 0
                    and all(p % 16 == 0 for p in ptrs[1:]))
        scale = sm_scale if sm_scale is not None else d ** -0.5
        out = torch.empty_like(q)
        with torch.cuda.device(q.device):
            stream = torch.cuda.current_stream().cuda_stream
            err = _fn()(
                q.data_ptr(), k.data_ptr(), v.data_ptr(), lo.data_ptr(),
                hi.data_ptr(), out.data_ptr(), b, hq, hkv, s, d, float(scale),
                _DTYPE_CODE[q.dtype], ROUTES.index(route), plan.splits,
                plan.per, plan.step, vec16, stream,
            )
        if err:
            raise RuntimeError(f"flash_decode kernel launch failed ({route}, "
                               f"{plan}): cudaError {err}")
        _build.count_launch(flash_decode, route)
    return out


flash_decode.launches = 0
flash_decode.route_launches = dict.fromkeys(ROUTES, 0)
