"""Hand-written CUDA SSD chunk kernel (``csrc/ssd_scan.cu``) and its wrapper.

Replaces the reference's Pallas TPU kernel ``_ssd_chunk_kernel`` via
``ssd_chunk_diag`` (``src/repro/kernels/ssd_scan.py``): the Mamba-2
within-chunk (diagonal-block) term ``Y = (L ∘ C Bᵀ) X`` for every
(batch·head, chunk) cell, ``L[i, j] = exp(dta_i − dta_j)·[j ≤ i]``.  The
kernels' designs and their bound are described in the CUDA sources.

The source holds two kernels, and :func:`ssd_route` names the one a call
runs, from dtype, widths and alignment, before the launch:

* ``"mma"`` (``csrc/ssd_mma.cuh``) — f32 or bf16 whose rows are whole
  16-byte chunks (P and N multiples of 4 in f32, of 8 in bf16), P ≤ 128,
  16-byte-aligned operands and a block's shared memory within the card's:
  3xTF32 ``mma.sync`` tiles on the tensor cores, fp32 accumulation, the
  causal triangle balanced across blocks by :func:`ssd_plan`.  Every SSD
  launch of the models' forwards takes it;
* ``"simt"`` — the rest (P up to 256, other row widths): fp32 FMAs on the
  CUDA cores.

The route is not a fallback: a launch that fails raises, and is never
retried on the other kernel.

:func:`ssd_chunk_diag` launches the kernel for CUDA tensors and takes the
plain version, :func:`repro_torch.kernels.ref.ssd_chunk_diag_ref`, only for
CPU tensors.  ``ssd_chunk_diag.launches`` counts kernel launches and
``ssd_chunk_diag.route_launches[route]`` the launches of each route.

:func:`ssd_scan` runs the ``ssd_scan`` descriptor's whole core (within-chunk
term, chunk states, the pass over the chunks, the entering states' term and
the D skip) on the card, on one of two routes that :func:`scan_route`
names from what it sees in the operands:

* ``"chunked"`` — f32 x, B, C and dt with P ≤ 128 and N ≤ 128 in whole
  16-byte rows, every address and stride 16-byte aligned, and the blocks'
  shared memory within the card's: three launches (``csrc/ssd_mma.cuh``:
  ``ssd_state_kernel``, ``ssd_pass_kernel`` and the ``ssd_mma_kernel``
  instances of the chunk output) that read x, B and C where they lie (the
  conv's output, sliced) and B and C once a group of heads;
* ``"composed"`` — the rest: B and C repeated per head and the plain
  composition around :func:`ssd_chunk_diag`, as the port ran it before.

``ssd_scan.launches`` / ``.route_launches[route]`` count its calls on the
card by route, ``ssd_scan.kernel_launches`` the chunked route's launches
of each kernel (``"state"``, ``"pass"``, ``"output"``).

The same source holds the mixer's depthwise causal conv + SiLU, which makes
the SSD operands from the x / B / C projections (``csrc/mamba_conv.cuh``):
:func:`causal_conv_silu`, one pass that reads each projection in place and
writes the (B, S, F) f32 result, on route ``"bf16"`` or ``"f32"`` by the
operands' dtype (:func:`conv_route`, which also says when the kernel does
not read them as they lie: such views are copied first, and operands that
no copy makes fit raise).  Its plain version is
:func:`repro_torch.kernels.ref.causal_conv_silu_ref`, for CPU tensors; it
counts ``causal_conv_silu.launches`` and ``.route_launches[route]``.
"""

from __future__ import annotations

import ctypes
import functools
from typing import NamedTuple, Optional, Tuple

import torch

from repro_torch.kernels import _build
from repro_torch.kernels.ref import (causal_conv_silu_ref, ssd_chunk_diag_ref,
                                     ssd_scan_ref)
from repro_torch.obs.spans import measured

__all__ = ["CONV_ROUTES", "ROUTES", "SCAN_KERNELS", "SCAN_ROUTES", "SsdPlan",
           "causal_conv_silu", "causal_conv_silu_ref", "chunk_smem_bytes",
           "conv_route", "heads_per_block", "mma_smem_bytes", "scan_route",
           "ssd_chunk_diag", "ssd_chunk_diag_ref", "ssd_plan", "ssd_route",
           "ssd_scan", "state_stages"]

_DTYPE_CODE = {torch.float32: 0, torch.bfloat16: 1}
ROUTES = ("simt", "mma")         # index = the C side's route code
# The CUDA-core kernel's widest head dim P (16 accumulator columns a thread).
_MAX_P = 256
_MAX_CELLS = 2 ** 31 - 1
_MAX_SMEM = 232_448              # what one block may use on an H100
# csrc/ssd_mma.cuh's geometry: query tiles of 64 rows, key steps of 32,
# two query tiles' C resident, a two-stage ring of B / X tiles, every tile
# stored as TMA boxes of 128-byte rows; head dims up to 128 (16 n-tiles of
# 8); three 8-byte mbarriers.
_BQ, _BK, _STAGES, _MMA_MAX_P, _GROUP = 64, 32, 2, 128, 128
CONV_ROUTES = ("f32", "bf16")    # index = the C side's dtype code
# csrc/mamba_conv.cuh: the conv width it is built for (every Mamba-2
# configuration's), and the channels a thread loads at once.
_CONV_K, _CONV_VEC = 4, 4


def _groups(cols: int, itemsize: int) -> int:
    """Mirrors ``ssd_mma::groups``: 128-byte column groups of a row."""
    return -(-cols * itemsize // _GROUP)


def _np_of(p: int) -> int:
    """Mirrors ``ssd_mma::np_of``: head-dim n-tiles of 8 a warp holds."""
    return 2 if p <= 16 else 4 if p <= 32 else 8 if p <= 64 else 16


def mma_smem_bytes(n: int, p: int, itemsize: int) -> int:
    """Dynamic shared memory of one ``mma`` block: C of two query tiles,
    two ring stages of a key step's B and X, and the mbarriers
    (``ssd_mma::smem_bytes``)."""
    gn, gp = _groups(n, itemsize), _groups(8 * _np_of(p), itemsize)
    return (2 * _BQ * gn + _STAGES * _BK * (gn + gp)) * _GROUP + 64


def ssd_route(dtype: torch.dtype, p: int, n: int, ptrs) -> str:
    """The kernel that runs the SSD chunk term on these operands:
    ``"mma"`` for f32 / bf16 with P ≤ 128, P and N rows of whole 16-byte
    chunks, every address in ``ptrs`` (x, dt_a, b, c, out) a multiple of
    16 bytes except dt_a's, which is read by element, and the block's
    shared memory within the card's; else ``"simt"``."""
    if dtype not in _DTYPE_CODE:
        return "simt"
    e = dtype.itemsize
    x, _, b, c, out = ptrs
    if p <= _MMA_MAX_P and (p * e) % 16 == 0 and (n * e) % 16 == 0 \
            and all(a % 16 == 0 for a in (x, b, c, out)) \
            and mma_smem_bytes(n, p, e) <= _MAX_SMEM:
        return "mma"
    return "simt"


class SsdPlan(NamedTuple):
    """Launch plan of the ``mma`` route for chunks of ``q`` rows (see
    :func:`ssd_plan`)."""

    tiles: int                          # query tiles of 64 rows
    blocks: Tuple[Tuple[int, ...], ...]  # query tiles of each block a cell

    def key_steps(self, tile: int, q: int) -> int:
        """Key steps of 32 keys query tile ``tile`` walks: those up to its
        last row (nothing above the diagonal)."""
        return (min(tile * _BQ + _BQ - 1, q - 1)) // _BK + 1

    def work(self, q: int) -> Tuple[int, ...]:
        """(query tile, key step) pairs each block computes."""
        return tuple(sum(self.key_steps(t, q) for t in blk)
                     for blk in self.blocks)


def ssd_plan(q: int) -> SsdPlan:
    """How the ``mma`` route splits one cell's causal triangle into
    blocks: ``ceil(q / 64)`` query tiles, tile t paired with tile
    ``tiles − 1 − t`` in one block, so every block walks ``tiles + 1``
    tiles' worth of keys (with an odd count, the middle tile has a block
    of its own, with half of that).  The kernel maps block ``p`` of a cell
    to tiles ``(p, tiles − 1 − p)``; the wrapper passes ``tiles`` and the
    number of blocks, and the kernel refuses any other split."""
    if q < 1:
        raise ValueError(f"ssd_plan: chunk length {q} < 1")
    tiles = -(-q // _BQ)
    blocks = tuple(tuple(sorted({t, tiles - 1 - t}))
                   for t in range(-(-tiles // 2)))
    return SsdPlan(tiles, blocks)


@functools.lru_cache(maxsize=None)
def _fn():
    fn = _build.library("ssd_scan").repro_ssd_chunk_diag
    fn.restype = ctypes.c_int
    fn.argtypes = (
        [ctypes.c_void_p] * 5
        + [ctypes.c_longlong]
        + [ctypes.c_int] * 7
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
    n = b.shape[3]
    out = torch.empty_like(x)
    # The route reads the output's address; under a profiler the rest of
    # the card path is one range, checks to count.
    route = ssd_route(x.dtype, p, n, [t.data_ptr() for t in (*ops, out)])
    with measured("kernel", "ssd_scan", route):
        if any(t.device != x.device for t in ops):
            raise ValueError(
                "ssd_chunk_diag: all operands must be on one device")
        if x.dtype not in _DTYPE_CODE or any(t.dtype != x.dtype for t in ops):
            raise TypeError(f"ssd_chunk_diag kernel takes one of f32/bf16, "
                            f"got {[str(t.dtype) for t in ops]}")
        if not all(t.is_contiguous() for t in ops):
            raise ValueError("ssd_chunk_diag kernel takes contiguous operands")
        if not (1 <= p <= _MAX_P) or n < 1:
            raise ValueError(f"ssd_chunk_diag kernel takes 1 <= P <= "
                             f"{_MAX_P} and N >= 1, got P {p}, N {n}")
        if bh * nc > _MAX_CELLS:
            raise ValueError(f"ssd_chunk_diag kernel takes < 2^31 cells, got "
                             f"{bh * nc}")
        if out.numel() == 0:
            return out
        plan = ssd_plan(q)
        with torch.cuda.device(x.device):
            stream = torch.cuda.current_stream().cuda_stream
            err = _fn()(
                x.data_ptr(), dt_a.data_ptr(), b.data_ptr(), c.data_ptr(),
                out.data_ptr(), bh * nc, q, p, n, _DTYPE_CODE[x.dtype],
                ROUTES.index(route), plan.tiles, len(plan.blocks), stream,
            )
        if err:
            raise RuntimeError(f"ssd_chunk_diag kernel ({route}) launch "
                               f"failed: cudaError {err}")
        _build.count_launch(ssd_chunk_diag, route)
    return out


ssd_chunk_diag.launches = 0
ssd_chunk_diag.route_launches = dict.fromkeys(ROUTES, 0)


# csrc/ssd_mma.cuh's chunked core: score slabs of 16 keys, a ring of up to
# 8 X slabs in the state kernel's eight warps, at most 16 heads a block.
SCAN_ROUTES = ("composed", "chunked")
SCAN_KERNELS = ("state", "pass", "output")
_BKS, _MAX_SSTAGES, _MAX_HG, _MAX_PN = 16, 8, 16, 128


def _round_q(q: int) -> int:
    return -(-q // _BQ) * _BQ


def chunk_smem_bytes(q: int, n: int, p: int) -> int:
    """Dynamic shared memory of one chunk-output block: the C tile, S of
    every (row, key) pair up to Q, two ring stages, the mbarriers
    (``ssd_mma::chunk_smem_bytes``)."""
    gn, gp = _groups(n, 4), _groups(8 * _np_of(p), 4)
    stage = max(_BKS * gn, _BK * gp) * _GROUP
    return _BQ * gn * _GROUP + _round_q(q) * 256 + 2 * stage + 64


def state_stages(q: int, n: int, p: int, hg: int) -> int:
    """X-slab ring stages of one chunk-state block: as many as fit beside
    the chunk's B, the block's row weights and the mbarriers, up to 8; 0
    where fewer than 2 fit (``ssd_mma::state_stages``)."""
    fixed = (_round_q(q) * _groups(n, 4) * _GROUP + hg * _round_q(q) * 4
             + 16 * (_MAX_SSTAGES + 1))
    k = (_MAX_SMEM - fixed) // (_BK * _groups(8 * _np_of(p), 4) * _GROUP)
    return 0 if k < 2 else min(k, _MAX_SSTAGES)


def heads_per_block(heads_per_group: int) -> int:
    """Heads one block of the chunked route walks: the most, up to 16, that
    divide a group's heads (every head of a block reads one group)."""
    return max(d for d in range(1, min(_MAX_HG, heads_per_group) + 1)
               if heads_per_group % d == 0)


def _in_place_f32(t: torch.Tensor) -> bool:
    """A (B, S, heads, width) f32 operand the chunked route reads as it
    lies: unit stride along the width, the other strides and the address
    in whole 16-byte chunks, no stride 0."""
    return t.dtype == torch.float32 and t.stride(3) == 1 \
        and all(st > 0 and st % 4 == 0 for st in t.stride()[:3]) \
        and t.data_ptr() % 16 == 0


def scan_route(xh, dt, bh, ch, chunk: int) -> str:
    """The route :func:`ssd_scan` takes on the card (which alone calls it,
    so the device is not checked here): ``"chunked"`` for f32 x, B, C and
    dt on one device with 4 ≤ P ≤ 128 and 4 ≤ N ≤ 128 multiples of 4, x, B
    and C read in place (:func:`_in_place_f32`) and both kernels' shared
    memory within a block's; else ``"composed"``."""
    bsz, s, h, p = xh.shape
    g, n = bh.shape[2], bh.shape[3]
    q = min(int(chunk), s)
    ops = (xh, dt, bh, ch)
    if any(t.device != xh.device for t in ops) \
            or dt.dtype != torch.float32 \
            or not all(_in_place_f32(t) for t in (xh, bh, ch)) \
            or not (0 < p <= _MAX_PN and 0 < n <= _MAX_PN) or p % 4 or n % 4 \
            or chunk_smem_bytes(q, n, p) > _MAX_SMEM \
            or not state_stages(q, n, p, heads_per_block(h // g)):
        return "composed"
    return "chunked"


@functools.lru_cache(maxsize=None)
def _scan_fn():
    fn = _build.library("ssd_scan").repro_ssd_scan_chunked
    fn.restype = ctypes.c_int
    fn.argtypes = ([ctypes.c_void_p] * 8 + [ctypes.POINTER(ctypes.c_longlong)]
                   + [ctypes.c_int] * 8 + [ctypes.c_void_p])
    return fn


def _composed(xh, dt, a, bh, ch, d_skip, chunk):
    """The plain composition around the SSD chunk kernel (B and C repeated
    per head), the kernel lowering the port ran before the chunked route."""
    def diag(x_bh, cum_bh, b_bh, c_bh):
        # The kernel takes one dtype; the log-decays are fp32 in the kernel
        # whatever they arrive in, as in the reference's Pallas kernel.
        return ssd_chunk_diag(x_bh.contiguous(), cum_bh.float().contiguous(),
                              b_bh.contiguous(), c_bh.contiguous())

    return ssd_scan_ref(xh, dt, a, bh, ch, d_skip, chunk, diag)


def ssd_scan(xh: torch.Tensor, dt: torch.Tensor, a: torch.Tensor,
             bh: torch.Tensor, ch: torch.Tensor, d_skip: torch.Tensor, *,
             chunk: int) -> torch.Tensor:
    """The whole Mamba-2 SSD core: xh (B, S, H, P), dt (B, S, H) fp32, a and
    d_skip (H,), bh and ch (B, S, G, N) with H % G == 0 (G = H: per head).
    Returns (B, S, H, P) fp32, contiguous.  CPU tensors take the plain core
    (:func:`~repro_torch.kernels.ref.ssd_scan_ref`); on the card the route
    :func:`scan_route` names."""
    bsz, s, h, p = xh.shape
    g, n = bh.shape[2], bh.shape[3]
    q = min(int(chunk), s)
    if xh.device.type == "cpu":
        return ssd_scan_ref(xh, dt, a, bh, ch, d_skip, chunk)
    if xh.device.type != "cuda":
        raise ValueError(f"ssd_scan: no kernel for device {xh.device}")
    route = scan_route(xh, dt, bh, ch, chunk)
    if route == "composed":
        out = _composed(xh, dt, a, bh, ch, d_skip, chunk)
        _build.count_launch(ssd_scan, route)
        return out
    with measured("kernel", "ssd_scan", route):
        hg = heads_per_block(h // g)
        # dt and the within-chunk cumulative log-decays, (B, H, S) and
        # (B, H, C, Q), so that a head's rows lie together.  The sums run
        # along the chunk one position after another, as the plain core's
        # do: a pair's exp(cum_i − cum_j) then keeps the terms the two
        # sums share exact, where a tree-ordered scan of the contiguous
        # axis rounds them apart (3 × the error at Q 256).
        dt_t = dt.transpose(1, 2).contiguous()
        cum = torch.cumsum((dt * a).view(bsz, s // q, q, h), dim=2) \
            .permute(0, 3, 1, 2).float().contiguous()
        d32 = d_skip.float().contiguous()
        states = torch.empty((bsz, s // q, h, n, p), dtype=torch.float32,
                             device=xh.device)
        out = torch.empty((bsz, s, h, p), dtype=torch.float32,
                          device=xh.device)
        if out.numel() == 0:
            return out
        strides = (ctypes.c_longlong * 9)(
            *(st for t in (xh, bh, ch) for st in t.stride()[:3]))
        with torch.cuda.device(xh.device):
            stream = torch.cuda.current_stream().cuda_stream
            err = _scan_fn()(
                xh.data_ptr(), bh.data_ptr(), ch.data_ptr(), dt_t.data_ptr(),
                cum.data_ptr(), d32.data_ptr(), states.data_ptr(),
                out.data_ptr(), strides, bsz, s, h, g, p, n, q, hg, stream)
        if err:
            raise RuntimeError(f"ssd_scan kernels ({route}) launch failed: "
                               f"cudaError {err}")
        _build.count_launch(ssd_scan, route, kernels=SCAN_KERNELS)
    return out


ssd_scan.launches = 0
ssd_scan.route_launches = dict.fromkeys(SCAN_ROUTES, 0)
ssd_scan.kernel_launches = dict.fromkeys(SCAN_KERNELS, 0)


def _conv_dims(x, b, c, w, bias):
    """(B, S, di, gn, K) of a conv call; raises on shapes that do not fit."""
    if x.ndim != 3 or b.ndim != 3 or c.shape != b.shape \
            or b.shape[:2] != x.shape[:2]:
        raise ValueError(f"causal_conv_silu: bad shapes x {tuple(x.shape)}, "
                         f"b {tuple(b.shape)}, c {tuple(c.shape)}")
    bsz, s, di = x.shape
    gn = b.shape[2]
    f = di + 2 * gn
    if w.ndim != 2 or w.shape[1] != f or tuple(bias.shape) != (f,):
        raise ValueError(f"causal_conv_silu: w {tuple(w.shape)} / bias "
                         f"{tuple(bias.shape)} do not fit F {f}")
    return bsz, s, di, gn, w.shape[0]


def _conv_shape_route(x, b, c, w, bias) -> Optional[str]:
    """The route by what no copy changes: the five on one device in one
    dtype, f32 or bf16; K 4; widths di and G·N in whole vectors of 4
    channels.  None where one of these fails."""
    _conv_dims(x, b, c, w, bias)
    ops = (x, b, c, w, bias)
    if any(t.device != x.device for t in ops) or x.dtype not in _DTYPE_CODE \
            or any(t.dtype != x.dtype for t in ops) \
            or w.shape[0] != _CONV_K \
            or x.shape[2] % _CONV_VEC or b.shape[2] % _CONV_VEC:
        return None
    return CONV_ROUTES[_DTYPE_CODE[x.dtype]]


def _reads_in_place(t: torch.Tensor) -> bool:
    """x, B or C as the kernel reads it: unit channel stride, batch and
    sequence strides in whole 4-channel vectors, the address aligned to one
    such vector (8 bytes in bf16, 16 in f32)."""
    return t.stride(2) == 1 and not (
        t.stride(0) % _CONV_VEC or t.stride(1) % _CONV_VEC
        or t.data_ptr() % (_CONV_VEC * t.dtype.itemsize))


def conv_route(x, b, c, w, bias) -> Optional[str]:
    """The route :func:`causal_conv_silu`'s kernel takes on these operands
    as they lie, or None where it takes them not: the five on one device
    (the kernel's call needs it to be a card) in one dtype, f32 (``"f32"``)
    or bf16 (``"bf16"``); K 4; x, B and C read in place (unit channel
    stride, widths, batch and sequence strides in whole vectors of 4
    channels, addresses aligned to one such vector); w and bias contiguous
    (read element by element, any alignment)."""
    route = _conv_shape_route(x, b, c, w, bias)
    if route is None or not (w.is_contiguous() and bias.is_contiguous()) \
            or not all(_reads_in_place(t) for t in (x, b, c)):
        return None
    return route


@functools.lru_cache(maxsize=None)
def _conv_fn():
    fn = _build.library("ssd_scan").repro_causal_conv_silu
    fn.restype = ctypes.c_int
    fn.argtypes = ([ctypes.c_void_p] * 6 + [ctypes.POINTER(ctypes.c_longlong)]
                   + [ctypes.c_int] * 7 + [ctypes.c_void_p])
    return fn


def causal_conv_silu(x: torch.Tensor, b: torch.Tensor, c: torch.Tensor,
                     w: torch.Tensor, bias: torch.Tensor, *,
                     silu: bool = True) -> torch.Tensor:
    """SiLU of the depthwise causal conv of x (B, S, di), B and C (B, S, gn)
    side by side: (B, S, di + 2·gn) fp32, the plain version's result
    (:func:`~repro_torch.kernels.ref.causal_conv_silu_ref`) with the same
    pre-activation bit for bit.  w: (K, F); bias: (F,).  ``silu=False``
    returns that pre-activation (the conv rounded to the operands' dtype,
    in f32); it exists for the checks that hold the kernel to the plain
    version bit for bit.  CPU tensors take the plain version.  On the card
    a view the kernel cannot read in place (:func:`conv_route`) is copied
    to a contiguous tensor first; operands that no copy makes fit (another
    dtype, K or width) raise."""
    bsz, s, di, gn, k = _conv_dims(x, b, c, w, bias)
    if x.device.type == "cpu":
        return causal_conv_silu_ref(x, b, c, w, bias, silu=silu)
    if x.device.type != "cuda":
        raise ValueError(f"causal_conv_silu: no kernel for device {x.device}")
    route = _conv_shape_route(x, b, c, w, bias)
    if route is None:
        raise ValueError(
            "causal_conv_silu kernel takes f32 / bf16 operands on one card, "
            f"K {_CONV_K}, widths in {_CONV_VEC}-channel vectors; got "
            f"{[str(t.dtype) for t in (x, b, c, w, bias)]}, K {k}, widths "
            f"{di}, {gn}")
    x, b, c = (t if _reads_in_place(t)
               else t.clone(memory_format=torch.contiguous_format)
               for t in (x, b, c))
    w, bias = w.contiguous(), bias.contiguous()
    with measured("kernel", "causal_conv", route):
        out = torch.empty((bsz, s, di + 2 * gn), dtype=torch.float32,
                          device=x.device)
        if out.numel() == 0:
            return out
        strides = (ctypes.c_longlong * 6)(
            *(st for t in (x, b, c) for st in t.stride()[:2]))
        with torch.cuda.device(x.device):
            stream = torch.cuda.current_stream().cuda_stream
            err = _conv_fn()(
                x.data_ptr(), b.data_ptr(), c.data_ptr(), w.data_ptr(),
                bias.data_ptr(), out.data_ptr(), strides, bsz, s, di, gn, k,
                int(silu), _DTYPE_CODE[x.dtype], stream)
        if err:
            raise RuntimeError(f"causal_conv_silu kernel ({route}) launch "
                               f"failed: cudaError {err}")
        _build.count_launch(causal_conv_silu, route)
    return out


causal_conv_silu.launches = 0
causal_conv_silu.route_launches = dict.fromkeys(CONV_ROUTES, 0)
