"""Hand-written CUDA GEMM (``csrc/gemm.cu``) and its wrapper.

Replaces the reference's Pallas TPU kernel ``gemm_kernel`` via
``pallas_gemm`` (``src/repro/kernels/gemm.py``): ``C = A @ B`` with an fp32
accumulator and one rounding to ``out_dtype``.

The source holds four kernels, and :func:`gemm_route` names the one a call
runs, by shape, dtype, layout and alignment, before the launch:

* ``"wgmma"`` — bf16 operands with m > 16 (the forward's and hnp's GEMMs):
  Hopper tensor cores fed by TMA, bound by bf16 FLOPs
  (``csrc/gemm_wgmma.cuh``); :func:`wgmma_plan` fixes the order in which
  the blocks visit the output tiles from the tile counts and the card's
  SM count;
* ``"tf32x3"`` — f32 operands with m > 16, any layout and alignment:
  3xTF32 ``mma.sync`` tiles on the tensor cores fed by a cp.async ring,
  fp32-accurate (``csrc/gemm_tf32x3.cuh``); :func:`tf32x3_plan` fixes the
  tile and the k splits across a cluster from shape and strides — never
  from the batch count;
* ``"skinny"`` — m <= 16 (serving: m = batch), bound by the bytes of B
  (``csrc/gemm_skinny.cuh``): B read once in 16-byte copies, all rows in
  one block, k split across warps and across the blocks of a cluster,
  split partials summed in split order through distributed shared memory
  (no workspace, no atomics); bf16 on the tensor cores, f32 on the CUDA
  cores; :func:`skinny_plan` fixes the launch from shape, dtype, strides
  and alignment — never from the batch count;
* ``"tiled"`` — the bf16 GEMMs with m > 16 that ``wgmma`` cannot take (a
  column-major A, k % 8 != 0 or a misaligned operand): fp32 FMAs on the
  CUDA cores.

The route is not a fallback: a launch that fails raises, and is never
retried on another kernel.

:func:`gemm` launches the kernel for CUDA tensors and takes the plain
version, :func:`repro_torch.kernels.ref.gemm_ref`, only for CPU tensors.
There is no fallback: a CUDA tensor the kernel does not take raises.
``gemm.launches`` counts kernel launches (never plain-version calls),
``gemm.route_launches[route]`` the launches of each route, and
``gemm.grouped_launches`` the ``wgmma`` launches whose tile order is not the
plain one (:func:`wgmma_plan`).

:func:`gemm_batched` replaces ``pallas_gemm_batched`` (same source file,
the same ``gemm_kernel`` with the batch as the outermost parallel grid
axis): ``C[z] = A[z] @ B[z]``, launched as one grid over ``blockIdx.z``
with the operands' own batch strides.  It has its own counter,
``gemm_batched.launches``, so a stacked launch is told apart from a
single one, and its own ``gemm_batched.route_launches`` and
``gemm_batched.grouped_launches``.

:func:`gemm_grouped` is the dropless MoE's ragged grouped GEMM (its own
entry point in the same source, ``csrc/gemm_grouped.cuh``): ``C[r] = A[r]
@ B[e]`` for the rows ``offsets[e]:offsets[e+1]`` of A, rows sorted by
expert, the (E+1,) int32 offsets on the card.  It runs ``wgmma``'s
producer, ring, consumers and epilogue over a tile table that each block
builds from the offsets on the card, in a grid of ``ceil(R / 128) + E``
rows of m tiles by the n tiles, so the host never reads the counts; its
one route is ``"wgmma"`` (bf16 operands, B row-major, TMA's alignment),
and a CUDA tensor it cannot take raises.  Its kernel is ``grouped_wgmma``,
a name no other kernel's contains.  ``gemm_grouped.launches`` and
``gemm_grouped.route_launches`` count it; the plain version is
:func:`repro_torch.kernels.ref.gemm_grouped_ref`.  It is reached as the
ragged route of the ``moe_expert_ffn`` descriptor (``core/blas.py``).
"""

from __future__ import annotations

import ctypes
import functools
import math
from typing import NamedTuple, Optional, Tuple

import torch

from repro_torch.kernels import _build
from repro_torch.kernels.ref import gemm_batched_ref, gemm_grouped_ref, gemm_ref
from repro_torch.obs.spans import measured

__all__ = ["ROUTES", "SkinnyPlan", "Tf32x3Plan", "gemm", "gemm_batched",
           "gemm_batched_ref", "gemm_grouped", "gemm_grouped_ref", "gemm_ref", "gemm_route", "skinny_plan",
           "sm_count", "tf32x3_capacity", "tf32x3_plan", "wgmma_block_tile",
           "wgmma_plan"]

_DTYPE_CODE = {torch.float32: 0, torch.bfloat16: 1}
ROUTES = ("skinny", "tiled", "wgmma", "tf32x3")   # index = the C side's code
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
    ``"skinny"``; f32 operands ``"tf32x3"`` whatever their layout and
    alignment.  bf16 operands with a row-major A, a B with unit k- or
    n-stride, and the 16-byte alignment TMA needs take ``"wgmma"``; the
    other bf16 operands ``"tiled"``."""
    if m <= 16:
        return "skinny"
    if dtype == torch.float32:
        return "tf32x3"
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


# The tf32x3 kernels' block tiles (csrc/gemm_tf32x3.cuh; index = the C
# side's tile code) and the warps of a block (4 for every tile).
_T3_TILES = ((128, 64), (64, 64), (32, 32))
_T3_WARPS = 4
# The plan's time model, fit to every plan tools/gemm_f32_times.py --plans
# timed on an H100 SXM at 700 W (18 shapes, 3 tiles, 1-8 splits; the
# chosen plan within 5 % of the fastest at each, and within 7 % at the
# tool's held-out single matrices; a stack of many matrices gets one
# matrix's plan, up to 2.1 × the fastest for it).  Blocks run in rounds of
# at most the tile's capacity; a round costs a fill and drain, a
# cluster's split-k sum (a fixed part and a part per output of the tile),
# and the MACs of the blocks that share an SM over the SM's rate for the
# tile, which a tile reaches only with enough warps on the SM (the share
# falls as (warps / full)^0.45 below that).  k is split 1, 2, 4, 7 or 8
# ways, at least _T3_MIN_KC rows a split: clusters of 3, 5 and 6 blocks
# land unevenly on the SMs (64×64 blocks in clusters of 3 ran 1.3 × the
# model's time), which the card's capacity (:func:`tf32x3_capacity`)
# does not show.
_T3_SPLITS = (1, 2, 4, 7, 8)
_T3_RATE = {(128, 64): 233.2e3, (64, 64): 211.9e3,
            (32, 32): 134.9e3}              # MACs per µs of one SM
_T3_FULL_WARPS = {(128, 64): 8, (64, 64): 16, (32, 32): 28}
_T3_SHARE_EXP = 0.45
_T3_ROUND_US = 2.65
_T3_SPLIT_US, _T3_SPLIT_US_PER_OUT = 1.13, 0.398e-3
_T3_MIN_KC = 16


def _t3_cost(m: int, n: int, bm: int, bn: int, splits: int, kc: int,
             cap: int) -> float:
    """The plan model's µs for one matrix on tile (bm, bn) with k cut into
    ``splits`` ranges of ``kc`` rows, of which blocks the card holds
    ``cap`` at once."""
    tile = (bm, bn)
    blocks = -(-m // bm) * -(-n // bn) * splits

    def one_round(nb: int) -> float:
        per_sm = -(-nb // _SK_SMS)
        share = min(1.0, per_sm * _T3_WARPS
                    / _T3_FULL_WARPS[tile]) ** _T3_SHARE_EXP
        split = (_T3_SPLIT_US + _T3_SPLIT_US_PER_OUT * bm * bn
                 if splits > 1 else 0.0)
        return (_T3_ROUND_US + split
                + per_sm * bm * bn * kc / (_T3_RATE[tile] * share))

    full, rem = divmod(blocks, cap)
    return full * one_round(cap) + (one_round(rem) if rem else 0.0)


class Tf32x3Plan(NamedTuple):
    """Launch plan of the tf32x3 route (see :func:`tf32x3_plan`), every
    field passed to the kernel's entry point."""

    bm: int             # block tile rows
    bn: int             # block tile columns
    splits: int         # blocks along k: the cluster's size, at most 8
    kc: int             # k rows per split (a multiple of 8)
    a_kmajor: bool      # A staged k-contiguous (row-major A)
    b_kmajor: bool      # B staged k-contiguous (K-major B)
    a_vec: bool         # A in 16-byte copies
    b_vec: bool         # B in 16-byte copies


def _t3_vec(ptr: int, unit: int, other: int, batch_stride: int) -> bool:
    return unit == 1 and other % 4 == 0 and batch_stride % 4 == 0 \
        and ptr % 16 == 0


@functools.lru_cache(maxsize=None)
def tf32x3_capacity(device: int) -> dict:
    """{(bm, bn): blocks of that tile's tf32x3 kernel that card ``device``
    holds at once in clusters of 1..8 blocks} (a tuple of 8,
    ``cudaOccupancyMaxActiveClusters``), asked once per card."""
    fn = _build.library("gemm").repro_gemm_tf32x3_capacity
    fn.restype = ctypes.c_int
    fn.argtypes = [ctypes.c_int, ctypes.c_int, ctypes.POINTER(ctypes.c_int)]
    caps = {}
    with torch.cuda.device(device):
        for code, tile in enumerate(_T3_TILES):
            row = []
            for splits in range(1, 9):
                blocks = ctypes.c_int(0)
                err = fn(code, splits, ctypes.byref(blocks))
                if err or blocks.value < splits:
                    raise RuntimeError(
                        f"gemm: tf32x3 occupancy query failed ({tile}, "
                        f"{splits} splits): cudaError {err}, "
                        f"{blocks.value} blocks")
                row.append(blocks.value)
            caps[tile] = tuple(row)
    return caps


def tf32x3_plan(m: int, n: int, k: int, dtype: torch.dtype, a_strides,
                b_strides, a_ptr: int, b_ptr: int,
                capacity: dict) -> Tf32x3Plan:
    """The launch of the tf32x3 kernels for an f32 ``C[z] = A[z] @ B[z]``.

    A function of shape, strides (``a_strides`` A's (batch, row, k),
    ``b_strides`` B's (batch, k, column), in elements) and addresses
    alone: it never sees the batch count, so a stacked launch runs each
    matrix exactly as its single launch does.  The tile and the splits
    (k cut into ``splits`` ranges of ``kc`` rows, summed in split order
    across a cluster) come from m, n and k alone, the least time of the
    model :func:`_t3_cost` over the card's ``capacity``
    (:func:`tf32x3_capacity`'s table); the layouts and the copy widths, which change
    no bit of the result, follow the strides and addresses: A is staged
    k-contiguous unless only its row stride is 1 (column-major), B
    k-contiguous when only its k stride is 1 (K-major); 16-byte copies
    where the unit-stride dimension's rows and the batch stride are
    multiples of 4 floats and the address 16-byte aligned."""
    if dtype != torch.float32:
        raise ValueError(f"tf32x3_plan: f32 operands only, not {dtype}")
    sa_b, sa_m, sa_k = a_strides
    sb_b, sb_k, sb_n = b_strides
    a_kmajor = sa_k == 1 or sa_m != 1
    b_kmajor = sb_k == 1 and sb_n != 1
    a_vec = (_t3_vec(a_ptr, sa_k, sa_m, sa_b) if a_kmajor
             else _t3_vec(a_ptr, sa_m, sa_k, sa_b))
    b_vec = (_t3_vec(b_ptr, sb_k, sb_n, sb_b) if b_kmajor
             else _t3_vec(b_ptr, sb_n, sb_k, sb_b))
    kk = max(k, 1)
    best = None
    for bm, bn in _T3_TILES:
        for want in _T3_SPLITS:
            kc = 8 * -(-kk // (8 * want))
            splits = -(-kk // kc)
            if splits != want or (splits > 1 and kc < _T3_MIN_KC):
                continue
            key = (_t3_cost(m, n, bm, bn, splits, kc,
                            capacity[(bm, bn)][splits - 1]),
                   splits, -bm * bn)
            if best is None or key < best[0]:
                best = (key, bm, bn, splits, kc)
    _, bm, bn, splits, kc = best
    return Tf32x3Plan(bm, bn, splits, kc, a_kmajor, b_kmajor, a_vec, b_vec)


# The wgmma kernel's block tile (csrc/gemm_wgmma.cuh): 128 rows by 128
# columns, or 64 where n <= 64.
_WG_BM = 128


def wgmma_block_tile(block: int, m_tiles: int, n_tiles: int,
                     group: int) -> Tuple[int, int]:
    """(m tile, n tile) that block ``block`` of one batch entry computes,
    in the order of :func:`wgmma_plan`; ``csrc/gemm_wgmma.cuh`` maps its
    blocks with the same arithmetic."""
    span = group * n_tiles
    first = block // span * group
    rows = min(m_tiles - first, group)
    r = block % span
    return first + r % rows, r // rows


@functools.lru_cache(maxsize=None)
def sm_count(device: int) -> int:
    """Streaming multiprocessors of card ``device``, asked once per card."""
    return torch.cuda.get_device_properties(device).multi_processor_count


@functools.lru_cache(maxsize=4096)
def wgmma_plan(m: int, n: int, k: int, batch: int, sms: int) -> int:
    """The tile order of the wgmma kernel for ``C[z] = A[z] @ B[z]`` on
    a card of ``sms`` SMs: ``group``, the m tiles of a group.

    The kernel's blocks of one batch entry get linear ids in the order the
    card starts them, ``block = n_idx * m_tiles + m_idx`` over its grid of
    ``m_tiles = ceil(m / 128)`` by ``n_tiles`` (``ceil(n / 128)``, or 1
    where n <= 64), and block ``block`` computes tile
    (:func:`wgmma_block_tile`)::

        span  = group * n_tiles            # blocks of one whole group
        first = block // span * group      # the group's first m tile
        rows  = min(m_tiles - first, group)  # the last group may be short
        r     = block % span
        tile  = (first + r % rows, r // rows)   # (m tile, n tile)

    so within a group m runs fastest, then n, then the next group.  A group
    of all ``m_tiles`` is the plain order (tile = (block % m_tiles, block //
    m_tiles)).  Only which block computes which tile changes, so C is the
    same bits in every order.

    The rule: one block runs on each SM, so the card works on a wave of
    ``sms`` consecutive blocks at a time, and a wave reads each A and B
    panel of its tiles from HBM once (the L2 holds a panel while the
    wave's blocks walk k together).  In groups of g a wave covers g m
    tiles by the columns that ``sms`` blocks span from where the wave
    starts in a column, ``ceil((o + sms) / g)`` for a start o; over the
    starts that successive waves take (the multiples of gcd(g, sms)) that
    is, on average, :func:`_wave_columns`.  The plan is the g in 1 ..
    m_tiles with the fewest panels a wave, g plus those columns, the larger
    on a tie.  A grid that fits in one wave reads every panel once in any
    order and keeps the plain one; so does every launch whose best g is
    all its m tiles (m <= 1024 on 132 SMs).  On an H100 (132 SMs) the rule
    gives 12 at yi-6b's prefill shapes (a wave is a 12 x 11 patch, 23
    panels, against 129-130 in the plain order), the fastest of the groups
    ``tools/gemm_bf16_times.py --orders`` timed there.  k is not read (at k
    11008 groups 6 to 12 ran within 1 % of each other), nor ``batch``
    (each batch entry is ordered alone).  Returns at most ``m_tiles``, and
    exactly ``m_tiles`` for the plain order."""
    m_tiles = -(-m // _WG_BM)
    n_tiles = 1 if n <= 64 else -(-n // 128)
    if m_tiles * n_tiles <= sms:
        return m_tiles
    return min(range(1, m_tiles + 1),
               key=lambda g: (g + _wave_columns(g, sms), -g))


def _wave_columns(group: int, wave: int) -> float:
    """Mean n columns that a wave of ``wave`` consecutive blocks spans in
    groups of ``group`` m tiles, over the starts successive waves take."""
    step = math.gcd(group, wave)
    starts = range(0, group, step)
    return sum(-(-(o + wave) // group) for o in starts) / len(starts)


@functools.lru_cache(maxsize=None)
def _fn():
    fn = _build.library("gemm").repro_gemm
    fn.restype = ctypes.c_int
    fn.argtypes = (
        [ctypes.c_void_p] * 3
        + [ctypes.c_int] * 4
        + [ctypes.c_longlong] * 8
        + [ctypes.c_int] * 9 + [ctypes.c_void_p]
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


def _launch_gemm(a, b, c, m, n, k, batch, a_strides, b_strides, c_strides,
                 route, stream, plan: Optional[Tf32x3Plan] = None,
                 group: int = 1) -> int:
    """One launch through ``repro_gemm`` on ``route`` ("tiled", "wgmma"
    in the tile order ``group`` of :func:`wgmma_plan`, or "tf32x3", whose
    plan is :func:`tf32x3_plan`'s unless given); returns the
    cudaError_t."""
    t3 = (0, 0, 1, 8, 0)
    if route == "tf32x3":
        if plan is None:
            plan = tf32x3_plan(m, n, k, a.dtype, a_strides, b_strides,
                               a.data_ptr(), b.data_ptr(),
                               tf32x3_capacity(a.device.index))
        t3 = (_T3_TILES.index((plan.bm, plan.bn)),
              int(plan.a_kmajor) | 2 * int(plan.b_kmajor), plan.splits,
              plan.kc, int(plan.a_vec) | 2 * int(plan.b_vec))
    return _fn()(
        a.data_ptr(), b.data_ptr(), c.data_ptr(), m, n, k, batch,
        *a_strides,         # A strides: batch, row, k
        *b_strides,         # B strides: batch, k, column
        *c_strides,         # C strides: batch, row
        _DTYPE_CODE[a.dtype], _DTYPE_CODE[c.dtype], ROUTES.index(route),
        *t3, group, stream,
    )


def _launch(a, b, c, m, n, k, batch, a_strides, b_strides, c_strides,
            route) -> bool:
    """Launch ``route``'s kernel, as :func:`gemm_route` named it; True
    when it ran ``wgmma`` in an order other than the plain one."""
    group = 1
    if route == "wgmma":
        group = wgmma_plan(m, n, k, batch, sm_count(a.device.index))
    with torch.cuda.device(a.device):
        stream = torch.cuda.current_stream().cuda_stream
        if route == "skinny":
            err = _launch_skinny(a, b, c, m, n, k, batch, a_strides,
                                 b_strides, c_strides, stream)
        else:
            err = _launch_gemm(a, b, c, m, n, k, batch, a_strides, b_strides,
                               c_strides, route, stream, group=group)
    if err:
        raise RuntimeError(
            f"gemm kernel launch failed ({route} route): cudaError {err}")
    return route == "wgmma" and group < -(-m // _WG_BM)


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
    m, k = a.shape
    n = b.shape[1]
    a_strides, b_strides = (0, *a.stride()), (0, *b.stride())
    route = gemm_route(m, n, k, 1, a.dtype, a_strides, b_strides,
                       a.data_ptr(), b.data_ptr())
    # Under a profiler the wrapper's card path is one range, checks to count.
    with measured("kernel", "gemm", route):
        _check_kernel_operands("gemm", a, b, out_dtype, (a, b))
        c = torch.empty((m, n), dtype=out_dtype, device=a.device)
        grouped = _launch(a, b, c, m, n, k, 1, a_strides, b_strides, (0, n),
                          route)
        _build.count_launch(gemm, route, grouped)
    return c


gemm.launches = 0
gemm.route_launches = dict.fromkeys(ROUTES, 0)
gemm.grouped_launches = 0


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
    if z == 0:
        return torch.empty((z, m, n), dtype=out_dtype, device=a.device)
    route = gemm_route(m, n, k, z, a.dtype, a.stride(), b.stride(),
                       a.data_ptr(), b.data_ptr())
    with measured("kernel", "gemm", route):
        _check_kernel_operands("gemm_batched", a, b, out_dtype, (a[0], b[0]))
        c = torch.empty((z, m, n), dtype=out_dtype, device=a.device)
        grouped = _launch(a, b, c, m, n, k, z, a.stride(), b.stride(),
                          (m * n, n), route)
        _build.count_launch(gemm_batched, route, grouped)
    return c


gemm_batched.launches = 0
gemm_batched.route_launches = dict.fromkeys(ROUTES, 0)
gemm_batched.grouped_launches = 0


@functools.lru_cache(maxsize=None)
def _grouped_fn():
    fn = _build.library("gemm").repro_gemm_grouped
    fn.restype = ctypes.c_int
    fn.argtypes = ([ctypes.c_void_p] * 4 + [ctypes.c_int] * 4
                   + [ctypes.c_longlong] * 4 + [ctypes.c_int, ctypes.c_void_p])
    return fn


def gemm_grouped(a: torch.Tensor, b: torch.Tensor, offsets: torch.Tensor, *,
                 out_dtype: Optional[torch.dtype] = None) -> torch.Tensor:
    """C[r] = A[r] @ B[e] for (R, k) rows sorted by expert and an (E, k, n)
    stack, expert e owning rows ``offsets[e]:offsets[e+1]`` ((E+1,) int32
    on A's device, ``offsets[0] == 0`` and ``offsets[E] == R``), fp32
    accumulation, in one launch that reads the offsets on the card.

    bf16 operands; A with unit k-stride, each B[e] row-major (unit n
    stride), both 16-byte aligned with 16-byte row strides; ``out_dtype``
    bfloat16 or float32 (default: bfloat16)."""
    if a.ndim != 2 or b.ndim != 3 or a.shape[1] != b.shape[1]:
        raise ValueError(
            f"gemm_grouped: bad shapes {tuple(a.shape)} @ {tuple(b.shape)}")
    e, k, n = b.shape
    if tuple(offsets.shape) != (e + 1,) or offsets.dtype != torch.int32:
        raise ValueError(f"gemm_grouped: offsets must be ({e + 1},) int32, "
                         f"got {tuple(offsets.shape)} {offsets.dtype}")
    if len({a.device, b.device, offsets.device}) != 1:
        raise ValueError(f"gemm_grouped: operands on {a.device}, {b.device} "
                         f"and {offsets.device}")
    out_dtype = out_dtype or torch.promote_types(a.dtype, b.dtype)
    if a.device.type == "cpu":
        return gemm_grouped_ref(a, b, offsets, out_dtype=out_dtype)
    r = a.shape[0]
    with measured("kernel", "gemm", "grouped"):
        if a.device.type != "cuda":
            raise ValueError(f"gemm_grouped: no kernel for device {a.device}")
        if a.dtype != torch.bfloat16 or b.dtype != torch.bfloat16 \
                or out_dtype not in _DTYPE_CODE:
            raise TypeError(f"gemm_grouped kernel takes bf16 operands and "
                            f"writes f32 or bf16, got {a.dtype}, {b.dtype} "
                            f"-> {out_dtype}")
        sa_m, sa_k = a.stride()
        sb_e, sb_k, sb_n = b.stride()
        aligned = all(s % _TMA_ELEMS == 0 for s in (sa_m, sb_k, sb_e)) \
            and a.data_ptr() % _TMA_ALIGN == 0 \
            and b.data_ptr() % _TMA_ALIGN == 0 and k % _TMA_ELEMS == 0
        if (sa_k != 1 and k > 1) or (sb_n != 1 and n > 1) or not aligned:
            raise ValueError(
                f"gemm_grouped kernel takes a row-major A and row-major "
                f"experts with 16-byte aligned rows, got strides {a.stride()} "
                f"and {b.stride()}")
        if not offsets.is_contiguous():
            raise ValueError("gemm_grouped kernel takes contiguous offsets")
        c = torch.empty((r, n), dtype=out_dtype, device=a.device)
        if r:
            with torch.cuda.device(a.device):
                stream = torch.cuda.current_stream().cuda_stream
                err = _grouped_fn()(
                    a.data_ptr(), b.data_ptr(), c.data_ptr(),
                    offsets.data_ptr(), r, n, k, e, sa_m, sb_e, sb_k, n,
                    _DTYPE_CODE[out_dtype], stream)
            if err:
                raise RuntimeError(
                    f"gemm_grouped kernel launch failed: cudaError {err}")
            _build.count_launch(gemm_grouped, "wgmma")
    return c


gemm_grouped.launches = 0
gemm_grouped.route_launches = {"wgmma": 0}
