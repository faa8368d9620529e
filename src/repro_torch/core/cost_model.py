"""Three-region offload cost model — the paper's offload decision, generalized.

The paper decomposes offloaded runtime into ``data copy`` + ``fork/join`` +
``compute`` and shows offload pays off only once the compute gain outweighs
the two overhead regions (2.71x at n=128 on their heSoC).  This module turns
that observation into the dispatch policy: every BLAS call-site is scored
analytically from its static shapes and the active :class:`Platform`, and the
dispatcher offloads iff the model predicts a win.

All quantities are derived from static shapes — nothing here touches device
data, so scoring a call never waits on the card.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Optional, Sequence, Tuple

from repro_torch.core.platform import Platform

__all__ = [
    "OpCost",
    "PipelinedBreakdown",
    "RegionBreakdown",
    "gemm_cost",
    "syrk_cost",
    "gemv_cost",
    "vector_cost",
    "attention_cost",
    "d2d_cost",
    "d2d_breakdown",
    "decide_offload",
    "pipeline_makespan",
    "pipelined_breakdown",
    "staging_legs",
]

# Backstop on the modeled chunk count: past this the per-chunk legs are so
# small the closed-form bubble is negligible, and O(chunks) simulation time
# stays bounded for huge staged_bytes / tiny chunk tiles.
MAX_PIPELINE_CHUNKS = 64


@dataclasses.dataclass(frozen=True)
class OpCost:
    """Static workload description of one BLAS-level call."""

    op: str
    flops: float            # useful FLOPs
    staged_bytes: float     # host<->device traffic if operands not resident
    touched_bytes: float    # device memory traffic (inputs+outputs, ideal)
    out_shape: Tuple[int, ...] = ()


@dataclasses.dataclass(frozen=True)
class RegionBreakdown:
    """The paper's Figure-3 decomposition for one call.

    ``d2d_s`` is a fourth region introduced for the cluster: device-to-device
    traffic when a pinned (resident) buffer migrates between PMCAs.  It rides
    the DMA engine like the host copy region, so the overlap timeline treats
    both as copy-stream work.
    """

    copy_s: float
    fork_join_s: float
    compute_s: float
    host_s: float           # host-only alternative
    d2d_s: float = 0.0      # device-to-device migration traffic

    @property
    def offload_s(self) -> float:
        return self.copy_s + self.fork_join_s + self.compute_s + self.d2d_s

    @property
    def speedup(self) -> float:
        return self.host_s / self.offload_s if self.offload_s > 0 else math.inf

    @property
    def copy_fraction(self) -> float:
        return self.copy_s / self.offload_s if self.offload_s > 0 else 0.0


@dataclasses.dataclass(frozen=True)
class PipelinedBreakdown(RegionBreakdown):
    """Region breakdown whose copy region overlaps compute (chunked staging).

    ``copy_s`` / ``compute_s`` keep their serial meaning (total DMA-stream
    seconds, total compute-engine seconds) so rollups that sum regions stay
    comparable with serial records; what changes is the *makespan*:
    ``offload_s`` is the double-buffered pipeline schedule of the two
    streams, not their sum.  The operand set is tiled into ``chunks`` DMA
    legs and the compute engine starts as soon as the first leg lands
    (prologue bubble) and finishes one compute leg after the last one
    (epilogue bubble) — the classic double-buffered DMA-pipeline shape.
    """

    chunks: int = 1
    # Copy+compute pipeline makespan, seconds (excludes fork/join and d2d).
    overlapped_s: float = 0.0
    # First DMA leg: compute is gated on this, not on the whole copy.
    first_copy_leg_s: float = 0.0

    @property
    def offload_s(self) -> float:
        return self.fork_join_s + self.overlapped_s + self.d2d_s

    @property
    def serial_s(self) -> float:
        """What the same call costs without overlap (the pre-pipeline model)."""
        return self.copy_s + self.fork_join_s + self.compute_s + self.d2d_s

    @property
    def hidden_copy_s(self) -> float:
        """Copy-stream seconds hidden under compute by the pipeline."""
        return max(self.copy_s + self.compute_s - self.overlapped_s, 0.0)

    @property
    def bubble_s(self) -> float:
        """Prologue + epilogue exposure beyond the dominant stream."""
        return max(self.overlapped_s - max(self.copy_s, self.compute_s), 0.0)

    @property
    def exposed_copy_s(self) -> float:
        """Copy time still on the critical path (not hidden under compute)."""
        return max(self.overlapped_s - self.compute_s, 0.0)

    @property
    def copy_fraction(self) -> float:
        """Share of offload time spent copying with the compute engine idle
        — the pipelined successor of the paper's T_copy/T_offload."""
        return self.exposed_copy_s / self.offload_s if self.offload_s > 0 else 0.0

    @property
    def pipelined_speedup(self) -> float:
        """Serial offload time over pipelined offload time (>= 1)."""
        return self.serial_s / self.offload_s if self.offload_s > 0 else 1.0


def staging_legs(staged_bytes: float, chunk_bytes: float) -> Tuple[float, ...]:
    """Split a staging transfer into DMA chunk legs (bytes per leg).

    ``chunk_bytes``-sized legs plus one remainder leg when the transfer does
    not divide evenly; degenerate inputs (zero bytes, non-positive chunk
    size, single-chunk transfers) collapse to one leg.  When the chunk tile
    would produce more than :data:`MAX_PIPELINE_CHUNKS` legs, the split
    falls back to that many equal legs (the modeled bubbles are already
    negligible at that depth).
    """
    staged_bytes = max(float(staged_bytes), 0.0)
    if staged_bytes <= 0.0:
        return (0.0,)
    if chunk_bytes is None or chunk_bytes <= 0.0 or chunk_bytes >= staged_bytes:
        return (staged_bytes,)
    # A chunk too small to count (a subnormal tile makes the quotient inf)
    # is clamped to the equal-leg backstop instead of overflowing int().
    # For finite quotients ``staged / chunk > MAX`` holds exactly when the
    # leg count below would exceed MAX, so this only adds the inf case.
    n_legs = staged_bytes / chunk_bytes
    if not math.isfinite(n_legs) or n_legs > MAX_PIPELINE_CHUNKS:
        k = MAX_PIPELINE_CHUNKS
        return (staged_bytes / k,) * k
    n_full = int(staged_bytes // chunk_bytes)
    rem = staged_bytes - n_full * chunk_bytes
    k = n_full + (1 if rem > 0 else 0)
    legs = [float(chunk_bytes)] * n_full
    if rem > 0:
        legs.append(rem)
    return tuple(legs)


def pipeline_makespan(
    copy_legs: Sequence[float],
    compute_legs: Sequence[float],
    *,
    buffers: int = 2,
) -> float:
    """Makespan of a chunked copy->compute pipeline with ``buffers`` staging
    slots (double-buffering by default).

    Chunk i's compute starts once its copy has landed and chunk i-1's
    compute is done; its copy may start once a staging buffer frees up
    (chunk i-``buffers``'s compute done).  Always lies in
    ``[max(sum(copy), sum(compute)), sum(copy) + sum(compute)]``.
    """
    buffers = max(int(buffers), 1)
    dma = 0.0
    comp = 0.0
    ends: list = []
    for i, (c, w) in enumerate(zip(copy_legs, compute_legs)):
        start = dma if i < buffers else max(dma, ends[i - buffers])
        dma = start + c
        comp = max(comp, dma) + w
        ends.append(comp)
    return max(comp, dma)


def pipelined_breakdown(
    cost: OpCost,
    platform: Platform,
    *,
    chunks: Optional[int] = None,
    chunk_bytes: Optional[float] = None,
    zero_copy: bool = False,
    resident_fraction: float = 0.0,
) -> PipelinedBreakdown:
    """Score one call with chunked, double-buffered staging.

    The operand set is tiled into DMA legs (``chunks`` equal legs when
    given explicitly, else ``chunk_bytes``-sized legs — defaulting to the
    platform's ``dma_chunk_bytes``) and each leg's compute share overlaps
    the next leg's transfer.  Degenerate cases (one chunk, zero staged
    bytes, fully-resident operands) collapse to the serial model with no
    division hazards; ``copy_fraction`` is clamped non-negative.
    """
    resident_fraction = min(max(float(resident_fraction), 0.0), 1.0)
    staged = cost.staged_bytes * (1.0 - resident_fraction)
    copy_s = platform.t_copy(staged, zero_copy=zero_copy)
    compute_s = platform.t_compute(cost.flops, cost.touched_bytes)
    if chunks is not None:
        k = min(max(int(chunks), 1), MAX_PIPELINE_CHUNKS)
        byte_legs: Tuple[float, ...] = (
            (staged / k,) * k if staged > 0 else (0.0,) * k
        )
    else:
        qb = platform.dma_chunk_bytes if chunk_bytes is None else chunk_bytes
        byte_legs = staging_legs(staged, qb)
    k = len(byte_legs)
    copy_legs = [platform.t_copy(b, zero_copy=zero_copy) for b in byte_legs]
    # Each chunk's compute share is proportional to its byte share: the device
    # consumes the operands the DMA just landed.
    if staged > 0:
        compute_legs = [compute_s * (b / staged) for b in byte_legs]
    else:
        compute_legs = [compute_s / k] * k
    overlapped = pipeline_makespan(copy_legs, compute_legs)
    return PipelinedBreakdown(
        copy_s=copy_s,
        fork_join_s=platform.t_fork_join(),
        compute_s=compute_s,
        host_s=platform.t_host(cost.flops),
        chunks=k,
        overlapped_s=overlapped,
        first_copy_leg_s=copy_legs[0] if copy_legs else 0.0,
    )


def d2d_cost(nbytes: float, *, op: str = "d2d_copy") -> OpCost:
    """Workload of migrating one resident buffer device-to-device."""
    nbytes = float(nbytes)
    return OpCost(op=op, flops=0.0, staged_bytes=nbytes, touched_bytes=nbytes)


def d2d_breakdown(nbytes: float, platform: Platform) -> RegionBreakdown:
    """Score a pinned-buffer migration on ``platform``.

    The transfer occupies the DMA stream (``d2d_s``), plus one fork/join for
    the transfer descriptors.  ``host_s`` is the alternative the ROADMAP item
    calls out: dropping the buffer and re-staging it from host memory.
    """
    return RegionBreakdown(
        copy_s=0.0,
        fork_join_s=platform.t_fork_join(),
        compute_s=0.0,
        host_s=platform.t_copy(float(nbytes)),
        d2d_s=platform.t_d2d(float(nbytes)),
    )


# ---------------------------------------------------------------------------
# Workload models per BLAS op.
# ---------------------------------------------------------------------------

def gemm_cost(
    m: int,
    n: int,
    k: int,
    itemsize: int,
    *,
    batch: int = 1,
    op: str = "gemm",
) -> OpCost:
    """C[m,n] += A[m,k] @ B[k,n] — 2mnk flops, A+B in, C out."""
    flops = 2.0 * batch * m * n * k
    in_bytes = batch * (m * k + k * n) * itemsize
    out_bytes = batch * m * n * itemsize
    return OpCost(
        op=op,
        flops=flops,
        staged_bytes=in_bytes + out_bytes,
        touched_bytes=in_bytes + out_bytes,
        out_shape=(batch, m, n) if batch > 1 else (m, n),
    )


def syrk_cost(n: int, k: int, itemsize: int) -> OpCost:
    """C[n,n] = A[n,k] @ A.T — n^2 k flops (symmetric half)."""
    flops = float(n) * n * k
    in_bytes = n * k * itemsize
    out_bytes = n * n * itemsize
    return OpCost("syrk", flops, in_bytes + out_bytes, in_bytes + out_bytes, (n, n))


def gemv_cost(m: int, n: int, itemsize: int) -> OpCost:
    flops = 2.0 * m * n
    bytes_ = (m * n + n + m) * itemsize
    return OpCost("gemv", flops, bytes_, bytes_, (m,))


def vector_cost(op: str, n: int, itemsize: int, flops_per_elem: float = 2.0) -> OpCost:
    bytes_ = 2.0 * n * itemsize
    return OpCost(op, flops_per_elem * n, bytes_, bytes_, (n,))


def attention_cost(
    batch: int,
    q_len: int,
    kv_len: int,
    num_q_heads: int,
    head_dim: int,
    itemsize: int,
    *,
    window: Optional[int] = None,
) -> OpCost:
    """Flash-attention workload (QK^T + PV), window-clipped if sliding."""
    eff_kv = min(kv_len, window) if window else kv_len
    flops = 4.0 * batch * num_q_heads * q_len * eff_kv * head_dim
    io = batch * num_q_heads * (q_len + 2 * eff_kv + q_len) * head_dim * itemsize
    return OpCost("attention", flops, io, io)


# ---------------------------------------------------------------------------
# The offload decision.
# ---------------------------------------------------------------------------

def breakdown(
    cost: OpCost,
    platform: Platform,
    *,
    zero_copy: bool = False,
    resident_fraction: float = 0.0,
) -> RegionBreakdown:
    """Score one call on one platform.

    ``resident_fraction`` marks the share of ``staged_bytes`` already living
    in device memory (weights during training/serving): those never cross the
    host<->device link, reproducing the paper's observation that the copy
    region only exists for non-resident operands.
    """
    staged = cost.staged_bytes * (1.0 - resident_fraction)
    return RegionBreakdown(
        copy_s=platform.t_copy(staged, zero_copy=zero_copy),
        fork_join_s=platform.t_fork_join(),
        compute_s=platform.t_compute(cost.flops, cost.touched_bytes),
        host_s=platform.t_host(cost.flops),
    )


def decide_offload(
    cost: OpCost,
    platform: Platform,
    *,
    zero_copy: bool = False,
    resident_fraction: float = 0.0,
    min_speedup: float = 1.0,
    pipeline: bool = False,
    chunk_bytes: Optional[float] = None,
) -> Tuple[bool, RegionBreakdown]:
    """Offload iff the modeled offload time beats host by ``min_speedup``.

    With ``pipeline=True`` the decision is scored against the chunked
    double-buffered staging model — overlap lowers ``offload_s``, so the
    paper's crossover moves down when the runtime can pipeline.
    """
    if pipeline:
        bd: RegionBreakdown = pipelined_breakdown(
            cost,
            platform,
            chunk_bytes=chunk_bytes,
            zero_copy=zero_copy,
            resident_fraction=resident_fraction,
        )
    else:
        bd = breakdown(
            cost,
            platform,
            zero_copy=zero_copy,
            resident_fraction=resident_fraction,
        )
    return bd.speedup >= min_speedup, bd


def crossover_size(
    platform: Platform,
    itemsize: int = 8,
    *,
    zero_copy: bool = False,
    lo: int = 2,
    hi: int = 1 << 16,
) -> int:
    """Smallest square GEMM size for which offload wins (paper's crossover)."""
    n = lo
    while n <= hi:
        ok, _ = decide_offload(gemm_cost(n, n, n, itemsize), platform, zero_copy=zero_copy)
        if ok:
            return n
        n *= 2
    return -1
