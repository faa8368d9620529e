"""Offload accounting — the paper's three-region runtime instrumentation.

The paper measures each offloaded call as ``data copy`` / ``fork-join`` /
``compute`` regions.  We reproduce that bookkeeping at the BLAS seam: every
dispatched call appends an :class:`OffloadRecord` carrying the op, static
shapes, chosen backend, and the modeled region breakdown.  Recording happens
before the lowering runs, from static shapes alone.

Usage::

    with offload_trace() as trace:
        y = blas.gemm(a, b)
    print(trace.summary())
"""

from __future__ import annotations

import contextlib
import dataclasses
from typing import Dict, Iterator, List, Optional, Sequence, Tuple

from repro_torch.core.cost_model import OpCost, RegionBreakdown

__all__ = [
    "DeviceAggregate",
    "DeviceTimeline",
    "GraphAggregate",
    "LatencyStats",
    "OffloadRecord",
    "OffloadTrace",
    "RequestMetrics",
    "SLOReport",
    "SLOStats",
    "offload_trace",
    "current_trace",
    "scaled",
    "current_scale",
    "graph_region",
    "current_graph",
    "percentile",
    "slo_report",
]


@dataclasses.dataclass(frozen=True)
class OffloadRecord:
    op: str
    shape_key: str
    dtype: str
    backend: str                # "host" | "device" | "device-kernel"
    cost: OpCost
    regions: RegionBreakdown
    zero_copy: bool
    note: str = ""
    # Structural multiplier: a record written once for work that executes
    # `count` times (under :func:`scaled`: layer stacks, microbatches,
    # kv chunks).  Aggregations weight by this.
    count: float = 1.0
    # Cluster placement: which virtual PMCA ran the call (-1 = host).
    device_id: int = -1
    # Effective operand-residency credit the launch applied: the fraction of
    # ``cost.staged_bytes`` that never crossed the host<->device link (graph
    # scheduling threads exact per-call fractions; eager calls carry the
    # policy default).
    resident_fraction: float = 0.0
    # Graph scope this call was lowered under ("" = eager call site).  Set by
    # the ambient :func:`graph_region`, the way ``count`` is set by `scaled`.
    graph: str = ""

    @property
    def staged_bytes_charged(self) -> float:
        """Host<->device bytes actually paid after the residency credit."""
        return self.cost.staged_bytes * (1.0 - self.resident_fraction)


@dataclasses.dataclass
class DeviceAggregate:
    """Per-device rollup of offloaded calls (the paper's regions, per PMCA)."""

    device_id: int
    calls: float = 0.0
    copy_s: float = 0.0
    fork_join_s: float = 0.0
    compute_s: float = 0.0
    flops: float = 0.0
    staged_bytes: float = 0.0
    d2d_s: float = 0.0          # inbound pinned-buffer migrations

    @property
    def offload_s(self) -> float:
        return self.copy_s + self.fork_join_s + self.compute_s + self.d2d_s


@dataclasses.dataclass
class GraphAggregate:
    """Rollup of one graph region's offloaded calls (the ``hnp`` frontend
    lowers a whole expression graph under one :func:`graph_region` scope)."""

    graph: str
    calls: float = 0.0
    copy_s: float = 0.0
    fork_join_s: float = 0.0
    compute_s: float = 0.0
    d2d_s: float = 0.0
    host_s: float = 0.0
    flops: float = 0.0
    staged_bytes: float = 0.0           # bytes the eager path would stage
    staged_bytes_charged: float = 0.0   # bytes actually staged after credit

    @property
    def offload_s(self) -> float:
        return self.copy_s + self.fork_join_s + self.compute_s + self.d2d_s

    @property
    def staged_bytes_saved(self) -> float:
        return self.staged_bytes - self.staged_bytes_charged


@dataclasses.dataclass
class DeviceTimeline:
    """Modeled copy/compute overlap on one device's launch stream.

    Two resources per PMCA, as on the real part: the DMA engine (data
    copy) and the compute cluster (fork/join + kernel).  Launch k's copy
    streams while launch k-1 computes (double-buffering); its compute
    starts once both its copy is done and the compute engine frees up.
    ``makespan_s <= serial_s`` always; the gap is hidden copy time.
    """

    device_id: int
    makespan_s: float
    serial_s: float
    # Stream occupancy: seconds each engine was busy across the stream.
    # ``dma_busy_s`` counts host staging + inbound d2d; a fully-resident
    # launch contributes zero here.  ``makespan_s >= max(dma_busy_s,
    # compute_busy_s)`` and ``dma_busy_s + compute_busy_s >= serial_s`` need
    # not hold individually — the two engines run concurrently.
    dma_busy_s: float = 0.0
    compute_busy_s: float = 0.0

    @property
    def hidden_copy_s(self) -> float:
        return self.serial_s - self.makespan_s

    @property
    def overlap_efficiency(self) -> float:
        return self.serial_s / self.makespan_s if self.makespan_s > 0 else 1.0


class OffloadTrace:
    """Accumulates records for one traced region of the application."""

    def __init__(self) -> None:
        self.records: List[OffloadRecord] = []

    def add(self, rec: OffloadRecord) -> None:
        self.records.append(rec)

    # ---- aggregation ----------------------------------------------------
    def totals(self) -> Tuple[float, float, float, float]:
        """(copy_s, fork_join_s, compute_s, host_only_s) over offloaded calls."""
        copy = fork = comp = host = 0.0
        for r in self.records:
            if r.backend.startswith("device"):
                copy += r.regions.copy_s * r.count
                fork += r.regions.fork_join_s * r.count
                comp += r.regions.compute_s * r.count
            host += r.regions.host_s * r.count
        return copy, fork, comp, host

    def offloaded(self) -> List[OffloadRecord]:
        return [r for r in self.records if r.backend.startswith("device")]

    def host_only(self) -> List[OffloadRecord]:
        return [r for r in self.records if not r.backend.startswith("device")]

    def total_flops(self) -> float:
        return sum(r.cost.flops * r.count for r in self.records)

    def total_touched_bytes(self) -> float:
        """Kernel-ideal device-memory traffic: each op streams its operands
        and results exactly once (the SPM/VMEM-tiled execution the paper's
        device kernels implement)."""
        return sum(r.cost.touched_bytes * r.count for r in self.records)

    def total_staged_bytes(self) -> float:
        return sum(r.cost.staged_bytes * r.count for r in self.offloaded())

    def summary(self) -> str:
        copy, fork, comp, host = self.totals()
        d2d = self.total_d2d_s()
        # d2d migrations are part of what the offload path pays, so they
        # belong in the total and the speedup denominator (keeps this line
        # consistent with the per-device offload_s rollups below).
        off = copy + fork + comp + d2d
        lines = [
            f"offload trace: {len(self.records)} calls "
            f"({len(self.offloaded())} offloaded, {len(self.host_only())} host)",
            f"  regions  copy={copy:.6f}s  fork/join={fork:.6f}s  compute={comp:.6f}s",
            f"  offload total={off:.6f}s   host-only equivalent={host:.6f}s",
        ]
        if off > 0:
            lines.append(
                f"  modeled speedup={host / off:.2f}x   copy fraction={copy / off:.1%}"
            )
        if d2d > 0:
            lines.append(f"  d2d migrations={d2d:.6f}s")
        devs = self.by_device()
        if len(devs) > 1 or (devs and next(iter(devs)) != 0):
            for did in sorted(devs):
                d = devs[did]
                lines.append(
                    f"  device {did}: {d.calls:.0f} launches  "
                    f"offload={d.offload_s:.6f}s  flops={d.flops:.3e}"
                )
            lines.append(
                f"  cluster makespan={self.cluster_makespan_s():.6f}s "
                f"(copy/compute overlap modeled)"
            )
        return "\n".join(lines)

    # ---- per-device aggregation (cluster view) --------------------------
    def by_device(self) -> Dict[int, DeviceAggregate]:
        """Offloaded work grouped by virtual device (host records excluded).

        Invariant: summing any region over the aggregates equals the same
        region in :meth:`totals` — per-device traces add up to the cluster
        total (asserted in tests/test_cluster.py).
        """
        agg: Dict[int, DeviceAggregate] = {}
        for r in self.offloaded():
            d = agg.setdefault(r.device_id, DeviceAggregate(r.device_id))
            d.calls += r.count
            d.copy_s += r.regions.copy_s * r.count
            d.fork_join_s += r.regions.fork_join_s * r.count
            d.compute_s += r.regions.compute_s * r.count
            d.flops += r.cost.flops * r.count
            d.staged_bytes += r.cost.staged_bytes * r.count
            d.d2d_s += r.regions.d2d_s * r.count
        return agg

    def by_graph(self) -> Dict[str, GraphAggregate]:
        """Offloaded work grouped by graph region (eager records under "").

        The per-graph rollup is what the ``hnp`` frontend reports: how much
        staging the residency threading actually saved for one lowered
        expression graph, next to the region seconds it paid."""
        agg: Dict[str, GraphAggregate] = {}
        for r in self.offloaded():
            g = agg.setdefault(r.graph, GraphAggregate(r.graph))
            g.calls += r.count
            g.copy_s += r.regions.copy_s * r.count
            g.fork_join_s += r.regions.fork_join_s * r.count
            g.compute_s += r.regions.compute_s * r.count
            g.d2d_s += r.regions.d2d_s * r.count
            g.host_s += r.regions.host_s * r.count
            g.flops += r.cost.flops * r.count
            g.staged_bytes += r.cost.staged_bytes * r.count
            g.staged_bytes_charged += r.staged_bytes_charged * r.count
        return agg

    def total_staged_bytes_charged(self) -> float:
        """Host<->device bytes actually paid (residency credits applied)."""
        return sum(r.staged_bytes_charged * r.count for r in self.offloaded())

    def total_d2d_s(self) -> float:
        """Modeled device-to-device migration seconds (pinned-handle moves)."""
        return sum(r.regions.d2d_s * r.count for r in self.offloaded())

    def device_timelines(self) -> Dict[int, DeviceTimeline]:
        """Modeled copy/compute-overlap timeline per device.

        Records repeated ``count`` times (scan bodies) are unrolled as
        ``count`` back-to-back launches of the same shape.
        """
        streams: Dict[int, List[OffloadRecord]] = {}
        for r in self.offloaded():
            streams.setdefault(r.device_id, []).append(r)
        out: Dict[int, DeviceTimeline] = {}
        for dev, recs in streams.items():
            dma_free = 0.0
            compute_free = 0.0
            serial = 0.0
            dma_busy = 0.0
            compute_busy = 0.0
            for r in recs:
                n = max(int(round(r.count)), 1)
                # A fully-resident launch stages nothing: its operands
                # already live in device memory, so it must not occupy the
                # DMA engine.
                staging = 0.0 if r.resident_fraction >= 1.0 else r.regions.copy_s
                # host staging and d2d migration both occupy the DMA engine
                copy = staging + r.regions.d2d_s
                work = r.regions.fork_join_s + r.regions.compute_s
                # Chunk-gated start: a pipelined launch's compute may begin
                # once its *first* staging leg lands (double-buffered DMA);
                # a monolithic launch waits for the whole copy.
                first = getattr(r.regions, "first_copy_leg_s", None)
                chunks = getattr(r.regions, "chunks", 1)
                gate = (
                    first if (first is not None and chunks > 1) else staging
                ) + r.regions.d2d_s
                # first repeat explicitly...
                start = dma_free
                dma_free += copy
                compute_free = max(compute_free, start + gate) + work
                # ...then n-1 identical repeats in closed form: each adds
                # `copy` to the DMA stream, and the compute stream is
                # whichever resource is the bottleneck (O(1), not O(n) —
                # scan-body records can carry counts in the thousands)
                if n > 1:
                    k = n - 1
                    dma_free += k * copy
                    compute_free = max(
                        compute_free + k * work,
                        dma_free - copy + gate + work,
                    )
                serial += n * (staging + r.regions.d2d_s + work)
                dma_busy += n * copy
                compute_busy += n * work
            out[dev] = DeviceTimeline(
                device_id=dev,
                makespan_s=max(compute_free, dma_free),
                serial_s=serial,
                dma_busy_s=dma_busy,
                compute_busy_s=compute_busy,
            )
        return out

    def cluster_makespan_s(self) -> float:
        """Modeled wall-clock of the offloaded work: devices run in
        parallel, each overlapping copy with compute."""
        tls = self.device_timelines()
        return max((t.makespan_s for t in tls.values()), default=0.0)

    def by_op(self) -> dict:
        agg: dict = {}
        for r in self.records:
            d = agg.setdefault(r.op, {"calls": 0, "flops": 0.0, "offloaded": 0})
            d["calls"] += 1
            d["flops"] += r.cost.flops
            d["offloaded"] += int(r.backend.startswith("device"))
        return agg


# Module-level stacks (single-threaded, like the reference's trace-time model).
_TRACE_STACK: List[OffloadTrace] = []
_SCALE_STACK: List[float] = []
_GRAPH_STACK: List[str] = []


def current_trace() -> Optional[OffloadTrace]:
    return _TRACE_STACK[-1] if _TRACE_STACK else None


def current_scale() -> float:
    s = 1.0
    for m in _SCALE_STACK:
        s *= m
    return s


@contextlib.contextmanager
def scaled(mult: float) -> Iterator[None]:
    """Mark the enclosed trace region as executing ``mult`` times (scan body)."""
    _SCALE_STACK.append(float(mult))
    try:
        yield
    finally:
        _SCALE_STACK.pop()


def current_graph() -> str:
    return _GRAPH_STACK[-1] if _GRAPH_STACK else ""


@contextlib.contextmanager
def graph_region(name: str) -> Iterator[None]:
    """Stamp every record in the scope as belonging to graph ``name``.

    Entered by the ``hnp`` scheduler around one lowered expression graph
    (including the d2d migrations its residency threading triggers), so
    :meth:`OffloadTrace.by_graph` can roll the whole graph up."""
    _GRAPH_STACK.append(str(name))
    try:
        yield
    finally:
        _GRAPH_STACK.pop()


@contextlib.contextmanager
def offload_trace() -> Iterator[OffloadTrace]:
    t = OffloadTrace()
    _TRACE_STACK.append(t)
    try:
        yield t
    finally:
        _TRACE_STACK.pop()


def record(rec: OffloadRecord) -> None:
    t = current_trace()
    if t is not None:
        t.add(
            dataclasses.replace(
                rec, count=current_scale(), graph=rec.graph or current_graph()
            )
        )


# ---------------------------------------------------------------------------
# Per-request SLO accounting (the streaming serve engine's ledger).
#
# ``serve_cluster`` reports one makespan; production serving is judged per
# *request*: time to first token (TTFT), per-token decode latency, and their
# tail percentiles per request class.  These records are modeled seconds off
# the LaunchTicket event clocks — never wall clock — so two runs with the
# same seed produce byte-identical reports.
# ---------------------------------------------------------------------------

def percentile(values: Sequence[float], q: float) -> float:
    """Deterministic linear-interpolation percentile (``q`` in [0, 100]).

    Stdlib-only twin of ``numpy.percentile(..., method="linear")`` so the
    accounting layer stays import-light and the SLO math has no backend
    drift.  Empty input returns 0.0 (an empty class shows empty stats, not
    a crash)."""
    vals = sorted(float(v) for v in values)
    if not vals:
        return 0.0
    if len(vals) == 1:
        return vals[0]
    q = min(max(float(q), 0.0), 100.0)
    pos = (len(vals) - 1) * (q / 100.0)
    lo = int(pos)
    hi = min(lo + 1, len(vals) - 1)
    frac = pos - lo
    return vals[lo] * (1.0 - frac) + vals[hi] * frac


@dataclasses.dataclass(frozen=True)
class LatencyStats:
    """p50/p95/p99 + mean over one latency population (modeled seconds)."""

    n: int
    mean_s: float
    p50_s: float
    p95_s: float
    p99_s: float
    max_s: float

    @classmethod
    def from_values(cls, values: Sequence[float]) -> "LatencyStats":
        vals = [float(v) for v in values]
        if not vals:
            return cls(0, 0.0, 0.0, 0.0, 0.0, 0.0)
        return cls(
            n=len(vals),
            mean_s=sum(vals) / len(vals),
            p50_s=percentile(vals, 50),
            p95_s=percentile(vals, 95),
            p99_s=percentile(vals, 99),
            max_s=max(vals),
        )

    def as_dict(self) -> Dict[str, float]:
        return {
            "n": self.n, "mean_s": self.mean_s, "p50_s": self.p50_s,
            "p95_s": self.p95_s, "p99_s": self.p99_s, "max_s": self.max_s,
        }


@dataclasses.dataclass
class RequestMetrics:
    """One served (or rejected) request's modeled lifecycle timestamps."""

    rid: int
    req_class: str
    arrival_s: float
    prompt_len: int
    output_len: int
    admitted: bool = True
    prefill_done_s: float = 0.0
    first_token_s: float = 0.0
    finish_s: float = 0.0
    tokens_out: int = 0
    # Completion-to-completion gap of each decode token after the first
    # (the population the per-token percentiles are computed over).
    token_latencies_s: List[float] = dataclasses.field(default_factory=list)

    @property
    def completed(self) -> bool:
        return self.admitted and self.tokens_out >= self.output_len

    @property
    def ttft_s(self) -> float:
        """Arrival -> first emitted token (queueing + prefill + first step)."""
        return self.first_token_s - self.arrival_s

    @property
    def e2e_s(self) -> float:
        return self.finish_s - self.arrival_s


@dataclasses.dataclass(frozen=True)
class SLOStats:
    """Latency rollup for one request class (or ``"all"``)."""

    req_class: str
    requests: int               # admitted requests of this class
    completed: int
    ttft: LatencyStats
    per_token: LatencyStats
    e2e: LatencyStats

    def as_dict(self) -> dict:
        return {
            "class": self.req_class,
            "requests": self.requests,
            "completed": self.completed,
            "ttft": self.ttft.as_dict(),
            "per_token": self.per_token.as_dict(),
            "e2e": self.e2e.as_dict(),
        }


@dataclasses.dataclass(frozen=True)
class SLOReport:
    """Per-class + overall SLO accounting for one serving run.

    ``meets_slo`` is the serving acceptance question: did the p99 tails of
    the *completed* population stay inside the stated TTFT and per-token
    budgets?  (Rejected requests are counted by the engine's reject rate,
    not here — an admission-controlled server keeps its served tails inside
    SLO precisely by shedding load.)"""

    classes: Dict[str, SLOStats]
    ttft_slo_s: float = 0.0
    per_token_slo_s: float = 0.0

    @property
    def overall(self) -> SLOStats:
        return self.classes["all"]

    @property
    def meets_slo(self) -> bool:
        o = self.overall
        if o.completed == 0:
            return False
        ok = True
        if self.ttft_slo_s > 0:
            ok = ok and o.ttft.p99_s <= self.ttft_slo_s
        if self.per_token_slo_s > 0:
            ok = ok and o.per_token.p99_s <= self.per_token_slo_s
        return ok

    def as_dict(self) -> dict:
        return {
            "ttft_slo_s": self.ttft_slo_s,
            "per_token_slo_s": self.per_token_slo_s,
            "meets_slo": self.meets_slo,
            "classes": {k: v.as_dict() for k, v in self.classes.items()},
        }


def _class_stats(req_class: str, metrics: List[RequestMetrics]) -> SLOStats:
    done = [m for m in metrics if m.completed]
    return SLOStats(
        req_class=req_class,
        requests=len(metrics),
        completed=len(done),
        ttft=LatencyStats.from_values([m.ttft_s for m in done]),
        per_token=LatencyStats.from_values(
            [lat for m in done for lat in m.token_latencies_s]
        ),
        e2e=LatencyStats.from_values([m.e2e_s for m in done]),
    )


def slo_report(
    metrics: Sequence[RequestMetrics],
    *,
    ttft_slo_s: float = 0.0,
    per_token_slo_s: float = 0.0,
) -> SLOReport:
    """Roll per-request metrics up into per-class p50/p95/p99 SLO stats.

    Rejected requests (``admitted=False``) are excluded from the latency
    populations — they never produced a token; the engine reports them as
    its reject rate."""
    admitted = [m for m in metrics if m.admitted]
    classes: Dict[str, List[RequestMetrics]] = {}
    for m in admitted:
        classes.setdefault(m.req_class, []).append(m)
    out = {c: _class_stats(c, ms) for c, ms in sorted(classes.items())}
    out["all"] = _class_stats("all", admitted)
    return SLOReport(
        classes=out, ttft_slo_s=ttft_slo_s, per_token_slo_s=per_token_slo_s
    )
