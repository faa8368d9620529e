"""Offload engine — the HeroSDK analogue, scaled to a multi-PMCA cluster.

HeroSDK's ``libhero`` boots *one* PMCA, manages its manually-partitioned
device DRAM and copies shared structures into it before the first offload.
HERO (Kurth et al.) and ESP both show the natural next step: one host
orchestrating *many* accelerator clusters.  This module is that seam.

A :class:`HeroCluster` owns N :class:`VirtualDevice` s.  Each virtual
device keeps what the paper's runtime kept per PMCA:

* a **residency ledger** — which logical buffers (weights, caches) live in
  that device's DRAM and therefore never pay the ``data copy`` region again;
* **boot state** — the PMCA boot + L2 image copy happens lazily on the
  first offload routed to the device, exactly as in HeroSDK;
* an **in-flight launch queue** — modeled outstanding work, which is what
  the schedulers balance and what fault tolerance reschedules on loss.

Every offload goes through :func:`HeroCluster.launch`, which scores the
call with the cost model, picks a device through the pluggable scheduler
(``round-robin`` / ``least-loaded`` / ``cost-aware``) and appends an
:class:`accounting.OffloadRecord` tagged with the device id to the active
trace — the paper's instrumentation, per device.

``launch`` returns a :class:`LaunchResult`: a ``str`` subclass equal to the
chosen backend name (``"host"`` / ``"device"`` / ``"device-kernel"``) that
also carries ``device_id`` and unpacks as ``(backend, device_id)``, so the
BLAS seam reads the placement while older call sites keep comparing it to
the backend string.

The cluster is *modeled*: its devices are bookkeeping lanes scored with a
:class:`~repro_torch.core.platform.Platform`, not CUDA devices.  Which card
(or the CPU) actually computes is the tensors' own device; the backend
name only picks the lowering (plain torch or the hand-written kernel).
"""

from __future__ import annotations

import contextlib
import dataclasses
import itertools
from typing import Callable, Dict, Iterator, List, Optional, Set, Tuple

from repro_torch.core import accounting
from repro_torch.core.cost_model import (
    OpCost,
    PipelinedBreakdown,
    RegionBreakdown,
    breakdown,
    d2d_breakdown,
    d2d_cost,
    decide_offload,
    pipelined_breakdown,
)
from repro_torch.core.platform import H100_SXM, Platform, get_platform
from repro_torch.obs import flight as _flight
from repro_torch.obs import metrics as _metrics
from repro_torch.obs import spans as _spans

__all__ = [
    "DeviceHandle",
    "HeroCluster",
    "LaunchResult",
    "LaunchTicket",
    "OffloadPolicy",
    "SCHEDULERS",
    "VirtualDevice",
    "engine",
    "offload_policy",
]

HOST_DEVICE_ID = -1


@dataclasses.dataclass
class DeviceHandle:
    """Residency token for one logical buffer pinned to a device.

    The handle *is* the placement contract: as long as it is valid, the
    named buffer lives in ``device_id``'s DRAM, launches keyed on it skip
    the copy region there, and the ``cost-aware`` scheduler is drawn to
    that device.  Migration (:meth:`HeroCluster.migrate_handle`) moves the
    buffer over the device-to-device link; device loss invalidates the
    handle (``device_id`` becomes the host sentinel) until it is re-staged.
    """

    name: str
    device_id: int
    nbytes: float

    @property
    def valid(self) -> bool:
        return self.device_id != HOST_DEVICE_ID


@dataclasses.dataclass
class OffloadPolicy:
    """How the dispatcher routes BLAS calls.

    mode:
      * ``"host"``   — never offload (paper's host-only baseline)
      * ``"device"`` — always offload (paper's offloaded run)
      * ``"auto"``   — offload iff the cost model predicts >= ``min_speedup``
    """

    mode: str = "auto"
    zero_copy: bool = False
    min_speedup: float = 1.0
    # Fraction of operand bytes assumed device-resident (weights in a
    # training step are resident; activations are produced on device too, so
    # inside a step everything is resident and the copy region vanishes — the
    # paper's IOMMU end-state).
    resident_fraction: float = 0.0
    # Prefer the hand-written CUDA kernels over the plain torch lowering
    # when legal (the reference's ``use_pallas``; there is no interpreter).
    use_kernels: bool = False
    # Chunked, double-buffered staging: tile each launch's operand set into
    # DMA legs that stream in *while* the device computes, so offload_s
    # approaches max(copy, compute) instead of copy + compute.  Scoring,
    # the auto decision and the cost-aware scheduler all see the pipelined
    # cost; the overlap timeline shingles the DMA legs under compute.
    pipeline_staging: bool = True
    # DMA chunk size override, bytes (None = the platform's natural
    # double-buffer tile, ``Platform.dma_chunk_bytes``).
    pipeline_chunk_bytes: Optional[float] = None
    # Cross-wave prefetch: the graph scheduler may stage wave k+1's leaf
    # operands while wave k computes (charged as ``prefetch_stage`` records
    # riding the DMA stream; the consuming launch gets the residency
    # credit, so no byte is charged twice).
    prefetch_staging: bool = False

    def validate(self) -> None:
        if self.mode not in ("host", "device", "auto"):
            raise ValueError(f"bad offload mode {self.mode!r}")

    def score(
        self,
        cost: OpCost,
        platform: Platform,
        *,
        resident_fraction: Optional[float] = None,
    ) -> RegionBreakdown:
        """Score one call under this policy: pipelined when staging overlap
        is on, the paper's serial three-region model otherwise."""
        rf = (
            self.resident_fraction
            if resident_fraction is None
            else resident_fraction
        )
        if self.pipeline_staging:
            return pipelined_breakdown(
                cost,
                platform,
                chunk_bytes=self.pipeline_chunk_bytes,
                zero_copy=self.zero_copy,
                resident_fraction=rf,
            )
        return breakdown(
            cost,
            platform,
            zero_copy=self.zero_copy,
            resident_fraction=rf,
        )


class LaunchResult(str):
    """Backend name + placement.  Compares as the backend string."""

    device_id: int

    def __new__(cls, backend: str, device_id: int = HOST_DEVICE_ID):
        self = super().__new__(cls, backend)
        self.device_id = device_id
        return self

    @property
    def backend(self) -> str:
        return str(self)

    def __iter__(self):
        # allow `backend, device_id = cluster.launch(...)`
        return iter((str(self), self.device_id))


@dataclasses.dataclass(frozen=True)
class LaunchTicket:
    """One modeled in-flight offload on a device's queue.

    Tickets are *events*, not just durations: :meth:`VirtualDevice.issue`
    stamps each one with where it lands on the device's two modeled streams
    (DMA engine / compute cluster).  ``copy_ready_s`` is when the first
    staged chunk is on device — with pipelined staging that is one DMA leg
    after issue, not the whole copy, which is what lets the compute stream
    start under the remaining transfer.  Queue-depth accounting (serving
    admission control) reads ``complete_s`` off the in-flight window.
    """

    op: str
    shape_key: str
    offload_s: float
    issue_s: float = 0.0         # DMA stream start (device clock, seconds)
    copy_ready_s: float = 0.0    # first operand chunk landed; compute may start
    copy_done_s: float = 0.0     # staging + d2d stream fully drained
    complete_s: float = 0.0      # compute retired (launch completion event)
    # Compute-stream start: max(compute engine free, copy_ready).  Stamped so
    # a happens-before checker (the reference's ``analysis/races.py``) can
    # verify compute never races its staging without re-deriving the schedule.
    compute_start_s: float = 0.0
    # Which modeled path issued the ticket: "launch" (offloaded op),
    # "prefetch" (cross-wave staging), "d2d" (handle migration), "restage"
    # (host re-stage after loss/shrink), "requeue" (orphan reschedule).
    kind: str = "launch"
    # Residency credit the launch was scored with (>=1.0 must charge no DMA).
    resident_fraction: float = 0.0
    # Device the ticket was issued on (stamped by VirtualDevice.issue).
    device_id: int = HOST_DEVICE_ID


class VirtualDevice:
    """One PMCA-analogue: boot state, residency ledger, in-flight queue.

    The in-flight queue is a bounded window (``MAX_INFLIGHT``): enqueuing
    past the bound retires the oldest ticket into the completed counters,
    as a real device's bounded command queue would.  ``pending_s`` therefore
    reflects *outstanding* work, not all work ever assigned, and long-lived
    processes don't accumulate tickets without bound.
    """

    MAX_INFLIGHT = 128

    def __init__(self, device_id: int, platform: Platform = H100_SXM) -> None:
        self.device_id = device_id
        self.platform = platform
        self.alive = True
        self._booted = False
        self._l2_image_loaded = False
        self._resident: Set[str] = set()
        self.inflight: List[LaunchTicket] = []
        self.completed_s = 0.0          # modeled seconds of retired work
        self.completed_launches = 0
        # Event-driven stream clocks: the frontier of each modeled engine.
        # ``issue`` advances them per launch; their gap is hidden copy time.
        self.dma_free_s = 0.0
        self.compute_free_s = 0.0

    # ---- lifecycle (mirrors hero_snitch.c boot / hero_allocator.c) -------
    def boot(self) -> None:
        """Analogue of booting the PMCA + copying device functions to L2."""
        if not self.alive:
            raise RuntimeError(f"device {self.device_id} is failed")
        self._booted = True
        self._l2_image_loaded = True

    def reset(self) -> None:
        self.alive = True
        self._booted = False
        self._l2_image_loaded = False
        self._resident.clear()
        self.inflight.clear()
        self.completed_s = 0.0
        self.completed_launches = 0
        self.dma_free_s = 0.0
        self.compute_free_s = 0.0

    @property
    def booted(self) -> bool:
        return self._booted

    # ---- residency ledger -------------------------------------------------
    def mark_resident(self, name: str) -> None:
        self._resident.add(name)

    def evict(self, name: str) -> None:
        self._resident.discard(name)

    def is_resident(self, name: str) -> bool:
        return name in self._resident

    @property
    def resident(self) -> frozenset:
        return frozenset(self._resident)

    # ---- in-flight queue --------------------------------------------------
    @property
    def pending_s(self) -> float:
        """Modeled seconds of queued-but-unretired work."""
        return sum(t.offload_s for t in self.inflight)

    def enqueue(self, ticket: LaunchTicket) -> None:
        while len(self.inflight) >= self.MAX_INFLIGHT:
            oldest = self.inflight.pop(0)
            self.completed_s += oldest.offload_s
            self.completed_launches += 1
        self.inflight.append(ticket)

    @property
    def stream_makespan_s(self) -> float:
        """Frontier of the later modeled stream (DMA vs compute)."""
        return max(self.dma_free_s, self.compute_free_s)

    def advance_clocks(self, t: float) -> None:
        """Advance both stream clocks to at least ``t`` (modeled idle gap).

        Streaming consumers live on a wall of *arrival* time: a request that
        lands at t=5 cannot issue before t=5 even on an idle device.  The
        gap is pure idleness — clocks only ever move forward, so the
        happens-before monotonicity checks are unaffected."""
        t = float(t)
        if t > self.dma_free_s:
            self.dma_free_s = t
        if t > self.compute_free_s:
            self.compute_free_s = t

    def issue(
        self,
        cost: OpCost,
        bd: RegionBreakdown,
        shape_key: str,
        *,
        kind: str = "launch",
        resident_fraction: float = 0.0,
    ) -> LaunchTicket:
        """Issue one launch event-wise: charge its staging (plus any d2d
        leg) to the DMA stream, gate compute on the *first* landed chunk
        when the breakdown is pipelined (the whole copy otherwise), and
        enqueue the stamped ticket.  The completion event is what retires
        through :meth:`retire_all` / cluster ``sync``.
        """
        copy = bd.copy_s + bd.d2d_s
        gate = bd.d2d_s + (
            bd.first_copy_leg_s
            if isinstance(bd, PipelinedBreakdown) and bd.chunks > 1
            else bd.copy_s
        )
        work = bd.fork_join_s + bd.compute_s
        issue_s = self.dma_free_s
        self.dma_free_s = issue_s + copy
        ready = issue_s + gate
        compute_start = max(self.compute_free_s, ready)
        self.compute_free_s = compute_start + work
        if isinstance(bd, PipelinedBreakdown):
            # compute cannot retire before its last chunk has landed
            self.compute_free_s = max(self.compute_free_s, self.dma_free_s)
        ticket = LaunchTicket(
            op=cost.op,
            shape_key=shape_key,
            offload_s=bd.offload_s,
            issue_s=issue_s,
            copy_ready_s=ready,
            copy_done_s=self.dma_free_s,
            complete_s=self.compute_free_s,
            compute_start_s=compute_start,
            kind=kind,
            resident_fraction=float(resident_fraction),
            device_id=self.device_id,
        )
        self.enqueue(ticket)
        _flight.note_ticket(ticket)
        _metrics.counter("stream.tickets", kind=kind).inc()
        if bd.copy_s > 0 and cost.staged_bytes > 0:
            charged = cost.staged_bytes * (1.0 - float(resident_fraction))
            chunks = bd.chunks if isinstance(bd, PipelinedBreakdown) else 1
            if charged > 0:
                _metrics.histogram("staging.leg_bytes").observe(
                    charged / chunks, n=chunks)
        tr = _spans.current_tracer()
        if tr is not None:
            _trace_ticket(tr, ticket, bd)
            tr.counter(f"dev{self.device_id}/inflight", ticket.issue_s,
                       float(len(self.inflight)), device_id=self.device_id)
        return ticket

    def requeue(self, ticket: LaunchTicket) -> LaunchTicket:
        """Re-issue an orphaned ticket on this device (failure/resize
        rescheduling): its staging was charged where it first ran, so only
        the modeled completion occupies this device's compute stream."""
        start = max(self.compute_free_s, self.dma_free_s)
        self.compute_free_s = start + ticket.offload_s
        moved = dataclasses.replace(
            ticket,
            issue_s=start,
            copy_ready_s=start,
            copy_done_s=start,
            complete_s=self.compute_free_s,
            compute_start_s=start,
            kind="requeue",
            device_id=self.device_id,
        )
        self.enqueue(moved)
        _flight.note_ticket(moved)
        _metrics.counter("stream.tickets", kind="requeue").inc()
        tr = _spans.current_tracer()
        if tr is not None:
            _trace_ticket(tr, moved, None)
            tr.counter(f"dev{self.device_id}/inflight", moved.issue_s,
                       float(len(self.inflight)), device_id=self.device_id)
        return moved

    def breakdown_for(
        self, cost: OpCost, policy: OffloadPolicy, shape_key: str
    ) -> RegionBreakdown:
        """Score a call on this device with its residency credit applied:
        operands already resident here never pay the copy region.  Scoring
        goes through :meth:`OffloadPolicy.score`, so schedulers comparing
        completion times see the pipelined cost when staging overlap is on.
        """
        return policy.score(
            cost,
            self.platform,
            resident_fraction=(
                1.0 if self.is_resident(shape_key) else None
            ),
        )

    def retire_all(self) -> int:
        """Drain the queue (modeled completion); returns launches retired."""
        n = len(self.inflight)
        self.completed_s += self.pending_s
        self.completed_launches += n
        self.inflight.clear()
        return n

    def fail(self) -> List[LaunchTicket]:
        """Device loss: mark dead, drop residency, surrender in-flight work."""
        self.alive = False
        self._booted = False
        self._l2_image_loaded = False
        self._resident.clear()
        orphans = list(self.inflight)
        self.inflight.clear()
        return orphans


# Cap on per-chunk child spans under one pipelined staging span: keeps the
# trace readable for multi-hundred-chunk copies (the parent span's attrs
# carry the exact chunk count either way).
_MAX_LEG_SPANS = 16


def _trace_ticket(
    tr: "_spans.SpanTracer",
    ticket: LaunchTicket,
    bd: Optional[RegionBreakdown],
) -> None:
    """Emit the stream-lane span(s) for one stamped ticket.

    Only called with an active tracer.  Spans mirror the ticket's event
    pairs exactly — DMA window ``[issue_s, copy_done_s]``, compute window
    ``[compute_start_s, complete_s]`` — and carry the ticket identity in
    attrs so the ``check_obs`` gate can match every ticket to a span.
    """
    dev = ticket.device_id
    attrs = {
        "ticket": True,
        "kind": ticket.kind,
        "op": ticket.op,
        "shape_key": ticket.shape_key,
        "issue_s": ticket.issue_s,
        "complete_s": ticket.complete_s,
        "resident_fraction": ticket.resident_fraction,
    }
    name = f"{ticket.kind}:{ticket.op}"
    copy_dur = ticket.copy_done_s - ticket.issue_s
    if copy_dur > 0:
        staging = tr.emit(name, cat="stream", lane=f"dev{dev}/dma",
                          t0=ticket.issue_s, t1=ticket.copy_done_s,
                          attrs=attrs, device_id=dev)
        if (isinstance(bd, PipelinedBreakdown) and bd.chunks > 1
                and bd.copy_s > 0):
            staging.attrs["chunks"] = bd.chunks
            if bd.chunks <= _MAX_LEG_SPANS:
                t = ticket.issue_s
                rest = max(bd.copy_s - bd.first_copy_leg_s, 0.0)
                leg = rest / (bd.chunks - 1)
                for k in range(bd.chunks):
                    dur = bd.first_copy_leg_s if k == 0 else leg
                    tr.emit(f"leg{k}", cat="stream", lane=f"dev{dev}/dma",
                            t0=t, t1=t + dur, parent_id=staging.span_id,
                            device_id=dev)
                    t += dur
    work_dur = ticket.complete_s - ticket.compute_start_s
    if work_dur > 0 or copy_dur <= 0:
        tr.emit(name, cat="stream", lane=f"dev{dev}/compute",
                t0=ticket.compute_start_s, t1=ticket.complete_s,
                attrs=attrs, device_id=dev)


# ---------------------------------------------------------------------------
# Schedulers.  select(devices, cost, policy) -> VirtualDevice
# ---------------------------------------------------------------------------

def _round_robin():
    counter = itertools.count()

    def select(
        devices: List[VirtualDevice], cost: OpCost, policy: OffloadPolicy,
        shape_key: str,
    ) -> VirtualDevice:
        return devices[next(counter) % len(devices)]

    return select


def _least_loaded():
    def select(
        devices: List[VirtualDevice], cost: OpCost, policy: OffloadPolicy,
        shape_key: str,
    ) -> VirtualDevice:
        # deterministic tie-break by device id
        return min(devices, key=lambda d: (d.pending_s, d.device_id))

    return select


def _cost_aware():
    def select(
        devices: List[VirtualDevice], cost: OpCost, policy: OffloadPolicy,
        shape_key: str,
    ) -> VirtualDevice:
        def completion(d: VirtualDevice) -> float:
            # residency affinity: operands already on the device skip the
            # copy region entirely (paper's resident-buffer observation)
            return d.pending_s + d.breakdown_for(cost, policy, shape_key).offload_s

        return min(devices, key=lambda d: (completion(d), d.device_id))

    return select


SCHEDULERS: Dict[str, Callable[[], Callable]] = {
    "round-robin": _round_robin,
    "least-loaded": _least_loaded,
    "cost-aware": _cost_aware,
}


class HeroCluster:
    """Host-side orchestrator for N virtual PMCA devices (singleton)."""

    def __init__(
        self,
        num_devices: int = 1,
        platform: Platform = H100_SXM,
        scheduler: str = "least-loaded",
    ) -> None:
        self.platform = platform
        self.policy = OffloadPolicy()
        self._scheduler_name = ""
        self._select: Optional[Callable] = None
        self._pinned: Optional[VirtualDevice] = None
        self.devices: List[VirtualDevice] = []
        self._handles: Dict[str, DeviceHandle] = {}
        self.resize(num_devices)
        self.set_scheduler(scheduler)

    # ---- topology ---------------------------------------------------------
    @property
    def num_devices(self) -> int:
        return len(self.devices)

    def _rebuild(self, num_devices: int) -> None:
        """Tear down and rebuild the topology (scoped ``offload_policy``
        entry): every device starts cold and the handle ledger clears."""
        if num_devices < 1:
            raise ValueError(f"cluster needs >= 1 device, got {num_devices}")
        self.devices = [
            VirtualDevice(i, self.platform) for i in range(num_devices)
        ]
        self._handles.clear()       # fresh devices hold nothing yet

    def resize(self, num_devices: int) -> List[Tuple[str, int]]:
        """Elastically grow/shrink the cluster (checkpoint-boundary replan).

        Grow appends cold devices; existing devices keep their queues,
        residency and pinned handles.  Shrink drains the removed devices
        first: their in-flight launches reschedule onto the keepers through
        the active scheduler, and every pinned handle homed on a removed
        device is re-staged onto a keeper (full host->device copy, recorded
        on the new lane — the same path the
        :class:`~repro_torch.runtime.fault_tolerance.ClusterSupervisor`
        takes on device loss).  Returns ``[(handle name, new device), ...]``
        for the re-staged handles (empty on grow).
        """
        if num_devices < 1:
            raise ValueError(f"cluster needs >= 1 device, got {num_devices}")
        cur = len(self.devices)
        if num_devices == cur:
            return []
        if not self.devices:        # first build (from __init__)
            self._rebuild(num_devices)
            return []
        if num_devices > cur:
            self.devices = self.devices + [
                VirtualDevice(i, self.platform)
                for i in range(cur, num_devices)
            ]
            return []
        if not any(d.alive for d in self.devices[:num_devices]):
            raise RuntimeError(
                "cannot shrink: no alive device among the keepers"
            )
        # Drain removed lanes: mark failed (evicts residency, surrenders
        # queues), truncate, then restage handles / reschedule orphans onto
        # the survivors via the active scheduler.
        orphans: List[LaunchTicket] = []
        for d in self.devices[num_devices:]:
            orphans.extend(d.fail())
        lost = [
            h for h in self._handles.values() if h.device_id >= num_devices
        ]
        self.devices = self.devices[:num_devices]
        moves: List[Tuple[str, int]] = []
        for h in lost:
            h.device_id = HOST_DEVICE_ID   # bytes live only in host DRAM now
            self.restage_handle(h)
            moves.append((h.name, h.device_id))
        for t in orphans:
            cost = OpCost(
                op=t.op, flops=0.0, staged_bytes=0.0, touched_bytes=0.0
            )
            target = self._pick(cost, t.shape_key)
            if not target.booted:
                target.boot()
            old_dev = t.device_id
            target.requeue(t)
            self._record_requeue(t, old_dev, target.device_id)
        return moves

    def _record_requeue(self, ticket: LaunchTicket, old_dev: int,
                        new_dev: int) -> None:
        """Account a rescheduled orphan on its surviving device.

        The original launch record keeps the aborted attempt on the lost
        lane; the re-execution charges its compute once, on the survivor —
        with no copy/fork-join regions, matching ``VirtualDevice.requeue``
        which occupies only the compute stream, so the busy-time rollups
        (``OffloadTrace.summary()`` / ``device_timelines()``) keep it.
        """
        accounting.record(
            accounting.OffloadRecord(
                op=ticket.op,
                shape_key=ticket.shape_key,
                dtype="",
                backend="device",
                cost=OpCost(op=ticket.op, flops=0.0, staged_bytes=0.0,
                            touched_bytes=0.0),
                regions=RegionBreakdown(
                    copy_s=0.0, fork_join_s=0.0,
                    compute_s=ticket.offload_s, host_s=0.0,
                ),
                zero_copy=self.policy.zero_copy,
                note=f"requeue {old_dev}->{new_dev}",
                device_id=new_dev,
            )
        )

    def set_scheduler(self, name: str) -> None:
        if name not in SCHEDULERS:
            raise ValueError(
                f"unknown scheduler {name!r}; have {sorted(SCHEDULERS)}"
            )
        self._scheduler_name = name
        self._select = SCHEDULERS[name]()

    @property
    def scheduler(self) -> str:
        return self._scheduler_name

    def set_platform(self, platform: Platform) -> None:
        self.platform = platform
        for d in self.devices:
            d.platform = platform

    def alive_devices(self) -> List[VirtualDevice]:
        return [d for d in self.devices if d.alive]

    def device(self, device_id: int) -> VirtualDevice:
        return self.devices[device_id]

    # ---- lifecycle --------------------------------------------------------
    def boot(self) -> None:
        for d in self.alive_devices():
            d.boot()

    def reset(self) -> None:
        for d in self.devices:
            d.reset()
        self._handles.clear()
        if self._select is not None:
            self.set_scheduler(self._scheduler_name)  # fresh RR counter

    @property
    def booted(self) -> bool:
        return any(d.booted for d in self.devices)

    # ---- residency (cluster-wide convenience; per-device via .device()) ---
    def mark_resident(self, name: str, device_id: Optional[int] = None) -> None:
        """Pin a logical buffer: one device, or all alive devices (None)."""
        targets = (
            [self.devices[device_id]] if device_id is not None
            else self.alive_devices()
        )
        for d in targets:
            d.mark_resident(name)

    def evict(self, name: str, device_id: Optional[int] = None) -> None:
        targets = (
            [self.devices[device_id]] if device_id is not None
            else self.devices
        )
        for d in targets:
            d.evict(name)

    def is_resident(self, name: str, device_id: Optional[int] = None) -> bool:
        if device_id is not None:
            return self.devices[device_id].is_resident(name)
        return any(d.is_resident(name) for d in self.alive_devices())

    # ---- device-resident handles (first-class placement tokens) -----------
    def pin_handle(
        self, name: str, nbytes: float, device_id: Optional[int] = None
    ) -> DeviceHandle:
        """Pin a logical buffer to one device and return its handle.

        ``device_id=None`` lets the active scheduler choose (so pinning a
        KV cache at prefill lands on the least-costly lane).  Re-pinning an
        existing name moves the residency mark to the new home.
        """
        if device_id is not None:
            dev = self.devices[device_id]
            if not dev.alive:
                raise RuntimeError(f"cannot pin to failed device {device_id}")
        else:
            dev = self._pick(d2d_cost(nbytes, op="pin"), name)
        old = self._handles.get(name)
        if old is not None and old.valid and old.device_id != dev.device_id:
            self.devices[old.device_id].evict(name)
        if not dev.booted:
            dev.boot()
        dev.mark_resident(name)
        handle = DeviceHandle(name=name, device_id=dev.device_id,
                              nbytes=float(nbytes))
        self._handles[name] = handle
        self._note_resident_bytes(dev.device_id)
        return handle

    def _note_resident_bytes(self, device_id: int) -> None:
        """Counter-track sample of pinned bytes on one device (traced runs
        only — a single guarded call at every residency transition)."""
        tr = _spans.current_tracer()
        if tr is None or not (0 <= device_id < len(self.devices)):
            return
        total = sum(h.nbytes for h in self.handles_on(device_id))
        tr.counter(f"dev{device_id}/resident_bytes",
                   self.devices[device_id].stream_makespan_s, total,
                   device_id=device_id)

    def handle(self, name: str) -> Optional[DeviceHandle]:
        return self._handles.get(name)

    def handles_on(self, device_id: int) -> List[DeviceHandle]:
        return [h for h in self._handles.values() if h.device_id == device_id]

    def unstage_handle(self, handle: DeviceHandle) -> None:
        """Drain a pinned buffer back to host DRAM, keeping the handle known.

        The unstaged handle stays in the ledger (``valid`` becomes False);
        a later :meth:`restage_handle` pays the host->device copy to bring
        it back.  This is the "don't pin" serving baseline and the state a
        handle enters when its device is lost.
        """
        if self._handles.get(handle.name) is not handle:
            raise KeyError(f"unknown handle {handle.name!r}")
        old_dev = handle.device_id
        if handle.valid and handle.device_id < len(self.devices):
            self.devices[handle.device_id].evict(handle.name)
        handle.device_id = HOST_DEVICE_ID
        self._note_resident_bytes(old_dev)

    def release_handle(self, handle: DeviceHandle) -> None:
        old_dev = handle.device_id
        if handle.valid and handle.device_id < len(self.devices):
            self.devices[handle.device_id].evict(handle.name)
        self._handles.pop(handle.name, None)
        handle.device_id = HOST_DEVICE_ID
        self._note_resident_bytes(old_dev)

    def migrate_handle(
        self, handle: DeviceHandle, device_id: int
    ) -> RegionBreakdown:
        """Move a pinned buffer to another device over the d2d link.

        Charges the ``d2d_copy`` region on the *destination* lane (its DMA
        engine receives the bytes) and records it on the active trace, so
        migrations show up in per-device rollups and the overlap timeline.
        No-op (zero breakdown) when the handle already lives there.
        """
        if self._handles.get(handle.name) is not handle:
            raise KeyError(f"unknown handle {handle.name!r}")
        if not handle.valid:
            raise RuntimeError(
                f"handle {handle.name!r} is unstaged; use restage_handle()"
            )
        if device_id == handle.device_id:
            return RegionBreakdown(0.0, 0.0, 0.0, 0.0)
        dst = self.devices[device_id]
        if not dst.alive:
            raise RuntimeError(f"cannot migrate to failed device {device_id}")
        bd = d2d_breakdown(handle.nbytes, self.platform)
        self.devices[handle.device_id].evict(handle.name)
        if not dst.booted:
            dst.boot()
        dst.mark_resident(handle.name)
        cost = d2d_cost(handle.nbytes)
        ticket = dst.issue(cost, bd, handle.name, kind="d2d")
        tr = _spans.current_tracer()
        if tr is not None:
            # Arrow from the source lane to the receiving DMA window: the
            # bytes leave where the handle lived and land on dst's stream.
            tr.flow(f"d2d:{handle.name}", cat="stream",
                    src_lane=f"dev{handle.device_id}/compute",
                    src_t=ticket.issue_s,
                    dst_lane=f"dev{device_id}/dma",
                    dst_t=ticket.copy_done_s,
                    attrs={"nbytes": handle.nbytes,
                           "src": handle.device_id, "dst": device_id})
        accounting.record(
            accounting.OffloadRecord(
                op=cost.op, shape_key=handle.name, dtype="",
                backend="device", cost=cost, regions=bd,
                zero_copy=self.policy.zero_copy,
                note=f"handle migration {handle.device_id}->{device_id}",
                device_id=device_id,
            )
        )
        old_dev = handle.device_id
        handle.device_id = device_id
        self._note_resident_bytes(old_dev)
        self._note_resident_bytes(device_id)
        return bd

    def restage_handle(
        self, handle: DeviceHandle, device_id: Optional[int] = None
    ) -> RegionBreakdown:
        """Re-stage an unstaged handle from host memory onto a device.

        Used after device loss: the dead device's buffers exist only in
        host DRAM again, so the survivor pays the full host->device copy
        region (the d2d path needs a live source).
        """
        if self._handles.get(handle.name) is not handle:
            raise KeyError(f"unknown handle {handle.name!r}")
        cost = d2d_cost(handle.nbytes, op="restage")
        if device_id is not None:
            dev = self.devices[device_id]
            if not dev.alive:
                raise RuntimeError(
                    f"cannot restage to failed device {device_id}"
                )
        else:
            dev = self._pick(cost, handle.name)
        bd = RegionBreakdown(
            copy_s=self.platform.t_copy(handle.nbytes,
                                        zero_copy=self.policy.zero_copy),
            fork_join_s=self.platform.t_fork_join(),
            compute_s=0.0,
            host_s=0.0,
        )
        if not dev.booted:
            dev.boot()
        dev.mark_resident(handle.name)
        dev.issue(cost, bd, handle.name, kind="restage")
        accounting.record(
            accounting.OffloadRecord(
                op=cost.op, shape_key=handle.name, dtype="",
                backend="device", cost=cost, regions=bd,
                zero_copy=self.policy.zero_copy,
                note="host re-stage after device loss",
                device_id=dev.device_id,
            )
        )
        handle.device_id = dev.device_id
        return bd

    def prefetch_stage(
        self, name: str, nbytes: float, device_id: Optional[int] = None
    ) -> DeviceHandle:
        """Stage a buffer onto a device *ahead of* the op that consumes it.

        The cross-wave half of the DMA pipeline: the graph frontend calls it
        for wave k+1's unresident operands while wave k's compute is still
        in flight, so the copy rides the DMA stream under compute instead of
        serializing in front of the consumer.  The copy is charged on the
        chosen lane's DMA clock (no fork/join — nothing launches) and the
        returned handle carries the residency credit the consumer's
        ``resident_fraction`` math then picks up.
        """
        handle = self.pin_handle(name, nbytes, device_id=device_id)
        dev = self.devices[handle.device_id]
        cost = OpCost(
            op="prefetch_stage",
            flops=0.0,
            staged_bytes=float(nbytes),
            touched_bytes=float(nbytes),
        )
        bd = RegionBreakdown(
            copy_s=self.platform.t_copy(nbytes,
                                        zero_copy=self.policy.zero_copy),
            fork_join_s=0.0,
            compute_s=0.0,
            host_s=0.0,
        )
        dev.issue(cost, bd, name, kind="prefetch")
        accounting.record(
            accounting.OffloadRecord(
                op=cost.op, shape_key=name, dtype="",
                backend="device", cost=cost, regions=bd,
                zero_copy=self.policy.zero_copy,
                note="cross-wave prefetch",
                device_id=dev.device_id,
            )
        )
        return handle

    @contextlib.contextmanager
    def handle_scope(self) -> Iterator[None]:
        """Scope the lifetime of handles pinned inside to the block.

        The graph frontend pins one handle per device-resident intermediate
        so multi-op chains reuse placement; those buffers are dead once the
        graph (or an ``hnp.offload_region``) finishes.  On exit, every handle
        pinned inside the scope is released and its residency mark evicted —
        handles pinned before the scope (weights, KV caches) survive.
        """
        before = set(self._handles)
        try:
            yield
        finally:
            for name in [n for n in self._handles if n not in before]:
                self.release_handle(self._handles[name])

    # ---- fault tolerance --------------------------------------------------
    def fail_device(self, device_id: int) -> List[Tuple[LaunchTicket, int]]:
        """Device loss: evict + reschedule its in-flight work.

        Returns ``[(ticket, new_device_id), ...]`` — each orphaned launch
        re-placed on a surviving device through the active scheduler (never
        through a pin).  Handles homed on the lost device become unstaged
        (their bytes only exist in host memory now); re-placing them is the
        supervisor's call (:meth:`restage_handle`), since it costs a full
        host copy.
        """
        survivors = [
            d for d in self.alive_devices() if d.device_id != device_id
        ]
        if not survivors:
            raise RuntimeError("all devices failed; no reschedule target")
        orphans = self.devices[device_id].fail()
        for h in self.handles_on(device_id):
            h.device_id = HOST_DEVICE_ID
        moved: List[Tuple[LaunchTicket, int]] = []
        for t in orphans:
            cost = OpCost(op=t.op, flops=0.0, staged_bytes=0.0, touched_bytes=0.0)
            target = self._select(survivors, cost, self.policy, t.shape_key)
            if not target.booted:
                target.boot()
            target.requeue(t)
            self._record_requeue(t, device_id, target.device_id)
            moved.append((t, target.device_id))
        return moved

    def restore_device(self, device_id: int) -> None:
        """Bring a failed device back (cold: empty ledger, unbooted)."""
        self.devices[device_id].reset()

    # ---- placement --------------------------------------------------------
    @contextlib.contextmanager
    def pin_device(self, device_id: int) -> Iterator[VirtualDevice]:
        """Force every launch in the scope onto one device.

        Batch-level consumers place a unit of work with :meth:`assign` and
        then execute it under this pin, so the fine-grained launches the
        work issues land on — and are traced against — its assigned lane.
        The pin only affects *placement* of new launches; failure
        rescheduling (:meth:`fail_device`) always goes through the real
        scheduler over the survivors.
        """
        dev = self.devices[device_id]
        if not dev.alive:
            raise RuntimeError(f"device {device_id} is failed")
        saved = self._pinned
        self._pinned = dev
        try:
            yield dev
        finally:
            self._pinned = saved

    def _pick(
        self, cost: OpCost, shape_key: str
    ) -> VirtualDevice:
        """Placement for one new launch: the pinned device if any, else the
        scheduler's choice over the alive devices."""
        if self._pinned is not None:
            if not self._pinned.alive:
                raise RuntimeError(
                    f"pinned device {self._pinned.device_id} failed mid-scope"
                )
            return self._pinned
        alive = self.alive_devices()
        if not alive:
            raise RuntimeError("no alive devices in cluster")
        return self._select(alive, cost, self.policy, shape_key)

    def assign(
        self,
        cost: OpCost,
        shape_key: str,
        handle: Optional[DeviceHandle] = None,
    ) -> Tuple[int, RegionBreakdown]:
        """Place one unit of work (e.g. a serving batch) on a device.

        Scheduler-driven placement without an offload record: boots the
        chosen device, enqueues a ticket for its modeled time, and returns
        ``(device_id, breakdown)`` — the breakdown is exactly what the
        ticket was sized with, so callers account lanes with the same
        numbers the scheduler saw.  Used by batch-level consumers
        (``launch/serve.py``).  ``handle`` declares a data dependency on a
        pinned buffer: placement-affine schedulers (``cost-aware``) see the
        residency credit and are drawn to the device holding it; oblivious
        ones (``round-robin``) are not.
        """
        device_id, bd, _ = self.assign_at(cost, shape_key, handle=handle)
        return device_id, bd

    def assign_at(
        self,
        cost: OpCost,
        shape_key: str,
        *,
        ready_s: float = 0.0,
        device_id: Optional[int] = None,
        handle: Optional[DeviceHandle] = None,
        resident_fraction: Optional[float] = None,
    ) -> Tuple[int, RegionBreakdown, LaunchTicket]:
        """Place one unit of work that becomes *ready* at ``ready_s``.

        The streaming serve engine's issue path: identical to
        :meth:`assign`, but (a) the chosen device's stream clocks are first
        advanced to ``ready_s`` (a request cannot issue before it arrives —
        the gap is modeled idleness, never wall clock), (b) the stamped
        :class:`LaunchTicket` is returned so the caller can read the modeled
        completion event (``complete_s``) for SLO accounting and queue-depth
        admission control, and (c) ``device_id``/``resident_fraction`` may
        be forced (slot-refill launches land on their lane with the weights'
        residency credit, not the scheduler's choice).
        """
        key = (
            handle.name if handle is not None and handle.valid else shape_key
        )
        if device_id is not None:
            dev = self.devices[device_id]
            if not dev.alive:
                raise RuntimeError(f"cannot assign to failed device {device_id}")
        else:
            dev = self._pick(cost, key)
        if not dev.booted:
            dev.boot()
        if ready_s > 0.0:
            dev.advance_clocks(ready_s)
        if resident_fraction is None:
            rf = 1.0 if dev.is_resident(key) else 0.0
            bd = dev.breakdown_for(cost, self.policy, key)
        else:
            rf = min(max(float(resident_fraction), 0.0), 1.0)
            bd = self.policy.score(cost, dev.platform, resident_fraction=rf)
        ticket = dev.issue(cost, bd, key, resident_fraction=rf)
        return dev.device_id, bd, ticket

    # ---- modeled completion ----------------------------------------------
    def sync(self) -> int:
        """Retire every in-flight launch (modeled barrier). Returns count."""
        return sum(d.retire_all() for d in self.devices)

    # ---- the offload decision + bookkeeping -------------------------------
    def launch(
        self,
        cost: OpCost,
        *,
        dtype: str,
        shape_key: str,
        kernel_eligible: bool = False,
        force_host: bool = False,
        note: str = "",
        handle: Optional[DeviceHandle] = None,
        resident_fraction: Optional[float] = None,
    ) -> LaunchResult:
        """Route one BLAS call.  Returns backend + device placement.

        Called from the :mod:`repro_torch.core.dispatch` registry before the
        lowering runs;
        side effect is one :class:`accounting.OffloadRecord` on the active
        trace (if any) and one :class:`LaunchTicket` on the chosen device's
        in-flight queue.  ``handle`` keys scheduling and residency credit on
        a pinned buffer instead of the operand shapes.

        ``resident_fraction`` overrides the policy's blanket fraction with an
        exact per-call value — the graph frontend computes, per node, how
        many operand/result bytes already live (or will stay) in device
        memory and threads that through here, so intermediates consumed
        on-device never pay the host staging region.  When given, it also
        replaces the all-or-nothing ledger bump (the caller already did the
        bookkeeping at byte granularity).
        """
        pol = self.policy
        pol.validate()
        key = (
            handle.name if handle is not None and handle.valid else shape_key
        )
        rf = (
            pol.resident_fraction
            if resident_fraction is None
            else min(max(float(resident_fraction), 0.0), 1.0)
        )
        if force_host:  # ops compiled host-only (paper: syrk.c)
            bd = pol.score(cost, self.platform, resident_fraction=rf)
            _metrics.counter("dispatch.calls", op=cost.op).inc()
            accounting.record(
                accounting.OffloadRecord(
                    op=cost.op, shape_key=shape_key, dtype=dtype,
                    backend="host", cost=cost, regions=bd,
                    zero_copy=pol.zero_copy, note=note or "host-only op",
                    device_id=HOST_DEVICE_ID, resident_fraction=rf,
                )
            )
            return LaunchResult("host")
        if pol.mode == "host":
            offload = False
            bd = pol.score(cost, self.platform, resident_fraction=rf)
        elif pol.mode == "device":
            offload = True
            bd = pol.score(cost, self.platform, resident_fraction=rf)
        else:  # auto — the paper's size-dependent decision
            offload, bd = decide_offload(
                cost,
                self.platform,
                zero_copy=pol.zero_copy,
                resident_fraction=rf,
                min_speedup=pol.min_speedup,
                pipeline=pol.pipeline_staging,
                chunk_bytes=pol.pipeline_chunk_bytes,
            )

        device_id = HOST_DEVICE_ID
        if offload:
            dev = self._pick(cost, key)
            device_id = dev.device_id
            if not dev.booted:
                dev.boot()  # first offload boots the device, as in HeroSDK
            # residency affinity credit on the chosen device (skipped when
            # the caller supplied the exact fraction itself)
            if resident_fraction is None and dev.is_resident(key):
                bd = dev.breakdown_for(cost, pol, key)
                rf = 1.0
            dev.issue(cost, bd, key, resident_fraction=rf)

        if not offload:
            backend = "host"
        elif kernel_eligible and pol.use_kernels:
            backend = "device-kernel"
        else:
            backend = "device"
        _metrics.counter("dispatch.calls", op=cost.op).inc()
        if offload:
            _metrics.counter("dispatch.offloaded", op=cost.op).inc()
        accounting.record(
            accounting.OffloadRecord(
                op=cost.op,
                shape_key=shape_key,
                dtype=dtype,
                backend=backend,
                cost=cost,
                regions=bd,
                zero_copy=pol.zero_copy,
                note=note,
                device_id=device_id,
                resident_fraction=rf,
            )
        )
        return LaunchResult(backend, device_id)

# Singleton cluster — the process's host-side orchestrator.
_ENGINE = HeroCluster()


def engine() -> HeroCluster:
    return _ENGINE


class offload_policy:
    """Context manager to scope policy/platform/topology changes.

    ::

        with offload_policy(mode="auto", platform="hesoc-vcu128",
                            num_devices=4, scheduler="cost-aware"):
            ...
    """

    def __init__(
        self,
        mode: Optional[str] = None,
        *,
        platform: Optional[str] = None,
        zero_copy: Optional[bool] = None,
        min_speedup: Optional[float] = None,
        resident_fraction: Optional[float] = None,
        use_kernels: Optional[bool] = None,
        num_devices: Optional[int] = None,
        scheduler: Optional[str] = None,
        pipeline_staging: Optional[bool] = None,
        pipeline_chunk_bytes: Optional[float] = None,
        prefetch_staging: Optional[bool] = None,
    ) -> None:
        self._overrides = {
            k: v
            for k, v in dict(
                mode=mode,
                zero_copy=zero_copy,
                min_speedup=min_speedup,
                resident_fraction=resident_fraction,
                use_kernels=use_kernels,
                pipeline_staging=pipeline_staging,
                pipeline_chunk_bytes=pipeline_chunk_bytes,
                prefetch_staging=prefetch_staging,
            ).items()
            if v is not None
        }
        self._platform = get_platform(platform) if platform else None
        self._num_devices = num_devices
        self._scheduler = scheduler
        self._saved_policy: Optional[OffloadPolicy] = None
        self._saved_platform: Optional[Platform] = None
        self._saved_devices: Optional[List[VirtualDevice]] = None
        self._saved_scheduler: Optional[str] = None
        self._saved_handles: Optional[Dict[str, DeviceHandle]] = None

    def __enter__(self) -> HeroCluster:
        eng = engine()
        self._saved_policy = dataclasses.replace(eng.policy)
        self._saved_platform = eng.platform
        self._saved_devices = eng.devices
        self._saved_scheduler = eng.scheduler
        self._saved_handles = dict(eng._handles)
        eng.policy = dataclasses.replace(eng.policy, **self._overrides)
        if self._platform is not None:
            eng.set_platform(self._platform)
        if self._num_devices is not None:
            eng._rebuild(self._num_devices)  # scoped topology: fresh devices
        if self._scheduler is not None:
            eng.set_scheduler(self._scheduler)
        return eng

    def __exit__(self, *exc) -> None:
        eng = engine()
        assert self._saved_policy is not None
        eng.policy = self._saved_policy
        eng.platform = self._saved_platform
        eng.devices = self._saved_devices
        for d in eng.devices:
            d.platform = self._saved_platform
        # handles pinned inside the scope die with it (their devices may be
        # scoped); residency marks they left on outer devices are evicted
        for name in set(eng._handles) - set(self._saved_handles):
            eng.evict(name)
        eng._handles = self._saved_handles
        if self._scheduler is not None:
            # only rebuild when overridden — rebuilding resets stateful
            # schedulers (round-robin's counter) in the outer scope
            eng.set_scheduler(self._saved_scheduler)
