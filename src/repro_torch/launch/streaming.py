"""Streaming serving engine: continuous batching over the HeroCluster.

The twin of the reference's ``launch/streaming.py``.  ``serve_cluster``
drains a *fixed list* of batches and reports one makespan.  Production
serving is the opposite shape: requests arrive on a stochastic clock, each
carries its own prompt/output lengths and deadline, and the number that
matters is the **max offered load the cluster sustains while the p99 TTFT
/ per-token tails stay inside SLO**.  This module is that engine, built
entirely on modeled time — it builds no model and launches no kernel:

* **Arrival processes** — seeded Poisson, bursty (on/off modulated
  Poisson) and trace-replay generators producing :class:`Request` streams
  with per-class prompt/output-length distributions and deadlines.  Every
  generator takes an explicit seed; nothing in this file reads a wall
  clock.

* **Continuous batching** — each decode lane owns a slot pool; every step
  decodes one token for every active slot, and slots refill *per step* as
  requests finish, instead of lock-step batch drain.  The per-step issue
  path is :meth:`HeroCluster.assign_at`: the lane's stream clocks advance
  to the step's ready time and the stamped :class:`LaunchTicket` supplies
  the modeled completion event each emitted token is timed with.

* **Prefill/decode disaggregation** — prefill lanes run prompt passes and
  pin the KV cache they build as a :class:`DeviceHandle`; at slot
  assignment the handle migrates to the decode lane over the modeled d2d
  link, exactly the ``serve_cluster`` placement machinery driven per
  request instead of per batch.

* **Admission control with backpressure** — reject/queue decisions read
  modeled in-flight completion times off the prefill lanes' ticket
  streams (``stream_makespan_s`` is the frontier of stamped
  ``complete_s`` events) plus the decode-side backlog; an AIMD slot-target
  controller shrinks the decode width multiplicatively when step latency
  blows the per-token budget and grows it back additively.

The lock-step baseline (:func:`serve_lockstep`) runs the *same trace* on
the same lanes with ``serve_cluster`` semantics modeled per step — batches
form at full width, pad to the longest output, and never refill mid-drain
— so the continuous-vs-lockstep comparison is apples to apples.

:class:`StreamConfig` defaults to the port's ``h100-sxm`` platform row;
the reference defaults to ``tpu-v5e``.  On the same platform the event
streams, reports, slot refills and ticket logs equal the reference's.
"""

from __future__ import annotations

import dataclasses
import heapq
import random
from collections import deque
from typing import Dict, Iterable, List, Optional, Sequence, Tuple

from repro_torch.configs import get_arch
from repro_torch.core import accounting
from repro_torch.core.hero import (
    DeviceHandle,
    HeroCluster,
    LaunchTicket,
    OffloadPolicy,
)
from repro_torch.core.placement import (
    ExpertPlacementPolicy,
    PlacementConfig,
    zipf_histogram,
)
from repro_torch.core.platform import H100_SXM, Platform
from repro_torch.launch import costing
from repro_torch.obs import metrics as _obs_metrics
from repro_torch.obs import spans as _obs_spans

__all__ = [
    "SLO",
    "ArrivalTrace",
    "Request",
    "SlotRefill",
    "StreamConfig",
    "StreamReport",
    "bursty_trace",
    "estimate_capacity",
    "offered_load_sweep",
    "poisson_trace",
    "replay_trace",
    "scale_trace",
    "serve_lockstep",
    "serve_stream",
]


# ---------------------------------------------------------------------------
# Arrival processes
# ---------------------------------------------------------------------------

@dataclasses.dataclass(frozen=True)
class Request:
    """One serving request on the modeled arrival clock."""

    rid: int
    arrival_s: float
    prompt_len: int
    output_len: int
    req_class: str = "default"
    # Absolute first-token deadline (admission rejects requests whose
    # estimated TTFT already misses it).  0 = no deadline.
    deadline_s: float = 0.0


@dataclasses.dataclass(frozen=True)
class ArrivalTrace:
    """A seeded, replayable request stream (sorted by arrival time)."""

    requests: Tuple[Request, ...]
    seed: int
    kind: str                   # "poisson" | "bursty" | "replay" | "scaled"
    duration_s: float

    @property
    def offered_qps(self) -> float:
        return len(self.requests) / max(self.duration_s, 1e-9)


# Request classes: (weight, prompt range, output range, TTFT deadline budget).
# "interactive" models chat turns; "batch" models long-document jobs that
# tolerate a slower first token.  Percentile rollups key on the class name.
DEFAULT_CLASSES: Tuple[Tuple[str, float, Tuple[int, int], Tuple[int, int], float], ...] = (
    ("interactive", 0.8, (16, 128), (16, 96), 0.5),
    ("batch", 0.2, (128, 512), (32, 96), 2.0),
)


def _sample_request(
    rng: random.Random, rid: int, arrival_s: float, classes
) -> Request:
    r = rng.random()
    acc = 0.0
    name, _, prange, orange, budget = classes[-1]
    for cname, weight, cp, co, cb in classes:
        acc += weight
        if r <= acc:
            name, prange, orange, budget = cname, cp, co, cb
            break
    return Request(
        rid=rid,
        arrival_s=arrival_s,
        prompt_len=rng.randint(*prange),
        output_len=rng.randint(*orange),
        req_class=name,
        deadline_s=arrival_s + budget if budget > 0 else 0.0,
    )


def poisson_trace(
    qps: float,
    duration_s: float,
    *,
    seed: int,
    classes=DEFAULT_CLASSES,
) -> ArrivalTrace:
    """Memoryless arrivals at rate ``qps`` (seeded; no wall clock)."""
    rng = random.Random(seed)
    t = 0.0
    reqs: List[Request] = []
    while True:
        t += rng.expovariate(max(qps, 1e-9))
        if t >= duration_s:
            break
        reqs.append(_sample_request(rng, len(reqs), t, classes))
    return ArrivalTrace(tuple(reqs), seed, "poisson", duration_s)


def bursty_trace(
    qps: float,
    duration_s: float,
    *,
    seed: int,
    burst_factor: float = 3.0,
    burst_fraction: float = 0.3,
    period_s: float = 0.25,
    classes=DEFAULT_CLASSES,
) -> ArrivalTrace:
    """On/off modulated Poisson: bursts at ``burst_factor`` x the base rate.

    ``burst_fraction`` of each ``period_s`` window runs hot; the quiet
    remainder is rate-scaled so the *average* offered load is ``qps`` —
    bursty and plain traces at the same ``qps`` are comparable.  Sampled
    by Lewis-Shedler thinning (candidates at the hot rate, accepted with
    probability ``rate(t) / hot``) so the modulation is exact even when
    the quiet rate's mean step would jump clean over a burst window."""
    rng = random.Random(seed)
    hot = max(qps * burst_factor, 1e-9)
    denom = 1.0 - burst_fraction * burst_factor
    cold = qps * max(denom, 0.0) / max(1.0 - burst_fraction, 1e-9)
    t = 0.0
    reqs: List[Request] = []
    while True:
        t += rng.expovariate(hot)
        if t >= duration_s:
            break
        phase = (t % period_s) / period_s
        rate = hot if phase < burst_fraction else cold
        if rng.random() * hot <= rate:
            reqs.append(_sample_request(rng, len(reqs), t, classes))
    return ArrivalTrace(tuple(reqs), seed, "bursty", duration_s)


def replay_trace(
    arrivals: Iterable[Tuple[float, int, int]],
    *,
    seed: int = 0,
    req_class: str = "replay",
    deadline_budget_s: float = 0.0,
) -> ArrivalTrace:
    """Replay explicit ``(arrival_s, prompt_len, output_len)`` rows."""
    reqs = tuple(
        Request(
            rid=i, arrival_s=float(t), prompt_len=int(p), output_len=int(o),
            req_class=req_class,
            deadline_s=float(t) + deadline_budget_s if deadline_budget_s > 0 else 0.0,
        )
        for i, (t, p, o) in enumerate(sorted(arrivals))
    )
    dur = reqs[-1].arrival_s if reqs else 0.0
    return ArrivalTrace(reqs, seed, "replay", dur)


def scale_trace(trace: ArrivalTrace, factor: float) -> ArrivalTrace:
    """Rescale offered load by compressing arrival times (``factor`` > 1 =
    more load).  The request *population* — lengths, classes, order — is
    untouched, so a load sweep built from one base trace compares identical
    work at every point; deadlines keep their relative budget."""
    f = 1.0 / max(float(factor), 1e-9)
    reqs = tuple(
        dataclasses.replace(
            r,
            arrival_s=r.arrival_s * f,
            deadline_s=(
                r.arrival_s * f + (r.deadline_s - r.arrival_s)
                if r.deadline_s > 0 else 0.0
            ),
        )
        for r in trace.requests
    )
    return ArrivalTrace(reqs, trace.seed, "scaled", trace.duration_s * f)


# ---------------------------------------------------------------------------
# Engine configuration
# ---------------------------------------------------------------------------

@dataclasses.dataclass(frozen=True)
class SLO:
    """The serving contract the sweep searches against (p99 budgets)."""

    ttft_s: float = 0.25
    per_token_s: float = 0.008


@dataclasses.dataclass
class StreamConfig:
    """Knobs for one streaming run (all placement is modeled)."""

    num_devices: int = 4
    prefill_lanes: int = 1          # devices [0, prefill_lanes) run prefill
    decode_slots: int = 8           # slot pool size per decode lane
    scheduler: str = "least-loaded"
    # The port's default platform row (the reference defaults to
    # ``tpu-v5e``; parity runs pin it).
    platform: Platform = H100_SXM
    slo: SLO = dataclasses.field(default_factory=SLO)
    # Admission: "none" admits everything, "queue" bounds the backlog,
    # "slo" additionally rejects when the modeled TTFT estimate misses the
    # request's deadline / the SLO budget (backpressure).
    admission: str = "slo"
    max_queue: int = 64
    headroom: float = 0.8           # admit while est. TTFT <= headroom * SLO
    # AIMD slot-target controller (xpra-style congestion response).
    adaptive: bool = True
    aimd_decrease: float = 0.7
    aimd_increase: int = 1
    # Dynamic expert placement: a PlacementConfig here makes every decode
    # step feed its routed-token histogram (seeded Zipf skew over the
    # step's active slots) to an ExpertPlacementPolicy homed on the decode
    # lanes, so live decode traffic drives expert migration/replication.
    # None (the default) leaves serve runs byte-identical to before.
    expert_placement: Optional[PlacementConfig] = None
    expert_zipf_s: float = 1.2

    def __post_init__(self) -> None:
        if self.admission not in ("none", "queue", "slo"):
            raise ValueError(f"bad admission mode {self.admission!r}")
        if not (0 < self.prefill_lanes < self.num_devices):
            raise ValueError(
                "need at least one prefill lane and one decode lane"
            )


@dataclasses.dataclass(frozen=True)
class SlotRefill:
    """One slot-refill edge on a decode lane (the race-rule witness).

    ``refill_issue_s`` is the DMA-stream issue event of the lane's first
    launch after ``freed_rids`` finished; the happens-before invariant
    (``race/slot-refill-before-complete``) is ``refill_issue_s >=
    freed_complete_s`` — a freed slot's successor cannot be issued before
    the finishing request's completion event."""

    device_id: int
    freed_rids: Tuple[int, ...]
    freed_complete_s: float
    next_rids: Tuple[int, ...]
    refill_issue_s: float


@dataclasses.dataclass
class StreamReport:
    """Everything one streaming (or lock-step) run produced."""

    arch: str
    seed: int
    engine: str                     # "continuous" | "lockstep"
    offered_qps: float
    admitted: int
    rejected: int
    completed: int
    sustained_qps: float
    makespan_s: float
    max_active_slots: int
    min_slot_target: int
    slo: accounting.SLOReport
    metrics: List[accounting.RequestMetrics]
    slot_refills: List[SlotRefill]
    # Every ticket this run issued, per device — the full event streams
    # (unlike VirtualDevice.inflight, which is a bounded window), so race
    # checks and rejected-never-launched assertions see the whole run.
    ticket_log: Dict[int, List[LaunchTicket]]
    # Deterministic event trail: (event, modeled_s, id).  Two runs with the
    # same seed must produce identical trails (regression-tested).
    events: List[Tuple[str, float, int]]
    # Flat obs-metrics rollup scoped to this run (admission counts by
    # reason, AIMD decisions, ticket kinds...) — rides into point_dict.
    metrics_rollup: Dict[str, object] = dataclasses.field(
        default_factory=dict)
    # Expert-placement decision identities from this run's decode traffic
    # ((step, kind, expert, src, dst) keys); empty unless
    # StreamConfig.expert_placement was set.
    placement_decisions: List[tuple] = dataclasses.field(
        default_factory=list)

    @property
    def reject_rate(self) -> float:
        total = self.admitted + self.rejected
        return self.rejected / total if total else 0.0

    def point_dict(self) -> dict:
        """One offered-load-sweep row."""
        o = self.slo.overall
        return {
            "offered_qps": round(self.offered_qps, 3),
            "sustained_qps": round(self.sustained_qps, 3),
            "admitted": self.admitted,
            "rejected": self.rejected,
            "completed": self.completed,
            "reject_rate": round(self.reject_rate, 4),
            "ttft_p50_ms": round(o.ttft.p50_s * 1e3, 3),
            "ttft_p95_ms": round(o.ttft.p95_s * 1e3, 3),
            "ttft_p99_ms": round(o.ttft.p99_s * 1e3, 3),
            "per_token_p50_ms": round(o.per_token.p50_s * 1e3, 4),
            "per_token_p95_ms": round(o.per_token.p95_s * 1e3, 4),
            "per_token_p99_ms": round(o.per_token.p99_s * 1e3, 4),
            "meets_slo": self.slo.meets_slo,
            "metrics": dict(self.metrics_rollup),
        }


# ---------------------------------------------------------------------------
# Continuous-batching engine
# ---------------------------------------------------------------------------

class _Lane:
    """Decode-lane state: the slot pool and its in-flight step."""

    def __init__(self, device_id: int, slots: int) -> None:
        self.device_id = device_id
        self.slots = slots
        self.slot_target = slots        # AIMD-controlled (<= slots)
        self.active: List[int] = []     # rids in slots, step order
        self.stepping = False
        self.step_issue_s = 0.0
        self.steps = 0
        # Pending refill witness: set when slots free, consumed by the next
        # issued step on this lane (even across an idle gap).
        self.last_freed: Optional[Tuple[Tuple[int, ...], float]] = None


class _StreamSim:
    """Discrete-event simulation of the streaming server (modeled time)."""

    def __init__(self, arch: str, trace: ArrivalTrace, cfg: StreamConfig,
                 cluster: Optional[HeroCluster] = None) -> None:
        self.arch_cfg = get_arch(arch)
        self.arch = arch
        self.trace = trace
        self.cfg = cfg
        self.cluster = cluster or HeroCluster(
            num_devices=cfg.num_devices, platform=cfg.platform,
            scheduler=cfg.scheduler,
        )
        self.prefill_ids = list(range(cfg.prefill_lanes))
        self.lanes = [
            _Lane(d, cfg.decode_slots)
            for d in range(cfg.prefill_lanes, cfg.num_devices)
        ]
        self.kv_per_token = costing.kv_bytes_per_token(self.arch_cfg)
        self.metrics: Dict[int, accounting.RequestMetrics] = {}
        self.requests: Dict[int, Request] = {r.rid: r for r in trace.requests}
        self.kv_handles: Dict[int, DeviceHandle] = {}
        self.kv_bytes: Dict[int, float] = {}
        self.last_token_s: Dict[int, float] = {}
        self.ready: deque = deque()     # rids with prefill done, no slot yet
        self.inflight_prefills = 0
        self.slot_refills: List[SlotRefill] = []
        self.ticket_log: Dict[int, List[LaunchTicket]] = {}
        self.events: List[Tuple[str, float, int]] = []
        self.max_active = 0
        self.min_slot_target = cfg.decode_slots
        self._weight_handles: List[DeviceHandle] = []
        self._heap: List[Tuple[float, int, str, int]] = []
        self._seq = 0
        # Observability: tracer captured once (a sim is single-use); the
        # request-lifecycle asyncs still open at drain time get closed at
        # the final makespan so exported traces always pair begin/end.
        self._tr = _obs_spans.current_tracer()
        self._open_reqs: List[int] = []
        # Optional dynamic expert placement fed by decode traffic: expert
        # weights home on the decode lanes; each issued decode step routes
        # its active-slot tokens through a seeded Zipf histogram.
        self.placement: Optional[ExpertPlacementPolicy] = None
        self._moe_rng: Optional[random.Random] = None
        if cfg.expert_placement is not None:
            self.placement = ExpertPlacementPolicy(
                cfg.expert_placement, self.cluster)
            self.placement.attach([lane.device_id for lane in self.lanes])
            self._moe_rng = random.Random(trace.seed)

    # -- plumbing -----------------------------------------------------------

    def _push(self, t: float, kind: str, ident: int) -> None:
        self._seq += 1
        heapq.heappush(self._heap, (t, self._seq, kind, ident))

    def _log_ticket(self, ticket: LaunchTicket) -> None:
        self.ticket_log.setdefault(ticket.device_id, []).append(ticket)

    def _pin_weights(self) -> None:
        """Model the stack weights resident on every lane (pinned once at
        server start); per-launch residency credit is threaded through
        ``assign_at`` as an explicit resident fraction."""
        wb = costing.weight_bytes(self.arch_cfg)
        for d in range(self.cfg.num_devices):
            self._weight_handles.append(
                self.cluster.pin_handle(f"stack-weights-d{d}", wb, device_id=d)
            )

    def _release_all(self) -> None:
        for h in list(self.kv_handles.values()) + self._weight_handles:
            self.cluster.release_handle(h)
        self.kv_handles.clear()

    # -- admission ----------------------------------------------------------

    def _avg_output_len(self) -> float:
        pool = [self.requests[r].output_len for r in self.ready]
        for lane in self.lanes:
            pool.extend(self.requests[r].output_len for r in lane.active)
        return sum(pool) / len(pool) if pool else 64.0

    def _estimate_ttft(self, req: Request, now: float) -> float:
        """Modeled TTFT if admitted now, read off the in-flight window:
        prefill-lane frontier (the max stamped ``complete_s``) + prefill
        time + decode-queue drain ahead of this request + one step."""
        lane = min(
            (self.cluster.devices[d] for d in self.prefill_ids),
            key=lambda dev: dev.stream_makespan_s,
        )
        queue_wait = max(0.0, lane.stream_makespan_s - now)
        pcost = costing.prefill_cost(req.prompt_len, self.arch_cfg)
        prefill_s = self.cluster.policy.score(
            pcost, self.cfg.platform,
            resident_fraction=costing.weight_resident_fraction(
                pcost, self.arch_cfg),
        ).offload_s
        step_s = self._step_estimate_s()
        backlog = len(self.ready) + self.inflight_prefills
        free = sum(
            max(0, lane.slot_target - len(lane.active)) for lane in self.lanes
        )
        waves = max(0, backlog - free) / max(
            sum(lane.slot_target for lane in self.lanes), 1
        )
        queue_delay = waves * self._avg_output_len() * step_s
        return queue_wait + prefill_s + queue_delay + step_s

    def _step_estimate_s(self) -> float:
        width = max(sum(len(lane.active) for lane in self.lanes), 1)
        width = min(width, self.cfg.decode_slots)
        cache = width * 128 * self.kv_per_token
        cost = costing.decode_step_cost(width, self.arch_cfg, cache_bytes=cache)
        return self.cluster.policy.score(
            cost, self.cfg.platform, resident_fraction=0.0
        ).offload_s

    def _admit(self, req: Request, now: float) -> Tuple[bool, str]:
        """Admission decision plus the reject reason ("" on admit)."""
        if self.cfg.admission == "none":
            return True, ""
        backlog = len(self.ready) + self.inflight_prefills
        if backlog >= self.cfg.max_queue:
            return False, "queue-full"
        if self.cfg.admission == "queue":
            return True, ""
        est = now + self._estimate_ttft(req, now)
        budget = self.cfg.headroom * self.cfg.slo.ttft_s
        if self.cfg.slo.ttft_s > 0 and est > now + budget:
            return False, "ttft-budget"
        if req.deadline_s > 0 and est > req.deadline_s:
            return False, "deadline"
        return True, ""

    # -- event handlers -----------------------------------------------------

    def _on_arrival(self, req: Request) -> None:
        now = req.arrival_s
        m = accounting.RequestMetrics(
            rid=req.rid, req_class=req.req_class, arrival_s=now,
            prompt_len=req.prompt_len, output_len=req.output_len,
        )
        self.metrics[req.rid] = m
        ok, reason = self._admit(req, now)
        if not ok:
            m.admitted = False
            self.events.append(("reject", now, req.rid))
            _obs_metrics.counter("serve.rejected", reason=reason).inc()
            if self._tr is not None:
                self._tr.instant(f"reject:{reason}", cat="serve",
                                 lane="requests", t=now,
                                 attrs={"rid": req.rid,
                                        "class": req.req_class})
            return
        self.events.append(("admit", now, req.rid))
        _obs_metrics.counter("serve.admitted").inc()
        if self._tr is not None:
            self._tr.async_begin(f"req{req.rid}", cat="serve",
                                 lane="requests", t=now, pair_id=req.rid,
                                 attrs={"class": req.req_class,
                                        "prompt_len": req.prompt_len,
                                        "output_len": req.output_len})
            self._open_reqs.append(req.rid)
        # Prefill on the least-backlogged prefill lane; the request cannot
        # issue before it arrives (assign_at advances the lane clocks).
        lane_id = min(
            self.prefill_ids,
            key=lambda d: self.cluster.devices[d].stream_makespan_s,
        )
        pcost = costing.prefill_cost(req.prompt_len, self.arch_cfg)
        _, _, ticket = self.cluster.assign_at(
            pcost, f"prefill-{req.rid}", ready_s=now, device_id=lane_id,
            resident_fraction=costing.weight_resident_fraction(
                pcost, self.arch_cfg),
        )
        self._log_ticket(ticket)
        self.inflight_prefills += 1
        # The prefill builds this request's KV cache on its lane.
        kv = req.prompt_len * self.kv_per_token
        self.kv_bytes[req.rid] = kv
        self.kv_handles[req.rid] = self.cluster.pin_handle(
            f"kv-{req.rid}", kv, device_id=lane_id
        )
        m.prefill_done_s = ticket.complete_s
        self._push(ticket.complete_s, "prefill_done", req.rid)

    def _on_prefill_done(self, rid: int, now: float) -> None:
        self.inflight_prefills -= 1
        self.ready.append(rid)
        self.events.append(("ready", now, rid))
        if self._tr is not None:
            self._tr.async_instant("prefill-done", cat="serve",
                                   lane="requests", t=now, pair_id=rid)
            self._tr.counter("ready_queue", now, float(len(self.ready)))
        # Wake any idle lane (one with no step in flight).
        for lane in sorted(self.lanes, key=lambda L: len(L.active)):
            if not lane.stepping:
                self._refill_and_step(lane, now)

    def _refill_and_step(self, lane: _Lane, now: float) -> None:
        """Refill free slots from the ready queue, then issue one step."""
        refilled: List[int] = []
        while self.ready and len(lane.active) < lane.slot_target:
            rid = self.ready.popleft()
            handle = self.kv_handles[rid]
            if handle.device_id != lane.device_id:
                # KV migrates from its prefill lane at-or-after `now`
                # (slots it fills were freed at `now` at the earliest).
                self.cluster.devices[lane.device_id].advance_clocks(now)
                src_dev = handle.device_id
                self.cluster.migrate_handle(handle, lane.device_id)
                self._log_ticket(
                    self.cluster.devices[lane.device_id].inflight[-1]
                )
                if self._tr is not None:
                    self._tr.async_instant(
                        "kv-migrate", cat="serve", lane="requests", t=now,
                        pair_id=rid,
                        attrs={"src": src_dev, "dst": lane.device_id})
            lane.active.append(rid)
            refilled.append(rid)
        if not lane.active:
            return
        self.max_active = max(
            self.max_active, sum(len(L.active) for L in self.lanes)
        )
        cache = sum(
            self.kv_bytes[r]
            + self.metrics[r].tokens_out * self.kv_per_token
            for r in lane.active
        )
        cost = costing.decode_step_cost(
            len(lane.active), self.arch_cfg, cache_bytes=cache
        )
        # Weights + KV ride touched bytes (device-resident); staged bytes
        # are this step's activations only, so no residency credit applies.
        _, _, ticket = self.cluster.assign_at(
            cost, f"decode-step-d{lane.device_id}-{lane.steps}",
            ready_s=now, device_id=lane.device_id, resident_fraction=0.0,
        )
        self._log_ticket(ticket)
        if lane.last_freed is not None:
            freed_rids, freed_t = lane.last_freed
            self.slot_refills.append(SlotRefill(
                device_id=lane.device_id,
                freed_rids=freed_rids,
                freed_complete_s=freed_t,
                next_rids=tuple(refilled),
                refill_issue_s=ticket.issue_s,
            ))
            if self._tr is not None:
                # Arrow from the freeing completion to the refilled step.
                self._tr.flow(
                    "slot-refill", cat="serve",
                    src_lane=f"dev{lane.device_id}/compute", src_t=freed_t,
                    dst_lane=f"dev{lane.device_id}/compute",
                    dst_t=ticket.issue_s,
                    attrs={"freed": list(freed_rids),
                           "next": list(refilled)})
            lane.last_freed = None
        if self._tr is not None:
            self._tr.counter(
                "decode_slots_active", ticket.issue_s,
                float(sum(len(L.active) for L in self.lanes)))
        lane.stepping = True
        lane.step_issue_s = ticket.issue_s
        lane.steps += 1
        if self.placement is not None:
            # This step's tokens (one per active slot) hit the router; the
            # policy sees the histogram at the step's modeled issue time so
            # any migrate/replicate d2d lands on the lane clocks after it.
            hist = zipf_histogram(
                self._moe_rng, self.placement.cfg.num_experts,
                self.cfg.expert_zipf_s, len(lane.active),
            )
            for d in self.placement.step(hist, now_s=ticket.issue_s):
                if d.ticket is not None:
                    self._log_ticket(d.ticket)
                t_dec = (d.ticket.issue_s if d.ticket is not None
                         else ticket.issue_s)
                self.events.append((f"placement-{d.kind}", t_dec, d.expert))
        self._push(ticket.complete_s, "step_done", lane.device_id)

    def _on_step_done(self, lane: _Lane, now: float) -> None:
        lane.stepping = False
        finished: List[int] = []
        for rid in lane.active:
            m = self.metrics[rid]
            m.tokens_out += 1
            if m.tokens_out == 1:
                m.first_token_s = now
                self.events.append(("first_token", now, rid))
                if self._tr is not None:
                    self._tr.async_instant("first-token", cat="serve",
                                           lane="requests", t=now,
                                           pair_id=rid)
            else:
                m.token_latencies_s.append(now - self.last_token_s[rid])
            self.last_token_s[rid] = now
            if m.tokens_out >= m.output_len:
                finished.append(rid)
        for rid in finished:
            m = self.metrics[rid]
            m.finish_s = now
            lane.active.remove(rid)
            self.cluster.release_handle(self.kv_handles.pop(rid))
            self.events.append(("finish", now, rid))
            if self._tr is not None:
                self._tr.async_end(f"req{rid}", cat="serve",
                                   lane="requests", t=now, pair_id=rid,
                                   attrs={"tokens": m.tokens_out})
                self._open_reqs.remove(rid)
        if finished:
            lane.last_freed = (tuple(finished), now)
        if self.cfg.adaptive:
            # AIMD: the step's modeled latency *is* the per-token latency
            # when steps are back to back — shrink the width target hard
            # when it exceeds the budget, regrow it additively.
            step_s = now - lane.step_issue_s
            before = lane.slot_target
            if step_s > self.cfg.slo.per_token_s > 0:
                lane.slot_target = max(
                    1, int(lane.slot_target * self.cfg.aimd_decrease)
                )
                _obs_metrics.counter("serve.aimd",
                                     decision="decrease").inc()
            else:
                lane.slot_target = min(
                    lane.slots, lane.slot_target + self.cfg.aimd_increase
                )
            if self._tr is not None and lane.slot_target != before:
                decision = ("aimd-decrease" if lane.slot_target < before
                            else "aimd-increase")
                self._tr.instant(
                    decision, cat="serve", lane="aimd", t=now,
                    attrs={"device": lane.device_id, "step_s": step_s,
                           "slot_target": lane.slot_target,
                           "was": before})
            self.min_slot_target = min(self.min_slot_target, lane.slot_target)
        self._refill_and_step(lane, now)

    # -- event loop ---------------------------------------------------------

    def run(self) -> StreamReport:
        self._pin_weights()
        lane_by_id = {lane.device_id: lane for lane in self.lanes}
        with _obs_metrics.collect() as reg:
            try:
                for req in self.trace.requests:
                    self._push(req.arrival_s, "arrival", req.rid)
                while self._heap:
                    t, _, kind, ident = heapq.heappop(self._heap)
                    if kind == "arrival":
                        self._on_arrival(self.requests[ident])
                    elif kind == "prefill_done":
                        self._on_prefill_done(ident, t)
                    else:
                        self._on_step_done(lane_by_id[ident], t)
                self.cluster.sync()
            finally:
                self._release_all()
        if self._tr is not None and self._open_reqs:
            # Requests still mid-decode when the trace drained: close their
            # lifecycle tracks at the run's modeled frontier so exported
            # traces always pair async begin/end.
            end_t = max((d.stream_makespan_s for d in self.cluster.devices),
                        default=0.0)
            for rid in self._open_reqs:
                self._tr.async_end(f"req{rid}", cat="serve",
                                   lane="requests", t=end_t, pair_id=rid,
                                   attrs={"drained": True})
            self._open_reqs.clear()
        rep = self._report()
        rep.metrics_rollup = reg.rollup()
        return rep

    def _report(self) -> StreamReport:
        ms = [self.metrics[r.rid] for r in self.trace.requests
              if r.rid in self.metrics]
        admitted = sum(1 for m in ms if m.admitted)
        completed = sum(1 for m in ms if m.completed)
        finishes = [m.finish_s for m in ms if m.completed]
        arrivals = [m.arrival_s for m in ms]
        span = (max(finishes) - min(arrivals)) if finishes else 0.0
        return StreamReport(
            arch=self.arch,
            seed=self.trace.seed,
            engine="continuous",
            offered_qps=self.trace.offered_qps,
            admitted=admitted,
            rejected=len(ms) - admitted,
            completed=completed,
            sustained_qps=completed / max(span, 1e-9),
            makespan_s=span,
            max_active_slots=self.max_active,
            min_slot_target=self.min_slot_target,
            slo=accounting.slo_report(
                ms, ttft_slo_s=self.cfg.slo.ttft_s,
                per_token_slo_s=self.cfg.slo.per_token_s,
            ),
            metrics=ms,
            slot_refills=self.slot_refills,
            ticket_log=self.ticket_log,
            events=self.events,
            placement_decisions=(
                list(self.placement.decision_log)
                if self.placement is not None else []
            ),
        )


def serve_stream(
    arch: str,
    trace: ArrivalTrace,
    *,
    config: Optional[StreamConfig] = None,
    cluster: Optional[HeroCluster] = None,
) -> StreamReport:
    """Run the continuous-batching streaming server over one trace.

    Fully modeled and deterministic: same ``trace`` (same seed) and same
    ``config`` produce an identical :attr:`StreamReport.events` trail."""
    cfg = config or StreamConfig()
    return _StreamSim(arch, trace, cfg, cluster=cluster).run()


# ---------------------------------------------------------------------------
# Lock-step baseline (serve_cluster semantics, modeled per step)
# ---------------------------------------------------------------------------

def serve_lockstep(
    arch: str,
    trace: ArrivalTrace,
    *,
    config: Optional[StreamConfig] = None,
) -> StreamReport:
    """The ``serve_cluster`` drain discipline on a live arrival stream.

    Requests batch in arrival order at the full slot width; a batch's
    prefill cannot start until its *last* member arrives (batch-forming
    wait), decode runs every step at full width padded to the longest
    output (finished slots keep burning), and no slot refills until the
    whole batch drains.  Same lanes, same cost model, same trace as
    :func:`serve_stream` — the delta is purely the batching discipline,
    which is what the ``continuous_vs_lockstep`` headline isolates."""
    cfg = config or StreamConfig()
    arch_cfg = get_arch(arch)
    cluster = HeroCluster(
        num_devices=cfg.num_devices, platform=cfg.platform,
        scheduler=cfg.scheduler,
    )
    kv_tok = costing.kv_bytes_per_token(arch_cfg)
    wb = costing.weight_bytes(arch_cfg)
    weight_handles = [
        cluster.pin_handle(f"stack-weights-d{d}", wb, device_id=d)
        for d in range(cfg.num_devices)
    ]
    decode_ids = list(range(cfg.prefill_lanes, cfg.num_devices))
    prefill_ids = list(range(cfg.prefill_lanes))
    metrics: List[accounting.RequestMetrics] = []
    ticket_log: Dict[int, List[LaunchTicket]] = {}
    events: List[Tuple[str, float, int]] = []

    def log(t: LaunchTicket) -> None:
        ticket_log.setdefault(t.device_id, []).append(t)

    reqs = list(trace.requests)
    batches = [
        reqs[i:i + cfg.decode_slots]
        for i in range(0, len(reqs), cfg.decode_slots)
    ]
    try:
        for bi, batch in enumerate(batches):
            ready_t = max(r.arrival_s for r in batch)  # batch-forming wait
            ms = [
                accounting.RequestMetrics(
                    rid=r.rid, req_class=r.req_class, arrival_s=r.arrival_s,
                    prompt_len=r.prompt_len, output_len=r.output_len,
                )
                for r in batch
            ]
            metrics.extend(ms)
            p_lane = min(
                prefill_ids,
                key=lambda d: cluster.devices[d].stream_makespan_s,
            )
            pcost = costing.prefill_cost(
                sum(r.prompt_len for r in batch), arch_cfg
            )
            _, _, pt = cluster.assign_at(
                pcost, f"lockstep-prefill-{bi}", ready_s=ready_t,
                device_id=p_lane,
                resident_fraction=costing.weight_resident_fraction(
                    pcost, arch_cfg),
            )
            log(pt)
            for m in ms:
                m.prefill_done_s = pt.complete_s
            kv0 = sum(r.prompt_len for r in batch) * kv_tok
            handle = cluster.pin_handle(f"kv-batch-{bi}", kv0, device_id=p_lane)
            d_lane = min(
                decode_ids,
                key=lambda d: cluster.devices[d].stream_makespan_s,
            )
            cluster.devices[d_lane].advance_clocks(pt.complete_s)
            cluster.migrate_handle(handle, d_lane)
            log(cluster.devices[d_lane].inflight[-1])
            width = len(batch)
            max_out = max(r.output_len for r in batch)
            last_tok = {r.rid: 0.0 for r in batch}
            step_ready = pt.complete_s
            for step in range(max_out):
                # padded: every slot charges compute + KV whether or not
                # its request already finished (the lock-step tax)
                cache = kv0 + width * step * kv_tok
                cost = costing.decode_step_cost(
                    width, arch_cfg, cache_bytes=cache
                )
                _, _, st = cluster.assign_at(
                    cost, f"lockstep-decode-{bi}-{step}", ready_s=step_ready,
                    device_id=d_lane, resident_fraction=0.0,
                )
                log(st)
                step_ready = 0.0  # subsequent steps queue on the lane clock
                now = st.complete_s
                for r, m in zip(batch, ms):
                    if m.tokens_out >= m.output_len:
                        continue
                    m.tokens_out += 1
                    if m.tokens_out == 1:
                        m.first_token_s = now
                        events.append(("first_token", now, r.rid))
                    else:
                        m.token_latencies_s.append(now - last_tok[r.rid])
                    last_tok[r.rid] = now
                    if m.tokens_out >= m.output_len:
                        m.finish_s = now
                        events.append(("finish", now, r.rid))
            cluster.release_handle(handle)
        cluster.sync()
    finally:
        for h in weight_handles:
            cluster.release_handle(h)
    completed = sum(1 for m in metrics if m.completed)
    finishes = [m.finish_s for m in metrics if m.completed]
    arrivals = [m.arrival_s for m in metrics]
    span = (max(finishes) - min(arrivals)) if finishes else 0.0
    return StreamReport(
        arch=arch,
        seed=trace.seed,
        engine="lockstep",
        offered_qps=trace.offered_qps,
        admitted=len(metrics),
        rejected=0,
        completed=completed,
        sustained_qps=completed / max(span, 1e-9),
        makespan_s=span,
        max_active_slots=cfg.decode_slots * len(decode_ids),
        min_slot_target=cfg.decode_slots,
        slo=accounting.slo_report(
            metrics, ttft_slo_s=cfg.slo.ttft_s,
            per_token_slo_s=cfg.slo.per_token_s,
        ),
        metrics=metrics,
        slot_refills=[],
        ticket_log=ticket_log,
        events=events,
    )


# ---------------------------------------------------------------------------
# Offered-load sweep (the headline producer)
# ---------------------------------------------------------------------------

def estimate_capacity(arch: str, config: Optional[StreamConfig] = None) -> float:
    """Back-of-envelope sustainable QPS from the cost model (sweep anchor).

    Decode bound: each lane completes ``slots`` requests every
    ``avg_output x step_time`` seconds at full width; prefill bound: one
    prompt pass per request per prefill lane.  The knee lives near the
    smaller of the two — load points are placed as fractions of it."""
    cfg = config or StreamConfig()
    arch_cfg = get_arch(arch)
    score = OffloadPolicyScore(cfg)
    avg_prompt, avg_out = 96, 56    # midpoints of DEFAULT_CLASSES mixture
    kv = (
        cfg.decode_slots * (avg_prompt + avg_out)
        * costing.kv_bytes_per_token(arch_cfg)
    )
    step_s = score(
        costing.decode_step_cost(cfg.decode_slots, arch_cfg, cache_bytes=kv)
    )
    decode_lanes = cfg.num_devices - cfg.prefill_lanes
    decode_qps = decode_lanes * cfg.decode_slots / (avg_out * step_s)
    pcost = costing.prefill_cost(avg_prompt, arch_cfg)
    prefill_s = score(
        pcost, rf=costing.weight_resident_fraction(pcost, arch_cfg)
    )
    prefill_qps = cfg.prefill_lanes / prefill_s
    return min(decode_qps, prefill_qps)


class OffloadPolicyScore:
    """Tiny adapter: score a cost on a config's platform (no cluster)."""

    def __init__(self, cfg: StreamConfig) -> None:
        self.policy = OffloadPolicy()
        self.platform = cfg.platform

    def __call__(self, cost, rf: float = 0.0) -> float:
        return self.policy.score(
            cost, self.platform, resident_fraction=rf
        ).offload_s


def offered_load_sweep(
    arch: str = "yi-6b",
    *,
    utils: Sequence[float] = (0.5, 1.0, 2.0),
    seed: int = 0,
    duration_s: float = 1.5,
    config: Optional[StreamConfig] = None,
) -> dict:
    """Sweep offered load over one bursty trace; produce the bench section.

    One base bursty trace at the highest load point is time-scaled down to
    the lower points (:func:`scale_trace`), so every point — and the
    lock-step baseline — serves the *identical request population*.  The
    headline is ``max_qps_at_slo``: the largest sustained QPS among points
    whose p99 TTFT / per-token tails meet the SLO."""
    cfg = config or StreamConfig()
    capacity = estimate_capacity(arch, cfg)
    top = max(utils)
    base = bursty_trace(capacity * top, duration_s, seed=seed)
    points: List[dict] = []
    lockstep_points: List[dict] = []
    runs: List[Tuple[ArrivalTrace, StreamReport, StreamReport]] = []
    best: Optional[int] = None
    for u in utils:
        trace = scale_trace(base, u / top)
        rep = serve_stream(arch, trace, config=cfg)
        lock = serve_lockstep(arch, trace, config=cfg)
        runs.append((trace, rep, lock))
        points.append(rep.point_dict())
        lockstep_points.append(lock.point_dict())
        if rep.slo.meets_slo and (
            best is None or rep.sustained_qps > runs[best][1].sustained_qps
        ):
            best = len(runs) - 1
    max_qps = runs[best][1].sustained_qps if best is not None else 0.0
    lock_max = max(
        (p["sustained_qps"] for p in lockstep_points if p["meets_slo"]),
        default=0.0,
    )
    # Continuous vs lock-step on the SAME trace at the knee: the batching
    # discipline is the only delta.
    knee, cont_at_knee, lock_at_knee = runs[best if best is not None else 0]
    speedup = cont_at_knee.sustained_qps / max(
        lock_at_knee.sustained_qps, 1e-9
    )
    return {
        "arch": arch,
        "seed": seed,
        "trace": "bursty",
        "duration_s": duration_s,
        "estimated_capacity_qps": round(capacity, 3),
        "slo": {
            "ttft_ms": cfg.slo.ttft_s * 1e3,
            "per_token_ms": cfg.slo.per_token_s * 1e3,
        },
        "config": {
            "num_devices": cfg.num_devices,
            "prefill_lanes": cfg.prefill_lanes,
            "decode_slots": cfg.decode_slots,
            "admission": cfg.admission,
            "adaptive": cfg.adaptive,
        },
        "points": points,
        "lockstep_points": lockstep_points,
        "max_qps_at_slo": round(max_qps, 3),
        "lockstep_max_qps_at_slo": round(lock_max, 3),
        "continuous_vs_lockstep": {
            "knee_offered_qps": round(knee.offered_qps, 3),
            "continuous_qps": round(cont_at_knee.sustained_qps, 3),
            "lockstep_qps": round(lock_at_knee.sustained_qps, 3),
            "speedup": round(speedup, 3),
        },
    }
