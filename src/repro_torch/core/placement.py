"""Dynamic expert placement — migrate/replicate hot experts under skew.

A static expert-parallel layout homes expert ``e`` on lane ``e * L // E``
forever, so a Zipfian router serializes
the whole step on whichever lane owns the hot experts (the head of a
s=1.2 popularity curve puts ~70% of all routed tokens on one of four
lanes).  This module makes placement a *policy*, not a layout constant:

* each expert's weight triple (``we_gate``/``we_up``/``we_down``) is a
  first-class :class:`~repro_torch.core.hero.DeviceHandle` homed on a lane
  (:meth:`ExpertPlacementPolicy.attach` pins that contiguous-block
  layout);
* the route/pack stage surfaces a per-expert token histogram, and
  :meth:`ExpertPlacementPolicy.step` folds it into a rolling (EMA) token
  share per expert with enter/exit hysteresis on the "hot" state;
* a hot expert **migrates** d2d to the lane that most reduces the modeled
  per-step makespan — but only when the move amortizes: the projected
  saving over ``amortize_steps`` steps must exceed the
  :func:`~repro_torch.core.cost_model.d2d_breakdown` cost of moving its bytes
  (charged for real on the destination lane's DMA stream clock);
* a *persistently* hot expert **replicates** onto a second lane
  (:meth:`~repro_torch.core.hero.HeroCluster.replicate_handle`), and
  :meth:`ExpertPlacementPolicy.plan` splits its tokens across the copies;
* capacity factors + token dropping are explicit knobs — every dropped
  token copy is counted (``moe.tokens_dropped{expert=}``), never silently
  lost: ``tokens_routed == tokens_processed + tokens_dropped`` by
  construction.

:meth:`plan` compiles one step's histogram into an
:class:`ExpertDispatchPlan` — the per-expert, handle-affine sub-launch
fan-out that ``dispatch_placed(..., placement=plan)`` executes under one
dispatch graph (the math lowering is untouched; only the accounting fans
out, so the placed path is bitwise-equal to the static one).

Everything here is modeled-time and deterministic: decisions are pure
arithmetic over the histogram stream, and the only randomness is the
caller's seeded :class:`random.Random` feeding :func:`zipf_histogram`.
The lanes are the modeled cluster's: on one card every expert's math runs
where the unplaced call's does, and only the books fan out.  Pure Python,
the twin of the reference's ``src/repro/core/placement.py``; the port's
:func:`run_skewed_workload` and :func:`placement_sweep` default to the
port's ``h100-sxm`` platform row (the reference: ``tpu-v5e``).
"""

from __future__ import annotations

import bisect
import dataclasses
import itertools
import math
import random
from typing import Dict, List, Optional, Sequence, Tuple

from repro_torch.core.cost_model import OpCost, d2d_breakdown, gemm_cost
from repro_torch.core.hero import (
    DeviceHandle,
    HeroCluster,
    LaunchTicket,
    engine,
    offload_policy,
)
from repro_torch.obs import metrics as _metrics
from repro_torch.obs import spans as _spans

__all__ = [
    "ExpertDispatchPlan",
    "ExpertPlacementPolicy",
    "MigrationEdge",
    "PlacedSubLaunch",
    "PlacementConfig",
    "PlacementDecision",
    "SkewedRunResult",
    "placement_sweep",
    "run_skewed_workload",
    "zipf_histogram",
    "zipf_shares",
]


# ---------------------------------------------------------------------------
# Plan / decision records
# ---------------------------------------------------------------------------

@dataclasses.dataclass(frozen=True)
class PlacedSubLaunch:
    """One expert's share of a grouped-FFN step, placed on one lane.

    ``shape_key`` is the expert-weight handle name on that lane, so the
    ticket keys the residency ledger exactly like every handle-affine
    launch; ``resident_fraction`` is the weight bytes' share of the staged
    operand set (the activations still ride the DMA stream)."""

    expert: int
    device_id: int
    tokens: int
    cost: OpCost
    shape_key: str
    resident_fraction: float


@dataclasses.dataclass(frozen=True)
class ExpertDispatchPlan:
    """Per-expert placed fan-out for one grouped-FFN dispatch.

    Conservation is structural: ``tokens_routed == tokens_processed +
    tokens_dropped`` (the bench gate asserts zero unaccounted drops)."""

    sub_launches: Tuple[PlacedSubLaunch, ...]
    tokens_routed: int
    tokens_processed: int
    tokens_dropped: int
    dropped_by_expert: Tuple[int, ...]
    capacity: int  # per expert copy per step (0 = unbounded)


@dataclasses.dataclass(frozen=True)
class MigrationEdge:
    """Happens-before witness for one expert-weight d2d migration.

    ``src_drain_s`` is the latest modeled completion of a source-lane
    launch still reading the handle when the move was decided; the
    migration ticket may not issue before it.  Duck-typed for
    the reference's ``analysis.races.check_expert_migrations`` (the
    ``race/expert-migrate-before-drain`` rule; the port's ``analysis/`` is
    still to come)."""

    expert: int
    handle_name: str
    src_device: int
    dst_device: int
    migrate_issue_s: float
    src_drain_s: float


@dataclasses.dataclass
class PlacementDecision:
    """One executed placement action (``kind`` is "migrate"/"replicate")."""

    step: int
    kind: str
    expert: int
    src_device: int
    dst_device: int
    d2d_s: float
    share: float
    ticket: Optional[LaunchTicket] = dataclasses.field(
        default=None, compare=False, repr=False)

    @property
    def key(self) -> tuple:
        """Comparable identity (same-seed runs must produce equal keys)."""
        return (self.step, self.kind, self.expert,
                self.src_device, self.dst_device)


# ---------------------------------------------------------------------------
# Policy configuration
# ---------------------------------------------------------------------------

@dataclasses.dataclass
class PlacementConfig:
    """Knobs of the dynamic-placement policy.

    Hotness thresholds are multiples of the fair share ``1/E`` with
    enter/exit hysteresis: an expert turns hot at ``hot_enter_x / E`` and
    only cools below ``hot_exit_x / E``, so a share oscillating between
    the two never flaps (and never re-triggers the rising-edge migration
    check — the no-ping-pong property the tests pin)."""

    num_experts: int = 16
    # Modeled expert dims default to a realistic MoE block (Mixtral-class):
    # per-token staging/compute must dominate the per-launch fork/join
    # overhead or lane makespan stops tracking token load entirely.
    d_model: int = 2048
    d_ff: int = 5632
    itemsize: int = 2               # weight dtype bytes (bf16)
    enabled: bool = True            # False = static homes, no decisions
    ema_alpha: float = 0.3          # rolling token-share smoothing
    hot_enter_x: float = 1.5        # hot when share >= hot_enter_x / E
    hot_exit_x: float = 1.1         # cool when share <  hot_exit_x  / E
    cooldown_steps: int = 16        # min steps between moves of one expert
    recheck_steps: int = 4          # re-score a still-hot expert's migration
    replicate_after: int = 8        # hot-streak period between replica checks
    max_replicas: int = 1           # extra copies per expert
    capacity_factor: float = 4.0    # per-copy slot headroom over fair share
    drop_tokens: bool = True        # clamp to capacity (drops are counted)
    amortize_steps: int = 16        # horizon a migration must pay back over
    name_prefix: str = "moe"        # handle namespace: {prefix}/expert{e}

    @property
    def expert_nbytes(self) -> float:
        """Bytes of one expert's weight triple (gate + up + down)."""
        return 3.0 * self.d_model * self.d_ff * self.itemsize


def _split_tokens(
    n: int, ncopies: int, cap: Optional[int]
) -> Tuple[List[int], int]:
    """Split ``n`` token copies across ``ncopies`` expert copies, each
    holding at most ``cap`` (None = unbounded).  Returns (parts, dropped)."""
    kept = n if cap is None else min(n, cap * ncopies)
    base, rem = divmod(kept, ncopies)
    parts = [base + (1 if i < rem else 0) for i in range(ncopies)]
    return parts, n - kept


# ---------------------------------------------------------------------------
# The policy
# ---------------------------------------------------------------------------

class ExpertPlacementPolicy:
    """Consume per-step expert histograms; migrate/replicate hot experts.

    Lifecycle: construct with a :class:`PlacementConfig`, ``attach()`` to
    pin one weight handle per expert (contiguous blocks over the lanes —
    the static layout), then per dispatch step call :meth:`step` with the
    route/pack histogram (decisions execute immediately on the cluster,
    d2d charged on the destination lane's stream clocks) and :meth:`plan`
    to build the placed sub-launch fan-out for that step's tokens.

    All decision state is host-side Python — the policy never touches the
    tensor math, which is how the placed path stays bitwise-equal to the
    static grouped MoE.
    """

    def __init__(
        self,
        cfg: Optional[PlacementConfig] = None,
        cluster: Optional[HeroCluster] = None,
    ) -> None:
        self.cfg = cfg or PlacementConfig()
        self.cluster = cluster if cluster is not None else engine()
        e = self.cfg.num_experts
        self.lanes: List[int] = []
        self.home: List[int] = []                  # expert -> home lane
        self.handles: Dict[int, DeviceHandle] = {}
        self.replica_lanes: Dict[int, List[int]] = {i: [] for i in range(e)}
        self.share: List[float] = [1.0 / e] * e    # EMA token share
        self.tokens_ema: float = 0.0               # EMA tokens per step
        self.hot: List[bool] = [False] * e
        self.hot_streak: List[int] = [0] * e
        self.cooldown: List[int] = [0] * e
        self.step_count = 0
        self.decisions: List[PlacementDecision] = []
        self.migration_edges: List[MigrationEdge] = []
        self.tokens_routed = 0
        self.tokens_processed = 0
        self.tokens_dropped = 0
        self.dropped_by_expert: List[int] = [0] * e

    # ---- attachment -------------------------------------------------------
    @property
    def attached(self) -> bool:
        return bool(self.handles)

    @property
    def enabled(self) -> bool:
        return self.cfg.enabled

    def attach(self, lanes: Optional[Sequence[int]] = None) -> None:
        """Pin each expert's weight triple as a handle homed on a lane.

        Homes are contiguous blocks over ``lanes`` (expert ``e`` on lane
        ``lanes[e·L//E]``) — exactly the static expert-parallel shard_map
        layout, so the policy-off placement matches today's plan."""
        if self.attached:
            raise RuntimeError("placement policy already attached")
        if lanes is None:
            lanes = [d.device_id for d in self.cluster.alive_devices()]
        self.lanes = [int(x) for x in lanes]
        n_lanes = len(self.lanes)
        if n_lanes == 0:
            raise RuntimeError("no lanes to attach expert handles to")
        e = self.cfg.num_experts
        for i in range(e):
            lane = self.lanes[min(i * n_lanes // e, n_lanes - 1)]
            h = self.cluster.pin_handle(
                f"{self.cfg.name_prefix}/expert{i}",
                self.cfg.expert_nbytes, lane)
            self.handles[i] = h
            self.home.append(lane)

    def _require_attached(self) -> None:
        if not self.attached:
            raise RuntimeError(
                "placement policy not attached; call attach() first")

    # ---- rolling histogram ------------------------------------------------
    def observe(self, histogram: Sequence[int]) -> None:
        """Fold one step's per-expert token histogram into the EMA shares."""
        hist = [max(int(h), 0) for h in histogram]
        if len(hist) != self.cfg.num_experts:
            raise ValueError(
                f"histogram has {len(hist)} entries for "
                f"{self.cfg.num_experts} experts")
        total = sum(hist)
        if total <= 0:
            return
        a = self.cfg.ema_alpha
        self.tokens_ema = (
            total if self.tokens_ema == 0.0
            else (1.0 - a) * self.tokens_ema + a * total
        )
        for i, n in enumerate(hist):
            self.share[i] = (1.0 - a) * self.share[i] + a * (n / total)

    # ---- per-step dispatch plan ------------------------------------------
    def _default_capacity(self, total_tokens: int) -> Optional[int]:
        if not self.cfg.drop_tokens:
            return None
        ideal = total_tokens / self.cfg.num_experts
        cap = int(math.ceil(ideal * self.cfg.capacity_factor / 8.0) * 8)
        return max(cap, 8)

    def _expert_cost(self, tokens: int) -> OpCost:
        c = self.cfg
        return gemm_cost(tokens, 3 * c.d_ff, c.d_model, c.itemsize,
                         op="moe_expert_ffn")

    def _replica_name(self, expert: int, lane: int) -> str:
        return f"{self.handles[expert].name}@dev{lane}"

    def plan(
        self,
        histogram: Sequence[int],
        *,
        capacity: Optional[int] = None,
        record: bool = True,
    ) -> ExpertDispatchPlan:
        """Compile one step's histogram into the placed sub-launch fan-out.

        Each expert's (capacity-clamped) tokens go to its home lane, split
        evenly across its replica set when one exists; empty experts are
        skipped (pipegoose's dispatch-order idiom).  ``record=False`` makes
        the call a pure probe (no counters, no running totals) — the
        decision heuristics use it to score hypothetical placements."""
        self._require_attached()
        hist = [max(int(h), 0) for h in histogram]
        total = sum(hist)
        cap = capacity if capacity is not None else self._default_capacity(total)
        w_bytes = self.cfg.expert_nbytes
        subs: List[PlacedSubLaunch] = []
        dropped_by = [0] * self.cfg.num_experts
        processed = 0
        for i, n in enumerate(hist):
            if n <= 0:
                continue
            targets = [self.home[i]] + self.replica_lanes[i]
            parts, dropped = _split_tokens(n, len(targets), cap)
            dropped_by[i] = dropped
            for lane, tok in zip(targets, parts):
                if tok <= 0:
                    continue
                cost = self._expert_cost(tok)
                rf = (
                    min(1.0, w_bytes / cost.staged_bytes)
                    if cost.staged_bytes > 0 else 0.0
                )
                name = (
                    self.handles[i].name if lane == self.home[i]
                    else self._replica_name(i, lane)
                )
                subs.append(PlacedSubLaunch(
                    expert=i, device_id=lane, tokens=tok, cost=cost,
                    shape_key=name, resident_fraction=rf))
                processed += tok
        tokens_dropped = total - processed
        if record:
            self.tokens_routed += total
            self.tokens_processed += processed
            self.tokens_dropped += tokens_dropped
            for i, dn in enumerate(dropped_by):
                if dn:
                    self.dropped_by_expert[i] += dn
                    _metrics.counter(
                        "moe.tokens_dropped", expert=str(i)).inc(dn)
        return ExpertDispatchPlan(
            sub_launches=tuple(subs),
            tokens_routed=total,
            tokens_processed=processed,
            tokens_dropped=tokens_dropped,
            dropped_by_expert=tuple(dropped_by),
            capacity=cap or 0,
        )

    # ---- placement scoring ------------------------------------------------
    def _ema_counts(self) -> List[int]:
        """The rolling histogram as integer token counts (decision input)."""
        t = self.tokens_ema or float(self.cfg.num_experts)
        return [int(round(s * t)) for s in self.share]

    def _lane_seconds(
        self,
        counts: Sequence[int],
        home: Sequence[int],
        replica_lanes: Dict[int, List[int]],
    ) -> Dict[int, float]:
        """Modeled busy seconds per lane for one step of ``counts`` under a
        hypothetical placement — same per-expert costs and policy scoring
        the real fan-out uses, so decisions and charges agree.

        Scoring deliberately ignores the capacity clamp: decisions balance
        the *offered* load.  Clamping here would hide exactly the signal
        replication exists to act on — a saturated expert looks identical
        before and after adding a copy if both trials are cut to the same
        per-copy cap, even though the replica doubles the tokens actually
        served (fewer drops at dispatch time)."""
        pol = self.cluster.policy
        cap = None
        w_bytes = self.cfg.expert_nbytes
        out = {lane: 0.0 for lane in self.lanes}
        for i, n in enumerate(counts):
            if n <= 0:
                continue
            targets = [home[i]] + replica_lanes.get(i, [])
            parts, _ = _split_tokens(n, len(targets), cap)
            for lane, tok in zip(targets, parts):
                if tok <= 0:
                    continue
                cost = self._expert_cost(tok)
                rf = (
                    min(1.0, w_bytes / cost.staged_bytes)
                    if cost.staged_bytes > 0 else 0.0
                )
                bd = pol.score(cost, self.cluster.platform,
                               resident_fraction=rf)
                out[lane] = out.get(lane, 0.0) + bd.offload_s
        return out

    def _src_drain_s(self, expert: int) -> float:
        """Latest in-flight completion on the source lane still reading the
        expert's handle — the migration's happens-before fence."""
        h = self.handles[expert]
        dev = self.cluster.devices[self.home[expert]]
        drain = 0.0
        for t in dev.inflight:
            if t.shape_key == h.name:
                drain = max(drain, t.complete_s)
        return drain

    # ---- decisions --------------------------------------------------------
    def _consider_migrate(
        self, expert: int, now_s: float
    ) -> Optional[PlacementDecision]:
        src = self.home[expert]
        counts = self._ema_counts()
        base = max(self._lane_seconds(counts, self.home, self.replica_lanes)
                   .values())
        best_dst, best_gain = None, 0.0
        for lane in self.lanes:
            if lane == src:
                continue
            trial = list(self.home)
            trial[expert] = lane
            after = max(self._lane_seconds(counts, trial, self.replica_lanes)
                        .values())
            gain = base - after
            if gain > best_gain + 1e-12:
                best_dst, best_gain = lane, gain
        if best_dst is None:
            return None
        bd = d2d_breakdown(self.cfg.expert_nbytes, self.cluster.platform)
        if best_gain * self.cfg.amortize_steps < bd.offload_s:
            return None  # the move does not amortize — stay put
        h = self.handles[expert]
        drain = self._src_drain_s(expert)
        dst_dev = self.cluster.devices[best_dst]
        # The d2d may not issue while a source-lane launch still reads the
        # handle: fence the destination DMA stream on the drain event.
        dst_dev.advance_clocks(max(now_s, drain))
        self.cluster.migrate_handle(h, best_dst)
        ticket = dst_dev.inflight[-1]
        self.migration_edges.append(MigrationEdge(
            expert=expert, handle_name=h.name, src_device=src,
            dst_device=best_dst, migrate_issue_s=ticket.issue_s,
            src_drain_s=drain))
        self.home[expert] = best_dst
        self.cooldown[expert] = self.cfg.cooldown_steps
        _metrics.counter("placement.migrations", expert=str(expert)).inc()
        tr = _spans.current_tracer()
        if tr is not None:
            tr.instant("expert-migrate", cat="placement",
                       lane=f"dev{best_dst}/dma", t=ticket.issue_s,
                       attrs={"expert": expert, "src": src, "dst": best_dst,
                              "share": round(self.share[expert], 4)},
                       device_id=best_dst)
        return PlacementDecision(
            step=self.step_count, kind="migrate", expert=expert,
            src_device=src, dst_device=best_dst, d2d_s=bd.d2d_s,
            share=self.share[expert], ticket=ticket)

    def _consider_replicate(
        self, expert: int, now_s: float
    ) -> Optional[PlacementDecision]:
        src = self.home[expert]
        taken = {src, *self.replica_lanes[expert]}
        counts = self._ema_counts()
        base = max(self._lane_seconds(counts, self.home, self.replica_lanes)
                   .values())
        best_dst, best_gain = None, 0.0
        for lane in self.lanes:
            if lane in taken:
                continue
            trial = {k: list(v) for k, v in self.replica_lanes.items()}
            trial[expert].append(lane)
            after = max(self._lane_seconds(counts, self.home, trial).values())
            gain = base - after
            if gain > best_gain + 1e-12:
                best_dst, best_gain = lane, gain
        if best_dst is None:
            return None
        bd = d2d_breakdown(self.cfg.expert_nbytes, self.cluster.platform)
        if best_gain * self.cfg.amortize_steps < bd.offload_s:
            return None
        dst_dev = self.cluster.devices[best_dst]
        dst_dev.advance_clocks(now_s)
        self.cluster.replicate_handle(self.handles[expert], best_dst)
        ticket = dst_dev.inflight[-1]
        self.replica_lanes[expert].append(best_dst)
        self.cooldown[expert] = self.cfg.cooldown_steps
        _metrics.counter("placement.replications", expert=str(expert)).inc()
        tr = _spans.current_tracer()
        if tr is not None:
            tr.instant("expert-replicate", cat="placement",
                       lane=f"dev{best_dst}/dma", t=ticket.issue_s,
                       attrs={"expert": expert, "src": src, "dst": best_dst,
                              "share": round(self.share[expert], 4)},
                       device_id=best_dst)
        return PlacementDecision(
            step=self.step_count, kind="replicate", expert=expert,
            src_device=src, dst_device=best_dst, d2d_s=bd.d2d_s,
            share=self.share[expert], ticket=ticket)

    def step(
        self, histogram: Sequence[int], *, now_s: float = 0.0
    ) -> List[PlacementDecision]:
        """Observe one step's histogram, then execute any migrate/replicate
        decisions on the cluster (d2d charged on the destination lane's
        stream clocks at modeled time ``now_s`` or later).

        Migration is scored on a hot *rising edge* and re-scored every
        ``recheck_steps`` while the expert stays hot (the rising edge often
        lands before the EMA has converged, so a once-only check can
        foreclose a profitable move forever); replication triggers only
        every ``replicate_after`` steps of a persistent hot streak.  Both
        must amortize their d2d cost, and that margin — not the trigger
        cadence — is what prevents ping-pong: once an expert sits on its
        best lane, moving it back never clears the amortization bar."""
        self._require_attached()
        self.step_count += 1
        self.observe(histogram)
        if not self.cfg.enabled:
            return []
        cfg = self.cfg
        fair = 1.0 / cfg.num_experts
        rising: List[int] = []
        for i in range(cfg.num_experts):
            if self.cooldown[i] > 0:
                self.cooldown[i] -= 1
            if self.hot[i]:
                if self.share[i] < cfg.hot_exit_x * fair:
                    self.hot[i] = False
                    self.hot_streak[i] = 0
                else:
                    self.hot_streak[i] += 1
            elif self.share[i] >= cfg.hot_enter_x * fair:
                self.hot[i] = True
                self.hot_streak[i] = 1
                rising.append(i)
        decisions: List[PlacementDecision] = []
        candidates = list(rising)
        for i in range(cfg.num_experts):
            if (
                i not in candidates
                and self.hot[i]
                and self.hot_streak[i] % cfg.recheck_steps == 0
            ):
                candidates.append(i)
        for i in candidates:
            if self.cooldown[i] > 0 or self.replica_lanes[i]:
                continue
            d = self._consider_migrate(i, now_s)
            if d is not None:
                decisions.append(d)
        for i in range(cfg.num_experts):
            if (
                self.hot[i]
                and self.hot_streak[i] > 0
                and self.hot_streak[i] % cfg.replicate_after == 0
                and len(self.replica_lanes[i]) < cfg.max_replicas
                and self.cooldown[i] == 0
            ):
                d = self._consider_replicate(i, now_s)
                if d is not None:
                    decisions.append(d)
        self.decisions.extend(decisions)
        return decisions

    # ---- summaries --------------------------------------------------------
    @property
    def decision_log(self) -> Tuple[tuple, ...]:
        """Comparable decision identities (same-seed determinism anchor)."""
        return tuple(d.key for d in self.decisions)

    def counters(self) -> Dict[str, int]:
        mig = sum(1 for d in self.decisions if d.kind == "migrate")
        rep = sum(1 for d in self.decisions if d.kind == "replicate")
        return {
            "migrations": mig,
            "replications": rep,
            "tokens_routed": self.tokens_routed,
            "tokens_processed": self.tokens_processed,
            "tokens_dropped": self.tokens_dropped,
        }


# ---------------------------------------------------------------------------
# Seeded Zipfian router traffic
# ---------------------------------------------------------------------------

def zipf_shares(num_experts: int, s: float) -> List[float]:
    """Normalized Zipf(s) popularity over ``num_experts`` ranks."""
    w = [1.0 / (i + 1) ** s for i in range(num_experts)]
    tot = sum(w)
    return [x / tot for x in w]

def zipf_histogram(
    rng: random.Random, num_experts: int, s: float, tokens: int
) -> List[int]:
    """One step's per-expert token histogram: ``tokens`` multinomial draws
    from the Zipf(s) popularity curve, deterministic given ``rng`` state."""
    cum = list(itertools.accumulate(zipf_shares(num_experts, s)))
    hist = [0] * num_experts
    for _ in range(tokens):
        i = bisect.bisect_left(cum, rng.random())
        hist[min(i, num_experts - 1)] += 1
    return hist


# ---------------------------------------------------------------------------
# The skewed-router workload (bench / tests / race-replay share it)
# ---------------------------------------------------------------------------

@dataclasses.dataclass
class SkewedRunResult:
    """One seeded skewed-router run on a fresh modeled cluster."""

    zipf_s: float
    seed: int
    dynamic: bool
    num_lanes: int
    makespan_s: float
    migrations: int
    replications: int
    tokens_routed: int
    tokens_processed: int
    tokens_dropped: int
    decision_log: Tuple[tuple, ...]
    migration_edges: Tuple[MigrationEdge, ...]
    ticket_streams: Dict[int, List[LaunchTicket]]


def run_skewed_workload(
    *,
    zipf_s: float,
    seed: int = 0,
    dynamic: bool = True,
    steps: int = 96,
    tokens_per_step: int = 1024,
    num_experts: int = 16,
    num_lanes: int = 4,
    platform: str = "h100-sxm",
    config: Optional[PlacementConfig] = None,
) -> SkewedRunResult:
    """Drive ``steps`` grouped-FFN dispatch steps of Zipf(s) router traffic
    through an :class:`ExpertPlacementPolicy` on a fresh ``num_lanes``
    modeled cluster; ``dynamic=False`` freezes the static contiguous-block
    homes (the baseline the headline divides by).  Same seed, same result —
    decisions, makespan and tickets are all modeled-deterministic."""
    cfg = config or PlacementConfig(num_experts=num_experts, enabled=dynamic)
    rng = random.Random(seed)
    with offload_policy(
        mode="device", platform=platform, num_devices=num_lanes,
        scheduler="least-loaded",
    ) as eng:
        pol = ExpertPlacementPolicy(cfg, cluster=eng)
        pol.attach(range(num_lanes))
        for step_i in range(steps):
            hist = zipf_histogram(rng, cfg.num_experts, zipf_s,
                                  tokens_per_step)
            pol.step(hist)
            plan = pol.plan(hist)
            if plan.sub_launches:
                eng.launch_fanout(
                    plan.sub_launches,
                    note=f"skewed-router step {step_i}")
        makespan = max(d.stream_makespan_s for d in eng.devices)
        streams = {d.device_id: list(d.inflight) for d in eng.devices}
        c = pol.counters()
    return SkewedRunResult(
        zipf_s=zipf_s, seed=seed, dynamic=dynamic, num_lanes=num_lanes,
        makespan_s=makespan,
        migrations=c["migrations"], replications=c["replications"],
        tokens_routed=c["tokens_routed"],
        tokens_processed=c["tokens_processed"],
        tokens_dropped=c["tokens_dropped"],
        decision_log=pol.decision_log,
        migration_edges=tuple(pol.migration_edges),
        ticket_streams=streams,
    )


def placement_sweep(
    *,
    zipf_points: Sequence[float] = (0.6, 1.2, 1.8),
    seed: int = 0,
    steps: int = 96,
    tokens_per_step: int = 1024,
    num_experts: int = 16,
    num_lanes: int = 4,
    platform: str = "h100-sxm",
) -> dict:
    """Static-vs-dynamic makespan over a Zipf skew sweep (JSON-safe).

    The headline ``expert_placement_speedup`` is the dynamic/static
    makespan ratio at s=1.2 (the gated point); every point records its
    seed and full token conservation so the bench gate can assert zero
    unaccounted drops."""
    points = []
    for s in zipf_points:
        runs = {}
        for label, dyn in (("static", False), ("dynamic", True)):
            r = run_skewed_workload(
                zipf_s=s, seed=seed, dynamic=dyn, steps=steps,
                tokens_per_step=tokens_per_step, num_experts=num_experts,
                num_lanes=num_lanes, platform=platform)
            runs[label] = r
        stat, dyn = runs["static"], runs["dynamic"]
        speedup = (
            stat.makespan_s / dyn.makespan_s if dyn.makespan_s > 0 else 0.0
        )
        points.append({
            "zipf_s": s,
            "seed": seed,
            "static_makespan_s": stat.makespan_s,
            "dynamic_makespan_s": dyn.makespan_s,
            "speedup": speedup,
            "migrations": dyn.migrations,
            "replications": dyn.replications,
            "static": {
                "tokens_routed": stat.tokens_routed,
                "tokens_processed": stat.tokens_processed,
                "tokens_dropped": stat.tokens_dropped,
                "tokens_unaccounted": (
                    stat.tokens_routed - stat.tokens_processed
                    - stat.tokens_dropped),
            },
            "dynamic": {
                "tokens_routed": dyn.tokens_routed,
                "tokens_processed": dyn.tokens_processed,
                "tokens_dropped": dyn.tokens_dropped,
                "tokens_unaccounted": (
                    dyn.tokens_routed - dyn.tokens_processed
                    - dyn.tokens_dropped),
            },
        })
    headline = next(
        (p["speedup"] for p in points if abs(p["zipf_s"] - 1.2) < 1e-9),
        max((p["speedup"] for p in points), default=0.0),
    )
    return {
        "seed": seed,
        "steps": steps,
        "tokens_per_step": tokens_per_step,
        "num_experts": num_experts,
        "num_lanes": num_lanes,
        "platform": platform,
        "points": points,
        "expert_placement_speedup": headline,
    }
