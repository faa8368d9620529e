"""Happens-before checker over ``LaunchTicket`` event streams — the twin
of the reference's ``analysis/races.py``, rule for rule.

Every modeled device keeps two event streams (DMA engine, compute cluster)
whose frontier clocks ``VirtualDevice.issue`` advances per launch;
every ticket is stamped with where its events landed
(``issue_s -> copy_ready_s -> copy_done_s`` on the DMA stream,
``compute_start_s -> complete_s`` on the compute stream).  The whole
overlap story — pipelined staging, cross-wave prefetch, ``d2d_copy``
migration shingled under compute — is only *correct* if a happens-before
order holds between those events.  HERO-class shared-memory platforms get
exactly this wrong in subtle ways (arxiv 1712.06497): a compute kernel
reading a buffer whose DMA hasn't drained reads garbage without crashing.

This pass re-derives the order from the tickets alone (it never consults
the scheduler that produced them) and reports named violations:

* ``race/event-order`` — a ticket's own events out of order;
* ``race/compute-before-copy-ready`` — compute starts before the first
  staged chunk has landed;
* ``race/complete-before-copy-done`` — a launch retires before its staging
  stream drained (the readback would copy a half-written buffer);
* ``race/dma-clock-monotone`` / ``race/compute-clock-monotone`` — a
  device's stream clocks ran backwards between consecutive tickets;
* ``race/read-before-copy-done`` — a launch's compute starts before the
  copy-done of a staging ticket (prefetch / d2d / restage) issued earlier
  on its device: the data it could consume is still in flight;
* ``race/resident-charged-dma`` — a fully-resident launch
  (``resident_fraction >= 1``) charged DMA time it must not pay;
* ``race/device-mismatch`` — a ticket filed on a device other than the one
  stamped on it;
* ``race/slot-refill-before-complete`` — continuous-batching slot refill:
  a freed decode slot's next launch was issued before the finishing
  request's ``complete`` event (:func:`check_slot_refills`, over the
  streaming engine's :class:`~repro_torch.launch.streaming.SlotRefill` records);
* ``race/expert-migrate-before-drain`` — dynamic expert placement: an
  expert-weight migration's d2d ticket issued while a source-lane launch
  still reading the handle was in flight (:func:`check_expert_migrations`,
  over the placement policy's
  :class:`~repro_torch.core.placement.MigrationEdge` records).

Violations carry the offending ticket chain so the report reads as a
timeline, not a boolean.

Stdlib only at module scope; the engine loads lazily inside
:func:`ticket_streams`.
"""

from __future__ import annotations

from typing import Dict, List, Optional, Sequence

from repro_torch.analysis.base import AnalysisError, Violation

__all__ = [
    "StreamRaceError",
    "assert_race_free",
    "check_cluster",
    "check_expert_migrations",
    "check_slot_refills",
    "check_ticket_streams",
    "ticket_streams",
]

# Stream clocks are exact float copies of one another in a correct model;
# the tolerance only forgives accumulated fp error, never a real reorder.
_TOL = 1e-9

_STAGING_KINDS = ("prefetch", "d2d", "restage")


class StreamRaceError(AnalysisError):
    def __init__(self, violations: Sequence[Violation]) -> None:
        super().__init__(violations, "LaunchTicket streams violate happens-before")


def _tag(device_id: int, idx: int, t) -> str:
    return f"dev{device_id}[{idx}]({t.kind}:{t.op}/{t.shape_key})"


def _chain(device_id: int, *pairs) -> str:
    return " -> ".join(_tag(device_id, i, t) for i, t in pairs)


def ticket_streams(cluster=None) -> Dict[int, List]:
    """Per-device ticket streams, in issue order, from ``cluster`` (the
    engine singleton when omitted)."""
    if cluster is None:
        from repro_torch.core.hero import engine

        cluster = engine()
    return {d.device_id: list(d.inflight) for d in cluster.devices}


def _check_one(device_id: int, idx: int, t) -> List[Violation]:
    out: List[Violation] = []
    where = _tag(device_id, idx, t)
    if t.compute_start_s < t.copy_ready_s - _TOL:
        out.append(Violation(
            "race/compute-before-copy-ready",
            f"compute starts at {t.compute_start_s:.6g}s but the first "
            f"staged chunk lands at {t.copy_ready_s:.6g}s — the kernel "
            "would read an empty operand buffer",
            where,
        ))
    if t.complete_s < t.copy_done_s - _TOL:
        out.append(Violation(
            "race/complete-before-copy-done",
            f"launch retires at {t.complete_s:.6g}s with its staging "
            f"stream draining until {t.copy_done_s:.6g}s — readback would "
            "ship a half-written buffer",
            where,
        ))
    ordered = (
        t.issue_s - _TOL <= t.copy_ready_s <= t.copy_done_s + _TOL
        and t.compute_start_s - _TOL <= t.complete_s
    )
    if not ordered:
        out.append(Violation(
            "race/event-order",
            "ticket events out of order: issue="
            f"{t.issue_s:.6g} copy_ready={t.copy_ready_s:.6g} "
            f"copy_done={t.copy_done_s:.6g} "
            f"compute_start={t.compute_start_s:.6g} "
            f"complete={t.complete_s:.6g}",
            where,
        ))
    if t.kind == "launch" and t.resident_fraction >= 1.0 and (
        t.copy_done_s > t.issue_s + _TOL
    ):
        out.append(Violation(
            "race/resident-charged-dma",
            "fully-resident launch (resident_fraction="
            f"{t.resident_fraction:.2f}) charged "
            f"{t.copy_done_s - t.issue_s:.6g}s of DMA — residency credit "
            "must make the copy region free",
            where,
        ))
    if t.device_id != device_id:
        out.append(Violation(
            "race/device-mismatch",
            f"ticket stamped device_id={t.device_id} is filed on device "
            f"{device_id}'s queue — its events were charged to the wrong "
            "stream clocks",
            where,
        ))
    return out


def check_ticket_streams(streams: Dict[int, List]) -> List[Violation]:
    """Run every happens-before rule over per-device ticket streams
    (``{device_id: [LaunchTicket, ...]}`` in issue order)."""
    out: List[Violation] = []
    for device_id in sorted(streams):
        tickets = list(streams[device_id])
        for idx, t in enumerate(tickets):
            out.extend(_check_one(device_id, idx, t))

        # Clock monotonicity between consecutive tickets.  Requeued orphans
        # occupy only the compute stream (their staging was charged where
        # they first ran), so they are exempt from the DMA-stream rule.
        prev_dma = None        # (idx, ticket) of last DMA-stream user
        prev = None            # (idx, ticket) of last ticket
        for idx, t in enumerate(tickets):
            if prev_dma is not None and t.kind != "requeue":
                pi, p = prev_dma
                if t.issue_s < p.copy_done_s - _TOL:
                    out.append(Violation(
                        "race/dma-clock-monotone",
                        f"DMA clock ran backwards: issue at {t.issue_s:.6g}s "
                        f"while the previous staging drains until "
                        f"{p.copy_done_s:.6g}s",
                        _chain(device_id, (pi, p), (idx, t)),
                    ))
            if prev is not None:
                pi, p = prev
                if t.compute_start_s < p.complete_s - _TOL:
                    out.append(Violation(
                        "race/compute-clock-monotone",
                        "compute clock ran backwards: start at "
                        f"{t.compute_start_s:.6g}s while the previous "
                        f"launch retires at {p.complete_s:.6g}s",
                        _chain(device_id, (pi, p), (idx, t)),
                    ))
            if t.kind != "requeue":
                prev_dma = (idx, t)
            prev = (idx, t)

        # Happens-before from staging to compute: data staged by a
        # prefetch/d2d/restage ticket must be fully landed before any later
        # launch on the device starts computing — that launch is exactly the
        # consumer the staging was issued for (cross-wave prefetch lands
        # under wave k's compute, is read by wave k+1).
        for si, s in enumerate(tickets):
            if s.kind not in _STAGING_KINDS:
                continue
            for ti in range(si + 1, len(tickets)):
                t = tickets[ti]
                if t.kind != "launch":
                    continue
                if t.compute_start_s < s.copy_done_s - _TOL:
                    out.append(Violation(
                        "race/read-before-copy-done",
                        f"launch compute starts at {t.compute_start_s:.6g}s "
                        f"but the {s.kind} staging it may consume "
                        f"({s.shape_key!r}) only lands at "
                        f"{s.copy_done_s:.6g}s",
                        _chain(device_id, (si, s), (ti, t)),
                    ))
                break  # monotone streams make the first launch the witness
    return out


def check_slot_refills(refills: Sequence) -> List[Violation]:
    """Happens-before over continuous-batching slot refills.

    The streaming engine frees a decode slot when its request's final step
    retires (the ``complete`` event) and records the lane's next launch as
    a refill edge.  The invariant: that next launch's *issue* event is
    at-or-after the freeing completion — issuing into a slot whose previous
    occupant is still computing would interleave two requests' KV state on
    one lane.  Duck-typed over anything carrying ``device_id``,
    ``freed_rids``, ``freed_complete_s``, ``next_rids``, ``refill_issue_s``
    (the engine's ``SlotRefill`` records), so this pass stays import-light.
    """
    out: List[Violation] = []
    for i, r in enumerate(refills):
        if r.refill_issue_s < r.freed_complete_s - _TOL:
            out.append(Violation(
                "race/slot-refill-before-complete",
                f"slot refill issued at {r.refill_issue_s:.6g}s while the "
                f"freed request(s) {list(r.freed_rids)} only complete at "
                f"{r.freed_complete_s:.6g}s — the next launch "
                f"({list(r.next_rids)}) would share the lane with a live "
                "occupant",
                f"dev{r.device_id}[refill {i}]",
            ))
    return out


def check_expert_migrations(edges: Sequence) -> List[Violation]:
    """Happens-before over dynamic expert-weight migrations.

    When the placement policy moves a hot expert's weights between lanes,
    the d2d copy reads the source-lane buffer that in-flight grouped-FFN
    launches may still be consuming.  The invariant: the migration ticket's
    *issue* event is at-or-after the latest ``complete`` of source-lane
    launches keyed on the handle (the drain fence) — issuing earlier would
    copy weights out from under a running kernel.  Duck-typed over anything
    carrying ``expert``, ``handle_name``, ``src_device``, ``dst_device``,
    ``migrate_issue_s``, ``src_drain_s`` (the policy's ``MigrationEdge``
    records), so this pass stays import-light.
    """
    out: List[Violation] = []
    for i, e in enumerate(edges):
        if e.migrate_issue_s < e.src_drain_s - _TOL:
            out.append(Violation(
                "race/expert-migrate-before-drain",
                f"expert {e.expert} weight migration "
                f"({e.handle_name!r}, dev{e.src_device} -> "
                f"dev{e.dst_device}) issued its d2d at "
                f"{e.migrate_issue_s:.6g}s while a source-lane launch still "
                f"reading the handle completes at {e.src_drain_s:.6g}s — "
                "the copy would lift weights out from under a running "
                "kernel",
                f"dev{e.src_device}[migration {i}]",
            ))
    return out


def check_cluster(cluster=None) -> List[Violation]:
    """Check the live engine (or an explicit cluster) for stream races."""
    return check_ticket_streams(ticket_streams(cluster))


def assert_race_free(cluster_or_streams=None) -> None:
    if isinstance(cluster_or_streams, dict):
        violations = check_ticket_streams(cluster_or_streams)
    else:
        violations = check_cluster(cluster_or_streams)
    if violations:
        raise StreamRaceError(violations)
