"""Chrome trace-event export — load the modeled run in Perfetto.

Maps the format-agnostic :class:`repro_torch.obs.spans.Span` records onto the
Chrome trace-event JSON schema (the ``traceEvents`` array Perfetto and
``chrome://tracing`` both load):

* ``span``          -> ``ph="X"`` complete slices (``ts``/``dur`` in µs)
* ``instant``       -> ``ph="i"`` thread-scoped instants
* ``async_begin/end/instant`` -> ``ph="b"/"e"/"n"`` (request lifecycles,
  matched by ``id``)
* ``flow_start/end``-> ``ph="s"/"f"`` flow arrows (d2d migrations, slot
  refills), matched by ``id``
* counter samples   -> ``ph="C"`` counter tracks

Lanes become threads: ``pid`` is the process group (one per exported
tracer — e.g. per workload), ``tid`` is a stable small integer per lane,
and ``ph="M"`` metadata names both so the UI shows ``dev0/dma``,
``dev0/compute``, ... in device order with the host lane on top.

Modeled seconds convert to microseconds (``ts = t_s * 1e6``) — Perfetto
renders µs natively, and smoke-run spans live in the 1e-6..1e-1 s range.

Raw :class:`LaunchTicket` streams export losslessly through
:func:`ticket_spans` (each ticket -> its DMA window + compute window +
full field dict in attrs), so a trace can be built even for a run that
had no tracer installed.

Stdlib-only at module scope.
"""

from __future__ import annotations

import json
from typing import Any, Dict, Iterable, List, Mapping, Optional, Sequence, Tuple

from repro_torch.obs.spans import (
    KIND_ASYNC_B,
    KIND_ASYNC_E,
    KIND_ASYNC_N,
    KIND_FLOW_F,
    KIND_FLOW_S,
    KIND_INSTANT,
    KIND_SPAN,
    CounterSample,
    Span,
    SpanTracer,
)

__all__ = [
    "chrome_trace",
    "self_time",
    "summarize",
    "ticket_spans",
    "validate_chrome_trace",
    "write_trace",
]

_US = 1e6  # modeled seconds -> trace microseconds

_PH = {
    KIND_SPAN: "X",
    KIND_INSTANT: "i",
    KIND_ASYNC_B: "b",
    KIND_ASYNC_E: "e",
    KIND_ASYNC_N: "n",
    KIND_FLOW_S: "s",
    KIND_FLOW_F: "f",
}


def _lane_sort_key(lane: str) -> Tuple[int, int, int, str]:
    """host first, then dev lanes grouped per device (dma above compute),
    then the named tracks (requests, aimd), then anything else."""
    if lane == "host":
        return (0, 0, 0, lane)
    if lane.startswith("dev"):
        head, _, stream = lane.partition("/")
        try:
            dev = int(head[3:])
        except ValueError:
            return (3, 0, 0, lane)
        order = {"dma": 0, "compute": 1}.get(stream, 2)
        return (1, dev, order, lane)
    return (2, 0, 0, lane)


def _lane_tids(lanes: Iterable[str]) -> Dict[str, int]:
    ordered = sorted(set(lanes), key=_lane_sort_key)
    return {lane: i + 1 for i, lane in enumerate(ordered)}


def _span_event(span: Span, pid: int, tid: int) -> Dict[str, Any]:
    ev: Dict[str, Any] = {
        "name": span.name,
        "cat": span.cat or "obs",
        "ph": _PH[span.kind],
        "ts": span.t0_s * _US,
        "pid": pid,
        "tid": tid,
        "args": dict(span.attrs),
    }
    if span.kind == KIND_SPAN:
        ev["dur"] = max(span.dur_s, 0.0) * _US
    elif span.kind == KIND_INSTANT:
        ev["s"] = "t"
    else:
        ev["id"] = str(span.pair_id)
        if span.kind == KIND_FLOW_F:
            ev["bp"] = "e"  # bind to the enclosing slice's end
    return ev


def _group_events(name: str, spans: Sequence[Span],
                  counters: Sequence[CounterSample],
                  pid: int) -> List[Dict[str, Any]]:
    lanes = [s.lane for s in spans]
    tids = _lane_tids(lanes)
    events: List[Dict[str, Any]] = [{
        "name": "process_name", "ph": "M", "pid": pid, "tid": 0,
        "args": {"name": name},
    }]
    for lane, tid in sorted(tids.items(), key=lambda kv: kv[1]):
        events.append({
            "name": "thread_name", "ph": "M", "pid": pid, "tid": tid,
            "args": {"name": lane},
        })
        events.append({
            "name": "thread_sort_index", "ph": "M", "pid": pid, "tid": tid,
            "args": {"sort_index": tid},
        })
    for span in spans:
        events.append(_span_event(span, pid, tids[span.lane]))
    for c in counters:
        events.append({
            "name": c.name, "cat": "counter", "ph": "C",
            "ts": c.t_s * _US, "pid": pid, "tid": 0,
            "args": {"value": c.value},
        })
    return events


def chrome_trace(tracers: "SpanTracer | Sequence[SpanTracer]", *,
                 meta: Optional[Mapping[str, Any]] = None) -> Dict[str, Any]:
    """Export one tracer (or several — one Perfetto process each) to a
    Chrome trace-event dict; ``meta`` entries merge in at top level."""
    if isinstance(tracers, SpanTracer):
        tracers = [tracers]
    events: List[Dict[str, Any]] = []
    for pid, tr in enumerate(tracers, start=1):
        events.extend(_group_events(tr.name, tr.spans, tr.counters, pid))
    trace: Dict[str, Any] = {
        "traceEvents": events,
        "displayTimeUnit": "ms",
    }
    if meta:
        trace.update(meta)
    return trace


def ticket_spans(streams: Mapping[int, Sequence[Any]]) -> List[Span]:
    """Lossless Span view of raw per-device LaunchTicket streams.

    Each ticket becomes its DMA window (``issue_s -> copy_done_s``, when
    it staged anything) and its compute window (``compute_start_s ->
    complete_s``); the full ticket field set rides in attrs, so nothing
    the ticket recorded is dropped.
    """
    out: List[Span] = []
    sid = 0
    for dev in sorted(streams):
        for t in streams[dev]:
            attrs = {
                "op": t.op, "shape_key": t.shape_key, "kind": t.kind,
                "offload_s": t.offload_s, "issue_s": t.issue_s,
                "copy_ready_s": t.copy_ready_s, "copy_done_s": t.copy_done_s,
                "compute_start_s": t.compute_start_s,
                "complete_s": t.complete_s,
                "resident_fraction": t.resident_fraction,
                "device_id": t.device_id,
            }
            if t.copy_done_s > t.issue_s:
                sid += 1
                out.append(Span(
                    span_id=sid, parent_id=None,
                    name=f"{t.kind}:{t.op}", cat="ticket",
                    lane=f"dev{dev}/dma",
                    t0_s=t.issue_s, t1_s=t.copy_done_s,
                    attrs=attrs, device_id=dev,
                ))
            sid += 1
            out.append(Span(
                span_id=sid, parent_id=None,
                name=f"{t.kind}:{t.op}", cat="ticket",
                lane=f"dev{dev}/compute",
                t0_s=t.compute_start_s, t1_s=t.complete_s,
                attrs=attrs, device_id=dev,
            ))
    return out


# ---------------------------------------------------------------------------
# Validation — tests and ``chip_smoke.py`` assert on this, not on Perfetto.
# ---------------------------------------------------------------------------

def validate_chrome_trace(trace: Mapping[str, Any]) -> List[str]:
    """Structural validity of an exported trace; returns error strings
    (empty = valid)."""
    errors: List[str] = []
    events = trace.get("traceEvents")
    if not isinstance(events, list):
        return ["traceEvents missing or not a list"]
    flows: Dict[str, List[str]] = {}
    asyncs: Dict[str, List[str]] = {}
    for i, ev in enumerate(events):
        ph = ev.get("ph")
        if not ph:
            errors.append(f"event {i}: missing ph")
            continue
        if ph == "M":
            continue
        ts = ev.get("ts")
        if not isinstance(ts, (int, float)):
            errors.append(f"event {i} ({ev.get('name')}): non-numeric ts")
            continue
        if ts < 0:
            errors.append(f"event {i} ({ev.get('name')}): negative ts")
        if ph == "X":
            dur = ev.get("dur")
            if not isinstance(dur, (int, float)) or dur < 0:
                errors.append(
                    f"event {i} ({ev.get('name')}): X event needs dur >= 0")
        elif ph in ("s", "f"):
            fid = ev.get("id")
            if fid is None:
                errors.append(f"event {i} ({ev.get('name')}): flow without id")
            else:
                flows.setdefault(str(fid), []).append(ph)
        elif ph in ("b", "e", "n"):
            aid = ev.get("id")
            if aid is None:
                errors.append(
                    f"event {i} ({ev.get('name')}): async without id")
            elif ph != "n":
                asyncs.setdefault(str(aid), []).append(ph)
    for fid, phases in sorted(flows.items()):
        if phases.count("s") != phases.count("f"):
            errors.append(
                f"flow id {fid}: {phases.count('s')} starts vs "
                f"{phases.count('f')} finishes")
    for aid, phases in sorted(asyncs.items()):
        if phases.count("b") != phases.count("e"):
            errors.append(
                f"async id {aid}: {phases.count('b')} begins vs "
                f"{phases.count('e')} ends")
    return errors


# ---------------------------------------------------------------------------
# Self-time summary — quick triage in tests and in ``chip_smoke.py``.
# ---------------------------------------------------------------------------

def self_time(spans: Sequence[Span]) -> Dict[str, Dict[str, float]]:
    """Per-lane self-time by span name: duration minus direct children
    (parent links), so a wrapping dispatch span doesn't double-count the
    ticket spans it contains."""
    child_time: Dict[int, float] = {}
    for s in spans:
        if s.kind == KIND_SPAN and s.parent_id is not None:
            child_time[s.parent_id] = child_time.get(s.parent_id, 0.0) \
                + s.dur_s
    out: Dict[str, Dict[str, float]] = {}
    for s in spans:
        if s.kind != KIND_SPAN:
            continue
        own = max(s.dur_s - child_time.get(s.span_id, 0.0), 0.0)
        lane = out.setdefault(s.lane, {})
        lane[s.name] = lane.get(s.name, 0.0) + own
    return out


def summarize(spans: Sequence[Span], top: int = 10) -> str:
    """Top-``top`` spans by self-time per lane, in lane display order."""
    per_lane = self_time(spans)
    lines: List[str] = []
    for lane in sorted(per_lane, key=_lane_sort_key):
        lines.append(f"{lane}:")
        ranked = sorted(per_lane[lane].items(),
                        key=lambda kv: (-kv[1], kv[0]))[:top]
        for name, sec in ranked:
            lines.append(f"  {sec * 1e3:10.4f} ms  {name}")
    return "\n".join(lines)


def write_trace(path: str, trace: Mapping[str, Any]) -> str:
    with open(path, "w") as f:
        json.dump(trace, f)
        f.write("\n")
    return path
