"""Span tracing on two clocks: modeled time, and the profiler's.

**Modeled time** (:class:`SpanTracer`, :func:`span_trace`, :func:`traced`,
:func:`modeled_now`).  The runtime already stamps every interesting event
onto modeled clocks (`LaunchTicket` event pairs, stream-sim heap times,
device stream clocks).  This half turns those stamps into a queryable span
set: each :class:`Span` carries a name, category, lane (``host``,
``dev3/dma``, ``dev3/compute``, ``requests``, ...), a ``[t0_s, t1_s]``
window in modeled seconds, free-form attrs, and a parent link for nesting.

**The profiler's clock** (:func:`measured`).  A ``<kind>:<name>`` range
(``step:prefill``, ``layer:attn``, ``glue:rope``, ``dispatch:<op>``,
``lower:<kernel|host|plan>``, ``kernel:<module>.<route>``) opened as a
``torch.profiler.record_function`` while ``torch.profiler`` records, so
the profiler stamps it on the clock of the card's own activity.  The
``dispatch:<op>`` range has the modeled span's name and opens beside it.

Design contract (enforced by tests/test_obs.py and
tests/test_torch_obs_measured.py):

* **Zero cost when disabled.**  Instrumentation sites guard on
  ``current_tracer() is None`` and never compute span arguments when no
  tracer is installed, so a tracer-off run is bitwise-identical to a run
  of the uninstrumented code.  :func:`measured` asks the profiler one flag
  and, with the profiler off, returns one shared null context: it formats
  no name and enters no ``record_function``.
* **Observation only.**  A tracer records; it never touches device
  clocks, RNG, or scheduling state, so a tracer-on run produces the same
  numerical results as a tracer-off run.  The same holds for a range.
* **No clock read here.**  Modeled timestamps come from ticket fields, sim
  event times, or :func:`modeled_now`; a measured range is stamped by the
  profiler.  Neither half calls ``time.*`` / ``datetime`` (the
  ``obs-modeled-time-only`` lint rule patrols this file and the
  instrumented call sites).

Usage::

    with span_trace() as tr:
        y = blas.gemm(a, b)
    print(len(tr.spans), tr.lanes())

    with measured("glue", "rope"):     # a range only under the profiler
        ...

Module-scope imports are stdlib-only: ``repro_torch.core.hero`` and the
frontend import this module at module scope, and the frontend's
import-light contract (tools/check_import_time.py) extends to it;
:func:`measured` finds torch in ``sys.modules``.
"""

from __future__ import annotations

import contextlib
import dataclasses
import functools
import sys
from typing import Any, Callable, Dict, Iterator, List, Optional, Tuple

__all__ = [
    "CounterSample",
    "Span",
    "SpanTracer",
    "current_tracer",
    "measured",
    "modeled_now",
    "span_trace",
    "traced",
]

# Span record kinds, mirroring the Chrome trace-event phases they export to
# (trace_export.py owns the mapping; these names stay format-agnostic).
KIND_SPAN = "span"          # complete slice  [t0, t1]
KIND_INSTANT = "instant"    # point event     t0 == t1
KIND_ASYNC_B = "async_begin"  # async (request-lifecycle) open
KIND_ASYNC_E = "async_end"    # async close
KIND_ASYNC_N = "async_instant"  # point event inside an async track
KIND_FLOW_S = "flow_start"  # flow-arrow tail (e.g. d2d migration source)
KIND_FLOW_F = "flow_end"    # flow-arrow head


@dataclasses.dataclass(frozen=True)
class Span:
    """One recorded event on a modeled-time lane."""

    span_id: int
    parent_id: Optional[int]
    name: str
    cat: str
    lane: str
    t0_s: float
    t1_s: float
    kind: str = KIND_SPAN
    attrs: Dict[str, Any] = dataclasses.field(default_factory=dict)
    # Pairing id for async (request) and flow (arrow) events.
    pair_id: Optional[int] = None
    # Device the event belongs to (-1 = host / not device-specific); the
    # flight recorder buckets its bounded window by this.
    device_id: int = -1

    @property
    def dur_s(self) -> float:
        return self.t1_s - self.t0_s


@dataclasses.dataclass(frozen=True)
class CounterSample:
    """One sample on a counter track (in-flight depth, resident bytes...)."""

    name: str
    t_s: float
    value: float
    device_id: int = -1


class _OpenSpan:
    """A begun-but-not-finished span (mutable until :meth:`SpanTracer.end`)."""

    __slots__ = ("span_id", "parent_id", "name", "cat", "lane", "t0_s",
                 "attrs", "device_id")

    def __init__(self, span_id: int, parent_id: Optional[int], name: str,
                 cat: str, lane: str, t0_s: float,
                 attrs: Optional[Dict[str, Any]], device_id: int) -> None:
        self.span_id = span_id
        self.parent_id = parent_id
        self.name = name
        self.cat = cat
        self.lane = lane
        self.t0_s = t0_s
        self.attrs = dict(attrs) if attrs else {}
        self.device_id = device_id


class SpanTracer:
    """Accumulates spans and counter samples for one traced region.

    Nesting is tracked with an explicit open-span stack: :meth:`begin`
    pushes, :meth:`end` pops, and every event emitted in between gets the
    innermost open span as its parent.  One-shot :meth:`emit` calls (e.g.
    per-ticket stream spans, whose window is known up front) parent the
    same way without touching the stack.
    """

    def __init__(self, name: str = "trace") -> None:
        self.name = name
        self.spans: List[Span] = []
        self.counters: List[CounterSample] = []
        self._stack: List[_OpenSpan] = []
        self._ids = 0

    # ---- id / parent plumbing -------------------------------------------
    def _next_id(self) -> int:
        self._ids += 1
        return self._ids

    def _parent_id(self) -> Optional[int]:
        return self._stack[-1].span_id if self._stack else None

    def _add(self, span: Span) -> Span:
        self.spans.append(span)
        # The flight recorder keeps a bounded tail of spans per device for
        # post-mortem dumps; lazy import keeps this module self-contained.
        from repro_torch.obs import flight
        flight.note_span(span)
        return span

    # ---- one-shot events ------------------------------------------------
    def emit(self, name: str, cat: str, lane: str, t0: float, t1: float, *,
             attrs: Optional[Dict[str, Any]] = None,
             kind: str = KIND_SPAN,
             pair_id: Optional[int] = None,
             parent_id: Optional[int] = None,
             device_id: int = -1) -> Span:
        """Record a complete span whose window is already known."""
        return self._add(Span(
            span_id=self._next_id(),
            parent_id=parent_id if parent_id is not None else self._parent_id(),
            name=name, cat=cat, lane=lane, t0_s=t0, t1_s=t1, kind=kind,
            attrs=dict(attrs) if attrs else {}, pair_id=pair_id,
            device_id=device_id,
        ))

    def instant(self, name: str, cat: str, lane: str, t: float, *,
                attrs: Optional[Dict[str, Any]] = None,
                device_id: int = -1) -> Span:
        return self.emit(name, cat, lane, t, t, attrs=attrs,
                         kind=KIND_INSTANT, device_id=device_id)

    def counter(self, name: str, t: float, value: float, *,
                device_id: int = -1) -> None:
        self.counters.append(CounterSample(name, t, value, device_id))

    # ---- nested spans ---------------------------------------------------
    def begin(self, name: str, cat: str, lane: str, t0: float, *,
              attrs: Optional[Dict[str, Any]] = None,
              device_id: int = -1) -> _OpenSpan:
        open_span = _OpenSpan(self._next_id(), self._parent_id(), name, cat,
                              lane, t0, attrs, device_id)
        self._stack.append(open_span)
        return open_span

    def end(self, open_span: _OpenSpan, t1: float, *,
            attrs: Optional[Dict[str, Any]] = None) -> Span:
        # Pop through abandoned inner opens (an exception unwound past
        # them): close them at the same instant so lanes stay well-nested.
        while self._stack and self._stack[-1] is not open_span:
            self.end(self._stack[-1], t1)
        if self._stack and self._stack[-1] is open_span:
            self._stack.pop()
        merged = open_span.attrs
        if attrs:
            merged = dict(merged)
            merged.update(attrs)
        return self._add(Span(
            span_id=open_span.span_id, parent_id=open_span.parent_id,
            name=open_span.name, cat=open_span.cat, lane=open_span.lane,
            t0_s=open_span.t0_s, t1_s=max(open_span.t0_s, t1),
            attrs=merged, device_id=open_span.device_id,
        ))

    @contextlib.contextmanager
    def span(self, name: str, cat: str = "host", lane: str = "host", *,
             t0: Optional[float] = None,
             clock: Optional[Callable[[], float]] = None,
             attrs: Optional[Dict[str, Any]] = None,
             device_id: int = -1) -> Iterator[_OpenSpan]:
        """Context-manager span; end time read from ``clock`` (default
        :func:`modeled_now`) when the body exits."""
        tick = clock if clock is not None else modeled_now
        open_span = self.begin(name, cat, lane,
                               t0 if t0 is not None else tick(),
                               attrs=attrs, device_id=device_id)
        try:
            yield open_span
        finally:
            self.end(open_span, tick())

    # ---- async (request-lifecycle) tracks -------------------------------
    def async_begin(self, name: str, cat: str, lane: str, t: float,
                    pair_id: int, *,
                    attrs: Optional[Dict[str, Any]] = None) -> Span:
        return self.emit(name, cat, lane, t, t, attrs=attrs,
                         kind=KIND_ASYNC_B, pair_id=pair_id)

    def async_end(self, name: str, cat: str, lane: str, t: float,
                  pair_id: int, *,
                  attrs: Optional[Dict[str, Any]] = None) -> Span:
        return self.emit(name, cat, lane, t, t, attrs=attrs,
                         kind=KIND_ASYNC_E, pair_id=pair_id)

    def async_instant(self, name: str, cat: str, lane: str, t: float,
                      pair_id: int, *,
                      attrs: Optional[Dict[str, Any]] = None) -> Span:
        return self.emit(name, cat, lane, t, t, attrs=attrs,
                         kind=KIND_ASYNC_N, pair_id=pair_id)

    # ---- flow arrows ----------------------------------------------------
    def flow(self, name: str, cat: str, src_lane: str, src_t: float,
             dst_lane: str, dst_t: float, *,
             attrs: Optional[Dict[str, Any]] = None) -> int:
        """Record a flow arrow (d2d migration, slot refill) as a paired
        start/end event; returns the fresh pair id."""
        fid = self._next_id()
        self.emit(name, cat, src_lane, src_t, src_t, attrs=attrs,
                  kind=KIND_FLOW_S, pair_id=fid)
        self.emit(name, cat, dst_lane, dst_t, dst_t, attrs=attrs,
                  kind=KIND_FLOW_F, pair_id=fid)
        return fid

    # ---- queries --------------------------------------------------------
    def lanes(self) -> Tuple[str, ...]:
        seen: Dict[str, None] = {}
        for s in self.spans:
            seen.setdefault(s.lane)
        return tuple(seen)


# ---------------------------------------------------------------------------
# Ambient tracer stack (mirrors accounting's offload_trace scoping).
# ---------------------------------------------------------------------------

_TRACER_STACK: List[SpanTracer] = []


def current_tracer() -> Optional[SpanTracer]:
    """The innermost active tracer, or None — instrumentation sites guard
    on this so disabled tracing costs one list lookup."""
    return _TRACER_STACK[-1] if _TRACER_STACK else None


@contextlib.contextmanager
def span_trace(name: str = "trace",
               tracer: Optional[SpanTracer] = None) -> Iterator[SpanTracer]:
    tr = tracer if tracer is not None else SpanTracer(name)
    _TRACER_STACK.append(tr)
    try:
        yield tr
    finally:
        _TRACER_STACK.pop()


def modeled_now() -> float:
    """Current modeled time: the furthest stream clock across the ambient
    engine's devices (0.0 on a fresh engine).  Host-lane spans (dispatch,
    graph scheduling) use this; stream-lane spans use ticket fields."""
    from repro_torch.core.hero import engine
    eng = engine()
    best = 0.0
    for d in eng.devices:
        t = max(d.dma_free_s, d.compute_free_s)
        if t > best:
            best = t
    return best


def traced(name: Optional[str] = None, cat: str = "host",
           lane: str = "host") -> Callable:
    """Decorator twin of :meth:`SpanTracer.span`.  When no tracer is
    active the wrapper is a single ``if`` — it never reads a clock."""
    def deco(fn: Callable) -> Callable:
        label = name if name is not None else fn.__name__

        @functools.wraps(fn)
        def wrapper(*args: Any, **kwargs: Any) -> Any:
            tr = current_tracer()
            if tr is None:
                return fn(*args, **kwargs)
            with tr.span(label, cat=cat, lane=lane):
                return fn(*args, **kwargs)
        return wrapper
    return deco


# ---------------------------------------------------------------------------
# Ranges on the profiler's clock
# ---------------------------------------------------------------------------

_NULL = contextlib.nullcontext()


def measured(kind: str, name: str, *parts: str):
    """A ``record_function`` range named ``<kind>:<name>``, with ``parts``
    joined on by dots (``measured("kernel", "gemm", route)`` is
    ``kernel:gemm.<route>``), while ``torch.profiler`` records on this
    thread; else one shared null context, with no name formatted."""
    torch = sys.modules.get("torch")
    if torch is None or not torch._C._autograd._profiler_enabled():
        return _NULL
    return torch.profiler.record_function(
        f"{kind}:{'.'.join((name, *parts))}")
