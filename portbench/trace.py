"""Reduce a ``torch.profiler`` trace to what the metrics read.

The harness marks its own phases with ``record_function`` ranges
(:data:`PHASES`).  From the profiler's events this module keeps the
device's operations (kernels, copies, sets) as ``(name, start_us, end_us)``
and the host's ranges as ``(name, start_us, end_us)``, on the profiler's
one clock.  The traced window runs from the start of the first phase range
to the end of the last.  It gives the device's busy time (the union of its
operations' intervals inside the window), the operations that took the most
time, and the idle gaps between device operations, each named by what the
host was doing at the gap's middle: the phase and the innermost host range
open there.
"""

from __future__ import annotations

import dataclasses
import heapq
from typing import Dict, Iterable, List, Optional, Tuple

__all__ = ["PHASES", "Trace", "from_profiler", "reduce_events"]

PHASES = ("make inputs", "prefill step", "synchronise")

Span = Tuple[str, float, float]


@dataclasses.dataclass
class Trace:
    device_ops: List[Span]        # the device's operations in the window
    host_ranges: List[Span]       # every host range (phases and ops)
    window: Tuple[float, float]   # µs on the profiler's clock

    @property
    def window_s(self) -> float:
        return (self.window[1] - self.window[0]) * 1e-6

    def busy_intervals(self) -> List[Tuple[float, float]]:
        """The union of the device operations' intervals, clipped to the
        window, sorted and disjoint."""
        lo, hi = self.window
        merged: List[List[float]] = []
        for _, s, e in sorted(self.device_ops, key=lambda op: op[1]):
            s, e = max(s, lo), min(e, hi)
            if e <= s:
                continue
            if merged and s <= merged[-1][1]:
                merged[-1][1] = max(merged[-1][1], e)
            else:
                merged.append([s, e])
        return [(s, e) for s, e in merged]

    @property
    def busy_s(self) -> float:
        return sum(e - s for s, e in self.busy_intervals()) * 1e-6

    def op_seconds(self, names: Optional[Iterable[str]] = None,
                   exclude: bool = False) -> float:
        """Device seconds of the operations whose names contain one of
        ``names`` (all operations when ``names`` is None; with
        ``exclude``, those that contain none of them)."""
        keys = tuple(names or ())
        total = 0.0
        for name, s, e in self.device_ops:
            hit = names is None or any(k in name for k in keys)
            if hit != exclude:
                total += e - s
        return total * 1e-6

    def top_ops(self, n: int = 10) -> List[List]:
        by: Dict[str, float] = {}
        for name, s, e in self.device_ops:
            by[name[:120]] = by.get(name[:120], 0.0) + (e - s) * 1e-6
        return [[k, v] for k, v in sorted(by.items(), key=lambda kv: -kv[1])[:n]]

    def _hosts_at(self, times: List[float]) -> List[str]:
        """For each time (ascending), the phase open there and the
        innermost host range open there (the one that opened last), in one
        sweep over the host ranges sorted by start."""
        ranges = sorted(self.host_ranges, key=lambda r: r[1])
        # Heaps of (-start, end, name): the top is the range opened last.
        phases: List[Tuple[float, float, str]] = []
        inner: List[Tuple[float, float, str]] = []
        out, i = [], 0
        for t in times:
            while i < len(ranges) and ranges[i][1] <= t:
                name, start, end = ranges[i]
                heapq.heappush(inner, (-start, end, name))
                if name in PHASES:
                    heapq.heappush(phases, (-start, end, name))
                i += 1
            for heap in (phases, inner):
                # Drop ranges that closed; a closed range under an open
                # one waits until it reaches the top.
                while heap and heap[0][1] <= t:
                    heapq.heappop(heap)
            phase = phases[0][2] if phases else "outside the phases"
            top = inner[0] if inner else None
            if top is None or top[2] == phase:
                out.append(phase)
            else:
                out.append(f"{phase} / {top[2][:80]}")
        return out

    def idle_gaps(self, n: int = 10) -> List[List]:
        """Idle device time inside the window, summed by what the host was
        doing at each gap's middle; the ``n`` largest."""
        lo, hi = self.window
        edges = [lo]
        for s, e in self.busy_intervals():
            edges += [s, e]
        edges.append(hi)
        gaps = [(s, e) for s, e in zip(edges[::2], edges[1::2]) if e > s]
        by: Dict[str, float] = {}
        for (s, e), key in zip(gaps, self._hosts_at(
                [0.5 * (s + e) for s, e in gaps])):
            by[key] = by.get(key, 0.0) + (e - s) * 1e-6
        return [[k, v] for k, v in sorted(by.items(), key=lambda kv: -kv[1])[:n]]


def reduce_events(device: List[Span], host: List[Span]) -> Trace:
    """A :class:`Trace` of the device operations and host ranges; the
    window spans the phase ranges."""
    phases = [h for h in host if h[0] in PHASES]
    if not phases:
        raise ValueError("the trace holds none of the harness's phases")
    window = (min(h[1] for h in phases), max(h[2] for h in phases))
    inside = [d for d in device if d[2] > window[0] and d[1] < window[1]]
    return Trace(device_ops=inside, host_ranges=host, window=window)


def from_profiler(prof) -> Trace:
    """The :class:`Trace` of a finished ``torch.profiler.profile``, read
    from the profiler's raw events (``prof.events()`` builds a tree of
    them first, twenty times slower)."""
    from torch.autograd import DeviceType

    results = prof.profiler.kineto_results
    t0 = results.trace_start_ns()
    device, host = [], []
    for ev in results.events():
        start = (ev.start_ns() - t0) * 1e-3
        span = (ev.name(), start, start + ev.duration_ns() * 1e-3)
        if ev.device_type() == DeviceType.CUDA:
            # A range marked on the host is mirrored on the device's
            # timeline; it is no operation of the device.
            if not ev.is_user_annotation():
                device.append(span)
        elif ev.device_type() == DeviceType.CPU:
            host.append(span)
    return reduce_events(device, host)
