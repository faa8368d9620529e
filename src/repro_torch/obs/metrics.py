"""Process-local metrics registry — counters, gauges, histograms.

The span tracer answers *where did modeled time go*; this registry
answers *how often did each path fire*: dispatch offload ratio per op,
staging-leg size distribution, admission reject reasons.  Metrics are
always on (a dict update per event — they never touch modeled clocks or
results), and scoped snapshots come from :func:`collect`::

    with metrics.collect() as reg:
        serve_stream("yi-6b", trace)
    print(reg.rollup())   # {"serve.admitted": 42.0, ...}

Registries stack and writes fan out to every active scope, so a bench
section's ``collect()`` and an inner per-run ``collect()`` both see the
same events.  Rollups are flat ``{"name{label=value}": scalar}`` dicts —
JSON-able as-is for ``StreamReport.point_dict`` and ``BENCH_offload``.

Stdlib-only at module scope (import-light contract).
"""

from __future__ import annotations

import contextlib
from typing import Dict, Iterator, List, Optional, Tuple

__all__ = [
    "Counter",
    "Gauge",
    "Histogram",
    "MetricsRegistry",
    "collect",
    "counter",
    "gauge",
    "histogram",
    "reset",
    "snapshot",
]

LabelKey = Tuple[Tuple[str, str], ...]


def _percentile(ordered: List[float], q: float) -> float:
    """Linear-interpolation percentile over a pre-sorted list."""
    if not ordered:
        return 0.0
    if len(ordered) == 1:
        return ordered[0]
    pos = (q / 100.0) * (len(ordered) - 1)
    lo = int(pos)
    hi = min(lo + 1, len(ordered) - 1)
    frac = pos - lo
    return ordered[lo] * (1.0 - frac) + ordered[hi] * frac


class Counter:
    """Monotone event count."""

    __slots__ = ("value",)

    def __init__(self) -> None:
        self.value = 0.0

    def inc(self, n: float = 1.0) -> None:
        self.value += n


class Gauge:
    """Last-write-wins level (slot target, queue depth...)."""

    __slots__ = ("value",)

    def __init__(self) -> None:
        self.value = 0.0

    def set(self, v: float) -> None:
        self.value = float(v)


class Histogram:
    """Value distribution with count/sum/min/max and p50/p95/p99."""

    __slots__ = ("count", "total", "vmin", "vmax", "_values")

    def __init__(self) -> None:
        self.count = 0.0
        self.total = 0.0
        self.vmin = float("inf")
        self.vmax = float("-inf")
        self._values: List[float] = []

    def observe(self, v: float, n: float = 1.0) -> None:
        """Record ``n`` observations of value ``v`` (``n > 1`` for closed-form
        batches, e.g. `chunks` identical staging legs)."""
        v = float(v)
        self.count += n
        self.total += v * n
        if v < self.vmin:
            self.vmin = v
        if v > self.vmax:
            self.vmax = v
        self._values.append(v)

    def summary(self) -> Dict[str, float]:
        ordered = sorted(self._values)
        return {
            "count": self.count,
            "sum": self.total,
            "min": self.vmin if self._values else 0.0,
            "max": self.vmax if self._values else 0.0,
            "p50": _percentile(ordered, 50.0),
            "p95": _percentile(ordered, 95.0),
            "p99": _percentile(ordered, 99.0),
        }


def _label_key(labels: Dict[str, str]) -> LabelKey:
    return tuple(sorted((k, str(v)) for k, v in labels.items()))


def _render_name(name: str, key: LabelKey) -> str:
    if not key:
        return name
    inner = ",".join(f"{k}={v}" for k, v in key)
    return f"{name}{{{inner}}}"


class MetricsRegistry:
    """One scope's metrics, keyed by (kind, name, sorted labels)."""

    def __init__(self) -> None:
        self._items: Dict[Tuple[str, str, LabelKey], object] = {}

    def _get(self, kind: str, name: str, labels: Dict[str, str],
             factory: type) -> object:
        key = (kind, name, _label_key(labels))
        item = self._items.get(key)
        if item is None:
            item = factory()
            self._items[key] = item
        return item

    def counter(self, name: str, **labels: str) -> Counter:
        return self._get("counter", name, labels, Counter)  # type: ignore[return-value]

    def gauge(self, name: str, **labels: str) -> Gauge:
        return self._get("gauge", name, labels, Gauge)  # type: ignore[return-value]

    def histogram(self, name: str, **labels: str) -> Histogram:
        return self._get("histogram", name, labels, Histogram)  # type: ignore[return-value]

    def rollup(self) -> Dict[str, object]:
        """Flatten to ``{"name{k=v}": value}``; histograms flatten to
        ``name{...}.count/.sum/.p50/...`` scalar entries."""
        out: Dict[str, object] = {}
        for (kind, name, key), item in sorted(self._items.items()):
            rendered = _render_name(name, key)
            if kind == "histogram":
                for stat, v in item.summary().items():  # type: ignore[union-attr]
                    out[f"{rendered}.{stat}"] = v
            else:
                out[rendered] = item.value  # type: ignore[union-attr]
        return out

    def __len__(self) -> int:
        return len(self._items)


# ---------------------------------------------------------------------------
# Registry stack: a root registry always exists; collect() pushes scopes.
# Instrument handles fan writes out to every active scope so nested
# collectors each get a complete view.
# ---------------------------------------------------------------------------

_ROOT = MetricsRegistry()
_STACK: List[MetricsRegistry] = [_ROOT]


class _Fanout:
    """Write-through proxy over the same metric in every active scope."""

    __slots__ = ("_targets",)

    def __init__(self, targets: Tuple[object, ...]) -> None:
        self._targets = targets

    def inc(self, n: float = 1.0) -> None:
        for t in self._targets:
            t.inc(n)  # type: ignore[attr-defined]

    def set(self, v: float) -> None:
        for t in self._targets:
            t.set(v)  # type: ignore[attr-defined]

    def observe(self, v: float, n: float = 1.0) -> None:
        for t in self._targets:
            t.observe(v, n)  # type: ignore[attr-defined]


def counter(name: str, **labels: str) -> _Fanout:
    return _Fanout(tuple(r.counter(name, **labels) for r in _STACK))


def gauge(name: str, **labels: str) -> _Fanout:
    return _Fanout(tuple(r.gauge(name, **labels) for r in _STACK))


def histogram(name: str, **labels: str) -> _Fanout:
    return _Fanout(tuple(r.histogram(name, **labels) for r in _STACK))


@contextlib.contextmanager
def collect(registry: Optional[MetricsRegistry] = None
            ) -> Iterator[MetricsRegistry]:
    """Scope a fresh registry over the body; yields it for rollup."""
    reg = registry if registry is not None else MetricsRegistry()
    _STACK.append(reg)
    try:
        yield reg
    finally:
        _STACK.pop()


def snapshot() -> Dict[str, object]:
    """Rollup of the process-lifetime root registry."""
    return _ROOT.rollup()


def reset() -> None:
    """Clear the root registry (tests)."""
    _ROOT._items.clear()
