"""Bounded flight recorder — the last K tickets/spans per device.

Always on and O(K) per device: :func:`note_ticket` is called from every
``VirtualDevice.issue``/``requeue`` and :func:`note_span` from every
tracer record, each a single deque append.  When an analysis rule fires
(``StreamRaceError``, graph-validation errors), :func:`capture` freezes
the window next to the violation so a red ``make lint --smoke-races``
run ships its own repro trace — no re-run needed.

Stdlib-only at module scope; tickets/spans are duck-typed dataclasses so
this module imports nothing from ``repro_torch.core``.
"""

from __future__ import annotations

import collections
import dataclasses
import json
from typing import Any, Deque, Dict, List, Optional, Sequence

__all__ = [
    "DEFAULT_CAPACITY",
    "FlightRecorder",
    "capture",
    "clear",
    "configure",
    "dump",
    "note_span",
    "note_ticket",
    "recorder",
]

DEFAULT_CAPACITY = 64


def _as_dict(obj: Any) -> Dict[str, Any]:
    if dataclasses.is_dataclass(obj) and not isinstance(obj, type):
        return dataclasses.asdict(obj)
    return {"repr": repr(obj)}


class FlightRecorder:
    """Per-device ring buffers of the most recent tickets and spans."""

    def __init__(self, capacity: int = DEFAULT_CAPACITY) -> None:
        if capacity < 1:
            raise ValueError(f"flight capacity must be >= 1, got {capacity}")
        self.capacity = capacity
        self._tickets: Dict[int, Deque[Any]] = {}
        self._spans: Dict[int, Deque[Any]] = {}

    def _ring(self, store: Dict[int, Deque[Any]], device_id: int
              ) -> Deque[Any]:
        ring = store.get(device_id)
        if ring is None:
            ring = collections.deque(maxlen=self.capacity)
            store[device_id] = ring
        return ring

    def note_ticket(self, ticket: Any) -> None:
        self._ring(self._tickets, getattr(ticket, "device_id", -1)).append(
            ticket)

    def note_span(self, span: Any) -> None:
        self._ring(self._spans, getattr(span, "device_id", -1)).append(span)

    def capture(self, violations: Optional[Sequence[Any]] = None
                ) -> Dict[str, Any]:
        """Freeze the current window into a JSON-able dict."""
        return {
            "capacity": self.capacity,
            "violations": [
                getattr(v, "render", lambda: repr(v))()
                for v in (violations or [])
            ],
            "tickets": {
                str(dev): [_as_dict(t) for t in ring]
                for dev, ring in sorted(self._tickets.items())
            },
            "spans": {
                str(dev): [_as_dict(s) for s in ring]
                for dev, ring in sorted(self._spans.items())
            },
        }

    def clear(self) -> None:
        self._tickets.clear()
        self._spans.clear()


# ---------------------------------------------------------------------------
# Module singleton: one recorder per process, like accounting's engine.
# ---------------------------------------------------------------------------

_RECORDER = FlightRecorder()


def recorder() -> FlightRecorder:
    return _RECORDER


def note_ticket(ticket: Any) -> None:
    _RECORDER.note_ticket(ticket)


def note_span(span: Any) -> None:
    _RECORDER.note_span(span)


def capture(violations: Optional[Sequence[Any]] = None) -> Dict[str, Any]:
    return _RECORDER.capture(violations)


def configure(capacity: int) -> None:
    """Resize the window (drops the current contents — the new rings
    start empty, so 'last K' is exact from here on)."""
    global _RECORDER
    _RECORDER = FlightRecorder(capacity)


def clear() -> None:
    _RECORDER.clear()


def dump(path: str, violations: Optional[Sequence[Any]] = None) -> str:
    """Write the frozen window (plus the violations) to ``path``."""
    with open(path, "w") as f:
        json.dump(capture(violations), f, indent=1, default=repr)
        f.write("\n")
    return path
