"""repro_torch.obs — observability over the modeled runtime.

Three pieces, all on modeled time (never wall clock):

* :mod:`repro_torch.obs.spans` — zero-cost-when-disabled span tracer
  (``span_trace()`` / ``current_tracer()`` / ``@traced``).
* :mod:`repro_torch.obs.metrics` — process-local counters/gauges/histograms
  with labeled flat rollups (``obs.counter("dispatch.offloaded").inc()``).
* :mod:`repro_torch.obs.flight` — bounded last-K-per-device flight recorder.

Stdlib-only at module scope: the core runtime imports this package from
its hot seams, so it must stay as cheap to import as it is to leave
disabled.
"""

from repro_torch.obs.metrics import collect, counter, gauge, histogram, snapshot
from repro_torch.obs.spans import (
    SpanTracer,
    current_tracer,
    modeled_now,
    span_trace,
    traced,
)

__all__ = [
    "SpanTracer",
    "collect",
    "counter",
    "current_tracer",
    "gauge",
    "histogram",
    "modeled_now",
    "snapshot",
    "span_trace",
    "traced",
]
