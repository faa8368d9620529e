"""repro_torch.obs — observability over the runtime, on two clocks.

Modeled time is what the runtime's cost model and stream simulation
stamp; the span tracer, the Chrome export, the counters and the flight
recorder write only to it (never the wall clock).  The profiler's clock is
the one ``torch.profiler`` stamps the card's activity on; only
:func:`~repro_torch.obs.spans.measured` writes to it, with
``record_function`` ranges opened while the profiler records.

* :mod:`repro_torch.obs.spans` — zero-cost-when-disabled span tracer
  (``span_trace()`` / ``current_tracer()`` / ``@traced``) on modeled time,
  and ``measured(kind, name)``, a range on the profiler's clock.
* :mod:`repro_torch.obs.trace_export` — Chrome trace-event JSON export
  (Perfetto-loadable) of spans + raw ticket streams.
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
    measured,
    modeled_now,
    span_trace,
    traced,
)
from repro_torch.obs.trace_export import (
    chrome_trace,
    self_time,
    summarize,
    ticket_spans,
    validate_chrome_trace,
    write_trace,
)

__all__ = [
    "SpanTracer",
    "chrome_trace",
    "collect",
    "counter",
    "current_tracer",
    "gauge",
    "histogram",
    "measured",
    "modeled_now",
    "self_time",
    "snapshot",
    "span_trace",
    "summarize",
    "ticket_spans",
    "traced",
    "validate_chrome_trace",
    "write_trace",
]
