"""repro_torch.obs — tracing, metrics and trace export (the reference's
``repro.obs``).

One observability layer across the engine (``core.hytm``), streaming
(``stream.service``) and serving (``serve.scheduler`` /
``serve.warm_cache``) stacks:

* :class:`TraceRecorder` — host-side span/event ring with virtual-clock
  *and* wall-clock timestamps (``trace.py``);
* :class:`MetricsRegistry` — labeled counter/gauge/histogram registry
  unifying the per-engine bytes/time, misprediction, admission,
  cache-tier and lane-occupancy counters (``metrics.py``);
* ``export`` — Chrome trace-event JSON (``chrome://tracing`` /
  Perfetto), JSONL streaming, and a ``summary()``/``reconcile()`` that
  cross-checks the trace against ``HyTMResult`` totals exactly.

Contract: host-side only (events come from history rows already on the
host and from scheduler/cache callbacks); zero-overhead when disabled
(every instrumentation site guards on ``obs is not None``, so the
untraced path issues the same launches and syncs and is bit-identical);
every event carries both clocks.
"""

from repro_torch.obs.export import (
    reconcile,
    summary,
    to_chrome_trace,
    validate_chrome_trace,
    write_chrome_trace,
    write_jsonl,
)
from repro_torch.obs.metrics import Counter, Gauge, Histogram, MetricsRegistry
from repro_torch.obs.trace import NullRecorder, TraceEvent, TraceRecorder

__all__ = [
    "Counter",
    "Gauge",
    "Histogram",
    "MetricsRegistry",
    "NullRecorder",
    "TraceEvent",
    "TraceRecorder",
    "reconcile",
    "summary",
    "to_chrome_trace",
    "validate_chrome_trace",
    "write_chrome_trace",
    "write_jsonl",
]
