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
  cross-checks the trace against ``HyTMResult`` totals exactly;
* ``record.HostSpans`` — single-device ``run_hytm``'s host spans inside a
  run (``CAT_HOST``: iter, plan, sweep, dispatch with its relax/apply
  split, finish, and a sync span a blocking read), and ``device`` —
  device time from ``torch.profiler`` charged to the span that launched
  it, on the profiler's clock.

Contract: host-side only (events come from history rows already on the
host, from host clock stamps and from scheduler/cache callbacks);
zero-overhead when disabled (every instrumentation site guards on ``obs
is not None``, so the untraced path issues the same launches, copies and
syncs and is bit-identical; the one thing always on is ``core.hytm``'s
``host_syncs`` counter, an integer add a blocking read, which adds no
launch, copy or sync); every event carries both clocks.
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
