"""Labeled counter/gauge/histogram registry for ``repro_torch.obs``.

Unifies the counters today scattered across ``HyTMResult`` fields,
``ServiceStats.extra``, ``SchedulerStats``, ``QueueStats`` and
``CacheStats`` into one queryable namespace: per-engine bytes/time, ICI
exchange picks, mispredictions, admission defer/reject, cache tier
hit/spill/promote, lane occupancy.

Deliberately tiny and dependency-free: metrics are plain host-side
Python accumulators keyed by ``(name, sorted label items)``.  They are
*derived* views — the runtime's own accounting (``HyTMResult``,
``*Stats``) stays authoritative, and ``repro_torch.obs.export.reconcile``
checks the two agree exactly.
"""

from __future__ import annotations

import bisect
from typing import Any, Iterator

LabelKey = tuple[tuple[str, str], ...]


def _label_key(labels: dict[str, Any]) -> LabelKey:
    return tuple(sorted((k, str(v)) for k, v in labels.items()))


class Counter:
    """Monotonically increasing sum per label set."""

    def __init__(self, name: str, help: str = ""):
        self.name, self.help = name, help
        self._values: dict[LabelKey, float] = {}

    def inc(self, value: float = 1.0, **labels: Any) -> None:
        key = _label_key(labels)
        self._values[key] = self._values.get(key, 0.0) + float(value)

    def value(self, **labels: Any) -> float:
        return self._values.get(_label_key(labels), 0.0)

    def total(self) -> float:
        return sum(self._values.values())

    def items(self) -> Iterator[tuple[LabelKey, float]]:
        return iter(sorted(self._values.items()))


class Gauge:
    """Last-written value per label set (plus the observed max)."""

    def __init__(self, name: str, help: str = ""):
        self.name, self.help = name, help
        self._values: dict[LabelKey, float] = {}
        self._max: dict[LabelKey, float] = {}

    def set(self, value: float, **labels: Any) -> None:
        key = _label_key(labels)
        v = float(value)
        self._values[key] = v
        self._max[key] = max(self._max.get(key, v), v)

    def value(self, **labels: Any) -> float:
        return self._values.get(_label_key(labels), 0.0)

    def max(self, **labels: Any) -> float:
        return self._max.get(_label_key(labels), 0.0)

    def items(self) -> Iterator[tuple[LabelKey, float]]:
        return iter(sorted(self._values.items()))


# Default histogram buckets: wide log-spaced range that covers both byte
# counts and (modeled or wall) second durations without configuration.
DEFAULT_BUCKETS = tuple(10.0 ** e for e in range(-9, 13))


class Histogram:
    """Cumulative bucket counts + sum/count per label set."""

    def __init__(self, name: str, help: str = "",
                 buckets: tuple[float, ...] = DEFAULT_BUCKETS):
        self.name, self.help = name, help
        self.buckets = tuple(sorted(buckets))
        self._counts: dict[LabelKey, list[int]] = {}
        self._sum: dict[LabelKey, float] = {}
        self._n: dict[LabelKey, int] = {}

    def observe(self, value: float, **labels: Any) -> None:
        key = _label_key(labels)
        if key not in self._counts:
            self._counts[key] = [0] * (len(self.buckets) + 1)
        v = float(value)
        self._counts[key][bisect.bisect_left(self.buckets, v)] += 1
        self._sum[key] = self._sum.get(key, 0.0) + v
        self._n[key] = self._n.get(key, 0) + 1

    def count(self, **labels: Any) -> int:
        return self._n.get(_label_key(labels), 0)

    def sum(self, **labels: Any) -> float:
        return self._sum.get(_label_key(labels), 0.0)

    def items(self) -> Iterator[tuple[LabelKey, dict[str, Any]]]:
        for key in sorted(self._n):
            yield key, {"count": self._n[key], "sum": self._sum[key],
                        "buckets": list(self._counts[key])}


class MetricsRegistry:
    """Get-or-create registry of named metrics.

    Re-registering a name returns the existing instance (so independent
    instrumentation sites can share a metric without coordination);
    re-registering under a different type raises.
    """

    def __init__(self):
        self._metrics: dict[str, Counter | Gauge | Histogram] = {}

    def _get(self, cls, name: str, help: str, **kw):
        m = self._metrics.get(name)
        if m is None:
            m = self._metrics[name] = cls(name, help, **kw)
        elif not isinstance(m, cls):
            raise TypeError(
                f"metric {name!r} already registered as {type(m).__name__}")
        return m

    def counter(self, name: str, help: str = "") -> Counter:
        return self._get(Counter, name, help)

    def gauge(self, name: str, help: str = "") -> Gauge:
        return self._get(Gauge, name, help)

    def histogram(self, name: str, help: str = "",
                  buckets: tuple[float, ...] = DEFAULT_BUCKETS) -> Histogram:
        return self._get(Histogram, name, help, buckets=buckets)

    def get(self, name: str):
        return self._metrics.get(name)

    def names(self) -> list[str]:
        return sorted(self._metrics)

    def snapshot(self) -> dict[str, Any]:
        """Plain-dict dump of every metric, for ``export.summary`` and
        JSON serialization.  Label keys flatten to ``k=v,k2=v2`` strings
        (empty label set → ``""``)."""
        out: dict[str, Any] = {}
        for name, m in sorted(self._metrics.items()):
            if isinstance(m, Counter):
                out[name] = {
                    "type": "counter",
                    "values": {_fmt(k): v for k, v in m.items()},
                    "total": m.total(),
                }
            elif isinstance(m, Gauge):
                out[name] = {
                    "type": "gauge",
                    "values": {_fmt(k): v for k, v in m.items()},
                    "max": {_fmt(k): m._max[k] for k in sorted(m._max)},
                }
            else:
                out[name] = {
                    "type": "histogram",
                    "values": {_fmt(k): v for k, v in m.items()},
                }
        return out


def _fmt(key: LabelKey) -> str:
    return ",".join(f"{k}={v}" for k, v in key)
