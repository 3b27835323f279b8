"""Host-side span/event recorder — the core of ``repro_torch.obs``.

The reference's recorder (``repro/obs/trace.py``), unchanged in behaviour:

* **host-side only** — events are emitted from history rows already on
  the host and from scheduler/cache callbacks.  Nothing in this module
  touches a device tensor, so recording adds no launch, copy or sync to
  the runs it observes.
* **zero-overhead disabled** — every instrumentation site takes an
  ``obs`` parameter that defaults to ``None`` and guards emission with
  ``if obs is not None``; the untraced path issues the same launches and
  host syncs and is bit-identical.  ``NullRecorder`` exists for callers
  that prefer an always-valid object over a ``None`` guard.
* **virtual + wall clocks** — every event carries both a virtual-clock
  timestamp (engine iterations, the serving stack's deterministic time
  base) and a wall-clock timestamp (seconds since the recorder's
  creation).  The Chrome export lays spans out on the wall clock and
  keeps the virtual clock in ``args``.

The event buffer is a bounded ring (``capacity`` events): a runaway
producer overwrites the oldest events and increments ``dropped`` instead
of growing without bound.
"""

from __future__ import annotations

import collections
import contextlib
import dataclasses
import time
from typing import Any, Iterator

from repro_torch.obs.metrics import MetricsRegistry

# Event phases, mirroring the Chrome trace-event vocabulary the export
# layer targets: complete span, instant, counter sample.
PH_SPAN = "X"
PH_INSTANT = "i"
PH_COUNTER = "C"

DEFAULT_CAPACITY = 1 << 16


@dataclasses.dataclass
class TraceEvent:
    """One recorded event.  ``wall``/``wall_dur`` are seconds relative to
    the recorder's creation; ``vt``/``vt_dur`` are virtual-clock units
    (engine iterations).  ``track`` names the timeline the event belongs
    to (a device, a lane, a tenant) — the export layer maps each distinct
    track to its own thread row."""

    name: str
    ph: str
    cat: str
    track: str
    wall: float
    vt: float
    wall_dur: float = 0.0
    vt_dur: float = 0.0
    args: dict[str, Any] = dataclasses.field(default_factory=dict)


class TraceRecorder:
    """Bounded-ring recorder with an attached metrics registry.

    All emission helpers are plain host Python — cheap enough to call
    from drain loops (one call per iteration row, not per vertex).
    """

    enabled = True

    def __init__(self, capacity: int = DEFAULT_CAPACITY):
        self.capacity = int(capacity)
        self.events: collections.deque[TraceEvent] = collections.deque(
            maxlen=self.capacity
        )
        self.dropped = 0
        self.metrics = MetricsRegistry()
        self._wall0 = time.monotonic()

    # -- clocks ----------------------------------------------------------
    def wall(self) -> float:
        """Seconds since the recorder was created (the trace's wall origin)."""
        return time.monotonic() - self._wall0

    def wall_at(self, t_monotonic: float) -> float:
        """Convert a caller-captured ``time.monotonic()`` stamp into the
        trace's wall coordinates (instrumentation sites already take
        these stamps for their own accounting — reuse, don't re-read)."""
        return t_monotonic - self._wall0

    # -- emission --------------------------------------------------------
    def _push(self, ev: TraceEvent) -> None:
        if len(self.events) == self.capacity:
            self.dropped += 1
        self.events.append(ev)

    def extend(self, events: list[TraceEvent]) -> None:
        """Record finished events at once (a producer's own buffer, drained):
        the ring keeps the newest ``capacity`` and counts the rest dropped."""
        self.dropped += max(0, len(self.events) + len(events) - self.capacity)
        self.events.extend(events)

    def span(
        self, name: str, *, cat: str = "host", track: str = "main",
        wall: float, wall_dur: float = 0.0, vt: float = 0.0,
        vt_dur: float = 0.0, **args: Any,
    ) -> None:
        """Record a completed span (explicit start + duration)."""
        self._push(TraceEvent(name, PH_SPAN, cat, track, wall, vt,
                              wall_dur, vt_dur, args))

    def instant(
        self, name: str, *, cat: str = "event", track: str = "main",
        vt: float = 0.0, wall: float | None = None, **args: Any,
    ) -> None:
        """Record an instantaneous event (defaults to 'now' on the wall)."""
        w = self.wall() if wall is None else wall
        self._push(TraceEvent(name, PH_INSTANT, cat, track, w, vt, args=args))

    def counter(
        self, name: str, value: float, *, cat: str = "counter",
        track: str = "main", vt: float = 0.0, wall: float | None = None,
    ) -> None:
        """Record a counter sample (renders as a counter track in Chrome)."""
        w = self.wall() if wall is None else wall
        self._push(TraceEvent(name, PH_COUNTER, cat, track, w, vt,
                              args={"value": float(value)}))

    @contextlib.contextmanager
    def timed(
        self, name: str, *, cat: str = "host", track: str = "main",
        vt: float = 0.0, vt_dur: float = 0.0, **args: Any,
    ) -> Iterator[dict[str, Any]]:
        """Context manager recording a wall-timed span around its body.

        Yields the span's ``args`` dict so the body can attach results
        (bytes moved, iterations run) discovered while the span is open.
        """
        t0 = self.wall()
        try:
            yield args
        finally:
            self.span(name, cat=cat, track=track, wall=t0,
                      wall_dur=self.wall() - t0, vt=vt, vt_dur=vt_dur, **args)

    # -- views -----------------------------------------------------------
    def drain(self) -> list[TraceEvent]:
        """Snapshot-and-clear the event ring (for streaming JSONL export)."""
        out = list(self.events)
        self.events.clear()
        return out

    def __len__(self) -> int:
        return len(self.events)


class NullRecorder:
    """API-compatible no-op recorder.  Instrumentation sites normally
    guard with ``if obs is not None`` (so the disabled path pays nothing,
    not even a method call); this class exists for callers that want to
    pass a recorder unconditionally."""

    enabled = False
    dropped = 0
    capacity = 0

    def __init__(self):
        self.events: collections.deque[TraceEvent] = collections.deque(maxlen=0)
        self.metrics = MetricsRegistry()

    def wall(self) -> float:
        return 0.0

    def wall_at(self, t_monotonic: float) -> float:
        return 0.0

    def extend(self, events: list[TraceEvent]) -> None:
        pass

    def span(self, name: str, **kw: Any) -> None:
        pass

    def instant(self, name: str, **kw: Any) -> None:
        pass

    def counter(self, name: str, value: float, **kw: Any) -> None:
        pass

    @contextlib.contextmanager
    def timed(self, name: str, **kw: Any) -> Iterator[dict[str, Any]]:
        yield {}

    def drain(self) -> list[TraceEvent]:
        return []

    def __len__(self) -> int:
        return 0
