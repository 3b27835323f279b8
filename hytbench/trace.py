"""The traced segment: device activity from ``torch.profiler``, read
against the harness's own host spans.

Only device activity is recorded (``ProfilerActivity.CUDA``), so the host
issues work as fast as untraced.  The profiler's clock is tied to the
host's by an anchor: the segment starts on an idle device, takes a host
stamp and launches one small kernel, whose device start is then that
stamp (off by the launch latency, some microseconds).  Host spans (one a
``run_hytm`` call, and the chunk spans that ``run_hytm(obs=...)`` records)
then label each stretch in which the device was idle, and the idle time is
summed by label: most of it lies in gaps of microseconds between launches,
which no list of single gaps would show.
"""

from __future__ import annotations

import re
import time
from dataclasses import dataclass, field

TOP = 10  # entries of each breakdown list


@dataclass
class Span:
    label: str
    start: float  # time.monotonic()
    end: float


@dataclass
class Trace:
    busy_s: float      # union of device activity within the window
    window_s: float    # host seconds from the anchor to the last synchronize
    device_ops: list   # [[name, seconds]], most device time first
    idle_gaps: list    # [[label, seconds]]: idle time by what the host did, most first
    runs: list = field(default_factory=list)  # the traced runs' records


def op_name(key: str) -> str:
    """A device op's name as ``chip_smoke.traced_device_ms`` writes it: no
    return type, namespace of the port's kernels or argument list."""
    return re.sub(r"^void |\(.*$", "", key.replace("(anonymous namespace)::", ""))[:60]


def merged(intervals: list[tuple[float, float]]) -> list[tuple[float, float]]:
    """The union of ``(start, end)`` intervals, as disjoint sorted ones."""
    out: list[list[float]] = []
    for s, e in sorted(intervals):
        if out and s <= out[-1][1]:
            out[-1][1] = max(out[-1][1], e)
        else:
            out.append([s, e])
    return [(s, e) for s, e in out]


def gaps(busy: list[tuple[float, float]], lo: float, hi: float) -> list[tuple[float, float]]:
    """The stretches of [lo, hi] that no busy interval covers."""
    out, at = [], lo
    for s, e in busy:
        if s > at:
            out.append((at, min(s, hi)))
        at = max(at, e)
    if at < hi:
        out.append((at, hi))
    return [(s, e) for s, e in out if e > s]


def label_at(spans: list[Span], t: float) -> str:
    """The innermost span that holds host time ``t``."""
    inside = [s for s in spans if s.start <= t <= s.end]
    if not inside:
        return "harness: between runs"
    return min(inside, key=lambda s: s.end - s.start).label


def summarize(events: list[tuple[float, float, str]], anchor_host: float, window_s: float,
              spans: list[Span]) -> Trace:
    """``events``: the device events (start µs, end µs, name) on the
    profiler's clock, the anchor first.  The window runs from the anchor's
    start for ``window_s`` seconds."""
    t0 = events[0][0]
    lo, hi = t0, t0 + window_s * 1e6
    busy = merged([(max(s, lo), min(e, hi)) for s, e, _ in events if e > lo and s < hi])
    per_op: dict[str, float] = {}
    for s, e, name in events:
        per_op[op_name(name)] = per_op.get(op_name(name), 0.0) + (e - s) / 1e6
    idle: dict[str, float] = {}
    for s, e in gaps(busy, lo, hi):
        label = label_at(spans, anchor_host + ((s + e) / 2 - t0) / 1e6)
        idle[label] = idle.get(label, 0.0) + (e - s) / 1e6
    return Trace(busy_s=sum(e - s for s, e in busy) / 1e6, window_s=window_s,
                 device_ops=top(per_op), idle_gaps=top(idle))


def top(seconds: dict) -> list:
    return [[k, v] for k, v in sorted(seconds.items(), key=lambda kv: -kv[1])[:TOP]]


def traced(torch, device, run_segment) -> Trace:
    """Run ``run_segment()`` (which returns its host spans and its runs'
    records) under the profiler on an idle ``device``; its Trace."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    if device.type != "cuda":
        raise ValueError("the traced segment reads a CUDA card's activity")
    torch.cuda.synchronize(device)
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        anchor_host = time.monotonic()
        torch.ones(1, device=device)
        spans, runs = run_segment()
        torch.cuda.synchronize(device)
        window_s = time.monotonic() - anchor_host
    events = sorted((e.time_range.start, e.time_range.end, e.name) for e in prof.events()
                    if e.device_type == DeviceType.CUDA)
    if not events:
        raise RuntimeError("the profiler's trace holds no device event")
    out = summarize(events, anchor_host, window_s, spans)
    out.runs = runs
    return out
