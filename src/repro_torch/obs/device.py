"""Device time charged to the host span that launched it.

A traced run's spans (``record.HostSpans``' ``CAT_HOST`` spans, the chunk
and run spans) are stamped on ``time.monotonic()``.  ``torch.profiler``
stamps host activity, and puts device activity, on the wall clock in epoch
nanoseconds, so ``time.time_ns() - time.monotonic_ns()``, read around the
traced segment (:func:`clock_offset_ns`), places the spans on the
profiler's clock with no anchor kernel.  Each device op (kernel, copy,
fill) is joined to the CUDA runtime or driver call that launched it by
correlation id (:func:`launched_ops`), and charged to the innermost span
that holds that launch (:func:`charge`): a dispatch's op to its relax or
its apply part, by the dispatch's split instant.

Everything here runs after the traced segment, on the host.
"""

from __future__ import annotations

import time
from dataclasses import dataclass, field

from repro_torch.obs.export import CAT_HOST, CAT_RUN
from repro_torch.obs.trace import PH_SPAN

# CUDA runtime and driver calls that put the port's work on a stream
LAUNCHES = ("cudaLaunchKernel", "cudaLaunchKernelExC", "cuLaunchKernel", "cuLaunchKernelEx",
            "cudaMemcpyAsync", "cudaMemsetAsync")


def clock_offset_ns() -> int:
    """Epoch nanoseconds minus ``time.monotonic_ns()``, now."""
    return time.time_ns() - time.monotonic_ns()


@dataclass(frozen=True)
class DeviceOp:
    name: str
    start_ns: int
    end_ns: int
    launch_ns: int | None  # its launch call's host start; None if unseen


def launched_ops(kineto_results) -> list[DeviceOp]:
    """The device ops of a ``torch.profiler`` trace
    (``prof.profiler.kineto_results``), each with its launch's host stamp,
    in the order they started."""
    from torch.autograd import DeviceType

    events = list(kineto_results.events())
    launch = {e.correlation_id(): e.start_ns() for e in events
              if e.device_type() == DeviceType.CPU and e.name() in LAUNCHES}
    ops = [DeviceOp(e.name(), e.start_ns(), e.start_ns() + e.duration_ns(),
                    launch.get(e.linked_correlation_id(), launch.get(e.correlation_id())))
           for e in events if e.device_type() == DeviceType.CUDA]
    return sorted(ops, key=lambda op: op.start_ns)


@dataclass(frozen=True)
class ProgramSpan:
    start_ns: int
    end_ns: int
    name: str
    args: dict


def program_spans(rec, offset_ns: int) -> list[ProgramSpan] | None:
    """``rec``'s host, chunk and run spans on the profiler's clock;
    ``offset_ns`` is :func:`clock_offset_ns` at the traced segment.  None
    if the recorder's ring dropped events: the spans would be incomplete."""
    if rec.dropped:
        return None
    origin = -rec.wall_at(0.0)  # the recorder's zero on time.monotonic()

    def ns(wall: float) -> int:
        return round((origin + wall) * 1e9) + offset_ns

    out = []
    for ev in rec.events:
        if ev.ph != PH_SPAN or ev.cat not in (CAT_HOST, CAT_RUN):
            continue
        args = dict(ev.args)
        if "split" in args:
            args["split"] = ns(args["split"])
        out.append(ProgramSpan(ns(ev.wall), ns(ev.wall + ev.wall_dur), ev.name, args))
    return out


def label(span: ProgramSpan | None, at_ns: int) -> str:
    """What a launch at ``at_ns`` inside ``span`` is charged to: a
    dispatch's engine and part, a sync's site, else the span's name."""
    if span is None:
        return "outside the spans"
    if span.name == "dispatch":
        part = "relax" if at_ns < span.args["split"] else "apply"
        return f"dispatch {span.args['engine']} {part}"
    if span.name == "sync":
        return f"sync {span.args['site']}"
    return span.name


def innermost(spans: list[ProgramSpan], times: list[int]) -> list[ProgramSpan | None]:
    """For each of the ascending ``times``, the innermost of the nested
    ``spans`` that holds it, or None."""
    order = sorted(spans, key=lambda s: (s.start_ns, -s.end_ns))
    out: list[ProgramSpan | None] = []
    stack: list[ProgramSpan] = []
    j = 0
    for t in times:
        while j < len(order) and order[j].start_ns <= t:
            while stack and stack[-1].end_ns < order[j].start_ns:
                stack.pop()
            stack.append(order[j])
            j += 1
        while stack and stack[-1].end_ns < t:
            stack.pop()
        out.append(stack[-1] if stack else None)
    return out


@dataclass
class Charged:
    """Device and idle seconds of a window ``[lo, hi]`` by span label."""

    window_s: float
    busy_s: float = 0.0        # union of the ops' intervals in the window
    device_s: dict = field(default_factory=dict)  # label -> op seconds
    idle_s: dict = field(default_factory=dict)    # label -> idle seconds


def charge(ops: list[DeviceOp], spans: list[ProgramSpan], lo: int, hi: int) -> Charged:
    """Charge each op in ``[lo, hi]`` to the span that launched it, and
    each idle stretch of the window to the span that launched the op
    ending it (the last stretch, which no op ends, to "after the last op")."""
    ops = sorted((op for op in ops if op.end_ns > lo and op.start_ns < hi),
                 key=lambda op: op.start_ns)
    out = Charged(window_s=(hi - lo) / 1e9)
    by_launch = sorted((i for i, op in enumerate(ops) if op.launch_ns is not None),
                       key=lambda i: ops[i].launch_ns)
    labels = ["launch not seen"] * len(ops)
    for i, span in zip(by_launch, innermost(spans, [ops[i].launch_ns for i in by_launch])):
        labels[i] = label(span, ops[i].launch_ns)
    at = lo
    for op, lab in zip(ops, labels):
        out.device_s[lab] = out.device_s.get(lab, 0.0) + (op.end_ns - op.start_ns) / 1e9
        if op.start_ns > at:
            out.idle_s[lab] = out.idle_s.get(lab, 0.0) + (op.start_ns - at) / 1e9
        s, e = max(op.start_ns, at), min(op.end_ns, hi)
        if e > s:
            out.busy_s += (e - s) / 1e9
            at = e
    if hi > at:
        out.idle_s["after the last op"] = (hi - at) / 1e9
    return out
