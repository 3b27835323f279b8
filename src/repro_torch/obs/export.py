"""Trace export + reconciliation for ``repro_torch.obs``.

Three output forms:

* :func:`to_chrome_trace` / :func:`write_chrome_trace` — Chrome
  trace-event JSON (the ``{"traceEvents": [...]}`` object format)
  loadable in ``chrome://tracing`` and Perfetto.  Each distinct recorder
  track (device, lane, tenant) becomes its own thread row; spans lay out
  on the wall clock (microseconds) and carry the virtual clock in
  ``args``.
* :func:`write_jsonl` — one JSON object per event, for streaming
  consumers.
* :func:`summary` / :func:`reconcile` — host-side rollups.
  ``reconcile`` cross-checks the trace's run-span totals against the
  ``HyTMResult`` accounting (iterations, transfer bytes, modeled
  seconds, ICI bytes): the two views are computed from the same drained
  history rows by the same reductions, so they must agree *exactly*.

:func:`validate_chrome_trace` is the schema check of every trace the
port writes; a trace it accepts also passes the reference's.
"""

from __future__ import annotations

import json
import math
from typing import Any

from repro_torch.obs.trace import PH_COUNTER, PH_INSTANT, PH_SPAN, TraceRecorder

# Event names/categories the instrumentation sites and the reconciler
# agree on (producers: core.hytm, serve.scheduler; the ICI and fault
# names belong to the sharded sweep and the resilience plane).
CAT_ITERATION = "iteration"
CAT_RUN = "run"
CAT_ICI = "ici"
CAT_FAULTS = "faults"  # resilience plane: injections/retries/degrades
# single-device ``run_hytm``'s host spans (``record.HostSpans``): iter, plan,
# sweep, dispatch, finish and sync, which the reference does not record
CAT_HOST = "host"
EV_ITERATION = "iteration"
EV_RUN = "hytm_run"
EV_ICI_MERGE = "ici_merge"

PID = 1


def to_chrome_trace(rec: TraceRecorder) -> dict[str, Any]:
    """Render the recorder's event ring as a Chrome trace-event object."""
    tids: dict[str, int] = {}
    events: list[dict[str, Any]] = [{
        "name": "process_name", "ph": "M", "pid": PID, "tid": 0,
        "args": {"name": "repro_torch"},
    }]

    def tid_of(track: str) -> int:
        t = tids.get(track)
        if t is None:
            t = tids[track] = len(tids) + 1
            events.append({
                "name": "thread_name", "ph": "M", "pid": PID, "tid": t,
                "args": {"name": track},
            })
        return t

    for ev in rec.events:
        out: dict[str, Any] = {
            "name": ev.name,
            "cat": ev.cat,
            "ph": ev.ph,
            "ts": ev.wall * 1e6,          # Chrome expects microseconds
            "pid": PID,
            "tid": tid_of(ev.track),
            "args": dict(ev.args),
        }
        out["args"]["vt"] = ev.vt
        if ev.ph == PH_SPAN:
            out["dur"] = ev.wall_dur * 1e6
            out["args"]["vt_dur"] = ev.vt_dur
        elif ev.ph == PH_INSTANT:
            out["s"] = "t"                # thread-scoped instant
        elif ev.ph == PH_COUNTER:
            out["args"] = {"value": ev.args.get("value", 0.0)}
        events.append(out)

    return {
        "traceEvents": events,
        "displayTimeUnit": "ms",
        "otherData": {"dropped_events": rec.dropped},
    }


def validate_chrome_trace(doc: dict[str, Any]) -> int:
    """Raise ``ValueError`` unless ``doc`` is valid Chrome trace-event
    JSON (object format); returns the number of trace events."""
    if not isinstance(doc, dict) or not isinstance(doc.get("traceEvents"), list):
        raise ValueError("trace must be an object with a traceEvents list")
    for i, ev in enumerate(doc["traceEvents"]):
        where = f"traceEvents[{i}]"
        if not isinstance(ev, dict):
            raise ValueError(f"{where} is not an object")
        if not isinstance(ev.get("name"), str) or not ev["name"]:
            raise ValueError(f"{where} needs a non-empty string name")
        ph = ev.get("ph")
        if ph not in ("X", "i", "C", "M"):
            raise ValueError(f"{where} has unsupported phase {ph!r}")
        if not isinstance(ev.get("pid"), int) or not isinstance(ev.get("tid"), int):
            raise ValueError(f"{where} needs integer pid/tid")
        if ph == "M":
            if ev["name"] not in ("process_name", "thread_name"):
                raise ValueError(f"{where}: unknown metadata {ev['name']!r}")
            if not isinstance(ev.get("args", {}).get("name"), str):
                raise ValueError(f"{where}: metadata needs args.name")
            continue
        ts = ev.get("ts")
        if not isinstance(ts, (int, float)) or not math.isfinite(ts) or ts < 0:
            raise ValueError(f"{where} needs a finite non-negative ts")
        if ph == "X":
            dur = ev.get("dur")
            if not isinstance(dur, (int, float)) or not math.isfinite(dur) or dur < 0:
                raise ValueError(f"{where} (span) needs a finite non-negative dur")
        if ph == "i" and ev.get("s") not in ("t", "p", "g"):
            raise ValueError(f"{where} (instant) needs scope s in t/p/g")
        if ph == "C" and not all(
            isinstance(v, (int, float)) for v in ev.get("args", {}).values()
        ):
            raise ValueError(f"{where} (counter) args must be numeric")
        if not isinstance(ev.get("args", {}), dict):
            raise ValueError(f"{where} args must be an object")
    return len(doc["traceEvents"])


def write_chrome_trace(rec: TraceRecorder, path: str) -> dict[str, Any]:
    """Validate + write the Chrome trace JSON; returns the document."""
    doc = to_chrome_trace(rec)
    validate_chrome_trace(doc)
    with open(path, "w") as f:
        json.dump(doc, f)
        f.write("\n")
    return doc


def write_jsonl(rec: TraceRecorder, path: str) -> int:
    """One JSON object per recorded event (the streaming form); returns
    the number of lines written."""
    n = 0
    with open(path, "w") as f:
        for ev in rec.events:
            f.write(json.dumps({
                "name": ev.name, "ph": ev.ph, "cat": ev.cat,
                "track": ev.track, "wall": ev.wall, "wall_dur": ev.wall_dur,
                "vt": ev.vt, "vt_dur": ev.vt_dur, "args": ev.args,
            }))
            f.write("\n")
            n += 1
    return n


def summary(rec: TraceRecorder) -> dict[str, Any]:
    """Host-side rollup: event counts per category/phase + the metrics
    snapshot.  JSON-serializable."""
    by_cat: dict[str, int] = {}
    by_ph: dict[str, int] = {}
    tracks: set[str] = set()
    for ev in rec.events:
        by_cat[ev.cat] = by_cat.get(ev.cat, 0) + 1
        by_ph[ev.ph] = by_ph.get(ev.ph, 0) + 1
        tracks.add(ev.track)
    return {
        "events": len(rec.events),
        "dropped": rec.dropped,
        "tracks": sorted(tracks),
        "by_cat": dict(sorted(by_cat.items())),
        "by_ph": dict(sorted(by_ph.items())),
        "metrics": rec.metrics.snapshot(),
    }


def reconcile(rec: TraceRecorder, result: Any, track: str | None = None) -> dict[str, Any]:
    """Cross-check the trace against a ``HyTMResult``.

    Finds the run span(s) (``EV_RUN``) emitted by ``record_run`` —
    optionally restricted to ``track`` — and compares their summed totals
    against the result's fields, plus the per-iteration event count
    against ``result.iterations``.  Both sides are computed from the same
    drained history rows by the same reductions, so every comparison is
    **exact** (``==``), not approximate.

    Returns ``{"ok": bool, "checks": {name: {"trace", "result", "ok"}}}``.
    """
    runs = [ev for ev in rec.events
            if ev.name == EV_RUN and ev.ph == PH_SPAN
            and (track is None or ev.track == track)]
    iter_events = [ev for ev in rec.events
                   if ev.cat == CAT_ITERATION and ev.ph == PH_INSTANT
                   and (track is None or ev.track == track)]

    def tot(key: str) -> float:
        return sum(ev.args.get(key, 0.0) for ev in runs)

    checks = {
        "iterations": {
            "trace": int(tot("iterations")), "result": int(result.iterations)},
        "iteration_events": {
            "trace": len(iter_events), "result": int(result.iterations)},
        "transfer_bytes": {
            "trace": tot("transfer_bytes"),
            "result": float(result.total_transfer_bytes)},
        "modeled_seconds": {
            "trace": tot("modeled_seconds"),
            "result": float(result.modeled_seconds)},
        "mispredictions": {
            "trace": int(tot("mispredictions")),
            "result": int(result.total_mispredictions)},
        "ici_bytes": {
            "trace": tot("ici_bytes"),
            "result": float(getattr(result, "total_ici_bytes", 0.0))},
    }
    for c in checks.values():
        c["ok"] = c["trace"] == c["result"]
    return {"ok": all(c["ok"] for c in checks.values()), "checks": checks}
