"""Engine-side recording helpers of the instrumented driver
(``core.hytm.run_hytm``).

Everything here consumes history rows already on the host (NumPy): the
driver calls these helpers after the copies it makes anyway (the chunked
driver's per-key drain, the K = 1 loop's stacked rows), under an ``if obs
is not None`` guard.  The helpers therefore add no device work, copy or
sync, and never change what the traced run computes.

The run-summary span (:func:`record_run`) copies its totals directly from
the finished ``HyTMResult`` — the same host rows reduced by the same
``np.sum`` calls — which is what lets ``export.reconcile`` demand exact
equality rather than a tolerance.  :func:`record_ici` is the sharded
sweep's (``dist.graph_shard.run_hytm_sharded``).

:class:`HostSpans` is ``run_hytm``'s wall-clock view inside a run: the
host time of each iteration, its plan, sweeps, partition dispatches and
finish, and of every blocking device-to-host read.  It stamps
``time.monotonic()`` into plain tuples on the hot loop and turns them into
``CAT_HOST`` spans at the chunk drain, so a traced run issues the same
launches, copies and syncs as an untraced one.
"""

from __future__ import annotations

import itertools
import time
from typing import Any

import numpy as np

from repro_torch.core.cost_model import (
    COMPACT,
    ENGINE_NAMES,
    FILTER,
    KEY_ACTIVE_EDGES,
    KEY_ACTIVE_VERTICES,
    KEY_ENGINES,
    KEY_MISPREDICTIONS,
    KEY_N_TASKS,
    KEY_PER_ENGINE_TIME,
    KEY_TRANSFER_BYTES,
    KEY_TRANSFER_TIME,
    ZEROCOPY,
)
from repro_torch.obs.export import (
    CAT_HOST,
    CAT_ICI,
    CAT_ITERATION,
    CAT_RUN,
    EV_ICI_MERGE,
    EV_ITERATION,
    EV_RUN,
)
from repro_torch.obs.trace import PH_SPAN, TraceEvent

_REAL_ENGINES = (FILTER, COMPACT, ZEROCOPY)


def record_history_rows(
    obs: Any, drained: dict[str, np.ndarray], n_done: int, start_iter: int,
    track: str = "device0", walls: list[float] | None = None,
) -> None:
    """Emit one per-iteration instant (+ metric updates) per host history
    row ``[0:n_done)``.  ``start_iter`` is the global iteration index of
    row 0 (the virtual-clock timestamp); ``walls`` the rows' wall starts
    (``HostSpans.iteration_walls``), else the instants are stamped now."""
    m = obs.metrics
    picks = m.counter("engine.picks", "Algorithm-1 engine selections")
    bytes_c = m.counter("engine.bytes", "modeled host->device transfer bytes")
    secs_c = m.counter("engine.modeled_seconds", "modeled per-engine seconds")
    iters_c = m.counter("engine.iterations", "executed sweep iterations")
    mis_c = m.counter("engine.mispredictions",
                      "selections diverging from modeled-best")
    frontier_h = m.histogram("engine.frontier", "active vertices per iteration")

    engines = np.asarray(drained[KEY_ENGINES][:n_done])
    tbytes = np.asarray(drained[KEY_TRANSFER_BYTES][:n_done], dtype=np.float64)
    ttime = np.asarray(drained[KEY_TRANSFER_TIME][:n_done], dtype=np.float64)
    pet = np.asarray(drained[KEY_PER_ENGINE_TIME][:n_done], dtype=np.float64)
    av = np.asarray(drained[KEY_ACTIVE_VERTICES][:n_done])
    ae = np.asarray(drained[KEY_ACTIVE_EDGES][:n_done], dtype=np.float64)
    nt = np.asarray(drained[KEY_N_TASKS][:n_done])
    mis = np.asarray(drained[KEY_MISPREDICTIONS][:n_done])

    for k in range(int(n_done)):
        vt = float(start_iter + k)
        eng_row, byte_row = engines[k], tbytes[k]
        pick_counts = {}
        for e in _REAL_ENGINES:
            sel = eng_row == e
            n_sel = int(np.sum(sel))
            if n_sel:
                name = ENGINE_NAMES[e]
                pick_counts[name] = n_sel
                picks.inc(n_sel, engine=name)
                bytes_c.inc(float(np.sum(byte_row[sel])), engine=name)
            secs_c.inc(float(pet[k][e]), engine=ENGINE_NAMES[e])
        iters_c.inc(1)
        mis_c.inc(int(mis[k]))
        frontier_h.observe(float(av[k]))
        obs.instant(
            EV_ITERATION, cat=CAT_ITERATION, track=track, vt=vt,
            wall=None if walls is None else walls[k],
            bytes=float(np.sum(byte_row)),
            modeled_seconds=float(ttime[k]),
            active_vertices=int(av[k]),
            active_edges=float(ae[k]),
            n_tasks=int(nt[k]),
            mispredictions=int(mis[k]),
            picks=pick_counts,
        )
        obs.counter("frontier", float(av[k]), track=track, vt=vt)


def record_chunk(
    obs: Any, *, track: str, wall_start: float, wall_dur: float,
    start_iter: int, n_done: int, warm: bool,
) -> None:
    """One span per chunk dispatch: wall window = dispatch + execution +
    drain, virtual window = the iterations the chunk executed."""
    obs.span(
        "chunk", cat=CAT_RUN, track=track, wall=wall_start,
        wall_dur=wall_dur, vt=float(start_iter), vt_dur=float(n_done),
        n_done=int(n_done), warm=bool(warm),
    )


def record_ici(
    obs: Any, *, track: str, it: int, bytes_: float, seconds: float,
    engine: int, merged_entries: float, wall: float | None = None,
    halo_entries: float | None = None,
) -> None:
    """One instant per sharded-iteration ICI exchange (dense vs compact
    all-reduce pick), plus the unified ICI metrics.  ``halo_entries`` is
    set on owner-sharded runs: the boundary entries a compacted exchange
    would actually ship, surfaced as the ``ici.halo_bytes`` counter (8 B
    per entry).  Called by the sharded sweep only."""
    name = ENGINE_NAMES.get(int(engine), str(int(engine)))
    m = obs.metrics
    m.counter("ici.bytes", "modeled cross-device merge bytes").inc(
        float(bytes_), engine=name)
    m.counter("ici.picks", "ICI exchange-level engine picks").inc(
        1, engine=name)
    m.counter("ici.modeled_seconds", "modeled ICI merge seconds").inc(
        float(seconds), engine=name)
    extra = {}
    if halo_entries is not None:
        m.counter(
            "ici.halo_bytes",
            "compacted owner-halo exchange bytes (8 B/boundary entry)",
        ).inc(float(halo_entries) * 8.0, engine=name)
        extra["halo_entries"] = float(halo_entries)
    obs.instant(
        EV_ICI_MERGE, cat=CAT_ICI, track=track, vt=float(it), wall=wall,
        bytes=float(bytes_), modeled_seconds=float(seconds), engine=name,
        merged_entries=float(merged_entries), **extra,
    )


def record_run(
    obs: Any, result: Any, *, track: str = "device0", wall_start: float,
    wall_dur: float, program: str = "", label: str = "run",
) -> None:
    """The run-summary span: totals copied verbatim from the finished
    ``HyTMResult`` (exact-reconciliation anchor for ``export.reconcile``)."""
    obs.span(
        EV_RUN, cat=CAT_RUN, track=track, wall=wall_start,
        wall_dur=wall_dur, vt=0.0, vt_dur=float(result.iterations),
        label=label, program=program,
        iterations=int(result.iterations),
        transfer_bytes=float(result.total_transfer_bytes),
        modeled_seconds=float(result.modeled_seconds),
        mispredictions=int(result.total_mispredictions),
        ici_bytes=float(result.total_ici_bytes),
        ici_modeled_seconds=float(result.modeled_ici_seconds),
        wall_seconds=float(result.wall_seconds),
    )


# one id a traced run, unique in the process
_RUN_IDS = itertools.count()
# a dispatch's engine as its span names it (NONE: SUM's consume-only dispatch)
_ENGINE_LABELS = {e: name.upper() for e, name in ENGINE_NAMES.items()}


class HostSpans:
    """The host spans of one traced ``run_hytm`` on one device.

    ``run_hytm`` opens and closes spans around its steps (``open``/``close``
    keep a stack, so every span knows its parent); ``dispatch`` records a
    partition dispatch of ``_sweep`` (by engine id) with the instant that
    splits it into relax (building the block, the engine's launches) and
    apply (the state update after it); ``leaf`` records a span with no
    children, a blocking read.  Each is a tuple ``(name, parent, it, t0,
    t1, args)`` of ``time.monotonic()`` stamps, ``it`` the iteration the
    run is in (the number of iterations it ran before).  ``flush`` turns
    the tuples into ``CAT_HOST`` spans on track ``device0`` of ``obs``,
    carrying ``run`` (this run's id), ``it`` and ``parent``; a dispatch's
    ``split`` is on the trace's wall clock."""

    def __init__(self, obs: Any):
        self.obs = obs
        self.run = next(_RUN_IDS)
        self.it = 0
        self.stack = [EV_RUN]
        self.rows: list[tuple] = []
        self.iter_starts: list[float] = []  # each run iteration's start

    def open(self, name: str) -> float:
        self.stack.append(name)
        return time.monotonic()

    def close(self, t0: float, **args: Any) -> None:
        """Record the innermost open span, from ``t0`` to now."""
        name = self.stack.pop()
        self.rows.append((name, self.stack[-1], self.it, t0, time.monotonic(), args))

    def leave(self) -> None:
        """Close the innermost open span unrecorded: one that ``obs``
        records itself (a chunk).  Its children keep it as their parent."""
        self.stack.pop()

    def abandon(self) -> None:
        """Close the innermost open span unrecorded, its children moved to
        its parent: an iteration planned whose fetch found the frontier
        empty, so that it never ran."""
        name = self.stack.pop()
        for i in range(len(self.rows) - 1, -1, -1):
            row = self.rows[i]
            if row[1] != name or row[2] != self.it:
                break
            self.rows[i] = (row[0], self.stack[-1]) + row[2:]

    def end_iteration(self, t0: float) -> None:
        """Close the open ``iter`` span, started at ``t0``; the run moves
        to its next iteration."""
        self.close(t0)
        self.iter_starts.append(t0)
        self.it += 1

    def leaf(self, name: str, t0: float, **args: Any) -> None:
        self.rows.append((name, self.stack[-1], self.it, t0, time.monotonic(), args))

    def dispatch(self, p: int, engine: int, edges: int, pass_: int, t0: float,
                 split: float) -> None:
        self.rows.append(("dispatch", self.stack[-1], self.it, t0, time.monotonic(),
                          (p, engine, edges, pass_, split)))

    def iteration_walls(self, first: int, count: int) -> list[float]:
        """The wall starts of iterations ``[first, first + count)``."""
        return [self.obs.wall_at(t) for t in self.iter_starts[first:first + count]]

    def flush(self) -> None:
        origin = self.obs.wall_at(0.0)  # wall_at(t) == t + origin
        run, events = self.run, []
        for name, parent, it, t0, t1, args in self.rows:
            if name == "dispatch":
                p, engine, edges, pass_, split = args
                args = {"run": run, "it": it, "parent": parent, "p": p,
                        "engine": _ENGINE_LABELS[engine], "edges": edges, "pass": pass_,
                        "split": split + origin}
            else:
                args = {"run": run, "it": it, "parent": parent, **args}
            events.append(TraceEvent(name, PH_SPAN, CAT_HOST, "device0", t0 + origin,
                                     float(it), t1 - t0, float(name == "iter"), args))
        self.obs.extend(events)
        self.rows.clear()
