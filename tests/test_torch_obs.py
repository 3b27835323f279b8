"""The port's observability layer (``repro_torch.obs`` and the ``obs=`` of
``run_hytm``, ``run_incremental``, ``OnlineCalibrator``, ``WarmCache``,
the lane scheduler and ``GraphService``) against ``repro.obs`` on the
reference's own test sizes (``tests/test_obs.py``: ``rmat_graph(600,
4_800, seed=9)``, 8 partitions, ``sync_every`` 4 and 1).

Contract:
* a traced run's events, its host spans (``CAT_HOST``, which the
  reference does not record) left out, equal the reference's in name,
  phase, category,
  track, ``vt``, ``vt_dur`` and args, leaving out the wall-derived fields
  (``wall``, ``wall_dur``, ``wall_seconds``, ``measured_seconds`` and the
  calibrator's correction values, which come from wall time) and a chunk's
  ``warm`` flag (whether the process dispatched that signature before,
  which depends on what ran earlier in it).  The
  modeled-seconds fields (an iteration's ``modeled_seconds``, the run's,
  the ``engine.modeled_seconds`` counter) are held within rtol 1e-6: the
  reference's jitted cost model fuses Tiz's multiply-add and differs from
  its eager arithmetic, which the port matches, in the last place
  (ROADMAP's hazards).  Every other value is equal;
* the metrics snapshots are equal (modeled seconds as above);
* ``reconcile`` holds exactly in both packages on both drivers and
  detects a tampered total;
* traced values are bit-equal to untraced ones, and ``NullRecorder`` runs
  as ``None`` does;
* the ring keeps ``capacity`` events and counts the rest as dropped;
* a port Chrome trace validates under the reference's validator and the
  other way round;
* a traced ``GraphService`` query (the reference's ``obs_bench`` step 3)
  records the reference's tracks, events and ``serve.*``/``admission.*``/
  ``cache.*`` counters;
* the host spans nest run, chunk, iter, plan/sweep/finish, dispatch, with
  each sync inside its parent; an iteration's pass-1 dispatches are its
  history row's engines (and, for SUM, its consume-only partitions);
  ``hytm.host_syncs`` counts every blocking read by its site's formula.
"""

import dataclasses
import json

import numpy as np
import pytest

from repro import obs as jobs
from repro import stream as jstream
from repro.autotune.feedback import OnlineCalibrator as JCalibrator
from repro.core import hytm as jh
from repro.graph import algorithms as jalg
from repro.graph import generators as jgen
from repro.stream import delta_csr as jd
from repro.stream import incremental as ji
from repro_torch import convert
from repro_torch import obs as tobs
from repro_torch import stream as tstream
from repro_torch.autotune import OnlineCalibrator
from repro_torch.core import hytm as th
from repro_torch.core.cost_model import ENGINE_NAMES, HISTORY_KEYS, KEY_ENGINES, NONE
from repro_torch.graph import algorithms as talg
from repro_torch.obs import device as tobs_device
from repro_torch.obs import export as tobs_export

JCFG = jh.HyTMConfig(n_partitions=8, sync_every=4)
JCFG1 = jh.HyTMConfig(n_partitions=8, sync_every=1)
MODELED_RTOL = 1e-6
WALL_ARGS = {"wall_seconds", "measured_seconds", "correction", "warm"}
MODELED_ARGS = {"modeled_seconds"}


def _tconfig(cfg: jh.HyTMConfig, **kw) -> th.HyTMConfig:
    fields = {f.name for f in dataclasses.fields(th.HyTMConfig)} - {"link", "ici_link"}
    vals = {k: getattr(cfg, k) for k in fields}
    vals.update(kw)
    return th.HyTMConfig(link=convert.link_model(dataclasses.asdict(cfg.link)), **vals)


@pytest.fixture(scope="module")
def graphs():
    g = jgen.rmat_graph(600, 4_800, seed=9)
    return g, convert.csr_graph(g.indptr, g.indices, g.weights)


def _same_args(a: dict, b: dict, skip=()):
    assert set(a) == set(b)
    for k in a:
        if k in WALL_ARGS or k in skip:
            continue
        if k in MODELED_ARGS:
            np.testing.assert_allclose(b[k], a[k], rtol=MODELED_RTOL)
        else:
            assert a[k] == b[k], k


def _port_events(trec) -> list:
    """The port's events that the reference records too: all but the
    single-device ``run_hytm``'s host spans."""
    return [e for e in trec.events if e.cat != tobs_export.CAT_HOST]


def _same_events(jrec, trec, skip_args=()):
    port = _port_events(trec)
    assert len(jrec.events) == len(port) and jrec.dropped == trec.dropped
    for a, b in zip(jrec.events, port):
        assert (a.name, a.ph, a.cat, a.track, a.vt, a.vt_dur) == \
            (b.name, b.ph, b.cat, b.track, b.vt, b.vt_dur)
        _same_args(a.args, b.args, skip_args)


def _same_snapshots(js: dict, ts: dict):
    assert list(js) == list(ts)
    for name in js:
        if name == "engine.modeled_seconds":
            assert js[name]["values"].keys() == ts[name]["values"].keys()
            for k, v in js[name]["values"].items():
                np.testing.assert_allclose(ts[name]["values"][k], v, rtol=MODELED_RTOL)
        else:
            assert js[name] == ts[name], name


# --------------------------------------------------------------------------
# recorder and metrics primitives
# --------------------------------------------------------------------------

def test_ring_bound_and_drain_as_the_reference():
    recs = (jobs.TraceRecorder(capacity=8), tobs.TraceRecorder(capacity=8))
    for rec in recs:
        for i in range(50):
            rec.instant("e", vt=float(i), k=i)
        assert len(rec) == 8 and rec.dropped == 42
        assert [e.vt for e in rec.events] == [float(v) for v in range(42, 50)]
    _same_events(*recs)
    drained = recs[1].drain()
    assert len(drained) == 8 and len(recs[1]) == 0 and recs[1].dropped == 42
    null = tobs.NullRecorder()
    null.span("s", wall=0.0)
    null.instant("i")
    null.counter("c", 1.0)
    with null.timed("t") as args:
        assert args == {}
    assert len(null) == 0 and not null.enabled and null.drain() == []


def test_extend_keeps_the_ring_bound():
    rec = tobs.TraceRecorder(capacity=8)
    one = [tobs.TraceEvent("e", "i", "c", "t", 0.0, float(i)) for i in range(5)]
    rec.extend(one)
    assert len(rec) == 5 and rec.dropped == 0
    rec.extend([tobs.TraceEvent("f", "i", "c", "t", 0.0, float(i)) for i in range(6)])
    assert len(rec) == 8 and rec.dropped == 3
    assert [e.vt for e in rec.events] == [3.0, 4.0] + [float(i) for i in range(6)]
    rec.extend([tobs.TraceEvent("g", "i", "c", "t", 0.0, float(i)) for i in range(20)])
    assert rec.dropped == 23 and [e.vt for e in rec.events] == [float(i) for i in range(12, 20)]
    null = tobs.NullRecorder()
    null.extend(one)
    assert len(null) == 0


def test_metrics_registry_equals_the_reference():
    regs = (jobs.MetricsRegistry(), tobs.MetricsRegistry())
    for m in regs:
        c = m.counter("bytes", "transferred")
        c.inc(10, engine="filter")
        c.inc(5, engine="filter")
        c.inc(7.5, engine="compact")
        g = m.gauge("occ")
        for v in (0.5, 0.9, 0.25):
            g.set(v, lane="a")
        h = m.histogram("lat")
        for v in (3e-6, 2e-3, 2e-3, 40.0, 1e15):
            h.observe(v, kind="x")
        assert m.counter("bytes") is c
        with pytest.raises(TypeError):
            m.gauge("bytes")
        assert c.total() == 22.5 and g.max(lane="a") == 0.9 and h.count(kind="x") == 5
    assert regs[0].snapshot() == regs[1].snapshot()
    assert regs[0].names() == regs[1].names()


def test_recorder_timed_span_and_chrome_trace_round_trip(tmp_path):
    rec = tobs.TraceRecorder()
    with rec.timed("work", track="t1", vt=2.0, vt_dur=3.0) as args:
        args["bytes"] = 64
    rec.instant("mark", track="t2", note="x")
    rec.counter("gauge", 0.5, track="t1")
    doc = tobs.write_chrome_trace(rec, str(tmp_path / "t.json"))
    assert json.loads((tmp_path / "t.json").read_text()) == doc
    assert tobs.validate_chrome_trace(doc) == jobs.validate_chrome_trace(doc) == 6
    span = [e for e in doc["traceEvents"] if e["ph"] == "X"][0]
    assert span["args"] == {"bytes": 64, "vt": 2.0, "vt_dur": 3.0} and span["dur"] >= 0
    assert tobs.write_jsonl(rec, str(tmp_path / "t.jsonl")) == 3
    lines = [json.loads(s) for s in (tmp_path / "t.jsonl").read_text().splitlines()]
    assert [ln["name"] for ln in lines] == ["work", "mark", "gauge"]
    s = tobs.summary(rec)
    assert s["tracks"] == ["t1", "t2"] and s["by_ph"] == {"C": 1, "X": 1, "i": 1}


@pytest.mark.parametrize("bad", [
    {"traceEvents": [{"name": "", "ph": "X", "pid": 1, "tid": 1, "ts": 0, "dur": 1}]},
    {"traceEvents": [{"name": "e", "ph": "Q", "pid": 1, "tid": 1, "ts": 0}]},
    {"traceEvents": [{"name": "e", "ph": "X", "pid": 1, "tid": 1, "ts": -1, "dur": 1}]},
    {"traceEvents": [{"name": "e", "ph": "i", "pid": 1, "tid": 1, "ts": 0}]},
    {"traceEvents": [{"name": "e", "ph": "C", "pid": 1, "tid": 1, "ts": 0,
                      "args": {"v": "x"}}]},
    {"events": []},
])
def test_validate_rejects_what_the_reference_rejects(bad):
    with pytest.raises(ValueError):
        jobs.validate_chrome_trace(bad)
    with pytest.raises(ValueError):
        tobs.validate_chrome_trace(bad)


# --------------------------------------------------------------------------
# traced engine runs against the reference
# --------------------------------------------------------------------------

@pytest.fixture(scope="module")
def traced_runs(graphs):
    """K -> (reference recorder, result; port recorder, result; port
    untraced result)."""
    g, tg = graphs
    out = {}
    for jc in (JCFG, JCFG1):
        jrec, trec = jobs.TraceRecorder(), tobs.TraceRecorder()
        jres = jh.run_hytm(g, jalg.SSSP, source=0, config=jc, obs=jrec)
        tc = _tconfig(jc)
        tres = th.run_hytm(tg, talg.SSSP, source=0, config=tc, obs=trec, device="cpu")
        plain = th.run_hytm(tg, talg.SSSP, source=0, config=tc, device="cpu")
        out[jc.sync_every] = (jrec, jres, trec, tres, plain)
    return out


@pytest.mark.parametrize("K", [4, 1])
def test_traced_run_events_and_metrics_equal_the_reference(traced_runs, K):
    jrec, jres, trec, tres, _ = traced_runs[K]
    _same_events(jrec, trec)
    _same_snapshots(jrec.metrics.snapshot(), trec.metrics.snapshot())
    assert all(isinstance(e.args["warm"], bool) for e in trec.events if e.name == "chunk")
    names = [e.name for e in trec.events]
    assert names.count("iteration") == tres.iterations
    assert names.count("chunk") == (0 if K == 1 else -(-tres.iterations // K))
    assert names[-1] == "hytm_run" and {e.track for e in trec.events} == {"device0"}


@pytest.mark.parametrize("K", [4, 1])
def test_traced_run_reconciles_exactly_and_is_bit_identical(traced_runs, K):
    jrec, jres, trec, tres, plain = traced_runs[K]
    assert jobs.reconcile(jrec, jres)["ok"]
    rep = tobs.reconcile(trec, tres)
    assert rep["ok"], rep
    assert rep["checks"]["iteration_events"]["trace"] == tres.iterations
    np.testing.assert_array_equal(plain.values, tres.values)
    np.testing.assert_array_equal(plain.delta, tres.delta)
    assert plain.iterations == tres.iterations
    assert plain.total_transfer_bytes == tres.total_transfer_bytes
    assert plain.modeled_seconds == tres.modeled_seconds
    for k in plain.history:
        np.testing.assert_array_equal(plain.history[k], tres.history[k])
    # each package's trace validates under the other's schema check
    assert jobs.validate_chrome_trace(tobs.to_chrome_trace(trec)) == \
        tobs.validate_chrome_trace(tobs.to_chrome_trace(trec))
    tobs.validate_chrome_trace(jobs.to_chrome_trace(jrec))


def test_reconcile_detects_a_tampered_total(traced_runs):
    _, _, trec, tres, _ = traced_runs[4]
    for field, bump in (("transfer_bytes", 1.0), ("modeled_seconds", 1e-12),
                        ("iterations", 1)):
        bad = dataclasses.replace(tres)
        key = {"transfer_bytes": "total_transfer_bytes"}.get(field, field)
        setattr(bad, key, getattr(tres, key) + bump)
        rep = tobs.reconcile(trec, bad)
        assert not rep["ok"]
        failed = {k for k, c in rep["checks"].items() if not c["ok"]}
        assert field in failed
    assert not tobs.reconcile(trec, tres, track="nowhere")["ok"]


# --------------------------------------------------------------------------
# run_hytm's host spans and host-sync counter (the port's own)
# --------------------------------------------------------------------------

WALL_EPS = 1e-9  # two subtractions of one origin may round apart by an ulp


def _host_spans(rec) -> list:
    return [e for e in rec.events if e.cat == tobs_export.CAT_HOST]


def _inside(child, parent) -> bool:
    return (parent.wall - WALL_EPS <= child.wall
            and child.wall + child.wall_dur <= parent.wall + parent.wall_dur + WALL_EPS)


@pytest.mark.parametrize("K", [4, 1])
def test_same_events_leaves_out_only_the_host_spans(traced_runs, K):
    jrec, _, trec, _, _ = traced_runs[K]
    host = _host_spans(trec)
    kept = _port_events(trec)
    assert host and len(host) + len(kept) == len(trec.events)
    assert {e.cat for e in host} == {tobs_export.CAT_HOST}
    assert tobs_export.CAT_HOST not in {e.cat for e in kept}
    # every other event is kept, in its order
    assert [e for e in trec.events if e not in host] == kept
    assert {e.cat for e in kept} == {e.cat for e in jrec.events}
    assert tobs_export.CAT_HOST not in {e.cat for e in jrec.events}


@pytest.mark.parametrize("K", [4, 3, 1])
def test_host_spans_nest_in_order(graphs, traced_runs, K):
    if K in traced_runs:
        _, _, trec, tres, _ = traced_runs[K]
    else:
        # 8 iterations: the last chunk of 3 stops early, and the iteration
        # it plans and does not run leaves its plan and fetch to the chunk
        trec = tobs.TraceRecorder()
        tres = th.run_hytm(graphs[1], talg.SSSP, source=0, config=_tconfig(JCFG, sync_every=K),
                           obs=trec, device="cpu")
        assert tres.iterations % K
        assert [(e.name, e.args["site"] if e.name == "sync" else None)
                for e in _host_spans(trec) if e.args["parent"] == "chunk"
                and e.args["it"] == tres.iterations][:2] == [("plan", None), ("sync", "fetch")]
    host = _host_spans(trec)
    run = [e for e in trec.events if e.name == "hytm_run"][0]
    chunks = [e for e in trec.events if e.name == "chunk"]
    iters = [e for e in host if e.name == "iter"]
    assert {e.args["run"] for e in host} == {host[0].args["run"]}
    assert [e.args["it"] for e in iters] == list(range(tres.iterations))
    assert all(e.track == "device0" for e in host)
    parents = {"iter": {"chunk" if K > 1 else "hytm_run"}, "plan": {"iter", "chunk"},
               "sweep": {"iter"}, "finish": {"iter"}, "dispatch": {"sweep"},
               "sync": {"iter", "chunk", "hytm_run"}}
    by_name = {"hytm_run": [run], "chunk": chunks, "iter": iters,
               "sweep": [e for e in host if e.name == "sweep"]}
    for e in host:
        assert e.args["parent"] in parents[e.name], (e.name, e.args)
        assert _inside(e, run)
        # inside one span of its parent's name, of the same iteration below
        # the chunk
        outer = [o for o in by_name[e.args["parent"]]
                 if _inside(e, o) and (o.name not in ("iter", "sweep")
                                       or o.args["it"] == e.args["it"])]
        assert len(outer) == 1, (e.name, e.args)
    for it in iters:
        kids = [e for e in host if e.args["it"] == it.args["it"]
                and e.args["parent"] == "iter"]
        assert [e.name for e in kids if e.name != "sync"] == \
            ["plan", "sweep", "sweep", "finish"]
        assert [e.args["pass"] for e in kids if e.name == "sweep"] == [1, 2]
        ends = [e.wall + e.wall_dur for e in kids]
        assert all(b.wall >= a_end - WALL_EPS for a_end, b in zip(ends, kids[1:]))
    for a, b in zip(iters, iters[1:]):
        assert b.wall >= a.wall + a.wall_dur - WALL_EPS
    for d in (e for e in host if e.name == "dispatch"):
        assert d.wall <= d.args["split"] <= d.wall + d.wall_dur
    # the per-iteration instants sit at their iteration's start
    instants = [e for e in trec.events if e.name == "iteration"]
    assert len(instants) == len(iters)
    for inst, it in zip(instants, iters):
        assert inst.vt == it.args["it"] and _inside(inst, it)


@pytest.fixture(scope="module")
def traced_pagerank(graphs):
    """A traced and an untraced Δ-PageRank run (K=4): SUM consumes every
    partition's Δ in pass 1, so NONE partitions are dispatched too."""
    _, tg = graphs
    cfg = _tconfig(JCFG, cds_mode="delta")
    prog = dataclasses.replace(talg.PAGERANK, tolerance=1e-4)
    rec = tobs.TraceRecorder()
    res = th.run_hytm(tg, prog, None, cfg, obs=rec, device="cpu")
    return rec, res, th.run_hytm(tg, prog, None, cfg, device="cpu")


@pytest.mark.parametrize("case", ["sssp4", "sssp1", "pagerank4"])
def test_pass1_dispatches_are_the_history_rows(traced_runs, traced_pagerank, case):
    if case == "pagerank4":
        rec, res, plain = traced_pagerank
        np.testing.assert_array_equal(plain.values, res.values)
        np.testing.assert_array_equal(plain.delta, res.delta)
        assert plain.iterations == res.iterations
    else:
        _, _, rec, res, _ = traced_runs[int(case[-1])]
    summed = case.startswith("pagerank")
    dispatches = [e for e in _host_spans(rec) if e.name == "dispatch"]
    engines = res.history[KEY_ENGINES]
    for i in range(res.iterations):
        pass1 = [e for e in dispatches if e.args["it"] == i and e.args["pass"] == 1]
        row = engines[i]
        want = {p: ENGINE_NAMES[int(e)].upper() for p, e in enumerate(row)
                if summed or e != NONE}
        assert len(pass1) == len(want)
        assert {e.args["p"]: e.args["engine"] for e in pass1} == want
        for e in pass1:
            assert (e.args["edges"] == 0) == (e.args["engine"] == "NONE")
        pass2 = [e for e in dispatches if e.args["it"] == i and e.args["pass"] == 2]
        assert all(e.args["engine"] == want[e.args["p"]] != "NONE" for e in pass2)
    if summed:
        assert any(e.args["engine"] == "NONE" for e in dispatches)


def _syncs_of(run) -> tuple[dict, int, object]:
    """``hytm.host_syncs`` and ``hytm.iterations_run`` moved by ``run()``."""
    before, iters = dict(th.host_syncs), th.iterations_run
    res = run()
    return ({k: th.host_syncs[k] - before[k] for k in th.SYNC_SITES},
            th.iterations_run - iters, res)


@pytest.mark.parametrize("K,autotune", [(4, False), (4, True), (3, False), (1, False)])
def test_host_syncs_count_every_read_by_site(graphs, K, autotune):
    _, tg = graphs
    cfg = _tconfig(JCFG, sync_every=K, autotune=autotune)
    got, iters, res = _syncs_of(
        lambda: th.run_hytm(tg, talg.SSSP, source=0, config=cfg, device="cpu"))
    n = res.iterations
    keys = len(HISTORY_KEYS)
    if K > 1:
        chunks = -(-n // K)
        # the chunk that stops early fetches once more and finds no frontier
        want = {"fetch": n + (n % K != 0), "drain": keys * chunks, "active": chunks,
                "calib": chunks if autotune else 0, "history": 0}
    else:
        want = {"fetch": n, "drain": 0, "active": n, "calib": 0, "history": keys}
    assert got == {**want, "copy_out": 2} and iters == n
    # a traced run counts the same reads, each a sync span of its site
    rec = tobs.TraceRecorder()
    traced, _, _ = _syncs_of(lambda: th.run_hytm(tg, talg.SSSP, source=0, config=cfg,
                                                 obs=rec, device="cpu"))
    assert traced == got
    spans = {k: 0 for k in th.SYNC_SITES}
    for e in _host_spans(rec):
        if e.name == "sync":
            spans[e.args["site"]] += 1
    assert spans == got and rec.dropped == 0


def test_program_spans_land_on_the_profilers_clock():
    """A span of the recorder (``time.monotonic()``), moved by the clock
    offset, holds the CPU op the profiler saw run inside it."""
    import time

    import torch
    from torch.profiler import ProfilerActivity, profile

    rec = tobs.TraceRecorder()
    off0 = tobs_device.clock_offset_ns()
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        with rec.timed("work", cat=tobs_export.CAT_HOST):
            time.sleep(0.002)
            torch.ones(1 << 16).mul_(3.0)
            time.sleep(0.002)
    off1 = tobs_device.clock_offset_ns()
    (span,) = tobs_device.program_spans(rec, (off0 + off1) // 2)
    (op,) = [e for e in prof.profiler.kineto_results.events() if e.name() == "aten::mul_"]
    start, end = op.start_ns(), op.start_ns() + op.duration_ns()
    # the op ran in the middle of the span, ~2 ms from either end
    assert start - span.start_ns > 1_000_000 and span.end_ns - end > 1_000_000
    rec.dropped = 1
    assert tobs_device.program_spans(rec, off0) is None


def test_charge_splits_device_and_idle_time_by_launching_span():
    Span, Op = tobs_device.ProgramSpan, tobs_device.DeviceOp
    spans = [Span(0, 100, "hytm_run", {}), Span(10, 90, "iter", {}),
             Span(20, 80, "sweep", {"pass": 1}),
             Span(30, 60, "dispatch", {"engine": "FILTER", "edges": 7, "split": 45}),
             Span(62, 70, "dispatch", {"engine": "NONE", "edges": 0, "split": 66}),
             Span(85, 88, "sync", {"site": "fetch"})]
    ops = [Op("k", 40, 50, 35), Op("k", 55, 70, 50), Op("copy", 86, 87, 86),
           Op("k", 95, 96, None), Op("k", 5, 8, 5), Op("k", 72, 75, 67)]
    got = tobs_device.charge(ops, spans, 0, 100)
    ns = 1e-9
    assert got.device_s == pytest.approx({
        "hytm_run": 3 * ns, "dispatch FILTER relax": 10 * ns,
        "dispatch FILTER apply": 15 * ns, "dispatch NONE apply": 3 * ns,
        "sync fetch": 1 * ns, "launch not seen": 1 * ns})
    # each gap goes to the span that launched the op ending it
    assert got.idle_s == pytest.approx({
        "hytm_run": 5 * ns, "dispatch FILTER relax": 32 * ns, "dispatch FILTER apply": 5 * ns,
        "dispatch NONE apply": 2 * ns, "sync fetch": 11 * ns, "launch not seen": 8 * ns,
        "after the last op": 4 * ns})
    assert got.busy_s == pytest.approx(33 * ns)
    assert got.busy_s + sum(got.idle_s.values()) == pytest.approx(got.window_s)
    # a window cut at 52 keeps the ops that overlap it, whole
    assert tobs_device.charge(ops, spans, 0, 52).busy_s == pytest.approx(13 * ns)


def test_null_recorder_runs_as_none(graphs):
    _, tg = graphs
    tc = _tconfig(JCFG)
    a = th.run_hytm(tg, talg.SSSP, source=0, config=tc, device="cpu")
    b = th.run_hytm(tg, talg.SSSP, source=0, config=tc, obs=tobs.NullRecorder(),
                    device="cpu")
    np.testing.assert_array_equal(a.values, b.values)
    assert a.iterations == b.iterations and a.total_transfer_bytes == b.total_transfer_bytes


def test_traced_run_incremental_equals_the_reference(graphs):
    g, tg = graphs
    jdc = jd.DeltaCSR(g, JCFG)
    tdc = tstream.DeltaCSR(tg, _tconfig(JCFG), device="cpu")
    cold = jh.run_hytm(None, jalg.SSSP, source=0, config=JCFG,
                       runtime=jdc.runtime_for(jalg.SSSP))
    ja = jdc.apply(jd.random_batch(jdc, np.random.default_rng(4), n_insert=8, n_delete=8))
    ta = tdc.apply(tstream.random_batch(tdc, np.random.default_rng(4), n_insert=8,
                                        n_delete=8))
    jrec, trec = jobs.TraceRecorder(), tobs.TraceRecorder()
    jw = ji.run_incremental(jdc, jalg.SSSP, [ja], cold.values, cold.delta, source=0,
                            obs=jrec)
    tw = tstream.run_incremental(tdc, talg.SSSP, [ta], cold.values, cold.delta, source=0,
                                 obs=trec)
    np.testing.assert_array_equal(jw.values, tw.values)
    _same_events(jrec, trec)
    _same_snapshots(jrec.metrics.snapshot(), trec.metrics.snapshot())
    assert tobs.reconcile(trec, tw)["ok"]


def test_calibrator_records_each_folded_observation(graphs):
    g, tg = graphs
    jrec, trec = jobs.TraceRecorder(), tobs.TraceRecorder()
    jcal, tcal = JCalibrator(obs=jrec), OnlineCalibrator(obs=trec)
    rng = np.random.default_rng(2)
    for _ in range(6):
        modeled, secs = rng.random(3), float(rng.random())
        jcal.update(modeled, secs)
        tcal.update(modeled, secs)
    tcal.update(np.zeros(3), 1.0)  # ignored: records nothing
    jcal.update(np.zeros(3), 1.0)
    _same_events(jrec, trec)
    # the same (modeled, measured) stream: the corrections are equal too
    for a, b in zip(jrec.events, trec.events):
        assert a.args["correction"] == b.args["correction"]
    assert jrec.metrics.snapshot() == trec.metrics.snapshot()
    assert trec.metrics.counter("autotune.updates").total() == tcal.n_updates == 6
    # a traced autotune run folds one observation a warm chunk
    rec = tobs.TraceRecorder()
    cal = OnlineCalibrator(obs=rec)
    res = th.run_hytm(tg, talg.SSSP, source=0, config=_tconfig(JCFG, autotune=True),
                      calibrator=cal, obs=rec, device="cpu")
    assert [e.name for e in rec.events].count("correction_update") == cal.n_updates
    assert tobs.reconcile(rec, res)["ok"]


# --------------------------------------------------------------------------
# traced serving against the reference
# --------------------------------------------------------------------------

def test_traced_graph_service_equals_the_reference(graphs):
    g, tg = graphs
    budget = 3 * 9 * g.n_nodes
    jrec, trec = jobs.TraceRecorder(), tobs.TraceRecorder()
    js = jstream.GraphService(g, JCFG, max_lanes=2, obs=jrec, device_budget_bytes=budget)
    ts = tstream.GraphService(tg, _tconfig(JCFG), max_lanes=2, obs=trec,
                              device_budget_bytes=budget, device="cpu")
    sources = [0, 1, 2, 3, 4]
    jr, tr = js.query(jalg.SSSP, sources), ts.query(talg.SSSP, sources)
    for a, b in zip(jr, tr):
        np.testing.assert_array_equal(a.values, b.values)
    # the cache events name their (program, source) key by repr
    _same_events(jrec, trec, skip_args={"key"})
    tracks = {e.track for e in trec.events}
    assert {"scheduler", "cache", "tenant:_local"} == tracks == {e.track for e in jrec.events}
    jm, tm = jrec.metrics.snapshot(), trec.metrics.snapshot()
    assert list(jm) == list(tm)
    assert any(n.startswith("admission.") for n in tm)
    assert any(n.startswith("cache.") for n in tm)
    for name in tm:
        assert jm[name] == tm[name], name
    assert tm["serve.requests"]["total"] == len(sources)
    tobs.validate_chrome_trace(tobs.to_chrome_trace(trec))
    jobs.validate_chrome_trace(tobs.to_chrome_trace(trec))
    # a repeat is served from the cache: hits recorded, no new lane work
    n_events = len(trec.events)
    js.query(jalg.SSSP, sources[:2])
    ts.query(talg.SSSP, sources[:2])
    assert len(trec.events) == n_events  # the front end peeks; nothing is counted
    _same_events(jrec, trec, skip_args={"key"})


def test_graph_service_obs_threads_into_every_consumer(graphs):
    _, tg = graphs
    rec = tobs.TraceRecorder()
    svc = tstream.GraphService(tg, _tconfig(JCFG, autotune=True), max_lanes=2, obs=rec,
                               device="cpu")
    assert svc.cache.obs is rec and svc._calibrator.obs is rec and svc.obs is rec
    pr = dataclasses.replace(talg.PAGERANK, tolerance=1e-6)
    svc.query(pr, None)
    svc.update(tstream.random_batch(svc.dcsr, np.random.default_rng(1), n_insert=4,
                                    n_delete=4))
    inc = svc.query(pr, None)[0]
    assert inc.mode == "incremental"
    runs = [e for e in rec.events if e.name == "hytm_run"]
    assert len(runs) == 2 and {e.track for e in runs} == {"device0"}
    assert any(e.name == "correction_update" for e in rec.events)
    assert runs[-1].args["iterations"] == inc.iterations
