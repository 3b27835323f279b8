"""The port's ``GraphService`` (``repro_torch.stream.service``) against the
reference's on the same graphs, queries and update batches.

Contract: every ``QueryResult`` equals the reference's — values bit for
bit for SSSP/BFS/CC/k-core and within 1e-5 for PageRank/Δ-PPR, modes,
iterations and ``cache_hit`` equal — and so do ``ServiceStats``,
``SchedulerStats``, ``CacheStats`` and the retained report log; the
port's answers also equal its own solo runs (tests/test_stream_service.py
holds the reference the same way).  A three-tenant ``pump`` under quotas
and a byte budget that forces spills completes in the reference's order.
The reference runs its default ``use_kernels="auto"`` (off on the CPU).
"""

import dataclasses

import numpy as np
import pytest
import torch

from repro import serve as jserve
from repro import stream as jstream
from repro.core import hytm as jh
from repro.graph import algorithms as jalg
from repro.graph import generators as jgen
from repro_torch import convert
from repro_torch import serve as tserve
from repro_torch import stream as tstream
from repro_torch.core import hytm as th
from repro_torch.graph import algorithms as talg

SUM_ATOL = 1e-5
JCFG = jh.HyTMConfig(n_partitions=8)


def _tconfig(cfg: jh.HyTMConfig, **kw) -> th.HyTMConfig:
    fields = {f.name for f in dataclasses.fields(th.HyTMConfig)} - {"link", "ici_link"}
    vals = {k: getattr(cfg, k) for k in fields}
    vals.update(kw)
    return th.HyTMConfig(link=convert.link_model(dataclasses.asdict(cfg.link)), **vals)


TCFG = _tconfig(JCFG)


def _programs(name, **kw):
    return (dataclasses.replace(jalg.ALGORITHMS[name], **kw),
            dataclasses.replace(talg.ALGORITHMS[name], **kw))


def _service(seed=13, n=400, m=3200, lanes=3, **kw):
    g = jgen.rmat_graph(n, m, seed=seed)
    tg = convert.csr_graph(g.indptr, g.indices, g.weights)
    return (jstream.GraphService(g, JCFG, max_lanes=lanes, **kw),
            tstream.GraphService(tg, TCFG, max_lanes=lanes, device="cpu", **kw))


def _port_batch(b):
    return tstream.EdgeBatch(b.op, b.src, b.dst, b.weight)


def _update(jsvc, tsvc, batch):
    """The same batch through both services; equal reports' versions."""
    a = jsvc.update(batch)
    b = tsvc.update(_port_batch(batch))
    assert a.version == b.version
    return a


def _query(jsvc, tsvc, jprog, tprog, sources, exact=True):
    """Both services answer; every QueryResult field agrees."""
    jres = jsvc.query(jprog, sources)
    tres = tsvc.query(tprog, sources)
    assert len(jres) == len(tres)
    for a, b in zip(jres, tres):
        assert (a.source, a.mode, a.iterations, a.cache_hit) == \
            (b.source, b.mode, b.iterations, b.cache_hit)
        assert isinstance(b.values, np.ndarray) and b.values.dtype == np.float32
        if exact:
            np.testing.assert_array_equal(np.asarray(a.values), b.values)
        else:
            np.testing.assert_allclose(np.asarray(a.values), b.values, rtol=0, atol=SUM_ATOL)
    return tres


def _same_state(jsvc, tsvc):
    assert dataclasses.asdict(jsvc.stats) == dataclasses.asdict(tsvc.stats)
    assert dataclasses.asdict(jsvc.scheduler.stats) == dataclasses.asdict(tsvc.scheduler.stats)
    assert jsvc.cache.stats.as_dict() == tsvc.cache.stats.as_dict()
    assert [r.version for r in jsvc._reports] == [r.version for r in tsvc._reports]
    assert {(k[0].name, k[1]): (e.version, e.tier) for k, e in jsvc.cache.items()} == \
        {(k[0].name, k[1]): (e.version, e.tier) for k, e in tsvc.cache.items()}


def _solo(tsvc, prog, s):
    return th.run_hytm(None, prog, s, TCFG, runtime=tsvc.dcsr.runtime_for(prog))


def test_batched_queries_match_independent_runs():
    """5 sources over 3 lanes == the reference's lanes == solo runs."""
    jsvc, tsvc = _service()
    sources = [0, 11, 42, 123, 250]
    res = _query(jsvc, tsvc, jalg.SSSP, talg.SSSP, sources)
    assert [r.source for r in res] == sources
    for s, r in zip(sources, res):
        np.testing.assert_array_equal(r.values, _solo(tsvc, talg.SSSP, s).values)
        assert r.mode == "batched" and not r.cache_hit
    _same_state(jsvc, tsvc)


def test_cached_repeat_is_zero_iterations():
    jsvc, tsvc = _service()
    first = _query(jsvc, tsvc, jalg.BFS, talg.BFS, [0, 7])
    assert all(r.iterations > 0 for r in first)
    again = _query(jsvc, tsvc, jalg.BFS, talg.BFS, [7, 0])
    for r in again:
        assert r.cache_hit and r.iterations == 0 and r.mode == "cache"
    for a, b in zip(first, reversed(again)):
        np.testing.assert_array_equal(a.values, b.values)
    assert tsvc.stats.n_cache_hits == 2
    _same_state(jsvc, tsvc)


def test_duplicate_sources_share_one_computation():
    jsvc, tsvc = _service()
    res = _query(jsvc, tsvc, jalg.SSSP, talg.SSSP, [5, 5, 5])
    np.testing.assert_array_equal(res[0].values, res[2].values)
    assert tsvc.stats.n_full == 1
    _same_state(jsvc, tsvc)


def test_update_invalidates_and_incremental_matches():
    jsvc, tsvc = _service()
    sources = [0, 33]
    _query(jsvc, tsvc, jalg.SSSP, talg.SSSP, sources)
    rng = np.random.default_rng(3)
    rep = _update(jsvc, tsvc, jstream.random_batch(jsvc.dcsr, rng, n_insert=10, n_delete=10))
    assert tsvc.version == 1 and rep.version == 1
    post = _query(jsvc, tsvc, jalg.SSSP, talg.SSSP, sources)
    for s, r in zip(sources, post):
        assert r.mode == "incremental" and not r.cache_hit
        np.testing.assert_array_equal(r.values, _solo(tsvc, talg.SSSP, s).values)
    again = _query(jsvc, tsvc, jalg.SSSP, talg.SSSP, sources)
    assert all(r.cache_hit for r in again)
    _same_state(jsvc, tsvc)


def test_accumulative_program_is_global_and_incremental():
    jpr, tpr = _programs("pagerank", tolerance=1e-7)
    jsvc, tsvc = _service()
    r1 = _query(jsvc, tsvc, jpr, tpr, None, exact=False)[0]
    r2 = _query(jsvc, tsvc, jpr, tpr, [17], exact=False)[0]
    assert r2.cache_hit and r2.iterations == 0
    np.testing.assert_array_equal(r1.values, r2.values)
    rng = np.random.default_rng(5)
    _update(jsvc, tsvc, jstream.random_batch(jsvc.dcsr, rng, n_insert=6, n_delete=6))
    r3 = _query(jsvc, tsvc, jpr, tpr, None, exact=False)[0]
    assert r3.mode == "incremental"
    fs = _solo(tsvc, tpr, None)
    assert np.max(np.abs(r3.values - fs.values)) < 1e-3
    assert r3.iterations < fs.iterations
    _same_state(jsvc, tsvc)


def test_program_variants_do_not_share_cache_entries():
    """The cache key is the frozen program: tolerance variants never serve
    each other's converged results."""
    jsvc, tsvc = _service()
    loose, tight = _programs("pagerank", tolerance=1e-3), _programs("pagerank", tolerance=1e-7)
    r_loose = _query(jsvc, tsvc, *loose, None, exact=False)[0]
    r_tight = _query(jsvc, tsvc, *tight, None, exact=False)[0]
    assert not r_tight.cache_hit and r_tight.iterations > r_loose.iterations
    assert _query(jsvc, tsvc, *loose, None, exact=False)[0].cache_hit
    assert _query(jsvc, tsvc, *tight, None, exact=False)[0].cache_hit
    assert len(tsvc.cache) == 2
    _same_state(jsvc, tsvc)


def test_reports_are_pruned_once_warm_states_catch_up():
    jsvc, tsvc = _service()
    rng = np.random.default_rng(7)
    _query(jsvc, tsvc, jalg.SSSP, talg.SSSP, [0])
    for _ in range(4):
        _update(jsvc, tsvc, jstream.random_batch(jsvc.dcsr, rng, n_insert=4, n_delete=4))
    assert len(tsvc._reports) == 4
    _query(jsvc, tsvc, jalg.SSSP, talg.SSSP, [0])
    assert len(tsvc._reports) == 0
    _same_state(jsvc, tsvc)


def test_abandoned_entry_cannot_grow_report_memory():
    """Past ``max_reports`` the oldest reports drop and entries too stale
    to replay the retained suffix are evicted, in both packages alike."""
    jsvc, tsvc = _service(seed=8, n=300, m=2400, lanes=2, max_reports=4)
    _query(jsvc, tsvc, jalg.SSSP, talg.SSSP, [0, 7])
    rng = np.random.default_rng(8)
    for _ in range(3):
        _update(jsvc, tsvc, jstream.random_batch(jsvc.dcsr, rng, n_insert=3, n_delete=3))
    assert _query(jsvc, tsvc, jalg.SSSP, talg.SSSP, [7])[0].mode == "incremental"
    for _ in range(4):
        _update(jsvc, tsvc, jstream.random_batch(jsvc.dcsr, rng, n_insert=3, n_delete=3))
    assert len(tsvc._reports) <= 4
    assert (talg.SSSP, 0) not in tsvc.cache and (talg.SSSP, 7) in tsvc.cache
    q7 = _query(jsvc, tsvc, jalg.SSSP, talg.SSSP, [7])[0]
    q0 = _query(jsvc, tsvc, jalg.SSSP, talg.SSSP, [0])[0]
    assert q7.mode == "incremental" and q0.mode == "batched" and not q0.cache_hit
    for s, r in ((7, q7), (0, q0)):
        np.testing.assert_array_equal(r.values, _solo(tsvc, talg.SSSP, s).values)
    _same_state(jsvc, tsvc)


def test_incremental_disabled_falls_back_to_full():
    jsvc, tsvc = _service(seed=2, n=300, m=2400, lanes=2, incremental=False)
    _query(jsvc, tsvc, jalg.SSSP, talg.SSSP, [0])
    _update(jsvc, tsvc, jstream.EdgeBatch.inserts([0], [5], [2.0]))
    r = _query(jsvc, tsvc, jalg.SSSP, talg.SSSP, [0])[0]
    assert r.mode == "batched"
    np.testing.assert_array_equal(r.values, _solo(tsvc, talg.SSSP, 0).values)
    _same_state(jsvc, tsvc)


def test_kcore_and_ppr_route_like_the_reference():
    """k-core is global (one run, keyed ``None``, bit for bit); Δ-PPR keys
    per source and rides the lanes (within 1e-5), warm after an update."""
    jsvc, tsvc = _service()
    jk, tk = _programs("kcore")
    res = _query(jsvc, tsvc, jk, tk, [3])
    assert res[0].source is None and res[0].mode == "batched"
    jp, tp = _programs("ppr", tolerance=1e-7)
    _query(jsvc, tsvc, jp, tp, [0, 11, 42, 9], exact=False)
    _update(jsvc, tsvc, jstream.random_batch(jsvc.dcsr, np.random.default_rng(1),
                                             n_insert=5, n_delete=5))
    post = _query(jsvc, tsvc, jp, tp, [0, 11], exact=False)
    assert all(r.mode == "incremental" for r in post)
    _same_state(jsvc, tsvc)


def test_three_tenant_pump_under_quotas_and_a_spilling_budget():
    """A three-tenant trace of SSSP and BFS requests under per-tenant quotas
    and a byte budget of 2 lanes plus one cached state (the cache spills),
    before and after an update (warm lanes through ``incremental_state``):
    completion order, modes, iterations and virtual clocks equal the
    reference's; every answer equals its solo run; quotas and the budget
    hold."""
    n = 300
    budget = 2 * 9 * n + 8 * n
    jsvc, tsvc = _service(seed=21, n=n, m=2400, lanes=2, device_budget_bytes=budget)
    quotas = {"gold": 2, "silver": 1, "bronze": 1}
    trace = [("gold", "sssp", 0), ("silver", "bfs", 3), ("bronze", "sssp", 77),
             ("gold", "bfs", 5), ("gold", "sssp", 210), ("silver", "sssp", 9),
             ("bronze", "bfs", 11), ("gold", "sssp", 0), ("silver", "bfs", 3)]
    peaks = ({}, {})
    for round_ in range(2):
        served = []
        for k, (svc, Queue, Request, alg, Sched) in enumerate((
                (jsvc, jserve.RequestQueue, jserve.Request, jalg, jserve.LaneScheduler),
                (tsvc, tserve.RequestQueue, tserve.Request, talg, tserve.LaneScheduler))):
            q = Queue(quota=2, tenant_quotas=quotas)
            for i, (t, name, s) in enumerate(trace):
                q.submit(Request(tenant=t, program=alg.ALGORITHMS[name], source=s,
                                 deadline=float(i % 4), arrival=i))
            orig = Sched._dispatch

            def spying(self, *a, _orig=orig, _peak=peaks[k], **kw):
                for t, c in self.in_flight.items():
                    _peak[t] = max(_peak.get(t, 0), c)
                return _orig(self, *a, **kw)

            Sched._dispatch = spying
            try:
                served.append(svc.scheduler.pump(q))
            finally:
                Sched._dispatch = orig
            assert q.stats.quota_violations == 0 and q.stats.rejected == 0
            assert svc.scheduler.stats.max_device_bytes <= budget
        js, ts_ = served
        assert [(r.request.tenant, r.request.source, r.request.program.name, r.mode,
                 r.iterations, r.done_vt) for r in js] == \
            [(r.request.tenant, r.request.source, r.request.program.name, r.mode,
              r.iterations, r.done_vt) for r in ts_]
        for a, b in zip(js, ts_):
            np.testing.assert_array_equal(np.asarray(a.values), b.values)
            np.testing.assert_array_equal(
                b.values, _solo(tsvc, b.request.program, b.request.source).values)
        if round_ == 0:
            _update(jsvc, tsvc, jstream.random_batch(jsvc.dcsr, np.random.default_rng(4),
                                                     n_insert=6, n_delete=6))
        else:
            assert any(r.mode == "incremental" for r in ts_)
    assert peaks[0] == peaks[1]
    assert all(peaks[1][t] <= quotas[t] for t in peaks[1])
    assert tsvc.cache.stats.spills > 0
    _same_state(jsvc, tsvc)


def test_backfill_into_a_cached_slot_leaves_the_entry_alone():
    """A lane's result is cached, then the next request is backfilled into
    the same row of the (Q, n) state in place: the cache entry still holds
    the first result (``WarmCache.put`` owns its tensors)."""
    _, tsvc = _service(lanes=1)
    sources = [0, 11, 42]
    res = tsvc.query(talg.SSSP, sources)
    assert tsvc.scheduler.stats.backfills == 2
    for s, r in zip(sources, res):
        entry = tsvc.cache.peek((talg.SSSP, s))
        assert entry.tier == "device" and isinstance(entry.values, torch.Tensor)
        np.testing.assert_array_equal(entry.host_values(), r.values)
        np.testing.assert_array_equal(r.values, _solo(tsvc, talg.SSSP, s).values)
    assert not np.array_equal(res[0].values, res[1].values)


def test_service_runs_on_the_card_unless_asked_for_the_cpu():
    g = jgen.rmat_graph(100, 600, seed=1)
    tg = convert.csr_graph(g.indptr, g.indices, g.weights)
    assert tstream.GraphService(tg, TCFG, device="cpu").device.type == "cpu"
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="no CUDA device"):
            tstream.GraphService(tg, TCFG)
