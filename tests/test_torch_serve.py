"""The port's serving stack (``repro_torch.serve``, the lane-batched chunk
``core.hytm.hytm_batched_chunk`` and its lane kernels' plain versions)
against ``repro.serve`` on the same inputs.

Contract:
* the queue admits, defers and rejects the same requests in the same
  order, with equal ``QueueStats``;
* every lane's answer equals its solo ``run_hytm`` in the port and the
  reference's lane: bit for bit for MIN programs and k-core, SUM within
  1e-5 of the reference (the port's lane equals its own solo run bit for
  bit on the CPU);
* ``SchedulerStats``, ``CacheStats``, iteration counts, modes, the crc32
  integers and ``pump``'s completion order equal the reference's;
* quotas and the device byte budget are never exceeded;
* a lane-batched iteration issues at most 2·P·3 relax calls, at Q = 1 and
  Q = 8 alike.
The reference runs its default ``use_kernels="auto"`` (off on the CPU);
the port runs its oracle engines and, where named, its kernel wrappers
(plain bodies on the CPU).
"""

import dataclasses
import json

import numpy as np
import pytest
import torch
from hypothesis import given, settings
from hypothesis import strategies as st

from repro import serve as jserve
from repro import stream as jstream
from repro.core import hytm as jh
from repro.graph import algorithms as jalg
from repro.graph import generators as jgen
from repro_torch import convert
from repro_torch import serve as tserve
from repro_torch import stream as tstream
from repro_torch.core import engines as teng
from repro_torch.core import hytm as th
from repro_torch.graph import algorithms as talg
from repro_torch.kernels.frontier_compact.ref import (
    frontier_compact_lanes_ref,
    frontier_compact_ref,
)
from repro_torch.kernels.hyb_gather.ops import hyb_gather
from repro_torch.kernels.segment_spmm.ops import segment_spmm_lanes
from repro_torch.kernels.segment_spmm.ref import segment_spmm_lanes_ref, segment_spmm_ref
from repro_torch.launch import serve_graph
from repro_torch.launch.mesh import GraphMesh

SUM_ATOL = 1e-5
JCFG = jh.HyTMConfig(n_partitions=8, sync_every=4)


def _tconfig(cfg: jh.HyTMConfig, **kw) -> th.HyTMConfig:
    fields = {f.name for f in dataclasses.fields(th.HyTMConfig)} - {"link", "ici_link"}
    vals = {k: getattr(cfg, k) for k in fields}
    vals.update(kw)
    return th.HyTMConfig(link=convert.link_model(dataclasses.asdict(cfg.link)), **vals)


TCFG = _tconfig(JCFG)


def _programs(name, **kw):
    """The same program in both packages (``dataclasses.replace`` variants)."""
    return (dataclasses.replace(jalg.ALGORITHMS[name], **kw),
            dataclasses.replace(talg.ALGORITHMS[name], **kw))


def _graphs(n, m, seed):
    g = jgen.rmat_graph(n, m, seed=seed)
    return g, convert.csr_graph(g.indptr, g.indices, g.weights)


def _services(n, m, seed, cfg=JCFG, **kw):
    g, tg = _graphs(n, m, seed)
    return (jstream.GraphService(g, cfg, **kw),
            tstream.GraphService(tg, _tconfig(cfg), device="cpu", **kw))


def _port_batch(b):
    return tstream.EdgeBatch(b.op, b.src, b.dst, b.weight)


def _same_values(a, b, exact=True):
    a, b = np.asarray(a), np.asarray(b)
    assert a.shape == b.shape and a.dtype == b.dtype
    if exact:
        np.testing.assert_array_equal(a, b)
    else:
        np.testing.assert_allclose(a, b, rtol=0, atol=SUM_ATOL)


def _same_served(js, ts_, exact=True):
    """Two ``pump`` outputs: the same requests in the same completion order,
    with equal modes, iterations, virtual clocks and values."""
    assert [(r.request.tenant, r.request.source, r.mode, r.iterations, r.submit_vt, r.done_vt)
            for r in js] == \
        [(r.request.tenant, r.request.source, r.mode, r.iterations, r.submit_vt, r.done_vt)
         for r in ts_]
    for a, b in zip(js, ts_):
        if a.values is None:
            assert b.values is None
        else:
            _same_values(a.values, b.values, exact)


def _same_stats(jsvc, tsvc):
    assert dataclasses.asdict(jsvc.stats) == dataclasses.asdict(tsvc.stats)
    assert dataclasses.asdict(jsvc.scheduler.stats) == dataclasses.asdict(tsvc.scheduler.stats)
    assert jsvc.cache.stats.as_dict() == tsvc.cache.stats.as_dict()


# --------------------------------------------------------------------------
# queue: quotas + deadline order (no engine)
# --------------------------------------------------------------------------

def _request_pairs(specs):
    """One Request per (tenant, source, deadline) in each package, arrival
    numbers equal (both sequence counters start wherever they are)."""
    js = [jserve.Request(tenant=t, program=jalg.SSSP, source=s, deadline=d, arrival=i)
          for i, (t, s, d) in enumerate(specs)]
    ts_ = [tserve.Request(tenant=t, program=talg.SSSP, source=s, deadline=d, arrival=i)
           for i, (t, s, d) in enumerate(specs)]
    return js, ts_


@settings(max_examples=30, deadline=None)
@given(
    n_requests=st.integers(min_value=1, max_value=24),
    n_tenants=st.integers(min_value=1, max_value=4),
    quota=st.integers(min_value=0, max_value=3),
    n_slots=st.integers(min_value=1, max_value=8),
    seed=st.integers(min_value=0, max_value=999),
)
def test_admission_respects_quotas(n_requests, n_tenants, quota, n_slots, seed):
    """Both queues admit, defer and reject the same requests, pass by pass;
    no tenant ever exceeds its quota; zero-quota tenants are rejected."""
    rng = np.random.default_rng(seed)
    specs = [(f"t{rng.integers(n_tenants)}", int(rng.integers(100)),
              float(rng.integers(1000))) for _ in range(n_requests)]
    jreqs, treqs = _request_pairs(specs)
    out = []
    for Queue, reqs, prog in ((jserve.RequestQueue, jreqs, jalg.SSSP),
                              (tserve.RequestQueue, treqs, talg.SSSP)):
        q = Queue(quota=quota)
        for r in reqs:
            q.submit(r)
        in_flight, rejected, passes = {}, [], []
        while q:
            before = len(q)
            admitted = q.admit(n_slots, in_flight, program=prog, on_reject=rejected.append)
            passes.append([r.arrival for r in admitted])
            for r in admitted:
                in_flight[r.tenant] = in_flight.get(r.tenant, 0) + 1
                assert in_flight[r.tenant] <= quota or quota == 0
            if len(q) == before:
                break
            for t in list(in_flight):
                in_flight[t] -= 1
                if in_flight[t] == 0:
                    del in_flight[t]
        assert q.stats.quota_violations == 0
        assert len(rejected) == (n_requests if quota == 0 else 0)
        out.append((passes, [r.arrival for r in rejected], dataclasses.asdict(q.stats)))
    assert out[0] == out[1]


@settings(max_examples=30, deadline=None)
@given(
    n_requests=st.integers(min_value=1, max_value=24),
    n_slots=st.integers(min_value=1, max_value=8),
    seed=st.integers(min_value=0, max_value=999),
)
def test_admission_is_deadline_ordered(n_requests, n_slots, seed):
    """The admitted prefix is the (deadline, arrival)-sorted head of the
    pending set, in both packages alike."""
    rng = np.random.default_rng(seed)
    specs = [("t", i, float(rng.integers(10))) for i in range(n_requests)]
    jreqs, treqs = _request_pairs(specs)
    got = []
    for Queue, reqs in ((jserve.RequestQueue, jreqs), (tserve.RequestQueue, treqs)):
        q = Queue()
        for r in reqs:
            q.submit(r)
        admitted = q.admit(n_slots, {})
        expected = sorted(reqs, key=lambda r: (r.deadline, r.arrival))
        assert admitted == expected[:min(n_slots, n_requests)]
        got.append([r.arrival for r in admitted])
    assert got[0] == got[1]


def test_admission_rejects_unfittable_and_defers_over_budget():
    stats = []
    for Queue, Request, prog in ((jserve.RequestQueue, jserve.Request, jalg.SSSP),
                                 (tserve.RequestQueue, tserve.Request, talg.SSSP)):
        q = Queue()
        for i in range(3):
            q.submit(Request(tenant="t", program=prog, source=i))
        rejected = []
        out = q.admit(8, {}, bytes_per_lane=100, total_budget=50, on_reject=rejected.append)
        assert out == [] and len(rejected) == 3 and len(q) == 0
        for i in range(3):
            q.submit(Request(tenant="t", program=prog, source=i))
        out = q.admit(8, {}, free_bytes=150, bytes_per_lane=100, total_budget=1000)
        assert len(out) == 1 and len(q) == 2
        assert q.stats.deferred == 2
        stats.append(dataclasses.asdict(q.stats))
    assert stats[0] == stats[1]


# --------------------------------------------------------------------------
# scheduler: static buckets, backfill, pump
# --------------------------------------------------------------------------

def test_lane_buckets_one_compile_per_bucket():
    """Every request count 1..5 through a max_lanes=4 service pads to the
    static buckets {1, 2, 4}: the port dispatches at most one chunk
    signature per bucket (the reference's one compile per bucket), and
    every answer equals the reference's lane and the port's solo run."""
    jsvc, tsvc = _services(300, 2400, 13, max_lanes=4)
    assert tsvc.scheduler.buckets == jsvc.scheduler.buckets == (1, 2, 4)
    seen0 = {s for s in th._WARM_SIGNATURES if s[0] == "serve-lanes"}
    rt = tsvc.dcsr.runtime_for(talg.SSSP)
    for sources in ([0], [1, 2], [3, 4, 5], [6, 7, 8, 9], [10, 11, 12, 13, 14]):
        jres = jsvc.query(jalg.SSSP, sources)
        tres = tsvc.query(talg.SSSP, sources)
        for s, a, b in zip(sources, jres, tres):
            _same_values(a.values, b.values)
            assert (a.mode, a.iterations) == (b.mode, b.iterations)
            _same_values(b.values, th.run_hytm(None, talg.SSSP, s, TCFG, runtime=rt).values)
    signatures = {s for s in th._WARM_SIGNATURES if s[0] == "serve-lanes"} - seen0
    assert {s[4] for s in signatures} <= {1, 2, 4}
    assert len({s[4] for s in signatures}) <= len(tsvc.scheduler.buckets)
    _same_stats(jsvc, tsvc)


@pytest.mark.parametrize("use_kernels", [False, True])
def test_backfill_never_changes_results(use_kernels):
    """7 sources through 2 lanes: converged lanes are backfilled mid-flight,
    and every lane's result equals the reference's and its solo run."""
    g, tg = _graphs(400, 3200, 17)
    jsvc = jstream.GraphService(g, JCFG, max_lanes=2)
    tcfg = _tconfig(JCFG, use_kernels=use_kernels)
    tsvc = tstream.GraphService(tg, tcfg, max_lanes=2, device="cpu")
    sources = [0, 11, 42, 123, 250, 301, 77]
    jres = jsvc.query(jalg.SSSP, sources)
    tres = tsvc.query(talg.SSSP, sources)
    assert tsvc.scheduler.stats.backfills > 0
    rt = tsvc.dcsr.runtime_for(talg.SSSP)
    for s, a, b in zip(sources, jres, tres):
        _same_values(a.values, b.values)
        assert (a.mode, a.iterations, a.cache_hit) == (b.mode, b.iterations, b.cache_hit)
        _same_values(b.values, th.run_hytm(None, talg.SSSP, s, tcfg, runtime=rt).values)
    _same_stats(jsvc, tsvc)


def test_default_buckets():
    for n in (1, 3, 8, 12):
        assert tserve.default_buckets(n) == jserve.default_buckets(n)
    assert tserve.default_buckets(12) == (1, 2, 4, 8, 12)
    with pytest.raises(ValueError):
        tserve.default_buckets(0)


def test_pump_honors_quotas_and_serves_everyone():
    jsvc, tsvc = _services(300, 2400, 19, max_lanes=4)
    served, peaks = [], []
    for svc, Queue, Request, prog, Sched in (
            (jsvc, jserve.RequestQueue, jserve.Request, jalg.BFS, jserve.LaneScheduler),
            (tsvc, tserve.RequestQueue, tserve.Request, talg.BFS, tserve.LaneScheduler)):
        q = Queue(quota=1)
        for i, t in enumerate(["a", "b", "a", "c", "b", "a"]):
            q.submit(Request(tenant=t, program=prog, source=i, deadline=float(i)))
        peak: dict[str, int] = {}
        orig = Sched._dispatch

        def spying(self, *a, _orig=orig, _peak=peak, **k):
            for t, c in self.in_flight.items():
                _peak[t] = max(_peak.get(t, 0), c)
            return _orig(self, *a, **k)

        Sched._dispatch = spying
        try:
            out = svc.scheduler.pump(q)
        finally:
            Sched._dispatch = orig
        assert len(out) == 6 and not q and q.stats.quota_violations == 0
        assert all(c <= 1 for c in peak.values()), peak
        served.append(out)
        peaks.append(peak)
    _same_served(*served)
    assert peaks[0] == peaks[1]
    rt = tsvc.dcsr.runtime_for(talg.BFS)
    for r in served[1]:
        _same_values(r.values, th.run_hytm(None, talg.BFS, r.request.source, TCFG,
                                           runtime=rt).values)
    _same_stats(jsvc, tsvc)


# --------------------------------------------------------------------------
# warm cache: tiers, budget, spill -> promote -> replay equivalence
# --------------------------------------------------------------------------

def test_warm_cache_lru_spill_and_promote_roundtrip():
    """The same puts, gets and promotes give the same tiers, stats and
    crc32 integers; the round trip is bit-exact; put owns its tensors."""
    a = np.arange(10, dtype=np.float32)
    z = np.zeros(10, dtype=np.float32)
    caches = (jserve.WarmCache(jserve.TierPolicy(device_budget_bytes=2 * 80)),
              tserve.WarmCache(tserve.TierPolicy(device_budget_bytes=2 * 80), device="cpu"))
    for cache in caches:
        cache.put("k1", 0, a, z)
        cache.put("k2", 0, a + 1, z)
        cache.get("k1")
        cache.put("k3", 0, a + 2, z)
        assert {k: e.tier for k, e in cache.items()} == {
            "k1": "device", "k2": "host", "k3": "device"}
        assert cache.device_bytes <= 160
        assert isinstance(cache._entries["k2"].values, np.ndarray)
    jc, tc = caches
    assert tc._entries["k2"].checksum == jc._entries["k2"].checksum \
        == tserve.warm_cache.state_checksum(a + 1, z)
    for cache in caches:
        promoted = cache.promote("k2")
        assert promoted.tier == "device"
        np.testing.assert_array_equal(np.asarray(promoted.values), a + 1)
        assert cache.device_bytes <= 160
    assert isinstance(tc._entries["k2"].values, torch.Tensor)
    assert jc.stats.as_dict() == tc.stats.as_dict()
    assert tc.stats.spills >= 2 and tc.stats.promotions == 1
    # put copies: a later write to the source tensor leaves the entry alone
    row = torch.ones(10)
    tc.put("k4", 1, row, row)
    row.fill_(7.0)
    assert torch.equal(tc._entries["k4"].values, torch.ones(10))


@pytest.mark.parametrize("seed", [0, 5])
def test_spill_promote_replay_equals_never_evicted_min(seed):
    """MIN programs: a service whose warm states bounce through the host
    tier answers every query bit for bit as an unbounded one, and as the
    reference's budgeted service, with equal stats."""
    g, tg = _graphs(200, 1400, 5)
    budget = 9 * 200
    jtiny = jstream.GraphService(g, JCFG, max_lanes=2, device_budget_bytes=budget)
    tiny = tstream.GraphService(tg, TCFG, max_lanes=2, device_budget_bytes=budget, device="cpu")
    unbounded = tstream.GraphService(tg, TCFG, max_lanes=2, device="cpu")
    rng = np.random.default_rng(seed)
    sources = [0, 7, 19, 33]
    for _ in range(3):
        batch = jstream.random_batch(jtiny.dcsr, rng, n_insert=5, n_delete=5)
        for svc, b in ((jtiny, batch), (tiny, _port_batch(batch)),
                       (unbounded, _port_batch(batch))):
            svc.update(b)
        qs = [sources[int(rng.integers(len(sources)))]]
        for srcs in (qs, sources):
            rj = jtiny.query(jalg.SSSP, srcs)
            rt_ = tiny.query(talg.SSSP, srcs)
            ru = unbounded.query(talg.SSSP, srcs)
            for a, b, c in zip(rj, rt_, ru):
                _same_values(a.values, b.values)
                _same_values(b.values, c.values)
                assert (a.mode, a.iterations) == (b.mode, b.iterations)
    assert tiny.cache.stats.spills > 0
    _same_stats(jtiny, tiny)


def test_spill_promote_replay_tolerance_sum():
    """SUM programs (Δ-PPR): the spilled-and-promoted service tracks the
    unbounded one within the program tolerance after updates, and the
    reference's budgeted service within 1e-5."""
    jppr, tppr = _programs("ppr", tolerance=1e-7)
    g, tg = _graphs(200, 1400, 7)
    jtiny = jstream.GraphService(g, JCFG, max_lanes=2, device_budget_bytes=9 * 200)
    tiny = tstream.GraphService(tg, TCFG, max_lanes=2, device_budget_bytes=9 * 200,
                                device="cpu")
    unbounded = tstream.GraphService(tg, TCFG, max_lanes=2, device="cpu")
    rng = np.random.default_rng(3)
    sources = [0, 11, 23]
    jtiny.query(jppr, sources)
    tiny.query(tppr, sources)
    unbounded.query(tppr, sources)
    for _ in range(2):
        batch = jstream.random_batch(jtiny.dcsr, rng, n_insert=4, n_delete=4)
        jtiny.update(batch)
        tiny.update(_port_batch(batch))
        unbounded.update(_port_batch(batch))
        rj = jtiny.query(jppr, sources)
        rt_ = tiny.query(tppr, sources)
        ru = unbounded.query(tppr, sources)
        for a, b, c in zip(rj, rt_, ru):
            assert np.max(np.abs(b.values - c.values)) < 1e-4
            _same_values(a.values, b.values, exact=False)
            assert a.mode == b.mode
    assert tiny.cache.stats.spills > 0 and tiny.cache.stats.promotions > 0
    assert jtiny.cache.stats.as_dict() == tiny.cache.stats.as_dict()


def test_device_budget_is_never_exceeded():
    """Peak device-resident bytes (in-flight lanes + device tier) stay under
    the budget, the same peak as the reference's; bucket 4 would not fit,
    so admission degrades to bucket 2."""
    budget = 2 * 9 * 300 + 4 * 300 * 2
    jsvc, tsvc = _services(300, 2400, 23, max_lanes=4, device_budget_bytes=budget)
    sources = [0, 7, 19, 33, 41]
    for a, b in zip(jsvc.query(jalg.SSSP, sources), tsvc.query(talg.SSSP, sources)):
        _same_values(a.values, b.values)
    assert tsvc.scheduler.stats.max_device_bytes <= budget
    assert tsvc.scheduler.stats.batches >= 1
    assert tsvc.cache.device_bytes + tsvc.scheduler.pinned_bytes <= budget
    _same_stats(jsvc, tsvc)


# --------------------------------------------------------------------------
# hytm_batched_chunk against solo runs and the reference's lanes
# --------------------------------------------------------------------------

LANE_CASES = {"sssp": [0, 3, 77], "bfs": [0, 5, 9], "cc": [None, None, None],
              "ppr": [0, 3, 77], "kcore": [None, None, None]}


def _lane_inits(jprog, tprog, n, sources, jrt, trt):
    """Each lane's init triple in both packages (k-core seeds from the
    degrees, as run_hytm does), then a dead padding lane."""
    j, t = [], []
    for s in sources:
        if tprog.peel_k is not None:
            deg = trt.csr.out_degree.to(torch.float32)
            removed = deg < tprog.peel_k
            t.append((deg, removed.to(torch.float32), removed))
            j.append(tuple(np.asarray(x.numpy()) for x in t[-1]))
        else:
            t.append(tprog.init_state(n, s, "cpu"))
            j.append(jprog.init_state(n, s))
    t.append(th.dead_lane_state(tprog, n, "cpu"))
    j.append(jh.dead_lane_state(jprog, n))
    return ([np.stack([np.asarray(x[i]) for x in j]) for i in range(3)],
            th.HyTMState(*(torch.stack([x[i] for x in t]) for i in range(3))))


@pytest.mark.parametrize("name", sorted(LANE_CASES))
@pytest.mark.parametrize("use_kernels", [False, True])
def test_batched_chunk_matches_solo_runs_and_reference_lanes(name, use_kernels):
    """A Q=4 batch (one dead lane), chunk by chunk: the port's state,
    n_done and lane_active equal the reference's hytm_batched_chunk
    (values bit for bit for MIN and k-core, SUM within 1e-5), its summed
    per-engine seconds within 1 ulp-scale and its mispredictions equal;
    at the end every lane equals the port's solo run_hytm bit for bit and
    the dead lane is untouched."""
    import jax.numpy as jnp

    kw = {"tolerance": 1e-7} if name == "ppr" else {}
    jprog, tprog = _programs(name, **kw)
    g, tg = _graphs(500, 4000, 17)
    jcfg = dataclasses.replace(JCFG, use_kernels=False)
    tcfg = _tconfig(jcfg, use_kernels=use_kernels)
    weighted = jprog.use_delta and jprog.weighted
    jrt = jh.build_runtime(g, jcfg, weighted_norm=weighted)
    trt = th.build_runtime(tg, tcfg, weighted_norm=weighted, device="cpu")
    sources = LANE_CASES[name]
    jinit, tstate = _lane_inits(jprog, tprog, g.n_nodes, sources, jrt, trt)
    jstate = jh.HyTMState(*(jnp.asarray(x) for x in jinit))
    exact = jprog.combine == jalg.MIN or jprog.peel_k is not None
    for _ in range(40):
        jstate, jn, jact, jpe, jmp = jh.hytm_batched_chunk(
            jstate, jrt.csr, jrt.parts, jrt.zc_req, jrt.inv_deg, jprog, jcfg,
            jrt.n_hub_partitions, 4)
        tstate, tn, tact, tpe, tmp = th.hytm_batched_chunk(tstate, trt, tprog, tcfg, 4)
        assert int(jn) == tn
        np.testing.assert_array_equal(np.asarray(jact), tact.numpy())
        for a, b in ((jstate.values, tstate.values), (jstate.delta, tstate.delta)):
            _same_values(np.asarray(a), b.numpy(), exact)
        np.testing.assert_array_equal(np.asarray(jstate.frontier), tstate.frontier.numpy())
        np.testing.assert_allclose(np.asarray(jpe), tpe.numpy(), rtol=1e-6)
        assert int(jmp) == int(tmp)
        if not tact.any():
            break
    assert not tact.any()
    for q, s in enumerate(sources):
        solo = th.run_hytm(None, tprog, s, tcfg, runtime=trt)
        _same_values(tstate.values[q].numpy(), solo.values)
        _same_values(tstate.delta[q].numpy(), solo.delta)
    dead = th.dead_lane_state(tprog, g.n_nodes, "cpu")
    assert all(torch.equal(x[-1], y) for x, y in zip(
        (tstate.values, tstate.delta, tstate.frontier), dead))


@pytest.mark.parametrize("Q", [1, 8])
def test_lane_relax_calls_per_iteration_do_not_grow_with_q(Q, monkeypatch):
    """At most one relax call per engine a step, two passes of P steps: at
    most 2·P·3 lane-batched relax calls an iteration at Q = 1 and Q = 8
    alike, and no solo relax."""
    g, tg = _graphs(500, 4000, 17)
    cfg = _tconfig(JCFG, use_kernels=True)
    rt = th.build_runtime(tg, cfg, device="cpu")
    P = rt.parts.n_partitions
    calls = []
    orig = th.relax_lanes

    def counting(*a, **k):
        calls[-1] += 1
        return orig(*a, **k)

    def no_solo(*a, **k):
        raise AssertionError("the lane sweep called a solo relax")

    monkeypatch.setattr(th, "relax_lanes", counting)
    monkeypatch.setattr(th, "relax_with_engine", no_solo)
    sources = [0, 3, 77, 210, 9, 400, 123, 42][:Q]
    trip = [talg.SSSP.init_state(g.n_nodes, s, "cpu") for s in sources]
    state = th.HyTMState(*(torch.stack([x[i] for x in trip]) for i in range(3)))
    while True:
        calls.append(0)
        state, n_done, active, _, _ = th.hytm_batched_chunk(state, rt, talg.SSSP, cfg, 1)
        assert calls[-1] <= 2 * P * 3
        if not active.any():
            break
    assert len(calls) > 2 and max(calls) > 0


# --------------------------------------------------------------------------
# lane kernels' plain versions against loops of the single-lane ones
# --------------------------------------------------------------------------

def _lane_offsets(lengths):
    return torch.tensor(np.concatenate([[0], np.cumsum(lengths)]), dtype=torch.int64)


@pytest.mark.parametrize("combine,d", [("min", 1), ("sum", 2)])
def test_segment_spmm_lanes_plain_is_a_loop_of_single_lanes(combine, d):
    rng = np.random.default_rng(d)
    lengths = (40, 0, 333, 1)
    m, n = sum(lengths), 50
    msg = torch.from_numpy(rng.standard_normal((m, d)).astype(np.float32))
    if combine == "min":
        msg = msg[:, 0].contiguous()
    seg = torch.from_numpy(rng.integers(-2, n + 2, m).astype(np.int32))
    got = segment_spmm_lanes_ref(msg, seg, _lane_offsets(lengths), n, combine)
    off = np.concatenate([[0], np.cumsum(lengths)])
    for l_, (a, b) in enumerate(zip(off[:-1], off[1:])):
        lane_msg = msg[a:b] if d > 1 else msg[a:b, None]
        want = segment_spmm_ref(lane_msg, seg[a:b], n, None, combine)
        assert torch.equal(got[l_], want if d > 1 else want[:, 0])


@pytest.mark.parametrize("combine,d", [("min", 1), ("sum", 2), ("min", 3)])
def test_segment_spmm_lanes_host_lengths_give_the_same_rows(combine, d):
    """The lane entry given its lanes' lengths as host ints (as the lane
    chunk passes ``LaneGroup.lengths``, which plan the kernel's launch on
    the card) and without them: the same rows, on the CPU through the
    wrapper's plain version and through the plain version itself."""
    rng = np.random.default_rng(10 + d)
    lengths = (0, 57, 1, 0, 402)
    m, n = sum(lengths), 61
    msg = torch.from_numpy(rng.standard_normal((m, d)).astype(np.float32))
    if d == 1:
        msg = msg[:, 0].contiguous()
    seg = torch.from_numpy(rng.integers(-2, n + 2, m).astype(np.int32))
    offsets = _lane_offsets(lengths)
    want = segment_spmm_lanes_ref(msg, seg, offsets, n, combine)
    assert torch.equal(segment_spmm_lanes_ref(msg, seg, offsets, n, combine, lengths), want)
    for kw in ({}, {"lengths": lengths}):
        assert torch.equal(segment_spmm_lanes(msg, seg, offsets, n, combine, **kw), want)


def test_frontier_compact_lanes_plain_is_a_loop_of_single_lanes():
    rng = np.random.default_rng(1)
    lengths = (17, 0, 300, 2)
    m = sum(lengths)
    cols = (torch.from_numpy(rng.integers(0, 99, m).astype(np.int32)),
            torch.from_numpy(rng.standard_normal(m).astype(np.float32)))
    mask = torch.from_numpy(rng.random(m) < 0.4)
    got, counts = frontier_compact_lanes_ref(cols, mask, _lane_offsets(lengths))
    off = np.concatenate([[0], np.cumsum(lengths)])
    for l_, (a, b) in enumerate(zip(off[:-1], off[1:])):
        want, cnt = frontier_compact_ref([c[a:b] for c in cols], mask[a:b])
        assert int(counts[l_]) == int(cnt)
        assert all(torch.equal(g_[a:b], w_) for g_, w_ in zip(got, want))


def test_hyb_gather_lane_request_list_is_a_loop_of_single_lanes():
    """ZEROCOPY's lane path issues every lane's windows in one request list
    over the shared columns: equal to each lane's requests alone."""
    rng = np.random.default_rng(2)
    cols = tuple(torch.from_numpy(rng.integers(0, 99, 5000).astype(np.int32)) for _ in range(3))
    lanes = [(0, 300), (1000, 128), (4900, 100)]
    per = []
    for start, count in lanes:
        st_ = torch.arange(start, start + count, 128, dtype=torch.int32)
        per.append((st_, torch.clamp(start + count - st_, max=128).to(torch.int32)))
    got = hyb_gather(cols, torch.cat([p[0] for p in per]), torch.cat([p[1] for p in per]))
    want = [torch.cat(c) for c in zip(*(hyb_gather(cols, *p) for p in per))]
    assert all(torch.equal(g_, w_) for g_, w_ in zip(got, want))


def test_lane_relax_rows_equal_solo_relax():
    """Each engine's lane relax over three lanes of different partitions:
    lane l's row equals relax_with_engine over its partition alone, with
    and without the kernel wrappers."""
    g, tg = _graphs(500, 4000, 17)
    rt = th.build_runtime(tg, TCFG, device="cpu")
    n = g.n_nodes
    rng = np.random.default_rng(0)
    values = torch.from_numpy(rng.random((3, n)).astype(np.float32) * 10)
    frontier = torch.from_numpy(rng.random((3, n)) < 0.3)
    parts = [0, 5, 2]
    _, edge_start, part_edges = rt.parts.host
    lengths = tuple(part_edges[p] for p in parts)
    table = torch.tensor([0, 1, 2] + [edge_start[p] for p in parts] + list(lengths)
                         + list(np.concatenate([[0], np.cumsum(lengths)])), dtype=torch.int64)
    group = th._lane_group(table, 0, lengths)
    flat = values.view(-1)

    def operand_at(idx, src):
        return torch.index_select(flat, 0, idx)

    for eng in (0, 1, 2):
        for uk in (False, True):
            out = teng.relax_lanes(eng, group, rt.csr, frontier, operand_at, talg.SSSP, uk)
            for q, p in enumerate(parts):
                a, b = edge_start[p], edge_start[p] + part_edges[p]
                src = rt.csr.edge_src[a:b]
                block = teng.EdgeBlock(src=src, dst=rt.csr.edge_dst[a:b],
                                       weight=rt.csr.edge_weight[a:b],
                                       active=torch.index_select(frontier[q], 0, src))
                solo = teng.relax_with_engine(eng, block, values[q], n, talg.SSSP, uk)
                assert torch.equal(out.agg[q], solo.agg) and torch.equal(out.touched[q],
                                                                          solo.touched)


# --------------------------------------------------------------------------
# launcher and the parts not ported yet
# --------------------------------------------------------------------------

def test_serve_graph_selfcheck_on_cpu(capsys, tmp_path, monkeypatch):
    serve_graph.main(["--selfcheck", "--device", "cpu"])
    assert "SELFCHECK OK (device cpu)" in capsys.readouterr().out
    # --trace and --calibrated (a profile saved under the CPU's device kind)
    from repro_torch.autotune import save_profile
    from repro_torch.core.constants import PCIE3
    from repro_torch.obs import validate_chrome_trace

    monkeypatch.setenv("REPRO_AUTOTUNE_REGISTRY", str(tmp_path))
    save_profile(PCIE3.with_(name="cpu-calibrated", alpha=0.5), device_kind="cpu")
    trace = tmp_path / "serve.json"
    serve_graph.main(["--device", "cpu", "--nodes", "300", "--edges", "2400",
                      "--partitions", "8", "--queries", "4", "--lanes", "2",
                      "--update-batches", "1", "--update-size", "8",
                      "--trace", str(trace), "--calibrated"])
    out = capsys.readouterr().out
    assert "link profile: 'cpu-calibrated'" in out and f"-> {trace}" in out
    doc = json.loads(trace.read_text())
    assert validate_chrome_trace(doc) == len(doc["traceEvents"]) > 0
    tracks = {e["args"]["name"] for e in doc["traceEvents"] if e["name"] == "thread_name"}
    assert {"scheduler", "cache", "tenant:_local", "device0"} <= tracks


def test_unported_serving_options_raise():
    # owner placement is ported (tests/test_torch_stream_sharded.py): the
    # cache of a placement lives on its mesh's device as owned slices
    mesh = GraphMesh(group=None, axis="graph", size=2, rank=1, device=torch.device("cpu"))
    pl = tserve.warm_cache.OwnerPlacement(mesh, 9)
    assert (pl.n_loc, pl.n_pad) == (5, 10)
    cache = tserve.WarmCache(placement=pl)
    assert cache.device == torch.device("cpu") and cache.placement is pl
    entry = cache.put("k", 0, np.arange(9, dtype=np.float32), np.zeros(9, np.float32))
    assert entry.values.tolist() == [5.0, 6.0, 7.0, 8.0, 0.0] and entry.nbytes == 40
    # tracing is ported (tests/test_torch_obs.py): the cache takes a recorder;
    # fault sites and the supervisor too (tests/test_torch_resilience.py)
    assert tserve.WarmCache(device="cpu", obs=None).obs is None
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="no CUDA device"):
            tserve.WarmCache()
