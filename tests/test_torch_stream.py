"""The port's dynamic-graph layer (``repro_torch.stream``) against
``repro.stream`` on the same graphs and the same update batches.

Contract:
* ``DeltaCSR``: after construction and after every ``apply`` the host log,
  every device tensor, the block geometry, the version counters, the dirty
  set and the ``UpdateReport`` are equal bit for bit; a malformed batch
  raises with the same index and message and changes nothing;
* seeds: ``seed_min`` and ``seed_sum`` give the same (values, Δ, frontier)
  bit for bit;
* ``run_incremental``: MIN programs bit-identical in values, iterations,
  transfer bytes and engine history; SUM values + Δ within 1e-5 with the
  same iteration count (tests/test_torch_hytm.py's contract);
* the port alone, as tests/test_stream.py holds the reference: warm equals
  scratch (MIN bit for bit, SUM within 1e-3) over 3 batches, with strictly
  fewer iterations warm, and the ``seg_start`` refresh removes the Eq. 3
  alignment drift.
The reference runs K=1 with ``use_kernels=False`` (its Pallas bodies do
not run under the installed jax); the port runs K in {1, 4}, through its
oracle engines and its kernel wrappers (plain bodies on the CPU).
"""

import dataclasses

import numpy as np
import pytest
import torch

from repro.core import hytm as jh
from repro.graph import algorithms as jalg
from repro.graph import generators as jgen
from repro.stream import delta_csr as jd
from repro.stream import incremental as ji
from repro_torch import convert
from repro_torch import stream as ts
from repro_torch.core import hytm as th
from repro_torch.core.cost_model import zc_request_counts
from repro_torch.graph import algorithms as talg
from repro_torch.launch.mesh import GraphMesh
from repro_torch.stream import incremental as tinc

SUM_ATOL = 1e-5         # warm run against the reference's warm run
SCRATCH_SUM_ATOL = 1e-3  # warm against scratch (tests/test_stream.py's bound)
GRAPHS = {
    "rmat": lambda: jgen.rmat_graph(300, 2400, seed=0),
    "grid": lambda: jgen.grid_mesh_graph(16, 20, seed=1),
}
JCFG = jh.HyTMConfig(n_partitions=6, sync_every=1, use_kernels=False)
PROGRAMS = {
    "sssp": 0, "bfs": 0, "cc": None, "pagerank": None, "php": None,
}


def _tconfig(cfg: jh.HyTMConfig, **kw) -> th.HyTMConfig:
    fields = {f.name for f in dataclasses.fields(th.HyTMConfig)} - {"link", "ici_link"}
    vals = {k: getattr(cfg, k) for k in fields}
    vals.update(kw)
    return th.HyTMConfig(link=convert.link_model(dataclasses.asdict(cfg.link)), **vals)


def _graph(name):
    g = GRAPHS[name]()
    return g, convert.csr_graph(g.indptr, g.indices, g.weights)


def _pair(gname, **kw):
    g, tg = _graph(gname)
    return (jd.DeltaCSR(g, JCFG, **kw),
            ts.DeltaCSR(tg, _tconfig(JCFG), device="cpu", **kw))


def _eq(a, b):
    a, b = np.asarray(a), np.asarray(b)
    assert a.dtype == b.dtype, (a.dtype, b.dtype)
    np.testing.assert_array_equal(a, b)


def _same_dcsr(j, t):
    for name in ("_src", "_dst", "_w", "_valid", "counts", "vertex_start", "vertex_part",
                 "out_deg", "_seg_start_host"):
        _eq(getattr(j, name), getattr(t, name))
    for name in ("block_size", "n_partitions", "n_nodes", "version", "layout_version",
                 "dirty", "n_edges"):
        assert getattr(j, name) == getattr(t, name), name
    for name in ("edge_src", "edge_dst", "edge_weight", "edge_valid", "out_degree",
                 "seg_start"):
        _eq(getattr(j.csr, name), getattr(t.csr, name).numpy())
    assert j.csr.n_edges == t.csr.n_edges and j.csr.n_nodes == t.csr.n_nodes
    for name in ("vertex_start", "edge_start", "part_edges", "vertex_part_id"):
        _eq(getattr(j.parts, name), getattr(t.parts, name).numpy())
    assert (j.parts.n_partitions, j.parts.block_size) == (t.parts.n_partitions,
                                                          t.parts.block_size)
    # the sweep dispatches from the host copy: it must follow the patches
    assert t.parts.host == tuple(np.asarray(getattr(j.parts, k)).tolist()
                                 for k in ("vertex_start", "edge_start", "part_edges"))
    _eq(j.zc_req, t.zc_req.numpy())
    for weighted in (False, True):
        _eq(j._inv_deg(weighted), t._inv_deg(weighted).numpy())
    assert t.csr.capacity == t.n_partitions * t.block_size


def _same_report(a, b):
    for name in ("version", "merged"):
        assert getattr(a, name) == getattr(b, name)
    for name in ("dirty_partitions", "ins_src", "ins_dst", "ins_w", "del_src", "del_dst",
                 "del_w"):
        _eq(getattr(a, name), getattr(b, name))
    _eq(a.affected_vertices, b.affected_vertices)
    for name in ("pre_adj", "post_adj"):
        da, db = getattr(a, name), getattr(b, name)
        assert list(da) == list(db)
        for u in da:
            for x, y in zip(da[u], db[u]):
                _eq(x, y)


def _batch_pair(op, src, dst, w):
    return (jd.EdgeBatch(np.array(op), np.array(src), np.array(dst), np.array(w, np.float32)),
            ts.EdgeBatch(np.array(op), np.array(src), np.array(dst), np.array(w, np.float32)))


# --------------------------------------------------------------------------
# DeltaCSR
# --------------------------------------------------------------------------

@pytest.mark.parametrize("gname", sorted(GRAPHS))
def test_layout_matches_reference(gname):
    j, t = _pair(gname)
    _same_dcsr(j, t)
    assert t.csr.device.type == "cpu"
    # padding lanes are self-loops on vertex 0, weight +inf, not valid
    pad = ~t.csr.edge_valid
    assert bool((t.csr.edge_src[pad] == 0).all() and (t.csr.edge_dst[pad] == 0).all()
                and torch.isinf(t.csr.edge_weight[pad]).all())
    # the runtime view: blocked layout, no spare block, no hub partitions
    rt = t.runtime_for(talg.SSSP)
    assert rt.n_hub_partitions == 0 and rt.parts.block_size == t.block_size


def test_random_batch_matches_reference():
    j, t = _pair("rmat")
    for seed in range(3):
        a = jd.random_batch(j, np.random.default_rng(seed), n_insert=7, n_delete=9,
                            n_reweight=4)
        b = ts.random_batch(t, np.random.default_rng(seed), n_insert=7, n_delete=9,
                            n_reweight=4)
        for name in ("op", "src", "dst", "weight"):
            _eq(getattr(a, name), getattr(b, name))


def _scripted_batches(j, rng):
    """Insert (a parallel copy too), delete, reweight, insert-then-delete,
    reweight-of-absent and delete of one of several parallel copies."""
    s, d, w = j.live_edges()
    pairs = list(zip(s.tolist(), d.tolist()))
    multi = next(p for p in pairs if pairs.count(p) > 1) if len(set(pairs)) < len(pairs) \
        else pairs[0]
    n = j.n_nodes
    present = set(pairs)
    absent = next((u, v) for u in range(n) for v in range(n) if (u, v) not in present)
    first = (
        [0, 0, 1, 2, 0, 1, 2, 1, 2],
        [pairs[0][0], 5, pairs[1][0], pairs[2][0], 7, 7, absent[0], multi[0], multi[0]],
        [pairs[0][1], 6, pairs[1][1], pairs[2][1], 8, 8, absent[1], multi[1], multi[1]],
        [3.0, 4.0, 0.0, 9.5, 2.0, 0.0, 5.0, 0.0, 11.0],
    )
    yield first
    for _ in range(2):
        b = jd.random_batch(j, rng, n_insert=int(rng.integers(1, 12)),
                            n_delete=int(rng.integers(1, 12)),
                            n_reweight=int(rng.integers(0, 6)))
        yield b.op, b.src, b.dst, b.weight
    # overflow: flood one source past its block's free lanes -> merge
    k = j.block_size
    yield (np.zeros(k, np.int32), np.full(k, 3), np.arange(k) % n, np.ones(k, np.float32))
    b = jd.random_batch(j, rng, n_insert=5, n_delete=5, n_reweight=3)
    yield b.op, b.src, b.dst, b.weight


@pytest.mark.parametrize("gname", sorted(GRAPHS))
@pytest.mark.parametrize("refresh", [True, False])
def test_apply_sequences_match_reference(gname, refresh):
    j, t = _pair(gname, refresh_seg_start=refresh)
    rng = np.random.default_rng(7)
    merged = 0
    for op, src, dst, w in _scripted_batches(j, rng):
        bj, bt = _batch_pair(op, src, dst, w)
        ra, rb = j.apply(bj), t.apply(bt)
        _same_report(ra, rb)
        _same_dcsr(j, t)
        merged += rb.merged
    assert merged == 1 and t.layout_version == 1 and t.version == 5


def test_apply_keeps_live_prefix_and_patches_in_place():
    _, t = _pair("rmat")
    col = t.csr.edge_src
    s0, d0, _ = t.live_edges()
    t.apply(ts.EdgeBatch.deletes([s0[0]], [d0[0]]))
    assert t.csr.edge_src is col  # patched, not rebuilt
    for p in range(t.n_partitions):
        lo = p * t.block_size
        assert t._valid[lo:lo + t.counts[p]].all() and not t._valid[lo + t.counts[p]:
                                                                      lo + t.block_size].any()


@pytest.mark.parametrize("case", ["op", "src", "dst", "nan", "inf", "absent", "twice",
                                  "reweight_nan"])
def test_validate_batch_matches_reference(case):
    j, t = _pair("rmat")
    s, d, _ = j.live_edges()
    u, v = int(s[0]), int(d[0])
    n = j.n_nodes
    out_of_u = set(d[s == u].tolist())
    gone = next(x for x in range(n) if x not in out_of_u)
    ok = ([0, 1], [4, 4], [9, 9], [1.0, 0.0])  # insert-then-delete is legal
    bad = {
        "op": ([0, 7], [1, 2], [3, 4], [1.0, 1.0]),
        "src": ([0, 0], [1, n], [3, 4], [1.0, 1.0]),
        "dst": ([0, 1], [1, u], [-1, v], [1.0, 0.0]),
        "nan": ([1, 0], [u, 2], [v, 3], [0.0, np.nan]),
        "inf": ([0, 2], [1, u], [2, v], [1.0, np.inf]),
        "absent": ([0, 1], [1, u], [2, gone], [1.0, 0.0]),
        "twice": ([1, 1, 1], [u] * 3, [v] * 3, [0.0] * 3),
        "reweight_nan": ([2], [u], [v], [np.nan]),
    }[case]
    if case == "twice":
        count = int(((s == u) & (d == v)).sum())
        bad = ([1] * (count + 1), [u] * (count + 1), [v] * (count + 1), [0.0] * (count + 1))
    bj, bt = _batch_pair(*bad)
    with pytest.raises(jd.InvalidBatchError) as ej:
        j.apply(bj)
    with pytest.raises(ts.InvalidBatchError) as et:
        t.apply(bt)
    assert et.value.index == ej.value.index and str(et.value) == str(ej.value)
    _same_dcsr(j, t)
    assert t.version == 0 and t.dirty == set()
    bj, bt = _batch_pair(*ok)
    _same_report(j.apply(bj), t.apply(bt))
    _same_dcsr(j, t)


def test_batch_id_dedup_window_matches_reference():
    j, t = _pair("grid")
    for i in range(66):
        bj, bt = _batch_pair([0], [i % 50], [(i * 7) % 50], [1.0])
        ra, rb = j.apply(bj, batch_id=i), t.apply(bt, batch_id=i)
        _same_report(ra, rb)
    assert list(t._applied) == list(j._applied) == list(range(2, 66))
    # a redelivered id inside the window returns the first report, unapplied
    bj, bt = _batch_pair([0], [1], [2], [1.0])
    assert t.apply(bt, batch_id=65) is t._applied[65] and t.version == 66
    j.apply(bj, batch_id=65)
    # an id that fell out of the window applies again
    _same_report(j.apply(bj, batch_id=0), t.apply(bt, batch_id=0))
    _same_dcsr(j, t)


def test_unported_parts_raise():
    """Every part of the stream slice is ported: the sharded view, the
    service and run_incremental on a mesh (tests/test_torch_stream_sharded.py).
    A view needs a mesh axis; without ``mesh_axis`` a ``mesh`` is not read,
    as in the reference."""
    _, t = _pair("grid")
    with pytest.raises(ValueError, match="no mesh axis"):
        t.sharded_runtime_for(talg.SSSP)
    # GraphService is ported (tests/test_torch_stream_service.py), and its
    # tracing (tests/test_torch_obs.py), its fault options
    # (tests/test_torch_resilience.py) and its mesh option
    assert ts.GraphService(_graph("grid")[1], device="cpu", mesh=object()).mesh is None
    with pytest.raises(AttributeError):
        ts.no_such_name
    zeros = np.zeros(t.n_nodes, np.float32)
    res = ts.run_incremental(t, talg.SSSP, [], zeros, zeros, mesh=object())
    assert res.iterations == 1 and res.total_ici_bytes == 0.0
    cpu_mesh = GraphMesh(group=None, axis="graph", size=1, rank=0, device=torch.device("cpu"))
    with pytest.raises(ValueError, match="mesh's axis"):
        ts.run_incremental(t, talg.SSSP, [], zeros, zeros,
                           config=th.HyTMConfig(mesh_axis="rows"), mesh=cpu_mesh)
    assert t.version == 0


def test_delta_csr_raises_without_a_card():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present: DeltaCSR runs on it")
    _, tg = _graph("grid")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        ts.DeltaCSR(tg)


# --------------------------------------------------------------------------
# Seeds and warm runs against the reference
# --------------------------------------------------------------------------

@pytest.fixture(scope="module")
def updated_pairs():
    """name -> (reference DeltaCSR, port DeltaCSR, reports, reference cold
    result before the updates, reference warm result after them): two
    random batches on the rmat graph."""
    out = {}
    for name, src in PROGRAMS.items():
        j, t = _pair("rmat")
        pj = jalg.ALGORITHMS[name]
        cold = jh.run_hytm(None, pj, source=src, config=JCFG, runtime=j.runtime_for(pj))
        rng_j, rng_t = np.random.default_rng(11), np.random.default_rng(11)
        reports = []
        for _ in range(2):
            ra = j.apply(jd.random_batch(j, rng_j, n_insert=8, n_delete=12, n_reweight=5))
            rb = t.apply(ts.random_batch(t, rng_t, n_insert=8, n_delete=12, n_reweight=5))
            _same_report(ra, rb)
            reports.append((ra, rb))
        warm = ji.run_incremental(j, pj, [a for a, _ in reports], cold.values, cold.delta,
                                  source=src, config=JCFG)
        out[name] = (j, t, reports, cold, warm)
    return out


@pytest.mark.parametrize("name", sorted(PROGRAMS))
def test_seeds_match_reference(updated_pairs, name):
    j, t, reports, cold, _ = updated_pairs[name]
    src = PROGRAMS[name]
    want = ji.incremental_state(jalg.ALGORITHMS[name], cold.values, cold.delta,
                                [a for a, _ in reports], j, src)
    got = tinc.incremental_state(talg.ALGORITHMS[name], cold.values, cold.delta,
                                 [b for _, b in reports], t, src)
    for field in ("values", "delta", "frontier"):
        _eq(getattr(want, field), getattr(got, field).numpy())
    assert got.frontier.any()


@pytest.mark.parametrize("name", sorted(PROGRAMS))
@pytest.mark.parametrize("K", [1, 4])
@pytest.mark.parametrize("use_kernels", [False, True])
def test_run_incremental_matches_reference(updated_pairs, name, K, use_kernels):
    _, t, reports, cold, want = updated_pairs[name]
    src = PROGRAMS[name]
    pt = talg.ALGORITHMS[name]
    got = ts.run_incremental(t, pt, [b for _, b in reports], cold.values, cold.delta,
                             source=src, config=_tconfig(JCFG, sync_every=K,
                                                         use_kernels=use_kernels))
    assert got.iterations == want.iterations
    np.testing.assert_array_equal(got.history["active_vertices"],
                                  want.history["active_vertices"])
    if pt.combine == talg.MIN:
        _eq(want.values, got.values)
        assert got.total_transfer_bytes == want.total_transfer_bytes
        np.testing.assert_array_equal(got.history["engines"], want.history["engines"])
    else:
        np.testing.assert_allclose(got.values + got.delta, want.values + want.delta,
                                   rtol=0, atol=SUM_ATOL)


def test_merge_then_warm_run_matches_reference():
    """A merge-compaction re-partitions: the warm SSSP run over the new
    layout equals the reference's."""
    g, tg = _graph("rmat")
    j = jd.DeltaCSR(g, JCFG, slack=0.0, min_slack=1)
    t = ts.DeltaCSR(tg, _tconfig(JCFG), slack=0.0, min_slack=1, device="cpu")
    cold = jh.run_hytm(None, jalg.SSSP, source=0, config=JCFG, runtime=j.runtime_for(jalg.SSSP))
    k = t.block_size - int(t.counts[0]) + 1  # one past partition 0's free lanes
    op, src, dst, w = np.zeros(k, np.int32), np.zeros(k), np.arange(k) % 299 + 1, np.ones(k)
    bj, bt = _batch_pair(op, src, dst, w)
    ra, rb = j.apply(bj), t.apply(bt)
    assert rb.merged and t.layout_version == 1
    _same_report(ra, rb)
    _same_dcsr(j, t)
    want = ji.run_incremental(j, jalg.SSSP, [ra], cold.values, cold.delta, 0, config=JCFG)
    got = ts.run_incremental(t, talg.SSSP, [rb], cold.values, cold.delta, 0,
                             config=_tconfig(JCFG, sync_every=4))
    _eq(want.values, got.values)
    assert got.iterations == want.iterations
    np.testing.assert_array_equal(got.history["engines"], want.history["engines"])


# --------------------------------------------------------------------------
# The port alone: warm against scratch (tests/test_stream.py's contract)
# --------------------------------------------------------------------------

CFG = th.HyTMConfig(n_partitions=6, sync_every=4)
PR = dataclasses.replace(talg.PAGERANK, tolerance=1e-7)


@pytest.mark.parametrize("seed", [0, 1])
@pytest.mark.parametrize("name", ["sssp", "bfs", "pagerank"])
def test_incremental_matches_scratch(seed, name):
    prog = PR if name == "pagerank" else talg.ALGORITHMS[name]
    src = None if prog.use_delta else 0
    _, tg = _graph("rmat")
    dc = ts.DeltaCSR(tg, CFG, device="cpu")
    rng = np.random.default_rng(seed)
    warm = th.run_hytm(None, prog, src, CFG, runtime=dc.runtime_for(prog))
    for _ in range(3):
        rep = dc.apply(ts.random_batch(
            dc, rng, n_insert=int(rng.integers(1, 10)), n_delete=int(rng.integers(1, 10)),
            n_reweight=int(rng.integers(0, 6))))
        inc = ts.run_incremental(dc, prog, [rep], warm.values, warm.delta, source=src,
                                 config=CFG)
        fs = th.run_hytm(dc.to_host_graph(), prog, src, CFG, device="cpu")
        if prog.combine == talg.MIN:
            np.testing.assert_array_equal(inc.values, fs.values)
        else:
            np.testing.assert_allclose(inc.values + inc.delta, fs.values + fs.delta,
                                       atol=SCRATCH_SUM_ATOL)
        warm = inc


def test_cc_with_a_source_terminates_and_matches_scratch():
    """With a source, CC's every label edge is routed through, so the
    reference's invalidation loop re-grows into the source forever
    (ROADMAP queue 3); the port never invalidates the source, ends, and
    equals a run from scratch."""
    _, tg = _graph("rmat")
    dc = ts.DeltaCSR(tg, CFG, device="cpu")
    cold = th.run_hytm(None, talg.CC, 0, CFG, runtime=dc.runtime_for(talg.CC))
    rep = dc.apply(ts.random_batch(dc, np.random.default_rng(11), n_insert=8, n_delete=12))
    inc = ts.run_incremental(dc, talg.CC, [rep], cold.values, cold.delta, source=0, config=CFG)
    fs = th.run_hytm(dc.to_host_graph(), talg.CC, 0, CFG, device="cpu")
    np.testing.assert_array_equal(inc.values, fs.values)


def test_incremental_fewer_iterations_on_small_batches():
    g = jgen.rmat_graph(800, 8000, seed=9)
    dc = ts.DeltaCSR(convert.csr_graph(g.indptr, g.indices, g.weights),
                     th.HyTMConfig(n_partitions=8), device="cpu")
    cfg = dc.config
    rng = np.random.default_rng(9)
    warm = th.run_hytm(None, talg.SSSP, 0, cfg, runtime=dc.runtime_for(talg.SSSP))
    for _ in range(3):
        rep = dc.apply(ts.random_batch(dc, rng, n_insert=40, n_delete=40))
        assert len(rep.ins_src) + len(rep.del_src) <= 0.01 * 2 * g.n_edges
        inc = ts.run_incremental(dc, talg.SSSP, [rep], warm.values, warm.delta, 0, cfg)
        fs = th.run_hytm(dc.to_host_graph(), talg.SSSP, 0, cfg, device="cpu")
        np.testing.assert_array_equal(inc.values, fs.values)
        assert inc.iterations < fs.iterations, (inc.iterations, fs.iterations)
        warm = inc


def _aligned_zc_req(dc) -> np.ndarray:
    """The zero-copy request counts of the layout the next merge would
    realize: every partition's segments packed dense in vertex order."""
    seg = np.empty(dc.n_nodes, np.int64)
    B = dc.block_size
    for p in range(dc.n_partitions):
        v0, v1 = int(dc.vertex_start[p]), int(dc.vertex_start[p + 1])
        if v1 <= v0:
            continue
        deg = dc.out_deg[v0:v1].astype(np.int64)
        seg[v0:v1] = p * B + np.concatenate(([0], np.cumsum(deg[:-1])))
    return zc_request_counts(torch.from_numpy(dc.out_deg.astype(np.int32)),
                             torch.from_numpy(seg.astype(np.int32)), dc.config.link).numpy()


def test_seg_start_refresh_removes_cost_model_drift():
    g = jgen.rmat_graph(400, 3200, seed=6)
    tg = convert.csr_graph(g.indptr, g.indices, g.weights)
    cfg = th.HyTMConfig(n_partitions=6)
    fresh = ts.DeltaCSR(tg, cfg, device="cpu")
    frozen = ts.DeltaCSR(tg, cfg, refresh_seg_start=False, device="cpu")
    rng_a, rng_b = np.random.default_rng(6), np.random.default_rng(6)
    drift_fresh = drift_frozen = 0.0
    for _ in range(4):
        ba = ts.random_batch(fresh, rng_a, n_insert=2, n_delete=60)
        bb = ts.random_batch(frozen, rng_b, n_insert=2, n_delete=60)
        np.testing.assert_array_equal(ba.src, bb.src)
        ra, rb = fresh.apply(ba), frozen.apply(bb)
        assert not ra.merged and not rb.merged
        drift_fresh += float(np.abs(fresh.zc_req.numpy() - _aligned_zc_req(fresh)).sum())
        drift_frozen += float(np.abs(frozen.zc_req.numpy() - _aligned_zc_req(frozen)).sum())
    assert drift_fresh == 0.0, drift_fresh
    assert drift_frozen > 0.0
