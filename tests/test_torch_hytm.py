"""The port's convergence loop against ``repro.core.hytm.run_hytm`` on the
same graphs (made with numpy from a seed).

Contract (the reference's own between its paths):
* MIN programs and k-core: values, Δ, iteration count, transfer bytes and
  the per-iteration engine history are bit-identical;
* SUM programs: values + Δ within ``atol=1e-5`` (tests/test_chunked.py's
  tolerance), the same iteration count, transfer bytes within 1e-6.
The reference runs with ``use_kernels=False`` (its Pallas bodies do not run
under the installed jax) and K=1; the port runs K in {1, 4}, through its
oracle engines and through its kernel wrappers (plain bodies on the CPU).
"""

import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import hytm as jh
from repro.core.constants import PCIE3 as JPCIE3
from repro.graph import algorithms as jalg
from repro.graph import generators as jgen
from repro_torch import convert
from repro_torch.core import hytm as th
from repro_torch.core.constants import PCIE3
from repro_torch.dist import graph_shard as tgs
from repro_torch.graph import algorithms as talg
from repro_torch.launch.mesh import GraphMesh
from repro_torch import stream as tstream

GRAPHS = {
    "rmat": lambda: jgen.rmat_graph(600, 5000, seed=3),
    "grid": lambda: jgen.grid_mesh_graph(16, 20, seed=1),
    "uniform": lambda: jgen.uniform_graph(400, 3000, seed=2),
}
SUM_ATOL = 1e-5


def _source(prog):
    return None if (prog.use_delta and not prog.personalized) else 0


def _tconfig(cfg: jh.HyTMConfig, **kw) -> th.HyTMConfig:
    fields = {f.name for f in dataclasses.fields(th.HyTMConfig)} - {"link", "ici_link"}
    vals = {k: getattr(cfg, k) for k in fields}
    vals.update(kw)
    return th.HyTMConfig(link=convert.link_model(dataclasses.asdict(cfg.link)), **vals)


def _check(want, got, prog):
    np.testing.assert_array_equal(want.history["active_vertices"],
                                  got.history["active_vertices"])
    assert want.iterations == got.iterations
    if prog.combine == jalg.MIN or prog.peel_k is not None:
        np.testing.assert_array_equal(want.values, got.values)
        np.testing.assert_array_equal(want.delta, got.delta)
        assert want.total_transfer_bytes == got.total_transfer_bytes
        np.testing.assert_array_equal(want.history["engines"], got.history["engines"])
        np.testing.assert_array_equal(want.history["transfer_bytes"],
                                      got.history["transfer_bytes"])
    else:
        np.testing.assert_allclose(want.values + want.delta, got.values + got.delta,
                                   rtol=0, atol=SUM_ATOL)
        np.testing.assert_allclose(want.total_transfer_bytes, got.total_transfer_bytes,
                                   rtol=1e-6)
    np.testing.assert_allclose(want.modeled_seconds, got.modeled_seconds, rtol=1e-5)
    assert got.history["engines"].dtype == np.int32
    assert got.history["engines"].shape == (got.iterations, want.history["engines"].shape[1])


@pytest.fixture(scope="module")
def reference_runs():
    """Memo of reference results: (graph, program, config) -> HyTMResult."""
    memo = {}

    def run(gname, prog, cfg, **kw):
        key = (gname, prog, cfg, tuple(sorted(kw.items())))
        if key not in memo:
            memo[key] = jh.run_hytm(GRAPHS[gname](), prog, source=_source(prog),
                                    config=cfg, **kw)
        return memo[key]

    return run


@pytest.mark.parametrize("gname", sorted(GRAPHS))
@pytest.mark.parametrize("name", sorted(jalg.ALGORITHMS))
@pytest.mark.parametrize("K", [1, 4])
@pytest.mark.parametrize("use_kernels", [False, True])
def test_program_matches_reference(reference_runs, gname, name, K, use_kernels):
    cfg = jh.HyTMConfig(n_partitions=8, sync_every=1, use_kernels=False)
    want = reference_runs(gname, jalg.ALGORITHMS[name], cfg)
    prog = talg.ALGORITHMS[name]
    got = th.run_hytm(GRAPHS[gname](), prog, source=_source(prog),
                      config=_tconfig(cfg, sync_every=K, use_kernels=use_kernels),
                      device="cpu")
    _check(want, got, prog)


@pytest.mark.parametrize("name", ["sssp", "pagerank"])
def test_hub_sorted_quickstart_config_matches_reference(name):
    import importlib

    hub_sort = importlib.import_module("repro.graph.hub_sort").hub_sort
    hs = hub_sort(jgen.rmat_graph(1200, 12000, seed=0))
    prog_j = dataclasses.replace(jalg.ALGORITHMS[name], tolerance=1e-5)
    cfg = jh.HyTMConfig(link=JPCIE3.with_(mr=4.0), n_partitions=16, sync_every=1,
                        use_kernels=False, cds_mode="delta" if name == "pagerank" else "hub")
    src = None if name == "pagerank" else int(hs.perm[0])
    want = jh.run_hytm(hs.graph, prog_j, source=src, config=cfg, n_hubs=hs.n_hubs)
    prog_t = dataclasses.replace(talg.ALGORITHMS[name], tolerance=1e-5)
    assert _tconfig(cfg).link == PCIE3.with_(mr=4.0)
    got = th.run_hytm(hs.graph, prog_t, source=src, config=_tconfig(cfg, sync_every=8),
                      n_hubs=hs.n_hubs, device="cpu")
    _check(want, got, prog_t)


@pytest.mark.parametrize("peel_k", [3.0, 5.0])
def test_kcore_deeper_peeling_matches_reference(peel_k):
    g = jgen.rmat_graph(800, 3000, seed=4)
    cfg = jh.HyTMConfig(n_partitions=8, sync_every=1, use_kernels=False)
    want = jh.run_hytm(g, dataclasses.replace(jalg.KCORE, peel_k=peel_k), config=cfg)
    prog = dataclasses.replace(talg.KCORE, peel_k=peel_k)
    got = th.run_hytm(g, prog, config=_tconfig(cfg, sync_every=4), device="cpu")
    assert want.iterations > 1
    _check(want, got, prog)
    removed, deg = jalg.reference_kcore(g, peel_k)
    np.testing.assert_array_equal(got.delta > 0.5, removed)


@pytest.mark.parametrize("name", ["sssp", "cc", "pagerank"])
def test_warm_start_via_convert(name):
    """A warm state made by the reference (a few iterations in) goes to
    both packages through numpy; the port's run from it matches."""
    g = jgen.rmat_graph(600, 5000, seed=8)
    pj, pt = jalg.ALGORITHMS[name], talg.ALGORITHMS[name]
    cfg = jh.HyTMConfig(n_partitions=8, sync_every=1, use_kernels=False)
    part = jh.run_hytm(g, pj, source=_source(pj), config=dataclasses.replace(cfg, max_iters=2))
    values, delta = part.values.copy(), part.delta.copy()
    rng = np.random.default_rng(1)
    frontier = (np.abs(delta) > pj.tolerance) if pj.use_delta else \
        (np.isfinite(values) & (rng.random(g.n_nodes) < 0.5))
    want = jh.run_hytm(g, pj, config=cfg, initial_state=jh.HyTMState(
        jnp.asarray(values), jnp.asarray(delta), jnp.asarray(frontier)))
    rt = th.build_runtime(g, _tconfig(cfg), device="cpu")
    state = convert.hytm_state(values, delta, frontier, "cpu")
    got = th.run_hytm(None, pt, config=_tconfig(cfg, sync_every=4), runtime=rt,
                      initial_state=state)
    _check(want, got, pt)
    # the caller's warm state is not modified
    np.testing.assert_array_equal(state.values.numpy(), values)
    out = convert.result_to_numpy(got)
    assert out["iterations"] == got.iterations and out["history"]["engines"].dtype == np.int32


@pytest.mark.parametrize("K", [1, 3])
def test_empty_frontier_runs_one_iteration(K):
    g = jgen.uniform_graph(300, 2000, seed=1)
    n = g.n_nodes
    cfg = jh.HyTMConfig(n_partitions=4, sync_every=1, use_kernels=False)
    empty = (np.full(n, np.inf, np.float32), np.zeros(n, np.float32), np.zeros(n, bool))
    want = jh.run_hytm(g, jalg.SSSP, config=cfg, initial_state=jh.HyTMState(
        *map(jnp.asarray, empty)))
    got = th.run_hytm(g, talg.SSSP, config=_tconfig(cfg, sync_every=K), device="cpu",
                      initial_state=convert.hytm_state(*empty, "cpu"))
    assert want.iterations == got.iterations == 1
    _check(want, got, talg.SSSP)


@pytest.mark.parametrize("K,max_iters", [(2, 3), (4, 4), (1, 2), (8, 5)])
def test_max_iters_cap_matches_reference(K, max_iters):
    g = jgen.grid_mesh_graph(10, 12, seed=0)
    cfg = jh.HyTMConfig(n_partitions=6, sync_every=1, use_kernels=False, max_iters=max_iters)
    want = jh.run_hytm(g, jalg.BFS, config=cfg)
    got = th.run_hytm(g, talg.BFS, config=_tconfig(cfg, sync_every=K), device="cpu")
    assert got.iterations == max_iters
    _check(want, got, talg.BFS)


def test_chunked_driver_dispatch_counts():
    g = jgen.grid_mesh_graph(12, 12, seed=0)
    for K in (1, 4):
        cfg = th.HyTMConfig(n_partitions=6, sync_every=K)
        with th.count_driver_dispatches() as counts:
            res = th.run_hytm(g, talg.BFS, config=cfg, device="cpu")
        if K == 1:
            assert counts == {"iteration": res.iterations, "chunk": 0}
        else:
            assert counts["iteration"] == 0
            assert counts["chunk"] <= res.iterations // K + 1


def test_unported_features_raise(monkeypatch):
    g = jgen.uniform_graph(50, 300, seed=0)
    # obs= is ported (tests/test_torch_obs.py), and faults/retry/on_chunk
    # (tests/test_torch_resilience.py), and the sharded sweep in both
    # layouts (tests/test_torch_graph_shard*.py): an owner run goes through
    # the sharded path with the owner config
    mesh = GraphMesh(group=None, axis="graph", size=2, rank=0, device=torch.device("cpu"))
    owner = th.HyTMConfig(mesh_axis="graph", vertex_sharding="owner")
    calls = []
    monkeypatch.setattr(tgs, "run_hytm_sharded",
                        lambda g, prog, **kw: calls.append((prog, kw["config"], kw["mesh"])))
    th.run_hytm(g, talg.SSSP, mesh=mesh, config=owner)
    assert calls == [(talg.SSSP, owner, mesh)]
    monkeypatch.undo()
    rt = tgs.build_sharded_runtime(g, owner, mesh)
    assert (rt.vertex_sharding, rt.n_pad, rt.owned) == ("owner", 50, slice(0, 25))
    # the stream and serving paths on a mesh are ported too
    # (tests/test_torch_stream_sharded.py); a view needs a mesh axis
    assert callable(tgs.make_sharded_batched_chunk(rt, talg.SSSP, owner, 4))
    with pytest.raises(ValueError, match="no mesh axis"):
        tstream.DeltaCSR(g, th.HyTMConfig(n_partitions=4), device="cpu").sharded_runtime_for(
            talg.SSSP)
    # autotune is ported: a calibrator is read only with config.autotune
    assert th.run_hytm(g, talg.SSSP, config=th.HyTMConfig(autotune=True),
                       device="cpu").engine_corrections.shape == (3,)
    assert th.run_hytm(g, talg.SSSP, calibrator=object(),
                       device="cpu").engine_corrections is None
    # the lane-batched chunk is ported (tests/test_torch_serve.py holds it),
    # and on a mesh: a service there lives on the mesh's device
    svc = tstream.GraphService(g, th.HyTMConfig(mesh_axis="graph", vertex_sharding="owner"),
                               mesh=mesh)
    assert svc.mesh is mesh and svc.cache.placement.n_loc == 25
    assert svc.scheduler.lane_bytes == 9 * 25
    with pytest.raises(ValueError):
        th.run_hytm(g, talg.SSSP, config=th.HyTMConfig(sync_every=0), device="cpu")
    with pytest.raises(ValueError):
        th.run_hytm(None, talg.SSSP, device="cpu")


def test_runtime_rejects_short_capacity():
    g = jgen.rmat_graph(200, 2000, seed=0)
    rt = th.build_runtime(g, th.HyTMConfig(n_partitions=4), device="cpu")
    short = dataclasses.replace(rt.csr, edge_src=rt.csr.edge_src[:g.n_edges],
                                edge_dst=rt.csr.edge_dst[:g.n_edges],
                                edge_weight=rt.csr.edge_weight[:g.n_edges],
                                edge_valid=rt.csr.edge_valid[:g.n_edges])
    with pytest.raises(ValueError, match="capacity"):
        th.Runtime(csr=short, parts=rt.parts, zc_req=rt.zc_req, inv_deg=rt.inv_deg,
                   n_hub_partitions=0)


@pytest.mark.parametrize("name", ["sssp", "pagerank"])
def test_dead_lane_state_matches_reference(name):
    want = jh.dead_lane_state(jalg.ALGORITHMS[name], 40)
    got = th.dead_lane_state(talg.ALGORITHMS[name], 40, "cpu")
    for a, b in zip(want, got):
        np.testing.assert_array_equal(np.asarray(a), b.numpy())


def test_oracle_on_hub_sorted_graph():
    """SSSP and Δ-PageRank on a hub-sorted RMAT graph against the numpy
    references (PageRank within the Δ tolerance's reach: 1e-3)."""
    from repro_torch.graph.generators import rmat_graph
    from repro_torch.graph.hub_sort import hub_sort

    g = rmat_graph(2000, 20000, seed=0)
    hs = hub_sort(g)
    cfg = th.HyTMConfig(link=PCIE3.with_(mr=4.0), n_partitions=16)
    res = th.run_hytm(hs.graph, talg.SSSP, int(hs.perm[0]), cfg, n_hubs=hs.n_hubs,
                      device="cpu")
    np.testing.assert_allclose(hs.values_to_old(res.values), talg.reference_sssp(g, 0))
    pr = dataclasses.replace(talg.PAGERANK, tolerance=1e-6)
    res = th.run_hytm(hs.graph, pr, None, dataclasses.replace(cfg, cds_mode="delta"),
                      n_hubs=hs.n_hubs, device="cpu")
    np.testing.assert_allclose(hs.values_to_old(res.values + res.delta),
                               talg.reference_pagerank(g), atol=1e-3)
    assert torch.is_tensor(th.HyTMState(*talg.SSSP.init_state(5, 0, "cpu")).values)
