"""The port's sharded stream and serving paths (``DeltaCSR.sharded_runtime_for``,
``run_incremental(mesh=)``, ``GraphService(mesh=)``, ``OwnerPlacement`` and
``dist.graph_shard.make_sharded_batched_chunk``) against the reference, on
gloo ranks on the CPU; the counterpart of ``tests/test_stream_sharded.py``.

One pool of 4 ranks serves the module (a ``launch.mesh.RankPool``, started anew
by ``PoolKeeper`` after a case whose run broke it: this
process is rank 0, three spawned ranks with one thread each); D = 2 cases
run on its ``(0, 1)`` subgroup.  The reference's single-device oracles run
in this process; one forced-device reference subprocess at D = 4, started by
the module's first test, gives the reference's sharded warm-run ICI rows and
its owner service's ICI totals (its cases come last).

Graphs: ``rmat_graph(400, 3200, seed=11)`` and ``rmat_graph(600, 5000,
seed=11)`` (the reference's) and ``rmat_graph(601, 5000, seed=11)``
(``n_pad`` 602 at D = 2, 604 at D = 4: pad vertices exist).

Contract, the reference's own (``tests/test_stream_sharded.py``):
* a warm sharded ``run_incremental`` equals the single-device
  ``async_sweep=False`` warm run: MIN programs bit for bit in values, and
  with autotune off in iterations, transfer bytes and engine rows (the
  padding partitions' rows NONE); it takes fewer iterations than a cold
  sharded run; Δ-PageRank within ``atol=1e-5`` of single-device and 1e-3 of
  a run from scratch;
* the views follow the container's log: each rank's edge columns are its
  slice of the device columns, after every batch and after a
  merge-compaction; the owner halo plan is the reference's
  ``build_halo_plan`` of the reference ``DeltaCSR``'s grid;
* a ``GraphService`` on the mesh answers as the reference's single-device
  sync service: cold lanes, cache hits, incremental refreshes, k-core down
  the global path, and a spill and promote under a budget; its ICI totals
  are the reference's ``halo_level_cost``/``ici_level_cost`` of its merged
  rows;
* every rank's results are identical, autotune corrections included.
"""

import dataclasses
import os
import subprocess
import sys
import textwrap
from pathlib import Path

import numpy as np
import pytest
import torch

from repro import stream as jstream
from repro.core import hytm as jh
from repro.core.constants import TPU_V5E_ICI as J_ICI
from repro.dist import graph_shard as jgs
from repro.graph import algorithms as jalg
from repro.graph import generators as jgen
from repro.launch.mesh import forced_host_device_env
from repro_torch import convert
from repro_torch.core import hytm as th
from repro_torch.core.cost_model import KEY_ENGINE_CORRECTIONS, KEY_ICI_BYTES, KEY_ICI_TIME
from repro_torch.dist import graph_shard as tgs
from repro_torch.graph import algorithms as talg
from repro_torch.graph.csr import CSRGraph
from repro_torch.launch.mesh import GraphMesh, PoolKeeper, make_graph_mesh
from repro_torch.obs import TraceRecorder
from repro_torch.obs.export import CAT_ICI
from repro_torch.resilience import FaultSpec, RetryPolicy, Supervisor, plan_of
from repro_torch.serve import OwnerPlacement, TierPolicy, WarmCache
from repro_torch import stream as tstream

SUM_ATOL = 1e-5
BATCHES = 3
GRAPHS = {"g400": lambda: jgen.rmat_graph(400, 3200, seed=11),
          "g600": lambda: jgen.rmat_graph(600, 5000, seed=11),
          "g601": lambda: jgen.rmat_graph(601, 5000, seed=11)}
PR = dataclasses.replace(jalg.PAGERANK, tolerance=1e-6)
T_PR = dataclasses.replace(talg.PAGERANK, tolerance=1e-6)
SERVE_SOURCES = [0, 5, 9, 17, 23, 31]
KCORE, T_KCORE = jalg.ALGORITHMS["kcore"], talg.ALGORITHMS["kcore"]


def _tconfig(cfg: jh.HyTMConfig, **kw) -> th.HyTMConfig:
    """The port's config of a reference config, ``link`` and ``ici_link`` both
    carried through ``convert.link_model``."""
    names = {f.name for f in dataclasses.fields(th.HyTMConfig)} - {"link", "ici_link"}
    vals = {k: getattr(cfg, k) for k in names}
    vals.update(kw)
    return th.HyTMConfig(link=convert.link_model(dataclasses.asdict(cfg.link)),
                         ici_link=convert.link_model(dataclasses.asdict(cfg.ici_link)), **vals)


def _tgraph(g) -> CSRGraph:
    return CSRGraph(g.indptr, g.indices, g.weights)


def _tbatch(b):
    return tstream.EdgeBatch(b.op, b.src, b.dst, b.weight)


def _warm_cfg(k: int, P: int = 8, **kw) -> jh.HyTMConfig:
    """The reference's warm-equivalence config (``test_stream_sharded.py``);
    ``P = 7`` pads to 8 partitions at D = 2 and 4."""
    return jh.HyTMConfig(n_partitions=P, async_sweep=False, sync_every=k, **kw)


def _serve_cfg(P: int = 16) -> jh.HyTMConfig:
    return jh.HyTMConfig(n_partitions=P, async_sweep=False, sync_every=4)


# --------------------------------------------------------------------------
# the reference's sharded runs: one forced-device subprocess at D = 4
# --------------------------------------------------------------------------

_REFERENCE_SCRIPT = """
    import dataclasses, sys
    import jax
    import numpy as np
    assert len(jax.devices()) == 4, jax.devices()
    from repro.core.hytm import HyTMConfig, run_hytm
    from repro.graph.algorithms import SSSP
    from repro.graph.generators import rmat_graph
    from repro.stream import DeltaCSR, GraphService, random_batch, run_incremental

    out = {}
    g = rmat_graph(400, 3200, seed=11)
    for layout in ("replicated", "owner"):
        cfg1 = HyTMConfig(n_partitions=8, async_sweep=False, sync_every=1)
        cfgS = dataclasses.replace(cfg1, mesh_axis="graph", vertex_sharding=layout)
        dc = DeltaCSR(g, cfgS)
        dc.sharded_runtime_for(SSSP)
        warm = run_hytm(None, SSSP, source=0, config=cfg1, runtime=dc.runtime_for(SSSP))
        rng = np.random.default_rng(100)
        for b in range(3):
            rep = dc.apply(random_batch(dc, rng, n_insert=8, n_delete=8))
            inc = run_incremental(dc, SSSP, [rep], warm.values, warm.delta, source=0,
                                  config=cfgS)
            for k in ("ici_bytes", "ici_time", "ici_engine"):
                out[f"warm_{layout}_{b}/{k}"] = inc.history[k]
            warm = inc
    g = rmat_graph(600, 5000, seed=11)
    cfg = HyTMConfig(n_partitions=16, async_sweep=False, sync_every=4, mesh_axis="graph",
                     vertex_sharding="owner")
    svc = GraphService(g, config=cfg, max_lanes=4)
    srcs = [0, 5, 9, 17, 23, 31]
    for r in svc.query(SSSP, srcs):
        out[f"serve_owner_cold_{r.source}/values"] = np.asarray(r.values)
    out["serve_owner/ici_bytes"] = np.asarray(svc.stats.extra["ici_bytes"])
    out["serve_owner/ici_time"] = np.asarray(svc.stats.extra["ici_time"])
    np.savez(sys.argv[1], **out)
"""


class _Reference:
    """The subprocess running ``_REFERENCE_SCRIPT``; ``get(case)`` waits for
    it (at most ``timeout`` s) and returns the case's arrays."""

    def __init__(self, folder: Path, timeout: float = 400.0):
        self.path = folder / "reference.npz"
        self.timeout = timeout
        self.proc = subprocess.Popen(
            [sys.executable, "-c", textwrap.dedent(_REFERENCE_SCRIPT), str(self.path)],
            stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True,
            env=forced_host_device_env(4))
        self.data = None

    def get(self, case: str) -> dict:
        if self.data is None:
            out, err = self.proc.communicate(timeout=self.timeout)
            assert self.proc.returncode == 0, f"stdout:\n{out}\nstderr:\n{err[-4000:]}"
            with np.load(self.path) as z:
                self.data = dict(z)
        return {k.split("/", 1)[1]: v for k, v in self.data.items()
                if k.startswith(case + "/")}

    def close(self):
        if self.proc.poll() is None:
            self.proc.kill()
        self.proc.communicate()


@pytest.fixture(scope="module", autouse=True)
def ref_sharded(tmp_path_factory):
    """Started by the module's first test, so that it runs beside the cases
    that need no reference sharded run (those that do come last)."""
    ref = _Reference(tmp_path_factory.mktemp("stream_sharded"))
    yield ref
    ref.close()


@pytest.fixture(scope="module")
def pools(ref_sharded):
    with PoolKeeper(4, subgroups=[(0, 1)], threads=1, timeout_s=60.0) as keeper:
        yield keeper


@pytest.fixture
def pool(pools):
    """The module's pool, or a fresh one after a case whose run broke it."""
    return pools.get()


def _ranks(d: int):
    return None if d == 4 else (0, 1)


# --------------------------------------------------------------------------
# the reference's single-device oracles (this process)
# --------------------------------------------------------------------------

_MEMO: dict = {}


def _memo(key, fn):
    if key not in _MEMO:
        _MEMO[key] = fn()
    return _MEMO[key]


def _warm_chain(gname: str, prog_name: str, k: int, P: int = 8):
    """The reference's single-device sync chain: the batches (drawn from its
    ``DeltaCSR`` with ``default_rng(100)``, 8 inserts and 8 deletes each),
    the cold warm start, and each batch's warm run and run from scratch."""
    def run():
        prog = PR if prog_name == "pagerank" else jalg.ALGORITHMS[prog_name]
        src = None if prog_name == "pagerank" else 0
        cfg = _warm_cfg(k, P, cds_mode="delta" if prog_name == "pagerank" else "hub")
        g = GRAPHS[gname]()
        dc = jstream.DeltaCSR(g, cfg)
        warm = jh.run_hytm(None, prog, source=src, config=cfg, runtime=dc.runtime_for(prog))
        first = warm
        rng = np.random.default_rng(100)
        batches, incs, scratch = [], [], []
        for _ in range(BATCHES):
            b = jstream.random_batch(dc, rng, n_insert=8, n_delete=8)
            rep = dc.apply(b)
            batches.append(b)
            warm = jstream.run_incremental(dc, prog, [rep], warm.values, warm.delta,
                                           source=src, config=cfg)
            incs.append(warm)
            if prog_name == "pagerank":
                scratch.append(jh.run_hytm(dc.to_host_graph(), prog, source=src, config=cfg))
        return {"batches": batches, "first": first, "incs": incs, "scratch": scratch,
                "cfg": cfg}
    return _memo(("warm", gname, prog_name, k, P), run)


def _service_oracle(gname: str, budget_lanes: int = 4):
    """The reference's single-device sync service over the module's query
    sequence: cold SSSP lanes, the repeat, one update and the re-query,
    k-core; then BFS at 2 lanes, one more update and the BFS re-query."""
    def run():
        g = GRAPHS[gname]()
        svc = jstream.GraphService(g, _serve_cfg(), max_lanes=4)
        rng = np.random.default_rng(3)
        out = {"cold": svc.query(jalg.SSSP, SERVE_SOURCES)}
        out["hits"] = svc.query(jalg.SSSP, SERVE_SOURCES)
        out["batch1"] = jstream.random_batch(svc.dcsr, rng, n_insert=120, n_delete=60)
        svc.update(out["batch1"])
        out["inc"] = svc.query(jalg.SSSP, SERVE_SOURCES)
        out["kcore"] = svc.query(KCORE, [None])
        small = jstream.GraphService(g, _serve_cfg(), max_lanes=2)
        out["bfs"] = small.query(jalg.BFS, SERVE_SOURCES)
        out["batch2"] = jstream.random_batch(small.dcsr, np.random.default_rng(9),
                                             n_insert=50, n_delete=30)
        small.update(out["batch2"])
        out["bfs2"] = small.query(jalg.BFS, SERVE_SOURCES)
        return out
    return _memo(("serve", gname), run)


# --------------------------------------------------------------------------
# the ranks' parts (pickled to the spawned ranks by import path)
# --------------------------------------------------------------------------

def _rank_warm(group, g, prog_name, cfg, first, batches, opts):
    """One rank's warm chain over its own ``DeltaCSR``: the view registered
    before the first batch, each batch applied, the sharded warm run, a cold
    sharded run, and the view's columns held against the container's."""
    prog = T_PR if prog_name == "pagerank" else talg.ALGORITHMS[prog_name]
    src = None if prog_name == "pagerank" else 0
    mesh = make_graph_mesh(group=group, device="cpu")
    dc = tstream.DeltaCSR(g, cfg, device="cpu")
    view = dc.sharded_runtime_for(prog, mesh)
    assert dc.sharded_runtime_for(prog, mesh) is view
    values, delta = first
    out = {"rank": mesh.rank, "runs": [], "cold": [], "views": [], "corrections": []}
    for b in batches:
        rep = dc.apply(b)
        out["views"].append(_view_matches(dc, view))
        res = tstream.run_incremental(dc, prog, [rep], values, delta, source=src, config=cfg,
                                      mesh=mesh)
        out["runs"].append(res)
        if opts.get("cold"):
            out["cold"].append(th.run_hytm(None, prog, src, cfg, runtime=view).iterations)
        values, delta = res.values, res.delta
    if opts.get("merge"):
        # the no-slack case: enough inserts from one vertex to overflow its block
        u = int(np.argmax(np.diff(dc.vertex_start)))
        u = int(dc.vertex_start[u])
        n_ins = dc.block_size - int(dc.counts[dc.vertex_part[u]]) + 1
        rng = np.random.default_rng(4)
        rep = dc.apply(tstream.EdgeBatch.inserts(np.full(n_ins, u), rng.integers(0, dc.n_nodes,
                                                                               n_ins),
                                                 np.ones(n_ins, np.float32)))
        assert rep.merged and dc.layout_version == 1
        out["merge_view"] = _view_matches(dc, view)
        out["merge_run"] = tstream.run_incremental(dc, prog, [rep], values, delta, source=src,
                                                   config=cfg, mesh=mesh)
        single = dataclasses.replace(cfg, mesh_axis=None, vertex_sharding="replicated")
        out["merge_single"] = tstream.run_incremental(dc, prog, [rep], values, delta,
                                                      source=src, config=single)
    return out


def _view_matches(dc, view) -> bool:
    """The view's edge columns are the rank's slice of the device columns
    (views of them), its table and vectors the container's, padded."""
    D, r = view.mesh.size, view.mesh.rank
    P, B = dc.n_partitions, dc.block_size
    P_pad = -(-P // D) * D
    P_local = P_pad // D
    e0, e1 = r * P_local * B, max(r * P_local, min((r + 1) * P_local, P)) * B
    ok = view.edge_base == e0 and view.n_partitions == P_pad
    for mine, whole in ((view.edge_src, dc.csr.edge_src), (view.edge_dst, dc.csr.edge_dst),
                        (view.edge_weight, dc.csr.edge_weight)):
        ok &= torch.equal(mine, whole[e0:e1])
        ok &= mine.shape[0] == 0 or mine.data_ptr() == whole[e0:].data_ptr()
    counts = view.parts.part_edges.tolist()
    ok &= counts[:P] == dc.counts.tolist() and not any(counts[P:])
    ok &= view.parts.edge_start.tolist() == [p * B for p in range(P_pad + 1)]
    n = dc.n_nodes
    ok &= torch.equal(view.out_degree[:n], dc.csr.out_degree)
    ok &= torch.equal(view.zc_req[:n], dc.zc_req)
    ok &= bool((view.out_degree[n:] == 0).all()) and bool((view.inv_deg[n:] == 1).all())
    return bool(ok)


def _rank_service(group, g, cfg, budget, batches, opts):
    """One rank's mesh services over the module's query sequence (the
    reference oracle's), in the same order on every rank."""
    mesh = make_graph_mesh(group=group, device="cpu")
    obs = TraceRecorder()
    svc = tstream.GraphService(g, cfg, max_lanes=4, mesh=mesh, obs=obs)
    out = {"rank": mesh.rank, "lane_bytes": svc.scheduler.lane_bytes,
           "cold": svc.query(talg.SSSP, SERVE_SOURCES)}
    # the cold lanes' second-level charge (later sharded runs record their
    # own ICI instants; only lane chunks add to stats.extra)
    out["ici"] = [dict(ev.args) for ev in obs.events if ev.cat == CAT_ICI]
    out["extra"] = {k: svc.stats.extra.get(k) for k in (KEY_ICI_BYTES, KEY_ICI_TIME)}
    out["hits"] = svc.query(talg.SSSP, SERVE_SOURCES)
    svc.update(batches[0])
    out["inc"] = svc.query(talg.SSSP, SERVE_SOURCES)
    out["kcore"] = svc.query(T_KCORE, [None])
    out["kcore_hit"] = svc.query(T_KCORE, [3])
    out["extra_end"] = {k: svc.stats.extra.get(k) for k in (KEY_ICI_BYTES, KEY_ICI_TIME)}
    small = tstream.GraphService(g, cfg, max_lanes=2, mesh=mesh, device_budget_bytes=budget)
    out["bfs"] = small.query(talg.BFS, SERVE_SOURCES)
    small.update(batches[1])
    out["bfs2"] = small.query(talg.BFS, SERVE_SOURCES)
    out["cache"] = small.cache.stats.as_dict()
    out["max_device_bytes"] = small.scheduler.stats.max_device_bytes
    out["small_lane_bytes"] = small.scheduler.lane_bytes
    if opts.get("autotune"):
        tuned = tstream.GraphService(g, dataclasses.replace(cfg, autotune=True), max_lanes=4,
                                     mesh=mesh)
        out["tuned"] = tuned.query(talg.SSSP, SERVE_SOURCES)
        tuned.update(batches[0])
        out["tuned_inc"] = tuned.query(talg.SSSP, SERVE_SOURCES[:2])
        out["corrections"] = tuned.stats.extra[KEY_ENGINE_CORRECTIONS]
    return out


def _rank_faults(group, g, cfg, seed):
    """A seeded ``lane_dispatch`` plan on every rank: it fires alike and the
    retried answers stand."""
    mesh = make_graph_mesh(group=group, device="cpu")
    plan = plan_of(FaultSpec("lane_dispatch", "fail", p=0.5), seed=seed)
    svc = tstream.GraphService(g, cfg, max_lanes=4, mesh=mesh, faults=plan,
                               supervisor=Supervisor(policy=RetryPolicy(max_attempts=16)))
    res = svc.query(talg.SSSP, SERVE_SOURCES)
    return {"fired": [(e.site, e.kind, e.occurrence) for e in plan.events], "res": res}


# --------------------------------------------------------------------------
# checks
# --------------------------------------------------------------------------

def _same_result(a, b):
    """Two ranks' results, bit for bit."""
    np.testing.assert_array_equal(a.values, b.values)
    np.testing.assert_array_equal(a.delta, b.delta)
    assert a.iterations == b.iterations and a.history.keys() == b.history.keys()
    for k in a.history:
        np.testing.assert_array_equal(a.history[k], b.history[k], err_msg=k)
    np.testing.assert_array_equal(a.engine_corrections, b.engine_corrections)


def _same_answers(a, b, exact=True):
    assert len(a) == len(b)
    for x, y in zip(a, b):
        assert (x.source, x.mode, x.iterations, x.cache_hit) == \
            (y.source, y.mode, y.iterations, y.cache_hit)
        assert y.values.shape == np.asarray(x.values).shape
        if exact:
            np.testing.assert_array_equal(np.asarray(x.values), y.values)
        else:
            np.testing.assert_allclose(np.asarray(x.values), y.values, rtol=0, atol=SUM_ATOL)


def _check_warm(want, got, P):
    """A MIN warm run against the reference's single-device sync run."""
    np.testing.assert_array_equal(np.asarray(want.values), got.values)
    assert want.iterations == got.iterations
    assert want.total_transfer_bytes == got.total_transfer_bytes
    np.testing.assert_array_equal(want.history["engines"], got.history["engines"][:, :P])
    assert (got.history["engines"][:, P:] == -1).all()


# --------------------------------------------------------------------------
# 1. host-side: views, halo plans, placement, guards
# --------------------------------------------------------------------------

def _fake_mesh(D, r):
    return GraphMesh(group=None, axis="graph", size=D, rank=r, device=torch.device("cpu"))


@pytest.mark.parametrize("P", [8, 7, 3])
@pytest.mark.parametrize("D", [2, 4])
@pytest.mark.parametrize("gname", ["g600", "g601"])
def test_owner_halo_plan_follows_the_log(gname, D, P):
    """Every rank's view of an owner ``DeltaCSR``: its halo plan equals the
    reference's ``build_halo_plan`` of the reference ``DeltaCSR``'s padded
    grid, at the start and after each batch (the views built before the
    first batch, so the plans are the patched ones), and its columns are its
    slice of the container's (rank 3 of P = 3 holds only padding)."""
    jg = GRAPHS[gname]()
    jcfg = jh.HyTMConfig(n_partitions=P)
    jdc = jstream.DeltaCSR(jg, jcfg)
    cfg = _tconfig(jcfg, mesh_axis="graph", vertex_sharding="owner")
    # one container a rank, as each rank of a group holds its own
    dcs = [tstream.DeltaCSR(_tgraph(jg), cfg, device="cpu") for _ in range(D)]
    views = [dc.sharded_runtime_for(talg.SSSP, _fake_mesh(D, r)) for r, dc in enumerate(dcs)]
    rng = np.random.default_rng(1)
    for b in range(BATCHES + 1):
        if b:
            batch = jstream.random_batch(jdc, rng, n_insert=20, n_delete=20, n_reweight=5)
            jdc.apply(batch)
            for dc in dcs:
                dc.apply(_tbatch(batch))
        _, grid = jdc._grid_arrays(D)
        want = jgs.build_halo_plan(grid(jdc._src, 0), grid(jdc._dst, 0),
                                   grid(jdc._valid, False), jdc.n_nodes, D)
        for dc, v in zip(dcs, views):
            assert (v.halo.n_pad, v.halo.n_loc, v.halo.halo_counts, v.halo.halo_total) == \
                (want.n_pad, want.n_loc, want.halo_counts, want.halo_total)
            assert v.n_pad == want.n_pad and v.owned == slice(v.mesh.rank * want.n_loc,
                                                              (v.mesh.rank + 1) * want.n_loc)
            assert _view_matches(dc, v)
    assert sum(v.edge_src.shape[0] for v in views) == P * dcs[0].block_size


@pytest.mark.parametrize("layout", ["replicated", "owner"])
def test_view_is_registered_and_keyed(layout):
    """One view per (axis, group ranks, weighted, layout); a weighted
    program's view has its own ``inv_deg``; a patch keeps the object and
    refreshes it, and a merge-compaction refills it."""
    g = _tgraph(GRAPHS["g400"]())
    cfg = th.HyTMConfig(n_partitions=7, mesh_axis="graph", vertex_sharding=layout)
    dc = tstream.DeltaCSR(g, cfg, device="cpu")
    mesh = _fake_mesh(2, 1)
    a = dc.sharded_runtime_for(talg.SSSP, mesh)
    assert dc.sharded_runtime_for(talg.BFS, _fake_mesh(2, 1)) is a
    php = talg.ALGORITHMS["php"]
    w = dc.sharded_runtime_for(php, mesh)
    assert w is not a and len(dc._sharded_views) == 2
    assert torch.equal(w.inv_deg[:g.n_nodes], dc.runtime_for(php).inv_deg)
    dc.apply(tstream.EdgeBatch.inserts([5], [9], [2.0]))
    assert dc.sharded_runtime_for(talg.SSSP, mesh) is a and _view_matches(dc, a)
    assert a.parts.part_edges.tolist()[:7] == dc.counts.tolist()
    assert dc.view_seconds["patch"] > 0.0
    big = int(dc.block_size)
    dc.apply(tstream.EdgeBatch.inserts(np.zeros(big, np.int64), np.arange(big) % 400,
                                       np.ones(big, np.float32)))
    assert dc.layout_version == 1 and _view_matches(dc, a) and _view_matches(dc, w)


def test_guards_fire_with_assertions_disabled():
    """The guards are raised exceptions: under ``python -O`` a view without a
    mesh axis, a mesh without the configured axis and a mesh on another
    device still raise ``ValueError``."""
    script = """
        import numpy as np, torch
        from repro_torch.core.hytm import HyTMConfig
        from repro_torch.graph.algorithms import BFS
        from repro_torch.graph.generators import rmat_graph
        from repro_torch.launch.mesh import GraphMesh
        from repro_torch.stream import DeltaCSR, GraphService

        def expect(fn):
            try:
                fn()
            except ValueError:
                return
            raise SystemExit(f"guard did not fire: {fn}")

        g = rmat_graph(50, 200, seed=0)
        mesh = GraphMesh(group=None, axis="graph", size=1, rank=0, device=torch.device("cpu"))
        expect(lambda: DeltaCSR(g, HyTMConfig(), device="cpu").sharded_runtime_for(BFS, mesh))
        expect(lambda: DeltaCSR(g, HyTMConfig(mesh_axis="nope"), device="cpu")
               .sharded_runtime_for(BFS, mesh))
        expect(lambda: DeltaCSR(g, HyTMConfig(mesh_axis="graph", vertex_sharding="rows"),
                                device="cpu").sharded_runtime_for(BFS, mesh))
        expect(lambda: GraphService(g, HyTMConfig(mesh_axis="nope"), mesh=mesh))
        print("GUARDS-OK", __debug__)
    """
    src = Path(__file__).resolve().parents[1] / "src"
    out = subprocess.run([sys.executable, "-O", "-c", textwrap.dedent(script)],
                         capture_output=True, text=True, timeout=120,
                         env={**os.environ, "PYTHONPATH": str(src)})
    assert out.returncode == 0 and "GUARDS-OK False" in out.stdout, out.stderr[-3000:]


def test_owner_placement_and_cache_round_trip():
    """``OwnerPlacement`` without a collective: each rank's slice of a
    canonical state, zeros past ``n`` on the last rank, 8·n_loc device bytes;
    a ``WarmCache`` with it charges the per-rank share and spills to the
    canonical bytes (the gather is exercised on the ranks below)."""
    n, D = 601, 4
    vals = np.arange(n, dtype=np.float32)
    for r in range(D):
        pl = OwnerPlacement(_fake_mesh(D, r), n)
        assert (pl.n_loc, pl.n_pad) == (151, 604)
        got = pl.to_device(vals)
        want = np.concatenate([vals, np.zeros(3, np.float32)])[151 * r:151 * (r + 1)]
        np.testing.assert_array_equal(got.numpy(), want)
        np.testing.assert_array_equal(pl.to_device(torch.from_numpy(vals)).numpy(), want)
        cache = WarmCache(TierPolicy(device_budget_bytes=None), placement=pl)
        e = cache.put(("k", 0), 1, vals, vals + 1)
        assert e.nbytes == 8 * 151 and cache.device_bytes == 8 * 151 and e.placement is pl


# --------------------------------------------------------------------------
# 2. warm equivalence on the ranks
# --------------------------------------------------------------------------

def _warm_outs(pool, D, layout, k, autotune, gname="g400", P=8):
    """The ranks' SSSP warm chains (memoized: the ICI cases reuse them)."""
    def run():
        chain = _warm_chain(gname, "sssp", k, P)
        cfg = _tconfig(chain["cfg"], mesh_axis="graph", vertex_sharding=layout,
                       autotune=autotune)
        first = (chain["first"].values, chain["first"].delta)
        return pool.run(_rank_warm, _tgraph(GRAPHS[gname]()), "sssp", cfg, first,
                        [_tbatch(b) for b in chain["batches"]], {"cold": True},
                        ranks=_ranks(D))
    return _memo(("warm_outs", D, layout, k, autotune, gname, P), run)


@pytest.mark.parametrize("autotune", [False, True], ids=["plain", "autotune"])
@pytest.mark.parametrize("k", [1, 4])
@pytest.mark.parametrize("layout", ["replicated", "owner"])
@pytest.mark.parametrize("D", [2, 4])
def test_warm_equivalence(pool, D, layout, k, autotune):
    """SSSP warm-started over 3 batches: bit-equal in values to the
    reference's single-device sync ``run_incremental`` (with autotune off in
    iterations, bytes and engine rows too, padding rows NONE), fewer
    iterations than a cold sharded run, the views equal to the container's
    slices after every batch, and every rank identical (autotune corrections
    included)."""
    chain = _warm_chain("g400", "sssp", k)
    outs = _warm_outs(pool, D, layout, k, autotune)
    for o in outs:
        assert all(o["views"])
    for b in range(BATCHES):
        got = outs[0]["runs"][b]
        for o in outs[1:]:
            _same_result(got, o["runs"][b])
        want = chain["incs"][b]
        if autotune:
            np.testing.assert_array_equal(np.asarray(want.values), got.values)
            assert got.engine_corrections.shape == (3,)
        else:
            _check_warm(want, got, 8)
        assert got.iterations < outs[0]["cold"][b], (got.iterations, outs[0]["cold"][b])


@pytest.mark.parametrize("layout", ["replicated", "owner"])
@pytest.mark.parametrize("D", [2, 4])
def test_warm_equivalence_padded_partitions(pool, D, layout):
    """7 partitions padded to 8 on the graph with pad vertices: the padding
    partition's rank plans NONE on it, launches nothing there and the warm
    runs stay bit-equal to the single-device sync ones (values, iterations,
    bytes, engine rows)."""
    chain = _warm_chain("g601", "sssp", 4, P=7)
    outs = _warm_outs(pool, D, layout, 4, False, gname="g601", P=7)
    for b in range(BATCHES):
        got = outs[0]["runs"][b]
        for o in outs[1:]:
            _same_result(got, o["runs"][b])
        assert got.history["engines"].shape[1] == 8
        _check_warm(chain["incs"][b], got, 7)
        # a batch may reach as deep as the cold run here (the reference
        # claims fewer iterations on its own graph: test_warm_equivalence)
        assert got.iterations <= outs[0]["cold"][b]
    assert all(all(o["views"]) for o in outs)


@pytest.mark.parametrize("layout", ["replicated", "owner"])
@pytest.mark.parametrize("D", [2, 4])
def test_warm_pagerank_and_merge_compaction(pool, D, layout):
    """Δ-PageRank warm-started over 3 batches on the graph with pad
    vertices: within ``atol=1e-5`` of the reference's single-device sync
    warm run and 1e-3 of a run from scratch, ranks identical; then the
    no-slack merge-compaction: the views refilled from the re-blocked log
    and the warm run equal to the single-device one's (within ``atol``)."""
    chain = _warm_chain("g601", "pagerank", 4)
    cfg = _tconfig(chain["cfg"], mesh_axis="graph", vertex_sharding=layout)
    first = (chain["first"].values, chain["first"].delta)
    outs = pool.run(_rank_warm, _tgraph(GRAPHS["g601"]()), "pagerank", cfg, first,
                    [_tbatch(b) for b in chain["batches"]], {"merge": True}, ranks=_ranks(D))
    for o in outs:
        assert all(o["views"]) and o["merge_view"]
    for b in range(BATCHES):
        got = outs[0]["runs"][b]
        for o in outs[1:]:
            _same_result(got, o["runs"][b])
        want = chain["incs"][b]
        np.testing.assert_allclose(np.asarray(want.values + want.delta), got.values + got.delta,
                                   rtol=0, atol=SUM_ATOL)
        s = chain["scratch"][b]
        np.testing.assert_allclose(np.asarray(s.values + s.delta), got.values + got.delta,
                                   rtol=0, atol=1e-3)
    m, single = outs[0]["merge_run"], outs[0]["merge_single"]
    for o in outs[1:]:
        _same_result(m, o["merge_run"])
    np.testing.assert_allclose(single.values + single.delta, m.values + m.delta, rtol=0,
                               atol=SUM_ATOL)


@pytest.mark.parametrize("layout", ["replicated", "owner"])
def test_warm_merge_compaction_min_bit_equal(pool, layout):
    """SSSP through the no-slack merge-compaction at D = 4 (8 partitions):
    the refilled views' warm run bit-equal to the single-device sync one."""
    chain = _warm_chain("g400", "sssp", 4)
    cfg = _tconfig(chain["cfg"], mesh_axis="graph", vertex_sharding=layout)
    first = (chain["first"].values, chain["first"].delta)
    outs = pool.run(_rank_warm, _tgraph(GRAPHS["g400"]()), "sssp", cfg, first,
                    [_tbatch(b) for b in chain["batches"][:1]], {"merge": True})
    m, single = outs[0]["merge_run"], outs[0]["merge_single"]
    assert all(o["merge_view"] for o in outs)
    for o in outs[1:]:
        _same_result(m, o["merge_run"])
    np.testing.assert_array_equal(single.values, m.values)
    assert (single.iterations, single.total_transfer_bytes) == \
        (m.iterations, m.total_transfer_bytes)
    np.testing.assert_array_equal(single.history["engines"], m.history["engines"])


def test_ici_rows_are_chunk_size_invariant(pool):
    """At D = 4 with autotune off, the warm runs' ICI rows at K = 1 equal
    those at K = 4, batch by batch and in both layouts, and are charged."""
    for layout in ("replicated", "owner"):
        for b in range(BATCHES):
            a, c = (_warm_outs(pool, 4, layout, k, False)[0]["runs"][b].history
                    for k in (1, 4))
            for key in ("ici_bytes", "ici_time", "ici_engine"):
                np.testing.assert_array_equal(a[key], c[key], err_msg=key)
            assert a["ici_bytes"].sum() > 0


# --------------------------------------------------------------------------
# 3. serving on the ranks
# --------------------------------------------------------------------------

def _check_service(outs, want, D, layout, n):
    got = outs[0]
    for o in outs[1:]:
        for key in ("cold", "hits", "inc", "kcore", "kcore_hit", "bfs", "bfs2"):
            _same_answers(got[key], o[key])
        assert (o["extra"], o["extra_end"], o["cache"], o["ici"]) == \
            (got["extra"], got["extra_end"], got["cache"], got["ici"])
    assert got["extra_end"] == got["extra"]
    _same_answers(want["cold"], got["cold"])
    assert all(r.mode == "batched" for r in got["cold"])
    _same_answers(want["hits"], got["hits"])
    assert all(r.cache_hit and r.iterations == 0 for r in got["hits"])
    _same_answers(want["inc"], got["inc"])
    assert all(r.mode == "incremental" for r in got["inc"])
    _same_answers(want["kcore"], got["kcore"])
    assert got["kcore"][0].mode == "batched" and got["kcore_hit"][0].cache_hit
    n_loc = -(-n // D) if layout == "owner" else n
    assert got["lane_bytes"] == got["small_lane_bytes"] == 9 * n_loc
    _same_answers(want["bfs"], got["bfs"])
    _same_answers(want["bfs2"], got["bfs2"])
    assert got["cache"]["spills"] > 0 and got["cache"]["promotions"] > 0, got["cache"]
    assert got["max_device_bytes"] <= 40 * n_loc


def _check_ici_model(got, D, layout, n, halo_total):
    """The cold lanes' ICI totals: the reference's cost functions of the
    merged rows their ``ici`` instants carry, summed in the same order
    (every chunk of the 4-lane service runs 6 sources at bucket 4)."""
    total_b = total_t = 0.0
    names = {0: "filter", 1: "compact", 2: "zerocopy", -1: "none"}
    for ev in got["ici"]:
        me = ev["merged_entries"]
        if layout == "owner":
            cap = 4.0 * float(halo_total)
            ib, it_, ie = jgs.halo_level_cost(4 * n, me, cap, D, J_ICI, None)
            assert ev["halo_entries"] == min(me, cap)
        else:
            ib, it_, ie = jgs.ici_level_cost(4 * n, me, D, J_ICI, None)
            assert "halo_entries" not in ev
        assert (ev["bytes"], ev["modeled_seconds"], ev["engine"]) == (ib, it_, names[ie])
        total_b += ib
        total_t += it_
    assert got["extra"][KEY_ICI_BYTES] == total_b and got["extra"][KEY_ICI_TIME] == total_t


def _service_run(pool, gname, D, layout, **opts):
    want = _service_oracle(gname)
    jg = GRAPHS[gname]()
    cfg = _tconfig(_serve_cfg(), mesh_axis="graph", vertex_sharding=layout)
    n_loc = -(-jg.n_nodes // D) if layout == "owner" else jg.n_nodes
    outs = pool.run(_rank_service, _tgraph(jg), cfg, 40 * n_loc,
                    [_tbatch(want["batch1"]), _tbatch(want["batch2"])], opts, ranks=_ranks(D))
    return want, outs


@pytest.mark.parametrize("layout", ["replicated", "owner"])
@pytest.mark.parametrize("D", [2, 4])
def test_service_matches_single_device(pool, D, layout):
    """``GraphService(mesh=)`` on the graph with pad vertices against the
    reference's single-device sync service: cold lanes (6 sources on 4
    lanes: backfill), the repeat all cache hits, one update and the
    incremental re-query, k-core down the global path, ``lane_bytes`` 9·n_loc
    under the owner layout, and a 2-lane service under a budget of 40 rows'
    bytes that spills, then promotes, bit-equal; the ICI totals are the
    model's charge of the merged rows; every rank identical, and with
    autotune their corrections too."""
    jg = GRAPHS["g601"]()
    want, outs = _service_run(pool, "g601", D, layout, autotune=D == 2)
    _check_service(outs, want, D, layout, jg.n_nodes)
    halo = None
    if layout == "owner":
        jdc = jstream.DeltaCSR(jg, jh.HyTMConfig(n_partitions=16))
        _, grid = jdc._grid_arrays(D)
        halo = jgs.build_halo_plan(grid(jdc._src, 0), grid(jdc._dst, 0),
                                   grid(jdc._valid, False), jdc.n_nodes, D).halo_total
    assert outs[0]["ici"] and outs[0]["extra"][KEY_ICI_BYTES] > 0
    _check_ici_model(outs[0], D, layout, jg.n_nodes, halo)
    if D == 2:
        assert outs[0]["corrections"] == outs[1]["corrections"]
        for a, b in zip(outs[0]["tuned"] + outs[0]["tuned_inc"],
                        outs[1]["tuned"] + outs[1]["tuned_inc"]):
            np.testing.assert_array_equal(a.values, b.values)
        for a, b in zip(want["cold"], outs[0]["tuned"]):
            np.testing.assert_array_equal(np.asarray(a.values), b.values)


@pytest.mark.parametrize("layout", ["replicated", "owner"])
@pytest.mark.parametrize("D", [2, 4])
def test_lane_dispatch_faults_fire_alike(pool, D, layout):
    """A seeded ``lane_dispatch`` plan (p = 0.5) fires at the same
    occurrences on every rank, and the retried answers equal the reference's
    single-device sync service's; 7 partitions, so the lanes also run over
    a padding partition (NONE in every lane)."""
    want = _memo(("serve7",), lambda: jstream.GraphService(
        GRAPHS["g601"](), _serve_cfg(7), max_lanes=4).query(jalg.SSSP, SERVE_SOURCES))
    cfg = _tconfig(_serve_cfg(7), mesh_axis="graph", vertex_sharding=layout)
    outs = pool.run(_rank_faults, _tgraph(GRAPHS["g601"]()), cfg, 3, ranks=_ranks(D))
    assert outs[0]["fired"] and all(o["fired"] == outs[0]["fired"] for o in outs)
    for o in outs:
        _same_answers(want, o["res"])


# --------------------------------------------------------------------------
# 4. against the reference's sharded runs (last: they wait for its subprocess)
# --------------------------------------------------------------------------

@pytest.mark.parametrize("layout", ["replicated", "owner"])
def test_ici_rows_match_reference_run(pool, ref_sharded, layout):
    """At D = 4 the port's warm runs' ICI rows (K = 1) equal the reference's
    sharded warm runs', batch by batch."""
    for b in range(BATCHES):
        want = ref_sharded.get(f"warm_{layout}_{b}")
        got = _warm_outs(pool, 4, layout, 1, False)[0]["runs"][b].history
        for key in ("ici_bytes", "ici_time", "ici_engine"):
            np.testing.assert_array_equal(want[key], got[key], err_msg=key)


def test_owner_service_ici_totals_match_reference_run(pool, ref_sharded):
    """The owner service at D = 4 on the reference's graph: its cold answers
    and its ICI totals equal the reference's owner service's."""
    want, outs = _service_run(pool, "g600", 4, "owner")
    _check_service(outs, want, 4, "owner", 600)
    ref = ref_sharded.get("serve_owner")
    for r in outs[0]["cold"]:
        np.testing.assert_array_equal(
            ref_sharded.get(f"serve_owner_cold_{r.source}")["values"], r.values)
    assert (outs[0]["extra"][KEY_ICI_BYTES], outs[0]["extra"][KEY_ICI_TIME]) == \
        (float(ref["ici_bytes"]), float(ref["ici_time"]))
