"""The port's sharded sweep (``repro_torch.dist.graph_shard``, replicated
layout) against the reference, on gloo ranks on the CPU.

One pool of 4 ranks serves the module (a ``launch.mesh.RankPool``, started anew
by ``PoolKeeper`` after a case whose run broke it: this
process is rank 0, three spawned ranks with one thread each); D = 2 cases
run on its ``(0, 1)`` subgroup.  The reference's single-device oracle runs
in this process; its sharded run needs forced-host JAX devices, so one
subprocess (``repro.launch.mesh.forced_host_device_env(4)``) runs every
reference sharded case this file needs, at D = 4, while the ranks work,
and saves them to an ``.npz``.

Contract, the reference's own between its paths
(``tests/test_distributed.py:154``):
* against the single-device ``async_sweep=False`` run: the same iterations
  and engine history; MIN programs and k-core bit-equal in values, Δ and
  transfer bytes; SUM programs within ``atol=1e-5`` in values + Δ and
  ``rtol=1e-6`` in bytes;
* against the reference's sharded run at D = 4: the ``ici_bytes``,
  ``ici_time`` and ``ici_engine`` rows equal; at D = 2 they equal the
  reference's ``ici_level_cost`` of the run's ``merged_entries``;
* every rank's result is identical, bit for bit.
Host-side numbers (``_pad_table``, the ICI costs, ``make_schedule`` with
``pid_offset``/``priority_mask``) are bit-equal to the reference's.
"""

import dataclasses
import subprocess
import sys
import textwrap
from pathlib import Path

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import hytm as jh
from repro.core import scheduler as jsched
from repro.core.constants import TPU_V5E_ICI as J_ICI
from repro.core.cost_model import COMPACT, FILTER, ZEROCOPY
from repro.core.partition import PartitionTable as JTable
from repro.dist import graph_shard as jgs
from repro.graph import algorithms as jalg
from repro.graph import generators as jgen
from repro.graph.hub_sort import hub_sort as jhub_sort
from repro.launch.mesh import forced_host_device_env
from repro_torch import convert
from repro_torch import stream as tstream
from repro_torch.core import hytm as th
from repro_torch.core import scheduler as tsched
from repro_torch.core.partition import PartitionTable as TTable
from repro_torch.core.partition import partition_graph
from repro_torch.dist import graph_shard as tgs
from repro_torch.graph import algorithms as talg
from repro_torch.graph.csr import CSRGraph
from repro_torch.launch.mesh import GraphMesh, PoolKeeper, make_graph_mesh
from repro_torch.obs import TraceRecorder
from repro_torch.obs.export import CAT_ICI, reconcile
from repro_torch.resilience import CheckpointHook, FaultSpec, RetryPolicy, plan_of

SUM_ATOL = 1e-5
PROGRAMS = ("bfs", "sssp", "cc", "pagerank", "kcore")
FORCED = {"filter": FILTER, "compact": COMPACT, "zerocopy": ZEROCOPY, "hybrid": None}
ICI_KEYS = ("ici_bytes", "ici_time", "ici_engine")


def _prog(pkg, name):
    prog = pkg.ALGORITHMS[name]
    return dataclasses.replace(prog, tolerance=1e-6) if name == "pagerank" else prog


def _source(prog):
    return None if (prog.use_delta and not prog.personalized) or prog.peel_k else 0


def _cfg(prog, **kw):
    """The reference's sharded config for ``prog`` (``test_distributed.py``)."""
    cds = "delta" if (prog.combine and prog.peel_k is None) else "hub"
    return jh.HyTMConfig(n_partitions=16, async_sweep=False, mesh_axis="graph",
                         cds_mode=cds, **kw)


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


GRAPHS = {
    "main": lambda: jgen.rmat_graph(600, 5000, seed=7),
    "padded": lambda: jgen.rmat_graph(500, 4000, seed=11),
    "chunked": lambda: jgen.rmat_graph(500, 4000, seed=7),
}


def _hub_graph():
    hs = jhub_sort(jgen.rmat_graph(800, 7000, seed=5), hub_fraction=0.1)
    return hs.graph, hs.n_hubs


# --------------------------------------------------------------------------
# the reference's sharded runs: one forced-device subprocess
# --------------------------------------------------------------------------

_REFERENCE_SCRIPT = """
    import dataclasses, sys
    import jax
    import numpy as np
    assert len(jax.devices()) == 4, jax.devices()
    from repro.core.hytm import HyTMConfig, run_hytm
    from repro.core.cost_model import COMPACT, FILTER, ZEROCOPY
    from repro.graph.algorithms import ALGORITHMS, SSSP
    from repro.graph.generators import rmat_graph
    from repro.graph.hub_sort import hub_sort

    out = {}

    def keep(case, r):
        out[case + "/values"] = r.values
        out[case + "/delta"] = r.delta
        out[case + "/iterations"] = np.asarray(r.iterations)
        out[case + "/bytes"] = np.asarray(r.total_transfer_bytes)
        for k in ("engines", "ici_bytes", "ici_time", "ici_engine"):
            out[case + "/" + k] = r.history[k]

    g = rmat_graph(600, 5000, seed=7)
    for name in ("bfs", "sssp", "cc", "pagerank", "kcore"):
        prog = ALGORITHMS[name]
        if name == "pagerank":
            prog = dataclasses.replace(prog, tolerance=1e-6)
        src = None if (prog.use_delta and not prog.personalized) or prog.peel_k else 0
        cds = "delta" if (prog.combine and prog.peel_k is None) else "hub"
        keep("main_" + name, run_hytm(g, prog, source=src, config=HyTMConfig(
            n_partitions=16, async_sweep=False, mesh_axis="graph", cds_mode=cds)))
    g = rmat_graph(500, 4000, seed=11)
    for name, eng in (("filter", FILTER), ("compact", COMPACT), ("zerocopy", ZEROCOPY),
                      ("hybrid", None)):
        keep("padded_" + name, run_hytm(g, SSSP, source=0, config=HyTMConfig(
            n_partitions=10, async_sweep=False, mesh_axis="graph", forced_engine=eng)))
    hs = hub_sort(rmat_graph(800, 7000, seed=5), hub_fraction=0.1)
    keep("hubs", run_hytm(hs.graph, SSSP, source=0, n_hubs=hs.n_hubs, config=HyTMConfig(
        n_partitions=16, async_sweep=False, mesh_axis="graph", cds_mode="hub",
        recompute_once=True)))
    g = rmat_graph(500, 4000, seed=7)
    for k in (1, 4):
        keep(f"chunked_k{k}", run_hytm(g, SSSP, source=0, config=HyTMConfig(
            n_partitions=8, async_sweep=False, mesh_axis="graph", sync_every=k)))
    np.savez(sys.argv[1], **out)
"""


class _ReferenceSharded:
    """The subprocess running ``_REFERENCE_SCRIPT``; ``get(case)`` waits
    for it (at most ``timeout`` s) and returns the case's arrays."""

    def __init__(self, path: Path, timeout: float = 400.0):
        self.path, self.timeout = path, timeout
        self.proc = subprocess.Popen(
            [sys.executable, "-c", textwrap.dedent(_REFERENCE_SCRIPT), str(path)],
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
    ref = _ReferenceSharded(tmp_path_factory.mktemp("graph_shard") / "reference.npz")
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


@pytest.fixture(scope="module")
def oracle():
    """Memo of the reference's single-device ``async_sweep=False`` runs."""
    memo = {}

    def run(gname, name, cfg, **kw):
        key = (gname, name, cfg, tuple(sorted(kw.items())))
        if key not in memo:
            prog = _prog(jalg, name)
            g, n_hubs = _hub_graph() if gname == "hubs" else (GRAPHS[gname](), 0)
            memo[key] = jh.run_hytm(g, prog, source=_source(prog), n_hubs=n_hubs,
                                    config=dataclasses.replace(cfg, mesh_axis=None), **kw)
        return memo[key]

    return run


def _on_ranks(pool, gname, name, cfg, d=4, traced=False, fault_seed=None):
    """The port's sharded run on ``d`` ranks: each rank's output dict."""
    g, n_hubs = _hub_graph() if gname == "hubs" else (GRAPHS[gname](), 0)
    ranks = None if d == 4 else (0, 1)
    return pool.run(_rank_run, _tgraph(g), name, cfg, n_hubs, traced, fault_seed,
                    ranks=ranks)


def _rank_run(group, g, name, cfg, n_hubs, traced, fault_seed):
    """One rank's part (pickled to the spawned ranks by import path)."""
    prog = _prog(talg, name)
    mesh = make_graph_mesh(group=group, device="cpu")
    obs = TraceRecorder() if traced else None
    faults = retry = None
    if fault_seed is not None:
        faults = plan_of(FaultSpec("chunk_dispatch", "fail", p=0.5), seed=fault_seed)
        retry = RetryPolicy(max_attempts=16)
    chunks = []
    on_chunk = None
    if cfg.sync_every > 1:
        def on_chunk(**kw):
            chunks.append((kw["iterations"], kw["last_active"]))
    res = th.run_hytm(g, prog, _source(prog), cfg, n_hubs=n_hubs, mesh=mesh, obs=obs,
                      faults=faults, retry=retry, on_chunk=on_chunk)
    out = {"result": res, "chunks": chunks, "rank": mesh.rank, "size": mesh.size}
    if faults is not None:
        out["fired"] = [(e.site, e.kind, e.occurrence) for e in faults.events]
    if obs is not None:
        out["ici"] = [dict(ev.args) for ev in obs.events if ev.cat == CAT_ICI]
        out["reconcile"] = reconcile(obs, res)["ok"]
    return out


def _same_result(a, b):
    """Two ranks' results, bit for bit."""
    for f in ("values", "delta"):
        np.testing.assert_array_equal(getattr(a, f), getattr(b, f))
    assert a.iterations == b.iterations
    assert a.total_transfer_bytes == b.total_transfer_bytes
    assert a.total_ici_bytes == b.total_ici_bytes
    assert a.history.keys() == b.history.keys()
    for k in a.history:
        np.testing.assert_array_equal(a.history[k], b.history[k], err_msg=k)
    np.testing.assert_array_equal(a.engine_corrections, b.engine_corrections)


def _check_oracle(want, got, prog):
    assert want.iterations == got.iterations
    np.testing.assert_array_equal(want.history["engines"], got.history["engines"])
    if prog.combine == jalg.MIN or prog.peel_k is not None:
        np.testing.assert_array_equal(want.values, got.values)
        np.testing.assert_array_equal(want.delta, got.delta)
        assert want.total_transfer_bytes == got.total_transfer_bytes
    else:
        np.testing.assert_allclose(want.values + want.delta, got.values + got.delta,
                                   rtol=0, atol=SUM_ATOL)
        np.testing.assert_allclose(want.total_transfer_bytes, got.total_transfer_bytes,
                                   rtol=1e-6)


def _check_ici(ref: dict, got):
    for k in ICI_KEYS:
        np.testing.assert_array_equal(ref[k], got.history[k], err_msg=k)


# --------------------------------------------------------------------------
# 1. host-side numbers
# --------------------------------------------------------------------------

@pytest.mark.parametrize("P,D", [(16, 2), (16, 4), (10, 4), (7, 3), (1, 4), (5, 16)])
def test_pad_table_matches_reference(P, D):
    rng = np.random.default_rng(P * 100 + D)
    vs = np.concatenate([[0], np.cumsum(rng.integers(0, 5, P))]).astype(np.int64)
    es = np.concatenate([[0], np.cumsum(rng.integers(0, 9, P))]).astype(np.int64)
    want = jgs._pad_table(JTable(vertex_start=vs, edge_start=es), D)
    got = tgs._pad_table(TTable(vertex_start=vs, edge_start=es), D)
    assert got.n_partitions % D == 0 and got.n_partitions == want.n_partitions
    np.testing.assert_array_equal(got.vertex_start, want.vertex_start)
    np.testing.assert_array_equal(got.edge_start, want.edge_start)
    assert got.vertex_start.dtype == want.vertex_start.dtype


@pytest.mark.parametrize("n", [600, 4_194_304])
@pytest.mark.parametrize("D", [1, 2, 4, 16])
def test_ici_costs_match_reference(n, D):
    """Both ICI candidates and the pick, bit-equal, over merged-entry counts
    and corrections (``ici_link`` is the reference's ``TPU_V5E_ICI``)."""
    link = th.HyTMConfig().ici_link
    assert link == convert.link_model(dataclasses.asdict(jh.HyTMConfig().ici_link))
    assert tgs.ici_merge_cost(n, D, link) == jgs.ici_merge_cost(n, D, J_ICI)
    assert tgs.ici_merge_cost(n, D, link, n_collectives=2) == \
        jgs.ici_merge_cost(n, D, J_ICI, n_collectives=2)
    for me in (0, 1, 37, n // 64, n // 3, n):
        for corr in (None, np.ones(3), np.array([0.5, 2.0, 1.0]), np.array([3.0, 0.2, 1.0]),
                     np.float32([1.25, 0.8, 1.0]).astype(float)):
            assert tgs.ici_level_cost(n, me, D, link, corr) == \
                jgs.ici_level_cost(n, me, D, J_ICI, corr), (me, corr)


@pytest.mark.parametrize("mode", ["hub", "delta", "none"])
@pytest.mark.parametrize("offset", [0, 8])
@pytest.mark.parametrize("masked", [False, True])
def test_make_schedule_offset_and_mask_match_reference(mode, offset, masked):
    rng = np.random.default_rng(len(mode) * 10 + offset + masked)
    for P in (16, 16, 7):
        engines = rng.integers(-1, 3, P).astype(np.int32)
        dmass = np.round(rng.random(P) * 4, 1).astype(np.float32)   # ties
        mask = rng.random(P) < 0.4 if masked else None
        for recompute in (True, False):
            want = jsched.make_schedule(
                jnp.asarray(engines), jnp.asarray(dmass), 3, mode, recompute,
                pid_offset=offset, priority_mask=None if mask is None else jnp.asarray(mask))
            got = tsched.make_schedule(
                torch.from_numpy(engines), torch.from_numpy(dmass), 3, mode, recompute,
                pid_offset=offset, priority_mask=None if mask is None else torch.from_numpy(mask))
            np.testing.assert_array_equal(np.asarray(want.order), got.order.numpy())
            np.testing.assert_array_equal(np.asarray(want.second_pass), got.second_pass.numpy())


def test_default_schedule_is_unchanged():
    """The new arguments' defaults leave a single-device schedule as it was:
    ``pid_offset=0`` with no mask equals the call without them."""
    rng = np.random.default_rng(3)
    engines = torch.from_numpy(rng.integers(-1, 3, 19).astype(np.int32))
    dmass = torch.from_numpy(rng.random(19).astype(np.float32))
    for mode in ("hub", "delta", "none"):
        a = tsched.make_schedule(engines, dmass, 4, mode, True)
        b = tsched.make_schedule(engines, dmass, 4, mode, True, pid_offset=0, priority_mask=None)
        assert torch.equal(a.order, b.order) and torch.equal(a.second_pass, b.second_pass)


# --------------------------------------------------------------------------
# 2-4. the sharded sweep against the reference
# --------------------------------------------------------------------------

@pytest.mark.parametrize("use_kernels", [False, True], ids=["plain", "kernels"])
@pytest.mark.parametrize("D", [2, 4])
@pytest.mark.parametrize("name", PROGRAMS)
def test_sharded_matches_reference(pool, oracle, name, D, use_kernels):
    """The main contract at D = 2 and 4, through the plain engines and the
    kernels' plain versions; every rank identical; the ICI rows equal the
    reference's ``ici_level_cost`` of the traced ``merged_entries`` (the
    reference's sharded run at D = 4: ``test_ici_rows_match_reference_run``)."""
    cfg = _cfg(_prog(jalg, name))
    outs = _on_ranks(pool, "main", name, _tconfig(cfg, use_kernels=use_kernels), d=D,
                     traced=True)
    got = outs[0]["result"]
    for o in outs[1:]:
        _same_result(got, o["result"])
    assert all(o["reconcile"] for o in outs)
    _check_oracle(oracle("main", name, cfg), got, _prog(jalg, name))
    me = [ev["merged_entries"] for ev in outs[0]["ici"]]
    assert len(me) == got.iterations
    for i, m in enumerate(me):
        want = jgs.ici_level_cost(600, m, D, J_ICI, None)
        assert (got.history["ici_bytes"][i], got.history["ici_time"][i],
                got.history["ici_engine"][i]) == want


def test_padding_plans_none_and_zero_mass():
    """The padded partitions of a rank's table plan NONE, zero bytes and a
    zero Δ mass (an empty ``segment_reduce`` segment, ``unsafe=True``), on a
    Δ-mode PageRank frontier where every real partition is active."""
    g = _tgraph(GRAPHS["padded"]())
    mesh = GraphMesh(group=None, axis="graph", size=4, rank=3, device=torch.device("cpu"))
    cfg = th.HyTMConfig(n_partitions=10, async_sweep=False, mesh_axis="graph",
                        cds_mode="delta")
    rt = tgs.build_sharded_runtime(g, cfg, mesh)
    assert (rt.n_partitions, rt.n_local, rt.p_offset) == (12, 3, 9)
    _, edge_start, part_edges = rt.parts.host
    assert rt.edge_base == edge_start[9] and rt.edge_src.shape[0] == sum(part_edges[9:])
    values, delta, frontier = talg.PAGERANK.init_state(g.n_nodes, None, "cpu")
    planned = th._plan(th.HyTMState(values, delta, frontier), rt, talg.PAGERANK, cfg)
    assert (planned.plan.engines[:10] != -1).all() and (planned.plan.engines[10:] == -1).all()
    assert (planned.plan.transfer_bytes[10:] == 0).all()
    assert (planned.delta_mass[:10] > 0).all() and (planned.delta_mass[10:] == 0).all()


def test_padded_pagerank_in_delta_mode(pool, oracle):
    """Δ-mode PageRank on 10 partitions over 4 ranks (padded to 12): the
    padded Δ mass stays 0, so the plan and the SUM contract hold."""
    prog = _prog(jalg, "pagerank")
    cfg = jh.HyTMConfig(n_partitions=10, async_sweep=False, mesh_axis="graph",
                        cds_mode="delta")
    outs = _on_ranks(pool, "padded", "pagerank", _tconfig(cfg), d=4)
    got = outs[0]["result"]
    for o in outs[1:]:
        _same_result(got, o["result"])
    want = oracle("padded", "pagerank", cfg)
    assert got.history["engines"].shape[1] == 12
    assert (got.history["engines"][:, 10:] == -1).all()
    np.testing.assert_array_equal(want.history["engines"], got.history["engines"][:, :10])
    np.testing.assert_allclose(want.values + want.delta, got.values + got.delta,
                               rtol=0, atol=SUM_ATOL)
    assert want.iterations == got.iterations


# --------------------------------------------------------------------------
# 5. the chunked driver and autotune
# --------------------------------------------------------------------------

def _chunked_cfg(name, k, **kw):
    prog = _prog(jalg, name)
    return jh.HyTMConfig(n_partitions=8, async_sweep=False, mesh_axis="graph",
                         sync_every=k, cds_mode="delta" if prog.combine else "hub", **kw)


@pytest.mark.parametrize("k", [1, 4])
def test_autotune_ranks_agree(pool, oracle, k):
    """With ``autotune`` every rank runs rank 0's broadcast correction: the
    engine histories and ``engine_corrections`` are equal on all ranks, and
    SSSP's values equal the oracle's (engines never change an answer)."""
    cfg = _chunked_cfg("sssp", k, autotune=True)
    outs = _on_ranks(pool, "chunked", "sssp", _tconfig(cfg))
    got = outs[0]["result"]
    assert got.engine_corrections.shape == (3,)
    for o in outs[1:]:
        _same_result(got, o["result"])
    np.testing.assert_array_equal(oracle("chunked", "sssp", _chunked_cfg("sssp", k)).values,
                                  got.values)


# --------------------------------------------------------------------------
# 6. ranks agree: faults, on_chunk, obs
# --------------------------------------------------------------------------

@pytest.mark.parametrize("seed", [3, 11])
def test_faults_fire_alike_on_every_rank(pool, seed):
    """A seeded ``chunk_dispatch`` plan fires at the same dispatches on
    every rank, the retries keep the answer bit-equal to a clean run, and
    ``on_chunk`` sees the same chunk boundaries everywhere."""
    cfg = _tconfig(_chunked_cfg("sssp", 2))
    clean = _on_ranks(pool, "chunked", "sssp", cfg)
    faulty = _on_ranks(pool, "chunked", "sssp", cfg, fault_seed=seed)
    fired = faulty[0]["fired"]
    assert fired and all(o["fired"] == fired for o in faulty)
    for o in faulty:
        _same_result(clean[0]["result"], o["result"])
        assert o["chunks"] == clean[0]["chunks"]
    assert clean[0]["chunks"][-1] == (clean[0]["result"].iterations, 0)


@pytest.mark.parametrize("k", [1, 4])
def test_obs_ici_instants_and_reconcile(pool, k):
    """Traced on track ``mesh``: one ``ici`` instant an iteration whose
    bytes, seconds and engine are the history's ICI rows, and
    ``reconcile`` exact on every rank."""
    outs = _on_ranks(pool, "chunked", "pagerank", _tconfig(_chunked_cfg("pagerank", k)),
                     traced=True)
    names = {0: "filter", 1: "compact", -1: "none"}
    for o in outs:
        res = o["result"]
        assert o["reconcile"]
        assert [ev["bytes"] for ev in o["ici"]] == list(res.history["ici_bytes"])
        assert [ev["modeled_seconds"] for ev in o["ici"]] == list(res.history["ici_time"])
        assert [ev["engine"] for ev in o["ici"]] == [names[int(e)] for e in
                                                    res.history["ici_engine"]]
    assert outs[0]["ici"] == outs[-1]["ici"]


# --------------------------------------------------------------------------
# 7. what still raises
# --------------------------------------------------------------------------

def _fake_mesh():
    """A mesh no collective runs on (the checks fire first)."""
    return GraphMesh(group=None, axis="graph", size=2, rank=0, device=torch.device("cpu"))


def test_owner_layout_is_ported_and_layouts_are_checked(tmp_path):
    """The owner layout no longer raises: its three host helpers give the
    reference's values (``tests/test_torch_graph_shard_owner.py`` holds the
    layout against the reference); a bad layout or axis, and a runtime run
    under the other layout, still raise ``ValueError``."""
    jg = GRAPHS["padded"]()
    g = _tgraph(jg)
    cfg = th.HyTMConfig(mesh_axis="graph", vertex_sharding="owner", n_partitions=10)
    rt = tgs.build_sharded_runtime(g, cfg, _fake_mesh())
    assert (rt.vertex_sharding, rt.n_pad, rt.halo.n_loc) == ("owner", 500, 250)
    # the reference's (P_total, B) grid of the same padded table
    table = tgs._pad_table(partition_graph(g, n_partitions=10), 2)
    shape = (table.n_partitions, int(table.edges_per_partition.max()))
    src, dst, valid = np.zeros(shape, np.int32), np.zeros(shape, np.int32), np.zeros(shape, bool)
    for p in range(table.n_partitions):
        e0, e1 = int(table.edge_start[p]), int(table.edge_start[p + 1])
        src[p, :e1 - e0], dst[p, :e1 - e0] = g.edge_sources()[e0:e1], g.indices[e0:e1]
        valid[p, :e1 - e0] = True
    want = jgs.build_halo_plan(src, dst, valid, g.n_nodes, 2)
    assert rt.halo.halo_counts == want.halo_counts and rt.halo.halo_total == want.halo_total
    link = th.HyTMConfig().ici_link
    assert tgs.halo_level_cost(500, 321, 17, 2, link) == \
        jgs.halo_level_cost(500, 321, 17, 2, J_ICI)
    vals = torch.arange(500, dtype=torch.float32)
    st = tgs._owner_place_state(rt, talg.SSSP, vals, vals, vals > 100)
    assert torch.equal(st.values, vals[:250]) and torch.equal(st.frontier, vals[:250] > 100)
    with pytest.raises(ValueError, match="vertex_sharding"):
        th.run_hytm(g, talg.SSSP, config=dataclasses.replace(cfg, vertex_sharding="rows"),
                    mesh=_fake_mesh())
    with pytest.raises(ValueError, match="rebuild the runtime"):
        th.run_hytm(None, talg.SSSP, runtime=rt, mesh=_fake_mesh(),
                    config=dataclasses.replace(cfg, vertex_sharding="replicated"))
    # a checkpoint hook of the other layout would save owned slices as whole vectors
    with pytest.raises(ValueError, match="state_layout"):
        th.run_hytm(None, talg.SSSP, runtime=rt, mesh=_fake_mesh(),
                    config=dataclasses.replace(cfg, sync_every=2),
                    on_chunk=CheckpointHook(tmp_path / "c.npz", program="sssp"))
    with pytest.raises(ValueError, match="mesh_axis"):
        th.run_hytm(g, talg.SSSP, config=th.HyTMConfig(mesh_axis="rows"), mesh=_fake_mesh())


def test_sharded_stream_and_serving_raise_naming_item_11c():
    """Item 11c is ported (tests/test_torch_stream_sharded.py): no module of
    the port raises ``NotImplementedError`` naming it, and the stream and
    serving paths on a mesh raise only their guards' ``ValueError``s (no
    collective runs here: this process may hold the module's pool)."""
    src = Path(__file__).resolve().parents[1] / "src" / "repro_torch"
    for path in src.rglob("*.py"):
        text = path.read_text()
        assert not ("NotImplementedError" in text and "11c" in text), path
    jg = jgen.grid_mesh_graph(8, 8, seed=1)
    g = _tgraph(jg)
    mesh_cfg = th.HyTMConfig(mesh_axis="graph", n_partitions=3)
    with pytest.raises(ValueError, match="mesh's axis"):
        tstream.GraphService(g, mesh_cfg, mesh=dataclasses.replace(_fake_mesh(), axis="rows"))
    svc = tstream.GraphService(g, mesh_cfg, mesh=_fake_mesh())
    assert svc.mesh == _fake_mesh() and svc.device == torch.device("cpu")
    rt = svc._runtime_for(talg.SSSP)
    assert (rt.n_partitions, rt.mesh.rank) == (4, 0)
    assert callable(tgs.make_sharded_batched_chunk(rt, talg.SSSP, mesh_cfg, 4))
    dcsr = tstream.DeltaCSR(g, th.HyTMConfig(n_partitions=4), device="cpu")
    with pytest.raises(ValueError, match="no mesh axis"):
        dcsr.sharded_runtime_for(talg.SSSP)
    with pytest.raises(ValueError, match="mesh's axis"):
        tstream.run_incremental(dcsr, talg.SSSP, [], np.zeros(dcsr.n_nodes, np.float32),
                                np.zeros(dcsr.n_nodes, np.float32),
                                config=th.HyTMConfig(mesh_axis="rows"), mesh=_fake_mesh())


def test_make_graph_mesh_needs_a_card_or_a_device():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present: make_graph_mesh() takes it")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        make_graph_mesh()


# --------------------------------------------------------------------------
# against the reference's sharded runs (last: they wait for its subprocess)
# --------------------------------------------------------------------------

@pytest.mark.parametrize("name", PROGRAMS)
def test_ici_rows_match_reference_run(pool, ref_sharded, name):
    """At D = 4 the port's ICI rows, iterations and engine history equal the
    reference's sharded run's."""
    got = _on_ranks(pool, "main", name, _tconfig(_cfg(_prog(jalg, name))))[0]["result"]
    ref = ref_sharded.get("main_" + name)
    _check_ici(ref, got)
    assert got.iterations == int(ref["iterations"])
    np.testing.assert_array_equal(ref["engines"], got.history["engines"])


@pytest.mark.parametrize("forced", list(FORCED))
def test_padding_and_forced_engines(pool, oracle, ref_sharded, forced):
    """10 partitions on 4 ranks pad to 12; the padding stays NONE and moves
    no bytes; forced engines and the hybrid agree with both references."""
    cfg = jh.HyTMConfig(n_partitions=10, async_sweep=False, mesh_axis="graph",
                        forced_engine=FORCED[forced])
    outs = _on_ranks(pool, "padded", "sssp", _tconfig(cfg), d=4)
    got = outs[0]["result"]
    for o in outs[1:]:
        _same_result(got, o["result"])
    want = oracle("padded", "sssp", cfg)
    np.testing.assert_array_equal(want.values, got.values)
    assert want.iterations == got.iterations
    assert want.total_transfer_bytes == got.total_transfer_bytes
    eng = got.history["engines"]
    assert eng.shape == (got.iterations, 12)
    assert (eng[:, 10:] == -1).all()
    np.testing.assert_array_equal(eng[:, :10], want.history["engines"])
    ref = ref_sharded.get("padded_" + forced)
    np.testing.assert_array_equal(ref["engines"], eng)
    np.testing.assert_array_equal(ref["values"], got.values)
    _check_ici(ref, got)


@pytest.mark.parametrize("D", [2, 4])
def test_hubs_and_recompute_once(pool, oracle, ref_sharded, D):
    """Hub partitions with the recompute-once second pass: the global mask
    and ``pid_offset`` give the single-device schedule's passes."""
    cfg = jh.HyTMConfig(n_partitions=16, async_sweep=False, mesh_axis="graph",
                        cds_mode="hub", recompute_once=True)
    g, n_hubs = _hub_graph()
    assert n_hubs > 0
    outs = _on_ranks(pool, "hubs", "sssp", _tconfig(cfg), d=D)
    got = outs[0]["result"]
    _same_result(got, outs[-1]["result"])
    _check_oracle(oracle("hubs", "sssp", cfg), got, jalg.SSSP)
    if D == 4:
        ref = ref_sharded.get("hubs")
        np.testing.assert_array_equal(ref["values"], got.values)
        _check_ici(ref, got)


@pytest.mark.parametrize("name", ["sssp", "pagerank"])
def test_chunked_k4_matches_k1(pool, oracle, ref_sharded, name):
    """K = 4 against K = 1 on 4 ranks: SSSP values and ICI rows bit-equal
    (and equal to the reference's sharded K = 1 and K = 4), PageRank within
    ``1e-5``; both against the single-device oracle."""
    k1 = _on_ranks(pool, "chunked", name, _tconfig(_chunked_cfg(name, 1)))[0]["result"]
    k4 = _on_ranks(pool, "chunked", name, _tconfig(_chunked_cfg(name, 4)))[0]["result"]
    assert k1.iterations == k4.iterations
    if name == "sssp":
        np.testing.assert_array_equal(k1.values, k4.values)
        for k in ICI_KEYS:
            np.testing.assert_array_equal(k1.history[k], k4.history[k])
        for k, res in (("chunked_k1", k1), ("chunked_k4", k4)):
            ref = ref_sharded.get(k)
            np.testing.assert_array_equal(ref["values"], res.values)
            _check_ici(ref, res)
    else:
        np.testing.assert_allclose(k1.values + k1.delta, k4.values + k4.delta,
                                   rtol=0, atol=SUM_ATOL)
    _check_oracle(oracle("chunked", name, _chunked_cfg(name, 4)), k4, _prog(jalg, name))
