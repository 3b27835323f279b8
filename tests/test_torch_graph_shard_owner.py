"""The port's owner/halo vertex layout of the sharded sweep
(``HyTMConfig(vertex_sharding="owner")`` in ``repro_torch.dist.graph_shard``)
and resilience on a mesh, against the reference, on gloo ranks on the CPU.

One pool of 4 ranks serves the module (a ``launch.mesh.RankPool``, started anew
by ``PoolKeeper`` after a case whose run broke it: this
process is rank 0, three spawned ranks with one thread each); D = 2 cases
run on its ``(0, 1)`` subgroup.  The reference's single-device oracle runs
in this process; its owner runs need forced-host JAX devices, so one
subprocess (``repro.launch.mesh.forced_host_device_env(4)``) runs every
reference owner case this file needs, at D = 4, while the ranks work, and
saves them (and one owner checkpoint) beside an ``.npz``.

Two graphs: ``rmat_graph(600, 5000, seed=7)`` (the reference's own test
graph, no pad vertices at D = 2 or 4) and ``rmat_graph(601, 5000, seed=7)``
(``n_pad`` 602 at D = 2, 604 at D = 4: pad vertices exist).

Contract, the reference's own between its paths
(``tests/test_distributed.py:223``):
* against the single-device ``async_sweep=False`` run: the same iterations
  and engine history; MIN programs and k-core bit-equal in values, Δ and
  transfer bytes; SUM programs within ``atol=1e-5`` in values + Δ and
  ``rtol=1e-6`` in bytes; ``values.shape == (n,)``;
* against the reference's owner run at D = 4: the ICI rows equal; at D = 2
  they equal the reference's ``halo_level_cost`` of the run's
  ``merged_entries`` and the reference's halo plan;
* against the port's replicated layout: MIN programs bit-equal;
* every rank's result is identical, bit for bit.
Host-side numbers (``build_halo_plan``, ``halo_level_cost``,
``vertex_state_bytes``, ``owner_state_pad_values``) are bit-equal to the
reference's.
"""

import dataclasses
import subprocess
import sys
import textwrap
from pathlib import Path

import numpy as np
import pytest
import torch

from repro import resilience as jres
from repro.core import cost_model as jcm
from repro.core import hytm as jh
from repro.core.constants import TPU_V5E_ICI as J_ICI
from repro.core.cost_model import COMPACT, FILTER, ZEROCOPY
from repro.core.partition import partition_graph as jpartition_graph
from repro.dist import graph_shard as jgs
from repro.graph import algorithms as jalg
from repro.graph import generators as jgen
from repro.launch.mesh import forced_host_device_env
from repro_torch import convert
from repro_torch.core import cost_model as tcm
from repro_torch.core import hytm as th
from repro_torch.core.partition import partition_graph as tpartition_graph
from repro_torch.core.partition import to_device_partitions
from repro_torch.dist import graph_shard as tgs
from repro_torch.graph import algorithms as talg
from repro_torch.graph.csr import CSRGraph
from repro_torch.launch.mesh import GraphMesh, PoolKeeper, make_graph_mesh, mesh_barrier
from repro_torch.obs import TraceRecorder
from repro_torch.obs.export import CAT_ICI, reconcile
from repro_torch.resilience import (CheckpointError, CheckpointHook, FaultSpec,
                                    RetriesExhausted, RetryPolicy, Supervisor,
                                    migrate_state_layout, plan_of, restore, resume_run,
                                    run_supervised, save)
from repro_torch.resilience import checkpoint as tckpt

SUM_ATOL = 1e-5
PROGRAMS = ("bfs", "sssp", "pagerank", "kcore")
FORCED = {"filter": FILTER, "compact": COMPACT, "zerocopy": ZEROCOPY, "hybrid": None}
ICI_KEYS = ("ici_bytes", "ici_time", "ici_engine")
GRAPHS = {"main": lambda: jgen.rmat_graph(600, 5000, seed=7),
          "pads": lambda: jgen.rmat_graph(601, 5000, seed=7)}


def _prog(pkg, name):
    prog = pkg.ALGORITHMS[name]
    return dataclasses.replace(prog, tolerance=1e-6) if name == "pagerank" else prog


def _source(prog):
    return None if (prog.use_delta and not prog.personalized) or prog.peel_k else 0


def _cfg(prog, **kw):
    """The reference's owner config for ``prog`` (``test_distributed.py``)."""
    cds = "delta" if (prog.combine and prog.peel_k is None) else "hub"
    return jh.HyTMConfig(n_partitions=16, async_sweep=False, mesh_axis="graph",
                         cds_mode=cds, vertex_sharding="owner", **kw)


def _chunked_cfg(name, k, **kw):
    prog = _prog(jalg, name)
    return jh.HyTMConfig(n_partitions=8, async_sweep=False, mesh_axis="graph", sync_every=k,
                         cds_mode="delta" if prog.combine else "hub",
                         vertex_sharding="owner", **kw)


# the kill/resume config: 8 partitions (no padded partitions at D = 4, so a
# single-device reference run can resume the port's checkpoint)
KILL_CFG = jh.HyTMConfig(n_partitions=8, sync_every=2, async_sweep=False, mesh_axis="graph",
                         vertex_sharding="owner")


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


def _ref_halo(g, n_partitions: int, D: int):
    """The reference's ``build_halo_plan`` on the reference's ``(P_total, B)``
    grid, built on the host as its ``build_sharded_runtime`` builds it."""
    cfg = jh.HyTMConfig()
    table = jgs._pad_table(jpartition_graph(g, n_partitions=n_partitions,
                                            partition_bytes=cfg.partition_bytes,
                                            d1=cfg.link.d1), D)
    P = table.n_partitions
    B = max(128, -(-int(table.edges_per_partition.max(initial=1)) // 128) * 128)
    src_all = g.edge_sources()
    src = np.zeros((P, B), np.int32)
    dst = np.zeros((P, B), np.int32)
    valid = np.zeros((P, B), bool)
    for p in range(P):
        e0, e1 = int(table.edge_start[p]), int(table.edge_start[p + 1])
        src[p, :e1 - e0] = src_all[e0:e1]
        dst[p, :e1 - e0] = g.indices[e0:e1]
        valid[p, :e1 - e0] = True
    return jgs.build_halo_plan(src, dst, valid, g.n_nodes, D)


# --------------------------------------------------------------------------
# the reference's owner runs: one forced-device subprocess
# --------------------------------------------------------------------------

_REFERENCE_SCRIPT = """
    import dataclasses, sys
    import jax
    import numpy as np
    assert len(jax.devices()) == 4, jax.devices()
    from repro.core.hytm import HyTMConfig, run_hytm
    from repro.dist.graph_shard import build_sharded_runtime
    from repro.graph.algorithms import ALGORITHMS, PAGERANK, SSSP
    from repro.graph.generators import rmat_graph
    from repro.launch.mesh import make_graph_mesh
    from repro.obs import TraceRecorder
    from repro.resilience import CheckpointHook, FaultSpec, RetriesExhausted, plan_of

    out = {}

    def keep(case, r):
        out[case + "/values"] = r.values
        out[case + "/delta"] = r.delta
        out[case + "/iterations"] = np.asarray(r.iterations)
        out[case + "/bytes"] = np.asarray(r.total_transfer_bytes)
        for k in ("engines", "ici_bytes", "ici_time", "ici_engine"):
            out[case + "/" + k] = r.history[k]

    graphs = {"main": rmat_graph(600, 5000, seed=7), "pads": rmat_graph(601, 5000, seed=7)}
    for gname, g in graphs.items():
        for name in ("bfs", "sssp", "pagerank", "kcore"):
            prog = ALGORITHMS[name]
            if name == "pagerank":
                prog = dataclasses.replace(prog, tolerance=1e-6)
            src = None if (prog.use_delta and not prog.personalized) or prog.peel_k else 0
            cds = "delta" if (prog.combine and prog.peel_k is None) else "hub"
            cfg = HyTMConfig(n_partitions=16, async_sweep=False, mesh_axis="graph",
                             cds_mode=cds, vertex_sharding="owner")
            keep(gname + "_" + name, run_hytm(g, prog, source=src, config=cfg))
        rt = build_sharded_runtime(g, cfg, make_graph_mesh(axis="graph"))
        out[gname + "_halo/counts"] = np.asarray(rt.halo.halo_counts)
    g = graphs["pads"]
    obs = TraceRecorder()
    keep("traced", run_hytm(g, dataclasses.replace(PAGERANK, tolerance=1e-6), source=None,
                            config=HyTMConfig(n_partitions=8, async_sweep=False,
                                              mesh_axis="graph", sync_every=4,
                                              cds_mode="delta", vertex_sharding="owner"),
                            obs=obs))
    out["traced/halo_bytes"] = np.asarray(obs.metrics.counter("ici.halo_bytes").total())
    cfg = HyTMConfig(n_partitions=8, sync_every=2, async_sweep=False, mesh_axis="graph",
                     vertex_sharding="owner")
    keep("kill_base", run_hytm(g, SSSP, source=0, config=cfg))
    hook = CheckpointHook(sys.argv[2], program=SSSP.name, anchor=(0, 0),
                          state_layout="owner", n_nodes=g.n_nodes)
    try:
        run_hytm(g, SSSP, source=0, config=cfg, on_chunk=hook,
                 faults=plan_of(FaultSpec("chunk_dispatch", "fail", at=(2,)), seed=5))
        raise SystemExit("the injected kill did not fire")
    except RetriesExhausted:
        pass
    np.savez(sys.argv[1], **out)
"""


class _ReferenceOwner:
    """The subprocess running ``_REFERENCE_SCRIPT``; ``get(case)`` waits for
    it (at most ``timeout`` s) and returns the case's arrays; ``checkpoint``
    is the owner checkpoint it wrote."""

    def __init__(self, folder: Path, timeout: float = 400.0):
        self.path, self.checkpoint = folder / "reference.npz", folder / "reference.ckpt.npz"
        self.timeout = timeout
        self.proc = subprocess.Popen(
            [sys.executable, "-c", textwrap.dedent(_REFERENCE_SCRIPT), str(self.path),
             str(self.checkpoint)],
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
def ref_owner(tmp_path_factory):
    """Started by the module's first test, so that it runs beside the cases
    that need no reference owner run (those that do come last)."""
    ref = _ReferenceOwner(tmp_path_factory.mktemp("graph_shard_owner"))
    yield ref
    ref.close()


@pytest.fixture(scope="module")
def pools(ref_owner):
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

    def run(gname, name, cfg):
        key = (gname, name, cfg)
        if key not in memo:
            prog = _prog(jalg, name)
            memo[key] = jh.run_hytm(GRAPHS[gname](), prog, source=_source(prog),
                                    config=dataclasses.replace(cfg, mesh_axis=None,
                                                               vertex_sharding="replicated"))
        return memo[key]

    return run


_RUNS: dict = {}


def _on_ranks(pool, gname, name, cfg, d=4, **opts):
    """The port's sharded run on ``d`` ranks: each rank's output dict
    (memoized: the cases against the reference's runs reuse the main
    contract's)."""
    key = (gname, name, cfg, d, tuple(sorted(opts.items())))
    if key not in _RUNS:
        _RUNS[key] = pool.run(_rank_run, _tgraph(GRAPHS[gname]()), name, cfg, opts,
                              ranks=None if d == 4 else (0, 1))
    return _RUNS[key]


def _exact(prog) -> bool:
    """MIN programs and k-core: bit-equal across layouts and to the oracle."""
    return prog.combine == jalg.MIN or prog.peel_k is not None


def _rank_run(group, g, name, cfg, opts):
    """One rank's part (pickled to the spawned ranks by import path).
    ``opts``: ``traced``, ``fault_seed``, ``replicated`` (also run the
    replicated layout), ``watch`` (record the state each chunk boundary
    hands ``on_chunk``)."""
    prog = _prog(talg, name)
    mesh = make_graph_mesh(group=group, device="cpu")
    obs = TraceRecorder() if opts.get("traced") else None
    faults = retry = None
    if opts.get("fault_seed") is not None:
        faults = plan_of(FaultSpec("chunk_dispatch", "fail", p=0.5), seed=opts["fault_seed"])
        retry = RetryPolicy(max_attempts=16)
    chunks = []
    on_chunk = None
    if cfg.sync_every > 1:
        def on_chunk(*, state, iterations, last_active, **kw):
            seen = (iterations, last_active)
            if opts.get("watch"):
                seen += tuple(t.numpy().copy()
                              for t in (state.values, state.delta, state.frontier))
            chunks.append(seen)
    res = th.run_hytm(g, prog, _source(prog), cfg, mesh=mesh, obs=obs, faults=faults,
                      retry=retry, on_chunk=on_chunk)
    out = {"result": res, "chunks": chunks, "rank": mesh.rank, "size": mesh.size}
    if opts.get("replicated"):
        out["replicated"] = th.run_hytm(
            g, prog, _source(prog), dataclasses.replace(cfg, vertex_sharding="replicated"),
            mesh=mesh)
    if faults is not None:
        out["fired"] = [(e.site, e.kind, e.occurrence) for e in faults.events]
    if obs is not None:
        out["ici"] = [dict(ev.args) for ev in obs.events if ev.cat == CAT_ICI]
        out["reconcile"] = reconcile(obs, res)["ok"]
        out["halo_bytes"] = obs.metrics.counter("ici.halo_bytes").total()
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
    assert got.values.shape == want.values.shape
    np.testing.assert_array_equal(want.history["engines"], got.history["engines"])
    if _exact(prog):
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


def _check_ici_model(got, merged, n, D, halo):
    """The ICI rows are the reference's ``halo_level_cost`` of each
    iteration's ``merged_entries`` under the reference's halo plan."""
    assert len(merged) == got.iterations
    for i, m in enumerate(merged):
        want = jgs.halo_level_cost(n, m, halo.halo_total, D, J_ICI, None)
        assert (got.history["ici_bytes"][i], got.history["ici_time"][i],
                got.history["ici_engine"][i]) == want


# --------------------------------------------------------------------------
# 1. host-side numbers
# --------------------------------------------------------------------------

@pytest.mark.parametrize("P", [16, 10, 7])
@pytest.mark.parametrize("D", [1, 2, 3, 4, 16])
@pytest.mark.parametrize("gname", list(GRAPHS))
def test_halo_plan_matches_reference(gname, D, P):
    """``build_halo_plan`` from the host CSR and the padded table: the counts
    of the reference's ``np.unique`` over its ``(P_total, B)`` grid."""
    jg = GRAPHS[gname]()
    want = _ref_halo(jg, P, D)
    g = _tgraph(jg)
    cfg = th.HyTMConfig()
    table = tgs._pad_table(tpartition_graph(g, n_partitions=P,
                                            partition_bytes=cfg.partition_bytes,
                                            d1=cfg.link.d1), D)
    got = tgs.build_halo_plan(g, table, g.n_nodes, D)
    assert (got.n_pad, got.n_loc, got.halo_counts, got.halo_total, got.max_halo) == \
        (want.n_pad, want.n_loc, want.halo_counts, want.halo_total, want.max_halo)
    assert got == tgs.build_halo_plan(g, table, g.n_nodes, D, src=g.edge_sources())


@pytest.mark.parametrize("n", [600, 601, 4_194_304])
@pytest.mark.parametrize("D", [1, 2, 4, 16])
def test_halo_level_cost_and_state_bytes_match_reference(n, D):
    link = th.HyTMConfig().ici_link
    for halo_total in (0, 1, 77, n // 5, 4 * n):
        for me in (0, 1, 37, n // 64, n // 3, n):
            for corr in (None, np.array([0.5, 2.0, 1.0]), np.array([3.0, 0.2, 1.0])):
                assert tgs.halo_level_cost(n, me, halo_total, D, link, corr) == \
                    jgs.halo_level_cost(n, me, halo_total, D, J_ICI, corr), (halo_total, me)
        assert tgs.halo_level_cost(n, 9, halo_total, D, link, n_collectives=2) == \
            jgs.halo_level_cost(n, 9, halo_total, D, J_ICI, n_collectives=2)
        for layout in ("replicated", "owner"):
            assert tcm.vertex_state_bytes(n, D, layout, halo=halo_total) == \
                jcm.vertex_state_bytes(n, D, layout, halo=halo_total)
    assert tcm.vertex_state_bytes(n) == jcm.vertex_state_bytes(n)
    assert tcm.STATE_BYTES_PER_VERTEX == jcm.STATE_BYTES_PER_VERTEX == 9


@pytest.mark.parametrize("name", sorted(talg.ALGORITHMS))
def test_owner_state_pad_values_match_reference(name):
    """One definition, in ``dist.graph_shard``, importable from the
    checkpoint module too; equal to the reference's for all eight programs."""
    assert tckpt.owner_state_pad_values is tgs.owner_state_pad_values
    want = jgs.owner_state_pad_values(jalg.ALGORITHMS[name])
    assert tgs.owner_state_pad_values(talg.ALGORITHMS[name]) == want


def test_partition_stats_ignore_the_pads():
    """``partition_stats`` takes ``(n_pad,)`` vectors: its running sums are
    differenced at the table's bounds, which end at ``n``, so pad entries add
    nothing even when they are set (here: frontier, degree and requests all
    non-zero on the pads)."""
    g = _tgraph(GRAPHS["pads"]())
    n, n_pad = g.n_nodes, 604
    table = tpartition_graph(g, n_partitions=10)
    parts = to_device_partitions(table, n, -(-(g.n_edges + 1024) // 128) * 128, device="cpu")
    rng = np.random.default_rng(0)
    frontier = torch.from_numpy(rng.random(n_pad) < 0.5)
    frontier[n:] = True
    deg = torch.from_numpy(rng.integers(0, 9, n_pad).astype(np.int32))
    zc = torch.from_numpy(rng.integers(0, 4, n_pad).astype(np.float32))
    whole = tcm.partition_stats(frontier, deg, zc, parts)
    real = tcm.partition_stats(frontier[:n], deg[:n], zc[:n], parts)
    for f in whole._fields:
        assert torch.equal(getattr(whole, f), getattr(real, f)), f


def test_owner_runtime_and_placement():
    """A rank's owner runtime: the per-vertex vectors padded to ``n_pad``
    with their inert fills, the halo plan of every rank, and the state
    placed as the rank's ``(n_loc,)`` slice of the padded triple (no
    collective runs: the mesh has no group)."""
    g = _tgraph(GRAPHS["pads"]())
    cfg = th.HyTMConfig(n_partitions=10, mesh_axis="graph", vertex_sharding="owner")
    rep_cfg = dataclasses.replace(cfg, vertex_sharding="replicated")
    for rank in range(4):
        mesh = GraphMesh(group=None, axis="graph", size=4, rank=rank,
                         device=torch.device("cpu"))
        rt = tgs.build_sharded_runtime(g, cfg, mesh)
        rep = tgs.build_sharded_runtime(g, rep_cfg, mesh)
        assert (rt.vertex_sharding, rt.n_pad, rt.halo.n_loc, rt.n_partitions) == \
            ("owner", 604, 151, 12)
        assert (rep.vertex_sharding, rep.n_pad, rep.halo) == ("replicated", 601, None)
        assert rt.owned == slice(151 * rank, 151 * (rank + 1))
        assert rt.halo.halo_counts == _ref_halo(GRAPHS["pads"](), 10, 4).halo_counts
        for f, fill in (("out_degree", 0), ("zc_req", 0.0), ("inv_deg", 1.0)):
            vec = getattr(rt, f)
            assert vec.shape == (604,) and torch.equal(vec[:601], getattr(rep, f))
            assert (vec[601:] == fill).all()
        vpid = rt.parts.vertex_part_id
        assert torch.equal(vpid[:601], rep.parts.vertex_part_id) and (vpid[601:] == 11).all()
        assert torch.equal(rt.edge_src, rep.edge_src) and rt.edge_base == rep.edge_base
        for prog in (talg.SSSP, talg.PAGERANK, talg.KCORE):
            pad_v, pad_d = tgs.owner_state_pad_values(prog)
            vals = torch.arange(601, dtype=torch.float32)
            st = tgs._owner_place_state(rt, prog, vals, vals + 0.5, vals > 300)
            want_v = torch.cat([vals, torch.full((3,), pad_v)])[rt.owned]
            want_d = torch.cat([vals + 0.5, torch.full((3,), pad_d)])[rt.owned]
            assert torch.equal(st.values, want_v) and torch.equal(st.delta, want_d)
            assert torch.equal(st.frontier, torch.cat([vals > 300, torch.zeros(3, dtype=bool)])
                               [rt.owned])
            assert st.values.shape == (151,) and st.values.is_contiguous()


# --------------------------------------------------------------------------
# 2-4. the owner sweep against the reference
# --------------------------------------------------------------------------

@pytest.mark.parametrize("use_kernels", [False, True], ids=["plain", "kernels"])
@pytest.mark.parametrize("D", [2, 4])
@pytest.mark.parametrize("gname", list(GRAPHS))
@pytest.mark.parametrize("name", PROGRAMS)
def test_owner_matches_reference(pool, oracle, name, gname, D, use_kernels):
    """The main contract at D = 2 and 4, with and without pad vertices,
    through the plain engines and the kernels' plain versions; every rank
    identical; MIN programs bit-equal to the replicated layout; the ICI rows
    the reference's ``halo_level_cost`` of the traced ``merged_entries``
    (the reference's owner run at D = 4: ``test_ici_rows_match_reference_run``)."""
    prog = _prog(jalg, name)
    cfg = _cfg(prog)
    outs = _on_ranks(pool, gname, name, _tconfig(cfg, use_kernels=use_kernels), d=D,
                     traced=True, replicated=_exact(prog) and not use_kernels)
    got = outs[0]["result"]
    for o in outs[1:]:
        _same_result(got, o["result"])
    assert all(o["reconcile"] for o in outs)
    _check_oracle(oracle(gname, name, cfg), got, prog)
    if _exact(prog) and not use_kernels:
        rep = outs[0]["replicated"]
        assert rep.iterations == got.iterations
        np.testing.assert_array_equal(rep.history["engines"], got.history["engines"])
        np.testing.assert_array_equal(rep.values, got.values)
        np.testing.assert_array_equal(rep.delta, got.delta)
    jg = GRAPHS[gname]()
    halo = _ref_halo(jg.symmetrize() if prog.symmetrize else jg, 16, D)
    merged = [ev["merged_entries"] for ev in outs[0]["ici"]]
    _check_ici_model(got, merged, jg.n_nodes, D, halo)
    assert [ev["halo_entries"] for ev in outs[0]["ici"]] == \
        [min(m, float(halo.halo_total)) for m in merged]


def test_state_is_the_owned_slice_and_pads_stay_inert(pool):
    """Every program at D = 4 on the graph with pads: each rank's state (as
    ``on_chunk`` sees it at every chunk boundary) holds ``n_loc`` = 151
    entries, and rank 3's three pads keep their fills throughout."""
    for name in sorted(talg.ALGORITHMS):
        prog = talg.ALGORITHMS[name]
        cfg = _tconfig(jh.HyTMConfig(n_partitions=16, async_sweep=False, mesh_axis="graph",
                                     sync_every=2, vertex_sharding="owner",
                                     cds_mode="hub" if prog.peel_k else "delta"))
        outs = _on_ranks(pool, "pads", name, cfg, watch=True)
        pad_v, pad_d = tgs.owner_state_pad_values(prog)
        for o in outs:
            assert o["chunks"], name
            for _, _, values, delta, frontier in o["chunks"]:
                assert values.shape == delta.shape == frontier.shape == (151,), name
                if o["rank"] == 3:
                    assert (values[-3:] == pad_v).all() and (delta[-3:] == pad_d).all(), name
                    assert not frontier[-3:].any(), name
            assert o["result"].values.shape == (601,)


# --------------------------------------------------------------------------
# 5. the chunked driver, autotune, faults, obs
# --------------------------------------------------------------------------

@pytest.mark.parametrize("name", ["sssp", "pagerank"])
def test_chunked_k4_matches_k1(pool, oracle, name):
    """Owner K = 4 against K = 1 on 4 ranks with pads: SSSP values and ICI
    rows bit-equal, PageRank within ``1e-5``; both against the oracle."""
    k1 = _on_ranks(pool, "pads", name, _tconfig(_chunked_cfg(name, 1)))[0]["result"]
    k4 = _on_ranks(pool, "pads", name, _tconfig(_chunked_cfg(name, 4)))[0]["result"]
    assert k1.iterations == k4.iterations
    if name == "sssp":
        np.testing.assert_array_equal(k1.values, k4.values)
        for k in ICI_KEYS:
            np.testing.assert_array_equal(k1.history[k], k4.history[k])
    else:
        np.testing.assert_allclose(k1.values + k1.delta, k4.values + k4.delta,
                                   rtol=0, atol=SUM_ATOL)
    _check_oracle(oracle("pads", name, _chunked_cfg(name, 4)), k4, _prog(jalg, name))


@pytest.mark.parametrize("k", [1, 4])
def test_autotune_ranks_agree(pool, oracle, k):
    """With ``autotune`` every rank runs rank 0's broadcast correction: the
    engine histories and ``engine_corrections`` are equal on all ranks, and
    SSSP's values equal the oracle's."""
    outs = _on_ranks(pool, "pads", "sssp", _tconfig(_chunked_cfg("sssp", k, autotune=True)))
    got = outs[0]["result"]
    assert got.engine_corrections.shape == (3,)
    for o in outs[1:]:
        _same_result(got, o["result"])
    np.testing.assert_array_equal(oracle("pads", "sssp", _chunked_cfg("sssp", k)).values,
                                  got.values)


@pytest.mark.parametrize("seed", [3, 11])
def test_faults_fire_alike_on_every_rank(pool, seed):
    """A seeded ``chunk_dispatch`` plan fires at the same dispatches on
    every rank, and the retries keep the answer bit-equal to a clean run."""
    cfg = _tconfig(_chunked_cfg("sssp", 2))
    clean = _on_ranks(pool, "pads", "sssp", cfg)
    faulty = _on_ranks(pool, "pads", "sssp", cfg, fault_seed=seed)
    fired = faulty[0]["fired"]
    assert fired and all(o["fired"] == fired for o in faulty)
    for o in faulty:
        _same_result(clean[0]["result"], o["result"])
        assert o["chunks"] == clean[0]["chunks"]
    assert clean[0]["chunks"][-1] == (clean[0]["result"].iterations, 0)


# --------------------------------------------------------------------------
# 6. resilience on a mesh
# --------------------------------------------------------------------------

def _rank_kill_resume(group, g, cfg, path, at):
    """Kill SSSP by a seeded dispatch fault at chunk ``at`` and resume it
    from its checkpoint; the uninterrupted run beside it."""
    mesh = make_graph_mesh(group=group, device="cpu")
    base = th.run_hytm(g, talg.SSSP, 0, cfg, mesh=mesh)
    hook = CheckpointHook(path, program=talg.SSSP.name, anchor=(0, 0),
                          state_layout=cfg.vertex_sharding, n_nodes=g.n_nodes)
    killed = False
    try:
        th.run_hytm(g, talg.SSSP, 0, cfg, mesh=mesh, on_chunk=hook,
                    faults=plan_of(FaultSpec("chunk_dispatch", "fail", at=(at,)), seed=5))
    except RetriesExhausted:
        killed = True
    res = resume_run(path, g, talg.SSSP, config=cfg, source=0, mesh=mesh,
                     expect_anchor=(0, 0))
    return {"base": base, "res": res, "killed": killed, "saved": hook.saved,
            "committed": hook.committed, "rank": mesh.rank}


@pytest.mark.parametrize("layout", ["replicated", "owner"])
def test_kill_resume_on_a_mesh(pool, tmp_path, layout):
    """Killed at chunk 2 and resumed on every rank: bit-equal to the
    uninterrupted run in values, iterations, bytes and engines; rank 0
    alone wrote, and the file holds the layout, the real ``n_nodes`` and,
    under the owner layout, the gathered ``(n_pad,)`` arrays."""
    g = _tgraph(GRAPHS["pads"]())
    cfg = _tconfig(KILL_CFG, vertex_sharding=layout)
    path = tmp_path / f"{layout}.ckpt.npz"
    outs = pool.run(_rank_kill_resume, g, cfg, path, 2)
    for o in outs:
        base, res = o["base"], o["res"]
        assert o["killed"] and o["committed"] == 2
        assert o["saved"] == (2 if o["rank"] == 0 else 0)
        np.testing.assert_array_equal(res.values, base.values)
        assert res.iterations == base.iterations > 4
        assert res.total_transfer_bytes == base.total_transfer_bytes
        np.testing.assert_array_equal(res.history["engines"], base.history["engines"])
        _same_result(outs[0]["res"], res)
    ckpt = restore(path)
    assert (ckpt.state_layout, ckpt.n_nodes, ckpt.iterations) == (layout, 601, 4)
    assert ckpt.values.shape == ((604,) if layout == "owner" else (601,))
    assert not list(tmp_path.glob("*.tmp"))


def _rank_layouts(group, g, cfg, path, path2):
    """The typed error of an owner checkpoint resumed into a replicated run,
    and the migrated checkpoint (rank 0 writes it) resumed on the
    replicated path."""
    mesh = make_graph_mesh(group=group, device="cpu")
    rep_cfg = dataclasses.replace(cfg, vertex_sharding="replicated")
    try:
        resume_run(path, g, talg.SSSP, config=rep_cfg, source=0, mesh=mesh)
        error = None
    except CheckpointError as e:
        error = str(e)
    ckpt = restore(path)
    rep = migrate_state_layout(ckpt, "replicated")
    back = migrate_state_layout(rep, "owner", n_devices=mesh.size)
    if mesh.rank == 0:
        save(rep, path2)
    mesh_barrier(mesh)
    res = resume_run(path2, g, talg.SSSP, config=rep_cfg, source=0, mesh=mesh)
    same = all(np.array_equal(getattr(back, f), getattr(ckpt, f))
               for f in ("values", "delta", "frontier"))
    return {"error": error, "round_trip": same, "rep_shape": rep.values.shape, "res": res}


def test_owner_checkpoint_layout_error_and_migration(pool, tmp_path):
    """An owner checkpoint resumed into a replicated run raises the typed
    ``CheckpointError`` naming ``migrate_state_layout``; the owner ->
    replicated -> owner round trip is bit-exact, and the migrated
    checkpoint resumes on the replicated path to the uninterrupted answer."""
    g = _tgraph(GRAPHS["pads"]())
    cfg = _tconfig(KILL_CFG)
    path = tmp_path / "owner.ckpt.npz"
    killed = pool.run(_rank_kill_resume, g, cfg, path, 2)
    outs = pool.run(_rank_layouts, g, cfg, path, tmp_path / "migrated.ckpt.npz")
    for o, k in zip(outs, killed):
        assert "migrate_state_layout" in o["error"]
        assert o["round_trip"] and o["rep_shape"] == (601,)
        np.testing.assert_array_equal(o["res"].values, k["base"].values)
        assert o["res"].iterations == k["base"].iterations


def _rank_supervised(group, g, cfg, path):
    """``run_supervised`` on a mesh: on a prebuilt sharded runtime with no
    graph, then with its retries run out at the third dispatch."""
    mesh = make_graph_mesh(group=group, device="cpu")
    rt = tgs.build_sharded_runtime(g, cfg, mesh)
    clean = run_supervised(None, talg.SSSP, 0, cfg, runtime=rt, ckpt_path=path)
    sup = Supervisor(policy=RetryPolicy(max_attempts=2),
                     faults=plan_of(FaultSpec("chunk_dispatch", "fail", at=(2, 3)), seed=1))
    res = run_supervised(g, talg.SSSP, 0, cfg, mesh=mesh, supervisor=sup, ckpt_path=path)
    return {"clean": clean, "res": res, "degradations": [d for d, _ in sup.degradations],
            "counters": dict(sup.counters)}


@pytest.mark.parametrize("layout", ["replicated", "owner"])
def test_run_supervised_on_a_mesh(pool, oracle, tmp_path, layout):
    """A sharded runtime with no graph checkpoints without an
    ``AttributeError`` (the port read ``rt.csr``, which a ``ShardedRuntime``
    lacks); retries run out on every rank at the same dispatch, every rank
    degrades to ``mesh->single-device``, resumes from the checkpoint rank 0
    wrote, and returns SSSP bit-equal to the oracle."""
    g = _tgraph(GRAPHS["pads"]())
    cfg = _tconfig(KILL_CFG, vertex_sharding=layout)
    outs = pool.run(_rank_supervised, g, cfg, tmp_path / "sup.ckpt.npz")
    want = oracle("pads", "sssp", KILL_CFG)
    for o in outs:
        assert o["degradations"] == ["mesh->single-device"]
        assert o["counters"] == outs[0]["counters"]
        for res in (o["clean"], o["res"]):
            np.testing.assert_array_equal(res.values, want.values)
            assert res.iterations == want.iterations
            assert res.total_transfer_bytes == want.total_transfer_bytes
    assert restore(tmp_path / "sup.ckpt.npz").state_layout == layout


# --------------------------------------------------------------------------
# against the reference's owner runs (last: they wait for its subprocess)
# --------------------------------------------------------------------------

@pytest.mark.parametrize("gname", list(GRAPHS))
@pytest.mark.parametrize("name", PROGRAMS)
def test_ici_rows_match_reference_run(pool, ref_owner, gname, name):
    """At D = 4 the port's owner ICI rows, iterations, engine history and
    MIN values equal the reference's owner run's; the runtimes' halo counts
    are equal."""
    prog = _prog(jalg, name)
    got = _on_ranks(pool, gname, name, _tconfig(_cfg(prog), use_kernels=False), traced=True,
                    replicated=_exact(prog))[0]["result"]
    ref = ref_owner.get(f"{gname}_{name}")
    _check_ici(ref, got)
    assert got.iterations == int(ref["iterations"])
    np.testing.assert_array_equal(ref["engines"], got.history["engines"])
    if _exact(prog):
        np.testing.assert_array_equal(ref["values"], got.values)
    mesh = GraphMesh(group=None, axis="graph", size=4, rank=0, device=torch.device("cpu"))
    g = _tgraph(GRAPHS[gname]())
    rt = tgs.build_sharded_runtime(g, _tconfig(_cfg(prog)), mesh)
    assert rt.halo.halo_counts == tuple(ref_owner.get(f"{gname}_halo")["counts"].tolist())


def test_obs_halo_bytes_match_reference(pool, ref_owner):
    """Traced owner PageRank at K = 4 with pads: every ``ici`` instant
    carries ``halo_entries``, the ``ici.halo_bytes`` counter equals the
    reference's, the ICI rows equal its run's, and ``reconcile`` is exact on
    every rank."""
    outs = _on_ranks(pool, "pads", "pagerank", _tconfig(_chunked_cfg("pagerank", 4)),
                     traced=True)
    ref = ref_owner.get("traced")
    for o in outs:
        assert o["reconcile"]
        assert all("halo_entries" in ev for ev in o["ici"])
        assert o["halo_bytes"] == float(ref["halo_bytes"])
        _check_ici(ref, o["result"])
    assert outs[0]["ici"] == outs[-1]["ici"]


def _rank_resume(group, g, cfg, path):
    mesh = make_graph_mesh(group=group, device="cpu")
    return resume_run(path, g, talg.SSSP, config=cfg, source=0, mesh=mesh,
                      expect_anchor=(0, 0))


def test_checkpoints_cross_load_with_the_reference(pool, oracle, ref_owner, tmp_path):
    """The reference's owner checkpoint (D = 4, pads) resumes on the port's
    mesh bit-equal to the reference's uninterrupted run; the port's owner
    checkpoint restores in the reference with the same arrays and, migrated
    to the replicated layout, resumes in the reference's single-device run
    to the oracle's answer."""
    g = _tgraph(GRAPHS["pads"]())
    cfg = _tconfig(KILL_CFG)
    ref = ref_owner.get("kill_base")
    for res in pool.run(_rank_resume, g, cfg, ref_owner.checkpoint):
        np.testing.assert_array_equal(res.values, ref["values"])
        assert res.iterations == int(ref["iterations"])
        assert res.total_transfer_bytes == float(ref["bytes"])
    path = tmp_path / "port.ckpt.npz"
    pool.run(_rank_kill_resume, g, cfg, path, 2)
    mine = restore(path)
    theirs = jres.restore(path, expect_anchor=(0, 0), program="sssp")
    assert (theirs.state_layout, theirs.n_nodes, theirs.iterations) == ("owner", 601, 4)
    for f in ("values", "delta", "frontier"):
        np.testing.assert_array_equal(getattr(theirs, f), getattr(mine, f))
    for k, v in mine.history.items():
        np.testing.assert_array_equal(theirs.history[k], v)
    refs = jres.restore(ref_owner.checkpoint)
    for f in ("values", "delta", "frontier"):
        np.testing.assert_array_equal(getattr(refs, f), getattr(mine, f))
    rep = tmp_path / "port.rep.ckpt.npz"
    jres.save(jres.migrate_state_layout(theirs, "replicated"), rep)
    single = dataclasses.replace(KILL_CFG, mesh_axis=None, vertex_sharding="replicated")
    res = jres.resume_run(rep, GRAPHS["pads"](), jalg.SSSP, config=single, source=0,
                          expect_anchor=(0, 0))
    want = oracle("pads", "sssp", KILL_CFG)
    np.testing.assert_array_equal(res.values, want.values)
    assert res.iterations == want.iterations
    assert res.total_transfer_bytes == want.total_transfer_bytes


@pytest.mark.parametrize("forced", list(FORCED))
def test_padding_partitions_with_pad_vertices(pool, oracle, forced):
    """10 partitions on 4 ranks pad to 12, and 601 vertices to 604: the
    padding stays NONE and moves no bytes; forced engines and the hybrid
    agree with the oracle, and the ICI rows with the reference's
    ``halo_level_cost``."""
    cfg = jh.HyTMConfig(n_partitions=10, async_sweep=False, mesh_axis="graph",
                        forced_engine=FORCED[forced], vertex_sharding="owner")
    outs = _on_ranks(pool, "pads", "sssp", _tconfig(cfg), traced=True)
    got = outs[0]["result"]
    for o in outs[1:]:
        _same_result(got, o["result"])
    want = oracle("pads", "sssp", cfg)
    np.testing.assert_array_equal(want.values, got.values)
    assert want.iterations == got.iterations
    assert want.total_transfer_bytes == got.total_transfer_bytes
    eng = got.history["engines"]
    assert eng.shape == (got.iterations, 12)
    assert (eng[:, 10:] == -1).all()
    np.testing.assert_array_equal(eng[:, :10], want.history["engines"])
    _check_ici_model(got, [ev["merged_entries"] for ev in outs[0]["ici"]], 601, 4,
                     _ref_halo(GRAPHS["pads"](), 10, 4))
