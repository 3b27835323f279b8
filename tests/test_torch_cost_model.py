"""The port's Algorithm-1 selection against the reference's, bit for bit:
for random frontiers on a hub-sorted RMAT graph, with and without a (3,)
correction, the partition stats, Eq. 1-3 costs, engines, combined task
count, modeled transfer bytes and time, schedule order and second-pass
flags must be identical.

The reference runs its cost model under ``jax.jit``, where XLA may contract
``gamma*RTT + (1-gamma)*ratio*RTT`` into a fused multiply-add and turn a
division by a constant into a multiplication; the jitted and the eager
reference then differ in the last place of Tiz and Tec_full (one ulp in
RTT_zc, two after the product with the request count).  The port does the
float32 arithmetic op by op, so its costs equal the *eager* reference bit
for bit and the jitted one within two ulp; every integer and boolean output
(engines, task count, transfer bytes, order, second pass) equals the
jitted reference's."""

import dataclasses
import importlib
import zlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import cost_model as jcm
from repro.core import hytm as jhytm
from repro.core import scheduler as jsched
from repro.core import task_generation as jtg
from repro.core.constants import PCIE3 as JPCIE3
from repro.graph import generators as jgen
from repro_torch import convert
from repro_torch.core import cost_model as tcm
from repro_torch.core import hytm as thytm
from repro_torch.core import scheduler as tsched
from repro_torch.core import task_generation as ttg

jhub = importlib.import_module("repro.graph.hub_sort")

LINKS = {"pcie3": JPCIE3, "pcie3_mr4": JPCIE3.with_(mr=4.0),
         "full_compaction": JPCIE3.with_(mr=16.0, selection_uses_full_compaction_cost=True)}


@pytest.fixture(scope="module")
def graph():
    g = jgen.rmat_graph(1500, 14000, seed=9)
    hs = jhub.hub_sort(g)
    return hs


def _runtimes(hs, link, n_partitions):
    cfg_j = jhytm.HyTMConfig(link=link, n_partitions=n_partitions)
    cfg_t = thytm.HyTMConfig(link=convert.link_model(dataclasses.asdict(link)),
                             n_partitions=n_partitions)
    rj = jhytm.build_runtime(hs.graph, cfg_j, n_hubs=hs.n_hubs)
    rt = thytm.build_runtime(hs.graph, cfg_t, n_hubs=hs.n_hubs, device="cpu")
    return rj, rt, cfg_t.link


def _flat(stats, plan, sched):
    return [*stats, plan.engines, plan.n_tasks, plan.transfer_bytes,
            sched.order, sched.second_pass]


def _floats(plan):
    return [plan.transfer_time, *plan.costs]


def _same(want, got):
    assert len(want) == len(got)
    for a, b in zip(want, got):
        a = np.asarray(a)
        b = b.numpy()
        assert a.dtype == b.dtype and a.shape == b.shape
        np.testing.assert_array_equal(a, b)


@pytest.mark.parametrize("link_name", sorted(LINKS))
@pytest.mark.parametrize("with_correction", [False, True])
@pytest.mark.parametrize("mode", ["hub", "delta"])
def test_selection_bit_identical(graph, link_name, with_correction, mode):
    link = LINKS[link_name]
    rj, rt, tlink = _runtimes(graph, link, 24)
    np.testing.assert_array_equal(np.asarray(rj.zc_req), rt.zc_req.numpy())
    np.testing.assert_array_equal(np.asarray(rj.inv_deg), rt.inv_deg.numpy())
    assert rj.n_hub_partitions == rt.n_hub_partitions
    rng = np.random.default_rng(zlib.crc32(f"{link_name}-{with_correction}-{mode}".encode()))
    corr = rng.uniform(0.5, 2.0, 3).astype(np.float32) if with_correction else None

    def ref(frontier, delta_mass, correction):
        stats = jcm.partition_stats(frontier, rj.csr.out_degree, rj.zc_req, rj.parts)
        plan = jtg.generate_tasks(stats, link, correction=correction)
        sched = jsched.make_schedule(plan.engines, delta_mass, rj.n_hub_partitions, mode, True)
        diag = jcm.selection_diagnostics(plan.engines, plan.transfer_time, stats,
                                         plan.costs, correction)
        return _flat(stats, plan, sched), diag[1], _floats(plan)

    jitted = jax.jit(ref)

    for density in (0.0, 0.002, 0.02, 0.1, 0.4, 1.0):
        frontier = rng.random(rt.csr.n_nodes) < density
        delta_mass = rng.random(rt.parts.n_partitions).astype(np.float32)
        delta_mass[rng.random(delta_mass.shape) < 0.3] = 0.0
        args = (jnp.asarray(frontier), jnp.asarray(delta_mass),
                None if corr is None else jnp.asarray(corr))
        want, want_mis, jit_floats = jitted(*args)
        _, _, eager_floats = ref(*args)
        f = torch.from_numpy(frontier)
        c = None if corr is None else torch.from_numpy(corr)
        stats = tcm.partition_stats(f, rt.csr.out_degree, rt.zc_req, rt.parts)
        plan = ttg.generate_tasks(stats, tlink, correction=c)
        sched = tsched.make_schedule(plan.engines, torch.from_numpy(delta_mass),
                                     rt.n_hub_partitions, mode, True)
        _same(want, _flat(stats, plan, sched))
        _same(eager_floats, _floats(plan))
        for a, b in zip(jit_floats, _floats(plan)):
            np.testing.assert_array_max_ulp(np.asarray(a), b.numpy(), maxulp=2)
        _, mis = tcm.selection_diagnostics(plan.engines, plan.transfer_time, stats,
                                           plan.costs, c)
        assert int(mis) == int(want_mis)


@pytest.mark.parametrize("engine", [jcm.FILTER, jcm.COMPACT, jcm.ZEROCOPY])
@pytest.mark.parametrize("combination", [True, False])
def test_forced_engine_plan_bit_identical(graph, engine, combination):
    rj, rt, tlink = _runtimes(graph, JPCIE3, 16)
    rng = np.random.default_rng(engine)
    frontier = rng.random(rt.csr.n_nodes) < 0.05
    sj = jcm.partition_stats(jnp.asarray(frontier), rj.csr.out_degree, rj.zc_req, rj.parts)
    st = tcm.partition_stats(torch.from_numpy(frontier), rt.csr.out_degree, rt.zc_req, rt.parts)
    pj = jax.jit(lambda s: jtg.forced_engine_plan(s, JPCIE3, engine, combination))(sj)
    pt = ttg.forced_engine_plan(st, tlink, engine, combination)
    _same([pj.engines, pj.n_tasks, pj.transfer_bytes, pj.transfer_time],
          [pt.engines, pt.n_tasks, pt.transfer_bytes, pt.transfer_time])


@pytest.mark.parametrize("link_name", sorted(LINKS))
def test_engine_bandwidths_match_reference(graph, link_name):
    """The (3, P) modeled bandwidth rows on the frontiers of the selection
    test: bit-equal to the reference run eagerly, and within 4 ulp of it
    jitted (XLA contracts products and sums into FMAs: the seconds differ
    by up to 2 ulp, as in the selection test, the bytes by 1, and the
    quotient adds its own rounding).  Partitions of no modeled time (every
    row at density 0) are 0."""
    link = LINKS[link_name]
    rj, rt, tlink = _runtimes(graph, link, 24)
    rng = np.random.default_rng(zlib.crc32(link_name.encode()))

    def ref(frontier):
        stats = jcm.partition_stats(frontier, rj.csr.out_degree, rj.zc_req, rj.parts)
        return jcm.engine_bandwidths(stats, jcm.engine_costs(stats, link), link)

    jitted = jax.jit(ref)
    for density in (0.0, 0.002, 0.02, 0.1, 0.4, 1.0):
        frontier = rng.random(rt.csr.n_nodes) < density
        want = np.asarray(ref(jnp.asarray(frontier)))
        stats = tcm.partition_stats(torch.from_numpy(frontier), rt.csr.out_degree, rt.zc_req,
                                    rt.parts)
        got = tcm.engine_bandwidths(stats, tcm.engine_costs(stats, tlink), tlink)
        assert got.dtype == torch.float32 and got.shape == (3, rt.parts.n_partitions)
        np.testing.assert_array_equal(want, got.numpy())
        np.testing.assert_array_max_ulp(np.asarray(jitted(jnp.asarray(frontier))), got.numpy(),
                                        maxulp=4)
        if density == 0.0:
            assert not got[1:].any()


@pytest.mark.parametrize("k", [1, 2, 4, 7])
def test_merged_filter_tasks_exact(k):
    rng = np.random.default_rng(k)
    for p in (0.0, 0.3, 0.7, 1.0):
        flags = rng.random(97) < p
        want = int(jtg._merged_filter_tasks(jnp.asarray(flags), k))
        assert int(ttg._merged_filter_tasks(torch.from_numpy(flags), k)) == want


@pytest.mark.parametrize("mode", ["hub", "delta", "none"])
@pytest.mark.parametrize("recompute_once", [True, False])
def test_make_schedule_stable_ties(mode, recompute_once):
    rng = np.random.default_rng(3)
    engines = rng.integers(-1, 3, 40).astype(np.int32)
    mass = rng.choice(np.array([0.0, 0.5, 1.0], np.float32), 40)  # many ties
    want = jsched.make_schedule(jnp.asarray(engines), jnp.asarray(mass), 5, mode,
                                recompute_once)
    got = tsched.make_schedule(torch.from_numpy(engines), torch.from_numpy(mass), 5,
                               mode, recompute_once)
    _same(list(want), list(got))


def test_history_shapes_match_reference(graph):
    rj, rt, _ = _runtimes(graph, JPCIE3, 8)
    prog_j = importlib.import_module("repro.graph.algorithms").SSSP
    vals, delta, front = prog_j.init_state(rj.csr.n_nodes, 0)
    _, info = jhytm.hytm_iteration(
        jhytm.HyTMState(vals, delta, front), rj.csr, rj.parts, rj.zc_req, rj.inv_deg,
        prog_j, jhytm.HyTMConfig(n_partitions=8), rj.n_hub_partitions)
    shapes = tcm.history_shapes(rt.parts.n_partitions)
    assert set(shapes) == set(tcm.HISTORY_KEYS) == set(jcm.HISTORY_KEYS)
    for k, (shape, dtype) in shapes.items():
        a = np.asarray(info[k])
        assert a.shape == shape and a.dtype == torch.empty(0, dtype=dtype).numpy().dtype
    buf = tcm.init_history_buffers(shapes, 4)
    assert buf[tcm.KEY_ENGINES].shape == (4, 8)
