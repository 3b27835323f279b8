"""``correct`` is decided by a comparison shown to fail: the control (the
reference in bfloat16, the precision below the program's float32) fails
each cell's limit, and so does a run whose timed path is broken underneath
in each way a cell can be: a run that returns its state unchanged, half of
the answers left out, one answer altered where it is produced.  A sound
run passes.  (A CPU size; the chip readings are in PERF.md.)"""

import dataclasses

import numpy as np
import pytest
import torch

from hytbench import harness
from hytbench.reference import Arcs
from hytbench.reference.pagerank import pagerank
from hytbench.reference.sssp import sssp
from hytbench.tests.test_hytbench_gen import draw

CELLS = ("kron-sssp", "kron-pagerank", "urand-sssp")
SCALE = 10


@pytest.fixture(scope="module")
def spec():
    return harness.load_spec()


def limit_of(traffic: str) -> float:
    return harness.traffic_of(traffic)["check"]["limit"]


def test_control_fails_sssp():
    # kron: at this size urand's distances all lie below 256, where
    # bfloat16 holds every integer (PERF.md gives the card's readings)
    g = draw("kron", 2**31 + 99)
    arcs = Arcs.of(g.indptr, g.indices, g.weights, torch.device("cpu"))
    sources = np.random.default_rng(0).choice(np.flatnonzero(g.degrees > 0), 3)
    for s in sources:
        want = sssp(arcs, int(s)).numpy()
        control = sssp(arcs, int(s), dtype=torch.bfloat16).numpy()
        assert harness.sssp_gap(control, want) > limit_of("sssp_sources")


def test_control_fails_pagerank():
    g = draw("kron", 2**31 + 99)
    arcs = Arcs.of(g.indptr, g.indices, g.weights, torch.device("cpu"))
    want = pagerank(arcs, 0.85).numpy()
    control = pagerank(arcs, 0.85, dtype=torch.bfloat16).numpy()
    assert harness.pagerank_gap(control, want) > 3 * limit_of("pagerank_runs")


def unchanged(res, init, rng):
    return init


def half_left_out(res, init, rng):
    keep = rng.random(len(init[0])) < 0.5
    return tuple(np.where(keep, got, start) for got, start in zip((res.values, res.delta), init))


def one_altered(res, init, rng):
    values = res.values.copy()
    v = rng.choice(np.flatnonzero(np.isfinite(values) & (values > 0)))
    values[v] = values[v] * 1.5 + 1.0
    return values, res.delta


def run(spec, cell_name, monkeypatch, fault=None):
    cell = harness.find(spec["workloads"], cell_name, "workload")
    cfg = dict(harness.config_of(spec, cell), scale=SCALE)
    monkeypatch.setattr(harness.tracing, "traced", None)
    if fault is not None:
        from repro_torch.core import hytm

        real = hytm.run_hytm
        rng = np.random.default_rng(1)

        def broken(g, program, source, config, runtime, obs=None):
            res = real(g, program, source, config, runtime=runtime, obs=obs)
            init = tuple(t.numpy() for t in program.init_state(runtime.n_nodes, source, "cpu")[:2])
            values, delta = fault(res, init, rng)
            return dataclasses.replace(res, values=values, delta=delta)

        monkeypatch.setattr(hytm, "run_hytm", broken)
    return harness.run_cell(spec, cell, 2**31 + 5, 0.2, False, torch.device("cpu"),
                            t_start=0.0, cfg=cfg)


@pytest.mark.parametrize("cell", CELLS)
def test_sound_run_is_correct(spec, cell, monkeypatch):
    out = run(spec, cell, monkeypatch)
    assert out["correct"] and out["failed"] == 0 and out["attempted"] >= 1
    assert list(out)[-1] == "checks"


@pytest.mark.parametrize("fault", [unchanged, half_left_out, one_altered])
@pytest.mark.parametrize("cell", CELLS)
def test_broken_run_is_not_correct(spec, cell, fault, monkeypatch):
    out = run(spec, cell, monkeypatch, fault)
    assert not out["correct"], fault.__name__


def test_failed_request_is_not_correct(spec, monkeypatch):
    from repro_torch.core import hytm

    real, calls = hytm.run_hytm, []

    def flaky(*args, **kw):
        calls.append(1)
        if len(calls) == 3:   # set-up's warm-up is call 1
            raise RuntimeError("injected")
        return real(*args, **kw)

    monkeypatch.setattr(hytm, "run_hytm", flaky)
    out = run(spec, "kron-sssp", monkeypatch)
    assert out["failed"] == 1 and not out["correct"]


@pytest.mark.parametrize("cell, fixed", [("kron-pagerank", True), ("kron-sssp", False)])
def test_graph_seed_fixes_the_draw(spec, cell, fixed, monkeypatch):
    """A mix with ``graph_seed`` draws one graph for every run seed; the
    others draw the graph from the run seed."""
    seeds = []
    real = harness.generator

    def spy(family):
        mod = real(family)

        class Spy:
            @staticmethod
            def generate(cfg, gen, device):
                seeds.append(gen.initial_seed())
                return mod.generate(cfg, gen, device)
        return Spy

    monkeypatch.setattr(harness, "generator", spy)
    entry = harness.find(spec["workloads"], cell, "workload")
    cfg = dict(harness.config_of(spec, entry), scale=8)
    monkeypatch.setattr(harness.tracing, "traced", None)
    for seed in (11, 12):
        assert harness.run_cell(spec, entry, seed, 0.05, False, torch.device("cpu"),
                                t_start=0.0, cfg=cfg)["correct"]
    assert (seeds[0] == seeds[1]) == fixed
