"""The host-sync readers: the program's counters over its iterations, and
nothing where the program keeps no counter."""

import pytest

from hytbench.harness import Observed, RunRecord, metric_reader
from repro_torch.core import hytm


def observed(algorithm, runs=(RunRecord(0.1, 5, 100.0, 0.0, 10),)):
    return Observed(algorithm=algorithm, arcs=2000, setup_s=1.0, prep_s=0.5, runs=list(runs),
                    launches={}, trace=None)


@pytest.mark.parametrize("algorithm", ["sssp", "pagerank"])
def test_syncs_over_iterations(monkeypatch, algorithm):
    other = {"sssp": "pagerank", "pagerank": "sssp"}[algorithm]
    reader = metric_reader(f"host_syncs_per_iter.{algorithm}")
    monkeypatch.setattr(hytm, "host_syncs", {"fetch": 40, "drain": 32, "active": 4,
                                             "calib": 0, "history": 0, "copy_out": 6})
    monkeypatch.setattr(hytm, "iterations_run", 38)
    assert reader.read(observed(algorithm)) == pytest.approx(82 / 38)
    assert reader.read(observed(other)) is None
    assert reader.read(observed(algorithm, runs=())) is None
    monkeypatch.setattr(hytm, "iterations_run", 0)
    assert reader.read(observed(algorithm)) is None
    # a program without the counters (the commit before them) reads nothing
    monkeypatch.delattr(hytm, "host_syncs")
    monkeypatch.delattr(hytm, "iterations_run")
    assert reader.read(observed(algorithm)) is None


def test_a_run_reads_its_own_syncs():
    """On the CPU the counters move by each run's reads: one fetch an
    iteration (one more where the last chunk stops early), eight history
    copies and one frontier count a chunk, two copies out."""
    from repro_torch.graph import algorithms
    from repro_torch.graph.generators import rmat_graph

    g = rmat_graph(256, 2048, seed=1)
    cfg = hytm.HyTMConfig(n_partitions=4, sync_every=8)
    syncs, iters = sum(hytm.host_syncs.values()), hytm.iterations_run
    res = hytm.run_hytm(g, algorithms.SSSP, 0, cfg, device="cpu")
    n, chunks = res.iterations, -(-res.iterations // 8)
    assert hytm.iterations_run - iters == n
    assert sum(hytm.host_syncs.values()) - syncs == n + (n % 8 != 0) + 9 * chunks + 2
    value = metric_reader("host_syncs_per_iter.sssp").read(observed("sssp"))
    assert value == sum(hytm.host_syncs.values()) / hytm.iterations_run
