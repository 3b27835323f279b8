"""The port's host graph layer against the reference's: generators, CSR
construction, hub sorting, the padded device CSR, partitioning and every
program's initial state.  All comparisons are exact (same numpy calls at the
same seeds, integer or copied float data)."""

import dataclasses
import importlib

import numpy as np
import pytest
import torch

from repro.core import constants as jconst
from repro.core import partition as jpart
from repro.graph import algorithms as jalg
from repro.graph import csr as jcsr
from repro.graph import generators as jgen
from repro_torch import convert
from repro_torch.core import constants as tconst
from repro_torch.core import partition as tpart
from repro_torch.graph import algorithms as talg
from repro_torch.graph import csr as tcsr
from repro_torch.graph import generators as tgen
from repro_torch.graph import hub_sort as thub

jhub = importlib.import_module("repro.graph.hub_sort")


def _same_csr(a, b):
    np.testing.assert_array_equal(a.indptr, b.indptr)
    np.testing.assert_array_equal(a.indices, b.indices)
    if a.weights is None:
        assert b.weights is None
    else:
        np.testing.assert_array_equal(a.weights, b.weights)


GRAPHS = [
    ("rmat_graph", (700, 6000), dict(seed=3)),
    ("rmat_graph", (512, 4000), dict(seed=1, weighted=False, dedup=True)),
    ("uniform_graph", (400, 3000), dict(seed=2)),
    ("grid_mesh_graph", (12, 17), dict(seed=5)),
]


@pytest.mark.parametrize("name,args,kw", GRAPHS)
def test_generators_equal_reference(name, args, kw):
    _same_csr(getattr(jgen, name)(*args, **kw), getattr(tgen, name)(*args, **kw))


@pytest.mark.parametrize("name,args,kw", GRAPHS)
def test_transforms_equal_reference(name, args, kw):
    gj, gt = getattr(jgen, name)(*args, **kw), getattr(tgen, name)(*args, **kw)
    _same_csr(gj.symmetrize(), gt.symmetrize())
    _same_csr(gj.transpose(), gt.transpose())
    np.testing.assert_array_equal(gj.edge_sources(), gt.edge_sources())
    np.testing.assert_array_equal(gj.in_degrees, gt.in_degrees)
    perm = np.random.default_rng(0).permutation(gj.n_nodes)
    _same_csr(gj.permute(perm), gt.permute(perm))


def test_csr_from_edges_equal_reference():
    rng = np.random.default_rng(7)
    src, dst = rng.integers(0, 300, 2000), rng.integers(0, 300, 2000)
    w = rng.random(2000).astype(np.float32)
    for dedup in (False, True):
        _same_csr(jcsr.csr_from_edges(300, src, dst, w, dedup=dedup),
                  tcsr.csr_from_edges(300, src, dst, w, dedup=dedup))


@pytest.mark.parametrize("frac", [0.08, 0.3])
def test_hub_sort_equal_reference(frac):
    g = jgen.rmat_graph(900, 8000, seed=4)
    hj = jhub.hub_sort(g, frac)
    ht = thub.hub_sort(convert.csr_graph(g.indptr, g.indices, g.weights), frac)
    assert hj.n_hubs == ht.n_hubs
    np.testing.assert_array_equal(hj.perm, ht.perm)
    np.testing.assert_array_equal(hj.inv_perm, ht.inv_perm)
    _same_csr(hj.graph, ht.graph)
    np.testing.assert_array_equal(jhub.hub_scores(g), thub.hub_scores(ht.graph.permute(ht.inv_perm)))


@pytest.mark.parametrize("capacity", [None, 9000])
def test_to_device_csr_equal_reference(capacity):
    g = jgen.rmat_graph(600, 5000, seed=2)
    dj = jcsr.to_device_csr(g, capacity=capacity)
    dt = tcsr.to_device_csr(g, capacity=capacity, device="cpu")
    for f in ("edge_src", "edge_dst", "edge_weight", "edge_valid", "out_degree", "seg_start"):
        np.testing.assert_array_equal(np.asarray(getattr(dj, f)), getattr(dt, f).numpy())
    assert (dj.n_nodes, dj.n_edges, dj.capacity) == (dt.n_nodes, dt.n_edges, dt.capacity)
    # padding contract: self-loops on vertex 0, weight +inf, edge_valid false
    pad = ~dt.edge_valid
    assert torch.all(dt.edge_src[pad] == 0) and torch.all(dt.edge_dst[pad] == 0)
    assert torch.all(torch.isinf(dt.edge_weight[pad]))
    # the conversion of the reference's arrays gives the same object
    dc = convert.device_csr(
        {f.name: np.asarray(getattr(dj, f.name)) for f in dataclasses.fields(dj)}, "cpu")
    for f in ("edge_src", "edge_dst", "edge_weight", "edge_valid", "out_degree", "seg_start"):
        assert torch.equal(getattr(dc, f), getattr(dt, f))


def test_to_device_csr_rejects_small_capacity():
    g = tgen.uniform_graph(50, 400, seed=0)
    with pytest.raises(ValueError):
        tcsr.to_device_csr(g, capacity=100, device="cpu")


@pytest.mark.parametrize("n_partitions", [None, 1, 7, 64])
def test_partitions_equal_reference(n_partitions):
    g = jgen.rmat_graph(800, 7000, seed=6)
    tj = jpart.partition_graph(g, n_partitions=n_partitions, partition_bytes=4096)
    tt = tpart.partition_graph(g, n_partitions=n_partitions, partition_bytes=4096)
    np.testing.assert_array_equal(tj.vertex_start, tt.vertex_start)
    np.testing.assert_array_equal(tj.edge_start, tt.edge_start)
    pj = jpart.to_device_partitions(tj, g.n_nodes, 8192)
    pt = tpart.to_device_partitions(tt, g.n_nodes, 8192, device="cpu")
    for f in ("vertex_start", "edge_start", "part_edges", "vertex_part_id"):
        np.testing.assert_array_equal(np.asarray(getattr(pj, f)), getattr(pt, f).numpy())
    assert (pj.n_partitions, pj.block_size) == (pt.n_partitions, pt.block_size)
    pc = convert.device_partitions({
        f: np.asarray(getattr(pj, f)) for f in (
            "vertex_start", "edge_start", "part_edges", "vertex_part_id",
            "n_partitions", "block_size")}, "cpu")
    assert pc.host == pt.host and pc.block_size == pt.block_size


@pytest.mark.parametrize("name", sorted(jalg.ALGORITHMS))
def test_init_state_equal_reference(name):
    pj, pt = jalg.ALGORITHMS[name], talg.ALGORITHMS[name]
    assert (pj.combine, pj.use_delta, pj.damping, pj.tolerance, pj.weighted,
            pj.personalized, pj.symmetrize, pj.peel_k) == (
        pt.combine, pt.use_delta, pt.damping, pt.tolerance, pt.weighted,
        pt.personalized, pt.symmetrize, pt.peel_k)
    if pj.peel_k is not None:
        with pytest.raises(ValueError):
            pt.init_state(50, 0, "cpu")
        return
    for source in (0, 17, None):
        if source is None and not pj.use_delta:
            continue
        want = pj.init_state(50, source)
        got = pt.init_state(50, source, "cpu")
        for a, b in zip(want, got):
            np.testing.assert_array_equal(np.asarray(a), b.numpy())
            assert np.asarray(a).dtype == b.numpy().dtype


@pytest.mark.parametrize("name", ["sssp", "bfs", "cc", "pagerank", "php", "kcore"])
def test_edge_messages_equal_reference(name):
    rng = np.random.default_rng(11)
    op = rng.random(64).astype(np.float32)
    w = rng.integers(1, 64, 64).astype(np.float32)
    want = np.asarray(jalg.ALGORITHMS[name].edge_message(op, w))
    got = talg.ALGORITHMS[name].edge_message(torch.from_numpy(op), torch.from_numpy(w))
    np.testing.assert_array_equal(want, got.numpy())


def test_link_model_round_trip():
    for link in (jconst.PCIE3, jconst.PCIE3.with_(mr=4.0)):
        assert dataclasses.asdict(convert.link_model(dataclasses.asdict(link))) == \
            dataclasses.asdict(link)
    assert dataclasses.asdict(tconst.PCIE3) == dataclasses.asdict(jconst.PCIE3)
    with pytest.raises(ValueError):
        convert.link_model({"name": "x", "beta": 2.0})
    with pytest.raises(ValueError):
        convert.link_model({"name": "x", "bogus": 1.0})
