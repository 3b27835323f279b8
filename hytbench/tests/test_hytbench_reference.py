"""The plain references against textbook NumPy versions."""

import heapq

import numpy as np
import pytest
import torch

from hytbench.reference import Arcs
from hytbench.reference.components import component_edges
from hytbench.reference.pagerank import pagerank
from hytbench.reference.sssp import sssp
from hytbench.tests.test_hytbench_gen import draw


def dijkstra(g, s):
    dist = np.full(g.n, np.inf)
    dist[s] = 0.0
    heap = [(0.0, s)]
    while heap:
        d, u = heapq.heappop(heap)
        if d > dist[u]:
            continue
        for k in range(g.indptr[u], g.indptr[u + 1]):
            v, nd = g.indices[k], d + g.weights[k]
            if nd < dist[v]:
                dist[v] = nd
                heapq.heappush(heap, (nd, v))
    return dist


def power_iteration(g, d, iters=400):
    deg = np.maximum(g.degrees, 1).astype(np.float64)
    src = np.repeat(np.arange(g.n), g.degrees)
    r = np.full(g.n, 1 - d)
    for _ in range(iters):
        nxt = np.full(g.n, 1 - d)
        np.add.at(nxt, g.indices, d * r[src] / deg[src])
        r = nxt
    return r


@pytest.fixture(scope="module", params=["kron", "urand"])
def graph(request):
    g = draw(request.param, 11)
    return g, Arcs.of(g.indptr, g.indices, g.weights, torch.device("cpu"))


def test_sssp_is_dijkstra(graph):
    g, arcs = graph
    rng = np.random.default_rng(0)
    for s in rng.choice(np.flatnonzero(g.degrees > 0), 4, replace=False):
        np.testing.assert_array_equal(sssp(arcs, int(s)).numpy(), dijkstra(g, int(s)))


def test_pagerank_is_power_iteration(graph):
    g, arcs = graph
    np.testing.assert_allclose(pagerank(arcs, 0.85).numpy(), power_iteration(g, 0.85),
                               rtol=1e-9, atol=0)


def test_components_count_undirected_edges(graph):
    g, arcs = graph
    label, edges = component_edges(arcs)
    label, edges = label.numpy(), edges.numpy()
    # union-find over the arcs
    parent = list(range(g.n))

    def root(x):
        while parent[x] != x:
            parent[x] = parent[parent[x]]
            x = parent[x]
        return x

    src = np.repeat(np.arange(g.n), g.degrees)
    for u, v in zip(src.tolist(), g.indices.tolist()):
        parent[root(u)] = root(v)
    roots = np.array([root(v) for v in range(g.n)])
    for r in np.unique(roots):
        members = np.flatnonzero(roots == r)
        assert np.all(label[members] == members.min())
        assert edges[members.min()] == g.degrees[members].sum() // 2
