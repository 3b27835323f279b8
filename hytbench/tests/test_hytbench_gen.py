"""The generators draw GAP's graphs: symmetric, simple, weighted in
[1, 255], and the same graph for the same seed."""

import numpy as np
import pytest
import torch

from hytbench.harness import generator

CFG = {"kron": dict(generator="kron", scale=10, degree=16, a=0.57, b=0.19, c=0.19,
                    weight_min=1, weight_max=255),
       "urand": dict(generator="urand", scale=10, degree=16, weight_min=1, weight_max=255)}


def draw(family: str, seed: int):
    gen = torch.Generator().manual_seed(seed)
    return generator(family).generate(CFG[family], gen, torch.device("cpu"))


def arcs_of(g):
    src = np.repeat(np.arange(g.n), g.degrees)
    return src, g.indices.astype(np.int64), g.weights


@pytest.mark.parametrize("family", sorted(CFG))
def test_graph_is_gap_shaped(family):
    g = draw(family, 2**31 + 7)
    src, dst, w = arcs_of(g)
    assert g.n == 2**10 and g.indptr[0] == 0 and np.all(np.diff(g.indptr) >= 0)
    assert not np.any(src == dst), "self-loop"
    key = src * g.n + dst
    assert len(np.unique(key)) == len(key), "duplicate arc"
    assert np.all(np.diff(key) > 0), "rows not sorted by destination"
    back = dict(zip((dst * g.n + src).tolist(), w.tolist()))
    assert set(back) == set(key.tolist()), "not symmetric"
    assert all(back[k] == x for k, x in zip(key.tolist(), w.tolist())), "arcs differ in weight"
    assert w.dtype == np.float32 and np.all(w == np.round(w))
    assert w.min() >= 1 and w.max() <= 255
    # most draws survive: degree 16 gives close to 32 arcs a vertex
    assert 20 * g.n < g.arcs <= 32 * g.n


@pytest.mark.parametrize("family", sorted(CFG))
def test_same_seed_same_graph(family):
    a, b, c = draw(family, 5), draw(family, 5), draw(family, 6)
    for x, y in ((a.indptr, b.indptr), (a.indices, b.indices), (a.weights, b.weights)):
        np.testing.assert_array_equal(x, y)
    assert not (np.array_equal(a.indptr, c.indptr) and np.array_equal(a.indices, c.indices))


def test_kron_is_skewed_and_urand_is_not():
    k, u = draw("kron", 3), draw("urand", 3)
    assert k.degrees.max() > 5 * u.degrees.max()
    assert (k.degrees == 0).sum() > (u.degrees == 0).sum()
