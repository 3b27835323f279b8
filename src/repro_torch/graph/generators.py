"""Synthetic graph generators (host-side numpy).

``rmat_graph`` follows Chakrabarti et al. [arXiv:cs/0412052 / SIAM'04] with
the canonical (a,b,c,d) = (0.57, 0.19, 0.19, 0.05) power-law parameters the
paper's RMAT ladder uses (paper §VII-F).  ``grid_mesh_graph`` builds the
MeshGraphNet-style simulation mesh; ``batched_molecule_graphs`` builds the
`molecule` shape cell (128 graphs x 30 nodes x 64 bonds, 128 arcs).  The
arrays equal ``repro``'s at the same seed (same numpy calls in the same
order).
"""

from __future__ import annotations

import numpy as np

from repro_torch.graph.csr import CSRGraph, csr_from_edges


def rmat_graph(
    n_nodes: int,
    n_edges: int,
    seed: int = 0,
    a: float = 0.57,
    b: float = 0.19,
    c: float = 0.19,
    weighted: bool = True,
    dedup: bool = False,
) -> CSRGraph:
    """R-MAT generator, vectorized over all edges and bit-levels at once."""
    rng = np.random.default_rng(seed)
    scale = max(1, int(np.ceil(np.log2(max(n_nodes, 2)))))
    d = 1.0 - a - b - c
    if d < 0:
        raise ValueError(f"a + b + c must be <= 1, got {a + b + c}")
    src = np.zeros(n_edges, dtype=np.int64)
    dst = np.zeros(n_edges, dtype=np.int64)
    # Quadrant probabilities: [a (0,0), b (0,1), c (1,0), d (1,1)]
    probs = np.cumsum([a, b, c, d])
    for level in range(scale):
        u = rng.random(n_edges)
        quadrant = np.searchsorted(probs, u)
        src_bit = quadrant >= 2
        dst_bit = (quadrant == 1) | (quadrant == 3)
        src = (src << 1) | src_bit
        dst = (dst << 1) | dst_bit
    src %= n_nodes
    dst %= n_nodes
    weights = rng.integers(1, 64, size=n_edges).astype(np.float32) if weighted else None
    return csr_from_edges(n_nodes, src, dst, weights, dedup=dedup)


def uniform_graph(
    n_nodes: int, n_edges: int, seed: int = 0, weighted: bool = True
) -> CSRGraph:
    rng = np.random.default_rng(seed)
    src = rng.integers(0, n_nodes, size=n_edges)
    dst = rng.integers(0, n_nodes, size=n_edges)
    weights = rng.integers(1, 64, size=n_edges).astype(np.float32) if weighted else None
    return csr_from_edges(n_nodes, src, dst, weights)


def grid_mesh_graph(height: int, width: int, seed: int = 0) -> CSRGraph:
    """2-D simulation mesh with 4-neighbourhood + diagonal bracing edges,
    bidirectional (MeshGraphNet processes directed mesh edges both ways)."""
    ids = np.arange(height * width).reshape(height, width)
    pairs = []
    pairs.append((ids[:, :-1].ravel(), ids[:, 1:].ravel()))  # horizontal
    pairs.append((ids[:-1, :].ravel(), ids[1:, :].ravel()))  # vertical
    pairs.append((ids[:-1, :-1].ravel(), ids[1:, 1:].ravel()))  # diagonal
    src = np.concatenate([p[0] for p in pairs])
    dst = np.concatenate([p[1] for p in pairs])
    s = np.concatenate([src, dst])
    d = np.concatenate([dst, src])
    rng = np.random.default_rng(seed)
    w = rng.random(len(s)).astype(np.float32) + 0.5
    return csr_from_edges(height * width, s, d, w)


def batched_molecule_graphs(
    n_graphs: int, n_nodes: int = 30, n_edges: int = 64, seed: int = 0
) -> CSRGraph:
    """A batch of small molecule-like graphs packed into one block-diagonal
    CSR (standard batched-small-graph layout; segment ids recover graphs).
    ``n_edges`` counts arcs: ``n_edges // 2`` bonds a graph, each both ways."""
    rng = np.random.default_rng(seed)
    srcs, dsts = [], []
    for gidx in range(n_graphs):
        base = gidx * n_nodes
        # a spanning path guarantees connectivity, rest random (bond-like)
        path_s = np.arange(n_nodes - 1)
        path_d = np.arange(1, n_nodes)
        extra = n_edges // 2 - (n_nodes - 1)
        rs = rng.integers(0, n_nodes, size=max(extra, 0))
        rd = rng.integers(0, n_nodes, size=max(extra, 0))
        s = np.concatenate([path_s, rs])
        d = np.concatenate([path_d, rd])
        # undirected
        srcs.append(base + np.concatenate([s, d]))
        dsts.append(base + np.concatenate([d, s]))
    src = np.concatenate(srcs)
    dst = np.concatenate(dsts)
    w = rng.random(len(src)).astype(np.float32)
    return csr_from_edges(n_graphs * n_nodes, src, dst, w)
