"""Synthetic graph generators (host-side CSR graphs).

``rmat_graph`` follows Chakrabarti et al. [arXiv:cs/0412052 / SIAM'04] with
the canonical (a,b,c,d) = (0.57, 0.19, 0.19, 0.05) power-law parameters the
paper's RMAT ladder uses (paper §VII-F).  ``grid_mesh_graph`` builds the
MeshGraphNet-style simulation mesh; ``batched_molecule_graphs`` builds the
`molecule` shape cell (128 graphs x 30 nodes x 64 bonds, 128 arcs).  The
arrays equal ``repro``'s at the same seed (the same numpy draws in the same
order; ``rmat_graph`` may do its arithmetic and sort on a card).
"""

from __future__ import annotations

import numpy as np
import torch

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
    device: str | torch.device | None = None,
) -> CSRGraph:
    """R-MAT generator, vectorized over all edges, one bit-level at a time.

    Each level draws ``rng.random(n_edges)`` as the 64-bit outputs it is
    made of (``(x >> 11) * 2**-53``, numpy's own conversion), and the
    quadrant arithmetic and the CSR sort run in torch on ``device`` (the CPU
    by default).  The graph is the same on every device and equals the one
    drawn level by level with ``np.searchsorted``."""
    rng = np.random.default_rng(seed)
    scale = max(1, int(np.ceil(np.log2(max(n_nodes, 2)))))
    d = 1.0 - a - b - c
    if d < 0:
        raise ValueError(f"a + b + c must be <= 1, got {a + b + c}")
    dev = torch.device("cpu" if device is None else device)
    src = torch.zeros(n_edges, dtype=torch.int64, device=dev)
    dst = torch.zeros(n_edges, dtype=torch.int64, device=dev)
    # Quadrant probabilities: [a (0,0), b (0,1), c (1,0), d (1,1)]
    probs = np.cumsum([a, b, c, d])
    for level in range(scale):
        raw = torch.from_numpy(rng.bit_generator.random_raw(n_edges).view(np.int64)).to(dev)
        u = ((raw >> 11) & ((1 << 53) - 1)).to(torch.float64) * 2.0**-53
        # np.searchsorted(probs, u) counts the probs below u
        above = [u > float(p) for p in probs]
        src = (src << 1) | above[1]                                  # quadrant >= 2
        dst = (dst << 1) | (above[0] ^ above[1] ^ above[2] ^ above[3])  # quadrant 1 or 3
    src %= n_nodes
    dst %= n_nodes
    weights = rng.integers(1, 64, size=n_edges).astype(np.float32) if weighted else None
    return csr_from_edges(n_nodes, src, dst, weights, dedup=dedup, device=dev)


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
