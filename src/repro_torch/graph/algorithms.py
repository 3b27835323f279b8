"""Vertex-centric push-based programs (paper §II-A) + numpy references.

A ``VertexProgram`` is the generic function of the paper's Figure 1: each
*active* vertex sends a message along its out-edges; messages combine at
the destination with an associative-commutative combiner; updated
destinations become active next iteration.

Two families, matching the paper's two active-vertex change patterns:

* traversal / value-replacement (combine=min): SSSP, BFS, CC, WCC;
* accumulative (combine=sum): Δ-PageRank, PHP, PPR — the vertex carries
  (value, pending-Δ);

plus k-core peeling (unit removal counts combined with SUM).  The
``edge_message`` callables act on torch tensors; the ``reference_*``
oracles are numpy.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Callable

import numpy as np
import torch

from repro_torch.graph.csr import CSRGraph
from repro_torch.kernels.runtime import resolve_device

MIN, SUM = 0, 1


@dataclass(frozen=True)
class VertexProgram:
    name: str
    combine: int  # MIN or SUM
    # message emitted along an edge: f(source_operand, edge_weight) where
    # source_operand is `values[src]` (traversal) or
    # `damping * delta[src] / deg[src]` (accumulative).
    edge_message: Callable
    use_delta: bool = False
    damping: float = 0.85
    tolerance: float = 1e-3
    weighted: bool = True
    # personalized accumulative programs (PPR): the teleport mass starts on
    # the source vertex only
    personalized: bool = False
    # WCC-family programs run on the underlying undirected graph:
    # run_hytm symmetrizes its input before building the runtime
    symmetrize: bool = False
    # peeling programs (k-core): values = remaining degree, Δ = removed
    # flag, frontier = newly-removed set; seeded by run_hytm from the
    # runtime's degrees, never by init_state
    peel_k: float | None = None

    def init_state(self, n: int, source: int | None,
                   device: str | torch.device | None = None):
        """The (values, delta, frontier) triple a cold run starts from,
        on ``cuda`` unless ``device`` says otherwise."""
        if self.peel_k is not None:
            raise ValueError(
                f"{self.name}: peeling programs seed from vertex degrees; "
                "use run_hytm (it special-cases the init), not init_state")
        dev = resolve_device(device)
        f32 = torch.float32
        # the source's entries are set with fill_ on a one-element slice: an
        # item store of a Python scalar copies it from host memory, a host
        # sync on CUDA (range() indexes as a tensor does, negatives included)
        at = None if source is None else slice(range(n)[source], range(n)[source] + 1)
        if self.use_delta and self.personalized and source is not None:
            values = torch.zeros(n, dtype=f32, device=dev)
            delta = torch.zeros(n, dtype=f32, device=dev)
            delta[at].fill_(1.0 - self.damping)
            frontier = torch.zeros(n, dtype=torch.bool, device=dev)
            frontier[at].fill_(True)
        elif self.use_delta:
            values = torch.zeros(n, dtype=f32, device=dev)
            delta = torch.full((n,), 1.0 - self.damping, dtype=f32, device=dev)
            frontier = torch.ones(n, dtype=torch.bool, device=dev)
        elif self.name in ("cc", "wcc"):
            # labels are exact in float32 for n < 2**24
            values = torch.arange(n, dtype=f32, device=dev)
            delta = torch.zeros(n, dtype=f32, device=dev)
            frontier = torch.ones(n, dtype=torch.bool, device=dev)
        else:
            values = torch.full((n,), float("inf"), dtype=f32, device=dev)
            values[at].fill_(0.0)
            delta = torch.zeros(n, dtype=f32, device=dev)
            frontier = torch.zeros(n, dtype=torch.bool, device=dev)
            frontier[at].fill_(True)
        return values, delta, frontier


def init_state(program: VertexProgram, n: int, source: int | None,
               device: str | torch.device | None = None):
    """Module-level alias of ``program.init_state``."""
    return program.init_state(n, source, device)


def _sssp_msg(src_val, w):
    return src_val + w


def _bfs_msg(src_val, w):
    return src_val + 1.0


def _cc_msg(src_val, w):
    return src_val


def _pr_msg(src_delta_over_deg, w):
    return src_delta_over_deg  # damping folded in by the sweep


def _php_msg(src_delta_over_deg, w):
    return src_delta_over_deg * w


def _kcore_msg(src_op, w):
    # unit removal count (inactive lanes are masked to 0.0 by the engines)
    return torch.ones_like(src_op)


SSSP = VertexProgram("sssp", MIN, _sssp_msg, weighted=True)
BFS = VertexProgram("bfs", MIN, _bfs_msg, weighted=False)
CC = VertexProgram("cc", MIN, _cc_msg, weighted=False)
WCC = VertexProgram("wcc", MIN, _cc_msg, weighted=False, symmetrize=True)
PAGERANK = VertexProgram("pagerank", SUM, _pr_msg, use_delta=True, weighted=False)
PHP = VertexProgram("php", SUM, _php_msg, use_delta=True, weighted=True)
PPR = VertexProgram("ppr", SUM, _pr_msg, use_delta=True, weighted=False,
                    personalized=True)
KCORE = VertexProgram("kcore", SUM, _kcore_msg, weighted=False,
                      symmetrize=True, damping=1.0, peel_k=2.0)

ALGORITHMS = {p.name: p for p in (SSSP, BFS, CC, WCC, PAGERANK, PHP, PPR,
                                  KCORE)}


# --------------------------------------------------------------------------
# Numpy references (oracles for tests / benchmarks)
# --------------------------------------------------------------------------

def reference_sssp(g: CSRGraph, source: int) -> np.ndarray:
    """Bellman-Ford over CSR (handles arbitrary positive weights)."""
    dist = np.full(g.n_nodes, np.inf, dtype=np.float64)
    dist[source] = 0.0
    src = g.edge_sources()
    w = g.weights if g.weights is not None else np.ones(g.n_edges, dtype=np.float64)
    for _ in range(g.n_nodes):
        cand = dist[src] + w
        new = dist.copy()
        np.minimum.at(new, g.indices, cand)
        if np.allclose(new, dist, equal_nan=True):
            break
        dist = new
    return dist


def reference_bfs(g: CSRGraph, source: int) -> np.ndarray:
    level = np.full(g.n_nodes, np.inf)
    level[source] = 0
    frontier = np.array([source])
    depth = 0
    while len(frontier):
        depth += 1
        nxt = []
        for u in frontier:
            nbrs = g.indices[g.indptr[u]:g.indptr[u + 1]]
            fresh = nbrs[level[nbrs] == np.inf]
            level[fresh] = depth
            nxt.append(np.unique(fresh))
        frontier = np.concatenate(nxt) if nxt else np.array([], dtype=np.int64)
        frontier = np.unique(frontier)
    return level


def reference_cc(g: CSRGraph) -> np.ndarray:
    """Min-label propagation on the symmetrized graph (matches the device
    program's semantics: component id = min vertex id in component)."""
    sym = g.symmetrize()
    label = np.arange(sym.n_nodes, dtype=np.int64)
    src = sym.edge_sources()
    changed = True
    while changed:
        cand = label[src]
        new = label.copy()
        np.minimum.at(new, sym.indices, cand)
        new = np.minimum(new, label)
        changed = not np.array_equal(new, label)
        label = new
    return label


def reference_wcc(g: CSRGraph) -> np.ndarray:
    """Weakly connected components by union-find over the directed edge
    list (direction ignored), roots relabeled to the min vertex id of
    each component so the labels match the device program's min-label
    fixpoint exactly."""
    n = g.n_nodes
    parent = np.arange(n, dtype=np.int64)

    def find(x: int) -> int:
        root = x
        while parent[root] != root:
            root = parent[root]
        while parent[x] != root:   # path compression
            parent[x], x = root, parent[x]
        return root

    for u, v in zip(g.edge_sources(), g.indices):
        ru, rv = find(int(u)), find(int(v))
        if ru != rv:
            parent[max(ru, rv)] = min(ru, rv)

    roots = np.array([find(i) for i in range(n)], dtype=np.int64)
    # min vertex id per component (roots are already component minima
    # given the min-directed unions above, but don't rely on it)
    comp_min = np.full(n, n, dtype=np.int64)
    np.minimum.at(comp_min, roots, np.arange(n, dtype=np.int64))
    return comp_min[roots]


def reference_kcore(g: CSRGraph, k: float = 2.0):
    """Synchronous k-core peeling on the symmetrized graph, mirroring the
    device program round for round: every round the newly-removed set
    pushes one unit along its out-edges, every destination's remaining
    degree drops by its count of newly-removed in-neighbors (removed
    destinations included — the device subtracts unconditionally), and
    alive vertices falling below ``k`` join the next round's removal.
    Returns ``(removed, remaining_degree)``."""
    sym = g.symmetrize()
    n = sym.n_nodes
    deg = sym.out_degrees.astype(np.float64)
    src = sym.edge_sources()
    dst = sym.indices
    removed = deg < k
    newly = removed.copy()
    while newly.any():
        counts = np.zeros(n)
        m = newly[src]
        np.add.at(counts, dst[m], 1.0)
        deg = deg - counts
        nxt = (~removed) & (deg < k)
        removed |= nxt
        newly = nxt
    return removed, deg


def reference_ppr(
    g: CSRGraph, source: int, damping: float = 0.85, iters: int = 500
) -> np.ndarray:
    """Personalized PageRank matching Δ-PPR push semantics:
    r = (1-d)·e_s + d·AᵀD⁻¹r, dangling mass dropped (same as the
    push-based program, which pushes along out-edges only)."""
    n = g.n_nodes
    deg = np.maximum(g.out_degrees.astype(np.float64), 1)
    src = g.edge_sources()
    teleport = np.zeros(n)
    teleport[source] = 1.0 - damping
    r = teleport.copy()
    for _ in range(iters):
        contrib = damping * r[src] / deg[src]
        nxt = teleport.copy()
        np.add.at(nxt, g.indices, contrib)
        if np.max(np.abs(nxt - r)) < 1e-12:
            r = nxt
            break
        r = nxt
    return r


def reference_pagerank(g: CSRGraph, damping: float = 0.85, iters: int = 200) -> np.ndarray:
    """Unnormalized PR matching Δ-PR semantics: r = (1-d)·1 + d·AᵀD⁻¹r,
    dangling mass dropped (same as push-based Δ-PR over out-edges)."""
    n = g.n_nodes
    deg = np.maximum(g.out_degrees.astype(np.float64), 1)
    src = g.edge_sources()
    r = np.full(n, 1.0 - damping)
    for _ in range(iters):
        contrib = damping * r[src] / deg[src]
        nxt = np.full(n, 1.0 - damping)
        np.add.at(nxt, g.indices, contrib)
        if np.max(np.abs(nxt - r)) < 1e-10:
            r = nxt
            break
        r = nxt
    return r
