"""CSR graph containers.

``CSRGraph`` is the host-side (numpy) container used by preprocessing:
generation, hub sorting, partitioning and the reference algorithms.

``DeviceCSR`` is the device-side dataclass of tensors consumed by the HyTM
loop.  Besides the CSR triplet it carries the *expanded source array*
(``edge_src``, the COO row index of every edge), so relaxing a block of
edges is a flat gather ``msg = f(val[src], w)``.
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np
import torch

from repro_torch.kernels.runtime import resolve_device


@dataclass
class CSRGraph:
    """Host-side CSR graph. ``indptr[v]:indptr[v+1]`` are v's out-edges."""

    indptr: np.ndarray  # (n+1,) int64
    indices: np.ndarray  # (m,)  int32 — destination of each out-edge
    weights: np.ndarray | None = None  # (m,) float32

    def __post_init__(self):
        self.indptr = np.asarray(self.indptr, dtype=np.int64)
        self.indices = np.asarray(self.indices, dtype=np.int32)
        if self.weights is not None:
            self.weights = np.asarray(self.weights, dtype=np.float32)

    @property
    def n_nodes(self) -> int:
        return len(self.indptr) - 1

    @property
    def n_edges(self) -> int:
        return int(self.indptr[-1])

    @property
    def out_degrees(self) -> np.ndarray:
        return np.diff(self.indptr).astype(np.int64)

    @property
    def in_degrees(self) -> np.ndarray:
        return np.bincount(self.indices, minlength=self.n_nodes).astype(np.int64)

    def edge_sources(self) -> np.ndarray:
        """COO row index for every edge ('expanded' indptr)."""
        return np.repeat(np.arange(self.n_nodes, dtype=np.int32), self.out_degrees)

    def transpose(self) -> "CSRGraph":
        """Reverse every edge."""
        src = self.edge_sources()
        return csr_from_edges(
            self.n_nodes, self.indices.astype(np.int64), src.astype(np.int64),
            self.weights,
        )

    def symmetrize(self) -> "CSRGraph":
        """Union of the graph and its transpose (CC/WCC/k-core run on this)."""
        src = self.edge_sources().astype(np.int64)
        dst = self.indices.astype(np.int64)
        s = np.concatenate([src, dst])
        d = np.concatenate([dst, src])
        w = None
        if self.weights is not None:
            w = np.concatenate([self.weights, self.weights])
        return csr_from_edges(self.n_nodes, s, d, w, dedup=True)

    def permute(self, perm: np.ndarray) -> "CSRGraph":
        """Relabel vertices: new id of old vertex v is ``perm[v]``."""
        src = perm[self.edge_sources().astype(np.int64)]
        dst = perm[self.indices.astype(np.int64)]
        return csr_from_edges(self.n_nodes, src, dst, self.weights)

    def validate(self) -> None:
        if self.indptr[0] != 0 or self.indptr[-1] != len(self.indices):
            raise ValueError("indptr must start at 0 and end at len(indices)")
        if np.any(np.diff(self.indptr) < 0):
            raise ValueError("indptr must be monotone")
        if len(self.indices) and (
                self.indices.min() < 0 or self.indices.max() >= self.n_nodes):
            raise ValueError("edge destination out of range")
        if self.weights is not None and len(self.weights) != len(self.indices):
            raise ValueError("weights and indices differ in length")


def csr_from_edges(
    n_nodes: int,
    src: np.ndarray,
    dst: np.ndarray,
    weights: np.ndarray | None = None,
    dedup: bool = False,
) -> CSRGraph:
    """Build a CSR graph from COO edge lists (host-side, O(m log m))."""
    src = np.asarray(src, dtype=np.int64)
    dst = np.asarray(dst, dtype=np.int64)
    if dedup:
        key = src * n_nodes + dst
        _, uniq_idx = np.unique(key, return_index=True)
        src, dst = src[uniq_idx], dst[uniq_idx]
        if weights is not None:
            weights = np.asarray(weights)[uniq_idx]
    order = np.lexsort((dst, src))
    src, dst = src[order], dst[order]
    if weights is not None:
        weights = np.asarray(weights, dtype=np.float32)[order]
    counts = np.bincount(src, minlength=n_nodes)
    indptr = np.zeros(n_nodes + 1, dtype=np.int64)
    np.cumsum(counts, out=indptr[1:])
    return CSRGraph(indptr=indptr, indices=dst.astype(np.int32), weights=weights)


@dataclass(frozen=True)
class DeviceCSR:
    """Device-resident CSR + expanded COO rows, padded to ``capacity``.

    Padding edges are self-loops on vertex 0 with weight +inf, so they never
    relax anything; ``edge_valid`` masks them explicitly.
    """

    edge_src: torch.Tensor     # (capacity,) int32
    edge_dst: torch.Tensor     # (capacity,) int32
    edge_weight: torch.Tensor  # (capacity,) float32
    edge_valid: torch.Tensor   # (capacity,) bool
    out_degree: torch.Tensor   # (n,) int32
    seg_start: torch.Tensor    # (n,) int32 — indptr[:-1]
    n_nodes: int
    n_edges: int

    @property
    def capacity(self) -> int:
        return self.edge_src.shape[0]

    @property
    def device(self) -> torch.device:
        return self.edge_src.device


def to_device_csr(
    g: CSRGraph,
    capacity: int | None = None,
    pad_multiple: int = 1024,
    device: str | torch.device | None = None,
) -> DeviceCSR:
    """Upload a host CSR to a padded device structure (``cuda`` unless
    ``device`` says otherwise)."""
    dev = resolve_device(device)
    m = g.n_edges
    if capacity is None:
        capacity = max(pad_multiple, -(-m // pad_multiple) * pad_multiple)
    if capacity < m:
        raise ValueError(f"capacity {capacity} < n_edges {m}")
    src = np.zeros(capacity, dtype=np.int32)
    dst = np.zeros(capacity, dtype=np.int32)
    w = np.full(capacity, np.float32(np.inf), dtype=np.float32)
    valid = np.zeros(capacity, dtype=bool)
    src[:m] = g.edge_sources()
    dst[:m] = g.indices
    w[:m] = g.weights if g.weights is not None else 1.0
    valid[:m] = True

    def up(a):
        return torch.from_numpy(a).to(dev)

    return DeviceCSR(
        edge_src=up(src),
        edge_dst=up(dst),
        edge_weight=up(w),
        edge_valid=up(valid),
        out_degree=up(g.out_degrees.astype(np.int32)),
        seg_start=up(g.indptr[:-1].astype(np.int32)),
        n_nodes=g.n_nodes,
        n_edges=m,
    )
