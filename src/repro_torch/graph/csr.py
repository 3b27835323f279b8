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

    def permute(self, perm: np.ndarray, device=None) -> "CSRGraph":
        """Relabel vertices: new id of old vertex v is ``perm[v]``.  The
        relabelling and its sort run in torch on ``device`` (the CPU by
        default), as :func:`csr_from_edges` does."""
        dev = torch.device("cpu" if device is None else device)
        p = torch.from_numpy(np.asarray(perm, dtype=np.int64)).to(dev)
        deg = torch.from_numpy(self.out_degrees).to(dev)
        src = torch.repeat_interleave(torch.arange(self.n_nodes, device=dev), deg)
        dst = torch.from_numpy(self.indices).to(dev, torch.int64)
        return csr_from_edges(self.n_nodes, p[src], p[dst], self.weights, device=dev)

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
    src: np.ndarray | torch.Tensor,
    dst: np.ndarray | torch.Tensor,
    weights: np.ndarray | torch.Tensor | None = None,
    dedup: bool = False,
    device: str | torch.device | None = None,
) -> CSRGraph:
    """Build a CSR graph from COO edge lists, O(m log m).

    The edges are put in order by a stable sort of the key
    ``src * n_nodes + dst``, which orders them as ``np.lexsort((dst, src))``
    does (parallel edges keep their input order), in torch on ``device``:
    the CPU by default, a card when the caller has one (a 67M-edge graph
    sorts in well under a second there).  The graph is the same on every
    device.  With ``dedup``, the first of each set of parallel edges is
    kept, as ``np.unique(..., return_index=True)`` keeps it."""
    dev = torch.device("cpu" if device is None else device)
    s, d = _on(src, dev, torch.int64), _on(dst, dev, torch.int64)
    w = None if weights is None else _on(weights, dev, torch.float32)
    key, order = torch.sort(s * n_nodes + d, stable=True)
    if dedup:
        # a stable sort puts the first occurrence of a key first in its run
        first = torch.ones_like(key, dtype=torch.bool)
        first[1:] = key[1:] != key[:-1]
        order = order[first]
    s, d = s[order], d[order]
    if w is not None:
        w = w[order]
    indptr = torch.zeros(n_nodes + 1, dtype=torch.int64, device=dev)
    indptr[1:] = torch.cumsum(torch.bincount(s, minlength=n_nodes), 0)
    return CSRGraph(indptr=indptr.cpu().numpy(), indices=d.to(torch.int32).cpu().numpy(),
                    weights=None if w is None else w.cpu().numpy())


def _on(a: np.ndarray | torch.Tensor, dev: torch.device, dtype: torch.dtype) -> torch.Tensor:
    """``a`` as a tensor of ``dtype`` on ``dev`` (numpy input cast first, as
    ``np.asarray(a, dtype)`` casts it)."""
    if isinstance(a, torch.Tensor):
        return a.to(dev, dtype)
    np_dtype = np.int64 if dtype == torch.int64 else np.float32
    return torch.from_numpy(np.ascontiguousarray(a, dtype=np_dtype)).to(dev)


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
