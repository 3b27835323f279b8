"""What every GAP generator shares: the undirected, deduplicated CSR.

GAP (Beamer, Asanovic, Patterson, arXiv:1508.03619) builds its synthetic
graphs from an edge list of ``degree * n`` draws, symmetrizes it, drops
self-loops and duplicate edges, and gives SSSP integer weights drawn
uniformly from [1, 255].  ``undirected_csr`` does that on the device the
draws live on: an undirected edge keeps one weight, which both of its arcs
carry.  Plain PyTorch: nothing of the program under test is imported.
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np
import torch


@dataclass
class Graph:
    """A host CSR: ``indptr[v]:indptr[v + 1]`` are v's arcs."""

    indptr: np.ndarray   # (n + 1,) int64
    indices: np.ndarray  # (arcs,) int32, the destination of each arc
    weights: np.ndarray  # (arcs,) float32, integers in [weight_min, weight_max]

    @property
    def n(self) -> int:
        return len(self.indptr) - 1

    @property
    def arcs(self) -> int:
        return int(self.indptr[-1])

    @property
    def degrees(self) -> np.ndarray:
        return np.diff(self.indptr)


def undirected_csr(n: int, src: torch.Tensor, dst: torch.Tensor, gen: torch.Generator,
                   weight_min: int, weight_max: int) -> Graph:
    """The undirected simple graph of the edge draws ``src``-``dst``, each
    edge weighted by a uniform integer in [weight_min, weight_max] (drawn
    in the order of the sorted edge keys, so the same draws give the same
    weights), as a CSR whose rows are sorted by destination."""
    dev = src.device
    lo, hi = torch.minimum(src, dst).long(), torch.maximum(src, dst).long()
    keep = lo != hi
    key = torch.unique(lo[keep] * n + hi[keep])          # sorted, one per edge
    del lo, hi, keep
    w = torch.randint(weight_min, weight_max + 1, (key.numel(),), generator=gen,
                      device=dev, dtype=torch.int32).to(torch.float32)
    lo, hi = key // n, key % n
    arc_key, order = torch.sort(torch.cat([key, hi * n + lo]))
    del key
    tail = torch.cat([hi, lo])[order].to(torch.int32)
    weights = torch.cat([w, w])[order]
    indptr = torch.zeros(n + 1, dtype=torch.int64, device=dev)
    indptr[1:] = torch.cumsum(torch.bincount(arc_key // n, minlength=n), 0)
    return Graph(indptr=indptr.cpu().numpy(), indices=tail.cpu().numpy(),
                 weights=weights.cpu().numpy())
