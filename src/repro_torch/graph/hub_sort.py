"""Hub sorting (paper §VI-A, following Zhang et al. BigData'17 [42]).

Gathers the top ``hub_fraction`` (paper: 8%) of vertices — ranked by
``H(v) = D_o(v) * D_i(v) / (D_omax * D_imax)`` (Eq. 4) — to the *front* of
the CSR id space, keeping all non-hub vertices in their natural order.

Because hub vertices then occupy the first partitions, hub-vertex-driven
priority scheduling reduces to "schedule low partition ids first", and the
high-in-degree vertices (likely active) are stored together, which sharpens
per-partition cost analysis (paper's stated second benefit).

Done once at preprocessing; every algorithm run reuses it (paper §VI-A).
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np

from repro_torch.graph.csr import CSRGraph


@dataclass(frozen=True)
class HubSortResult:
    graph: CSRGraph
    perm: np.ndarray        # old id -> new id
    inv_perm: np.ndarray    # new id -> old id
    n_hubs: int

    def to_new(self, old_ids: np.ndarray) -> np.ndarray:
        return self.perm[np.asarray(old_ids)]

    def values_to_old(self, new_values: np.ndarray) -> np.ndarray:
        """Reorder a per-vertex result array back to original vertex ids."""
        return np.asarray(new_values)[self.perm]


def hub_scores(g: CSRGraph) -> np.ndarray:
    do = g.out_degrees.astype(np.float64)
    di = g.in_degrees.astype(np.float64)
    do_max = max(do.max(initial=0.0), 1.0)
    di_max = max(di.max(initial=0.0), 1.0)
    return (do * di) / (do_max * di_max)


def hub_sort(g: CSRGraph, hub_fraction: float = 0.08, device=None) -> HubSortResult:
    """Relabel ``g`` with its hubs first; the relabelled graph is sorted in
    torch on ``device`` (the CPU by default, see :meth:`CSRGraph.permute`)."""
    n = g.n_nodes
    n_hubs = int(np.ceil(hub_fraction * n))
    h = hub_scores(g)
    # Top-n_hubs by H(v), sorted by descending score; stable so equal-score
    # vertices keep natural order.
    order = np.argsort(-h, kind="stable")
    hubs = order[:n_hubs]
    hub_mask = np.zeros(n, dtype=bool)
    hub_mask[hubs] = True
    non_hubs = np.nonzero(~hub_mask)[0]  # natural order preserved
    inv_perm = np.concatenate([hubs, non_hubs]).astype(np.int64)
    perm = np.empty(n, dtype=np.int64)
    perm[inv_perm] = np.arange(n)
    return HubSortResult(graph=g.permute(perm, device=device), perm=perm, inv_perm=inv_perm,
                         n_hubs=n_hubs)
