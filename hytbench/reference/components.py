"""Connected components, for Graph500's count of traversed edges.

Min-label propagation with pointer jumping over the undirected graph's
arcs: every vertex ends labelled with the least id of its component.
"""

from __future__ import annotations

import torch

from hytbench.reference import Arcs


def component_edges(arcs: Arcs) -> tuple[torch.Tensor, torch.Tensor]:
    """(label of each vertex, undirected edges of each label's component),
    both (n,) int64 on the arcs' device."""
    label = torch.arange(arcs.n, device=arcs.src.device)
    while True:
        new = label.scatter_reduce(0, arcs.dst, label[arcs.src], "amin")
        new = new[new]
        if torch.equal(new, label):
            break
        label = new
    edges = torch.bincount(label[arcs.src], minlength=arcs.n) // 2
    return label, edges
