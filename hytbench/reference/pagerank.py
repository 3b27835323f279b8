"""PageRank by power iteration, with the semantics of push-based
Delta-PageRank: ``r = (1 - d) + d * A^T D^-1 r`` over out-arcs, the mass of
a vertex with no arc dropped, unnormalized (GAP divides by n, which scales
every rank alike).

In float64 the iteration runs until no rank moves by more than ``eps``;
the ranks then lie within ``eps * d / (1 - d)`` of the fixpoint.
``dtype=torch.bfloat16`` is the control: every rank, contribution and sum
held in bfloat16, the nearest precision below the float32 the program
states, for at most ``max_iters`` rounds.
"""

from __future__ import annotations

import torch

from hytbench.reference import Arcs


def pagerank(arcs: Arcs, damping: float, dtype: torch.dtype = torch.float64,
             eps: float = 1e-10, max_iters: int = 300) -> torch.Tensor:
    dev = arcs.src.device
    inv_deg = (1.0 / arcs.degree.clamp(min=1).to(torch.float64)).to(dtype)
    base = torch.full((arcs.n,), 1.0 - damping, dtype=dtype, device=dev)
    r = base.clone()
    for _ in range(max_iters):
        share = (damping * r * inv_deg).to(dtype)
        nxt = base.clone().index_add_(0, arcs.dst, share[arcs.src])
        moved = float((nxt.to(torch.float64) - r.to(torch.float64)).abs().max())
        r = nxt
        if moved <= eps:
            break
    return r.to(torch.float64)
