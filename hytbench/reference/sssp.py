"""SSSP by frontier Bellman-Ford.

Each round relaxes the arcs of the vertices whose distance fell in the
round before, until none falls.  With GAP's integer weights every distance
is an integer far below 2**24, so float32 holds it exactly and the result
is the exact shortest distance (``inf`` where unreachable).

``dtype=torch.bfloat16`` is the control: each candidate ``dist[u] + w`` is
rounded to bfloat16, the nearest precision below the float32 the program
states.  Distances above 256 then lose their low bits.
"""

from __future__ import annotations

import torch

from hytbench.reference import Arcs


def sssp(arcs: Arcs, source: int, dtype: torch.dtype = torch.float32) -> torch.Tensor:
    dev = arcs.src.device
    dist = torch.full((arcs.n,), float("inf"), dtype=torch.float32, device=dev)
    dist[source] = 0.0
    frontier = torch.zeros(arcs.n, dtype=torch.bool, device=dev)
    frontier[source] = True
    while bool(frontier.any()):
        live = frontier[arcs.src]
        u, v, w = arcs.src[live], arcs.dst[live], arcs.weight[live]
        cand = (dist[u].to(dtype) + w.to(dtype)).to(torch.float32)
        new = dist.scatter_reduce(0, v, cand, "amin")
        frontier = new < dist
        dist = new
    return dist
