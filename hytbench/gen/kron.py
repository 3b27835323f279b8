"""GAP ``kron``: Graph500's Kronecker generator (A=0.57, B=C=0.19).

Each of the ``degree * 2**scale`` edges picks one quadrant of the adjacency
matrix per bit level: (0,0) with probability A, (0,1) with B, (1,0) with C
and (1,1) with the rest; the quadrant's row bit extends the source id and
its column bit the destination id.  Graph500 and GAP then relabel the
vertices by a random permutation, so that a vertex id says nothing of its
degree.  Everything is drawn on ``device`` from ``gen``.
"""

from __future__ import annotations

import torch

from hytbench.gen.common import Graph, undirected_csr


def generate(cfg: dict, gen: torch.Generator, device: torch.device) -> Graph:
    scale, degree = cfg["scale"], cfg["degree"]
    a, b, c = cfg["a"], cfg["b"], cfg["c"]
    n = 1 << scale
    m = degree * n
    src = torch.zeros(m, dtype=torch.int32, device=device)
    dst = torch.zeros(m, dtype=torch.int32, device=device)
    for _ in range(scale):
        u = torch.rand(m, generator=gen, device=device)
        row = u >= a + b                                  # quadrant (1,0) or (1,1)
        col = ((u >= a) & (u < a + b)) | (u >= a + b + c)  # quadrant (0,1) or (1,1)
        src = (src << 1) | row
        dst = (dst << 1) | col
    perm = torch.randperm(n, generator=gen, device=device).to(torch.int32)
    src, dst = perm[src.long()], perm[dst.long()]
    return undirected_csr(n, src, dst, gen, cfg["weight_min"], cfg["weight_max"])
