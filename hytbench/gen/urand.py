"""GAP ``urand``: Erdos-Renyi edges, both endpoints uniform over the
``2**scale`` vertices, ``degree * 2**scale`` draws, drawn on ``device``."""

from __future__ import annotations

import torch

from hytbench.gen.common import Graph, undirected_csr


def generate(cfg: dict, gen: torch.Generator, device: torch.device) -> Graph:
    n = 1 << cfg["scale"]
    m = cfg["degree"] * n
    src = torch.randint(0, n, (m,), generator=gen, device=device, dtype=torch.int32)
    dst = torch.randint(0, n, (m,), generator=gen, device=device, dtype=torch.int32)
    return undirected_csr(n, src, dst, gen, cfg["weight_min"], cfg["weight_max"])
