"""Plain PyTorch references of the benchmark's algorithms.

They read the benchmark's own graph (``hytbench.gen``) and nothing that
the program under test computed: no relabelled ids, no runtime, no
partition table.  They import neither the program nor JAX.
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np
import torch


@dataclass
class Arcs:
    """A graph's arcs on a device: source, destination, weight (int64
    indices, as ``scatter_reduce_`` and ``index_add_`` take them)."""

    n: int
    src: torch.Tensor
    dst: torch.Tensor
    weight: torch.Tensor
    degree: torch.Tensor

    @classmethod
    def of(cls, indptr: np.ndarray, indices: np.ndarray, weights: np.ndarray,
           device: torch.device) -> "Arcs":
        n = len(indptr) - 1
        degree = torch.from_numpy(np.diff(indptr)).to(device)
        src = torch.repeat_interleave(torch.arange(n, device=device), degree)
        return cls(n=n, src=src, dst=torch.from_numpy(indices).to(device).long(),
                   weight=torch.from_numpy(weights).to(device), degree=degree)
