"""Fanout neighbour sampling (GraphSAGE [arXiv:1706.02216] minibatch path;
port of ``repro.graph.sampler``).

Given a CSR graph, seed nodes and a fanout list (e.g. 15-10), draw a fixed
number of neighbours per layer with replacement (the GraphSAGE estimator).
Static output shapes: hop k holds ``len(seeds) * prod(fanouts[:k])`` ids,
row-major by parent.

  * ``sample_neighbors`` — host-side numpy, the reference's
    ``default_rng`` calls in the same order, so its ids equal the
    reference's bit for bit at the same seed.
  * ``sample_neighbors_device`` — tensors on the card, uniforms from an
    explicit ``torch.Generator``.  ``sample_hop`` turns one hop's uniforms
    into ids exactly as the reference's device sampler does (float32
    ``floor(u * max(d, 1))``), so the reference's own uniforms give its ids.

Zero-degree vertices sample themselves (self-loop fallback), so downstream
aggregation never sees invalid ids.
"""

from __future__ import annotations

from typing import Sequence

import numpy as np
import torch

from repro_torch.graph.csr import CSRGraph
from repro_torch.kernels.runtime import resolve_device


def sample_neighbors(
    g: CSRGraph,
    seeds: np.ndarray,
    fanouts: Sequence[int],
    seed: int = 0,
) -> list[np.ndarray]:
    """Layered sampling. Returns ``[seeds, hop1, hop2, ...]`` where
    ``hop_k`` has shape ``seeds.shape + (fanouts[0], ..., fanouts[k-1])``
    flattened to ``(n_prev * fanout_k,)`` row-major."""
    rng = np.random.default_rng(seed)
    deg = g.out_degrees
    layers = [np.asarray(seeds, dtype=np.int64)]
    frontier = layers[0]
    for f in fanouts:
        d = deg[frontier]
        offs = rng.integers(0, np.maximum(d, 1)[:, None], size=(len(frontier), f))
        base = g.indptr[frontier][:, None]
        eids = base + offs
        nbrs = g.indices[np.minimum(eids, g.n_edges - 1)].astype(np.int64)
        # self-loop fallback for isolated vertices
        nbrs = np.where(d[:, None] == 0, frontier[:, None], nbrs)
        frontier = nbrs.reshape(-1)
        layers.append(frontier)
    return layers


def sample_hop(u: torch.Tensor, frontier: torch.Tensor, indptr: torch.Tensor,
               indices: torch.Tensor) -> torch.Tensor:
    """One hop: uniforms ``u`` (len(frontier), f) in [0, 1) -> neighbour ids
    (len(frontier), f) int32.  The offset is ``floor(u * max(d, 1))`` in
    float32, the edge id ``min(indptr[v] + offset, m - 1)``; a vertex of
    degree 0 samples itself."""
    d = indptr[frontier + 1] - indptr[frontier]
    offs = torch.floor(u * d.clamp_min(1).to(torch.float32)[:, None]).to(torch.int64)
    eids = (indptr[frontier].to(torch.int64)[:, None] + offs).clamp_max(indices.shape[0] - 1)
    nbrs = indices[eids].to(torch.int32)
    return torch.where(d[:, None] == 0, frontier[:, None].to(torch.int32), nbrs)


def sample_neighbors_device(
    generator: torch.Generator,
    indptr: torch.Tensor,      # (n+1,) int32 or int64
    indices: torch.Tensor,     # (m,) int32
    seeds: torch.Tensor,       # (b,) int
    fanouts: Sequence[int],
    device: str | torch.device | None = None,
) -> list[torch.Tensor]:
    """Device-side equivalent (uniform with replacement, static shapes):
    ``[seeds, hop1, ...]`` as int32 tensors on ``device`` (``None``: the
    card), one float32 uniform draw of ``generator`` (which must live on
    ``device``) a hop."""
    dev = resolve_device(device)
    if generator.device.type != dev.type:
        raise ValueError(f"sample_neighbors_device: generator on {generator.device}, "
                         f"sampling on {dev}")
    indptr, indices = indptr.to(dev), indices.to(dev)
    frontier = seeds.to(device=dev, dtype=torch.int32)
    layers = [frontier]
    for f in fanouts:
        u = torch.rand((frontier.shape[0], f), generator=generator, device=dev,
                       dtype=torch.float32)
        frontier = sample_hop(u, frontier, indptr, indices).reshape(-1)
        layers.append(frontier)
    return layers
