"""Asynchronous task scheduling — paper §VI.

1. **Contribution-driven priority** (§VI-A).  The sweep is asynchronous
   (later partitions read values already improved by earlier ones), so the
   order matters:
     * ``hub``   — after hub sorting hubs live in the lowest partition ids,
       so "hubs first" is ascending id;
     * ``delta`` — partitions with the largest pending |Δ| mass first.
   FILTER tasks go first, then ZC / COMPACT tasks (§VI-B).
2. **Recompute-once** (§VI-A): loaded (FILTER/COMPACT) priority partitions
   are processed once more per iteration at no transfer cost.

Both sorts are stable, as in the reference.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from repro_torch.core.cost_model import COMPACT, FILTER


class Schedule(NamedTuple):
    order: torch.Tensor        # (P,) int32 permutation: processing order
    second_pass: torch.Tensor  # (P,) bool — partitions re-processed once


def _rank(keys: torch.Tensor) -> torch.Tensor:
    """Rank of each element under a stable ascending sort."""
    order = torch.argsort(keys, stable=True)
    ranks = torch.empty_like(order)
    ranks[order] = torch.arange(order.shape[0], device=keys.device)
    return ranks


def make_schedule(
    engines: torch.Tensor,     # (P,)
    delta_mass: torch.Tensor,  # (P,) pending |delta| per partition
    n_hub_partitions: int,
    mode: str,                 # 'hub' | 'delta' | 'none'
    recompute_once: bool,
    second_pass_fraction: float = 0.125,
    pid_offset: int = 0,
    priority_mask: torch.Tensor | None = None,
) -> Schedule:
    """``pid_offset`` shifts local partition indices to global ids, so a
    rank scheduling its shard of the partitions (``dist.graph_shard``)
    ranks hubs as the single-device schedule does.  The Δ-mode priority
    mask is a global top-fraction rank that a rank cannot derive from its
    local |Δ| slice: the sharded sweep computes it on the replicated state
    and passes it as ``priority_mask``, which then overrides the local
    one."""
    P = engines.shape[0]
    dev = engines.device
    pid = pid_offset + torch.arange(P, dtype=torch.int32, device=dev)
    if mode == "delta":
        score = delta_mass
        if priority_mask is None:
            priority_mask = _rank(-delta_mass) < max(1, int(P * second_pass_fraction))
    elif mode == "hub":
        score = -pid.to(torch.float32)  # low id == hub partitions first
        if priority_mask is None:
            priority_mask = pid < n_hub_partitions
    else:
        score = torch.zeros(P, dtype=torch.float32, device=dev)
        if priority_mask is None:
            priority_mask = torch.zeros(P, dtype=torch.bool, device=dev)

    # engine tier: FILTER first (paper §VI-B), then ZC/COMPACT, skips last
    tier = torch.where(engines == FILTER, 0, torch.where(engines >= 0, 1, 2))
    key = tier * (2 * P) + _rank(-score)
    order = torch.argsort(key, stable=True).to(torch.int32)

    loaded = (engines == FILTER) | (engines == COMPACT)
    if recompute_once:
        second = priority_mask & loaded
    else:
        second = torch.zeros(P, dtype=torch.bool, device=dev)
    return Schedule(order=order, second_pass=second)
