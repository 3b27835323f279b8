"""Cost-aware task generation — paper Algorithm 1 + §V-B task combination.

* consecutive FILTER partitions merge into tasks of at most ``k`` (k=4),
* all COMPACT partitions merge into ONE task,
* all ZEROCOPY partitions merge into ONE kernel.

The merged task count drives the modeled per-task scheduling overhead.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from repro_torch.core.constants import LinkModel
from repro_torch.core.cost_model import (
    COMPACT,
    FILTER,
    ZEROCOPY,
    EngineCosts,
    PartitionStats,
    engine_costs,
    modeled_time_seconds,
    modeled_transfer_bytes,
    select_engines,
)


class TaskPlan(NamedTuple):
    engines: torch.Tensor         # (P,) int32 engine ids (NONE = skip)
    n_tasks: torch.Tensor         # 0-dim int32 — combined task count
    transfer_bytes: torch.Tensor  # (P,) modeled bytes under chosen engine
    transfer_time: torch.Tensor   # (P,) modeled seconds under chosen engine
    costs: EngineCosts


def _merged_filter_tasks(is_filter: torch.Tensor, k: int) -> torch.Tensor:
    """Number of tasks after merging runs of consecutive FILTER partitions
    into chunks of at most k (Algorithm 1 lines 15-24).  A task starts at
    every FILTER partition whose position in its run is a multiple of k;
    the position is the distance to the last non-FILTER partition before
    it, found with a running max — exact integers, no scan."""
    idx = torch.arange(is_filter.shape[0], device=is_filter.device)
    last_break = torch.cummax(torch.where(is_filter, -1, idx), dim=0).values
    run_pos = idx - last_break - 1
    return (is_filter & (run_pos % k == 0)).sum(dtype=torch.int32)


def _n_tasks(engines: torch.Tensor, enable_combination: bool, k: int) -> torch.Tensor:
    if not enable_combination:
        return (engines >= 0).sum(dtype=torch.int32)
    return (_merged_filter_tasks(engines == FILTER, k)
            + (engines == COMPACT).any().to(torch.int32)
            + (engines == ZEROCOPY).any().to(torch.int32))


def generate_tasks(
    stats: PartitionStats,
    link: LinkModel,
    combine_k: int = 4,
    enable_combination: bool = True,
    correction=None,
) -> TaskPlan:
    """``correction``: optional (3,) per-engine cost scaling — biases
    selection only; the accounting stays in model units."""
    costs = engine_costs(stats, link)
    engines = select_engines(stats, costs, link, correction)
    return TaskPlan(
        engines=engines,
        n_tasks=_n_tasks(engines, enable_combination, combine_k),
        transfer_bytes=modeled_transfer_bytes(stats, engines, link),
        transfer_time=modeled_time_seconds(costs, engines),
        costs=costs,
    )


def forced_engine_plan(
    stats: PartitionStats,
    link: LinkModel,
    engine: int,
    enable_combination: bool = True,
    combine_k: int = 4,
) -> TaskPlan:
    """Single-engine baseline plan (the paper's ExpTM-F / ExpTM-C /
    ImpTM-ZC systems, Table V)."""
    costs = engine_costs(stats, link)
    engines = torch.where(stats.active_edges > 0, engine, -1).to(torch.int32)
    return TaskPlan(
        engines=engines,
        n_tasks=_n_tasks(engines, enable_combination, combine_k),
        transfer_bytes=modeled_transfer_bytes(stats, engines, link),
        transfer_time=modeled_time_seconds(costs, engines),
        costs=costs,
    )
