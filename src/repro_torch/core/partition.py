"""Chunk-based edge-balanced graph partitioning (paper §IV).

Each partition is a run of consecutively numbered vertices whose edge
segments are contiguous in the CSR edge arrays and hold about equal edge
counts.  Partitions stay small for fine-grained cost analysis; the task
combiner merges them at schedule time (paper §V-B).

``DevicePartitions`` records one ``block_size`` (the largest partition's
edge count, rounded up: the reference's fixed block shape) and keeps the
partition bounds as host integers: the sweep dispatches one partition at a
time from the host, each as a slice of its own edges.
"""

from __future__ import annotations

from dataclasses import dataclass, field

import numpy as np
import torch

from repro_torch.graph.csr import CSRGraph
from repro_torch.kernels.runtime import resolve_device


@dataclass(frozen=True)
class PartitionTable:
    """Host-side partition boundaries."""

    vertex_start: np.ndarray  # (P+1,) int64
    edge_start: np.ndarray    # (P+1,) int64

    @property
    def n_partitions(self) -> int:
        return len(self.vertex_start) - 1

    @property
    def edges_per_partition(self) -> np.ndarray:
        return np.diff(self.edge_start)

    @property
    def vertices_per_partition(self) -> np.ndarray:
        return np.diff(self.vertex_start)


def partition_graph(
    g: CSRGraph,
    n_partitions: int | None = None,
    partition_bytes: int = 32 * 2**20,
    d1: float = 4.0,
) -> PartitionTable:
    """Edge-balanced chunk partitioning with vertex-aligned boundaries.

    If ``n_partitions`` is None it is derived from the paper's 32 MB
    partition size (``partition_bytes / d1`` edges per partition).
    """
    m = max(g.n_edges, 1)
    if n_partitions is None:
        epp = max(int(partition_bytes / d1), 1)
        n_partitions = max(1, -(-m // epp))
    n_partitions = min(n_partitions, g.n_nodes)
    targets = np.linspace(0, m, n_partitions + 1)
    vertex_start = np.searchsorted(g.indptr, targets, side="left").astype(np.int64)
    vertex_start[0], vertex_start[-1] = 0, g.n_nodes
    vertex_start = np.maximum.accumulate(vertex_start)
    edge_start = g.indptr[vertex_start]
    return PartitionTable(vertex_start=vertex_start, edge_start=edge_start)


@dataclass(frozen=True)
class DevicePartitions:
    vertex_start: torch.Tensor    # (P+1,) int32
    edge_start: torch.Tensor      # (P+1,) int32
    part_edges: torch.Tensor      # (P,) int32 — E_i
    vertex_part_id: torch.Tensor  # (n,) int32
    n_partitions: int
    block_size: int
    # host copies of (vertex_start, edge_start, part_edges) as int lists,
    # read by the per-partition dispatch of the sweep
    host: tuple = field(init=False, repr=False, compare=False)

    def __post_init__(self):
        object.__setattr__(self, "host", (
            self.vertex_start.tolist(), self.edge_start.tolist(),
            self.part_edges.tolist()))


def to_device_partitions(
    table: PartitionTable,
    n_nodes: int,
    edge_capacity: int,
    block_multiple: int = 128,
    device: str | torch.device | None = None,
) -> DevicePartitions:
    device = resolve_device(device)
    epp = table.edges_per_partition
    block = int(epp.max(initial=1))
    block = max(block_multiple, -(-block // block_multiple) * block_multiple)
    block = min(block, edge_capacity)
    part_id = np.repeat(
        np.arange(table.n_partitions, dtype=np.int32),
        table.vertices_per_partition,
    )
    if len(part_id) != n_nodes:
        raise ValueError("partition table does not cover the vertices")

    def up(a):
        return torch.as_tensor(np.asarray(a, dtype=np.int32), device=device)

    return DevicePartitions(
        vertex_start=up(table.vertex_start),
        edge_start=up(table.edge_start),
        part_edges=up(epp),
        vertex_part_id=up(part_id),
        n_partitions=table.n_partitions,
        block_size=block,
    )
