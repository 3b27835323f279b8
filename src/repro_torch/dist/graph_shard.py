"""Multi-GPU HyTM: the partition sweep over a 1-D ``torch.distributed``
group (the reference's ``repro/dist/graph_shard.py``), in both vertex
layouts.

Each rank owns a contiguous run of ``P_local = P_pad / D`` partitions: their
edges, one contiguous range of the CSR edge arrays, live on the rank's
device with rank-local offsets.  Every rank holds the per-vertex vectors
(``out_degree``, ``zc_req``, ``inv_deg``) and the whole partition table,
padded to ``P_pad = ceil(P/D)·D`` with empty partitions (:func:`_pad_table`).
The (values, Δ, frontier) state is laid out by
``HyTMConfig.vertex_sharding``:

* ``"replicated"``: every rank holds the whole ``(n,)`` triple;
* ``"owner"`` (the owner/halo layout): ``n`` pads to ``n_pad = n_loc·D``
  with ``n_loc = ceil(n/D)``, rank ``d`` owns the vertex slice
  ``[d·n_loc, (d+1)·n_loc)`` and holds only that slice of the triple.  The
  per-vertex vectors stay replicated, padded to ``n_pad`` with inert fills.
  The owned slice is not the rank's partitions' vertex range (partitions
  are balanced by edges, ownership by vertex count), so a rank's edges
  name vertices it does not own: its halo (:class:`HaloPlan`).

One iteration on each rank, step for step the reference's
(``graph_shard.py:439-662``):

  1. the global stats, Δ mass, task plan and the global schedule's
     second-pass mask (``core.hytm._plan``), from the whole frontier and Δ:
     under the owner layout the owned slices are all-gathered first, so
     the plan is bit-identical to the replicated layout's;
  2. the rank's engines: its slice of the global plan (selection is per
     partition, so this equals Algorithm 1 on the local stats);
  3. the local schedules of both passes, hub ids made global with
     ``pid_offset = rank·P_local`` and the global mask passed in;
  4. ONE device-to-host copy: the local engines, both local orders, the
     second-pass flags and the previous iteration's ``next_active``;
  5. pass 1: each local partition relaxed by its engine against the
     iteration-start operand (under the owner layout all-gathered into the
     ``(n_pad,)`` view the edges read: the halo fill), the results combined
     locally, then one collective merge (MIN on the aggregate and SUM on
     the touched counts for MIN programs, SUM on both for SUM programs):
     an ``all_reduce`` under the replicated layout, a ``reduce_scatter`` to
     the owned slices under the owner layout; then :func:`_apply_merged`;
  6. pass 2 over the masked engines, gathered and merged the same way;
  7. the next frontier and the info row (``core.hytm._finish``), with
     ``merged_entries``: the destinations touched in either pass.  Under
     the owner layout ``next_active`` and ``merged_entries`` are owned-slice
     sums, made global by one ``all_reduce`` of the two packed together.

The sweep is bulk-synchronous: every rank relaxes against the
iteration-start state and the updates merge once a pass, so a sharded run
reproduces the single-device ``async_sweep=False`` run, bit for bit for MIN
programs and k-core, up to float summation order for SUM programs.

What every rank decides on the host comes from values a collective handed
every rank alike: the plan copy, the chunk's early exit and the loop's end.
With ``autotune`` each rank's wall clock differs, so rank 0's calibrator
alone observes and its correction is broadcast once a chunk (or
iteration).  A ``FaultPlan`` is seeded per site, so it fires alike on ranks
that make the same calls.

The cross-device merge is charged in the model by :func:`ici_level_cost`
(the second transfer-management level) from the drained ``merged_entries``
rows, and under the owner layout by :func:`halo_level_cost`, whose
compacted candidate is capped at the halo; the executed collectives stay
the dense ones.  The collectives are the list forms ``all_gather`` and
``reduce_scatter``, which gloo and NCCL both take in torch 2.11 and 2.13
(``torch.bool`` included).

Sharded serving runs :func:`make_sharded_batched_chunk`: the same
iteration over a ``(Q, ·)`` lane state, every lane planned on its own
whole row and relaxed through the lane entries of the three graph kernels
(``core.engines.relax_lanes``), one batched collective a pass merging
every lane.  A ``stream.DeltaCSR`` serves a sharded view of its blocked
edge log (``DeltaCSR.sharded_runtime_for``): the same
:class:`ShardedRuntime`, its edge columns slices of the container's
device columns, its halo plan from :func:`blocked_halo_plan`.
"""

from __future__ import annotations

import dataclasses
import functools
import time
from dataclasses import dataclass
from typing import NamedTuple

import numpy as np
import torch
import torch.distributed as dist

from repro_torch.core.cost_model import (
    COMPACT,
    FILTER,
    HISTORY_KEYS,
    KEY_ACTIVE_VERTICES,
    KEY_ICI_BYTES,
    KEY_ICI_ENGINE,
    KEY_ICI_TIME,
    KEY_MERGED_ENTRIES,
    KEY_MISPREDICTIONS,
    KEY_PER_ENGINE_TIME,
    KEY_TRANSFER_BYTES,
    KEY_TRANSFER_TIME,
    NONE,
    history_shapes,
    init_history_buffers,
    link_constants,
    selection_diagnostics,
    zc_request_counts,
)
from repro_torch.core.engines import EdgeBlock, relax_lanes, relax_with_engine
from repro_torch.core.hytm import (
    HyTMConfig,
    HyTMResult,
    HyTMState,
    _lane_group,
    _lane_plans,
    _lane_steps,
    _LaneUpload,
    _Planned,
    _consume_warm,
    _finish,
    _plan,
    _scalar,
    chunked_while,
)
from repro_torch.core.partition import (
    DevicePartitions,
    PartitionTable,
    partition_graph,
    to_device_partitions,
)
from repro_torch.core.scheduler import make_schedule
from repro_torch.graph.algorithms import MIN, SUM, VertexProgram
from repro_torch.graph.csr import CSRGraph
from repro_torch.kernels.runtime import resolve_use_kernels
from repro_torch.launch.mesh import GraphMesh, make_graph_mesh


@dataclass(frozen=True)
class HaloPlan:
    """The owner layout of one sharded runtime, on the host: rank ``d``
    owns the vertex slice ``[d·n_loc, (d+1)·n_loc)`` of the ``n_pad =
    n_loc·D`` padded ids, and its halo is the set of vertices outside that
    slice which its edges name as source or destination (the boundary
    entries a compacted owner-layout exchange would ship)."""

    n_pad: int
    n_loc: int
    halo_counts: tuple     # (D,) ints: distinct boundary vertices of each rank
    halo_total: int

    @property
    def max_halo(self) -> int:
        return max(self.halo_counts) if self.halo_counts else 0


def _halo_plan(src: np.ndarray, dst: np.ndarray, segments, n_nodes: int,
               n_devices: int) -> HaloPlan:
    """The halo counts of ranks whose edges are ``src/dst[e0:e1]`` over the
    ``(e0, e1)`` runs of ``segments[d]`` (rank order).  The reference
    counts ``np.unique`` over its ``(P_total, B)`` grid; a boolean mark
    array over ``n`` counts the same set in one pass over the edges.  Every
    rank computes all ``D`` counts, so ``halo_total`` (an input of the ICI
    charge) is equal on every rank.  On one rank every vertex is owned."""
    n_loc = -(-n_nodes // n_devices)
    if n_devices == 1:
        return HaloPlan(n_pad=n_loc, n_loc=n_loc, halo_counts=(0,), halo_total=0)
    mark = np.zeros(n_nodes, bool)
    counts = []
    for d, runs in enumerate(segments):
        mark[:] = False
        for e0, e1 in runs:
            mark[src[e0:e1]] = True
            mark[dst[e0:e1]] = True
        owned = int(np.count_nonzero(mark[d * n_loc:(d + 1) * n_loc]))
        counts.append(int(np.count_nonzero(mark)) - owned)
    return HaloPlan(n_pad=n_loc * n_devices, n_loc=n_loc, halo_counts=tuple(counts),
                    halo_total=int(sum(counts)))


def build_halo_plan(g: CSRGraph, table: PartitionTable, n_nodes: int, n_devices: int,
                    src: np.ndarray | None = None) -> HaloPlan:
    """Every rank's halo count, from the host CSR and the padded table
    (rank ``d`` holds the edges of partitions ``[d·P_local, (d+1)·P_local)``,
    one contiguous range).  ``src`` is ``g.edge_sources()`` when the caller
    has it."""
    P_local = table.n_partitions // n_devices
    src = g.edge_sources() if src is None else src
    segments = [[(int(table.edge_start[d * P_local]), int(table.edge_start[(d + 1) * P_local]))]
                for d in range(n_devices)]
    return _halo_plan(src, g.indices, segments, n_nodes, n_devices)


def blocked_ranges(n_partitions: int, block_size: int, n_devices: int) -> list:
    """Each rank's ``(e0, e1)`` of a blocked edge log (partition ``p``'s
    lanes ``[p·B, (p+1)·B)``) whose ``P`` partitions pad to ``P_pad =
    ceil(P/D)·D``: rank ``d`` holds the real partitions of ``[d·P_local,
    (d+1)·P_local)``, an empty range when all of them are padding."""
    P_local = -(-n_partitions // n_devices)
    out = []
    for d in range(n_devices):
        p0 = d * P_local
        out.append((p0 * block_size, max(p0, min(p0 + P_local, n_partitions)) * block_size))
    return out


def blocked_halo_plan(src: np.ndarray, dst: np.ndarray, counts: np.ndarray, block_size: int,
                      n_nodes: int, n_devices: int) -> HaloPlan:
    """:func:`build_halo_plan` of a blocked edge log (a ``stream.DeltaCSR``'s
    host ``src``/``dst`` lanes, partition ``p``'s live edges the dense prefix
    ``[p·B, p·B + counts[p])`` of its block): the counts of the reference's
    ``build_halo_plan(src_g, dst_g, valid_g, n, D)`` on the log's padded
    ``(P_pad, B)`` grid, whose padding rows hold no valid lane."""
    P_local = -(-len(counts) // n_devices)
    segments = [[(p * block_size, p * block_size + int(counts[p]))
                 for p in range(d * P_local, min((d + 1) * P_local, len(counts)))]
                for d in range(n_devices)]
    return _halo_plan(src, dst, segments, n_nodes, n_devices)


@dataclass
class ShardedRuntime:
    """One rank's device-placed inputs, shared by every sharded iteration.
    Under the owner layout the per-vertex vectors are padded to ``n_pad``
    with inert fills (``out_degree`` 0, ``zc_req`` 0, ``inv_deg`` 1,
    ``parts.vertex_part_id`` ``P_pad − 1``); under the replicated layout
    ``n_pad == n_nodes`` and ``halo`` is None."""

    mesh: GraphMesh
    parts: DevicePartitions    # the padded (P_pad) table, replicated
    edge_src: torch.Tensor     # (E_local,) int32: this rank's edge range
    edge_dst: torch.Tensor     # (E_local,) int32
    edge_weight: torch.Tensor  # (E_local,) float32
    edge_base: int             # global index of the rank's first edge
    out_degree: torch.Tensor   # (n_pad,) int32, replicated
    zc_req: torch.Tensor       # (n_pad,) float32, replicated
    inv_deg: torch.Tensor      # (n_pad,) float32, replicated
    n_nodes: int
    n_partitions: int          # padded: a multiple of the mesh size
    n_hub_partitions: int
    vertex_sharding: str = "replicated"
    n_pad: int = 0
    halo: HaloPlan | None = None

    @property
    def device(self) -> torch.device:
        return self.mesh.device

    @property
    def n_local(self) -> int:
        return self.n_partitions // self.mesh.size

    @property
    def p_offset(self) -> int:
        """Global id of the rank's first partition."""
        return self.mesh.rank * self.n_local

    @property
    def owned(self) -> slice:
        """The rank's owned vertex slice (every vertex under the replicated
        layout)."""
        if self.halo is None:
            return slice(0, self.n_nodes)
        r, n_loc = self.mesh.rank, self.halo.n_loc
        return slice(r * n_loc, (r + 1) * n_loc)


def _pad_table(table: PartitionTable, n_dev: int) -> PartitionTable:
    """Append empty partitions so the partition count divides the mesh."""
    P_real = table.n_partitions
    P_pad = -(-P_real // n_dev) * n_dev
    if P_pad == P_real:
        return table
    extra = P_pad - P_real
    vs = np.concatenate([table.vertex_start, np.full(extra, table.vertex_start[-1])])
    es = np.concatenate([table.edge_start, np.full(extra, table.edge_start[-1])])
    return PartitionTable(vertex_start=vs.astype(np.int64), edge_start=es.astype(np.int64))


def _check_vertex_sharding(sharding: str) -> str:
    if sharding not in ("replicated", "owner"):
        raise ValueError(
            f"vertex_sharding must be 'replicated' or 'owner', got {sharding!r}")
    return sharding


def _pad_vertex_vec(vec: torch.Tensor, n_pad: int, fill) -> torch.Tensor:
    """A per-vertex vector padded from ``(n,)`` to ``(n_pad,)`` with an inert
    fill (pad ids carry no edges and never activate)."""
    extra = n_pad - vec.shape[0]
    if extra <= 0:
        return vec
    return torch.cat([vec, vec.new_full((extra,), fill)])


def build_sharded_runtime(
    g: CSRGraph,
    config: HyTMConfig,
    mesh: GraphMesh,
    n_hubs: int = 0,
    weighted_norm: bool = False,
) -> ShardedRuntime:
    """Partition ``g``, pad the table to a multiple of the mesh size and
    upload this rank's edge range and the replicated vectors to the mesh's
    device (padded to ``n_pad`` under the owner layout)."""
    if config.mesh_axis != mesh.axis:
        raise ValueError(
            f"config.mesh_axis={config.mesh_axis!r} is not the mesh's axis {mesh.axis!r}")
    sharding = _check_vertex_sharding(config.vertex_sharding)
    dev = mesh.device
    table = _pad_table(
        partition_graph(g, n_partitions=config.n_partitions,
                        partition_bytes=config.partition_bytes, d1=config.link.d1),
        mesh.size)
    P_pad = table.n_partitions
    P_local = P_pad // mesh.size
    e0 = int(table.edge_start[mesh.rank * P_local])
    e1 = int(table.edge_start[(mesh.rank + 1) * P_local])
    block = int(table.edges_per_partition.max(initial=1))
    block = max(128, -(-block // 128) * 128)
    parts = to_device_partitions(table, g.n_nodes, -(-(g.n_edges + block) // 128) * 128,
                                 device=dev)

    src_all = g.edge_sources()
    w_all = g.weights if g.weights is not None else np.ones(g.n_edges, np.float32)

    def up(a, dtype):
        return torch.as_tensor(np.ascontiguousarray(a, dtype=dtype), device=dev)

    out_degree = up(g.out_degrees, np.int32)
    zc_req = zc_request_counts(out_degree, up(g.indptr[:-1], np.int32), config.link)
    c = link_constants(config.link, dev)
    if weighted_norm:
        # the reference's sharded runtime sums the weights on the host in
        # float64 (a rank holds only its own edges)
        wsum = np.bincount(src_all, weights=w_all.astype(np.float64), minlength=g.n_nodes)
        inv_deg = up(1.0 / np.maximum(wsum, 1e-30), np.float32)
    else:
        inv_deg = c["one"] / torch.maximum(out_degree.to(torch.float32), c["one"])
    n_hub_parts = int(np.searchsorted(table.vertex_start, n_hubs, side="left"))
    n_hub_parts = max(n_hub_parts, 1) if n_hubs > 0 else 0
    rt = ShardedRuntime(
        mesh=mesh, parts=parts, edge_src=None, edge_dst=None, edge_weight=None, edge_base=e0,
        out_degree=out_degree, zc_req=zc_req, inv_deg=inv_deg,
        n_nodes=g.n_nodes, n_partitions=P_pad, n_hub_partitions=n_hub_parts,
        vertex_sharding=sharding)
    rt.edge_src, rt.edge_dst, rt.edge_weight = shard_edge_range(
        (src_all, g.indices, w_all), e0, e1, dev)
    if sharding == "owner":
        rt.halo = build_halo_plan(g, table, g.n_nodes, mesh.size, src=src_all)
    place_vertex_vectors(rt, out_degree, zc_req, inv_deg, parts.vertex_part_id)
    return rt


def shard_edge_range(columns, e0: int, e1: int, device) -> tuple:
    """One rank's ``[e0, e1)`` range of the ``(src, dst, weight)`` edge
    columns on ``device``, the rank-local edge tensors of a
    :class:`ShardedRuntime`: host arrays are uploaded, device tensors
    sliced (views, which in-place patches of the whole columns reach)."""
    out = []
    for col, dtype in zip(columns, (np.int32, np.int32, np.float32)):
        if torch.is_tensor(col):
            out.append(col[e0:e1])
        else:
            out.append(torch.as_tensor(np.ascontiguousarray(col[e0:e1], dtype=dtype),
                                       device=device))
    return tuple(out)


def place_vertex_vectors(rt: ShardedRuntime, out_degree, zc_req, inv_deg,
                         vertex_part_id) -> None:
    """Set the runtime's replicated per-vertex vectors from their ``(n,)``
    forms: as they are under the replicated layout, padded to the halo
    plan's ``n_pad`` with the inert fills under the owner layout."""
    n_pad = rt.halo.n_pad if rt.halo is not None else rt.n_nodes
    rt.n_pad = n_pad
    rt.out_degree = _pad_vertex_vec(out_degree, n_pad, 0)
    rt.zc_req = _pad_vertex_vec(zc_req, n_pad, 0.0)
    rt.inv_deg = _pad_vertex_vec(inv_deg, n_pad, 1.0)
    if vertex_part_id.shape[0] != n_pad:
        rt.parts = dataclasses.replace(
            rt.parts, vertex_part_id=_pad_vertex_vec(vertex_part_id, n_pad,
                                                     rt.n_partitions - 1))


# --------------------------------------------------------------------------
# The owner layout's collectives
# --------------------------------------------------------------------------

def all_gather_owned(x: torch.Tensor, mesh: GraphMesh) -> torch.Tensor:
    """The ``(..., n_pad)`` view of owner-sharded ``(..., n_loc)`` rows,
    every rank's slice in rank order: one ``all_gather``.  The list form
    splits its buffer along dim 0, so lane rows gather into a contiguous
    ``(D, Q, n_loc)`` buffer that is then permuted (for one vector the
    permute is a view)."""
    buf = x.new_empty((mesh.size, *x.shape))
    dist.all_gather(list(buf.unbind(0)), x.contiguous(), group=mesh.group)
    return buf.movedim(0, -2).reshape(*x.shape[:-1], mesh.size * x.shape[-1])


def _reduce_to_owned(x: torch.Tensor, op, mesh: GraphMesh) -> torch.Tensor:
    """This rank's ``(..., n_loc)`` slice of the group's elementwise ``op``
    over the ``(..., n_pad)`` rows ``x``: one ``reduce_scatter``, its input
    laid out ``(D, ..., n_loc)`` (rank ``d``'s chunk contiguous)."""
    D = mesh.size
    chunks = x.reshape(*x.shape[:-1], D, x.shape[-1] // D).movedim(-2, 0).contiguous()
    out = x.new_empty(chunks.shape[1:])
    dist.reduce_scatter(out, list(chunks.unbind(0)), op=op, group=mesh.group)
    return out


def _merge(rt: ShardedRuntime, agg: torch.Tensor, touched: torch.Tensor,
           program: VertexProgram) -> tuple[torch.Tensor, torch.Tensor]:
    """One pass's merge across the group (MIN on the aggregate and SUM on
    the touched counts for MIN programs, SUM on both for SUM programs):
    the merged ``(..., n)`` rows under the replicated layout, the rank's
    owned ``(..., n_loc)`` slices of the same merge under the owner
    layout.  Lane rows merge together, one collective each."""
    op = dist.ReduceOp.MIN if program.combine == MIN else dist.ReduceOp.SUM
    count = touched.to(torch.int32)
    if rt.vertex_sharding == "owner":
        return (_reduce_to_owned(agg, op, rt.mesh),
                _reduce_to_owned(count, dist.ReduceOp.SUM, rt.mesh) > 0)
    group = rt.mesh.group
    dist.all_reduce(agg, op=op, group=group)
    dist.all_reduce(count, op=dist.ReduceOp.SUM, group=group)
    return agg, count > 0


# --------------------------------------------------------------------------
# One sharded iteration
# --------------------------------------------------------------------------

def _local_sweep(
    rt: ShardedRuntime,
    engines: list[int],        # (P_local,) host ints — NONE entries are skipped
    order: list[int],          # (P_local,) local processing order
    frontier: torch.Tensor,    # (n_pad,) the whole frontier
    operand: torch.Tensor,     # (n_pad,) the whole message operand
    program: VertexProgram,
    use_kernels: bool = False,
) -> tuple[torch.Tensor, torch.Tensor]:
    """Relax this rank's partitions, each its own ``part_edges[p]`` edges,
    into ``(n_pad,)`` (agg, touched), then merge across the group, one
    collective exchange of the contribution vector a pass: the merged
    ``(n,)`` vectors under the replicated layout, the rank's owned
    ``(n_loc,)`` slices of the same merge under the owner layout."""
    n = rt.n_pad
    _, edge_start, part_edges = rt.parts.host
    identity = float("inf") if program.combine == MIN else 0.0
    agg = torch.full((n,), identity, dtype=torch.float32, device=operand.device)
    touched = torch.zeros(n, dtype=torch.bool, device=operand.device)
    for p in order:
        eng = engines[p]
        if eng == NONE:
            continue
        gp = rt.p_offset + p
        start = edge_start[gp] - rt.edge_base
        stop = start + part_edges[gp]
        src = rt.edge_src[start:stop]
        block = EdgeBlock(src=src, dst=rt.edge_dst[start:stop],
                          weight=rt.edge_weight[start:stop],
                          active=torch.index_select(frontier, 0, src))
        out = relax_with_engine(eng, block, operand, n, program, use_kernels)
        agg = torch.minimum(agg, out.agg) if program.combine == MIN else agg + out.agg
        touched |= out.touched
    return _merge(rt, agg, touched, program)


def _apply_merged(
    values: torch.Tensor,
    delta: torch.Tensor,
    consumed: torch.Tensor,   # (n,) bool — frontier vertices absorbing Δ
    agg: torch.Tensor,
    touched: torch.Tensor,
    program: VertexProgram,
):
    """Synchronous state update from a merged contribution vector (the
    sharded counterpart of ``core.hytm._sweep``'s sync branch)."""
    if program.combine == MIN:
        improved = touched & (agg < values)
        return torch.where(improved, agg, values), delta, improved
    values = values + torch.where(consumed, delta, 0.0)
    delta = torch.where(consumed, 0.0, delta) + agg
    return values, delta, touched


class _ShardPlanned(NamedTuple):
    """One iteration's plan on the device: the global plan, the rank's
    slice of it, and the whole frontier and Δ it was planned from."""

    planned: _Planned          # stats, plan, global schedule, Δ mass (P_pad)
    engines: torch.Tensor      # (P_local,) the rank's engines
    order1: torch.Tensor       # (P_local,) pass-1 local order
    order2: torch.Tensor       # (P_local,) pass-2 local order (masked engines)
    second: torch.Tensor       # (P_local,) bool: the global second-pass mask
    frontier: torch.Tensor     # (n_pad,) the whole starting frontier
    delta: torch.Tensor | None  # (n_pad,) the whole Δ (owner layout, Δ mode), else None


def _make_iteration_impl(rt: ShardedRuntime, program: VertexProgram, config: HyTMConfig):
    """``(plan_fn, fetch, iter_fn)`` of one runtime and program:
    ``plan_fn(state, correction)`` plans on the device, ``fetch(splanned,
    prev_active)`` is the iteration's one copy to the host and
    ``iter_fn(state, splanned, host, correction)`` sweeps both passes
    (``core.hytm.chunked_while``'s protocol once the correction is
    bound).  Under the owner layout ``state`` holds the rank's owned
    slices."""
    mode = config.cds_mode
    P_local, p0 = rt.n_local, rt.p_offset
    use_kernels = resolve_use_kernels(config.use_kernels, rt.device)
    owner = rt.vertex_sharding == "owner"
    # the plan reads the whole Δ only for its Δ mass (core.hytm._plan)
    gather_delta = owner and program.combine != MIN and mode == "delta"
    own = rt.owned
    inv_deg_own, vpid_own = rt.inv_deg[own], rt.parts.vertex_part_id[own]

    def whole(x: torch.Tensor) -> torch.Tensor:
        """The halo fill: the (n_pad,) view the rank's edges read."""
        return all_gather_owned(x, rt.mesh) if owner else x

    def plan_fn(state: HyTMState, correction: torch.Tensor | None):
        # gather before planning: the plan, the engine picks and the
        # second-pass mask come from the whole frontier and Δ, as under the
        # replicated layout (a sum of per-rank Δ masses would reorder a float
        # sum); the gathered frontier is also pass 1's halo fill
        view = HyTMState(values=state.values,
                         delta=all_gather_owned(state.delta, rt.mesh) if gather_delta
                         else state.delta,
                         frontier=whole(state.frontier))
        planned = _plan(view, rt, program, config, correction)
        sl = slice(p0, p0 + P_local)
        engines_l = planned.plan.engines[sl]
        mask_l = planned.sched.second_pass[sl]
        dmass_l = planned.delta_mass[sl]
        order1 = make_schedule(engines_l, dmass_l, rt.n_hub_partitions, mode,
                               config.recompute_once, pid_offset=p0,
                               priority_mask=mask_l).order
        order2 = make_schedule(torch.where(mask_l, engines_l, NONE), dmass_l,
                               rt.n_hub_partitions, mode, config.recompute_once,
                               pid_offset=p0, priority_mask=mask_l).order
        return _ShardPlanned(planned, engines_l, order1, order2, mask_l, view.frontier,
                             view.delta if gather_delta else None)

    def fetch(splanned: _ShardPlanned, prev_active: torch.Tensor | None = None):
        parts = [splanned.engines, splanned.order1, splanned.order2,
                 splanned.second.to(torch.int32)]
        if prev_active is not None:
            parts.append(prev_active.reshape(1).to(torch.int32))
        host = torch.cat(parts).tolist()
        L = P_local
        prev = host[4 * L] if prev_active is not None else None
        return host[:L], host[L:2 * L], host[2 * L:3 * L], host[3 * L:4 * L], prev

    def iter_fn(state: HyTMState, splanned: _ShardPlanned, host, correction):
        planned = splanned.planned
        engines_h, order1, order2, second_h = host
        frontier, values, delta = state.frontier, state.values, state.delta
        consume_sum = program.combine == SUM
        damping = _scalar(program.damping, values) if consume_sum else None

        # pass 1: every active partition, one merge
        if not consume_sum:
            operand = whole(values)
        elif splanned.delta is not None:
            # elementwise: the same bits as gathering the owned products
            operand = damping * splanned.delta * rt.inv_deg
        else:
            operand = whole(damping * delta * inv_deg_own)
        agg, touched = _local_sweep(rt, engines_h, order1, splanned.frontier, operand,
                                    program, use_kernels)
        if program.peel_k is not None:
            # the merged agg counts each destination's newly-removed
            # in-neighbours: additive, so sync == sharded
            values1, delta1, activated = values - agg, delta, touched
        else:
            values1, delta1, activated = _apply_merged(values, delta, frontier, agg,
                                                       touched, program)

        # pass 2: recompute-once over the loaded priority partitions
        if program.peel_k is not None:
            frontier2 = torch.zeros_like(frontier)
        elif program.combine == MIN:
            frontier2 = frontier | activated
        else:
            frontier2 = torch.abs(delta1) > _scalar(program.tolerance, frontier)
        operand2 = damping * delta1 * inv_deg_own if consume_sum else values1
        engines2 = [e if s else NONE for e, s in zip(engines_h, second_h)]
        agg2, touched2 = _local_sweep(rt, engines2, order2, whole(frontier2), whole(operand2),
                                      program, use_kernels)
        if program.peel_k is not None:
            values2, delta2, activated2 = values1 - agg2, delta1, touched2
        else:
            # pass-2 consumption only touches re-processed partitions
            processed2 = (torch.index_select(planned.sched.second_pass, 0, vpid_own)
                          & (torch.index_select(planned.plan.engines, 0, vpid_own) != NONE))
            values2, delta2, activated2 = _apply_merged(
                values1, delta1, frontier2 & processed2, agg2, touched2, program)
        new_state, info = _finish(values2, delta2, activated | activated2, frontier,
                                  planned, program, config, correction)
        # the entries a compacted exchange would ship: destinations any rank
        # touched in either pass
        merged = (touched | touched2).sum(dtype=torch.int32)
        if owner:
            # owned-slice sums, made global (and equal on every rank) by one
            # all_reduce before the host reads either
            counts = torch.stack([info["next_active"], merged])
            dist.all_reduce(counts, group=rt.mesh.group)
            info["next_active"], merged = counts[0], counts[1]
            info[KEY_ACTIVE_VERTICES] = splanned.frontier.sum(dtype=torch.int32)
        info[KEY_MERGED_ENTRIES] = merged
        return new_state, info

    return plan_fn, fetch, iter_fn


def make_sharded_iteration(rt: ShardedRuntime, program: VertexProgram, config: HyTMConfig):
    """The K = 1 driver's dispatch unit: ``iteration(state, correction)
    -> (state, info)``."""
    plan_fn, fetch, iter_fn = _make_iteration_impl(rt, program, config)

    def iteration(state: HyTMState, correction: torch.Tensor | None = None):
        splanned = plan_fn(state, correction)
        *host, _ = fetch(splanned)
        return iter_fn(state, splanned, tuple(host), correction)

    return iteration


def make_sharded_chunk(rt: ShardedRuntime, program: VertexProgram, config: HyTMConfig,
                       chunk: int):
    """The chunked driver's dispatch unit: ``chunk_fn(state, history,
    correction)`` runs up to ``chunk`` sharded iterations under
    ``core.hytm.chunked_while``'s contract (the early exit reads the
    previous iteration's replicated ``next_active``, so every rank stops
    at the same iteration) and returns ``(state, history, n_done,
    last_active, per_engine_sum)``; ``init_history()`` allocates the
    (chunk, ...) buffers, ``merged_entries`` beside ``HISTORY_KEYS``."""
    plan_fn, fetch, iter_fn = _make_iteration_impl(rt, program, config)
    keys = HISTORY_KEYS + (KEY_MERGED_ENTRIES,)
    shapes = {**history_shapes(rt.n_partitions), KEY_MERGED_ENTRIES: ((), torch.int32)}

    def chunk_fn(state: HyTMState, history: dict, correction: torch.Tensor | None):
        return chunked_while(
            lambda st, sp, host: iter_fn(st, sp, host, correction),
            lambda st: plan_fn(st, correction), state, history, chunk, fetch=fetch)

    def init_history() -> dict:
        return init_history_buffers(shapes, chunk, keys=keys, device=rt.device)

    return chunk_fn, init_history


def _lane_sweep_local(rt: ShardedRuntime, steps: list, table: torch.Tensor,
                      frontier: torch.Tensor, operand: torch.Tensor,
                      program: VertexProgram, use_kernels: bool):
    """:func:`_local_sweep` for ``(Q, n_pad)`` lane rows: at step j every
    lane relaxes its own j-th local partition, each engine's lanes in one
    ``relax_lanes`` call over the rank's edge columns, the ``(L, n_pad)``
    results combined into the lanes' rows in each lane's own order; then
    one :func:`_merge` of all the lanes."""
    Q, n = frontier.shape
    identity = float("inf") if program.combine == MIN else 0.0
    agg = torch.full((Q, n), identity, dtype=torch.float32, device=operand.device)
    touched = torch.zeros((Q, n), dtype=torch.bool, device=operand.device)
    flat_op = operand.reshape(-1)

    def operand_at(flat, src):
        return torch.index_select(flat_op, 0, flat)

    for groups, _ in steps:
        for eng, pos, lengths in groups:
            group = _lane_group(table, pos, lengths)
            out = relax_lanes(eng, group, rt, frontier, operand_at, program, use_kernels)
            rows = group.rows
            cur = torch.index_select(agg, 0, rows)
            agg.index_copy_(0, rows, torch.minimum(cur, out.agg) if program.combine == MIN
                            else cur + out.agg)
            touched.index_copy_(0, rows, torch.index_select(touched, 0, rows) | out.touched)
    return _merge(rt, agg, touched, program)


def make_sharded_batched_chunk(rt: ShardedRuntime, program: VertexProgram,
                               config: HyTMConfig, chunk: int):
    """The dispatch unit of sharded serving: ``chunk_fn(state, correction)``
    runs up to ``chunk`` sharded iterations over a ``(Q, ·)`` lane state
    (``(Q, n)`` rows under the replicated layout, the rank's ``(Q, n_loc)``
    owned slices under the owner layout), while fewer than ``chunk`` ran
    and any lane is active; the first always runs.

    Each iteration is :func:`make_sharded_chunk`'s, lane by lane: every
    lane plans on its own whole row with ``core.hytm._plan`` (under the
    owner layout the lane frontiers, and for SUM lanes in Δ mode the Δ
    rows, all-gathered to ``(Q, n_pad)`` first), so its engines, orders,
    bytes and times equal its solo sharded run's; ONE host copy brings
    every lane's local engines, both local orders and second-pass flags
    with the previous iteration's ``(Q,)`` ``next_active``; the rank
    relaxes its local partitions through the lane entries
    (``core.engines.relax_lanes``, ``async_sweep=False``) and ONE batched
    collective a pass merges every lane.  ``next_active`` and the merged
    entries are summed per lane and, under the owner layout, made global
    by one ``all_reduce`` of the two packed together, so every rank leaves
    the chunk at the same iteration.

    Returns ``(state, n_done, lane_active, per_engine_sum, mispred_sum,
    merged_rows)``: ``n_done`` a host int, ``lane_active`` the last
    iteration's ``(Q,)`` int32 ``next_active``, ``per_engine_sum`` the
    ``(3,)`` modeled seconds summed over lanes and iterations,
    ``mispred_sum`` an int32 0-dim tensor and ``merged_rows`` the
    ``(n_done,)`` int32 lane-summed ``merged_entries`` of each iteration
    (the second level's input), all on the device and equal on every
    rank.  The input state is not modified.  ``rt``'s tensors are read
    when the chunk is built: build it anew after a ``DeltaCSR`` patch."""
    mode = config.cds_mode
    P_local, p0 = rt.n_local, rt.p_offset
    use_kernels = resolve_use_kernels(config.use_kernels, rt.device)
    owner = rt.vertex_sharding == "owner"
    gather_delta = owner and program.combine != MIN and mode == "delta"
    own = rt.owned
    inv_deg_own, vpid_own = rt.inv_deg[own], rt.parts.vertex_part_id[own]
    consume_sum = program.combine == SUM
    peel = program.peel_k is not None

    def whole(x: torch.Tensor) -> torch.Tensor:
        return all_gather_owned(x, rt.mesh) if owner else x

    def plan(state: HyTMState, correction):
        frontier = whole(state.frontier)
        delta = all_gather_owned(state.delta, rt.mesh) if gather_delta else state.delta
        plans = _lane_plans(HyTMState(values=state.values, delta=delta, frontier=frontier),
                            rt, program, config, correction)
        sl = slice(p0, p0 + P_local)
        local = []
        for pl in plans:
            engines_l, mask_l = pl.plan.engines[sl], pl.sched.second_pass[sl]
            dmass_l = pl.delta_mass[sl]
            local.append((engines_l, *(make_schedule(
                e, dmass_l, rt.n_hub_partitions, mode, config.recompute_once,
                pid_offset=p0, priority_mask=mask_l).order
                for e in (engines_l, torch.where(mask_l, engines_l, NONE))), mask_l))
        return plans, local, frontier, delta if gather_delta else None

    def fetch(local, prev_active):
        """The iteration's ONE copy to the host: (Q, P_local) stacks of the
        local engines, both orders and the flags, and the previous (Q,)
        ``next_active``."""
        Q, L = len(local), P_local
        parts = [torch.stack([row[k] for row in local]).to(torch.int32).reshape(-1)
                 for k in range(4)]
        if prev_active is not None:
            parts.append(prev_active.to(torch.int32))
        host = torch.cat(parts).tolist()

        def rows(k):
            return [host[(k * Q + q) * L:(k * Q + q + 1) * L] for q in range(Q)]

        prev = host[4 * Q * L:] if prev_active is not None else None
        return rows(0), rows(1), rows(2), rows(3), prev

    def iteration(state: HyTMState, plans, frontier_w, delta_w, host, correction):
        engines_h, order1, order2, second_h = host
        frontier, values, delta = state.frontier, state.values, state.delta
        damping = _scalar(program.damping, values) if consume_sum else None
        upload = _LaneUpload()
        steps1 = _lane_steps(upload, rt, engines_h, order1, None, p0, rt.edge_base)
        engines2 = [[e if f else NONE for e, f in zip(eq, sq)]
                    for eq, sq in zip(engines_h, second_h)]
        steps2 = _lane_steps(upload, rt, engines2, order2, None, p0, rt.edge_base)
        table = upload.upload(rt.device)

        # pass 1: every active partition of every lane, one merge
        if not consume_sum:
            operand = whole(values)
        elif delta_w is not None:
            operand = damping * delta_w * rt.inv_deg
        else:
            operand = whole(damping * delta * inv_deg_own)
        agg, touched = _lane_sweep_local(rt, steps1, table, frontier_w, operand, program,
                                         use_kernels)
        if peel:
            values1, delta1, activated = values - agg, delta, touched
        else:
            values1, delta1, activated = _apply_merged(values, delta, frontier, agg,
                                                       touched, program)

        # pass 2: recompute-once over each lane's loaded priority partitions
        if peel:
            frontier2 = torch.zeros_like(frontier)
        elif program.combine == MIN:
            frontier2 = frontier | activated
        else:
            frontier2 = torch.abs(delta1) > _scalar(program.tolerance, frontier)
        operand2 = damping * delta1 * inv_deg_own if consume_sum else values1
        agg2, touched2 = _lane_sweep_local(rt, steps2, table, whole(frontier2),
                                           whole(operand2), program, use_kernels)
        if peel:
            values2, delta2, activated2 = values1 - agg2, delta1, touched2
        else:
            second = torch.stack([pl.sched.second_pass for pl in plans])
            engines = torch.stack([pl.plan.engines for pl in plans])
            processed2 = (torch.index_select(second, 1, vpid_own)
                          & (torch.index_select(engines, 1, vpid_own) != NONE))
            values2, delta2, activated2 = _apply_merged(
                values1, delta1, frontier2 & processed2, agg2, touched2, program)
        activated = activated | activated2

        # the next frontier, as core.hytm._finish lane by lane
        if peel:
            next_frontier = (delta2 < 0.5) & (values2 < program.peel_k)
            delta2 = delta2 + next_frontier.to(torch.float32)
        elif program.combine == MIN:
            next_frontier = activated
        else:
            next_frontier = torch.abs(delta2) > _scalar(program.tolerance, frontier)
        diags = [selection_diagnostics(pl.plan.engines, pl.plan.transfer_time, pl.stats,
                                       pl.plan.costs, correction) for pl in plans]
        per_engine = torch.stack([d[0] for d in diags]).sum(dim=0)
        mispredictions = torch.stack([d[1] for d in diags]).sum(dtype=torch.int32)
        next_active = next_frontier.sum(dim=1, dtype=torch.int32)
        merged = (touched | touched2).sum(dtype=torch.int32).reshape(1)
        if owner:
            # owned-slice sums, made global by one all_reduce
            counts = torch.cat([next_active, merged])
            dist.all_reduce(counts, group=rt.mesh.group)
            next_active, merged = counts[:-1], counts[-1:]
        return (HyTMState(values=values2, delta=delta2, frontier=next_frontier),
                next_active, per_engine, mispredictions, merged)

    def chunk_fn(state: HyTMState, correction: torch.Tensor | None = None):
        Q = state.values.shape[0]
        dev = state.values.device
        pe_sum = torch.zeros(3, dtype=torch.float32, device=dev)
        mp_sum = torch.zeros((), dtype=torch.int32, device=dev)
        lane_active, merged_rows = None, []
        n_done = 0
        while n_done < chunk:
            plans, local, frontier_w, delta_w = plan(state, correction)
            *host, prev = fetch(local, lane_active)
            if prev is not None and not any(prev):
                break
            state, lane_active, pe, mp, merged = iteration(
                state, plans, frontier_w, delta_w, tuple(host), correction)
            pe_sum = pe_sum + pe
            mp_sum = mp_sum + mp
            merged_rows.append(merged)
            n_done += 1
        if lane_active is None:
            lane_active = torch.zeros(Q, dtype=torch.int32, device=dev)
        merged = (torch.cat(merged_rows) if merged_rows
                  else torch.zeros(0, dtype=torch.int32, device=dev))
        return state, n_done, lane_active, pe_sum, mp_sum, merged

    return chunk_fn


# --------------------------------------------------------------------------
# Second transfer-management level: the cross-device merge
# --------------------------------------------------------------------------

def _ring_per_dev_bytes(payload_bytes: float, n_devices: int) -> float:
    """Bytes one device moves for a ring all-reduce of ``payload_bytes``."""
    return 2.0 * (n_devices - 1) / n_devices * payload_bytes


def _collective_charge(per_dev_bytes: float, link) -> float:
    """Seconds for one collective, through the Eq-1 transaction-group
    model (shared by the dense and compacted ICI candidates)."""
    group = link.m * link.mr
    return float(np.ceil(per_dev_bytes / group)) * link.rtt + link.launch_overhead_s


def ici_merge_cost(n_nodes: int, n_devices: int, link,
                   n_collectives: int = 4) -> tuple[float, float]:
    """Modeled (bytes, seconds) of one iteration's cross-device merges:
    two dense (n,) vectors (the aggregate and the touched counts) a pass,
    two passes.  Bytes are the all-device total, seconds the per-device
    critical path through the transaction-group model (Eqs. 1-3)."""
    if n_devices <= 1:
        return 0.0, 0.0
    per_dev = _ring_per_dev_bytes(n_nodes * 4.0, n_devices)
    total_bytes = per_dev * n_devices * n_collectives
    return total_bytes, n_collectives * _collective_charge(per_dev, link)


def ici_level_cost(
    n_nodes: int,
    merged_entries: float,
    n_devices: int,
    link,
    correction: np.ndarray | None = None,
    n_collectives: int = 4,
) -> tuple[float, float, int]:
    """Algorithm 1 at the second level: a dense all-reduce of the whole
    (n,) vectors (the FILTER analogue) against a compacted exchange of the
    ``merged_entries`` touched destinations as 8-byte (index, payload)
    pairs (the COMPACT analogue).  Returns (bytes, seconds, engine).
    ``correction`` rescales the two candidates for the comparison only;
    the charge is the chosen engine's uncorrected time.  Host float64, as
    in the reference."""
    if n_devices <= 1:
        return 0.0, 0.0, NONE
    c = np.ones(3) if correction is None else np.asarray(correction, float)
    per_dev_comp = _ring_per_dev_bytes(float(merged_entries) * 8.0, n_devices)
    t_comp = n_collectives * _collective_charge(per_dev_comp, link)
    dense_bytes, t_dense = ici_merge_cost(n_nodes, n_devices, link,
                                          n_collectives=n_collectives)
    if t_comp * c[COMPACT] < t_dense * c[FILTER]:
        return per_dev_comp * n_devices * n_collectives, t_comp, COMPACT
    return dense_bytes, t_dense, FILTER


def halo_level_cost(
    n_nodes: int,
    merged_entries: float,
    halo_total: int,
    n_devices: int,
    link,
    correction: np.ndarray | None = None,
    n_collectives: int = 4,
) -> tuple[float, float, int]:
    """:func:`ici_level_cost` under the owner layout: a compacted exchange
    never ships more than the boundary vertices the edges name, so the
    compacted candidate's entry count is capped at ``halo_total``.  The
    dense candidate and the select-corrected, charge-uncorrected contract
    are unchanged."""
    return ici_level_cost(n_nodes, min(float(merged_entries), float(halo_total)),
                          n_devices, link, correction, n_collectives)


# --------------------------------------------------------------------------
# Convergence loop
# --------------------------------------------------------------------------

def owner_state_pad_values(program: VertexProgram) -> tuple[float, float]:
    """(values, Δ) fill of the ``[n, n_pad)`` ghost vertices of the owner
    layout.  Pads carry no edges, so the fills only keep them inert under
    the next-frontier rules: a peel pads Δ = 1 (removed; Δ = 0 would make
    them alive with degree < k), accumulative programs pad 0, min-combiners
    pad values = inf (unreachable); frontier pads are always False."""
    if program.peel_k is not None:
        return 0.0, 1.0
    if program.use_delta:
        return 0.0, 0.0
    return float(np.inf), 0.0


def _owner_place_state(rt: ShardedRuntime, program: VertexProgram, values, delta,
                       frontier) -> HyTMState:
    """This rank's ``(n_loc,)`` slices of an ``(n,)`` (values, Δ, frontier)
    triple padded with the program's inert fills, on the mesh's device: the
    placement of every owner-layout start (cold, warm or resumed).  Only the
    owned slice is copied; the whole padded vector is never built."""
    pad_v, pad_d = owner_state_pad_values(program)
    lo, hi = rt.owned.start, rt.owned.stop

    def place(x, fill, dtype):
        x = torch.as_tensor(x, dtype=dtype, device=rt.device)
        real = x[lo:max(lo, min(hi, x.shape[0]))]
        extra = hi - lo - real.shape[0]
        return torch.cat([real, real.new_full((extra,), fill)]) if extra else real.clone()

    return HyTMState(values=place(values, pad_v, torch.float32),
                     delta=place(delta, pad_d, torch.float32),
                     frontier=place(frontier, False, torch.bool))


def _rank0_correction(calib, mesh: GraphMesh) -> tuple[np.ndarray, torch.Tensor]:
    """Rank 0's calibrator correction on every rank: (float64 host copy,
    float32 device tensor rounded to nearest, as the single-device run
    enters it)."""
    c = torch.as_tensor(np.asarray(calib.correction(), np.float64), device=mesh.device)
    dist.broadcast(c, src=dist.get_global_rank(mesh.group, 0), group=mesh.group)
    c64 = c.cpu().numpy()
    return c64, torch.from_numpy(c64.astype(np.float32)).to(mesh.device)


def run_hytm_sharded(
    g: CSRGraph | None,
    program: VertexProgram,
    source: int | None = 0,
    config: HyTMConfig = HyTMConfig(mesh_axis="graph"),
    n_hubs: int = 0,
    mesh: GraphMesh | None = None,
    runtime: ShardedRuntime | None = None,
    calibrator=None,
    initial_state: HyTMState | None = None,
    obs=None,
    faults=None,
    retry=None,
    on_chunk=None,
    device: str | torch.device | None = None,
) -> HyTMResult:
    """``run_hytm`` over a 1-D process group; every rank of ``mesh``'s
    group calls it with the same arguments and gets the same result.

    Contract: the engine picks, the modeled transfer accounting, the
    iteration count and the state trajectory of the single-device
    ``async_sweep=False`` run (bit for bit for MIN programs and k-core, up
    to float summation order for SUM programs); the history's ICI rows
    (``ici_bytes``, ``ici_time``, ``ici_engine``) are the second level's
    model charge, one row an iteration.

    ``config.vertex_sharding`` picks the vertex layout (module docstring);
    both meet the contract, and the result's ``values``/``delta`` are host
    ``(n,)`` arrays under either.  Under ``"owner"`` each rank's persistent
    state is its ``(n_loc,)`` slice, and the ICI rows charge
    :func:`halo_level_cost` of the runtime's :class:`HaloPlan`.

    ``mesh`` defaults to ``make_graph_mesh(config.mesh_axis,
    device=device)`` over the default group; the run takes the mesh's
    device.  ``runtime`` (a :class:`ShardedRuntime` of this mesh, built
    under the config's layout) lets callers amortize the set-up, and then
    ``g`` may be ``None``.  ``initial_state`` warm-starts from a replicated
    ``(n,)`` (values, Δ, frontier) triple on the mesh's device (placed by
    :func:`_owner_place_state` under the owner layout).  ``calibrator``,
    ``obs``, ``faults``, ``retry`` and ``on_chunk`` are ``run_hytm``'s:
    every rank guards its dispatches at site ``chunk_dispatch``
    (``mesh=True`` in the plan's context) and calls ``on_chunk``, with
    ``mesh`` besides ``run_hytm``'s arguments (a ``CheckpointHook`` then
    gathers an owner state and lets rank 0 alone write); with
    ``config.autotune`` only rank 0's calibrator observes, and its
    correction is broadcast; ``obs`` records on track ``mesh``, one ``ici``
    instant an iteration."""
    # late import: the resilience package's checkpoint module imports this one
    from repro_torch.resilience.supervisor import guarded_dispatch

    layout = _check_vertex_sharding(config.vertex_sharding)
    if runtime is not None:
        rt = runtime
        mesh = rt.mesh
    else:
        if g is None:
            raise ValueError("run_hytm_sharded needs a graph or a prebuilt runtime")
        if mesh is None:
            mesh = make_graph_mesh(axis=config.mesh_axis, device=device)
        if program.symmetrize:
            g = g.symmetrize()
        rt = build_sharded_runtime(g, config, mesh, n_hubs=n_hubs,
                                   weighted_norm=program.use_delta and program.weighted)
    if rt.vertex_sharding != layout:
        raise ValueError(
            f"the runtime was built with vertex_sharding={rt.vertex_sharding!r} but the "
            f"config asks for {layout!r}; rebuild the runtime")
    if config.sync_every < 1:
        raise ValueError(f"sync_every must be >= 1, got {config.sync_every}")
    if on_chunk is not None and config.sync_every == 1:
        raise ValueError(
            "on_chunk (checkpointing) requires the chunked driver: set sync_every >= 2")
    if getattr(on_chunk, "state_layout", layout) != layout:
        raise ValueError(
            f"on_chunk saves state_layout={on_chunk.state_layout!r}, the run's "
            f"vertex_sharding is {layout!r}")
    owner = layout == "owner"
    dev = rt.device
    if initial_state is None:
        if program.peel_k is not None:
            # sliced to the real vertices: pads never enter the frontier
            deg = rt.out_degree[:rt.n_nodes].to(torch.float32)
            removed = deg < program.peel_k
            triple = (deg, removed.to(torch.float32), removed)
        else:
            triple = program.init_state(rt.n_nodes, source, dev)
    else:
        if initial_state.values.device.type != dev.type:
            raise ValueError(
                f"initial_state lives on {initial_state.values.device}, the mesh on {dev}")
        triple = (initial_state.values, initial_state.delta, initial_state.frontier)
    if owner:
        state = _owner_place_state(rt, program, *triple)
    else:
        state = initial_state if initial_state is not None else HyTMState(*triple)
    n_dev = mesh.size

    calib = None
    correction = corr_np = None
    if config.autotune:
        if calibrator is None:
            from repro_torch.autotune.feedback import OnlineCalibrator

            calibrator = OnlineCalibrator(decay=config.autotune_decay)
        calib = calibrator
        corr_np, correction = _rank0_correction(calib, mesh)
    lead = mesh.rank == 0

    rows: dict[str, list] = {k: [] for k in HISTORY_KEYS}
    ici_hist: dict[str, list] = {KEY_ICI_BYTES: [], KEY_ICI_TIME: [], KEY_ICI_ENGINE: []}

    def charge_ici(merged_entries: float) -> None:
        if owner:
            # a compacted exchange ships at most the halo
            halo_entries = min(float(merged_entries), float(rt.halo.halo_total))
            ib, it_, ie = halo_level_cost(rt.n_nodes, float(merged_entries),
                                          rt.halo.halo_total, n_dev, config.ici_link, corr_np)
        else:
            halo_entries = None
            ib, it_, ie = ici_level_cost(rt.n_nodes, float(merged_entries), n_dev,
                                         config.ici_link, corr_np)
        it = len(ici_hist[KEY_ICI_BYTES])
        ici_hist[KEY_ICI_BYTES].append(ib)
        ici_hist[KEY_ICI_TIME].append(it_)
        ici_hist[KEY_ICI_ENGINE].append(ie)
        if obs is not None:
            from repro_torch.obs.record import record_ici

            record_ici(obs, track="ici", it=it, bytes_=ib, seconds=it_, engine=ie,
                       merged_entries=float(merged_entries), halo_entries=halo_entries)

    use_kernels = resolve_use_kernels(config.use_kernels, dev)
    dispatch = functools.partial(guarded_dispatch, site="chunk_dispatch", faults=faults,
                                 policy=retry, obs=obs, mesh=True, kernels=use_kernels)
    t0 = time.monotonic()
    iters = 0
    if config.sync_every > 1:
        history, cur_chunk, cached = None, -1, None
        while iters < config.max_iters:
            chunk = min(config.sync_every, config.max_iters - iters)
            if chunk != cur_chunk:
                cached = make_sharded_chunk(rt, program, config, chunk)
                history = cached[1]()
                cur_chunk = chunk
            warm = _consume_warm((
                "sharded-chunk", program, config, rt.n_hub_partitions, chunk, rt.n_nodes,
                rt.n_partitions, rt.parts.block_size, mesh.rank, n_dev, layout,
                correction is not None,
            ))
            t_chunk = time.monotonic()
            state, history, n_done, last_active, pe_sum = dispatch(
                functools.partial(cached[0], state, history, correction))
            iters += n_done
            if calib is not None:
                # rank 0 observes (before the drain: the window covers
                # dispatch and execution only); every rank takes its result
                if lead:
                    calib.observe_chunk(state.values, pe_sum.cpu().numpy().astype(float),
                                        t_chunk, skip=not warm)
                next_np, correction = _rank0_correction(calib, mesh)
            drained = {k: v[:n_done].to("cpu", copy=True).numpy() for k, v in history.items()}
            for me in drained[KEY_MERGED_ENTRIES]:
                charge_ici(me)   # under the chunk's correction
            if calib is not None:
                corr_np = next_np
            for k in rows:
                rows[k].append(drained[k])
            if obs is not None:
                from repro_torch.obs.record import record_chunk, record_history_rows

                record_history_rows(obs, drained, n_done, iters - n_done, track="mesh")
                record_chunk(obs, track="mesh", wall_start=obs.wall_at(t_chunk),
                             wall_dur=obs.wall() - obs.wall_at(t_chunk),
                             start_iter=iters - n_done, n_done=n_done, warm=warm)
            active = int(last_active)
            if on_chunk is not None:
                on_chunk(state=state, iterations=iters, rows=rows, calibrator=calib,
                         last_active=active, mesh=mesh)
            if active == 0:
                break
        history = {k: np.concatenate(v) for k, v in rows.items()}
    else:
        iteration = make_sharded_iteration(rt, program, config)
        for _ in range(config.max_iters):
            t_iter = time.monotonic()
            state, info = dispatch(functools.partial(iteration, state, correction))
            iters += 1
            next_active, merged = torch.stack(
                [info["next_active"], info[KEY_MERGED_ENTRIES]]).tolist()
            charge_ici(merged)   # under this iteration's correction
            if calib is not None:
                if lead:
                    calib.observe_iteration(state.values, info[KEY_PER_ENGINE_TIME], t_iter,
                                            skip=iters == 1)
                corr_np, correction = _rank0_correction(calib, mesh)
            for k in rows:
                rows[k].append(info[k])
            if next_active == 0:
                break
        history = {k: torch.stack(v).cpu().numpy() for k, v in rows.items()}
        if obs is not None:
            from repro_torch.obs.record import record_history_rows

            record_history_rows(obs, history, iters, 0, track="mesh")
    if owner:
        # the whole vectors without their pads, on every rank
        n = rt.n_nodes
        both = torch.cat([all_gather_owned(state.values, mesh)[:n],
                          all_gather_owned(state.delta, mesh)[:n]]).cpu().numpy()
        values, delta = both[:n], both[n:]
    else:
        values = state.values.cpu().numpy()
        delta = state.delta.cpu().numpy()
    wall = time.monotonic() - t0

    for k, v in ici_hist.items():
        history[k] = np.asarray(v)
    result = HyTMResult(
        values=values,
        delta=delta,
        iterations=iters,
        wall_seconds=wall,
        modeled_seconds=float(np.sum(history[KEY_TRANSFER_TIME])),
        total_transfer_bytes=float(np.sum(history[KEY_TRANSFER_BYTES])),
        history=history,
        total_ici_bytes=float(np.sum(history[KEY_ICI_BYTES])),
        modeled_ici_seconds=float(np.sum(history[KEY_ICI_TIME])),
        total_mispredictions=int(np.sum(history[KEY_MISPREDICTIONS])),
        # rank 0's calibrator, the same on every rank
        engine_corrections=corr_np if calib is not None else None,
    )
    if obs is not None:
        from repro_torch.obs.record import record_run

        record_run(obs, result, track="mesh", wall_start=obs.wall_at(t0), wall_dur=wall,
                   program=program.name, label=f"run[{n_dev}dev]")
    return result
