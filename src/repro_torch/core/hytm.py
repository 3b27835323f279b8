"""HyTM engine orchestration — cost model, task generation and asynchronous
scheduling tied into the iterate-until-convergence loop (paper Fig. 5).

One *iteration*:

  1. per-partition activity stats      (segment sums, on the device)
  2. cost model + engine selection     (Eqs. 1-3, Algorithm 1)
  3. task combination                  (merged task count)
  4. priority schedule                 (hub / Δ contribution order)
  5. asynchronous sweep                (partitions in priority order, each
     relaxed by its engine against the *current* values — later
     partitions see earlier updates)
  6. recompute-once second pass        (loaded priority partitions)

Steps 1-4 run on the device.  The sweep dispatches one partition at a time
from the host, so it needs the (P,) engines, the order and the second-pass
flags there: each iteration copies them to the host in ONE transfer, and
the chunked driver folds the previous iteration's frontier population
(``next_active``, the early-exit test) into that same transfer.  That is
one host sync per iteration (plus one per chunk for the history drain), as
the reference's K=1 loop has (``repro/core/hytm.py:966``); the port's K=1
loop reads ``next_active`` separately, a second sync.  Capturing an
iteration as a CUDA graph is later work.

Every blocking device-to-host read of ``run_hytm`` goes through ``_to_host``,
which counts it in ``host_syncs`` by site: ``fetch`` (the per-iteration
transfer above), ``drain`` (the chunk's history, one copy a key),
``active`` (the chunk's last ``next_active``; K=1: every iteration's),
``calib`` (the chunk's per-engine seconds, with autotune), ``history``
(K=1: the stacked rows, one copy a key) and ``copy_out`` (the final
values and Δ).

The chunked driver (``HyTMConfig.sync_every = K``) keeps the per-iteration
history in device-side (K, ...) buffers and drains them to the host once
per chunk.  Its contract is the reference's: the first iteration of a run
always executes, even on an empty frontier; the loop stops right after the
iteration whose ``next_active`` is 0; the iteration count equals the K=1
loop's.  Both drivers run the same iteration code, so K changes when the
history reaches the host, never what an iteration computes.
"""

from __future__ import annotations

import contextlib
import functools
import itertools
import sys
import time
from dataclasses import dataclass
from typing import Any, NamedTuple

import numpy as np
import torch

from repro_torch.core.constants import PCIE3, TPU_V5E_ICI, LinkModel
from repro_torch.core.cost_model import (
    HISTORY_KEYS,
    KEY_ACTIVE_EDGES,
    KEY_ACTIVE_VERTICES,
    KEY_ENGINES,
    KEY_MISPREDICTIONS,
    KEY_N_TASKS,
    KEY_PER_ENGINE_TIME,
    KEY_TRANSFER_BYTES,
    KEY_TRANSFER_TIME,
    NONE,
    PartitionStats,
    history_shapes,
    init_history_buffers,
    link_constants,
    partition_stats,
    selection_diagnostics,
    zc_request_counts,
)
from repro_torch.core.engines import (
    EdgeBlock,
    LaneGroup,
    packed_ranges,
    relax_lanes,
    relax_with_engine,
)
from repro_torch.core.partition import (
    DevicePartitions,
    partition_graph,
    to_device_partitions,
)
from repro_torch.core.scheduler import Schedule, make_schedule
from repro_torch.core.task_generation import TaskPlan, forced_engine_plan, generate_tasks
from repro_torch.graph.algorithms import MIN, SUM, VertexProgram
from repro_torch.graph.csr import CSRGraph, DeviceCSR, to_device_csr
from repro_torch.kernels.runtime import resolve_device, resolve_use_kernels


@dataclass(frozen=True)
class HyTMConfig:
    link: LinkModel = PCIE3
    n_partitions: int | None = None
    partition_bytes: int = 32 * 2**20  # paper default: 32 MB partitions
    async_sweep: bool = True
    cds_mode: str = "hub"  # 'hub' | 'delta' | 'none'
    enable_task_combination: bool = True
    recompute_once: bool = True
    combine_k: int = 4
    max_iters: int = 10_000
    # iterations per chunk of the convergence driver; K=1 runs the
    # per-iteration loop
    sync_every: int = 8
    # "auto" (kernels iff the tensors are on CUDA) | True | False — see
    # repro_torch.kernels.runtime.  Selection and transfer accounting never
    # depend on it.
    use_kernels: bool | str = "auto"
    forced_engine: int | None = None  # force a single engine (baselines)
    hub_fraction: float = 0.08
    # The link that charges the sharded sweep's cross-device merge in the
    # model (``dist.graph_shard.ici_level_cost``); read only with
    # ``mesh_axis``.  The default is the reference's TPU v5e ICI profile,
    # so that modeled ICI seconds compare with the reference's: its numbers
    # are the reference's model inputs, not a measurement of any GPU link.
    ici_link: LinkModel = TPU_V5E_ICI
    autotune: bool = False
    autotune_decay: float = 0.25
    # A 1-D process group's axis name: ``run_hytm`` then runs the sharded
    # sweep (``dist.graph_shard.run_hytm_sharded``), which reproduces the
    # single-device ``async_sweep=False`` dataflow whatever ``async_sweep``
    # says.
    mesh_axis: str | None = None
    # the sharded sweep's vertex-state layout: "replicated" | "owner"
    # (dist.graph_shard)
    vertex_sharding: str = "replicated"


@dataclass
class HyTMState:
    values: torch.Tensor    # (n,) f32
    delta: torch.Tensor     # (n,) f32 (accumulative programs)
    frontier: torch.Tensor  # (n,) bool


@dataclass
class Runtime:
    """Device-resident inputs shared by every iteration."""

    csr: DeviceCSR
    parts: DevicePartitions
    zc_req: torch.Tensor   # (n,) float32
    inv_deg: torch.Tensor  # (n,) float32 — 1/max(deg,1), or 1/sum(w) (PHP)
    n_hub_partitions: int

    def __post_init__(self):
        # The reference's layout contract: every partition's block_size
        # slice lies inside the edge arrays (torch slicing would silently
        # return a short block).
        B = self.parts.block_size
        _, edge_start, _ = self.parts.host
        if max(edge_start[:-1], default=0) + B > self.csr.capacity:
            raise ValueError(
                f"edge capacity {self.csr.capacity} too small for blocks of "
                f"{B} (need ceil((n_edges + block) / 128) * 128)")

    @property
    def device(self) -> torch.device:
        return self.csr.device

    @property
    def out_degree(self) -> torch.Tensor:
        return self.csr.out_degree

    @property
    def n_nodes(self) -> int:
        """As ``dist.graph_shard.ShardedRuntime.n_nodes``."""
        return self.csr.n_nodes


def build_runtime(
    g: CSRGraph,
    config: HyTMConfig,
    n_hubs: int = 0,
    weighted_norm: bool = False,
    device: str | torch.device | None = None,
) -> Runtime:
    """Partition ``g`` and upload it (``cuda`` unless ``device`` says
    otherwise)."""
    dev = resolve_device(device)
    table = partition_graph(
        g, n_partitions=config.n_partitions,
        partition_bytes=config.partition_bytes, d1=config.link.d1,
    )
    block = int(table.edges_per_partition.max(initial=1))
    block = max(128, -(-block // 128) * 128)
    capacity = -(-(g.n_edges + block) // 128) * 128
    csr = to_device_csr(g, capacity=capacity, device=dev)
    parts = to_device_partitions(table, g.n_nodes, capacity, device=dev)
    zc_req = zc_request_counts(csr.out_degree, csr.seg_start, config.link)
    c = link_constants(config.link, dev)
    if weighted_norm:
        # accumulative programs over weighted edges (PHP) push
        # delta * w_ij / sum_j w_ij
        wsum = torch.zeros(g.n_nodes, dtype=torch.float32, device=dev).index_add_(
            0, csr.edge_src, torch.where(csr.edge_valid, csr.edge_weight, c["zero"]))
        tiny = torch.full((), 1e-30, dtype=torch.float32, device=dev)
        inv_deg = c["one"] / torch.maximum(wsum, tiny)
    else:
        inv_deg = c["one"] / torch.maximum(csr.out_degree.to(torch.float32), c["one"])
    n_hub_parts = int(np.searchsorted(table.vertex_start, n_hubs, side="left"))
    n_hub_parts = max(n_hub_parts, 1) if n_hubs > 0 else 0
    return Runtime(csr=csr, parts=parts, zc_req=zc_req, inv_deg=inv_deg,
                   n_hub_partitions=n_hub_parts)


# Blocking device-to-host reads since the process started, by site, and the
# iterations ``run_hytm``'s single-device drivers ran: counted always, at an
# integer add a read, and read as deltas like the kernel wrappers' ``launches``.
SYNC_SITES = ("fetch", "drain", "active", "calib", "history", "copy_out")
host_syncs: dict[str, int] = dict.fromkeys(SYNC_SITES, 0)
iterations_run = 0


def _to_host(x: torch.Tensor, site: str, spans=None) -> torch.Tensor:
    """A host copy of ``x``: ``run_hytm``'s one way to read the device, so
    that ``host_syncs[site]`` counts every blocking read; with ``spans`` (a
    ``repro_torch.obs.record.HostSpans``) also a ``sync`` span."""
    host_syncs[site] += 1
    if spans is None:
        return x.to("cpu", copy=True)
    t = time.monotonic()
    out = x.to("cpu", copy=True)
    spans.leaf("sync", t, site=site)
    return out


def _scalar(x: float, like: torch.Tensor) -> torch.Tensor:
    # a 0-dim float32 tensor: the Python double rounds to float32 once, as
    # the reference's weak-typed scalar does
    return torch.full((), x, dtype=torch.float32, device=like.device)


# --------------------------------------------------------------------------
# One iteration
# --------------------------------------------------------------------------

def _sweep(
    state: HyTMState,
    rt: Runtime,
    program: VertexProgram,
    engines: list[int],       # (P,) host ints — NONE entries are skipped
    order: list[int],         # (P,) host processing order
    frontier: torch.Tensor,   # (n,) sources active for this sweep
    async_sweep: bool,
    consume: str,             # 'all' (pass 1) | 'processed' (pass 2)
    use_kernels: bool = False,
    spans=None,
) -> tuple[HyTMState, torch.Tensor]:
    """Relax the partitions one by one in priority order; returns the new
    state and the activated set.  A NONE partition needs no relax (its
    result is the identity) but, for SUM programs in pass 1, still
    consumes its vertices' pending Δ.  ``spans`` records each dispatch.

    A partition's block is its own ``part_edges[p]`` edges from
    ``edge_start[p]``, not the whole ``block_size`` slice: the lanes past
    them (the next partition's edges, padding, or a ``DeltaCSR`` block's
    dead tail) are inactive, so leaving them out changes no result, and
    the plain combines no longer send their identity messages to the
    padding's vertex 0, one address for every atomic."""
    n = rt.csr.n_nodes
    vertex_start, edge_start, part_edges = rt.parts.host
    values0, delta0 = state.values, state.delta
    # private copies: the SUM consumption updates partition slices in place
    values, delta = values0.clone(), delta0.clone()
    activated = torch.zeros(n, dtype=torch.bool, device=values.device)
    peel = program.peel_k is not None
    consume_sum = not peel and program.combine == SUM
    damping = _scalar(program.damping, values) if consume_sum else None

    for p in order:
        eng = engines[p]
        processed = eng != NONE
        if not processed and not (consume_sum and consume == "all"):
            continue
        if spans is not None:
            t_dispatch = time.monotonic()
        out = None
        if processed:
            start, stop = edge_start[p], edge_start[p] + part_edges[p]
            src = rt.csr.edge_src[start:stop]
            block = EdgeBlock(
                src=src,
                dst=rt.csr.edge_dst[start:stop],
                weight=rt.csr.edge_weight[start:stop],
                active=torch.index_select(frontier, 0, src),
            )
            if consume_sum:
                operand = damping * (delta if async_sweep else delta0) * rt.inv_deg
            else:
                operand = values if async_sweep else values0
            out = relax_with_engine(eng, block, operand, n, program, use_kernels)
        if spans is not None:
            t_apply = time.monotonic()

        if peel:
            # each destination's remaining degree drops by its count of
            # newly-removed in-neighbours; removal happens per iteration
            values = values - out.agg
            activated |= out.touched
        elif program.combine == MIN:
            improved = out.touched & (out.agg < values)
            values = torch.where(improved, out.agg, values)
            activated |= improved
        else:
            # consumption (rank += Δ) of the partition's active vertices,
            # a contiguous vertex range
            lo, hi = vertex_start[p], vertex_start[p + 1]
            consumed = frontier[lo:hi]
            seg_d = delta[lo:hi]
            if async_sweep:
                values[lo:hi] = values[lo:hi] + torch.where(consumed, seg_d, 0.0)
                delta[lo:hi] = torch.where(consumed, 0.0, seg_d)
            else:
                # synchronous dataflow: consume exactly the iteration-start
                # delta0, so earlier partitions' contributions survive
                d0 = delta0[lo:hi]
                values[lo:hi] = values[lo:hi] + torch.where(consumed, d0, 0.0)
                delta[lo:hi] = torch.where(consumed, seg_d - d0, seg_d)
            if out is not None:
                delta += out.agg
                activated |= out.touched
        if spans is not None:
            spans.dispatch(p, eng, part_edges[p] if processed else 0,
                           1 if consume == "all" else 2, t_dispatch, t_apply)
    return HyTMState(values=values, delta=delta, frontier=state.frontier), activated


class _Planned(NamedTuple):
    stats: PartitionStats
    plan: TaskPlan
    sched: Schedule
    delta_mass: torch.Tensor  # (P,) pending |Δ| per partition


def _plan(
    state: HyTMState,
    rt,
    program: VertexProgram,
    config: HyTMConfig,
    correction: torch.Tensor | None = None,
) -> _Planned:
    """Steps 1-4 of an iteration, on the device.  ``rt`` is a ``Runtime``
    or a ``dist.graph_shard.ShardedRuntime``: both hold the replicated
    ``parts``, ``out_degree``, ``zc_req`` and ``n_hub_partitions``.  An
    empty partition (the sharded table's padding) has zero stats, so it
    plans NONE and zero bytes, and its Δ mass is an empty segment's 0."""
    P = rt.parts.n_partitions
    frontier = state.frontier
    stats = partition_stats(frontier, rt.out_degree, rt.zc_req, rt.parts)
    if config.forced_engine is None:
        plan = generate_tasks(
            stats, config.link, combine_k=config.combine_k,
            enable_combination=config.enable_task_combination,
            correction=correction,
        )
    else:
        plan = forced_engine_plan(
            stats, config.link, config.forced_engine,
            enable_combination=config.enable_task_combination,
            combine_k=config.combine_k,
        )
    if program.combine != MIN and config.cds_mode == "delta":
        # partitions are contiguous vertex ranges: a segmented sum in index
        # order, as the reference's scatter-add adds on the CPU, instead of
        # n atomics on P addresses
        # the lengths cover the n real vertices: an owner-layout view's
        # [n, n_pad) pads are sliced off first
        delta_mass = torch.segment_reduce(
            (torch.abs(state.delta) * frontier)[:rt.parts.host[0][-1]], "sum",
            lengths=torch.diff(rt.parts.vertex_start), unsafe=True)
    else:
        delta_mass = torch.zeros(P, dtype=torch.float32, device=frontier.device)
    sched = make_schedule(plan.engines, delta_mass, rt.n_hub_partitions,
                          config.cds_mode, config.recompute_once)
    return _Planned(stats=stats, plan=plan, sched=sched, delta_mass=delta_mass)


def _fetch(planned: _Planned, prev_active: torch.Tensor | None = None, spans=None):
    """The ONE device-to-host transfer of an iteration: engines, order and
    second-pass flags, plus the previous iteration's ``next_active`` when
    given.  Returns (engines, order, second_pass, prev_active) as host
    ints (prev_active None when not given)."""
    P = planned.plan.engines.shape[0]
    parts = [planned.plan.engines, planned.sched.order,
             planned.sched.second_pass.to(torch.int32)]
    if prev_active is not None:
        parts.append(prev_active.reshape(1).to(torch.int32))
    host = _to_host(torch.cat(parts), "fetch", spans).tolist()
    prev = host[3 * P] if prev_active is not None else None
    return host[:P], host[P:2 * P], host[2 * P:3 * P], prev


def _iteration_impl(
    state: HyTMState,
    rt: Runtime,
    program: VertexProgram,
    config: HyTMConfig,
    planned: _Planned,
    host: tuple[list, list, list],
    correction: torch.Tensor | None = None,
    spans=None,
) -> tuple[HyTMState, dict[str, Any]]:
    """Steps 5-6 and the next frontier, given the planned iteration and its
    host copy (engines, order, second_pass); ``spans`` records a ``sweep``
    span a pass and the ``finish``."""
    frontier = state.frontier
    use_kernels = resolve_use_kernels(config.use_kernels, frontier.device)
    engines_h, order_h, second_h = host

    # (5) asynchronous sweep in priority order
    if spans is not None:
        t = spans.open("sweep")
    state1, activated = _sweep(
        state, rt, program, engines_h, order_h, frontier,
        config.async_sweep, consume="all", use_kernels=use_kernels, spans=spans,
    )
    if spans is not None:
        spans.close(t, **{"pass": 1})

    # (6) recompute-once: loaded priority partitions, zero extra transfer
    engines2 = [e if s else NONE for e, s in zip(engines_h, second_h)]
    if program.peel_k is not None:
        # a second peeling pass would subtract the same removals twice
        frontier2 = torch.zeros_like(frontier)
    elif program.combine == MIN:
        frontier2 = frontier | activated
    else:
        # |Δ|: warm starts may carry signed correction deltas
        frontier2 = torch.abs(state1.delta) > _scalar(program.tolerance, frontier)
    if spans is not None:
        t = spans.open("sweep")
    state2, activated2 = _sweep(
        state1, rt, program, engines2, order_h, frontier2,
        config.async_sweep, consume="processed", use_kernels=use_kernels, spans=spans,
    )
    if spans is not None:
        spans.close(t, **{"pass": 2})
        t = spans.open("finish")
    out = _finish(state2.values, state2.delta, activated | activated2, frontier,
                  planned, program, config, correction)
    if spans is not None:
        spans.close(t)
    return out


def _finish(
    values: torch.Tensor,
    delta: torch.Tensor,
    activated: torch.Tensor,
    frontier: torch.Tensor,   # the iteration's starting frontier
    planned: _Planned,
    program: VertexProgram,
    config: HyTMConfig,
    correction: torch.Tensor | None,
) -> tuple[HyTMState, dict[str, Any]]:
    """The next frontier and the iteration's info row, from the state after
    both passes (the single-device and the sharded iteration share it)."""
    stats, plan = planned.stats, planned.plan
    if program.peel_k is not None:
        # removal: alive vertices whose remaining degree fell below k
        alive = delta < 0.5
        next_frontier = alive & (values < program.peel_k)
        delta = delta + next_frontier.to(torch.float32)
    elif program.combine == MIN:
        next_frontier = activated
    else:
        next_frontier = torch.abs(delta) > _scalar(program.tolerance, frontier)
    new_state = HyTMState(values=values, delta=delta, frontier=next_frontier)

    per_engine_time, mispredictions = selection_diagnostics(
        plan.engines, plan.transfer_time, stats, plan.costs, correction,
    )
    overhead = link_constants(config.link, frontier.device)["launch_overhead_s"]
    info = {
        KEY_ENGINES: plan.engines,
        KEY_TRANSFER_BYTES: plan.transfer_bytes,
        KEY_TRANSFER_TIME: plan.transfer_time.sum()
        + plan.n_tasks.to(torch.float32) * overhead,
        KEY_N_TASKS: plan.n_tasks,
        KEY_ACTIVE_VERTICES: frontier.sum(dtype=torch.int32),
        KEY_ACTIVE_EDGES: stats.active_edges.sum(),
        "next_active": next_frontier.sum(dtype=torch.int32),
        KEY_PER_ENGINE_TIME: per_engine_time,
        KEY_MISPREDICTIONS: mispredictions,
    }
    return new_state, info


def hytm_iteration(
    state: HyTMState,
    rt: Runtime,
    program: VertexProgram,
    config: HyTMConfig,
    correction: torch.Tensor | None = None,
    spans=None,
) -> tuple[HyTMState, dict[str, Any]]:
    """One iteration (the K=1 driver's dispatch unit); ``spans`` records
    its ``iter`` and ``plan`` spans and what ``_iteration_impl`` records."""
    if spans is not None:
        t_iter = spans.open("iter")
        t = spans.open("plan")
    planned = _plan(state, rt, program, config, correction)
    if spans is not None:
        spans.close(t)
    engines, order, second, _ = _fetch(planned, spans=spans)
    out = _iteration_impl(state, rt, program, config, planned,
                          (engines, order, second), correction, spans)
    if spans is not None:
        spans.end_iteration(t_iter)
    return out


# --------------------------------------------------------------------------
# Chunked driver
# --------------------------------------------------------------------------

def chunked_while(iter_fn, plan_fn, state: HyTMState, history: dict, chunk: int,
                  fetch=_fetch, spans=None):
    """Run up to ``chunk`` iterations: ``plan_fn(state) -> planned``,
    ``fetch(planned, prev_active) -> (*host, prev)`` and
    ``iter_fn(state, planned, host) -> (state, info)``, writing iteration
    ``i``'s info into ``history[k][i]`` and summing the (3,) per-engine
    modeled seconds.  The early-exit test reads the *previous* iteration's
    ``next_active`` from the same transfer that brings the next plan to
    the host (no previous iteration at the chunk start: the first one
    always runs).

    ``spans`` records each iteration's ``iter`` and ``plan`` spans; an
    iteration planned and not run leaves its plan and fetch to the chunk.

    Returns ``(state, history, n_done, last_next_active, per_engine_sum)``
    with ``last_next_active`` a device tensor (None if nothing ran)."""
    per_engine_sum = None
    prev_active = None
    n_done = 0
    while n_done < chunk:
        if spans is not None:
            t_iter = spans.open("iter")
            t = spans.open("plan")
        planned = plan_fn(state)
        if spans is not None:
            spans.close(t)
        *host, prev = fetch(planned, prev_active)
        if prev == 0:
            if spans is not None:
                spans.abandon()
            break
        state, info = iter_fn(state, planned, tuple(host))
        for k, buf in history.items():
            buf[n_done] = info[k]
        pe = info[KEY_PER_ENGINE_TIME]
        per_engine_sum = pe if per_engine_sum is None else per_engine_sum + pe
        prev_active = info["next_active"]
        n_done += 1
        if spans is not None:
            spans.end_iteration(t_iter)
    return state, history, n_done, prev_active, per_engine_sum


def hytm_chunk(
    state: HyTMState,
    history: dict[str, torch.Tensor],   # key -> (chunk, ...) preallocated
    rt: Runtime,
    program: VertexProgram,
    config: HyTMConfig,
    chunk: int,
    correction: torch.Tensor | None = None,
    spans=None,
):
    """Up to ``chunk`` iterations with device-side history; see
    ``chunked_while``.  Rows at index >= ``n_done`` are stale."""
    return chunked_while(
        lambda st, planned, host: _iteration_impl(
            st, rt, program, config, planned, host, correction, spans),
        lambda st: _plan(st, rt, program, config, correction),
        state, history, chunk,
        fetch=functools.partial(_fetch, spans=spans), spans=spans,
    )


# --------------------------------------------------------------------------
# Lane-batched chunk (graph serving)
# --------------------------------------------------------------------------

class _LaneUpload:
    """Host ints of one iteration's lane groups, gathered into ONE int64
    tensor and copied to the device once (pinned, asynchronous: no sync);
    ``add`` returns where a run of ints starts."""

    def __init__(self):
        self.ints: list[int] = []

    def add(self, ints) -> int:
        pos = len(self.ints)
        self.ints.extend(ints)
        return pos

    def upload(self, device: torch.device) -> torch.Tensor:
        host = torch.tensor(self.ints, dtype=torch.int64)
        if device.type != "cuda":
            return host
        return host.pin_memory().to(device, non_blocking=True)


def _lane_group(table: torch.Tensor, pos: int, lengths: tuple) -> LaneGroup:
    """The ``LaneGroup`` whose (rows, starts, counts, offsets) run of
    ``4L + 1`` ints starts at ``pos`` of the uploaded table."""
    L = len(lengths)
    return LaneGroup(rows=table[pos:pos + L], starts=table[pos + L:pos + 2 * L],
                     counts=table[pos + 2 * L:pos + 3 * L],
                     offsets=table[pos + 3 * L:pos + 4 * L + 1],
                     lengths=lengths, total=sum(lengths))


def _lane_steps(upload: _LaneUpload, rt, engines: list, order: list,
                consume: str | None, p_offset: int = 0, edge_base: int = 0) -> list:
    """One pass's steps: step j relaxes partition ``order[q][j]`` of every
    lane q with that lane's engine, grouped by engine, so a step issues at
    most one call per engine whatever the lane count; NONE partitions relax
    nothing.  Returns per step ``(groups, consumed)``: ``groups`` is
    ``[(engine, pos, lengths)]``, ``consumed`` the (pos, lengths) of the
    lanes whose partition's vertex range consumes its pending Δ at this
    step, or None.  ``consume`` is ``_sweep``'s: "all" (pass 1 of a SUM
    program: every lane), "processed" (pass 2: the lanes that relax), or
    None (no consumption).  A sharded rank passes its local engines and
    orders with ``p_offset`` (its first partition's global id) and
    ``edge_base`` (its first edge's global index): the lane starts then
    index its rank-local edge columns."""
    vertex_start, edge_start, part_edges = rt.parts.host

    def add(lanes, starts, lengths):
        offsets = list(itertools.accumulate(lengths, initial=0))
        return upload.add([q for q, _ in lanes] + starts + lengths + offsets), tuple(lengths)

    steps = []
    for j in range(len(order[0]) if order else 0):
        by_engine: dict[int, list[tuple[int, int]]] = {}
        cons = []
        for q, (eq, oq) in enumerate(zip(engines, order)):
            p = oq[j]
            if eq[p] != NONE:
                by_engine.setdefault(eq[p], []).append((q, p))
            if consume == "all" or (consume == "processed" and eq[p] != NONE):
                cons.append((q, p))
        groups = [(e, *add(lanes, [edge_start[p_offset + p] - edge_base for _, p in lanes],
                           [part_edges[p_offset + p] for _, p in lanes]))
                  for e, lanes in sorted(by_engine.items())]
        consumed = (add(cons, [vertex_start[p] for _, p in cons],
                        [vertex_start[p + 1] - vertex_start[p] for _, p in cons])
                    if cons else None)
        if groups or consumed:
            steps.append((groups, consumed))
    return steps


def _lane_sweep(
    state: HyTMState,
    rt: Runtime,
    program: VertexProgram,
    steps: list,
    table: torch.Tensor,
    frontier: torch.Tensor,   # (Q, n) sources active for this sweep
    async_sweep: bool,
    use_kernels: bool,
) -> tuple[HyTMState, torch.Tensor]:
    """``_sweep`` for a (Q, n) lane-stacked state: at step j every lane
    relaxes its own j-th partition (``_lane_steps``), each engine's lanes in
    one ``relax_lanes`` call, and the (L, n) results update the lanes' rows.
    Lanes never interact and each keeps its own order, so every row equals
    its lane's ``_sweep`` (the async sweep stays a scan over a lane's
    partitions: relaxing them all in one launch would compute the
    ``async_sweep=False`` dataflow).  For SUM programs a step relaxes, then
    consumes each lane's partition range, then adds the messages, as
    ``_sweep`` does a partition."""
    n = rt.csr.n_nodes
    values0, delta0 = state.values, state.delta
    values, delta = values0.clone(), delta0.clone()
    flat_v, flat_d, flat_f = values.view(-1), delta.view(-1), frontier.view(-1)
    activated = torch.zeros_like(frontier)
    peel = program.peel_k is not None
    consume_sum = not peel and program.combine == SUM
    if consume_sum:
        damping = _scalar(program.damping, values)
        src_delta = (delta if async_sweep else delta0).view(-1)

        def operand_at(flat, src):
            return damping * torch.index_select(src_delta, 0, flat) \
                * torch.index_select(rt.inv_deg, 0, src)
    else:
        src_values = (values if async_sweep else values0).view(-1)

        def operand_at(flat, src):
            return torch.index_select(src_values, 0, flat)

    for groups, consumed in steps:
        outs = []
        for eng, pos, lengths in groups:
            group = _lane_group(table, pos, lengths)
            out = relax_lanes(eng, group, rt.csr, frontier, operand_at, program, use_kernels)
            rows = group.rows
            if peel:
                values.index_copy_(0, rows, torch.index_select(values, 0, rows) - out.agg)
                touched = out.touched
            elif program.combine == MIN:
                v = torch.index_select(values, 0, rows)
                touched = out.touched & (out.agg < v)
                values.index_copy_(0, rows, torch.where(touched, out.agg, v))
            else:
                outs.append((rows, out))
                continue
            activated.index_copy_(0, rows, torch.index_select(activated, 0, rows) | touched)
        if consumed is not None:
            cg = _lane_group(table, *consumed)
            lane, idx = packed_ranges(cg.starts, cg.offsets, cg.total)
            flat = torch.index_select(cg.rows, 0, lane) * n + idx
            active = torch.index_select(flat_f, 0, flat)
            seg_d = torch.index_select(flat_d, 0, flat)
            seg_v = torch.index_select(flat_v, 0, flat)
            if async_sweep:
                flat_v.index_copy_(0, flat, seg_v + torch.where(active, seg_d, 0.0))
                flat_d.index_copy_(0, flat, torch.where(active, 0.0, seg_d))
            else:
                d0 = torch.index_select(delta0.view(-1), 0, flat)
                flat_v.index_copy_(0, flat, seg_v + torch.where(active, d0, 0.0))
                flat_d.index_copy_(0, flat, torch.where(active, seg_d - d0, seg_d))
        for rows, out in outs:
            delta.index_copy_(0, rows, torch.index_select(delta, 0, rows) + out.agg)
            activated.index_copy_(0, rows, torch.index_select(activated, 0, rows) | out.touched)
    return HyTMState(values=values, delta=delta, frontier=state.frontier), activated


def _lane_plans(state: HyTMState, rt: Runtime, program: VertexProgram,
                config: HyTMConfig, correction) -> list[_Planned]:
    """Each lane's ``_plan`` on its own row: the same function on the same
    row, so every lane's engines, order, second-pass flags, bytes and times
    equal its solo iteration's bit for bit."""
    return [_plan(HyTMState(values=state.values[q], delta=state.delta[q],
                            frontier=state.frontier[q]), rt, program, config, correction)
            for q in range(state.values.shape[0])]


def _fetch_lanes(plans: list[_Planned], prev_active: torch.Tensor | None):
    """The ONE device-to-host transfer of a lane-batched iteration: every
    lane's (P,) engines, order and second-pass flags, as (Q, P) stacks,
    plus the previous iteration's (Q,) ``next_active`` when given.  Returns
    host lists (engines, order, second_pass, prev_active) of Q rows."""
    Q = len(plans)
    P = plans[0].plan.engines.shape[0]
    parts = [torch.stack([pl.plan.engines for pl in plans]).reshape(-1),
             torch.stack([pl.sched.order for pl in plans]).reshape(-1),
             torch.stack([pl.sched.second_pass for pl in plans]).to(torch.int32).reshape(-1)]
    if prev_active is not None:
        parts.append(prev_active.to(torch.int32))
    host = _to_host(torch.cat(parts), "fetch").tolist()

    def rows(k):
        return [host[k * Q * P + q * P:k * Q * P + (q + 1) * P] for q in range(Q)]

    prev = host[3 * Q * P:] if prev_active is not None else None
    return rows(0), rows(1), rows(2), prev


def _lane_iteration(state: HyTMState, rt: Runtime, program: VertexProgram,
                    config: HyTMConfig, plans: list[_Planned], host, correction):
    """Steps 5-6 and the next frontier of a lane-batched iteration, given
    every lane's plan and their host copy; returns the new state, the (Q,)
    ``next_active`` and the lanes' (3,) per-engine seconds and
    mispredictions summed over the lanes."""
    frontier = state.frontier
    use_kernels = resolve_use_kernels(config.use_kernels, frontier.device)
    engines_h, order_h, second_h = host
    consume_sum = program.peel_k is None and program.combine == SUM
    upload = _LaneUpload()
    steps1 = _lane_steps(upload, rt, engines_h, order_h, "all" if consume_sum else None)
    engines2 = [[e if f else NONE for e, f in zip(eq, sq)] for eq, sq in zip(engines_h, second_h)]
    steps2 = _lane_steps(upload, rt, engines2, order_h, "processed" if consume_sum else None)
    table = upload.upload(frontier.device)

    state1, activated = _lane_sweep(state, rt, program, steps1, table, frontier,
                                    config.async_sweep, use_kernels)
    if program.peel_k is not None:
        frontier2 = torch.zeros_like(frontier)
    elif program.combine == MIN:
        frontier2 = frontier | activated
    else:
        frontier2 = torch.abs(state1.delta) > _scalar(program.tolerance, frontier)
    state2, activated2 = _lane_sweep(state1, rt, program, steps2, table, frontier2,
                                     config.async_sweep, use_kernels)
    activated |= activated2

    if program.peel_k is not None:
        alive = state2.delta < 0.5
        next_frontier = alive & (state2.values < program.peel_k)
        new_state = HyTMState(values=state2.values,
                              delta=state2.delta + next_frontier.to(torch.float32),
                              frontier=next_frontier)
    else:
        if program.combine == MIN:
            next_frontier = activated
        else:
            next_frontier = torch.abs(state2.delta) > _scalar(program.tolerance, frontier)
        new_state = HyTMState(values=state2.values, delta=state2.delta, frontier=next_frontier)

    diags = [selection_diagnostics(pl.plan.engines, pl.plan.transfer_time, pl.stats,
                                   pl.plan.costs, correction) for pl in plans]
    per_engine = torch.stack([d[0] for d in diags]).sum(dim=0)
    mispredictions = torch.stack([d[1] for d in diags]).sum(dtype=torch.int32)
    return new_state, next_frontier.sum(dim=1, dtype=torch.int32), per_engine, mispredictions


def hytm_batched_chunk(
    state: HyTMState,        # (Q, n) lane-stacked
    rt: Runtime,
    program: VertexProgram,
    config: HyTMConfig,
    chunk: int,
    correction: torch.Tensor | None = None,
):
    """Chunked *lane-batched* sweep, the dispatch unit of graph serving:
    up to ``chunk`` iterations over a state whose leading dimension stacks
    Q independent source lanes.  The loop runs while fewer than ``chunk``
    iterations ran and any lane is active; the first iteration always runs.

    Each iteration plans every lane on its own row (``_plan``: cost model,
    tasks, schedule), copies every lane's engines, order and second-pass
    flags to the host in ONE transfer (with the previous iteration's (Q,)
    ``next_active``, the early-exit test), uploads the lane groups' host
    ints in one asynchronous copy, and sweeps the lanes in step
    (``_lane_sweep``): launches per iteration do not grow with Q.  Lanes
    never interact, so every lane's trajectory equals its solo ``run_hytm``
    (bit for bit for MIN programs and k-core, within float tolerance for
    SUM on CUDA), whatever the other lanes do; a dead lane (empty
    frontier, ``dead_lane_state``) plans NONE everywhere, launches nothing
    and reports 0.

    Returns ``(state, n_done, lane_active, per_engine_sum, mispred_sum)``:
    ``n_done`` a host int, ``lane_active`` the (Q,) int32 ``next_active``
    of the last iteration (on the device), ``per_engine_sum`` the (3,)
    per-engine modeled seconds summed over lanes (a (Q, 3) sum over the
    lane axis each iteration, in the reference's order up to float
    association) and iterations, ``mispred_sum`` an int32 0-dim tensor.
    The input state is not modified."""
    Q = state.values.shape[0]
    dev = state.values.device
    pe_sum = torch.zeros(3, dtype=torch.float32, device=dev)
    mp_sum = torch.zeros((), dtype=torch.int32, device=dev)
    lane_active = None
    n_done = 0
    while n_done < chunk:
        plans = _lane_plans(state, rt, program, config, correction)
        engines, order, second, prev = _fetch_lanes(plans, lane_active)
        if prev is not None and not any(prev):
            break
        state, lane_active, pe, mp = _lane_iteration(
            state, rt, program, config, plans, (engines, order, second), correction)
        pe_sum = pe_sum + pe
        mp_sum = mp_sum + mp
        n_done += 1
    if lane_active is None:
        lane_active = torch.zeros(Q, dtype=torch.int32, device=dev)
    return state, n_done, lane_active, pe_sum, mp_sum


def dead_lane_state(program: VertexProgram, n: int,
                    device: str | torch.device | None = None) -> tuple:
    """The (values, delta, frontier) triple of a *dead* padding lane: an
    empty frontier and zero pending Δ, so every iteration is a no-op."""
    dev = resolve_device(device)
    if program.use_delta:
        values = torch.zeros(n, dtype=torch.float32, device=dev)
    else:
        values = torch.full((n,), float("inf"), dtype=torch.float32, device=dev)
    return (values, torch.zeros(n, dtype=torch.float32, device=dev),
            torch.zeros(n, dtype=torch.bool, device=dev))


@contextlib.contextmanager
def count_driver_dispatches():
    """Count convergence-driver dispatches by swapping the module-level
    entry points (``run_hytm`` resolves both at call time).  Yields a live
    ``{"iteration": n, "chunk": n}`` dict."""
    mod = sys.modules[__name__]
    counts = {"iteration": 0, "chunk": 0}
    orig_iter, orig_chunk = mod.hytm_iteration, mod.hytm_chunk

    def count_iter(*a, **kw):
        counts["iteration"] += 1
        return orig_iter(*a, **kw)

    def count_chunk(*a, **kw):
        counts["chunk"] += 1
        return orig_chunk(*a, **kw)

    mod.hytm_iteration, mod.hytm_chunk = count_iter, count_chunk
    try:
        yield counts
    finally:
        mod.hytm_iteration, mod.hytm_chunk = orig_iter, orig_chunk


# Dispatch signatures already run in this process.  The first dispatch of
# a signature pays for what a later one does not: the kernels' nvcc build
# on first use, CUDA module loading and allocator growth (the reference's
# trace and compile), so its wall time must not feed the online calibrator.
_WARM_SIGNATURES: set = set()


def _consume_warm(signature, registry: set | None = None) -> bool:
    """True if ``signature`` was dispatched before in this process (or in
    ``registry``, when given); marks it warm either way."""
    reg = _WARM_SIGNATURES if registry is None else registry
    warm = signature in reg
    reg.add(signature)
    return warm


# --------------------------------------------------------------------------
# Convergence loop
# --------------------------------------------------------------------------

@dataclass
class HyTMResult:
    values: np.ndarray
    delta: np.ndarray
    iterations: int
    wall_seconds: float
    modeled_seconds: float
    total_transfer_bytes: float
    history: dict[str, np.ndarray]  # per-iteration arrays
    total_ici_bytes: float = 0.0      # sharded sweep only
    modeled_ici_seconds: float = 0.0  # sharded sweep only
    total_mispredictions: int = 0
    engine_corrections: np.ndarray | None = None


def run_hytm(
    g: CSRGraph | None,
    program: VertexProgram,
    source: int | None = 0,
    config: HyTMConfig = HyTMConfig(),
    n_hubs: int = 0,
    runtime: Runtime | None = None,
    mesh=None,
    initial_state: HyTMState | None = None,
    calibrator=None,
    obs=None,
    faults=None,
    retry=None,
    on_chunk=None,
    device: str | torch.device | None = None,
) -> HyTMResult:
    """Run the HyTM convergence loop on one device.

    ``runtime`` lets callers amortize preprocessing across runs (then ``g``
    may be ``None``, and the runtime's device is used).  Otherwise the graph
    is uploaded to ``device`` — ``cuda`` unless the caller passes
    ``device="cpu"``; with no card that raises.  WCC-family programs
    symmetrize ``g`` first; k-core seeds its state from the runtime's
    degrees.

    ``initial_state`` warm-starts the loop from a (values, Δ, frontier)
    triple on the runtime's device; it is not modified.

    With ``config.autotune`` the run learns per-engine cost corrections
    from its measured chunk (K > 1) or iteration (K = 1) times into
    ``calibrator`` (a ``repro_torch.autotune.OnlineCalibrator``, or any
    object with its ``correction``/``observe_chunk``/``observe_iteration``
    methods), or into a fresh one; it starts from the calibrator's current
    correction and returns the final one in ``engine_corrections``.
    ``calibrator`` is read only with ``config.autotune``.  The first
    dispatch of a chunk signature in the process, and iteration 1 of the
    K = 1 loop, are not observed.

    ``obs`` (a ``repro_torch.obs.TraceRecorder``) records one instant per
    iteration (at its wall start), one span per chunk and the run-summary
    span on track ``device0``, from the history rows the loop copies to
    the host anyway, and the host spans of ``obs.record.HostSpans``
    (``CAT_HOST``: each iteration, its plan, sweeps, partition dispatches
    and finish, and every blocking read): it adds no launch, copy or sync,
    and the run's results are bit-identical to an untraced one.
    ``obs.export.reconcile`` holds its totals to the result exactly.

    ``faults``/``retry`` (a ``repro_torch.resilience.FaultPlan`` and
    ``RetryPolicy``) guard every chunk dispatch (K > 1) or iteration
    (K = 1) at site ``"chunk_dispatch"``: an injected fault fires before
    the dispatch, and a chunk never modifies its input state, so a retried
    dispatch is bit-identical.  ``faults=None`` takes the unguarded path:
    no extra launch, copy or sync.

    ``on_chunk`` (the attachment point of
    ``repro_torch.resilience.CheckpointHook``; chunked driver only) is
    called at every chunk boundary, after the history drain and the obs
    records and before the convergence test, with ``state`` (the live
    device state), ``iterations``, ``rows`` (the drained host history so
    far), ``calibrator`` and ``last_active``.

    With ``config.mesh_axis`` set the run is the sharded sweep over
    ``mesh`` (a ``launch.mesh.GraphMesh``; every rank of its group calls
    ``run_hytm`` with the same arguments): ``dist.graph_shard
    .run_hytm_sharded``, whose device is the mesh's.  Without
    ``mesh_axis``, ``mesh`` is not read (the supervisor's
    ``mesh->single-device`` rung relies on that).
    """
    if config.mesh_axis is not None:
        # late import: graph_shard builds on this module
        from repro_torch.dist.graph_shard import run_hytm_sharded

        return run_hytm_sharded(
            g, program, source=source, config=config, n_hubs=n_hubs,
            mesh=mesh, runtime=runtime, calibrator=calibrator,
            initial_state=initial_state, obs=obs, faults=faults, retry=retry,
            on_chunk=on_chunk, device=device)
    if config.sync_every < 1:
        raise ValueError(f"sync_every must be >= 1, got {config.sync_every}")
    if on_chunk is not None and config.sync_every == 1:
        raise ValueError(
            "on_chunk (checkpointing) requires the chunked driver: set sync_every >= 2")
    if runtime is not None:
        rt = runtime
        if device is not None and resolve_device(device).type != rt.device.type:
            raise ValueError(f"runtime lives on {rt.device}, not {device}")
    elif g is None:
        raise ValueError("run_hytm needs a graph or a prebuilt runtime")
    else:
        if program.symmetrize:
            g = g.symmetrize()
        rt = build_runtime(
            g, config, n_hubs=n_hubs,
            weighted_norm=program.use_delta and program.weighted, device=device,
        )
    if initial_state is None:
        if program.peel_k is not None:
            deg = rt.csr.out_degree.to(torch.float32)
            removed = deg < program.peel_k
            state = HyTMState(values=deg, delta=removed.to(torch.float32),
                              frontier=removed)
        else:
            values, delta, frontier = program.init_state(
                rt.csr.n_nodes, source, rt.device)
            state = HyTMState(values=values, delta=delta, frontier=frontier)
    else:
        state = initial_state
        if state.values.device.type != rt.device.type:
            raise ValueError(
                f"initial_state lives on {state.values.device}, the runtime on "
                f"{rt.device}")

    calib = None
    correction = None
    if config.autotune:
        if calibrator is None:
            from repro_torch.autotune.feedback import OnlineCalibrator

            calibrator = OnlineCalibrator(decay=config.autotune_decay)
        calib = calibrator
        # float64 -> float32 rounds to nearest, as the reference's
        # jnp.asarray(c, jnp.float32)
        correction = torch.from_numpy(
            np.asarray(calib.correction(), np.float64).astype(np.float32)).to(rt.device)

    rows: dict[str, list] = {k: [] for k in HISTORY_KEYS}
    # late import: the resilience package's checkpoint module imports
    # dist.graph_shard, which builds on this module
    from repro_torch.resilience.supervisor import guarded_dispatch

    spans = None
    if obs is not None:
        from repro_torch.obs.record import HostSpans, record_history_rows

        spans = HostSpans(obs)

    # the fault plane's ``when={"kernels": ...}`` context
    use_kernels = resolve_use_kernels(config.use_kernels, rt.device)
    t0 = time.monotonic()
    iters = 0
    if config.sync_every > 1:
        shapes = history_shapes(rt.parts.n_partitions)
        history, cur_chunk = None, -1
        while iters < config.max_iters:
            chunk = min(config.sync_every, config.max_iters - iters)
            if chunk != cur_chunk:
                history = init_history_buffers(shapes, chunk, device=rt.device)
                cur_chunk = chunk
            # the reference's jit cache key: statics and every shape
            warm = _consume_warm((
                "chunk", program, config, rt.n_hub_partitions, chunk,
                rt.csr.n_nodes, rt.csr.capacity, rt.parts.n_partitions,
                rt.parts.block_size, correction is not None,
            ))
            t_chunk = time.monotonic()
            if spans is not None:
                spans.open("chunk")  # recorded by record_chunk
            state, history, n_done, last_active, pe_sum = guarded_dispatch(
                functools.partial(hytm_chunk, state, history, rt, program,
                                  config, chunk, correction, spans),
                site="chunk_dispatch", faults=faults, policy=retry, obs=obs,
                mesh=False, kernels=use_kernels)
            iters += n_done
            if calib is not None:
                # before the history drain, so the window covers dispatch
                # and execution only
                correction = calib.observe_chunk(
                    state.values, _to_host(pe_sum, "calib", spans).numpy().astype(float),
                    t_chunk, skip=not warm)
            for k in rows:
                # a copy: the buffers are reused by the next chunk
                rows[k].append(_to_host(history[k][:n_done], "drain", spans).numpy())
            active = int(_to_host(last_active, "active", spans))
            if spans is not None:
                from repro_torch.obs.record import record_chunk

                spans.leave()
                spans.flush()
                record_history_rows(obs, {k: v[-1] for k, v in rows.items()},
                                    n_done, iters - n_done,
                                    walls=spans.iteration_walls(iters - n_done, n_done))
                record_chunk(
                    obs, track="device0", wall_start=obs.wall_at(t_chunk),
                    wall_dur=obs.wall() - obs.wall_at(t_chunk),
                    start_iter=iters - n_done, n_done=n_done, warm=warm,
                )
            if on_chunk is not None:
                on_chunk(state=state, iterations=iters, rows=rows,
                         calibrator=calib, last_active=active)
            if active == 0:
                break
        history = {k: np.concatenate(v) for k, v in rows.items()}
    else:
        for _ in range(config.max_iters):
            t_iter = time.monotonic()
            state, info = guarded_dispatch(
                functools.partial(hytm_iteration, state, rt, program, config,
                                  correction, spans=spans),
                site="chunk_dispatch", faults=faults, policy=retry, obs=obs,
                mesh=False, kernels=use_kernels)
            iters += 1
            if calib is not None:
                correction = calib.observe_iteration(
                    state.values, info[KEY_PER_ENGINE_TIME], t_iter,
                    skip=iters == 1)
            for k in rows:
                rows[k].append(info[k])
            if int(_to_host(info["next_active"], "active", spans)) == 0:
                break
        history = {k: _to_host(torch.stack(v), "history", spans).numpy()
                   for k, v in rows.items()}
        if obs is not None:
            record_history_rows(obs, history, iters, 0,
                                walls=spans.iteration_walls(0, iters))
    global iterations_run
    iterations_run += iters
    values = _to_host(state.values, "copy_out", spans).numpy()
    delta = _to_host(state.delta, "copy_out", spans).numpy()
    wall = time.monotonic() - t0
    result = HyTMResult(
        values=values,
        delta=delta,
        iterations=iters,
        wall_seconds=wall,
        modeled_seconds=float(np.sum(history[KEY_TRANSFER_TIME])),
        total_transfer_bytes=float(np.sum(history[KEY_TRANSFER_BYTES])),
        history=history,
        total_mispredictions=int(np.sum(history[KEY_MISPREDICTIONS])),
        engine_corrections=calib.correction() if calib is not None else None,
    )
    if obs is not None:
        from repro_torch.obs.record import record_run

        spans.flush()
        record_run(obs, result, track="device0", wall_start=obs.wall_at(t0),
                   wall_dur=wall, program=program.name)
    return result
