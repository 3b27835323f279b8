"""The three transfer/processing engines (paper §II-B/C, Fig. 2).

All three relax the *same* active edges and produce the same result; they
differ in how the edge bytes travel:

* ``FILTER``   — stream the whole partition block; inactive edges ride
  along and are masked in compute.  Kernel path: the destination combine
  runs in ``kernels/segment_spmm``.
* ``COMPACT``  — squeeze the active edges to the front of the block
  (stable stream compaction), then relax the dense prefix.  Kernel path:
  ``kernels/frontier_compact``.
* ``ZEROCOPY`` — fine-grained per-window gathers of the edge fields.
  Kernel path: ``kernels/hyb_gather``.

Each engine has two implementations behind ``use_kernels``:

* ``False`` — the plain *oracles*: ``scatter_reduce_``/``index_add_``
  combines, a stable argsort for COMPACT, an identity ``take`` for
  ZEROCOPY;
* ``True``  — the kernel wrappers (which run their plain versions on CPU
  tensors).  As in the reference, COMPACT and ZEROCOPY combine with the
  plain ``_combine`` after their kernel.  Both kernels take the block's
  columns as they are, so no packed copy is made.

The lane-batched relaxes (``relax_lanes``, graph serving) take L lanes
of a (Q, n) lane-stacked state that each relax one partition with the same
engine, in one call a step: their edges packed lane after lane, with the
lane entries of ``segment_spmm`` and ``frontier_compact`` and one
``hyb_gather`` request list for all lanes' windows.

Contract: the kernel path is bit-identical to the oracle for MIN combiners
(min is order-free; both compactions are stable) and tolerance-bounded for
SUM on CUDA, where float atomics add in varying order.
"""

from __future__ import annotations

import functools
from typing import NamedTuple

import torch

from repro_torch.graph.algorithms import MIN, VertexProgram


class EdgeBlock(NamedTuple):
    """One partition's edge block."""

    src: torch.Tensor     # (B,) int32
    dst: torch.Tensor     # (B,) int32
    weight: torch.Tensor  # (B,) float32
    active: torch.Tensor  # (B,) bool — source active AND edge in partition


class RelaxOut(NamedTuple):
    agg: torch.Tensor      # (n,) combined messages
    touched: torch.Tensor  # (n,) bool — destinations receiving any message


def _messages(block: EdgeBlock, operand: torch.Tensor, program: VertexProgram) -> torch.Tensor:
    """Per-edge messages; inactive lanes emit the combiner identity."""
    msg = program.edge_message(torch.index_select(operand, 0, block.src), block.weight)
    identity = float("inf") if program.combine == MIN else 0.0
    return torch.where(block.active, msg, identity)


def _combine(block: EdgeBlock, msg: torch.Tensor, n: int, program: VertexProgram) -> RelaxOut:
    dst = block.dst.long()
    if program.combine == MIN:
        agg = torch.full((n,), float("inf"), dtype=msg.dtype, device=msg.device)
        agg.scatter_reduce_(0, dst, msg, "amin")
        return RelaxOut(agg=agg, touched=torch.isfinite(agg))
    agg = torch.zeros(n, dtype=msg.dtype, device=msg.device).index_add_(0, dst, msg)
    got = torch.zeros(n, dtype=torch.float32, device=msg.device).index_add_(
        0, dst, block.active.to(torch.float32))
    return RelaxOut(agg=agg, touched=got > 0)


def _combine_spmm(block: EdgeBlock, msg: torch.Tensor, n: int, program: VertexProgram) -> RelaxOut:
    """Destination combine through the ``segment_spmm`` kernel.  MIN: the
    identity-masked messages with d=1.  SUM: packed (B, 2) [message,
    active] columns, so the 0/1 activity column keeps ``touched`` exact."""
    from repro_torch.kernels.segment_spmm.ops import segment_spmm

    if program.combine == MIN:
        agg = segment_spmm(msg, block.dst, n, combine="min")
        return RelaxOut(agg=agg, touched=torch.isfinite(agg))
    packed = torch.stack([msg, block.active.to(msg.dtype)], dim=-1)
    out = segment_spmm(packed, block.dst, n)
    return RelaxOut(agg=out[:, 0], touched=out[:, 1] > 0)


def relax_filter(
    block: EdgeBlock, operand: torch.Tensor, n: int, program: VertexProgram,
    use_kernels: bool = False,
) -> RelaxOut:
    """Whole-block masked relax (dense stream)."""
    msg = _messages(block, operand, program)
    if use_kernels:
        return _combine_spmm(block, msg, n, program)
    return _combine(block, msg, n, program)


def relax_compact(
    block: EdgeBlock, operand: torch.Tensor, n: int, program: VertexProgram,
    use_kernels: bool = False,
) -> RelaxOut:
    """Compact active edges to the front (stable), then relax the block.
    The kernel moves the four columns, ``active`` among them, as raw words
    and flags, and writes the inactive lanes after the kept ones in their
    order, as the plain argsort does: the two paths give the same block."""
    if use_kernels:
        from repro_torch.kernels.frontier_compact.ops import frontier_compact

        compacted = EdgeBlock(*frontier_compact(block, block.active)[0])
    else:
        order = torch.argsort((~block.active).to(torch.uint8), stable=True)
        compacted = EdgeBlock(
            src=block.src[order],
            dst=block.dst[order],
            weight=block.weight[order],
            active=block.active[order],
        )
    return _combine(compacted, _messages(compacted, operand, program), n, program)


@functools.lru_cache(maxsize=256)  # a block per partition, DeltaCSR patches
def _windows(B: int, device: torch.device) -> tuple[torch.Tensor, torch.Tensor]:
    """The block as PAD-lane requests: (starts, degrees), int32."""
    from repro_torch.kernels.hyb_gather.ops import PAD

    starts = torch.arange(0, -(-B // PAD) * PAD, PAD, dtype=torch.int32, device=device)
    return starts, torch.clamp(B - starts, max=PAD)


def relax_zerocopy(
    block: EdgeBlock, operand: torch.Tensor, n: int, program: VertexProgram,
    use_kernels: bool = False,
) -> RelaxOut:
    """Fine-grained gather relax: the edge fields are re-fetched, then
    combined.  The kernel path issues the block as PAD-lane windows
    through ``hyb_gather``, each column as raw words or flags."""
    if use_kernels:
        from repro_torch.kernels.hyb_gather.ops import hyb_gather

        B = block.src.shape[0]
        cols = hyb_gather(block, *_windows(B, block.src.device))
        gathered = EdgeBlock(*(col.reshape(-1)[:B] for col in cols))
    else:
        idx = torch.arange(block.src.shape[0], device=block.src.device)
        gathered = EdgeBlock(
            src=torch.take(block.src, idx),
            dst=torch.take(block.dst, idx),
            weight=torch.take(block.weight, idx),
            active=torch.take(block.active, idx),
        )
    return _combine(gathered, _messages(gathered, operand, program), n, program)


ENGINE_FNS = (relax_filter, relax_compact, relax_zerocopy)


def relax_with_engine(
    engine_id: int,  # host int: 0 filter / 1 compact / 2 zerocopy (NONE -> 0)
    block: EdgeBlock,
    operand: torch.Tensor,
    n: int,
    program: VertexProgram,
    use_kernels: bool = False,
) -> RelaxOut:
    return ENGINE_FNS[min(max(int(engine_id), 0), 2)](
        block, operand, n, program, use_kernels)


# --------------------------------------------------------------------------
# Lane-batched relax (graph serving)
# --------------------------------------------------------------------------

class LaneGroup(NamedTuple):
    """L lanes of a (Q, n) lane-stacked state that relax one partition each
    with one engine, in one call: lane l is row ``rows[l]`` and relaxes the
    ``lengths[l]`` edges from edge ``starts[l]``.  The device tensors are
    int64 (views of one per-iteration upload); ``lengths`` and ``total``
    are their host copies, which size the packed arrays without a sync."""

    rows: torch.Tensor      # (L,) rows in the (Q, n) state
    starts: torch.Tensor    # (L,) first edge of each lane's partition
    counts: torch.Tensor    # (L,) edges of each lane's partition
    offsets: torch.Tensor   # (L+1,) packed offsets: 0, cumsum(counts)
    lengths: tuple          # host copy of ``counts``
    total: int              # sum(lengths)


def packed_ranges(starts: torch.Tensor, offsets: torch.Tensor,
                  total: int) -> tuple[torch.Tensor, torch.Tensor]:
    """Ranges ``[starts[l], starts[l] + offsets[l+1] - offsets[l])`` packed
    lane after lane: (lane of each packed position, its index), int64,
    ``total`` (host-known) long.  A position's lane is the number of lane
    ends at or before it (a binary search of the (L+1,) offsets, one thread
    a position; empty lanes own no position).  ``repeat_interleave`` gives
    the same lanes but on CUDA gives each lane's run to one warp: 148 of
    994 ms of a traced 8-lane SSSP serving run on the H100."""
    pos = torch.arange(total, dtype=torch.int64, device=offsets.device)
    lane = torch.searchsorted(offsets[1:], pos, right=True)
    return lane, starts.index_select(0, lane) + (pos - offsets.index_select(0, lane))


class LaneEdges(NamedTuple):
    """A lane group's edges packed lane after lane, with each edge's lane
    and the flat (Q * n) index of its source in its lane's row."""

    block: EdgeBlock
    lane: torch.Tensor     # (M,) int64 lane in the group
    row_off: torch.Tensor  # (M,) int64: rows[lane] * n


def lane_edges(group: LaneGroup, csr, frontier: torch.Tensor) -> LaneEdges:
    """Gather the group's edges from the CSR columns by the packed edge
    index; ``active`` is the source's flag in its lane's frontier row."""
    n = frontier.shape[1]
    lane, idx = packed_ranges(group.starts, group.offsets, group.total)
    src = torch.index_select(csr.edge_src, 0, idx)
    row_off = torch.index_select(group.rows, 0, lane) * n
    block = EdgeBlock(
        src=src,
        dst=torch.index_select(csr.edge_dst, 0, idx),
        weight=torch.index_select(csr.edge_weight, 0, idx),
        active=torch.index_select(frontier.view(-1), 0, row_off + src),
    )
    return LaneEdges(block=block, lane=lane, row_off=row_off)


def _lane_messages(edges: LaneEdges, operand_at, program: VertexProgram) -> torch.Tensor:
    """Per-edge messages of packed lanes; ``operand_at(flat, src)`` gives
    each source's operand from its lane's row (flat = row_off + src)."""
    b = edges.block
    msg = program.edge_message(operand_at(edges.row_off + b.src, b.src), b.weight)
    identity = float("inf") if program.combine == MIN else 0.0
    return torch.where(b.active, msg, identity)


def _combine_lanes(edges: LaneEdges, msg: torch.Tensor, n_lanes: int, n: int,
                   program: VertexProgram) -> RelaxOut:
    """The plain combine of packed lanes into (L, n): ``_combine`` over the
    flat (L * n) index ``lane * n + dst``."""
    flat = edges.lane * n + edges.block.dst.long()
    if program.combine == MIN:
        agg = torch.full((n_lanes * n,), float("inf"), dtype=msg.dtype, device=msg.device)
        agg.scatter_reduce_(0, flat, msg, "amin")
        agg = agg.view(n_lanes, n)
        return RelaxOut(agg=agg, touched=torch.isfinite(agg))
    agg = torch.zeros(n_lanes * n, dtype=msg.dtype, device=msg.device).index_add_(0, flat, msg)
    got = torch.zeros(n_lanes * n, dtype=torch.float32, device=msg.device).index_add_(
        0, flat, edges.block.active.to(torch.float32))
    return RelaxOut(agg=agg.view(n_lanes, n), touched=(got > 0).view(n_lanes, n))


def relax_lanes_filter(group, csr, frontier, operand_at, program, use_kernels=False) -> RelaxOut:
    """FILTER over a lane group: every lane's whole partition, masked;
    with kernels, one ``segment_spmm_lanes`` combine for all lanes."""
    n = frontier.shape[1]
    edges = lane_edges(group, csr, frontier)
    msg = _lane_messages(edges, operand_at, program)
    L = len(group.lengths)
    if not use_kernels:
        return _combine_lanes(edges, msg, L, n, program)
    from repro_torch.kernels.segment_spmm.ops import segment_spmm_lanes

    if program.combine == MIN:
        agg = segment_spmm_lanes(msg, edges.block.dst, group.offsets, n, combine="min",
                                 lengths=group.lengths)
        return RelaxOut(agg=agg, touched=torch.isfinite(agg))
    packed = torch.stack([msg, edges.block.active.to(msg.dtype)], dim=-1)
    out = segment_spmm_lanes(packed, edges.block.dst, group.offsets, n, lengths=group.lengths)
    return RelaxOut(agg=out[..., 0], touched=out[..., 1] > 0)


def relax_lanes_compact(group, csr, frontier, operand_at, program, use_kernels=False) -> RelaxOut:
    """COMPACT over a lane group: each lane's active edges squeezed to the
    front of its own segment (stable), then combined.  A lane's segment
    keeps its place, so each edge's lane is unchanged."""
    n = frontier.shape[1]
    edges = lane_edges(group, csr, frontier)
    b = edges.block
    if use_kernels:
        from repro_torch.kernels.frontier_compact.ops import frontier_compact_lanes

        compacted = EdgeBlock(*frontier_compact_lanes(b, b.active, group.offsets)[0])
    else:
        order = torch.argsort(edges.lane * 2 + (~b.active).to(torch.int64), stable=True)
        compacted = EdgeBlock(src=b.src[order], dst=b.dst[order], weight=b.weight[order],
                              active=b.active[order])
    edges = edges._replace(block=compacted)
    msg = _lane_messages(edges, operand_at, program)
    return _combine_lanes(edges, msg, len(group.lengths), n, program)


def relax_lanes_zerocopy(group, csr, frontier, operand_at, program,
                         use_kernels=False) -> RelaxOut:
    """ZEROCOPY over a lane group: every lane's partition as PAD-lane
    windows, all lanes' windows in one ``hyb_gather`` request list over the
    shared CSR columns; ``active`` is computed after the gather from each
    window lane's frontier row (lanes past a window's degree are
    inactive)."""
    if not use_kernels:
        edges = lane_edges(group, csr, frontier)
        msg = _lane_messages(edges, operand_at, program)
        return _combine_lanes(edges, msg, len(group.lengths), frontier.shape[1], program)
    from repro_torch.kernels.hyb_gather.ops import PAD, hyb_gather

    n = frontier.shape[1]
    dev = frontier.device
    n_windows = -(-group.counts // PAD)
    wlane, first = packed_ranges(torch.zeros_like(group.counts),
                                 torch.cat([n_windows.new_zeros(1), torch.cumsum(n_windows, 0)]),
                                 sum(-(-c // PAD) for c in group.lengths))
    offset = first * PAD
    starts = (group.starts.index_select(0, wlane) + offset).to(torch.int32)
    degree = torch.clamp(group.counts.index_select(0, wlane) - offset, max=PAD).to(torch.int32)
    src, dst, weight = (col.reshape(-1) for col in hyb_gather(
        (csr.edge_src, csr.edge_dst, csr.edge_weight), starts, degree))
    k = torch.arange(PAD, device=dev)
    lane = wlane[:, None].expand(-1, PAD).reshape(-1)
    row_off = torch.index_select(group.rows, 0, lane) * n
    valid = (k[None, :] < degree[:, None]).reshape(-1)
    active = valid & torch.index_select(frontier.view(-1), 0, row_off + src)
    edges = LaneEdges(block=EdgeBlock(src=src, dst=dst, weight=weight, active=active),
                      lane=lane, row_off=row_off)
    msg = _lane_messages(edges, operand_at, program)
    return _combine_lanes(edges, msg, len(group.lengths), n, program)


LANE_ENGINE_FNS = (relax_lanes_filter, relax_lanes_compact, relax_lanes_zerocopy)


def relax_lanes(
    engine_id: int,           # host int: 0 filter / 1 compact / 2 zerocopy
    group: LaneGroup,
    csr,
    frontier: torch.Tensor,   # (Q, n) bool, the sweep's frontier
    operand_at,
    program: VertexProgram,
    use_kernels: bool = False,
) -> RelaxOut:
    """Relax a lane group with one engine: (L, n) results, lane l's row
    equal to ``relax_with_engine`` of its partition alone (bit for bit for
    MIN; SUM within float tolerance on CUDA, bit for bit on the CPU)."""
    return LANE_ENGINE_FNS[int(engine_id)](group, csr, frontier, operand_at, program,
                                           use_kernels)
