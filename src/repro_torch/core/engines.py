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
