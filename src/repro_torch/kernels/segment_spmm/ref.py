"""Plain PyTorch version of the segment-SpMM kernel."""

from __future__ import annotations

import itertools

import torch


def segment_spmm_ref(
    messages: torch.Tensor,   # (m, d) float32
    seg_ids: torch.Tensor,    # (m,) int32 destination ids
    n_segments: int,
    valid: torch.Tensor | None = None,  # (m,) bool
    combine: str = "sum",
) -> torch.Tensor:
    """(n_segments, d): segments that receive nothing hold the identity
    (+inf for min, 0 for sum); invalid lanes and ids outside
    ``[0, n_segments)`` are dropped, as ``jax.ops.segment_*`` drops them."""
    keep = (seg_ids >= 0) & (seg_ids < n_segments)
    if valid is not None:
        keep = keep & valid
    idx = torch.where(keep, seg_ids, 0).long()
    d = messages.shape[1]
    if combine == "min":
        msg = torch.where(keep[:, None], messages, float("inf"))
        out = torch.full((n_segments, d), float("inf"), dtype=messages.dtype,
                         device=messages.device)
        return out.scatter_reduce_(0, idx[:, None].expand(-1, d), msg, "amin")
    msg = torch.where(keep[:, None], messages, 0.0)
    out = torch.zeros((n_segments, d), dtype=messages.dtype, device=messages.device)
    return out.index_add_(0, idx, msg)


def segment_spmm_lanes_ref(
    messages: torch.Tensor,   # (M,) or (M, d) float32, lane after lane
    seg_ids: torch.Tensor,    # (M,) int32
    offsets: torch.Tensor,    # (L+1,) int64 packed offsets
    n_segments: int,
    combine: str = "sum",
    lengths=None,             # the lanes' row counts as host ints, or None
) -> torch.Tensor:
    """(L, n_segments[, d]): lane l's rows ``offsets[l]:offsets[l+1]``
    combined into row l, a loop over lanes of ``segment_spmm_ref``; the
    bounds from ``lengths`` where given (they must agree with ``offsets``)."""
    bounds = offsets.tolist() if lengths is None else [0, *itertools.accumulate(lengths)]
    squeeze = messages.dim() == 1
    msg = messages[:, None] if squeeze else messages
    rows = [segment_spmm_ref(msg[a:b], seg_ids[a:b], n_segments, None, combine)
            for a, b in zip(bounds[:-1], bounds[1:])]
    out = torch.stack(rows)
    return out[..., 0] if squeeze else out
