"""Plain PyTorch version of the stream-compaction kernel."""

from __future__ import annotations

import torch


def frontier_compact_ref(columns, mask: torch.Tensor):
    """Stable partition: kept rows move to the front in their original
    order, the others follow in theirs.  Returns (columns, count) with
    count an int32 0-dim tensor."""
    order = torch.argsort((~mask).to(torch.uint8), stable=True)
    return tuple(col[order] for col in columns), mask.sum(dtype=torch.int32)


def frontier_compact_lanes_ref(columns, mask: torch.Tensor, offsets: torch.Tensor):
    """Each lane's rows ``offsets[l]:offsets[l+1]`` partitioned by its own
    mask in place of themselves, a loop over lanes of
    ``frontier_compact_ref``.  Returns (columns, counts) with counts (L,)
    int32."""
    bounds = offsets.tolist()
    parts = [frontier_compact_ref([col[a:b] for col in columns], mask[a:b])
             for a, b in zip(bounds[:-1], bounds[1:])]
    cols = tuple(torch.cat([p[0][j] for p in parts]) if parts else col[:0]
                 for j, col in enumerate(columns))
    return cols, torch.stack([p[1] for p in parts])
