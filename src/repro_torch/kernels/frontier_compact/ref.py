"""Plain PyTorch version of the stream-compaction kernel."""

from __future__ import annotations

import torch


def frontier_compact_ref(columns, mask: torch.Tensor):
    """Stable partition: kept rows move to the front in their original
    order, the others follow in theirs.  Returns (columns, count) with
    count an int32 0-dim tensor."""
    order = torch.argsort((~mask).to(torch.uint8), stable=True)
    return tuple(col[order] for col in columns), mask.sum(dtype=torch.int32)
