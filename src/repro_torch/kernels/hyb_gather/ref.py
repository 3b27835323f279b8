"""Plain PyTorch version of the per-request window gather."""

from __future__ import annotations

import torch

PAD = 128  # rows per request window


def hyb_gather_ref(columns, seg_start: torch.Tensor,
                   degree: torch.Tensor) -> tuple[torch.Tensor, ...]:
    """One (a, PAD) tensor per column: request r's rows ``col[start :
    start + PAD]``, with 0 for lanes at or past ``degree[r]`` and for rows
    outside the column."""
    m = columns[0].shape[0]
    idx = seg_start.long()[:, None] + torch.arange(PAD, device=seg_start.device)
    lane = torch.arange(PAD, device=seg_start.device)[None, :]
    ok = (lane < degree.long()[:, None]) & (idx >= 0) & (idx < m)
    idx = torch.where(ok, idx, m)                        # row m reads as 0
    return tuple(torch.cat([col, col.new_zeros(1)])[idx] for col in columns)
