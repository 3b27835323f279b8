"""Plain PyTorch version of the grouped matmul kernel: one float32 product
a group, each group's rows a slice."""

from __future__ import annotations

import torch


def grouped_matmul_ref(x_sorted: torch.Tensor, weights: torch.Tensor, starts: torch.Tensor,
                       counts: torch.Tensor, max_rows: int | None = None) -> torch.Tensor:
    """(T, D) rows sorted by expert x (E, D, F) weights -> (T, F) in x's
    dtype.  Expert e owns rows [starts[e], starts[e] + min(counts[e],
    max_rows)) (``max_rows`` None: no bound); there the product runs in
    float32 and is cast once.  Rows outside every group, and rows outside
    [0, T), are 0.  Groups do not overlap (the reference's oracle, which
    builds a (T, D, F) tensor of per-row weights, assumes it too)."""
    T, _ = x_sorted.shape
    E, _, F = weights.shape
    out = torch.zeros((T, F), dtype=x_sorted.dtype, device=x_sorted.device)
    rows = counts.clamp(min=0)
    if max_rows is not None:
        rows = rows.clamp(max=max_rows)
    for e, (s, n) in enumerate(zip(starts.tolist(), rows.tolist())):
        lo, hi = max(s, 0), min(s + n, T)
        if hi > lo:
            out[lo:hi] = (x_sorted[lo:hi].float() @ weights[e].float()).to(out.dtype)
    return out
