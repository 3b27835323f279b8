"""Plain PyTorch version of the embedding-bag kernel: ``jnp.take``'s row
gather in its default mode, then the reference's bag reduce."""

from __future__ import annotations

import torch

MODES = ("sum", "mean", "max")


def take_rows(table: torch.Tensor, ids: torch.Tensor) -> torch.Tensor:
    """``jnp.take(table, ids, axis=0)``: (n,) ids -> (n, D) rows.  An id in
    [-V, 0) wraps to ``id + V``; any other id outside [0, V) gives a NaN
    row."""
    V = table.shape[0]
    ids = ids.long()
    wrapped = torch.where(ids < 0, ids + V, ids)
    ok = (wrapped >= 0) & (wrapped < V)
    rows = table.index_select(0, torch.where(ok, wrapped, 0))
    return torch.where(ok[:, None], rows, float("nan"))


def bag_reduce(rows: torch.Tensor, bags: int, bag_size: int, mode: str) -> torch.Tensor:
    """(bags * bag_size, D) rows -> (bags, D) by sum, mean or max, computed
    in float32 and cast back once (``jnp.sum`` and ``jnp.mean`` upcast a
    bfloat16 input the same way)."""
    r = rows.reshape(bags, bag_size, rows.shape[-1]).float()
    if mode == "sum":
        out = r.sum(dim=1)
    elif mode == "mean":
        # a true division, as jnp.mean's: on CUDA a Python-scalar divisor
        # would become a multiplication by its reciprocal
        out = r.sum(dim=1) / r.new_full((), bag_size)
    elif mode == "max":
        if bag_size == 0:
            raise ValueError("max of an empty bag: zero-size reduction")
        out = r.amax(dim=1)
    else:
        raise ValueError(f"unknown mode {mode!r}")
    return out.to(rows.dtype)


def embedding_bag_ref(table: torch.Tensor, indices: torch.Tensor,
                      mode: str = "sum") -> torch.Tensor:
    """(V, D) table x (B, L) ids -> (B, D) bags."""
    B, L = indices.shape
    return bag_reduce(take_rows(table, indices.reshape(-1)), B, L, mode)
