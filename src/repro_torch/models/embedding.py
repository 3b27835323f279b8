"""EmbeddingBag with the HyTM row engines, the DLRM hot path (port of
``repro.models.embedding``).

The reference maps the paper's transfer engines onto embedding-row
movement: ``gather`` (zero-copy: one row fetch per lookup), ``dedup``
(compaction: fetch each distinct row once, expand through the inverse
map) and ``onehot`` (filter: stream the whole table through a one-hot
product); ``select_row_engine`` is its cost model, in the same Python float
arithmetic, so the picks are identical.

``use_kernels`` ("auto", True or False; ``kernels.runtime``): on, the
``gather`` engine's lookup and reduce, and the ``dedup`` engine's expansion
and reduce (an embedding bag over the hot rows with the inverse map as its
ids), go through the ``embedding_bag`` kernel; the values are the same.
``onehot`` stays a one-hot matrix times the table, built by comparing with
``arange(V)`` as ``jax.nn.one_hot`` does (an id outside [0, V) gives a zero
row, where ``F.one_hot`` would raise).  The reference pads ``jnp.unique``
to a static B * L ids; ``torch.unique`` gives the same inverse map
unpadded, and the padding never reaches the result.
"""

from __future__ import annotations

import torch

from repro_torch.kernels.embedding_bag.ops import embedding_bag as embedding_bag_kernel
from repro_torch.kernels.embedding_bag.ref import bag_reduce as _bag_reduce
from repro_torch.kernels.embedding_bag.ref import take_rows
from repro_torch.kernels.runtime import resolve_use_kernels

ENGINES = ("gather", "dedup", "onehot")


def select_row_engine(vocab: int, n_lookups: int, expected_unique: float | None = None) -> str:
    """Static cost-model choice (per table, from batch shape statistics).

    rows_gather = n_lookups
    rows_dedup  = E[unique] + compaction pass over n_lookups indices
    rows_onehot = vocab (stream the whole table)
    """
    if expected_unique is None:
        # balls-in-bins expectation: V * (1 - (1 - 1/V)^n)
        expected_unique = vocab * (1.0 - (1.0 - 1.0 / max(vocab, 1)) ** n_lookups)
    if vocab <= min(n_lookups, 512):
        return "onehot"
    if expected_unique < 0.5 * n_lookups:
        return "dedup"
    return "gather"


def placed_bag(table: torch.Tensor, indices: torch.Tensor, mode: str = "sum") -> torch.Tensor:
    """``embedding_bag`` of a DTensor table (rows split over some mesh dims,
    ``dist.sharding.dlrm_rule``) with DTensor ids (rows split over the batch
    axes), under ``local_map``: each rank gathers the rows of its own slice
    of the table (zeros for ids outside it) and reduces its bags, and the
    bags are summed over the table's split (a ``Partial`` output), exact for
    ``sum`` and ``mean``; the table's gradient is each rank's slice, summed
    over the ids' split.  DTensor has no sharding of a gather by ids from a
    split table."""
    import math

    import torch.nn.functional as F
    from torch.distributed.tensor import DTensor, Partial, Replicate, Shard
    from torch.distributed.tensor.experimental import local_map

    if mode not in ("sum", "mean"):
        raise ValueError(f"placed_bag: mode {mode!r} has no partial sum over a split table")
    dm = table.device_mesh
    if not isinstance(indices, DTensor):
        indices = DTensor.from_local(indices, dm, [Replicate()] * dm.ndim, run_check=False)
    split, lo = [], 0
    for i, p in enumerate(table.placements):
        if p == Shard(0):
            split.append(i)
            lo = lo * dm.size(i) + dm.get_local_rank(i)
        elif not isinstance(p, Replicate):
            raise ValueError(f"a table placed {table.placements}: rows split or replicated only")
    lo *= table.shape[0] // max(1, math.prod(dm.size(i) for i in split))
    ids_pl = tuple(indices.placements)
    out_pl = tuple(Partial() if i in split else p for i, p in enumerate(ids_pl))
    grad_pl = tuple(Shard(0) if i in split else Partial() if isinstance(p, Shard) else Replicate()
                    for i, p in enumerate(ids_pl))

    def bag(ids, rows):
        idx = ids.long() - lo
        ok = (idx >= 0) & (idx < rows.shape[0])
        got = F.embedding(torch.where(ok, idx, 0), rows) * ok[..., None].to(rows.dtype)
        return got.sum(dim=1) if mode == "sum" else got.mean(dim=1)

    return local_map(bag, out_placements=(out_pl,), in_placements=(ids_pl, tuple(table.placements)),
                     in_grad_placements=(ids_pl, grad_pl), device_mesh=dm)(indices, table)


def embedding_bag(table: torch.Tensor, indices: torch.Tensor, mode: str = "sum",
                  engine: str = "auto", use_kernels: bool | str = "auto") -> torch.Tensor:
    """(V, D) table x (B, L) ids -> (B, D) reduced embeddings.  A DTensor
    table takes ``placed_bag``."""
    if hasattr(table, "placements"):
        return placed_bag(table, indices, mode)
    B, L = indices.shape
    V = table.shape[0]
    if engine == "auto":
        engine = select_row_engine(V, B * L)
    use = resolve_use_kernels(use_kernels, table.device)
    flat = indices.reshape(-1)
    if engine == "gather":
        if use:
            return embedding_bag_kernel(table, indices.contiguous(), mode)
        rows = take_rows(table, flat)
    elif engine == "dedup":
        uniq, inv = torch.unique(flat, sorted=True, return_inverse=True)
        hot = take_rows(table, uniq)
        if use:
            return embedding_bag_kernel(hot, inv.reshape(B, L), mode)
        rows = hot.index_select(0, inv)
    elif engine == "onehot":
        onehot = (flat[:, None] == torch.arange(V, device=flat.device)).to(table.dtype)
        rows = onehot @ table
    else:
        raise ValueError(f"unknown engine {engine!r}; known: {ENGINES}")
    return _bag_reduce(rows, B, L, mode)


def embedding_bag_grad_rows(vocab: int, indices: torch.Tensor) -> torch.Tensor:
    """Number of distinct rows touched by the backward scatter (used by the
    table-placement cost model), as an int32 scalar.  Like the reference's
    ``.at[].set``, a negative id wraps and an id still out of range is
    dropped."""
    flat = indices.reshape(-1).long()
    flat = torch.where(flat < 0, flat + vocab, flat)
    flat = flat[(flat >= 0) & (flat < vocab)]
    marks = torch.zeros(vocab, dtype=torch.int32, device=indices.device)
    marks[flat] = 1
    return marks.sum(dtype=torch.int32)
