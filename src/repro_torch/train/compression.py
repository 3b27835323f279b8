"""Gradient compression with error feedback (port of
``repro.train.compression``).

* ``int8``: per-leaf symmetric quantization to int8 (4x fewer bytes on an
  all-reduce wire); error feedback keeps the residual locally.
* ``topk``: magnitude sparsification to fraction ``k`` with residual
  accumulation (Deep Gradient Compression).

Both reduce over a whole reference leaf (``optimizer.Leaf``): int8's scale
is the largest |g| over every member of the leaf and top-k's threshold the
k-th largest |g| over all of them, so a stacked leaf of scan layers is
quantized and sparsified as the reference's one array is.  The arithmetic
is elementwise around those reductions, so on the CPU the port's wire
gradients and error state are the reference's bit for bit.  The scale's
``/ 127`` divides by a float32 0-dim tensor: on CUDA a division by a
Python scalar becomes a product with its reciprocal.
"""

from __future__ import annotations

from dataclasses import dataclass

import torch

from repro_torch.train.optimizer import default_leaves, leaf_shape, leaf_slices, member_views


@dataclass(frozen=True)
class CompressionConfig:
    kind: str = "none"       # 'none' | 'int8' | 'topk'
    topk_fraction: float = 0.01
    error_feedback: bool = True


def init_error_state(params: dict, leaves=None) -> dict:
    """Zero float32 residuals per leaf, in the reference's leaf shapes."""
    leaves = default_leaves(params) if leaves is None else leaves
    return {lf.name: torch.zeros(leaf_shape(lf, params), dtype=torch.float32,
                                 device=params[lf.members[0]].device) for lf in leaves}


def _int8_roundtrip(gs: list) -> list:
    big = torch.stack([g.abs().max() for g in gs]).max()
    scale = torch.clamp_min(big, 1e-12) / torch.full((), 127.0, device=big.device)
    return [torch.clamp(torch.round(g / scale), -127, 127).to(torch.int8).float() * scale
            for g in gs]


def _topk_roundtrip(gs: list, frac: float) -> list:
    flat = torch.cat([g.abs().reshape(-1) for g in gs])
    k = max(1, int(flat.shape[0] * frac))
    thresh = torch.topk(flat, k).values[-1]
    del flat
    return [torch.where(g.abs() >= thresh, g, 0.0) for g in gs]


@torch.no_grad()
def compress_grads(cfg: CompressionConfig, grads: dict, error_state: dict, leaves=None):
    """Returns (wire_grads, new_error_state): what survives the compressed
    exchange (name -> tensor in each gradient's dtype), and the residuals
    (leaf -> tensor; updated in place)."""
    if cfg.kind == "none":
        return grads, error_state
    leaves = default_leaves(grads) if leaves is None else leaves
    wire = {}
    for lf in leaves:
        gs = leaf_slices(lf, grads)
        es = member_views(lf, error_state[lf.name])
        g32 = [g.float() + (e if cfg.error_feedback else 0.0) for g, e in zip(gs, es)]
        if cfg.kind == "int8":
            w32 = _int8_roundtrip(g32)
        elif cfg.kind == "topk":
            w32 = _topk_roundtrip(g32, cfg.topk_fraction)
        else:
            raise ValueError(cfg.kind)
        for name, g, e, a, w in zip(lf.members, gs, es, g32, w32):
            if cfg.error_feedback:
                e.copy_(a - w)
            wire[name] = w.to(g.dtype)
    return wire, error_state


def wire_bytes(cfg: CompressionConfig, grads: dict, leaves=None) -> float:
    """Modeled bytes on the all-reduce wire: int8 one byte an element plus
    a float32 scale a leaf, top-k a value and an index a kept element,
    else four bytes an element."""
    total = sum(g.numel() for g in grads.values())
    if cfg.kind == "int8":
        n_leaves = len(grads) if leaves is None else len(leaves)
        return total * 1.0 + n_leaves * 4.0
    if cfg.kind == "topk":
        return total * cfg.topk_fraction * 8.0  # value + index
    return total * 4.0
