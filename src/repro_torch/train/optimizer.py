"""Optimizers: AdamW, Adafactor (factored second moments) and SGD with
momentum (port of ``repro.train.optimizer``).

The reference's arithmetic, not ``torch.optim``'s: AdamW divides the
bias-corrected first moment by ``sqrt(v / bc2) + eps`` and adds the decay
to the update (``torch.optim.AdamW`` divides by ``sqrt(v) / sqrt(bc2) +
eps`` and decays before the step).  The schedule, the bias corrections and
Adafactor's decay are float32 0-dim tensors on the parameters' device
(``count = step + 1``), and every division is by a tensor: on CUDA a
division by a Python scalar becomes a product with its reciprocal.

Leaves.  The reference updates a pytree whose scan layers are stacked on
axis 0; the port's parameters are one tensor a layer.  A :class:`Leaf`
names the port's parameters that form one reference leaf (``stacked``:
those slices on a new axis 0, in order), and the optimizer state is kept
per leaf in the reference's shapes.  The two reductions over a whole leaf,
Adafactor's update clipping (``rms`` of the update) and its factored
statistics over the stacked axis, run over the stacked leaf; AdamW and
SGD are elementwise and update each parameter in place through views of
the stacked state.  As in the reference, a leaf of ``ndim >= 3``,
``shape[0] >= 4`` and at least ``_CHUNKED_LEAF_ELEMS`` elements is updated
slice by slice along axis 0 (its Adafactor update clipped per slice).

Parameters are updated in place (``apply_updates`` returns them with the
state); the reference returns new trees.
"""

from __future__ import annotations

import dataclasses
import math
from dataclasses import dataclass

import torch


@dataclass(frozen=True)
class OptimizerConfig:
    name: str = "adamw"          # 'adamw' | 'adafactor' | 'sgd'
    learning_rate: float = 1e-3
    b1: float = 0.9
    b2: float = 0.999
    eps: float = 1e-8
    weight_decay: float = 0.01
    grad_clip: float = 1.0
    warmup_steps: int = 100
    total_steps: int = 10_000
    schedule: str = "cosine"     # 'cosine' | 'linear' | 'constant'
    # adafactor
    factored_min_dim: int = 32
    decay_rate: float = 0.8

    def replace(self, **kw) -> "OptimizerConfig":
        return dataclasses.replace(self, **kw)


@dataclass(frozen=True)
class Leaf:
    """One leaf of the reference's parameter tree: the port's parameters
    ``members`` (names), stacked on a new axis 0 in this order when
    ``stacked`` (the reference's scan over layers), else the one parameter
    itself."""

    name: str
    members: tuple
    stacked: bool = False


def default_leaves(params: dict) -> tuple:
    """Every parameter its own leaf."""
    return tuple(Leaf(name, (name,)) for name in params)


def leaf_shape(leaf: Leaf, params: dict) -> tuple:
    shape = tuple(params[leaf.members[0]].shape)
    return (len(leaf.members),) + shape if leaf.stacked else shape


def leaf_slices(leaf: Leaf, tensors: dict) -> list:
    """The leaf's members, each the slice ``i`` of axis 0 of the stacked leaf
    (a parameter or gradient of the port): for an unstacked leaf, the one
    tensor whole."""
    return [tensors[name] for name in leaf.members]


def member_views(leaf: Leaf, state: torch.Tensor) -> list:
    """Views of a leaf-shaped state tensor that line up with the members."""
    return list(state.unbind(0)) if leaf.stacked else [state]


def _f32(x: float, device) -> torch.Tensor:
    return torch.full((), x, dtype=torch.float32, device=device)


def learning_rate(cfg: OptimizerConfig, step: int,
                  device: str | torch.device | None = "cpu") -> torch.Tensor:
    """The schedule at ``step``: linear warmup, then cosine, linear or
    constant decay to ``total_steps``; a float32 0-dim tensor."""
    s = _f32(float(step), device)
    warm = torch.minimum(s / _f32(max(cfg.warmup_steps, 1), device), _f32(1.0, device))
    frac = torch.clamp((s - cfg.warmup_steps)
                       / _f32(max(cfg.total_steps - cfg.warmup_steps, 1), device), 0.0, 1.0)
    if cfg.schedule == "cosine":
        decay = 0.5 * (1.0 + torch.cos(math.pi * frac))
    elif cfg.schedule == "linear":
        decay = 1.0 - frac
    else:
        decay = 1.0
    return cfg.learning_rate * warm * decay


def _is_factored(shape, cfg: OptimizerConfig) -> bool:
    return (len(shape) >= 2 and shape[-1] >= cfg.factored_min_dim
            and shape[-2] >= cfg.factored_min_dim)


def init_opt_state(cfg: OptimizerConfig, params: dict, leaves=None) -> dict:
    """Zero float32 state per leaf, in the reference's leaf shapes, on the
    parameters' device."""
    leaves = default_leaves(params) if leaves is None else leaves

    def zeros(shape, leaf):
        return torch.zeros(shape, dtype=torch.float32, device=params[leaf.members[0]].device)

    if cfg.name == "sgd":
        return {"momentum": {lf.name: zeros(leaf_shape(lf, params), lf) for lf in leaves}}
    if cfg.name == "adamw":
        return {k: {lf.name: zeros(leaf_shape(lf, params), lf) for lf in leaves}
                for k in ("m", "v")}
    if cfg.name == "adafactor":
        out = {}
        for lf in leaves:
            shape = leaf_shape(lf, params)
            if _is_factored(shape, cfg):
                out[lf.name] = {"vr": zeros(shape[:-1], lf),
                                "vc": zeros(shape[:-2] + shape[-1:], lf)}
            else:
                out[lf.name] = {"v": zeros(shape, lf)}
        return {"f": out}
    raise ValueError(cfg.name)


def global_norm(grads: dict) -> torch.Tensor:
    """sqrt of the sum of every gradient's float32 sum of squares.  The
    reference adds the per-leaf sums in sorted-key order over stacked
    leaves; the port adds per parameter in its own order, so the two agree
    to rounding (rtol 1e-6), not bit for bit."""
    return torch.sqrt(sum(g.float().square().sum() for g in grads.values()))


def clip_by_global_norm(grads: dict, max_norm: float):
    """Scale every gradient (in place) by ``min(1, max_norm / max(norm,
    1e-9))``; returns (grads, norm)."""
    norm = global_norm(grads)
    scale = torch.clamp(_f32(max_norm, norm.device) / torch.clamp_min(norm, 1e-9), max=1.0)
    for g in grads.values():
        g.mul_(scale.to(g.dtype))
    return grads, norm


_CHUNKED_LEAF_ELEMS = 2**27  # 128M elements (~512 MB fp32 temporaries)


def _chunked(shape) -> bool:
    return len(shape) >= 3 and shape[0] >= 4 and math.prod(shape) >= _CHUNKED_LEAF_ELEMS


def _adafactor_update(cfg, p, g, f: dict, lr, decay) -> tuple:
    """The reference's Adafactor update of one (whole or chunked) leaf:
    (new parameter values in p's dtype, new state dict)."""
    g32 = g.float()
    g2 = g32.square() + 1e-30
    if "vr" in f:
        vr = decay * f["vr"] + (1 - decay) * g2.mean(dim=-1)
        vc = decay * f["vc"] + (1 - decay) * g2.mean(dim=-2)
        denom = torch.clamp_min(vr.mean(dim=-1, keepdim=True), 1e-30)
        vhat = vr[..., None] * vc[..., None, :] / denom[..., None]
        newf = {"vr": vr, "vc": vc}
    else:
        vhat = decay * f["v"] + (1 - decay) * g2
        newf = {"v": vhat}
    u = g32 / torch.sqrt(vhat + 1e-30)
    # update clipping (Shazeer & Stern): RMS(u) capped at 1
    rms = torch.sqrt(u.square().mean() + 1e-30)
    u = u / torch.clamp_min(rms, 1.0)
    u = u + cfg.weight_decay * p.float()
    return (p.float() - lr * u).to(p.dtype), newf


def _adafactor_leaf(cfg, leaf: Leaf, params: dict, grads: dict, f: dict, lr, decay) -> None:
    ps, gs = leaf_slices(leaf, params), leaf_slices(leaf, grads)
    shape = leaf_shape(leaf, params)
    if _chunked(shape):
        # the reference's lax.map over axis 0: one slice at a time
        if leaf.stacked:
            pairs = list(zip(ps, gs))
        else:
            pairs = list(zip(ps[0].unbind(0), gs[0].unbind(0)))
        for i, (p, g) in enumerate(pairs):
            new_p, newf = _adafactor_update(cfg, p, g, {k: v[i] for k, v in f.items()}, lr,
                                            decay)
            p.copy_(new_p)
            for k, v in newf.items():
                f[k][i].copy_(v)
        return
    p = torch.stack(ps) if leaf.stacked else ps[0]
    g = torch.stack(gs) if leaf.stacked else gs[0]
    new_p, newf = _adafactor_update(cfg, p, g, f, lr, decay)
    for dst, src in zip(ps, new_p.unbind(0) if leaf.stacked else [new_p]):
        dst.copy_(src)
    for k, v in newf.items():
        f[k].copy_(v)


@torch.no_grad()
def apply_updates(cfg: OptimizerConfig, params: dict, grads: dict, state: dict, step: int,
                  leaves=None):
    """One update of ``params`` (name -> tensor, in place) by ``grads``
    (name -> tensor) at ``step``; ``state`` (from ``init_opt_state``, same
    ``leaves``) is updated in place.  Returns (params, state)."""
    leaves = default_leaves(params) if leaves is None else leaves
    dev = next(iter(params.values())).device
    lr = learning_rate(cfg, step, dev)
    count = _f32(float(step) + 1.0, dev)

    if cfg.name == "sgd":
        for lf in leaves:
            for p, g, m in zip(leaf_slices(lf, params), leaf_slices(lf, grads),
                               member_views(lf, state["momentum"][lf.name])):
                m.copy_(0.9 * m + g.float())
                p.copy_((p - lr * m).to(p.dtype))
        return params, state

    if cfg.name == "adamw":
        bc1 = 1.0 - torch.pow(_f32(cfg.b1, dev), count)
        bc2 = 1.0 - torch.pow(_f32(cfg.b2, dev), count)
        for lf in leaves:
            for p, g, m, v in zip(leaf_slices(lf, params), leaf_slices(lf, grads),
                                  member_views(lf, state["m"][lf.name]),
                                  member_views(lf, state["v"][lf.name])):
                g32 = g.float()
                m.copy_(cfg.b1 * m + (1 - cfg.b1) * g32)
                v.copy_(cfg.b2 * v + (1 - cfg.b2) * g32.square())
                u = ((m / bc1) / (torch.sqrt(v / bc2) + cfg.eps)
                     + cfg.weight_decay * p.float())
                p.copy_((p.float() - lr * u).to(p.dtype))
        return params, state

    if cfg.name == "adafactor":
        decay = 1.0 - torch.pow(count, -cfg.decay_rate)
        for lf in leaves:
            _adafactor_leaf(cfg, lf, params, grads, state["f"][lf.name], lr, decay)
        return params, state

    raise ValueError(cfg.name)
