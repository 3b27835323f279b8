"""Train stepping: loss -> (microbatched) gradients -> clip -> optional
compression with error feedback -> optimizer update (port of
``repro.train.train_step``).

``params`` is an ``nn.Module`` or a dict of name -> tensor, and
``loss_fn(params, batch)`` returns a 0-dim loss.  ``init_train_state``
turns ``requires_grad`` on for every parameter (serving keeps the models'
parameters frozen) and groups them into the reference's leaves
(``param_leaves``): a ``Transformer``'s scan layers stack as the
reference's ``layers`` subtree, every other parameter is a leaf of its own.

Microbatches.  The reference reshapes the batch to ``(mb, B/mb, ...)``,
sums each microbatch's gradients cast to ``accum_dtype`` from zeros, and
divides the loss and the sums by ``mb``.  When every parameter is in
``accum_dtype``, autograd's accumulation into ``.grad`` (the first
backward writes, the next ones add) gives those sums in the same order;
otherwise each microbatch's ``.grad`` is cast and added into zeroed
``accum_dtype`` buffers, as the reference does.

The step updates the parameters and the optimizer and error state in
place and returns the state with ``step`` advanced, and the metrics
``loss`` and ``grad_norm`` (the norm before clipping) as 0-dim tensors.
"""

from __future__ import annotations

import dataclasses
from dataclasses import dataclass, field
from typing import Callable

import torch
from torch import nn

from repro_torch.kernels.runtime import resolve_device
from repro_torch.models.transformer import Transformer
from repro_torch.train.compression import CompressionConfig, compress_grads, init_error_state
from repro_torch.train.optimizer import (Leaf, OptimizerConfig, apply_updates,
                                         clip_by_global_norm, default_leaves, init_opt_state)


@dataclass
class TrainState:
    params: object               # nn.Module or dict name -> tensor
    opt_state: dict
    error_state: dict | None
    step: int
    # the reference's leaves of ``params``: structure, not checkpointed
    leaves: tuple = field(default=(), metadata={"static": True})


def named_params(params) -> dict:
    """name -> tensor of a module's parameters or of a dict of tensors."""
    if isinstance(params, nn.Module):
        return dict(params.named_parameters())
    return dict(params)


def param_leaves(params) -> tuple:
    """The reference's leaves of ``params``.  A ``Transformer``'s layers past
    its dense prefix are stacked by parameter (``layers.<key>``, one member
    a scan layer), its prefix layers are ``prefix.<i>.<key>``; every other
    parameter is its own leaf."""
    named = named_params(params)
    if not isinstance(params, Transformer):
        return default_leaves(named)
    n_prefix = params.cfg.n_prefix_layers
    leaves, stacks = [], {}
    for name in named:
        parts = name.split(".")
        if parts[0] != "layers":
            leaves.append(Leaf(name, (name,)))
            continue
        i, key = int(parts[1]), ".".join(parts[2:])
        if i < n_prefix:
            leaves.append(Leaf(f"prefix.{i}.{key}", (name,)))
        else:
            stacks.setdefault(key, []).append(name)
    leaves += [Leaf(f"layers.{key}", tuple(members), stacked=True)
               for key, members in stacks.items()]
    return tuple(leaves)


def _on(t: torch.Tensor, dev: torch.device) -> bool:
    return t.device.type == dev.type and (dev.index is None or t.device.index == dev.index)


def init_train_state(params, opt_cfg: OptimizerConfig,
                     comp_cfg: CompressionConfig | None = None,
                     device: str | torch.device | None = None) -> TrainState:
    """Step 0 of training ``params`` (which must live on ``device``, default
    ``cuda``; raises without a card unless given ``"cpu"``): every parameter
    made trainable, zero optimizer state, and zero residuals when
    ``comp_cfg`` compresses, over ``param_leaves(params)``."""
    dev = resolve_device(device)
    named = named_params(params)
    for name, p in named.items():
        if not _on(p, dev):
            raise ValueError(f"init_train_state: {name} lives on {p.device}, not {dev}")
        p.requires_grad_(True)
    leaves = param_leaves(params)
    err = None
    if comp_cfg is not None and comp_cfg.kind != "none":
        err = init_error_state(named, leaves)
    return TrainState(params=params, opt_state=init_opt_state(opt_cfg, named, leaves),
                      error_state=err, step=0, leaves=leaves)


def _microbatch(batch, i: int, n: int):
    """Rows ``[i*B/n, (i+1)*B/n)`` of every array of ``batch`` (a dict, or
    one array)."""
    def part(x):
        b = x.shape[0]
        if b % n:
            raise ValueError(f"a batch of {b} does not split into {n} microbatches")
        return x[i * (b // n):(i + 1) * (b // n)]

    if isinstance(batch, dict):
        return {k: part(v) for k, v in batch.items()}
    return part(batch)


def value_and_grads(loss_fn: Callable, params, batch, microbatches: int = 1,
                    accum_dtype: torch.dtype = torch.float32):
    """(loss, grads): the float32 loss averaged over ``microbatches`` and
    the gradients (name -> tensor, owned by the caller; the parameters'
    ``.grad`` is cleared), averaged the same way."""
    named = named_params(params)
    for p in named.values():
        p.grad = None
    direct = all(p.dtype == accum_dtype for p in named.values())
    acc = None if direct else {n: torch.zeros(p.shape, dtype=accum_dtype, device=p.device)
                               for n, p in named.items()}
    loss_acc = None
    with torch.enable_grad():
        for i in range(microbatches):
            part = batch if microbatches == 1 else _microbatch(batch, i, microbatches)
            loss = loss_fn(params, part)
            loss.backward()
            loss = loss.detach().float()
            loss_acc = loss if loss_acc is None else loss_acc + loss
            if acc is not None:
                for n, p in named.items():
                    if p.grad is not None:
                        acc[n] += p.grad.to(accum_dtype)
                    p.grad = None
    if acc is None:
        grads = {n: p.grad if p.grad is not None else torch.zeros_like(p)
                 for n, p in named.items()}
        for p in named.values():
            p.grad = None
    else:
        grads = acc
    if microbatches > 1:
        mb = torch.full((), float(microbatches), device=loss_acc.device)
        loss_acc = loss_acc / mb
        for g in grads.values():
            g.div_(mb.to(g.dtype))
    return loss_acc, grads


def make_train_step(loss_fn: Callable, opt_cfg: OptimizerConfig,
                    comp_cfg: CompressionConfig | None = None, microbatches: int = 1,
                    accum_dtype: torch.dtype = torch.float32) -> Callable:
    """``train_step(state, batch) -> (state, {"loss", "grad_norm"})``."""

    def train_step(state: TrainState, batch):
        named = named_params(state.params)
        loss, grads = value_and_grads(loss_fn, state.params, batch, microbatches, accum_dtype)
        grads, grad_norm = clip_by_global_norm(grads, opt_cfg.grad_clip)
        error_state = state.error_state
        if comp_cfg is not None and comp_cfg.kind != "none":
            grads, error_state = compress_grads(comp_cfg, grads, error_state, state.leaves)
        _, opt_state = apply_updates(opt_cfg, named, grads, state.opt_state, state.step,
                                     state.leaves)
        del grads
        new_state = dataclasses.replace(state, opt_state=opt_state, error_state=error_state,
                                        step=state.step + 1)
        return new_state, {"loss": loss, "grad_norm": grad_norm}

    return train_step
