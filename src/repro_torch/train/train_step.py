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

Over a mesh, SPMD: every rank calls the step on a state placed by
``dist.sharding.distribute(state, device_mesh, tree_shardings(state, mesh,
lm_rule(mesh)))`` (its parameters and optimizer state DTensors) and a
batch placed by ``lm_batch_spec``, with a ``loss_fn`` that runs on the
mesh (``lm_loss(..., mesh=)``).  Each gradient is placed as its parameter
before it is accumulated, the clip, the compression and the update run
under ``implicit_replication``, and the metrics are plain tensors, the
same on every rank.  Microbatch ``i`` is rows ``[i*B/n, (i+1)*B/n)`` of the
global batch, split over the mesh as the batch was.
"""

from __future__ import annotations

import contextlib
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


def _is_dtensor(t) -> bool:
    from torch.distributed.tensor import DTensor

    return isinstance(t, DTensor)


def _split(x: torch.Tensor, n: int):
    """``x`` (B, ...) as ``n`` microbatches: a (n, B/n, ...) tensor whose
    ``[i]`` is rows ``[i*B/n, (i+1)*B/n)``.  A DTensor is placed with each
    microbatch split over the mesh as the batch was (its batch ``Shard(0)``
    becomes ``Shard(1)``: the reference's ``pin_micro`` constraint), so
    that every rank holds its share of every microbatch.  DTensor cannot
    split a sharded dim into (n, B/n) unless n divides over its mesh axes,
    so the batch axes first hold the last dim instead (an all-to-all), the
    reshape is local, and a second all-to-all places the rows: no rank
    ever holds the whole batch."""
    b = x.shape[0]
    if b % n:
        raise ValueError(f"a batch of {b} does not split into {n} microbatches")
    if not _is_dtensor(x) or x.ndim < 2:
        return x.reshape(n, b // n, *x.shape[1:])
    from torch.distributed.tensor import Shard

    via = [Shard(x.ndim - 1) if isinstance(p, Shard) and p.dim == 0 else p for p in x.placements]
    rows = [Shard(1) if isinstance(p, Shard) and p.dim == 0
            else Shard(p.dim + 1) if isinstance(p, Shard) else p for p in x.placements]
    mbs = x.redistribute(x.device_mesh, via).reshape(n, b // n, *x.shape[1:])
    return mbs.redistribute(x.device_mesh, rows)


def _microbatches(batch, n: int) -> list:
    """The ``n`` microbatches of ``batch`` (a dict, or one array)."""
    if isinstance(batch, dict):
        parts = {k: _split(v, n) for k, v in batch.items()}
        return [{k: v[i] for k, v in parts.items()} for i in range(n)]
    mbs = _split(batch, n)
    return [mbs[i] for i in range(n)]


def _grad_of(p: torch.Tensor) -> torch.Tensor | None:
    """``p.grad``, a DTensor gradient placed as its parameter (autograd
    leaves it ``Partial`` over the axes the parameter is replicated on)."""
    g = p.grad
    if g is not None and _is_dtensor(g) and g.placements != p.placements:
        g = g.redistribute(p.device_mesh, p.placements)
    return g


def _full(t: torch.Tensor) -> torch.Tensor:
    """A plain tensor of ``t``: a DTensor's whole value on every rank."""
    return t.full_tensor() if _is_dtensor(t) else t


def _replicated(named: dict):
    """``implicit_replication`` when the parameters are DTensors (the
    step's plain tensors, the schedule, the bias corrections, the clip
    scale, are the same on every rank), else nothing."""
    if any(_is_dtensor(p) for p in named.values()):
        from repro_torch.dist.sharding import implicit_replication

        return implicit_replication()
    return contextlib.nullcontext()


def value_and_grads(loss_fn: Callable, params, batch, microbatches: int = 1,
                    accum_dtype: torch.dtype = torch.float32):
    """(loss, grads): the float32 loss averaged over ``microbatches`` and
    the gradients (name -> tensor, owned by the caller; the parameters'
    ``.grad`` is cleared), averaged the same way."""
    named = named_params(params)
    for p in named.values():
        p.grad = None
    direct = all(p.dtype == accum_dtype for p in named.values())
    acc = None if direct else {n: torch.zeros_like(p, dtype=accum_dtype)
                               for n, p in named.items()}
    loss_acc = None
    parts = [batch] if microbatches == 1 else _microbatches(batch, microbatches)
    with torch.enable_grad(), _replicated(named):
        for part in parts:
            loss = loss_fn(params, part)
            loss.backward()
            loss = loss.detach().float()
            loss_acc = loss if loss_acc is None else loss_acc + loss
            if acc is not None:
                for n, p in named.items():
                    if p.grad is not None:
                        acc[n] += _grad_of(p).to(accum_dtype)
                    p.grad = None
    if acc is None:
        grads = {n: _grad_of(p) if p.grad is not None else torch.zeros_like(p)
                 for n, p in named.items()}
        for p in named.values():
            p.grad = None
    else:
        grads = acc
    if microbatches > 1:
        with _replicated(named):
            mb = torch.full((), float(microbatches), device=loss_acc.device)
            loss_acc = loss_acc / mb
            for g in grads.values():
                g.div_(mb.to(g.dtype))
    return _full(loss_acc), grads


def make_train_step(loss_fn: Callable, opt_cfg: OptimizerConfig,
                    comp_cfg: CompressionConfig | None = None, microbatches: int = 1,
                    accum_dtype: torch.dtype = torch.float32) -> Callable:
    """``train_step(state, batch) -> (state, {"loss", "grad_norm"})``."""

    def train_step(state: TrainState, batch):
        named = named_params(state.params)
        loss, grads = value_and_grads(loss_fn, state.params, batch, microbatches, accum_dtype)
        with _replicated(named):
            grads, grad_norm = clip_by_global_norm(grads, opt_cfg.grad_clip)
            error_state = state.error_state
            if comp_cfg is not None and comp_cfg.kind != "none":
                grads, error_state = compress_grads(comp_cfg, grads, error_state, state.leaves)
            _, opt_state = apply_updates(opt_cfg, named, grads, state.opt_state, state.step,
                                         state.leaves)
        del grads
        new_state = dataclasses.replace(state, opt_state=opt_state, error_state=error_state,
                                        step=state.step + 1)
        return new_state, {"loss": loss, "grad_norm": _full(grad_norm)}

    return train_step
