"""Atomic, async checkpoints of a training state (port of
``repro.train.checkpoint``).

Layout per step::

    <dir>/step_000123.tmp/   -> written, then renamed to
    <dir>/step_000123/
        manifest.json        — step, each leaf's shape and dtype
        arrays.npz           — one entry per leaf, keyed by its path

* atomic: the tmp-dir rename is the commit point; a crash mid-write leaves
  only a ``.tmp`` directory that ``latest_steps`` ignores and the next
  write reaps.
* async: the snapshot (a host copy of every tensor) is taken before
  ``save_checkpoint`` returns, and the write runs on a thread (one writer
  at a time, under one lock), so training may update the state in place
  at once.  The snapshot copies even a CPU tensor: ``.cpu()`` of one, and
  ``.numpy()``, share its storage, and the next step's in-place update
  would reach the file.
* restore: into the structure of a target state, each tensor copied in
  place onto the target's tensor (so onto its device, and a model's
  parameters stay its parameters); ints take the saved value.

Trees are dicts, lists, tuples, ``nn.Module`` (its named parameters),
dataclasses (their fields, except those marked ``metadata={"static":
True}``), tensors and Python numbers; ``None`` stays ``None``.  Keys are
the port's names joined by dots (``params.layers.0.attn.wq``,
``opt_state.m.layers.attn.wq``, ``step``); the port does not read the
reference's files.  bfloat16 tensors are stored as their int16 bits, the
manifest naming the dtype.
"""

from __future__ import annotations

import dataclasses
import json
import os
import shutil
import threading
from typing import Any

import numpy as np
import torch
from torch import nn

# One writer at a time: otherwise an earlier writer's cleanup can reap a
# newer writer's in-progress .tmp directory.
_WRITE_LOCK = threading.Lock()


def _children(tree) -> list | None:
    """(key, child) pairs of a container, or None for a leaf."""
    if isinstance(tree, nn.Module):
        return list(tree.named_parameters())
    if dataclasses.is_dataclass(tree) and not isinstance(tree, type):
        return [(f.name, getattr(tree, f.name)) for f in dataclasses.fields(tree)
                if not f.metadata.get("static")]
    if isinstance(tree, dict):
        return [(str(k), v) for k, v in tree.items()]
    if isinstance(tree, (list, tuple)):
        return [(str(i), v) for i, v in enumerate(tree)]
    return None


def _flatten(tree, prefix: str = "") -> list:
    kids = _children(tree)
    if kids is None:
        return [] if tree is None else [(prefix, tree)]
    out = []
    for key, child in kids:
        out += _flatten(child, f"{prefix}.{key}" if prefix else key)
    return out


def _snapshot(leaf) -> np.ndarray:
    if isinstance(leaf, torch.Tensor):
        t = leaf.detach()
        if hasattr(t, "full_tensor"):   # a DTensor: its whole value, a collective
            t = t.full_tensor()
        t = t.to("cpu", copy=True)
        return t.view(torch.int16).numpy() if t.dtype == torch.bfloat16 else t.numpy()
    return np.asarray(leaf)


def save_checkpoint(directory: str, step: int, tree: Any, async_write: bool = False,
                    keep: int = 3, mesh=None) -> threading.Thread | None:
    """Write ``tree`` as step ``step`` under ``directory``, keeping the
    ``keep`` newest steps; with ``async_write``, return the writer thread
    (join it before reading the step back).

    On a mesh (``mesh``, a ``launch.mesh.ModelMesh``; SPMD, every rank
    calls it with the same tree), each DTensor is gathered whole on every
    rank (``full_tensor``, a collective at the same point everywhere), the
    mesh's rank 0 alone writes, synchronously, and every rank then passes
    ``mesh_barrier``, so the step is committed when any rank returns."""
    if mesh is not None:
        from repro_torch.launch.mesh import mesh_barrier

        if mesh.rank == 0:
            save_checkpoint(directory, step, tree, keep=keep)
        else:
            _flatten_snapshot(tree)
        mesh_barrier(mesh)
        return None
    os.makedirs(directory, exist_ok=True)
    leaves = _flatten(tree)
    # snapshot synchronously (device -> host, copied) so training can mutate state
    snapshot = _flatten_snapshot(tree)
    dtypes = {key: (str(leaf.dtype).removeprefix("torch.") if isinstance(leaf, torch.Tensor)
                    else str(snapshot[key].dtype)) for key, leaf in leaves}

    def write():
        with _WRITE_LOCK:
            _write_locked()

    def _write_locked():
        final = os.path.join(directory, f"step_{step:08d}")
        tmp = final + ".tmp"
        if os.path.exists(tmp):
            shutil.rmtree(tmp)
        os.makedirs(tmp)
        np.savez(os.path.join(tmp, "arrays.npz"), **snapshot)
        manifest = {"step": step,
                    "leaves": {k: {"shape": list(v.shape), "dtype": dtypes[k]}
                               for k, v in snapshot.items()}}
        with open(os.path.join(tmp, "manifest.json"), "w") as f:
            json.dump(manifest, f)
        if os.path.exists(final):
            shutil.rmtree(final)
        os.rename(tmp, final)  # commit point
        _cleanup(directory, keep)

    if async_write:
        t = threading.Thread(target=write, daemon=True)
        t.start()
        return t
    write()
    return None


def _flatten_snapshot(tree) -> dict:
    return {key: _snapshot(leaf) for key, leaf in _flatten(tree)}


def _cleanup(directory: str, keep: int) -> None:
    steps = sorted(latest_steps(directory))
    for s in steps[:-keep] if keep > 0 else []:
        shutil.rmtree(os.path.join(directory, f"step_{s:08d}"), ignore_errors=True)
    for name in os.listdir(directory):
        if name.endswith(".tmp"):
            shutil.rmtree(os.path.join(directory, name), ignore_errors=True)


def latest_steps(directory: str) -> list[int]:
    """The committed steps under ``directory``, ascending."""
    if not os.path.isdir(directory):
        return []
    out = []
    for name in os.listdir(directory):
        if name.startswith("step_") and not name.endswith(".tmp"):
            if os.path.exists(os.path.join(directory, name, "manifest.json")):
                out.append(int(name[5:]))
    return sorted(out)


@torch.no_grad()
def _restore(tree, prefix: str, loaded: dict, dtypes: dict, fresh: bool = False):
    """``fresh``: each tensor a new plain tensor on the target's device (a
    module's parameters replaced), for placing anew; else copied in
    place."""
    kids = _children(tree)
    if kids is None:
        if tree is None:
            return None
        if prefix not in loaded:
            raise KeyError(f"checkpoint missing leaf {prefix}")
        a = loaded[prefix]
        if isinstance(tree, torch.Tensor):
            t = torch.from_numpy(a)
            if dtypes[prefix] == "bfloat16":
                t = t.view(torch.bfloat16)
            if tuple(t.shape) != tuple(tree.shape):
                raise ValueError(f"checkpoint leaf {prefix}: shape {tuple(t.shape)}, target "
                                 f"{tuple(tree.shape)}")
            if fresh:
                return t.to(tree.device, copy=True)
            tree.copy_(t)
            return tree
        return type(tree)(a.item())
    new = {key: _restore(child, f"{prefix}.{key}" if prefix else key, loaded, dtypes, fresh)
           for key, child in kids}
    if isinstance(tree, nn.Module):
        if fresh:
            from repro_torch.dist.sharding import set_parameter

            for name, p in kids:
                set_parameter(tree, name, nn.Parameter(new[name], requires_grad=p.requires_grad))
        return tree
    if dataclasses.is_dataclass(tree):
        return dataclasses.replace(tree, **new)
    if isinstance(tree, dict):
        return {k: new[str(k)] for k in tree}
    return type(tree)(new[str(i)] for i in range(len(tree)))


def restore_checkpoint(directory: str, target_tree: Any, step: int | None = None,
                       shardings=None, device_mesh=None):
    """(step, tree): the newest step (or ``step``) restored into the
    structure of ``target_tree``, its tensors copied in place into the
    target's tensors (on their devices).

    The elastic restart: with ``shardings`` (a same-structure tree of
    specs, ``dist.sharding.tree_shardings`` on the new mesh) and
    ``device_mesh`` (the new mesh's ``DeviceMesh``), each leaf is read
    whole and placed by its spec on ``device_mesh`` (``distribute``),
    whatever mesh the target's tensors were on; a module's parameters are
    replaced by the placed ones.  SPMD: every rank of the new mesh calls
    it."""
    steps = latest_steps(directory)
    if not steps:
        raise FileNotFoundError(f"no checkpoints under {directory}")
    step = steps[-1] if step is None else step
    path = os.path.join(directory, f"step_{step:08d}")
    with np.load(os.path.join(path, "arrays.npz")) as data:
        loaded = {k: data[k] for k in data.files}
    with open(os.path.join(path, "manifest.json")) as f:
        dtypes = {k: v["dtype"] for k, v in json.load(f)["leaves"].items()}
    if shardings is None:
        return step, _restore(target_tree, "", loaded, dtypes)
    from repro_torch.dist.sharding import distribute

    tree = _restore(target_tree, "", loaded, dtypes, fresh=True)
    return step, distribute(tree, device_mesh, shardings)
