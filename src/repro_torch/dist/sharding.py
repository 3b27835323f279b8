"""Path-rule sharding DSL: regex rules over parameter paths -> partition
specs -> DTensor placements (port of ``repro.dist.sharding``).

The rule lists say *what* to shard; this module turns a rule list into a
same-structure tree of :class:`PartitionSpec` for any parameter,
optimizer or cache tree, and places a tree on a
``torch.distributed.device_mesh.DeviceMesh`` from its specs::

  rule  = [(path_regex, PartitionSpec), ...]   # first match wins
  specs = tree_shardings(tree, mesh, rule)
  tree  = distribute(tree, device_mesh, specs)

Matching conventions, as in the reference:

* A leaf's path is the "/"-joined key path.  The port's names are dotted
  (``layers.3.attn.wq``, a ``TrainState``'s ``opt_state.m.layers.attn.wq``)
  and every dot becomes a "/" (``params/layers/3/attn/wq``).  Rules use
  ``re.search``, so a rule written for ``.../attn/wq`` also matches the
  optimizer's moment trees.
* Specs are **right-aligned** onto the leaf's trailing dims, so a
  per-layer parameter of the port gets the trailing-dim spec of the
  reference's stacked ``(n_layers, ...)`` leaf, and the optimizer state
  (kept in the reference's stacked leaf shapes) gets the reference's spec.
* A dim whose size does not divide the product of its mesh axes
  replicates (``None``); unmatched leaves replicate (``P()``).

A mesh here is anything with axis names and sizes: a
``launch.mesh.ModelMesh``, a ``DeviceMesh`` (``mesh_dim_names``), or a
stub with ``axis_names`` and a ``shape`` dict, as the reference's tests
use.  ``placements(spec, ndim, device_mesh)`` gives the DTensor
placements of a spec: an entry naming several axes, ``("pod", "data")``,
becomes ``Shard(d)`` on each of those mesh dims, which DTensor splits in
mesh-dim order, so the axes must be named in the mesh's order (pod-major,
as the reference's ``P(("pod", "data"))`` splits).
"""

from __future__ import annotations

import contextlib
import dataclasses
import re
from collections.abc import Mapping
from typing import Any, Sequence

import torch
from torch import nn

# Mesh axes a batch dimension may shard over, outermost first.
_BATCH_AXIS_ORDER = ("pod", "data")


class PartitionSpec(tuple):
    """One entry a tensor dim: ``None`` (replicated), an axis name, or a
    tuple of axis names (the dim split over their product)."""

    def __new__(cls, *entries):
        return super().__new__(cls, entries)

    def __repr__(self) -> str:
        return f"P{tuple.__repr__(self)}"


P = PartitionSpec
Rule = Sequence[tuple[str, PartitionSpec]]


def _axis_names(mesh) -> tuple:
    names = getattr(mesh, "axis_names", None)
    return tuple(names if names is not None else mesh.mesh_dim_names)


def _axis_sizes(mesh) -> dict:
    shape = mesh.shape
    if isinstance(shape, Mapping):
        return {a: int(s) for a, s in shape.items()}
    return dict(zip(_axis_names(mesh), (int(s) for s in shape)))


def batch_axes(mesh) -> tuple[str, ...]:
    """Mesh axes the batch dimension shards over (present-axis subset of
    ('pod', 'data'), outermost first).  Empty tuple == replicated batch."""
    names = _axis_names(mesh)
    return tuple(a for a in _BATCH_AXIS_ORDER if a in names)


def path_str(path) -> str:
    """'/'-joined path of a key sequence, each key's dots split too."""
    return "/".join(str(k).replace(".", "/") for k in path)


def _axes_size(sizes: dict, entry) -> int:
    size = 1
    for a in entry if isinstance(entry, tuple) else (entry,):
        size *= sizes[a]
    return size


def fit_spec(spec: PartitionSpec, shape: tuple[int, ...], mesh) -> PartitionSpec:
    """Right-align ``spec`` onto ``shape`` and drop non-dividing entries.

    Leading spec entries are discarded when the spec is longer than the
    leaf rank (a rank-2 rule hitting a bias vector keeps only its last
    entry); leading dims beyond the spec replicate.
    """
    sizes = _axis_sizes(mesh)
    entries = list(spec)
    if len(entries) > len(shape):
        entries = entries[len(entries) - len(shape):]
    entries = [None] * (len(shape) - len(entries)) + entries
    out = []
    for dim, entry in zip(shape, entries):
        if entry is None or entry == ():
            out.append(None)
            continue
        size = _axes_size(sizes, entry)
        out.append(entry if size > 0 and dim % size == 0 else None)
    while out and out[-1] is None:
        out.pop()
    return P(*out)


def spec_for(path: str, shape: tuple[int, ...], mesh, rule: Rule) -> PartitionSpec:
    """Resolve the PartitionSpec for one leaf (first matching rule wins)."""
    for pattern, spec in rule:
        if re.search(pattern, path):
            return fit_spec(spec, shape, mesh)
    return P()


def _children(tree) -> list | None:
    """(key, child) pairs of a container, or None for a leaf: an
    ``nn.Module`` holds its named parameters, a dataclass its fields (not
    those marked ``metadata={"static": True}``)."""
    if isinstance(tree, nn.Module):
        return list(tree.named_parameters())
    if dataclasses.is_dataclass(tree) and not isinstance(tree, type):
        return [(f.name, getattr(tree, f.name)) for f in dataclasses.fields(tree)
                if not f.metadata.get("static")]
    if isinstance(tree, Mapping):
        return [(k, v) for k, v in tree.items()]
    if isinstance(tree, (list, tuple)):
        return list(enumerate(tree))
    return None


def tree_shardings(tree: Any, mesh, rule: Rule):
    """Map a rule list over a tree -> a same-structure tree of specs: a
    module, a dataclass and a dict become dicts (a module's by parameter
    name), a list or tuple the same type; ``None`` stays ``None``; every
    other leaf gets its spec (a non-tensor, ``P()``)."""

    def walk(node, path):
        kids = _children(node)
        if kids is None:
            if node is None:
                return None
            shape = tuple(node.shape) if isinstance(node, torch.Tensor) else ()
            return spec_for(path_str(path), shape, mesh, rule)
        out = {k: walk(child, path + (k,)) for k, child in kids}
        if isinstance(node, (list, tuple)):
            return type(node)(out[i] for i in range(len(node)))
        return out

    return walk(tree, ())


def placements(spec: PartitionSpec, ndim: int, device_mesh) -> list:
    """DTensor placements of ``spec`` on a ``ndim``-dim tensor: one a mesh
    dim, ``Shard(d)`` where dim ``d``'s entry names that mesh dim, else
    ``Replicate()``.  A dim over several axes must name them in the mesh's
    order (DTensor splits in that order)."""
    from torch.distributed.tensor import Replicate, Shard

    names = _axis_names(device_mesh)
    out = [Replicate() for _ in names]
    if len(spec) > ndim:
        raise ValueError(f"spec {spec!r} is longer than a {ndim}-dim tensor")
    for d, entry in enumerate(spec):
        if entry is None or entry == ():
            continue
        axes = entry if isinstance(entry, tuple) else (entry,)
        idx = [names.index(a) for a in axes]
        if idx != sorted(idx):
            raise ValueError(f"spec {spec!r}: dim {d} names {axes}, not in the mesh's order "
                             f"{names}")
        for i in idx:
            if not isinstance(out[i], Replicate):
                raise ValueError(f"spec {spec!r}: mesh axis {names[i]!r} shards two dims")
            out[i] = Shard(d)
    return out


@contextlib.contextmanager
def implicit_replication():
    """DTensor's ``implicit_replication`` (plain tensors meet DTensors as
    replicated ones), nestable: an inner use leaves the setting as the
    outer one made it (DTensor's own turns it off on every exit)."""
    from torch.distributed.tensor import DTensor
    from torch.distributed.tensor.experimental import implicit_replication as _implicit

    if DTensor._op_dispatcher._allow_implicit_replication:
        yield
        return
    with _implicit():
        yield


def set_parameter(module: nn.Module, name: str, value: nn.Parameter) -> None:
    """Replace ``module``'s parameter ``name`` (dotted) by ``value``."""
    owner, _, leaf = name.rpartition(".")
    (module.get_submodule(owner) if owner else module)._parameters[leaf] = value


def distribute(tree: Any, device_mesh, specs, make_local=None):
    """``tree`` with every tensor placed on ``device_mesh`` by its spec in
    ``specs`` (``tree_shardings``'s tree): ``distribute_tensor`` from each
    rank's own copy (``src_data_rank=None``: no collective; every rank
    must hold the same values; a shard is a copy, so the whole tensor can
    be freed), or, with ``make_local`` (``(tensor, local shape) -> this rank's
    shard``), a DTensor of the shard it makes (the dry run's, which makes
    an empty one).  A module's parameters are replaced in
    place by DTensor parameters (``requires_grad`` kept) and the module
    returned; dataclasses are replaced field by field, dicts and sequences
    rebuilt."""
    from torch.distributed.tensor import DTensor, Shard, distribute_tensor

    def place(t: torch.Tensor, spec) -> torch.Tensor:
        pl = placements(spec, t.ndim, device_mesh)
        if make_local is not None:
            shape = list(t.shape)   # rank 0's shard: the first, largest chunk
            for i, p in enumerate(pl):
                if isinstance(p, Shard):
                    shape[p.dim] = -(-shape[p.dim] // device_mesh.size(i))
            return DTensor.from_local(make_local(t, tuple(shape)), device_mesh, pl, run_check=False,
                                      shape=t.shape, stride=t.stride())
        if isinstance(t, DTensor):
            return t.redistribute(device_mesh, pl)
        d = distribute_tensor(t.detach(), device_mesh, pl, src_data_rank=None)
        local = d.to_local()
        if (local.numel() < t.numel()
                and local.untyped_storage().data_ptr() == t.untyped_storage().data_ptr()):
            # a shard that views the whole tensor would keep the whole alive
            d = DTensor.from_local(local.clone(), device_mesh, pl, run_check=False,
                                   shape=d.shape, stride=d.stride())
        return d

    def walk(node, spec):
        if isinstance(node, nn.Module):
            for name, p in list(node.named_parameters()):
                set_parameter(node, name, nn.Parameter(place(p, spec[name]),
                                                    requires_grad=p.requires_grad))
            return node
        if dataclasses.is_dataclass(node) and not isinstance(node, type):
            return dataclasses.replace(node, **{k: walk(v, spec[k])
                                                for k, v in _children(node)})
        if isinstance(node, Mapping):
            return {k: walk(v, spec[k]) for k, v in node.items()}
        if isinstance(node, (list, tuple)):
            return type(node)(walk(v, s) for v, s in zip(node, spec))
        if isinstance(node, torch.Tensor):
            return place(node, spec)
        return node

    return walk(tree, specs)


# ------------------------------------------------------------------- LM

def lm_rule(mesh) -> Rule:
    """Megatron-style tensor parallelism over the ``model`` axis.

    Column-parallel into attention/FFN (shard the output-feature dim),
    row-parallel out of them (shard the input-feature dim); embeddings
    shard the vocab dim.  MoE expert banks additionally shard the expert
    axis over the batch axes (EP width == DP width).
    """
    ba = batch_axes(mesh)
    expert = ba if len(ba) > 1 else (ba[0] if ba else None)
    return [
        (r"(^|/)(embed|unembed)$", P("model", None)),
        (r"/attn/(wq|wk|wv|w_uq|w_uk|w_uv|w_dq|w_dkv|w_kr)$", P(None, "model")),
        (r"/attn/wo$", P("model", None)),
        (r"/moe/router$", P()),
        (r"/moe/(w_gate|w_up)$", P(expert, None, "model")),
        (r"/moe/w_down$", P(expert, "model", None)),
        (r"/moe/(shared_gate|shared_up)$", P(None, "model")),
        (r"/moe/shared_down$", P("model", None)),
        (r"/ffn/(w_gate|w_up|w_in)$", P(None, "model")),
        (r"/ffn/w_down$", P("model", None)),
    ]


def lm_cache_rule(mesh, n_kv_heads: int) -> Rule:
    """KV-cache specs for serving: the KV heads shard over ``model`` when
    their count divides it; otherwise (MQA's kv=1, MLA's headless latent
    cache) the *sequence* dim shards instead."""
    ba = batch_axes(mesh)
    n_model = _axis_sizes(mesh).get("model", 1)
    if n_model > 1 and n_kv_heads % n_model == 0:
        kv = P(ba, None, "model", None)
    else:
        kv = P(ba, "model", None, None)
    return [
        (r"(^|/)[kv]$", kv),
        (r"(^|/)(ckv|kr)$", P(ba, "model", None)),
    ]


def lm_batch_spec(mesh) -> PartitionSpec:
    """(B, S) token batches: batch dim over the batch axes."""
    return P(batch_axes(mesh), None)


# ------------------------------------------------------------------ GNN

def gnn_rule(mesh) -> Rule:
    """GNN training is data-parallel over nodes/edges; dense kernels
    column-shard their output features over ``model`` (the divisibility
    guard replicates the ones that do not divide)."""
    return [
        (r"(^|/)(w_self|w_nbr|w_msg|w_upd|A|B|C|U|V|out|embed_h|embed_e)$",
         P(None, "model")),
        (r"/(edge_mlp|node_mlp|enc_node|enc_edge|dec)/w/\d+$", P(None, "model")),
    ]


def gnn_data_spec(mesh, kind: str) -> PartitionSpec:
    """Graph-data batch specs: 1-D per-node/per-edge arrays ('vector') and
    2-D feature matrices ('matrix') shard their leading dim over the batch
    axes."""
    ba = batch_axes(mesh)
    if kind == "vector":
        return P(ba)
    if kind == "matrix":
        return P(ba, None)
    raise ValueError(f"unknown gnn data kind: {kind!r}")


# ----------------------------------------------------------------- DLRM

def dlrm_rule(mesh) -> Rule:
    """Row-shard the embedding tables over ``model``; MLP towers
    column-shard like the LM FFN."""
    return [
        (r"(^|/)tables/\d+$", P("model", None)),
        (r"/(bot|top)/w/\d+$", P(None, "model")),
    ]
