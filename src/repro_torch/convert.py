"""Carry state across from the reference package.

The reference's arrays come in as numpy (``np.asarray`` of a jax array)
and leave as numpy, so this module imports neither jax nor ``repro``.  The
tests use it to feed both packages the same graph and warm state, and the
same LM, DLRM and GNN weights.
"""

from __future__ import annotations

from dataclasses import asdict, fields

import numpy as np
import torch

from repro_torch.core.constants import LinkModel
from repro_torch.core.hytm import HyTMResult, HyTMState
from repro_torch.core.partition import DevicePartitions
from repro_torch.graph.csr import CSRGraph, DeviceCSR
from repro_torch.kernels.runtime import resolve_device
from repro_torch.models.dlrm import DLRM, DLRMConfig
from repro_torch.models.gnn import ARCHITECTURES, GNN, GNNConfig
from repro_torch.models.moe import shard_moe_params
from repro_torch.models.transformer import Transformer, TransformerConfig, model_shards


def _up(a, dtype: torch.dtype, device: torch.device) -> torch.Tensor:
    return torch.from_numpy(np.array(a)).to(device=device, dtype=dtype)


def csr_graph(indptr, indices, weights=None) -> CSRGraph:
    """A host ``CSRGraph`` from the reference's CSR arrays."""
    return CSRGraph(indptr=np.asarray(indptr), indices=np.asarray(indices),
                    weights=None if weights is None else np.asarray(weights))


def device_csr(arrays: dict, device: str | torch.device | None = None) -> DeviceCSR:
    """A ``DeviceCSR`` from the reference's ``DeviceCSR`` fields (arrays
    plus the ``n_nodes``/``n_edges`` ints)."""
    dev = resolve_device(device)
    i32, f32 = torch.int32, torch.float32
    return DeviceCSR(
        edge_src=_up(arrays["edge_src"], i32, dev),
        edge_dst=_up(arrays["edge_dst"], i32, dev),
        edge_weight=_up(arrays["edge_weight"], f32, dev),
        edge_valid=_up(arrays["edge_valid"], torch.bool, dev),
        out_degree=_up(arrays["out_degree"], i32, dev),
        seg_start=_up(arrays["seg_start"], i32, dev),
        n_nodes=int(arrays["n_nodes"]),
        n_edges=int(arrays["n_edges"]),
    )


def device_partitions(arrays: dict,
                      device: str | torch.device | None = None) -> DevicePartitions:
    """A ``DevicePartitions`` from the reference's fields."""
    dev = resolve_device(device)
    i32 = torch.int32
    return DevicePartitions(
        vertex_start=_up(arrays["vertex_start"], i32, dev),
        edge_start=_up(arrays["edge_start"], i32, dev),
        part_edges=_up(arrays["part_edges"], i32, dev),
        vertex_part_id=_up(arrays["vertex_part_id"], i32, dev),
        n_partitions=int(arrays["n_partitions"]),
        block_size=int(arrays["block_size"]),
    )


def hytm_state(values, delta, frontier,
               device: str | torch.device | None = None) -> HyTMState:
    """A ``HyTMState`` from a (values, delta, frontier) triple."""
    dev = resolve_device(device)
    return HyTMState(values=_up(values, torch.float32, dev),
                     delta=_up(delta, torch.float32, dev),
                     frontier=_up(frontier, torch.bool, dev))


def link_model(field_values: dict) -> LinkModel:
    """A ``LinkModel`` from the reference's field dict
    (``dataclasses.asdict`` of its ``LinkModel``); validated on creation."""
    names = {f.name for f in fields(LinkModel)}
    unknown = set(field_values) - names
    if unknown:
        raise ValueError(f"unknown LinkModel fields: {sorted(unknown)}")
    return LinkModel(**field_values)


def result_to_numpy(res: HyTMResult) -> dict:
    """A ``HyTMResult`` as a dict of numpy arrays and Python numbers."""
    out = asdict(res)
    out["history"] = {k: np.asarray(v) for k, v in res.history.items()}
    return out


def _put(caller: str, param: torch.Tensor, a) -> None:
    a = np.asarray(a)
    if a.shape != tuple(param.shape):
        raise ValueError(f"{caller}: shape {a.shape}, expected {tuple(param.shape)}")
    param.copy_(torch.from_numpy(np.array(a, dtype=np.float32)))


@torch.no_grad()
def transformer_params(np_tree: dict, cfg: TransformerConfig,
                       device: str | torch.device | None = None,
                       dtype: torch.dtype | None = None, mesh=None,
                       batch_axes=("data",)) -> Transformer:
    """A ``Transformer`` holding the reference's parameter tree (numpy
    arrays: ``embed``, ``final_norm``, optional ``unembed``, the
    ``prefix`` list of dense layers (``first_dense_layers`` when ``moe`` is
    set), and ``layers`` stacked on axis 0 by the reference's scan over the
    others, each with ``attn`` (GQA or MLA keys) and ``ffn`` or ``moe``).
    The weights are cast to ``dtype`` (default ``cfg.param_dtype``); a MoE
    router stays float32 whatever ``dtype`` is.  With ``mesh`` (a
    ``launch.mesh.ModelMesh``), the model holds this rank's MoE shards over
    ``batch_axes`` and ``model`` (``moe.shard_moe_params`` of the whole
    arrays)."""
    dev = resolve_device(device)
    if dtype is not None:
        cfg = cfg.replace(param_dtype=str(dtype).removeprefix("torch."))
    model = Transformer(cfg, dev, mesh, batch_axes)
    shards = model_shards(cfg, mesh, batch_axes)

    def put(param: torch.Tensor, a) -> None:
        _put("transformer_params", param, a)

    put(model.embed, np_tree["embed"])
    put(model.final_norm, np_tree["final_norm"])
    if not cfg.tie_embeddings:
        put(model.unembed, np_tree["unembed"])
    prefix, stacked = np_tree.get("prefix") or [], np_tree["layers"]
    n = np.asarray(stacked["ln1"]).shape[0]
    if len(prefix) != cfg.n_prefix_layers or n != cfg.n_scan_layers:
        raise ValueError(f"transformer_params: {len(prefix)} prefix and {n} stacked layers, "
                         f"config has {cfg.n_prefix_layers} and {cfg.n_scan_layers}")
    trees = [(tree, None) for tree in prefix] + [(stacked, i) for i in range(n)]
    for layer, (tree, i) in zip(model.layers, trees):
        def at(a):
            return a if i is None else a[i]

        put(layer.ln1, at(tree["ln1"]))
        put(layer.ln2, at(tree["ln2"]))
        for group in ("attn", "ffn", "moe"):
            params = getattr(layer, group)
            if params is None:
                continue
            if group not in tree or set(params) != set(tree[group]):
                raise ValueError(f"transformer_params: {group} holds "
                                 f"{sorted(tree.get(group, ()))}, expected {sorted(params)}")
            arrays = {name: at(np.asarray(a)) for name, a in tree[group].items()}
            if group == "moe":
                arrays = shard_moe_params(arrays, cfg.moe, *shards)
            for name, param in params.items():
                put(param, arrays[name])
    return model


@torch.no_grad()
def dlrm_params(np_tree: dict, cfg: DLRMConfig,
                device: str | torch.device | None = None) -> DLRM:
    """A ``DLRM`` holding the reference's parameter tree (numpy arrays:
    ``tables`` a list of (V_i, D), ``bot`` and ``top`` each ``{"w": [...],
    "b": [...]}``)."""
    model = DLRM(cfg, resolve_device(device))
    for name, params in (("tables", model.tables), ("bot.w", model.bot["w"]),
                         ("bot.b", model.bot["b"]), ("top.w", model.top["w"]),
                         ("top.b", model.top["b"])):
        tree = np_tree
        for key in name.split("."):
            tree = tree[key]
        if len(tree) != len(params):
            raise ValueError(f"dlrm_params: {len(tree)} arrays in {name}, config has "
                             f"{len(params)}")
        for param, a in zip(params, tree):
            _put("dlrm_params", param, a)
    return model


def _put_tree(node, tree, path: str) -> None:
    """Copy the reference's (sub)tree into a module built from the same
    layout, checking every key set, list length and shape."""
    if isinstance(node, torch.Tensor):
        _put(f"gnn_params: {path}", node, tree)
    elif isinstance(node, (torch.nn.ModuleList, torch.nn.ParameterList)):
        if not isinstance(tree, (list, tuple)) or len(tree) != len(node):
            got = len(tree) if isinstance(tree, (list, tuple)) else type(tree).__name__
            raise ValueError(f"gnn_params: {got} entries in {path}, config has {len(node)}")
        for i, (item, sub) in enumerate(zip(node, tree)):
            _put_tree(item, sub, f"{path}[{i}]")
    else:
        names = [k for k, _ in node.named_children()]
        names += [k for k, _ in node.named_parameters(recurse=False)]
        if not isinstance(tree, dict) or set(tree) != set(names):
            got = sorted(tree) if isinstance(tree, dict) else type(tree).__name__
            raise ValueError(f"gnn_params: {path or 'the tree'} holds {got}, expected "
                             f"{sorted(names)}")
        for name in names:
            _put_tree(getattr(node, name), tree[name], f"{path}.{name}" if path else name)


@torch.no_grad()
def gnn_params(np_tree: dict, cfg: GNNConfig,
               device: str | torch.device | None = None) -> GNN:
    """The architecture of ``cfg`` holding the reference's parameter tree
    (numpy arrays, as ``repro.models.gnn.init_gnn`` lays it out; PNA's
    scalar ``avg_log_deg`` included)."""
    model = ARCHITECTURES[cfg.arch](cfg, resolve_device(device))
    _put_tree(model, np_tree, "")
    return model
