"""GNN architectures for inference: GraphSAGE, PNA, GatedGCN, MeshGraphNet
(port of ``repro.models.gnn``).

Message passing is a scatter-combine by destination over an edge index
``(src, dst)``: ``index_add_`` for sums and means, ``scatter_reduce_``
("amax"/"amin" over a ∓inf fill) for max and min, the plain PyTorch
counterparts of the reference's ``jax.ops.segment_sum/max/min``.  The
reference aggregates outside Pallas too; on CUDA both ops add with
atomics, so two card runs may differ in the last bits.

Each architecture's parameters are an ``nn.Module`` of frozen parameters
laid out as the reference's parameter tree (dicts become attributes that
also answer ``[key]``, lists ``ModuleList``/``ParameterList``):
``init_gnn`` fills them from a ``torch.Generator``, ``convert.gnn_params``
from the reference's tree.  PNA carries ``avg_log_deg`` as a 0-d
parameter.  The forwards run in the parameters' dtype wherever the inputs
lie, with TF32 off (PyTorch's default); the losses take log-softmax in
float32 (float64 stays float64).

Training: ``gnn_loss`` and ``graphsage_minibatch_forward`` run under grad
mode (``gnn_forward``, a serving entry point, keeps
``torch.inference_mode``).  The max and min aggregators reduce with
``include_self=True`` over the ∓inf fill, so a tie (ReLU zeros make them
common) shares the gradient equally among the tied messages, as
``jax.ops.segment_max`` does; with ``include_self=False`` over a zero fill
the excluded fill would count as one more tie.
"""

from __future__ import annotations

import dataclasses
import math
from dataclasses import dataclass

import torch
import torch.nn.functional as F
from torch import nn

from repro_torch.kernels.runtime import resolve_device
from repro_torch.models.common import frozen, layer_norm, mlp_apply


@dataclass(frozen=True)
class GNNConfig:
    name: str
    arch: str                   # 'graphsage' | 'pna' | 'gatedgcn' | 'meshgraphnet'
    n_layers: int
    d_hidden: int
    d_in: int
    d_out: int
    aggregator: str = "mean"
    sample_sizes: tuple = ()    # GraphSAGE minibatch fanouts
    mlp_layers: int = 2         # MeshGraphNet MLP depth
    d_edge_in: int = 1          # edge feature dim (gatedgcn / meshgraphnet)
    task: str = "node"          # 'node' | 'graph' | 'regression'
    dtype: str = "float32"

    def replace(self, **kw) -> "GNNConfig":
        return dataclasses.replace(self, **kw)


# ------------------------------------------------------------ aggregation

def gather_rows(h: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """``h[idx]``.  On DTensors (a graph placed by ``dist.sharding``'s
    ``gnn_data_spec``, rows split over the batch axes) DTensor has no
    sharding of an index by a split index, so ``h`` is gathered whole over
    its row split first (an all-gather, in code that says so) and each rank
    takes the rows of its own indices under ``local_map``: the result is
    placed as ``idx`` on its rows and as ``h`` on its features; ``h``'s
    gradient is each rank's sum of its rows' gradients, a ``Partial`` over
    ``idx``'s split."""
    if not hasattr(h, "placements"):
        return h[idx]
    from torch.distributed.tensor import DTensor, Partial, Replicate, Shard
    from torch.distributed.tensor.experimental import local_map

    dm = h.device_mesh
    if not isinstance(idx, DTensor):
        idx = DTensor.from_local(idx, dm, [Replicate()] * dm.ndim, run_check=False)
    h_pl = [Replicate() if isinstance(p, Partial) or p == Shard(0) else p
            for p in h.placements]
    idx_pl = list(idx.placements)
    out_pl = [q if isinstance(q, Shard) else p for p, q in zip(h_pl, idx_pl)]
    grad_pl = [Partial() if isinstance(q, Shard) else p for p, q in zip(h_pl, idx_pl)]
    return local_map(lambda t, i: t[i.long()], out_placements=(out_pl,),
                     in_placements=(h_pl, idx_pl), in_grad_placements=(grad_pl, idx_pl),
                     device_mesh=dm)(h.redistribute(dm, h_pl), idx)


def _placed_aggregate(messages: torch.Tensor, dst: torch.Tensor, n: int,
                      how: str) -> torch.Tensor:
    """``aggregate`` on DTensors: messages and ``dst`` split by edge over
    the batch axes.  A sum (and so a mean's sum and count) is each rank's
    scatter of its own edges into all ``n`` rows under ``local_map``, a
    ``Partial`` sum over the edge split, exact (DTensor has no sharding of
    ``index_add_``), reduce-scattered onto the node rows' split.  Max and
    min have no such partial form here: their messages and destinations
    are gathered whole first (all-gathers, in code that says so) and every
    rank combines them all."""
    from torch.distributed.tensor import DTensor, Partial, Replicate, Shard
    from torch.distributed.tensor.experimental import local_map

    dm = (messages if isinstance(messages, DTensor) else dst).device_mesh
    if not isinstance(messages, DTensor):
        messages = DTensor.from_local(messages, dm, [Replicate()] * dm.ndim, run_check=False)
    m_pl = [Replicate() if isinstance(p, Partial) else p for p in messages.placements]
    if how in ("max", "min"):
        m_pl = [Replicate() if p == Shard(0) else p for p in m_pl]
    rows = [p == Shard(0) for p in m_pl]
    d_pl = [Shard(0) if r else Replicate() for r in rows]
    if how == "std":
        mean = _placed_aggregate(messages, dst, n, "mean")
        sq = _placed_aggregate(messages.square(), dst, n, "mean")
        return torch.sqrt(torch.maximum(sq - mean.square(), sq.new_zeros(())) + 1e-6)
    if how == "mean":
        s = _placed_aggregate(messages, dst, n, "sum")
        ones = torch.ones_like(dst, dtype=messages.dtype)[:, None]
        c = _placed_aggregate(ones, dst, n, "sum")
        return s / c.clamp_min(1.0)
    out_pl = [Partial() if r else p for r, p in zip(rows, m_pl)]
    messages = messages.redistribute(dm, m_pl)
    if not isinstance(dst, DTensor):
        dst = DTensor.from_local(dst, dm, [Replicate()] * dm.ndim, run_check=False)
    out = local_map(lambda m, d: aggregate(m, d, n, how), out_placements=(out_pl,),
                    in_placements=(m_pl, d_pl), in_grad_placements=(m_pl, d_pl),
                    device_mesh=dm)(messages, dst.redistribute(dm, d_pl))
    # the partial sums reduce-scattered onto the node rows' split (whole where
    # the rows do not split), so that they meet the node features as those do
    split = math.prod(dm.size(i) for i, p in enumerate(out_pl) if isinstance(p, Partial))
    rows_pl = [(Shard(0) if n % split == 0 else Replicate()) if isinstance(p, Partial) else p
               for p in out_pl]
    return out.redistribute(dm, rows_pl)


def aggregate(messages: torch.Tensor, dst: torch.Tensor, n: int, how: str) -> torch.Tensor:
    """The message-passing primitive (scatter-combine by destination).  A
    destination with no edge gets 0 from every combine; max and min also
    turn a combined ±inf into 0, as the reference does.  DTensors take
    ``_placed_aggregate``."""
    if hasattr(messages, "placements") or hasattr(dst, "placements"):
        return _placed_aggregate(messages, dst, n, how)
    if how == "sum":
        return messages.new_zeros((n, *messages.shape[1:])).index_add_(0, dst, messages)
    if how == "mean":
        s = aggregate(messages, dst, n, "sum")
        c = aggregate(torch.ones_like(messages[:, :1]), dst, n, "sum")
        return s / c.clamp_min(1.0)
    if how in ("max", "min"):
        out = messages.new_full((n, *messages.shape[1:]),
                                float("-inf") if how == "max" else float("inf"))
        index = dst.to(torch.int64).view(-1, *[1] * (messages.dim() - 1)).expand_as(messages)
        out.scatter_reduce_(0, index, messages, "amax" if how == "max" else "amin",
                            include_self=True)
        return torch.where(torch.isfinite(out), out, 0.0)
    if how == "std":
        mean = aggregate(messages, dst, n, "mean")
        sq = aggregate(messages.square(), dst, n, "mean")
        # torch.maximum, as jnp.maximum, sends half the gradient at a tie (a
        # destination with one message has a variance of exactly 0);
        # clamp_min would pass all of it
        return torch.sqrt(torch.maximum(sq - mean.square(), sq.new_zeros(())) + 1e-6)
    raise ValueError(how)


# ------------------------------------------------------------- parameters
# A parameter tree's leaves: ("dense", (d_in, d_out)) normal / sqrt(d_in),
# ("zeros", shape), ("ones", shape).

def _dense(d_in: int, d_out: int) -> tuple:
    return ("dense", (d_in, d_out))


def _mlp(dims: list[int]) -> dict:
    return {"w": [_dense(dims[i], dims[i + 1]) for i in range(len(dims) - 1)],
            "b": [("zeros", (dims[i + 1],)) for i in range(len(dims) - 1)]}


class _Node(nn.Module):
    """A dict of the reference's tree: each key an attribute, also ``[key]``."""

    def __init__(self, tree: dict, device: torch.device):
        super().__init__()
        for key, sub in tree.items():
            setattr(self, key, _build(sub, device))

    def __getitem__(self, key: str):
        return getattr(self, key)


def _build(tree, device: torch.device):
    if isinstance(tree, dict):
        return _Node(tree, device)
    if isinstance(tree, list):
        items = [_build(sub, device) for sub in tree]
        if all(isinstance(item, nn.Parameter) for item in items):
            return nn.ParameterList(items)
        return nn.ModuleList(items)
    _, shape = tree
    return frozen(torch.empty(shape, device=device))


def _leaves(node, tree):
    """(parameter, leaf) pairs of a module built from ``tree``."""
    if isinstance(tree, dict):
        for key, sub in tree.items():
            yield from _leaves(node[key], sub)
    elif isinstance(tree, list):
        for item, sub in zip(node, tree):
            yield from _leaves(item, sub)
    else:
        yield node, tree


class GNN(_Node):
    """Base of the four architectures: ``tree(cfg)`` is the reference's
    parameter tree of ``cfg``, each leaf an uninitialised float32 parameter
    on ``device``."""

    @staticmethod
    def tree(cfg: GNNConfig) -> dict:
        raise NotImplementedError

    def __init__(self, cfg: GNNConfig, device: torch.device):
        super().__init__(self.tree(cfg), device)
        self.cfg = cfg


class GraphSAGE(GNN):
    @staticmethod
    def tree(cfg: GNNConfig) -> dict:
        dims = [cfg.d_in] + [cfg.d_hidden] * cfg.n_layers
        return {"layers": [{"w_self": _dense(dims[i], dims[i + 1]),
                            "w_nbr": _dense(dims[i], dims[i + 1]),
                            "b": ("zeros", (dims[i + 1],))} for i in range(cfg.n_layers)],
                "out": _dense(cfg.d_hidden, cfg.d_out)}


class PNA(GNN):
    @staticmethod
    def tree(cfg: GNNConfig) -> dict:
        dims = [cfg.d_in] + [cfg.d_hidden] * cfg.n_layers
        return {"layers": [{"w_msg": _dense(2 * dims[i], dims[i]),
                            "w_upd": _dense(dims[i] + 12 * dims[i], dims[i + 1]),
                            "b_upd": ("zeros", (dims[i + 1],))} for i in range(cfg.n_layers)],
                "out": _dense(cfg.d_hidden, cfg.d_out),
                "avg_log_deg": ("ones", ())}


class GatedGCN(GNN):
    @staticmethod
    def tree(cfg: GNNConfig) -> dict:
        d = cfg.d_hidden
        layer = {**{k: _dense(d, d) for k in "ABCUV"},
                 "ln_h": ("ones", (d,)), "ln_h_b": ("zeros", (d,)),
                 "ln_e": ("ones", (d,)), "ln_e_b": ("zeros", (d,))}
        return {"embed_h": _dense(cfg.d_in, d), "embed_e": _dense(cfg.d_edge_in, d),
                "layers": [dict(layer) for _ in range(cfg.n_layers)],
                "out": _dense(d, cfg.d_out)}


class MeshGraphNet(GNN):
    @staticmethod
    def tree(cfg: GNNConfig) -> dict:
        d = cfg.d_hidden
        hidden = [d] * cfg.mlp_layers
        layer = {"edge_mlp": _mlp([3 * d] + hidden + [d]),
                 "node_mlp": _mlp([2 * d] + hidden + [d]),
                 "ln_e": ("ones", (d,)), "ln_e_b": ("zeros", (d,)),
                 "ln_h": ("ones", (d,)), "ln_h_b": ("zeros", (d,))}
        return {"enc_node": _mlp([cfg.d_in] + hidden + [d]),
                "enc_edge": _mlp([cfg.d_edge_in] + hidden + [d]),
                "processor": [layer for _ in range(cfg.n_layers)],
                "dec": _mlp([d] + hidden + [cfg.d_out])}


ARCHITECTURES = {"graphsage": GraphSAGE, "pna": PNA, "gatedgcn": GatedGCN,
                 "meshgraphnet": MeshGraphNet}


@torch.no_grad()
def init_gnn(cfg: GNNConfig, generator: torch.Generator,
             device: str | torch.device | None = None) -> GNN:
    """The architecture of ``cfg`` with random weights from ``generator``
    (which must live on ``device``): dense weights normal with std
    1/sqrt(d_in), biases 0, norm scales 1, PNA's ``avg_log_deg`` 1."""
    dev = resolve_device(device)
    if generator.device.type != dev.type:
        raise ValueError(f"init_gnn: generator on {generator.device}, model on {dev}")
    cls = ARCHITECTURES[cfg.arch]
    model = cls(cfg, dev)
    for param, (kind, shape) in _leaves(model, cls.tree(cfg)):
        if kind == "dense":
            param.normal_(generator=generator).mul_(1.0 / shape[0] ** 0.5)
        else:
            param.fill_(1.0 if kind == "ones" else 0.0)
    return model


# --------------------------------------------------------------- forwards

def _unit_rows(h: torch.Tensor) -> torch.Tensor:
    return h / torch.linalg.vector_norm(h, dim=-1, keepdim=True).clamp_min(1e-6)


def graphsage_forward(model: GNN, feats: torch.Tensor, edge_src: torch.Tensor,
                      edge_dst: torch.Tensor, cfg: GNNConfig) -> torch.Tensor:
    """Full-graph forward."""
    h = feats
    n = feats.shape[0]
    for lp in model.layers:
        h_n = aggregate(gather_rows(h, edge_src), edge_dst, n, cfg.aggregator)
        h = _unit_rows(F.relu(h @ lp.w_self + h_n @ lp.w_nbr + lp.b))
    return h @ model.out


def graphsage_minibatch_forward(model: GNN, layer_feats: list[torch.Tensor],
                                cfg: GNNConfig | None = None) -> torch.Tensor:
    """Sampled forward: ``layer_feats[k]`` are features of hop-k vertices
    (hop-0 = seeds), shaped (b * prod(fanouts[:k]), d_in).  Aggregation is
    a reshape-mean over the fanout axis (a max for any other aggregator):
    the static-shape GraphSAGE estimator.  ``cfg`` defaults to
    ``model.cfg``; its ``sample_sizes`` are the fanouts."""
    cfg = model.cfg if cfg is None else cfg
    fan = cfg.sample_sizes
    hs = list(layer_feats)
    for li, lp in enumerate(model.layers):
        depth = len(fan) - li  # hops available this round
        new_hs = []
        for k in range(depth):
            parent = hs[k]
            child = hs[k + 1]
            agg = child.reshape(parent.shape[0], fan[k], child.shape[-1])
            agg = agg.mean(dim=1) if cfg.aggregator == "mean" else agg.amax(dim=1)
            new_hs.append(_unit_rows(F.relu(parent @ lp.w_self + agg @ lp.w_nbr + lp.b)))
        hs = new_hs
    return hs[0] @ model.out


PNA_AGGREGATORS = ("mean", "max", "min", "std")


def pna_forward(model: GNN, feats: torch.Tensor, edge_src: torch.Tensor,
                edge_dst: torch.Tensor, cfg: GNNConfig) -> torch.Tensor:
    h = feats
    n = feats.shape[0]
    deg = aggregate(torch.ones_like(edge_dst, dtype=h.dtype), edge_dst, n, "sum")
    log_deg = torch.log(deg + 1.0)[:, None]
    delta = model.avg_log_deg.clamp_min(1e-3)
    scalers = (
        torch.ones_like(log_deg),           # identity
        log_deg / delta,                    # amplification
        delta / log_deg.clamp_min(1e-3),    # attenuation
    )
    for lp in model.layers:
        msg = F.relu(torch.cat([gather_rows(h, edge_src), gather_rows(h, edge_dst)], dim=-1)
                     @ lp.w_msg)
        aggs = [aggregate(msg, edge_dst, n, a) for a in PNA_AGGREGATORS]
        scaled = [a * s for a in aggs for s in scalers]  # 4 x 3 = 12, aggregator-major
        del msg, aggs
        h = F.relu(torch.cat([h] + scaled, dim=-1) @ lp.w_upd + lp.b_upd)
    return h @ model.out


def gatedgcn_forward(model: GNN, feats: torch.Tensor, edge_src: torch.Tensor,
                     edge_dst: torch.Tensor, edge_feats: torch.Tensor,
                     cfg: GNNConfig) -> torch.Tensor:
    """Bresson & Laurent residual gated graph convnets [arXiv:1711.07553]
    (LayerNorm in place of BatchNorm, as the reference)."""
    n = feats.shape[0]
    h = feats @ model.embed_h
    e = edge_feats @ model.embed_e
    for lp in model.layers:
        h_src = gather_rows(h, edge_src)
        e_new = h_src @ lp.A + gather_rows(h, edge_dst) @ lp.B + e @ lp.C
        eta = torch.sigmoid(e_new)
        num = aggregate(eta * (h_src @ lp.V), edge_dst, n, "sum")
        den = aggregate(eta, edge_dst, n, "sum")
        del h_src, eta
        h_new = h @ lp.U + num / (den + 1e-6)
        h = h + F.relu(layer_norm(h_new, lp.ln_h, lp.ln_h_b))
        e = e + F.relu(layer_norm(e_new, lp.ln_e, lp.ln_e_b))
    return h @ model.out


def meshgraphnet_forward(model: GNN, feats: torch.Tensor, edge_src: torch.Tensor,
                         edge_dst: torch.Tensor, edge_feats: torch.Tensor,
                         cfg: GNNConfig) -> torch.Tensor:
    """Encode-process-decode [arXiv:2010.03409]; sum aggregator."""
    n = feats.shape[0]
    h = mlp_apply(model.enc_node, feats)
    e = mlp_apply(model.enc_edge, edge_feats)
    for lp in model.processor:
        e_in = torch.cat([e, gather_rows(h, edge_src), gather_rows(h, edge_dst)], dim=-1)
        e = e + layer_norm(mlp_apply(lp.edge_mlp, e_in), lp.ln_e, lp.ln_e_b)
        del e_in
        agg = aggregate(e, edge_dst, n, "sum")
        h_in = torch.cat([h, agg], dim=-1)
        h = h + layer_norm(mlp_apply(lp.node_mlp, h_in), lp.ln_h, lp.ln_h_b)
    return mlp_apply(model.dec, h)


# ------------------------------------------------------------- dispatch

@torch.inference_mode()
def gnn_forward(model: GNN, cfg: GNNConfig | None, feats: torch.Tensor,
                edge_src: torch.Tensor, edge_dst: torch.Tensor,
                edge_feats: torch.Tensor | None = None) -> torch.Tensor:
    """feats: (n, d_in); edge_src, edge_dst: (m,) int32 or int64 ->
    (n, d_out), on the inputs' device.  ``cfg`` (default ``model.cfg``)
    gives the architecture and its aggregator; GatedGCN and MeshGraphNet
    take ``edge_feats`` (m, d_edge_in), ones by default."""
    return _forward(model, cfg, feats, edge_src, edge_dst, edge_feats)


def _forward(model: GNN, cfg: GNNConfig | None, feats, edge_src, edge_dst, edge_feats=None):
    cfg = model.cfg if cfg is None else cfg
    if cfg.arch == "graphsage":
        return graphsage_forward(model, feats, edge_src, edge_dst, cfg)
    if cfg.arch == "pna":
        return pna_forward(model, feats, edge_src, edge_dst, cfg)
    if cfg.arch in ("gatedgcn", "meshgraphnet"):
        if edge_feats is None:
            edge_feats = feats.new_ones((edge_src.shape[0], cfg.d_edge_in))
        fwd = gatedgcn_forward if cfg.arch == "gatedgcn" else meshgraphnet_forward
        return fwd(model, feats, edge_src, edge_dst, edge_feats, cfg)
    raise ValueError(cfg.arch)


def _log_softmax(logits: torch.Tensor) -> torch.Tensor:
    return F.log_softmax(logits.to(torch.promote_types(logits.dtype, torch.float32)), dim=-1)


def gnn_loss(model: GNN, cfg: GNNConfig | None, feats: torch.Tensor, edge_src: torch.Tensor,
             edge_dst: torch.Tensor, labels: torch.Tensor,
             label_mask: torch.Tensor | None = None, edge_feats: torch.Tensor | None = None,
             graph_ids: torch.Tensor | None = None, n_graphs: int = 0) -> torch.Tensor:
    """The task's loss of one forward (``output_loss`` of the forward), under
    grad mode."""
    cfg = model.cfg if cfg is None else cfg
    out = _forward(model, cfg, feats, edge_src, edge_dst, edge_feats)
    return output_loss(out, cfg, labels, label_mask, graph_ids, n_graphs)


def output_loss(out: torch.Tensor, cfg: GNNConfig, labels: torch.Tensor,
                label_mask: torch.Tensor | None = None, graph_ids: torch.Tensor | None = None,
                n_graphs: int = 0) -> torch.Tensor:
    """The task's loss of the outputs ``out`` (n, d_out), a 0-d tensor:
    ``node``, the mean negative log-likelihood of ``labels`` (n,);
    ``graph``, that of the per-graph mean-pooled outputs (``graph_ids``
    (n,), ``labels`` (n_graphs,)); ``regression``, the mean squared error
    against ``labels`` (n, d_out).  ``label_mask`` (n,) weights the nodes
    of the node and regression tasks, divided by ``max(sum(mask), 1)``."""
    if cfg.task == "graph":
        # batched-small-graph cell: mean-pool per graph then classify
        pooled = aggregate(out, graph_ids, n_graphs, "sum")
        counts = aggregate(torch.ones_like(out[:, :1]), graph_ids, n_graphs, "sum")
        logp = _log_softmax(pooled / counts.clamp_min(1.0))
        return -logp.gather(-1, labels.to(torch.int64)[:, None]).mean()
    if cfg.task == "regression":
        err = (out - labels).square()
        if label_mask is not None:
            mask = label_mask.to(err.dtype)
            return (err * mask[:, None]).sum() / mask.sum().clamp_min(1.0)
        return err.mean()
    ll = _log_softmax(out).gather(-1, labels.to(torch.int64)[:, None])[:, 0]
    if label_mask is not None:
        mask = label_mask.to(ll.dtype)
        return -(ll * mask).sum() / mask.sum().clamp_min(1.0)
    return -ll.mean()
