"""Cell builders: everything the dry run and the arch tests need per
(architecture x input-shape) pair (port of ``repro.configs.common``).

A *cell* resolves to a ``CellBuild``: the step function, its arguments
on the meta device (the counterpart of the reference's
``ShapeDtypeStruct``s: shapes and dtypes, no storage), their specs on the
given mesh (``dist.sharding``'s ``PartitionSpec`` trees, as
``tree_shardings`` gives them), and the analytic ``model_flops`` of the
roofline's useful-compute ratio.  ``skip`` cells (long_500k on pure
full-attention archs) carry the reason instead.  A builder's ``mesh`` is
a ``launch.mesh.ModelMesh``, or anything with axis names and sizes when
the cell is only inspected; building one runs no collective.

The steps run on DTensor placements (``dist.sharding.distribute`` of the
arguments by their specs on ``launch.mesh.device_mesh(mesh)``): the LM
train step is 17c's, through ``lm_loss(mesh=)``; the GNN and DLRM train
steps and serving run the models' DTensor routes (``models.gnn``'s
gathers and aggregations, ``models.embedding``'s row-split bags); LM
serving gathers the dense weights and the caches' ``model`` split and runs
``prefill``/``decode_step(mesh=)`` on each rank's requests and expert
shards (``serve_on_placements``).

Also the smoke reductions (``reduce_lm_config``, ``reduce_dlrm_config``),
and ``gnn_cells``: the GNN shape cells' configs and sizes without their
steps, as the card's runs read them.
"""

from __future__ import annotations

import math
from dataclasses import dataclass, field
from typing import Any, Callable

import torch

from repro_torch.dist.sharding import (P, _axis_sizes, batch_axes, dlrm_rule, gnn_data_spec,
                                       gnn_rule, lm_batch_spec, lm_cache_rule, lm_rule,
                                       tree_shardings)
from repro_torch.models import dlrm as dlrm_mod
from repro_torch.models import gnn as gnn_mod
from repro_torch.models import transformer as tf_mod
from repro_torch.models.dlrm import DLRMConfig
from repro_torch.models.gnn import GNNConfig
from repro_torch.models.transformer import TransformerConfig
from repro_torch.train.optimizer import OptimizerConfig
from repro_torch.train.train_step import init_train_state, make_train_step

META = torch.device("meta")


@dataclass
class CellBuild:
    fn: Callable
    args: tuple                 # on the meta device
    in_shardings: Any           # PartitionSpec trees of the args
    out_shardings: Any
    donate_argnums: tuple = ()
    model_flops: float = 0.0    # 6*N*D (train) / 2*N*D (serve) useful FLOPs
    note: str = ""


@dataclass
class ArchSpec:
    name: str
    family: str                                 # 'lm' | 'gnn' | 'recsys' | 'graph'
    cells: dict = field(default_factory=dict)   # shape -> builder(mesh) -> CellBuild
    skips: dict = field(default_factory=dict)   # shape -> reason
    smoke: Callable | None = None               # () -> reduced-config smoke callable
    model_config: Any = None

    def shapes(self) -> list[str]:
        return list(self.cells) + list(self.skips)


def _meta(shape, dtype=torch.float32) -> torch.Tensor:
    return torch.empty(shape, dtype=dtype, device=META)


# ---------------------------------------------------------------- LM cells

def lm_param_count(cfg: TransformerConfig) -> tuple[float, float]:
    """(total, active) parameter counts, analytic."""
    total = sum(p.numel() for p in tf_mod.Transformer(cfg, META).parameters())
    active = total
    if cfg.moe is not None:
        m = cfg.moe
        per_expert = 3 * cfg.d_model * m.d_ff
        inactive = (m.n_experts - m.top_k) * per_expert
        active = total - cfg.n_scan_layers * inactive
    return float(total), float(active)


def _train_outs(state_sh) -> tuple:
    return state_sh, {"loss": P(), "grad_norm": P()}


def lm_train_cell(cfg: TransformerConfig, opt_cfg: OptimizerConfig, global_batch: int,
                  seq_len: int, microbatches: int = 1, grad_accum_dtype: str = "float32"):
    def build(mesh) -> CellBuild:
        step = make_train_step(lambda m, b: tf_mod.lm_loss(m, b["tokens"], mesh=mesh), opt_cfg,
                               microbatches=microbatches,
                               accum_dtype=getattr(torch, grad_accum_dtype))
        state = init_train_state(tf_mod.Transformer(cfg, META), opt_cfg, device=META)
        batch = {"tokens": _meta((global_batch, seq_len), torch.int32)}
        state_sh = tree_shardings(state, mesh, lm_rule(mesh))
        _, active = lm_param_count(cfg)
        return CellBuild(fn=step, args=(state, batch),
                         in_shardings=(state_sh, {"tokens": lm_batch_spec(mesh)}),
                         out_shardings=_train_outs(state_sh), donate_argnums=(0,),
                         model_flops=6.0 * active * global_batch * (seq_len - 1))

    return build


def _serve_cfg(cfg: TransformerConfig) -> TransformerConfig:
    return cfg.replace(remat=False, param_dtype="bfloat16")


def serve_on_placements(fn, model, tokens, caches, mesh, *extra):
    """Run ``fn`` (``transformer.prefill`` or ``decode_step``) on DTensor
    arguments placed by ``lm_rule``, ``lm_batch_spec`` (or a replicated
    batch that does not split) and ``lm_cache_rule``: each rank's model
    holds its expert shards (the lm_rule split, ``moe.shard_shapes``) and
    the dense weights whole (gathered over ``model``), its requests' rows
    and their caches whole over ``model`` (gathered), and runs ``fn(...,
    mesh=mesh, batch_axes=...)``, the SPMD serving path.  DTensor has no
    sharding of a cache write at a position, hence the gathers, which the
    dry run's census shows.  Returns (logits split as the requests and
    over ``model``, caches placed as they came)."""
    from torch.distributed.tensor import DTensor, Replicate, Shard

    dm = tokens.device_mesh
    ba = batch_axes(mesh)
    split = [i for i, p in enumerate(tokens.placements) if isinstance(p, Shard)]
    rows_pl = [p if i in split else Replicate() for i, p in enumerate(tokens.placements)]

    def local_rows(t):
        pl = [Shard(0) if i in split else Replicate() for i in range(dm.ndim)]
        return t.redistribute(dm, pl).to_local()

    local = tf_mod.Transformer(model.cfg, META, mesh, ba)
    state = {}
    for name, p in model.named_parameters():
        state[name] = (p.to_local() if ".moe." in name and not name.endswith("router")
                       else p.full_tensor())
    local.load_state_dict(state, assign=True)
    placed = [{k: v.placements for k, v in c.items()} for c in caches["layers"]]
    plain = {"layers": [{k: local_rows(v) for k, v in c.items()} for c in caches["layers"]]}
    logits, plain = fn(local, tokens.to_local(), plain, *extra, mesh=mesh, batch_axes=ba)
    out = DTensor.from_local(logits, dm, rows_pl, run_check=False)
    logits_pl = [Shard(0) if i in split else Shard(1) if n == "model" else Replicate()
                 for i, n in enumerate(dm.mesh_dim_names)]
    back = {"layers": [
        {k: DTensor.from_local(v, dm, [Shard(0) if i in split else Replicate()
                                       for i in range(dm.ndim)],
                               run_check=False).redistribute(dm, placed[j][k])
         for k, v in c.items()} for j, c in enumerate(plain["layers"])]}
    return out.redistribute(dm, logits_pl), back


def lm_prefill_cell(cfg: TransformerConfig, batch: int, seq_len: int):
    serve_cfg = _serve_cfg(cfg)

    def build(mesh) -> CellBuild:
        def fn(params, tokens, caches):
            return serve_on_placements(tf_mod.prefill, params, tokens, caches, mesh)

        params = tf_mod.Transformer(serve_cfg, META)
        caches = tf_mod.init_cache(serve_cfg, batch, seq_len, device=META)
        tokens = _meta((batch, seq_len), torch.int32)
        p_sh = tree_shardings(params, mesh, lm_rule(mesh))
        c_sh = tree_shardings(caches, mesh, lm_cache_rule(mesh, serve_cfg.n_kv_heads))
        _, active = lm_param_count(serve_cfg)
        return CellBuild(fn=fn, args=(params, tokens, caches),
                         in_shardings=(p_sh, lm_batch_spec(mesh), c_sh),
                         out_shardings=(P(batch_axes(mesh), "model"), c_sh),
                         donate_argnums=(2,), model_flops=2.0 * active * batch * seq_len)

    return build


def _position(index, cache_len: int) -> int:
    """A real index's value; a fake or meta one (the dry run's) stands for
    the last position, the step that reads the whole cache."""
    from torch._subclasses.fake_tensor import FakeTensor

    if isinstance(index, torch.Tensor):
        local = index.to_local() if hasattr(index, "to_local") else index
        if isinstance(local, FakeTensor) or local.is_meta:
            return cache_len - 1
        return int(local)
    return int(index)


def lm_decode_cell(cfg: TransformerConfig, batch: int, cache_len: int):
    serve_cfg = _serve_cfg(cfg)

    def build(mesh) -> CellBuild:
        ba = batch_axes(mesh)
        ba_size = math.prod(_axis_sizes(mesh)[a] for a in ba)
        # tiny-batch long-context decode: batch dim replicated (the cache
        # rule shards the sequence dim instead)
        ba_eff = ba if batch % ba_size == 0 else None

        def fn(params, token, caches, index):
            return serve_on_placements(tf_mod.decode_step, params, token, caches, mesh,
                                       _position(index, cache_len))

        params = tf_mod.Transformer(serve_cfg, META)
        caches = tf_mod.init_cache(serve_cfg, batch, cache_len, device=META)
        p_sh = tree_shardings(params, mesh, lm_rule(mesh))
        c_sh = tree_shardings(caches, mesh, lm_cache_rule(mesh, serve_cfg.n_kv_heads))
        _, active = lm_param_count(serve_cfg)
        return CellBuild(fn=fn, args=(params, _meta((batch, 1), torch.int32), caches,
                                      _meta((), torch.int32)),
                         in_shardings=(p_sh, P(ba_eff, None), c_sh, P()),
                         out_shardings=(P(ba_eff, "model"), c_sh), donate_argnums=(2,),
                         model_flops=2.0 * active * batch)

    return build


LM_SHAPES = {
    "train_4k": dict(kind="train", seq_len=4096, global_batch=256),
    "prefill_32k": dict(kind="prefill", seq_len=32768, global_batch=32),
    "decode_32k": dict(kind="decode", seq_len=32768, global_batch=128),
    "long_500k": dict(kind="decode", seq_len=524288, global_batch=1),
}


def standard_lm_arch(name: str, cfg: TransformerConfig, opt_cfg: OptimizerConfig,
                     microbatches: int = 1, grad_accum_dtype: str = "float32") -> ArchSpec:
    cells = {
        "train_4k": lm_train_cell(cfg, opt_cfg, 256, 4096, microbatches, grad_accum_dtype),
        "prefill_32k": lm_prefill_cell(cfg, 32, 32768),
        "decode_32k": lm_decode_cell(cfg, 128, 32768),
    }
    skips = {}
    if cfg.sub_quadratic:
        cells["long_500k"] = lm_decode_cell(cfg, 1, 524288)
    else:
        skips["long_500k"] = (
            "pure full-attention arch: 500k-token context requires "
            "sub-quadratic attention (DESIGN.md §4)"
        )
    return ArchSpec(name=name, family="lm", cells=cells, skips=skips, model_config=cfg)


def reduce_lm_config(cfg: TransformerConfig) -> TransformerConfig:
    """Reduced smoke config: shrink dims, keep the family's structure
    (MQA/MLA/MoE, windows) — used by the CPU tests and ``launch/serve.py
    --reduced``."""
    kw = dict(
        n_layers=min(cfg.n_layers, 3 if cfg.moe else 4),
        d_model=64,
        n_heads=4,
        n_kv_heads=min(cfg.n_kv_heads, 4) if cfg.n_kv_heads > 1 else 1,
        d_head=16,
        d_ff=128,
        vocab=211,
        dtype="float32",
        param_dtype="float32",
        d_ff_dense=128 if cfg.d_ff_dense else 0,
    )
    if cfg.window_pattern != (0,):
        kw["window_pattern"] = (4, 4, 0)
    if cfg.mla is not None:
        kw["mla"] = cfg.mla.replace(kv_lora=32, d_nope=16, d_rope=8, d_v=16)
    if cfg.moe is not None:
        kw["moe"] = cfg.moe.replace(
            n_experts=8, top_k=min(cfg.moe.top_k, 2), d_ff=32,
            d_ff_shared=0, capacity_factor=4.0, chunk_tokens=0,
        )
        kw["first_dense_layers"] = min(cfg.first_dense_layers, 1)
    return cfg.replace(**kw)


def reduce_dlrm_config(cfg: DLRMConfig) -> DLRMConfig:
    """Reduced smoke config of a DLRM: five small tables, narrow towers, the
    family's 13 dense features and dot interaction kept (the reduction of
    ``tests/test_smoke_archs.py``)."""
    return cfg.replace(vocab_sizes=(64, 3, 50, 7, 100), embed_dim=16, bot_mlp=(32, 16),
                       top_mlp=(32, 1))


# --------------------------------------------------------------- GNN cells

def gnn_flops_per_edge(cfg: GNNConfig) -> float:
    """Analytic useful FLOPs per edge per layer (message + aggregation)."""
    d = cfg.d_hidden
    per_edge = {
        "graphsage": 2 * d,               # gather+reduce; linears are per-node
        "pna": 2 * (2 * d) * d + 8 * d,   # message MLP + 4 aggregators
        "gatedgcn": 3 * 2 * d * d + 6 * d,
        "meshgraphnet": (3 * d) * d * 2 * cfg.mlp_layers,
    }[cfg.arch]
    return float(per_edge)


def gnn_node_flops(cfg: GNNConfig) -> float:
    d = cfg.d_hidden
    per_node = {
        "graphsage": 2 * 2 * cfg.d_in * d + (cfg.n_layers - 1) * 4 * d * d,
        "pna": 2 * (13 * d) * d * cfg.n_layers,
        "gatedgcn": 3 * 2 * d * d * cfg.n_layers,
        "meshgraphnet": (2 * d) * d * 2 * cfg.mlp_layers * cfg.n_layers,
    }[cfg.arch]
    return float(per_node)


def _pad_to(n: int, m: int = 512) -> int:
    """Round a node/edge count up to a shardable multiple (padding rows
    are masked in real runs: self-loop edges / zero-weight labels)."""
    return -(-n // m) * m


GNN_SHAPES = {
    "full_graph_sm": dict(n_nodes=2708, n_edges=10556, d_feat=1433),
    "minibatch_lg": dict(n_nodes=232965, n_edges=114615892, batch_nodes=1024, fanout=(15, 10)),
    "ogb_products": dict(n_nodes=2449029, n_edges=61859140, d_feat=100),
    "molecule": dict(n_nodes=30, n_edges=64, batch=128),
}


def _graph_cell(cfg: GNNConfig, n_nodes: int, n_edges: int, d_feat: int,
                n_graphs: int = 0) -> dict:
    cell_cfg = cfg.replace(d_in=d_feat)
    return {"cfg": cell_cfg, "kind": "graph", "n_nodes": n_nodes, "n_edges": n_edges,
            "d_feat": d_feat, "n_graphs": n_graphs,
            "n_nodes_padded": _pad_to(n_nodes), "n_edges_padded": _pad_to(n_edges),
            "model_flops": 3.0 * (gnn_flops_per_edge(cell_cfg) * n_edges * cell_cfg.n_layers
                                  + gnn_node_flops(cell_cfg) * n_nodes)}


def gnn_cells(cfg: GNNConfig) -> dict:
    """The four shape cells of an architecture as the reference's
    ``standard_gnn_arch`` derives them: cell -> its config (``d_in`` the
    cell's feature width, ``d_out`` 7, 47, 2 or 3, and 41; the molecule cell
    a ``graph`` task unless the config regresses) and sizes, with
    ``model_flops`` (3 x the forward's, as the reference counts a train
    step).  ``kind`` "graph" is an edge list of ``n_nodes`` and ``n_edges``
    (padded to 512 in the reference's batches); "minibatch" is GraphSAGE's
    sampled cell over a resident ``n_nodes`` table.  Non-GraphSAGE archs
    take ``minibatch_lg`` as the sampled block's edge list: 1024 seeds and
    their full fanout closure, 1024 * (1 + 15 + 150) nodes and
    1024 * (15 + 150) arcs."""
    s = GNN_SHAPES
    mol_nodes = s["molecule"]["batch"] * s["molecule"]["n_nodes"]
    mol_edges = s["molecule"]["batch"] * s["molecule"]["n_edges"] * 2  # undirected
    if cfg.task == "regression":
        mol_cfg = cfg.replace(d_out=3)
    else:
        mol_cfg = cfg.replace(task="graph", d_out=2)
    cells = {
        "full_graph_sm": _graph_cell(cfg.replace(d_out=7), s["full_graph_sm"]["n_nodes"],
                                     s["full_graph_sm"]["n_edges"],
                                     s["full_graph_sm"]["d_feat"]),
        "ogb_products": _graph_cell(cfg.replace(d_out=47), s["ogb_products"]["n_nodes"],
                                    s["ogb_products"]["n_edges"], s["ogb_products"]["d_feat"]),
        "molecule": _graph_cell(mol_cfg, mol_nodes, mol_edges, 16,
                                n_graphs=s["molecule"]["batch"]),
    }
    mb = s["minibatch_lg"]
    if cfg.arch == "graphsage":
        fanouts, batch = mb["fanout"], mb["batch_nodes"]
        d_feat = 602
        cell_cfg = cfg.replace(d_in=d_feat, sample_sizes=fanouts, d_out=41)
        total_gathered = sum(batch * math.prod(fanouts[:k]) for k in range(len(fanouts) + 1))
        cells["minibatch_lg"] = {
            "cfg": cell_cfg, "kind": "minibatch", "n_nodes": mb["n_nodes"],
            "n_edges": mb["n_edges"], "d_feat": d_feat, "batch_nodes": batch,
            "fanouts": fanouts, "n_classes": 41, "n_nodes_padded": _pad_to(mb["n_nodes"]),
            "model_flops": 3.0 * total_gathered * 4 * cell_cfg.d_hidden
            * max(d_feat, cell_cfg.d_hidden)}
    else:
        nodes = mb["batch_nodes"] * (1 + 15 + 15 * 10)
        edges = mb["batch_nodes"] * (15 + 15 * 10)
        mb_cfg = cfg.replace(d_out=41) if cfg.task != "regression" else cfg.replace(d_out=3)
        cells["minibatch_lg"] = _graph_cell(mb_cfg, nodes, edges, 602)
    return cells


def gnn_train_cell(cfg: GNNConfig, opt_cfg: OptimizerConfig, n_nodes: int, n_edges: int,
                   d_feat: int, n_graphs: int = 0):
    cell_cfg = cfg.replace(d_in=d_feat)
    n_nodes_orig, n_edges_orig = n_nodes, n_edges
    n_nodes, n_edges = _pad_to(n_nodes), _pad_to(n_edges)

    def build(mesh) -> CellBuild:
        needs_edge_feats = cell_cfg.arch in ("gatedgcn", "meshgraphnet")

        def loss_fn(model, b):
            ef = b.get("edge_feats")
            if cell_cfg.task == "graph":
                return gnn_mod.gnn_loss(model, cell_cfg, b["feats"], b["src"], b["dst"],
                                        b["labels"], edge_feats=ef, graph_ids=b["graph_ids"],
                                        n_graphs=n_graphs)
            return gnn_mod.gnn_loss(model, cell_cfg, b["feats"], b["src"], b["dst"], b["labels"],
                                    edge_feats=ef)

        step = make_train_step(loss_fn, opt_cfg)
        state = init_train_state(gnn_mod.ARCHITECTURES[cell_cfg.arch](cell_cfg, META), opt_cfg,
                                 device=META)
        batch = {"feats": _meta((n_nodes, d_feat)), "src": _meta((n_edges,), torch.int32),
                 "dst": _meta((n_edges,), torch.int32)}
        vec, mat = gnn_data_spec(mesh, "vector"), gnn_data_spec(mesh, "matrix")
        batch_sh = {"feats": mat, "src": vec, "dst": vec}
        if needs_edge_feats:
            batch["edge_feats"] = _meta((n_edges, cell_cfg.d_edge_in))
            batch_sh["edge_feats"] = mat
        if cell_cfg.task == "graph":
            batch["graph_ids"] = _meta((n_nodes,), torch.int32)
            batch["labels"] = _meta((n_graphs,), torch.int32)
            batch_sh["graph_ids"] = vec
            batch_sh["labels"] = vec
        elif cell_cfg.task == "regression":
            batch["labels"] = _meta((n_nodes, cell_cfg.d_out))
            batch_sh["labels"] = mat
        else:
            batch["labels"] = _meta((n_nodes,), torch.int32)
            batch_sh["labels"] = vec
        state_sh = tree_shardings(state, mesh, gnn_rule(mesh))
        flops = 3.0 * (gnn_flops_per_edge(cell_cfg) * n_edges_orig * cell_cfg.n_layers
                       + gnn_node_flops(cell_cfg) * n_nodes_orig)
        return CellBuild(fn=step, args=(state, batch), in_shardings=(state_sh, batch_sh),
                         out_shardings=_train_outs(state_sh), donate_argnums=(0,),
                         model_flops=flops)

    return build


def gnn_minibatch_cell(cfg: GNNConfig, opt_cfg: OptimizerConfig, n_nodes: int, d_feat: int,
                       batch_nodes: int, fanouts: tuple, n_classes: int):
    """Sampled-training cell: the sampler output (layered vertex ids) is
    the batch; the resident feature table is gathered on the device, the
    sparse-frontier regime of HyTM (gather engine)."""
    cell_cfg = cfg.replace(d_in=d_feat, sample_sizes=fanouts, d_out=n_classes)
    n_nodes = _pad_to(n_nodes)

    def build(mesh) -> CellBuild:
        sizes = [batch_nodes]
        for f in fanouts:
            sizes.append(sizes[-1] * f)

        def loss_fn(model, b):
            layer_feats = [gnn_mod.gather_rows(b["feats"], b[f"hop{k}"])
                           for k in range(len(sizes))]
            logits = gnn_mod.graphsage_minibatch_forward(model, layer_feats, cell_cfg)
            return gnn_mod.output_loss(logits, cell_cfg.replace(task="node"), b["labels"])

        step = make_train_step(loss_fn, opt_cfg)
        state = init_train_state(gnn_mod.ARCHITECTURES[cell_cfg.arch](cell_cfg, META), opt_cfg,
                                 device=META)
        vec = gnn_data_spec(mesh, "vector")
        batch = {"feats": _meta((n_nodes, d_feat))}
        batch_sh = {"feats": gnn_data_spec(mesh, "matrix")}
        for k, size in enumerate(sizes):
            batch[f"hop{k}"] = _meta((size,), torch.int32)
            batch_sh[f"hop{k}"] = vec
        batch["labels"] = _meta((batch_nodes,), torch.int32)
        batch_sh["labels"] = vec
        state_sh = tree_shardings(state, mesh, gnn_rule(mesh))
        total_gathered = sum(batch_nodes * math.prod(fanouts[:k])
                             for k in range(len(fanouts) + 1))
        flops = 3.0 * total_gathered * 4 * cell_cfg.d_hidden * max(d_feat, cell_cfg.d_hidden)
        return CellBuild(fn=step, args=(state, batch), in_shardings=(state_sh, batch_sh),
                         out_shardings=_train_outs(state_sh), donate_argnums=(0,),
                         model_flops=flops)

    return build


def standard_gnn_arch(name: str, cfg: GNNConfig, opt_cfg: OptimizerConfig) -> ArchSpec:
    """The four GNN shape cells (``gnn_cells``'s configs and sizes, with
    their train steps).  minibatch_lg uses the real neighbour sampler's
    layout for all archs: the GraphSAGE estimator path arch-natively, the
    other archs train on the sampled block as an edge-list subgraph."""
    cells = {}
    for shape, c in gnn_cells(cfg).items():
        if c["kind"] == "minibatch":
            cells[shape] = gnn_minibatch_cell(cfg, opt_cfg, c["n_nodes"], c["d_feat"],
                                              c["batch_nodes"], c["fanouts"], c["n_classes"])
        else:
            cells[shape] = gnn_train_cell(c["cfg"], opt_cfg, c["n_nodes"], c["n_edges"],
                                          c["d_feat"], n_graphs=c["n_graphs"])
    order = ("full_graph_sm", "ogb_products", "molecule", "minibatch_lg")
    return ArchSpec(name=name, family="gnn", cells={k: cells[k] for k in order},
                    model_config=cfg)


# -------------------------------------------------------------- DLRM cells

def _dlrm_fwd_flops(cfg: DLRMConfig) -> float:
    f = 0.0
    dims = [cfg.n_dense, *cfg.bot_mlp]
    f += sum(2 * dims[i] * dims[i + 1] for i in range(len(dims) - 1))
    f += cfg.n_sparse * cfg.multi_hot * cfg.embed_dim          # bag reduce
    nf = cfg.n_sparse + 1
    f += 2 * nf * nf * cfg.embed_dim                            # interaction
    dims = [cfg.embed_dim + cfg.n_interact_features, *cfg.top_mlp]
    f += sum(2 * dims[i] * dims[i + 1] for i in range(len(dims) - 1))
    return f


def dlrm_train_cell(cfg: DLRMConfig, opt_cfg: OptimizerConfig, batch: int):
    def build(mesh) -> CellBuild:
        step = make_train_step(
            lambda m, b: dlrm_mod.dlrm_loss(m, b["dense"], b["sparse"], b["labels"], cfg),
            opt_cfg)
        state = init_train_state(dlrm_mod.abstract_dlrm_params(cfg), opt_cfg, device=META)
        ba = batch_axes(mesh)
        batch_specs = {"dense": _meta((batch, cfg.n_dense)),
                       "sparse": _meta((batch, cfg.n_sparse), torch.int32),
                       "labels": _meta((batch,))}
        bsh = {"dense": P(ba, None), "sparse": P(ba, None), "labels": P(ba)}
        state_sh = tree_shardings(state, mesh, dlrm_rule(mesh))
        return CellBuild(fn=step, args=(state, batch_specs), in_shardings=(state_sh, bsh),
                         out_shardings=_train_outs(state_sh), donate_argnums=(0,),
                         model_flops=3.0 * batch * _dlrm_fwd_flops(cfg))

    return build


def dlrm_serve_cell(cfg: DLRMConfig, batch: int):
    def build(mesh) -> CellBuild:
        params = dlrm_mod.abstract_dlrm_params(cfg)
        ba = batch_axes(mesh)
        args = (params, _meta((batch, cfg.n_dense)), _meta((batch, cfg.n_sparse), torch.int32))
        in_sh = (tree_shardings(params, mesh, dlrm_rule(mesh)), P(ba, None), P(ba, None))
        return CellBuild(fn=lambda p, d, s: dlrm_mod.dlrm_forward(p, d, s, cfg), args=args,
                         in_shardings=in_sh, out_shardings=P(ba),
                         model_flops=batch * _dlrm_fwd_flops(cfg))

    return build


def dlrm_retrieval_cell(cfg: DLRMConfig, batch: int, n_candidates: int, top_k: int = 100):
    def build(mesh) -> CellBuild:
        params = dlrm_mod.abstract_dlrm_params(cfg)
        args = (params, _meta((batch, cfg.n_dense)), _meta((n_candidates, cfg.embed_dim)))
        ba = batch_axes(mesh)
        in_sh = (tree_shardings(params, mesh, dlrm_rule(mesh)), P(None, None),
                 P(ba, None))   # candidates sharded
        return CellBuild(
            fn=lambda p, d, c: dlrm_mod.retrieval_score(p, d, c, top_k=top_k), args=args,
            in_shardings=in_sh, out_shardings=P(),   # one spec for (scores, ids)
            model_flops=2.0 * batch * n_candidates * cfg.embed_dim)

    return build
