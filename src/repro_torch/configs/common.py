"""Config helpers shared by the architectures (port of the smoke reductions
of ``repro.configs.common``, and of its GNN shape cells without their
train steps: ``GNN_SHAPES``, the flop counts and ``gnn_cells``)."""

from __future__ import annotations

import math

from repro_torch.models.dlrm import DLRMConfig
from repro_torch.models.gnn import GNNConfig
from repro_torch.models.transformer import TransformerConfig


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
