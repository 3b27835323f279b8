"""Architecture registry of the port: ``--arch <id>`` -> the model's
config (``TransformerConfig``, ``GNNConfig`` or ``DLRMConfig``).

Every arch of the reference is ported: the LM, GNN and DLRM
configurations, each with the reference's ``OPT`` (its
``train.optimizer.OptimizerConfig``) beside its ``CONFIG``, and the
``hytgraph`` workload (``HyTGraphWorkload``).  The reference's ``ArchSpec``
and its mesh cells come with the arch specs (ROADMAP item 17c);
dlrm-mlperf's serving cells are ``configs.dlrm_mlperf.CELLS``, the GNNs'
shape cells ``configs.common.gnn_cells``.
"""

from __future__ import annotations

import importlib

ARCHS = {
    "internlm2-1.8b": "repro_torch.configs.internlm2_1p8b",
    "granite-20b": "repro_torch.configs.granite_20b",
    "gemma3-12b": "repro_torch.configs.gemma3_12b",
    "deepseek-v2-lite-16b": "repro_torch.configs.deepseek_v2_lite_16b",
    "kimi-k2-1t-a32b": "repro_torch.configs.kimi_k2_1t_a32b",
    "graphsage-reddit": "repro_torch.configs.graphsage_reddit",
    "pna": "repro_torch.configs.pna",
    "gatedgcn": "repro_torch.configs.gatedgcn",
    "meshgraphnet": "repro_torch.configs.meshgraphnet",
    "dlrm-mlperf": "repro_torch.configs.dlrm_mlperf",
    "hytgraph": "repro_torch.configs.hytgraph_paper",
}


def get_arch(name: str):
    """The model config of the architecture ``name`` (``hytgraph``: its
    ``HyTGraphWorkload``)."""
    if name not in ARCHS:
        raise KeyError(f"unknown arch {name!r}; known: {sorted(ARCHS)}")
    return importlib.import_module(ARCHS[name]).CONFIG
