"""Architecture registry of the port: ``--arch <id>`` -> its ``ArchSpec``
(``configs.common``) with per-shape cells; ``.model_config`` is the
model's config (``TransformerConfig``, ``GNNConfig``, ``DLRMConfig``, or
``hytgraph``'s ``HyTGraphWorkload``).

Every arch of the reference is ported: 10 assigned architectures, each
module with the reference's ``CONFIG``, ``OPT`` (its
``train.optimizer.OptimizerConfig``) and ``ARCH``, and the paper's own
graph-analytics engine.
"""

from __future__ import annotations

import importlib

ARCHS = {
    # LM family (5)
    "kimi-k2-1t-a32b": "repro_torch.configs.kimi_k2_1t_a32b",
    "deepseek-v2-lite-16b": "repro_torch.configs.deepseek_v2_lite_16b",
    "internlm2-1.8b": "repro_torch.configs.internlm2_1p8b",
    "granite-20b": "repro_torch.configs.granite_20b",
    "gemma3-12b": "repro_torch.configs.gemma3_12b",
    # GNN family (4)
    "graphsage-reddit": "repro_torch.configs.graphsage_reddit",
    "pna": "repro_torch.configs.pna",
    "gatedgcn": "repro_torch.configs.gatedgcn",
    "meshgraphnet": "repro_torch.configs.meshgraphnet",
    # RecSys (1)
    "dlrm-mlperf": "repro_torch.configs.dlrm_mlperf",
    # The paper's own system (bonus arch: graph analytics engine)
    "hytgraph": "repro_torch.configs.hytgraph_paper",
}


def get_arch(name: str):
    """The ``ArchSpec`` of the architecture ``name``."""
    if name not in ARCHS:
        raise KeyError(f"unknown arch {name!r}; known: {sorted(ARCHS)}")
    return importlib.import_module(ARCHS[name]).ARCH


def list_archs() -> list[str]:
    return list(ARCHS)
