"""meshgraphnet [arXiv:2010.03409; unverified] — 15 message-passing steps,
d_hidden=128, sum aggregator, 2-layer MLPs, encode-process-decode.
Regression head (per-node dynamics), mesh-edge features.
Its cells: ``ARCH``."""

from repro_torch.configs.common import standard_gnn_arch
from repro_torch.models.gnn import GNNConfig
from repro_torch.train.optimizer import OptimizerConfig

CONFIG = GNNConfig(
    name="meshgraphnet",
    arch="meshgraphnet",
    n_layers=15,
    d_hidden=128,
    d_in=12,
    d_out=3,
    aggregator="sum",
    mlp_layers=2,
    d_edge_in=8,
    task="regression",
)

OPT = OptimizerConfig(name="adamw", learning_rate=1e-3, warmup_steps=100)

ARCH = standard_gnn_arch("meshgraphnet", CONFIG, OPT)
