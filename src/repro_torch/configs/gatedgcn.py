"""gatedgcn [arXiv:2003.00982; paper] — 16L d_hidden=70, gated edge
aggregation (Bresson & Laurent residual gated graph convnets).
Its cells: ``ARCH``."""

from repro_torch.configs.common import standard_gnn_arch
from repro_torch.models.gnn import GNNConfig
from repro_torch.train.optimizer import OptimizerConfig

CONFIG = GNNConfig(
    name="gatedgcn",
    arch="gatedgcn",
    n_layers=16,
    d_hidden=70,
    d_in=70,
    d_out=10,
    d_edge_in=8,
)

OPT = OptimizerConfig(name="adamw", learning_rate=1e-3, warmup_steps=100)

ARCH = standard_gnn_arch("gatedgcn", CONFIG, OPT)
