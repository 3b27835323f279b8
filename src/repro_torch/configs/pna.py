"""pna [arXiv:2004.05718; paper] — 4L d_hidden=75,
aggregators mean-max-min-std x scalers id-amp-atten (12 combinations).
Its cells: ``ARCH``."""

from repro_torch.configs.common import standard_gnn_arch
from repro_torch.models.gnn import GNNConfig
from repro_torch.train.optimizer import OptimizerConfig

CONFIG = GNNConfig(
    name="pna",
    arch="pna",
    n_layers=4,
    d_hidden=75,
    d_in=75,
    d_out=10,
)

OPT = OptimizerConfig(name="adamw", learning_rate=1e-3, warmup_steps=100)

ARCH = standard_gnn_arch("pna", CONFIG, OPT)
