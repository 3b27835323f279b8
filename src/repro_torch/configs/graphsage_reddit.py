"""graphsage-reddit [arXiv:1706.02216; paper] — 2L d_hidden=128 mean
aggregator, sample_sizes 25-10 (training estimator; the `minibatch_lg`
cell uses the assigned 15-10 fanout).  Its cells: ``configs.common.gnn_cells``."""

from repro_torch.models.gnn import GNNConfig
from repro_torch.train.optimizer import OptimizerConfig

CONFIG = GNNConfig(
    name="graphsage-reddit",
    arch="graphsage",
    n_layers=2,
    d_hidden=128,
    d_in=602,
    d_out=41,
    aggregator="mean",
    sample_sizes=(25, 10),
)

OPT = OptimizerConfig(name="adamw", learning_rate=1e-3, warmup_steps=100)
