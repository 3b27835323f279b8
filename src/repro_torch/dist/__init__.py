"""Multi-GPU HyTM on ``torch.distributed`` (``graph_shard``)."""
