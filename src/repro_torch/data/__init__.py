"""Deterministic synthetic data pipelines (LM / GNN / RecSys)."""

from repro_torch.data.pipeline import GraphBatches, LMBatches, RecSysBatches

__all__ = ["LMBatches", "GraphBatches", "RecSysBatches"]
