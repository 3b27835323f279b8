"""Deterministic, shardable synthetic data pipelines (port of
``repro.data.pipeline``: the same NumPy draws in the same order, so every
batch equals the reference's bit for bit; the batches are NumPy arrays,
which the caller moves to its device).

Every pipeline is a pure function of (seed, step, shard) so that:
* fault-tolerant replay after restore reproduces the exact batch stream
  (train/fault_tolerance.py relies on this),
* each host in a multi-host deployment generates only its shard
  (``shard``/``n_shards``), which is how the real data-loading layer
  would be fed from a sharded file set.

RecSys ids are Zipf-distributed — real CTR traffic is heavy-tailed, which
is exactly what makes the HyTM dedup (compaction) engine win on hot rows.
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np


def _rng(seed: int, step: int, shard: int) -> np.random.Generator:
    return np.random.default_rng(np.random.SeedSequence([seed, step, shard]))


@dataclass(frozen=True)
class LMBatches:
    vocab: int
    batch: int           # global batch (sequences)
    seq_len: int
    seed: int = 0
    n_shards: int = 1

    def make(self, step: int, shard: int = 0) -> dict:
        b = self.batch // self.n_shards
        rng = _rng(self.seed, step, shard)
        # Markov-ish stream: mixture of uniform + repeated spans so the
        # loss actually decreases during the example runs.
        base = rng.integers(0, self.vocab, size=(b, self.seq_len), dtype=np.int32)
        span = rng.integers(0, self.vocab, size=(b, 1), dtype=np.int32)
        mask = rng.random((b, self.seq_len)) < 0.5
        tokens = np.where(mask, span, base)
        return {"tokens": tokens}


@dataclass(frozen=True)
class GraphBatches:
    """Seed-node stream for sampled GNN training."""

    n_nodes: int
    batch_nodes: int
    n_classes: int
    seed: int = 0
    n_shards: int = 1

    def make(self, step: int, shard: int = 0) -> dict:
        b = self.batch_nodes // self.n_shards
        rng = _rng(self.seed, step, shard)
        seeds = rng.integers(0, self.n_nodes, size=(b,), dtype=np.int64)
        return {"seeds": seeds}


@dataclass(frozen=True)
class RecSysBatches:
    vocab_sizes: tuple
    batch: int
    n_dense: int = 13
    multi_hot: int = 1
    zipf_a: float = 1.2
    seed: int = 0
    n_shards: int = 1

    def make(self, step: int, shard: int = 0) -> dict:
        b = self.batch // self.n_shards
        rng = _rng(self.seed, step, shard)
        dense = rng.standard_normal((b, self.n_dense)).astype(np.float32)
        cols = []
        for v in self.vocab_sizes:
            # Zipf over [1, inf) folded into [0, v): heavy head == hot rows
            z = rng.zipf(self.zipf_a, size=(b, self.multi_hot)) - 1
            cols.append(np.minimum(z, v - 1).astype(np.int32))
        sparse = np.stack(cols, axis=1)  # (b, n_fields, multi_hot)
        if self.multi_hot == 1:
            sparse = sparse[..., 0]
        labels = (rng.random(b) < 0.25).astype(np.float32)
        return {"dense": dense, "sparse": sparse, "labels": labels}
