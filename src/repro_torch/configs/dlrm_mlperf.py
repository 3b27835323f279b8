"""dlrm-mlperf [arXiv:1906.00091; paper] — MLPerf DLRM (Criteo 1TB).

13 dense + 26 sparse features, embed_dim=128, bottom 13-512-256-128, top
1024-1024-512-256-1, dot interaction.  187,770,880 embedding rows once
padded (96.14 GB in float32): more than one card holds, so the card runs
``one_card_config()``, capped at 25M rows a table (66.08 GB).
"""

from repro_torch.models.dlrm import MLPERF_VOCAB_SIZES, DLRMConfig
from repro_torch.train.optimizer import OptimizerConfig

# Row-sharded tables are padded to a shardable multiple (512 covers every
# mesh: 16x16 and 2x16x16); small tables stay replicated and unpadded.
_PADDED_VOCABS = tuple(
    (-(-v // 512) * 512) if v >= 4096 else v for v in MLPERF_VOCAB_SIZES
)

CONFIG = DLRMConfig(vocab_sizes=_PADDED_VOCABS)

OPT = OptimizerConfig(name="adamw", learning_rate=1e-3, warmup_steps=100)

# The serving cells of the reference's ArchSpec (its train_batch cell comes
# with training): the batch of a forward, or one query against N candidates.
CELLS = {
    "serve_p99": {"batch": 512},
    "serve_bulk": {"batch": 262_144},
    "retrieval_cand": {"batch": 1, "n_candidates": 1_000_000, "top_k": 100},
}

ONE_CARD_MAX_ROWS = 25_000_000


def one_card_config(cfg: DLRMConfig = CONFIG) -> DLRMConfig:
    """``cfg`` with every table capped at ``ONE_CARD_MAX_ROWS`` rows, the cut
    that one 80 GB card forces.  It follows the public DLRM reference
    implementation (facebookresearch/dlrm, ``--max-ind-range``), which
    hashes each categorical id modulo the range.  Five tables are capped
    (the four of 38.5-40.0M rows and the one of 25.6M): 187,770,880 rows
    (96.14 GB in float32) become 129,066,304 (66.08 GB).  The widths are
    the published ones."""
    return cfg.replace(vocab_sizes=tuple(min(v, ONE_CARD_MAX_ROWS) for v in cfg.vocab_sizes))
