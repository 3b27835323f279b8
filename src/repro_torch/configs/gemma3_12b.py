"""gemma3-12b [hf:google/gemma-3-12b-pt; unverified] — 5:1 local:global.

48L d_model=3840 16H (kv=8) d_ff=15360 vocab=262144, head_dim=256.
Sliding window 1024 on local layers; every 6th layer global.
"""

from repro_torch.configs.common import standard_lm_arch
from repro_torch.models.transformer import TransformerConfig
from repro_torch.train.optimizer import OptimizerConfig

CONFIG = TransformerConfig(
    name="gemma3-12b",
    n_layers=48,
    d_model=3840,
    n_heads=16,
    n_kv_heads=8,
    d_head=256,
    d_ff=15360,
    vocab=262144,
    window_pattern=(1024, 1024, 1024, 1024, 1024, 0),  # 5 local : 1 global
    tie_embeddings=True,
    sub_quadratic=True,
)

OPT = OptimizerConfig(name="adamw", learning_rate=2e-4, warmup_steps=2000)

ARCH = standard_lm_arch("gemma3-12b", CONFIG, OPT, microbatches=8)
