"""internlm2-1.8b [arXiv:2403.17297; hf] — dense, GQA kv=8, SwiGLU.

24L d_model=2048 16H (kv=8) d_ff=8192 vocab=92544.
"""

from repro_torch.models.transformer import TransformerConfig
from repro_torch.train.optimizer import OptimizerConfig

CONFIG = TransformerConfig(
    name="internlm2-1.8b",
    n_layers=24,
    d_model=2048,
    n_heads=16,
    n_kv_heads=8,
    d_head=128,
    d_ff=8192,
    vocab=92544,
    rope_theta=1_000_000.0,
    tie_embeddings=True,
)

OPT = OptimizerConfig(name="adamw", learning_rate=3e-4, warmup_steps=2000)
