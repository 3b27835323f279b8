"""granite-20b [arXiv:2405.04324; hf] — dense code model, MQA (kv=1).

52L d_model=6144 48H (kv=1) d_ff=24576 vocab=49152.  GPT-BigCode family:
non-gated GELU MLP (a gated SwiGLU at these dims would be ~27B params,
not 20B).
"""

from repro_torch.models.transformer import TransformerConfig
from repro_torch.train.optimizer import OptimizerConfig

CONFIG = TransformerConfig(
    name="granite-20b",
    n_layers=52,
    d_model=6144,
    n_heads=48,
    n_kv_heads=1,
    d_head=128,
    d_ff=24576,
    vocab=49152,
    ffn_act="gelu",
    tie_embeddings=True,
)

OPT = OptimizerConfig(name="adamw", learning_rate=2e-4, warmup_steps=2000)
