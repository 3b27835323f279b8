"""deepseek-v2-lite-16b [arXiv:2405.04434; hf] — MLA + fine-grained MoE.

27L d_model=2048 16H, MLA kv_lora=512 (d_nope=128, d_rope=64, d_v=128),
MoE: 64 routed experts d_ff=1408 top-6 + 2 shared, first layer dense
(d_ff=10944), vocab=102400.  15,706,484,224 parameters: 31.4 GB in bf16,
so one 80 GB card serves it whole.
"""

from repro_torch.configs.common import standard_lm_arch
from repro_torch.models.attention import MLAConfig
from repro_torch.models.moe import MoEConfig
from repro_torch.models.transformer import TransformerConfig
from repro_torch.train.optimizer import OptimizerConfig

CONFIG = TransformerConfig(
    name="deepseek-v2-lite-16b",
    n_layers=27,
    d_model=2048,
    n_heads=16,
    n_kv_heads=16,
    d_head=128,
    d_ff=1408,
    vocab=102400,
    attention="mla",
    mla=MLAConfig(kv_lora=512, q_lora=0, d_nope=128, d_rope=64, d_v=128),
    moe=MoEConfig(
        n_experts=64, top_k=6, d_ff=1408, n_shared=2,
        capacity_factor=1.25, dispatch="sorted", chunk_tokens=8192,
    ),
    first_dense_layers=1,
    d_ff_dense=10944,
    tie_embeddings=False,
)

OPT = OptimizerConfig(name="adamw", learning_rate=3e-4, warmup_steps=2000)

ARCH = standard_lm_arch("deepseek-v2-lite-16b", CONFIG, OPT, microbatches=4)
