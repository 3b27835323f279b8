"""kimi-k2-1t-a32b [arXiv:2501.kimi2; unverified] — trillion-param MoE.

61L d_model=7168 64H (GQA kv=8) expert d_ff=2048 vocab=163840,
MoE 384 routed experts top-8; first layer dense (d_ff=18432, as in the
DeepSeek-V3/K2 family).  ~1.04T total params, ~32B active: about 2 TB of
bf16 weights, which no single card holds (``launch/serve.py`` raises
without ``--reduced``; queue 1 item 11 brings the multi-GPU layout).
"""

from repro_torch.configs.common import standard_lm_arch
from repro_torch.models.moe import MoEConfig
from repro_torch.models.transformer import TransformerConfig
from repro_torch.train.optimizer import OptimizerConfig

CONFIG = TransformerConfig(
    name="kimi-k2-1t-a32b",
    n_layers=61,
    d_model=7168,
    n_heads=64,
    n_kv_heads=8,
    d_head=128,
    d_ff=2048,
    vocab=163840,
    moe=MoEConfig(
        n_experts=384, top_k=8, d_ff=2048, n_shared=0,
        capacity_factor=1.25, dispatch="sorted", chunk_tokens=4096,
    ),
    first_dense_layers=1,
    d_ff_dense=18432,
    tie_embeddings=False,
    param_dtype="bfloat16",
)

OPT = OptimizerConfig(name="adafactor", learning_rate=2e-4, warmup_steps=2000)

ARCH = standard_lm_arch("kimi-k2-1t-a32b", CONFIG, OPT, microbatches=8,
                        grad_accum_dtype="bfloat16")
