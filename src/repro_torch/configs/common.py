"""Config helpers shared by the architectures (port of the smoke reductions
of ``repro.configs.common``)."""

from __future__ import annotations

from repro_torch.models.dlrm import DLRMConfig
from repro_torch.models.transformer import TransformerConfig


def reduce_lm_config(cfg: TransformerConfig) -> TransformerConfig:
    """Reduced smoke config: shrink dims, keep the family's structure
    (MQA/MLA/MoE, windows) — used by the CPU tests and ``launch/serve.py
    --reduced``."""
    kw = dict(
        n_layers=min(cfg.n_layers, 3 if cfg.moe else 4),
        d_model=64,
        n_heads=4,
        n_kv_heads=min(cfg.n_kv_heads, 4) if cfg.n_kv_heads > 1 else 1,
        d_head=16,
        d_ff=128,
        vocab=211,
        dtype="float32",
        param_dtype="float32",
        d_ff_dense=128 if cfg.d_ff_dense else 0,
    )
    if cfg.window_pattern != (0,):
        kw["window_pattern"] = (4, 4, 0)
    if cfg.mla is not None:
        kw["mla"] = cfg.mla.replace(kv_lora=32, d_nope=16, d_rope=8, d_v=16)
    if cfg.moe is not None:
        kw["moe"] = cfg.moe.replace(
            n_experts=8, top_k=min(cfg.moe.top_k, 2), d_ff=32,
            d_ff_shared=0, capacity_factor=4.0, chunk_tokens=0,
        )
        kw["first_dense_layers"] = min(cfg.first_dense_layers, 1)
    return cfg.replace(**kw)


def reduce_dlrm_config(cfg: DLRMConfig) -> DLRMConfig:
    """Reduced smoke config of a DLRM: five small tables, narrow towers, the
    family's 13 dense features and dot interaction kept (the reduction of
    ``tests/test_smoke_archs.py``)."""
    return cfg.replace(vocab_sizes=(64, 3, 50, 7, 100), embed_dim=16, bot_mlp=(32, 16),
                       top_mlp=(32, 1))
