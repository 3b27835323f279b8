"""Decoder-only LM stack for inference (port of ``repro.models.transformer``).

The dense GQA/MQA family of the reference: gemma3-12b (5:1 local:global
sliding windows), internlm2-1.8b (SwiGLU) and granite-20b (MQA with a
non-gated GELU FFN).  MLA and MoE come with a later slice and raise.

The reference scans one stacked parameter tree over the layers; the port
holds one ``DecoderLayer`` module per layer, each with its own window
(``pat[i % len(pat)]``).  Every matmul casts its weight to the activation
dtype first, as the reference does; ``init_transformer`` builds the weights
in ``cfg.param_dtype``, so serving with ``param_dtype == dtype`` casts once
at build time (the same values, since the cast is deterministic).

The slice is inference only: ``forward``, ``prefill`` and ``decode_step``
run under ``torch.inference_mode()``.  ``forward`` and ``prefill`` take
``use_kernels`` ("auto", True or False), resolved by
``kernels.runtime.resolve_use_kernels``: on, attention over a prompt's own
keys goes through the ``flash_attention`` kernel.  Caches are updated in
place (the reference's are functional).  ``prefill`` computes the logits
of the last position only, where the reference computes all and keeps the
last.  The reference's ``lm_loss`` comes with the training slice.
"""

from __future__ import annotations

import dataclasses
from dataclasses import dataclass

import torch
import torch.nn.functional as F
from torch import nn

from repro_torch.kernels.runtime import resolve_device, resolve_use_kernels
from repro_torch.models.attention import NOT_PORTED_MLA, gqa_attention, init_gqa
from repro_torch.models.common import dense_init, embed_init, frozen, rms_norm, swiglu

NOT_PORTED_MOE = "MoE is not ported yet (ROADMAP queue 1, item 15: MoE serving)"


@dataclass(frozen=True)
class TransformerConfig:
    name: str
    n_layers: int
    d_model: int
    n_heads: int
    n_kv_heads: int
    d_head: int
    d_ff: int
    vocab: int
    rope_theta: float = 10_000.0
    norm_eps: float = 1e-6
    ffn_act: str = "swiglu"            # 'swiglu' | 'gelu' (non-gated)
    window_pattern: tuple = (0,)       # cycled over layers; 0 = global attn
    attention: str = "gqa"             # 'gqa' | 'mla'
    mla: object | None = None          # the reference's MLAConfig
    moe: object | None = None          # the reference's MoEConfig
    first_dense_layers: int = 0        # dense-FFN prefix when moe is set
    d_ff_dense: int = 0                # hidden dim of that prefix (0 -> d_ff)
    tie_embeddings: bool = True
    dtype: str = "bfloat16"
    param_dtype: str = "float32"
    remat: bool = True
    sub_quadratic: bool = False        # True iff long-context decode is runnable

    @property
    def act_dtype(self) -> torch.dtype:
        return getattr(torch, self.dtype)

    @property
    def n_scan_layers(self) -> int:
        return self.n_layers - (self.first_dense_layers if self.moe else 0)

    def windows(self) -> list[int]:
        pat = self.window_pattern or (0,)
        return [int(pat[i % len(pat)]) for i in range(self.n_layers)]

    def replace(self, **kw) -> "TransformerConfig":
        return dataclasses.replace(self, **kw)


def _check_ported(cfg: TransformerConfig) -> None:
    if cfg.attention == "mla" or cfg.mla is not None:
        raise NotImplementedError(NOT_PORTED_MLA)
    if cfg.moe is not None:
        raise NotImplementedError(NOT_PORTED_MOE)
    if cfg.attention != "gqa":
        raise ValueError(f"unknown attention {cfg.attention!r}")
    if cfg.ffn_act not in ("swiglu", "gelu"):
        raise ValueError(f"unknown ffn_act {cfg.ffn_act!r}")


class DecoderLayer(nn.Module):
    """Pre-norm block: RMS norm, GQA attention, residual; RMS norm, FFN,
    residual.  Weights are (d_in, d_out), applied as ``x @ w``."""

    def __init__(self, cfg: TransformerConfig, window: int, device: torch.device,
                 dtype: torch.dtype):
        super().__init__()
        d, dh = cfg.d_model, cfg.d_head

        def empty(*shape):
            return frozen(torch.empty(shape, device=device, dtype=dtype))

        self.cfg = cfg
        self.window = window
        self.ln1 = frozen(torch.zeros(d, device=device, dtype=dtype))
        self.ln2 = frozen(torch.zeros(d, device=device, dtype=dtype))
        self.attn = nn.ParameterDict({
            "wq": empty(d, cfg.n_heads * dh), "wk": empty(d, cfg.n_kv_heads * dh),
            "wv": empty(d, cfg.n_kv_heads * dh), "wo": empty(cfg.n_heads * dh, d)})
        if cfg.ffn_act == "swiglu":
            self.ffn = nn.ParameterDict({"w_gate": empty(d, cfg.d_ff),
                                         "w_up": empty(d, cfg.d_ff),
                                         "w_down": empty(cfg.d_ff, d)})
        else:
            self.ffn = nn.ParameterDict({"w_in": empty(d, cfg.d_ff),
                                         "w_down": empty(cfg.d_ff, d)})

    def forward(self, x, positions, cache=None, cache_index=None, use_kernels=False):
        cfg = self.cfg
        h = rms_norm(x, self.ln1, cfg.norm_eps)
        attn_out, cache = gqa_attention(
            self.attn, h, positions, cfg.n_heads, cfg.n_kv_heads, cfg.d_head, cfg.rope_theta,
            window=self.window, cache=cache, cache_index=cache_index, use_kernels=use_kernels)
        x = x + attn_out
        h = rms_norm(x, self.ln2, cfg.norm_eps)
        return x + _ffn_apply(self.ffn, h), cache


def _ffn_apply(p, x: torch.Tensor) -> torch.Tensor:
    dt = x.dtype
    if "w_gate" in p:
        h = swiglu(x @ p["w_gate"].to(dt), x @ p["w_up"].to(dt))
    else:
        # jax.nn.gelu's default is the tanh approximation
        h = F.gelu(x @ p["w_in"].to(dt), approximate="tanh")
    return h @ p["w_down"].to(dt)


class Transformer(nn.Module):
    """The LM: embedding (tied unembedding unless ``tie_embeddings`` is
    off), ``n_layers`` decoder layers, final RMS norm.  Parameters are
    allocated uninitialised in ``cfg.param_dtype``; ``init_transformer``
    fills them from a generator, ``convert.transformer_params`` from the
    reference's parameter tree."""

    def __init__(self, cfg: TransformerConfig, device: torch.device):
        super().__init__()
        _check_ported(cfg)
        dtype = getattr(torch, cfg.param_dtype)
        self.cfg = cfg
        self.embed = frozen(torch.empty((cfg.vocab, cfg.d_model), device=device, dtype=dtype))
        self.final_norm = frozen(torch.zeros(cfg.d_model, device=device, dtype=dtype))
        self.layers = nn.ModuleList(DecoderLayer(cfg, w, device, dtype) for w in cfg.windows())
        if not cfg.tie_embeddings:
            self.unembed = frozen(torch.empty_like(self.embed))

    def unembedding(self) -> torch.Tensor:
        return self.embed if self.cfg.tie_embeddings else self.unembed


@torch.no_grad()
def init_transformer(cfg: TransformerConfig, generator: torch.Generator,
                     device: str | torch.device | None = None) -> Transformer:
    """A ``Transformer`` with random weights from ``generator`` (which must
    live on ``device``): dense weights normal with std 1/sqrt(d_in),
    embeddings normal with std 0.02, norm scales 0.  Each tensor is drawn
    in float32 on the device and cast to ``cfg.param_dtype`` at once, so
    no float32 copy of the whole model is ever held."""
    dev = resolve_device(device)
    if generator.device.type != dev.type:
        raise ValueError(f"init_transformer: generator on {generator.device}, model on {dev}")
    model = Transformer(cfg, dev)
    dtype = getattr(torch, cfg.param_dtype)
    for layer in model.layers:
        for name, w in init_gqa(generator, cfg.d_model, cfg.n_heads, cfg.n_kv_heads,
                                cfg.d_head, dtype).items():
            layer.attn[name].copy_(w)
        for name, w in layer.ffn.items():
            w.copy_(dense_init(generator, w.shape[0], w.shape[1], dtype))
    model.embed.copy_(embed_init(generator, cfg.vocab, cfg.d_model, dtype))
    if not cfg.tie_embeddings:
        model.unembed.copy_(embed_init(generator, cfg.vocab, cfg.d_model, dtype))
    return model


def _hidden(model: Transformer, tokens: torch.Tensor, caches, cache_index, use_kernels):
    """The final-normed hidden states (B, S, D)."""
    cfg = model.cfg
    dt = cfg.act_dtype
    S = tokens.shape[1]
    start = 0 if cache_index is None else int(cache_index)
    positions = start + torch.arange(S, dtype=torch.int32, device=tokens.device)
    x = model.embed.to(dt)[tokens]
    for i, layer in enumerate(model.layers):
        cache = caches["layers"][i] if caches is not None else None
        x, _ = layer(x, positions, cache=cache, cache_index=cache_index,
                     use_kernels=use_kernels)
    return rms_norm(x, model.final_norm, cfg.norm_eps)


def _logits(model: Transformer, x: torch.Tensor) -> torch.Tensor:
    return x @ model.unembedding().to(x.dtype).T


@torch.inference_mode()
def forward(model: Transformer, tokens: torch.Tensor, caches: dict | None = None,
            cache_index: int | None = None, use_kernels: bool | str = "auto"):
    """tokens (B, S) int -> (logits (B, S, vocab), caches).  With
    ``caches``, the new keys and values go in at ``cache_index``."""
    use = resolve_use_kernels(use_kernels, tokens.device)
    x = _hidden(model, tokens, caches, cache_index, use)
    return _logits(model, x), caches


def init_cache(cfg: TransformerConfig, batch: int, max_len: int,
               device: str | torch.device | None = None) -> dict:
    """Decode caches: per layer {'k', 'v'} of (batch, max_len, KV, dh) in
    ``cfg.dtype``, zero."""
    _check_ported(cfg)
    dev = resolve_device(device)
    shape = (batch, max_len, cfg.n_kv_heads, cfg.d_head)
    return {"layers": [
        {"k": torch.zeros(shape, dtype=cfg.act_dtype, device=dev),
         "v": torch.zeros(shape, dtype=cfg.act_dtype, device=dev)}
        for _ in range(cfg.n_layers)]}


@torch.inference_mode()
def prefill(model: Transformer, tokens: torch.Tensor, caches: dict,
            use_kernels: bool | str = "auto"):
    """Run the prompt (B, S) through the stack, filling ``caches`` from
    position 0; returns (last-token logits (B, vocab), caches)."""
    use = resolve_use_kernels(use_kernels, tokens.device)
    x = _hidden(model, tokens, caches, 0, use)
    return _logits(model, x[:, -1]), caches


@torch.inference_mode()
def decode_step(model: Transformer, token: torch.Tensor, caches: dict, cache_index: int):
    """One new token (B, 1) at ``cache_index`` against the caches; returns
    (logits (B, vocab), caches).  Decode attends over the cache with the
    plain attention: the kernel takes a prompt's own keys only."""
    x = _hidden(model, token, caches, cache_index, False)
    return _logits(model, x[:, -1]), caches
