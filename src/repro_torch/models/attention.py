"""Grouped-query attention (GQA/MQA) with causal and sliding-window masks
and decode-time KV caches (port of the GQA half of
``repro.models.attention``).

Routes.  When the keys are the queries' own (no cache, or a prefill into
an empty cache, ``cache_index == 0``) and ``use_kernels`` is on, attention
goes through ``kernels.flash_attention`` (float32 probabilities).  Every
other call (decode, a prefill after earlier tokens, ``use_kernels=False``)
runs the plain ``_sdpa``, which casts the probabilities to the value type
before P.V as the reference's ``_sdpa`` does.  The reference itself takes a
blocked online softmax with float32 probabilities above 2048 x 2048 score
elements (its ``_FLASH_THRESHOLD``); in float32 the routes agree to rounding, in bfloat16 to
bfloat16 rounding of the probabilities.

Caches.  The reference's caches are functional; the port writes the new
keys and values into the cache tensors in place and returns the same dict.
A prefill attends over the prompt's keys only, and a decode step over the
``cache_index + S`` filled positions, where the reference attends over the
whole cache and masks the positions past ``kv_last``: the masked positions
carry zero weight in both, so the function is the same.

Positions are consecutive (``cache_index + arange(S)``, or ``arange(S)``
without a cache), as ``transformer.forward`` passes them.
"""

from __future__ import annotations

import numpy as np
import torch

from repro_torch.kernels.flash_attention.ops import flash_attention
from repro_torch.models.common import apply_rope, dense_init


NOT_PORTED_MLA = ("MLA is not ported yet (ROADMAP queue 1, item 15: MoE serving, whose "
                  "deepseek-v2-lite needs MLA)")


def attention_mask(q_pos: torch.Tensor, kv_pos: torch.Tensor,
                   kv_valid: torch.Tensor | None, window: int) -> torch.Tensor:
    """(B|1, 1, S, L) bool: causal, within ``window`` (0 = global), and
    ``kv_valid`` (B, L) where given."""
    mask = q_pos[:, None] >= kv_pos[None, :]
    if window > 0:
        mask = mask & (q_pos[:, None] - kv_pos[None, :] < window)
    if kv_valid is not None:
        return (mask[None] & kv_valid[:, None, :])[:, None]
    return mask[None, None]


def _sdpa(q, k, v, mask, scale):
    """q: (B,S,KV,G,dh) k/v: (B,L,KV,dh) -> (B,S,KV,G,dv)."""
    scores = torch.einsum("bskgd,btkd->bkgst", q, k).float() * scale
    # mask: (B|1, 1, S, L) -> (B|1, 1, 1, S, L) broadcasts over (B,KV,G,S,L)
    scores = torch.where(mask[:, None], scores, -1e30)
    probs = torch.softmax(scores, dim=-1).to(v.dtype)
    return torch.einsum("bkgst,btkd->bskgd", probs, v)


def init_gqa(generator: torch.Generator, d_model: int, n_heads: int, n_kv: int, d_head: int,
             dtype: torch.dtype = torch.float32) -> dict:
    return {
        "wq": dense_init(generator, d_model, n_heads * d_head, dtype),
        "wk": dense_init(generator, d_model, n_kv * d_head, dtype),
        "wv": dense_init(generator, d_model, n_kv * d_head, dtype),
        "wo": dense_init(generator, n_heads * d_head, d_model, dtype),
    }


def attention_scale(d_head: int) -> float:
    """1 / sqrt(d_head) in float32, as the reference computes it."""
    return float(np.float32(1.0) / np.sqrt(np.float32(d_head)))


def gqa_attention(p, x: torch.Tensor, positions: torch.Tensor, n_heads: int, n_kv: int,
                  d_head: int, rope_theta: float, window: int = 0, cache: dict | None = None,
                  cache_index: int | None = None, use_kernels: bool = False):
    """x (B, S, D) -> ((B, S, D), cache).  ``p`` maps wq, wk, wv, wo;
    ``cache`` is {'k': (B, L, KV, dh), 'v': ...}, written in place at
    ``cache_index``."""
    B, S, _ = x.shape
    G = n_heads // n_kv
    dt = x.dtype

    q = (x @ p["wq"].to(dt)).reshape(B, S, n_heads, d_head)
    k = (x @ p["wk"].to(dt)).reshape(B, S, n_kv, d_head)
    v = (x @ p["wv"].to(dt)).reshape(B, S, n_kv, d_head)
    q = apply_rope(q, positions, rope_theta)
    k = apply_rope(k, positions, rope_theta)
    scale = attention_scale(d_head)

    start = 0
    if cache is not None:
        start = int(cache_index)
        cache["k"][:, start:start + S] = k
        cache["v"][:, start:start + S] = v
    if use_kernels and start == 0:
        # (B*KV*G, S, dh) queries over (B*KV, S, dh) keys: head bh reads bh // G
        qh = q.reshape(B, S, n_kv, G, d_head).permute(0, 2, 3, 1, 4)
        qh = qh.reshape(-1, S, d_head).contiguous()
        kh = k.permute(0, 2, 1, 3).reshape(-1, S, d_head).contiguous()
        vh = v.permute(0, 2, 1, 3).reshape(-1, S, d_head).contiguous()
        o = flash_attention(qh, kh, vh, scale=scale, window=window, causal=True, kv_groups=G)
        out = o.reshape(B, n_heads, S, d_head).transpose(1, 2).reshape(B, S, n_heads * d_head)
    else:
        if cache is not None:
            k_all, v_all = cache["k"][:, :start + S], cache["v"][:, :start + S]
            kv_pos = torch.arange(start + S, device=x.device)
        else:
            k_all, v_all, kv_pos = k, v, positions
        mask = attention_mask(positions, kv_pos, None, window)
        out = _sdpa(q.reshape(B, S, n_kv, G, d_head), k_all, v_all, mask, scale)
        out = out.reshape(B, S, n_heads * d_head)
    return out @ p["wo"].to(dt), cache


def mla_attention(*args, **kwargs):
    raise NotImplementedError(NOT_PORTED_MLA)
