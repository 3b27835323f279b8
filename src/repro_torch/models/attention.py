"""Attention: grouped-query (GQA/MQA) and DeepSeek-V2's multi-head latent
attention (MLA), with causal and sliding-window masks and decode-time
caches (port of ``repro.models.attention``).

Routes.  When the keys are the queries' own (no cache, or a prefill into
an empty cache, ``cache_index == 0``) and ``use_kernels`` is on, attention
goes through ``kernels.flash_attention``: float32 scores and softmax, and
in bfloat16 the probabilities rounded to bfloat16 before P.V (as
FlashAttention-2/3 and SDPA do; the kernel's float32 route, and its plain
version on the CPU, keep them in float32).  Every other call (decode, a
prefill after earlier tokens, ``use_kernels=False``) runs the plain
``_sdpa``, which casts the probabilities to the value type before P.V as
the reference's ``_sdpa`` does.  The reference itself takes a blocked
online softmax with float32 probabilities above 2048 x 2048 score elements
(its ``_FLASH_THRESHOLD``); in float32 the routes agree to rounding, in
bfloat16 to bfloat16 rounding of the probabilities.

Caches.  The reference's caches are functional; the port writes the new
keys and values into the cache tensors in place and returns the same dict.
A prefill attends over the prompt's keys only, and a decode step over the
``cache_index + S`` filled positions, where the reference attends over the
whole cache and masks the positions past ``kv_last``: the masked positions
carry zero weight in both, so the function is the same.

Positions are consecutive (``cache_index + arange(S)``, or ``arange(S)``
without a cache), as ``transformer.forward`` passes them.

MLA follows the same routes.  Its kernel route feeds ``flash_attention``
one key head a query head (``kv_groups=1``): queries ``cat(q_nope,
q_rope)``, keys ``cat(k_nope, kr)`` with the shared rotary key broadcast
over the heads, and values ``d_v`` wide (the kernel takes values narrower
than the keys; the TPU wrapper pads them to its ``d_pad``).
Its plain route is the reference's two-einsum score.  Its cache holds the
latent ``ckv`` and the rotary ``kr`` only; the per-head keys and values are
recomputed from it, as in the reference.
"""

from __future__ import annotations

import dataclasses
from dataclasses import dataclass

import numpy as np
import torch

from repro_torch.kernels.flash_attention.ops import flash_attention
from repro_torch.models.common import apply_rope, at_least_f32, dense_init, rms_norm


@dataclass(frozen=True)
class MLAConfig:
    kv_lora: int = 512
    q_lora: int = 0        # 0 = direct q projection (V2-Lite)
    d_nope: int = 128      # non-rotary head dim
    d_rope: int = 64       # shared rotary dim
    d_v: int = 128         # value head dim

    def replace(self, **kw) -> "MLAConfig":
        return dataclasses.replace(self, **kw)


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


# The reference attends blocked, with an online softmax and its own
# FlashAttention-2 backward, above this many score elements (q_len x
# kv_len); the port's training route is the plain ``_sdpa`` below it.
_FLASH_THRESHOLD = 2048 * 2048


def _sdpa(q, k, v, mask, scale):
    """q: (B,S,KV,G,dh) k/v: (B,L,KV,dh) -> (B,S,KV,G,dv)."""
    scores = at_least_f32(torch.einsum("bskgd,btkd->bkgst", q, k)) * scale
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


def init_mla(generator: torch.Generator, d_model: int, n_heads: int, mla: MLAConfig,
             dtype: torch.dtype = torch.float32) -> dict:
    """The reference's ``init_mla`` parameters from ``generator``."""
    H = n_heads
    p = {
        "w_dkv": dense_init(generator, d_model, mla.kv_lora, dtype),
        "kv_norm": torch.zeros(mla.kv_lora, dtype=dtype, device=generator.device),
        "w_uk": dense_init(generator, mla.kv_lora, H * mla.d_nope, dtype),
        "w_uv": dense_init(generator, mla.kv_lora, H * mla.d_v, dtype),
        "w_kr": dense_init(generator, d_model, mla.d_rope, dtype),
        "wo": dense_init(generator, H * mla.d_v, d_model, dtype),
    }
    if mla.q_lora:
        p["w_dq"] = dense_init(generator, d_model, mla.q_lora, dtype)
        p["q_norm"] = torch.zeros(mla.q_lora, dtype=dtype, device=generator.device)
        p["w_uq"] = dense_init(generator, mla.q_lora, H * (mla.d_nope + mla.d_rope), dtype)
    else:
        p["wq"] = dense_init(generator, d_model, H * (mla.d_nope + mla.d_rope), dtype)
    return p


def mla_attention(p, x: torch.Tensor, positions: torch.Tensor, n_heads: int, mla: MLAConfig,
                  rope_theta: float, window: int = 0, cache: dict | None = None,
                  cache_index: int | None = None, use_kernels: bool = False):
    """Multi-head latent attention: x (B, S, D) -> ((B, S, D), cache).
    ``cache`` is {'ckv': (B, L, kv_lora), 'kr': (B, L, d_rope)}, written in
    place at ``cache_index``."""
    B, S, _ = x.shape
    dt = x.dtype
    H, dn, dr, dv = n_heads, mla.d_nope, mla.d_rope, mla.d_v

    if mla.q_lora:
        cq = rms_norm(x @ p["w_dq"].to(dt), p["q_norm"])
        q = (cq @ p["w_uq"].to(dt)).reshape(B, S, H, dn + dr)
    else:
        q = (x @ p["wq"].to(dt)).reshape(B, S, H, dn + dr)
    q_nope, q_rope = q[..., :dn], apply_rope(q[..., dn:], positions, rope_theta)
    c_kv = rms_norm(x @ p["w_dkv"].to(dt), p["kv_norm"])                  # (B, S, kv_lora)
    k_rope = apply_rope((x @ p["w_kr"].to(dt))[:, :, None, :], positions, rope_theta)[:, :, 0]

    start = 0
    if cache is not None:
        start = int(cache_index)
        cache["ckv"][:, start:start + S] = c_kv
        cache["kr"][:, start:start + S] = k_rope
        ckv_all, kr_all = cache["ckv"][:, :start + S], cache["kr"][:, :start + S]
        kv_pos = torch.arange(start + S, device=x.device)
    else:
        ckv_all, kr_all, kv_pos = c_kv, k_rope, positions
    L = ckv_all.shape[1]
    k_nope = (ckv_all @ p["w_uk"].to(dt)).reshape(B, L, H, dn)
    v = (ckv_all @ p["w_uv"].to(dt)).reshape(B, L, H, dv)
    scale = attention_scale(dn + dr)

    if use_kernels and start == 0:
        dh = dn + dr
        qh = torch.cat([q_nope, q_rope], dim=-1).transpose(1, 2).reshape(B * H, S, dh)
        kh = torch.cat([k_nope, kr_all[:, :, None, :].expand(B, L, H, dr)], dim=-1)
        kh = kh.transpose(1, 2).reshape(B * H, L, dh)
        vh = v.transpose(1, 2).reshape(B * H, L, dv)
        o = flash_attention(qh.contiguous(), kh.contiguous(), vh.contiguous(), scale=scale,
                            window=window, causal=True)
        out = o.reshape(B, H, S, dv).transpose(1, 2).reshape(B, S, H * dv)
    else:
        mask = attention_mask(positions, kv_pos, None, window)          # (1, 1, S, L)
        scores = (torch.einsum("bshd,bthd->bhst", q_nope, k_nope)
                  + torch.einsum("bshd,btd->bhst", q_rope, kr_all))
        scores = at_least_f32(scores) * scale
        scores = torch.where(mask, scores, -1e30)
        probs = torch.softmax(scores, dim=-1).to(dt)
        out = torch.einsum("bhst,bthd->bshd", probs, v).reshape(B, S, H * dv)
    return out @ p["wo"].to(dt), cache
