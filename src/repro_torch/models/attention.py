"""Attention: grouped-query (GQA/MQA) and DeepSeek-V2's multi-head latent
attention (MLA), with causal and sliding-window masks and decode-time
caches (port of ``repro.models.attention``).

Routes.  When the keys are the queries' own (no cache, or a prefill into
an empty cache, ``cache_index == 0``) and ``use_kernels`` is on, attention
goes through ``kernels.flash_attention``: float32 scores and softmax, and
in bfloat16 the probabilities rounded to bfloat16 before P.V (as
FlashAttention-2/3 and SDPA do; the kernel's float32 route, and its plain
version on the CPU, keep them in float32).  Outside inference mode
(training, ``lm_loss``) above 2048 x 2048 score elements (the reference's
``_FLASH_THRESHOLD``), attention runs blocked with an online softmax and
float32 probabilities (``_flash_sdpa``: the reference's FlashAttention-2
``custom_vjp`` as a ``torch.autograd.Function``, plain PyTorch like the
reference's jnp), skipping block pairs the causal and window masks
exclude whole.  Every other call (decode, a prefill after earlier
tokens, ``use_kernels=False``, serving above the threshold) runs the plain
``_sdpa``, which casts the probabilities to the value type before P.V as
the reference's ``_sdpa`` does; the reference serves blocked above the
threshold, and in float32 the routes agree to rounding, in bfloat16 to
bfloat16 rounding of the probabilities.

On a mesh (q, k and v DTensors: ``lm_loss(mesh=)``), each rank runs the
plain or blocked core on its own rows and heads under ``local_map``.

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


# Above this many score elements (q_len x kv_len) attention outside
# inference mode runs blocked, with an online softmax and its own
# FlashAttention-2 backward (never materializing the S x L matrix).
_FLASH_THRESHOLD = 2048 * 2048
_Q_BLOCK = 512
_KV_BLOCK = 1024
# a padded key's position: past every query, so it never attends
_PAD_POS = 2**30


def _sdpa(q, k, v, mask, scale):
    """q: (B,S,KV,G,dh) k/v: (B,L,KV,dh) -> (B,S,KV,G,dv)."""
    scores = at_least_f32(torch.einsum("bskgd,btkd->bkgst", q, k)) * scale
    # mask: (B|1, 1, S, L) -> (B|1, 1, 1, S, L) broadcasts over (B,KV,G,S,L)
    scores = torch.where(mask[:, None], scores, -1e30)
    probs = torch.softmax(scores, dim=-1).to(v.dtype)
    return torch.einsum("bkgst,btkd->bskgd", probs, v)


def _pad_dim(x: torch.Tensor, dim: int, mult: int, value=0):
    """``x`` padded with ``value`` along ``dim`` to a multiple of ``mult``,
    and the length it had."""
    n = x.shape[dim]
    pad = (-n) % mult
    if pad == 0:
        return x, n
    shape = list(x.shape)
    shape[dim] = pad
    return torch.cat([x, x.new_full(shape, value)], dim=dim), n


def _block_mask(qpb: torch.Tensor, kpb: torch.Tensor, kv_last: int, w: int) -> torch.Tensor:
    """(qb, kb) validity from absolute positions."""
    valid = (qpb[:, None] >= kpb[None, :]) & (kpb[None, :] <= kv_last)
    if w > 0:
        valid = valid & (qpb[:, None] - kpb[None, :] < w)
    return valid


def _ranges_meet(qa: int, qb: int, ka: int, kb: int, kv_last: int, w: int) -> bool:
    """Whether a query in positions [qa, qb] attends a key in [ka, kb]."""
    kb = min(kb, kv_last)
    if ka > kb:
        return False
    lo = max(qa - kb, 0)          # the least q - k >= 0 over the two ranges
    return lo <= qb - ka and (w <= 0 or lo < w)


def block_plan(q_start: int, S: int, kv_start: int, L: int, kv_last: int,
               window: int) -> tuple:
    """For consecutive query positions ``q_start + arange(S)`` and key
    positions ``kv_start + arange(L)``: per query block, the key blocks
    that hold at least one valid (query, key) pair, padding included as
    ``_flash_sdpa`` pads (queries at position 0, keys past every query).
    A block pair outside the plan is masked whole, and computing it adds
    exact zeros (``corr`` is 1, or 0 on a row that has seen no key, where
    ``l`` and ``acc`` are still 0), so skipping it changes no bit."""
    nq, nk = -(-S // _Q_BLOCK), -(-L // _KV_BLOCK)
    plan = []
    for i in range(nq):
        rows = [(q_start + i * _Q_BLOCK, q_start + min((i + 1) * _Q_BLOCK, S) - 1)]
        if (i + 1) * _Q_BLOCK > S:
            rows.append((0, 0))
        plan.append(tuple(
            j for j in range(nk)
            if any(_ranges_meet(qa, qb, kv_start + j * _KV_BLOCK,
                                kv_start + min((j + 1) * _KV_BLOCK, L) - 1, kv_last, window)
                   for qa, qb in rows)))
    return tuple(plan)


def _to_blocks(q_pad, k_pad, v_pad, qp_pad, kp_pad):
    B, Sq, KV, G, dh = q_pad.shape
    nq, nk = Sq // _Q_BLOCK, k_pad.shape[1] // _KV_BLOCK
    return (q_pad.reshape(B, nq, _Q_BLOCK, KV, G, dh),
            k_pad.reshape(B, nk, _KV_BLOCK, KV, dh),
            v_pad.reshape(B, nk, _KV_BLOCK, KV, v_pad.shape[-1]),
            qp_pad.reshape(nq, _Q_BLOCK), kp_pad.reshape(nk, _KV_BLOCK))


def _pairs(plan, qi: int, nk: int):
    return range(nk) if plan is None else plan[qi]


def _flash_fwd_blocks(q_blocks, k_blocks, v_blocks, qp_blocks, kp_blocks, kv_last: int,
                      w: int, plan):
    """Returns out (B, nq*qb, KV, G, dv) and lse (B, KV, G, nq*qb), in the
    queries' (float32 or wider) dtype."""
    B, nq, QB, KV, G, _ = q_blocks.shape
    nk = kp_blocks.shape[0]
    dv = v_blocks.shape[-1]
    ct = q_blocks.dtype
    inf = torch.tensor(float("inf"), dtype=ct, device=q_blocks.device)
    outs, lses = [], []
    for qi in range(nq):
        qb = q_blocks[:, qi]
        m = torch.full((B, KV, G, QB), float("-inf"), dtype=ct, device=qb.device)
        l = torch.zeros((B, KV, G, QB), dtype=ct, device=qb.device)
        acc = torch.zeros((B, KV, G, QB, dv), dtype=ct, device=qb.device)
        for ki in _pairs(plan, qi, nk):
            s = torch.einsum("bskgd,btkd->bkgst", qb, k_blocks[:, ki].to(ct))
            valid = _block_mask(qp_blocks[qi], kp_blocks[ki], kv_last, w)
            s = torch.where(valid, s, -inf)
            m_new = torch.maximum(m, s.amax(dim=-1))
            m_safe = torch.where(torch.isfinite(m_new), m_new, 0.0)
            p = torch.where(torch.isfinite(s), torch.exp(s - m_safe[..., None]), 0.0)
            corr = torch.where(torch.isfinite(m), torch.exp(m - m_safe), 0.0)
            l = l * corr + p.sum(dim=-1)
            acc = acc * corr[..., None] + torch.einsum("bkgst,btkd->bkgsd", p,
                                                       v_blocks[:, ki].to(ct))
            m = m_new
        outs.append((acc / l.clamp_min(1e-30)[..., None]).permute(0, 3, 1, 2, 4))
        m_safe = torch.where(torch.isfinite(m), m, 0.0)
        lses.append(m_safe + torch.log(l.clamp_min(1e-30)))
    return torch.cat(outs, dim=1), torch.cat(lses, dim=-1)


def _flash_bwd_blocks(q_blocks, k_blocks, v_blocks, qp_blocks, kp_blocks, kv_last: int,
                      w: int, plan, out, lse, dout):
    """FlashAttention-2 backward: p recomputed per (q, kv) block pair from
    the saved ``lse``; returns (dq, dk, dv) in the compute dtype, in the
    padded (B, S, ...) / (B, L, ...) layouts."""
    B, nq, QB, KV, G, dh = q_blocks.shape
    nk, KB = kp_blocks.shape
    dv = v_blocks.shape[-1]
    ct = q_blocks.dtype
    inf = torch.tensor(float("inf"), dtype=ct, device=q_blocks.device)
    dout = dout.to(ct)
    # D_i = rowsum(dout * out)  (B, KV, G, S)
    delta = torch.einsum("bskgd,bskgd->bkgs", dout, out)
    lse_blocks = lse.reshape(B, KV, G, nq, QB)
    delta_blocks = delta.reshape(B, KV, G, nq, QB)
    dout_blocks = dout.reshape(B, nq, QB, KV, G, dv)
    dk = torch.zeros((B, nk, KB, KV, dh), dtype=ct, device=q_blocks.device)
    dvv = torch.zeros((B, nk, KB, KV, dv), dtype=ct, device=q_blocks.device)
    dqs = []
    for qi in range(nq):
        qb, dob = q_blocks[:, qi], dout_blocks[:, qi]
        lse_b, delta_b = lse_blocks[:, :, :, qi], delta_blocks[:, :, :, qi]
        dq_b = torch.zeros((B, QB, KV, G, dh), dtype=ct, device=qb.device)
        for ki in _pairs(plan, qi, nk):
            kb, vb = k_blocks[:, ki].to(ct), v_blocks[:, ki].to(ct)
            s = torch.einsum("bskgd,btkd->bkgst", qb, kb)
            valid = _block_mask(qp_blocks[qi], kp_blocks[ki], kv_last, w)
            s = torch.where(valid, s, -inf)
            p = torch.where(torch.isfinite(s), torch.exp(s - lse_b[..., None]), 0.0)
            dp = torch.einsum("bskgd,btkd->bkgst", dob, vb)
            ds = p * (dp - delta_b[..., None])
            dq_b = dq_b + torch.einsum("bkgst,btkd->bskgd", ds, kb)
            dk[:, ki] += torch.einsum("bkgst,bskgd->btkd", ds, qb)
            dvv[:, ki] += torch.einsum("bkgst,bskgd->btkd", p, dob)
        dqs.append(dq_b)
    return (torch.cat(dqs, dim=1), dk.reshape(B, nk * KB, KV, dh),
            dvv.reshape(B, nk * KB, KV, dv))


class _FlashCore(torch.autograd.Function):
    """The blocked core on padded operands (the reference's ``_flash_core``
    ``custom_vjp``): the forward saves the operands, ``out`` and ``lse``
    and nothing tile-sized; the backward recomputes ``p`` per block
    pair."""

    @staticmethod
    def forward(ctx, q_pad, k_pad, v_pad, qp_pad, kp_pad, kv_last, w, plan):
        blocks = _to_blocks(q_pad, k_pad, v_pad, qp_pad, kp_pad)
        out, lse = _flash_fwd_blocks(*blocks, kv_last, w, plan)
        ctx.save_for_backward(q_pad, k_pad, v_pad, qp_pad, kp_pad, out, lse)
        ctx.args = (kv_last, w, plan)
        return out

    @staticmethod
    def backward(ctx, dout):
        q_pad, k_pad, v_pad, qp_pad, kp_pad, out, lse = ctx.saved_tensors
        blocks = _to_blocks(q_pad, k_pad, v_pad, qp_pad, kp_pad)
        dq, dk, dv = _flash_bwd_blocks(*blocks, *ctx.args, out, lse, dout)
        return (dq.to(q_pad.dtype), dk.to(k_pad.dtype), dv.to(v_pad.dtype),
                None, None, None, None, None)


def _flash_sdpa(q, k, v, q_pos, kv_pos, kv_last: int, window: int, scale: float,
                plan=None):
    """Blocked attention with an online softmax and the FlashAttention-2
    backward (the reference's ``_flash_sdpa``), in float32 (float64 stays
    float64) whatever the operands' dtype; never more than a (qb x kb)
    tile of scores.  ``plan`` (``block_plan``) lists the block pairs to
    compute; ``None`` computes every pair, as the reference does.

    q: (B,S,KV,G,dh); k: (B,L,KV,dh); v: (B,L,KV,dv); q_pos (S,) and
    kv_pos (L,) absolute positions; kv_last the last valid key position;
    window 0 = global.  Returns (B,S,KV,G,dv) in v's dtype."""
    ct = torch.promote_types(q.dtype, torch.float32)
    q_pad, S0 = _pad_dim(q.to(ct) * scale, 1, _Q_BLOCK)
    qp_pad, _ = _pad_dim(q_pos.to(torch.int32), 0, _Q_BLOCK)
    k_pad, _ = _pad_dim(k, 1, _KV_BLOCK)
    v_pad, _ = _pad_dim(v, 1, _KV_BLOCK)
    kp_pad, _ = _pad_dim(kv_pos.to(torch.int32), 0, _KV_BLOCK, _PAD_POS)
    out = _FlashCore.apply(q_pad, k_pad, v_pad, qp_pad, kp_pad, int(kv_last), int(window), plan)
    return out[:, :S0].to(v.dtype)


def _on_local_heads(fn, q, k, v, *args):
    """``fn(q, k, v, *args)``; when ``q``, ``k`` and ``v`` are DTensors
    (a model on a mesh), each rank runs ``fn`` on its own rows and heads
    under ``local_map`` and the result is a DTensor of them.  The batch
    dim is split over the batch axes and the KV-head dim (dim 2) over
    ``model`` where the head count divides it, else replicated (MQA's one
    KV head); heads and rows are independent, so this is exact.  ``args``
    are plain tensors and numbers (positions, masks), the same on every
    rank."""
    from torch.distributed.tensor import DTensor

    if not isinstance(q, DTensor):
        return fn(q, k, v, *args)
    from torch.distributed.tensor import Replicate, Shard
    from torch.distributed.tensor.experimental import local_map

    dm = q.device_mesh
    pl = []
    for i, name in enumerate(dm.mesh_dim_names):
        if name in ("pod", "data"):
            pl.append(Shard(0))
        elif name == "model" and k.shape[2] % dm.size(i) == 0:
            pl.append(Shard(2))
        else:
            pl.append(Replicate())
    pl = tuple(pl)
    q, k, v = (t.redistribute(dm, pl) for t in (q, k, v))
    return local_map(lambda q, k, v: fn(q, k, v, *args), out_placements=(pl,),
                     in_placements=(pl, pl, pl), device_mesh=dm)(q, k, v)


def _blocked(S: int, L: int) -> bool:
    """The blocked route: above ``_FLASH_THRESHOLD`` score elements and
    outside inference mode (training, ``lm_loss``); serving keeps its
    routes."""
    return S * L > _FLASH_THRESHOLD and not torch.is_inference_mode_enabled()


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


class _GradPlacedAsValue(torch.autograd.Function):
    """The identity on a DTensor whose adjoint places the gradient as the
    value is placed, its local shard contiguous: DTensor's own choice for
    a projection's gradient (a split of the sequence over ``model``, which
    a flattened batch turns into a strided split) can give the weight's
    gradient product a layout it cannot place (train_4k at 16 x 16)."""

    @staticmethod
    def forward(ctx, t):
        from torch.distributed.tensor import Partial, Replicate

        # a partial sum's gradient is the whole gradient on every rank
        ctx.dm = t.device_mesh
        ctx.pl = tuple(Replicate() if isinstance(p, Partial) else p for p in t.placements)
        return t.view_as(t)

    @staticmethod
    def backward(ctx, grad):
        from torch.distributed.tensor import DTensor

        if tuple(grad.placements) != ctx.pl:
            grad = grad.redistribute(ctx.dm, ctx.pl)
        return DTensor.from_local(grad.to_local().contiguous(), ctx.dm, ctx.pl,
                                  run_check=False, shape=grad.shape, stride=grad.stride())


def _grad_placed(t: torch.Tensor) -> torch.Tensor:
    """``t``; a DTensor's gradient placed as ``t`` (``_GradPlacedAsValue``)."""
    return _GradPlacedAsValue.apply(t) if hasattr(t, "placements") else t


def _gather_unsplit(t: torch.Tensor, dim: int, n: int) -> torch.Tensor:
    """``t``, a DTensor whose ``dim`` is split over a mesh dim whose size
    does not divide ``n`` (the heads or KV groups that dim is about to be
    cut into: 8 KV heads, or MQA's one, over a ``model`` axis of 16),
    gathered on that mesh dim first: DTensor cannot split a head across
    ranks.  A plain tensor as it is."""
    if not hasattr(t, "placements"):
        return t
    from torch.distributed.tensor import Replicate, Shard

    dm, dim = t.device_mesh, dim % t.ndim
    pl = [Replicate() if isinstance(q, Shard) and q.dim == dim and n % dm.size(i) else q
          for i, q in enumerate(t.placements)]
    return t.redistribute(dm, pl) if pl != list(t.placements) else t


def _split_heads(t: torch.Tensor, n: int, dh: int) -> torch.Tensor:
    """A projection (B, S, n * dh) -> (B, S, n, dh), gathering what DTensor
    cannot cut, its gradient placed as the projection."""
    return _gather_unsplit(_grad_placed(t), -1, n).reshape(*t.shape[:-1], n, dh)


def gqa_attention(p, x: torch.Tensor, positions: torch.Tensor, n_heads: int, n_kv: int,
                  d_head: int, rope_theta: float, window: int = 0, cache: dict | None = None,
                  cache_index: int | None = None, use_kernels: bool = False):
    """x (B, S, D) -> ((B, S, D), cache).  ``p`` maps wq, wk, wv, wo;
    ``cache`` is {'k': (B, L, KV, dh), 'v': ...}, written in place at
    ``cache_index``."""
    B, S, _ = x.shape
    G = n_heads // n_kv
    dt = x.dtype

    q = _split_heads(x @ p["wq"].to(dt), n_heads, d_head)
    k = _split_heads(x @ p["wk"].to(dt), n_kv, d_head)
    v = _split_heads(x @ p["wv"].to(dt), n_kv, d_head)
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
        q5 = _gather_unsplit(q, 2, n_kv).reshape(B, S, n_kv, G, d_head)
        if _blocked(S, start + S):
            out = _on_local_heads(_flash_sdpa, q5, k_all, v_all, positions, kv_pos,
                                  start + S - 1, window, scale,
                                  block_plan(start, S, 0, start + S, start + S - 1, window))
        else:
            mask = attention_mask(positions, kv_pos, None, window)
            out = _on_local_heads(_sdpa, q5, k_all, v_all, mask, scale)
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
        q = _split_heads(cq @ p["w_uq"].to(dt), H, dn + dr)
    else:
        q = _split_heads(x @ p["wq"].to(dt), H, dn + dr)
    q_nope, q_rope = q[..., :dn], apply_rope(q[..., dn:], positions, rope_theta)
    c_kv = rms_norm(_grad_placed(x @ p["w_dkv"].to(dt)), p["kv_norm"])    # (B, S, kv_lora)
    k_rope = apply_rope(_grad_placed(x @ p["w_kr"].to(dt))[:, :, None, :], positions,
                        rope_theta)[:, :, 0]

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
    k_nope = _split_heads(ckv_all @ p["w_uk"].to(dt), H, dn)
    v = _split_heads(ckv_all @ p["w_uv"].to(dt), H, dv)
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
    elif _blocked(S, L):
        # the shared rotary key folded into per-head keys: KV = H, G = 1
        q_all = torch.cat([q_nope, q_rope], dim=-1)[:, :, :, None, :]
        k_eff = torch.cat([k_nope, kr_all[:, :, None, :].expand(B, L, H, dr)], dim=-1)
        out = _on_local_heads(_flash_sdpa, q_all, k_eff, v, positions, kv_pos, L - 1, window,
                              scale, block_plan(start, S, 0, L, L - 1, window))
        out = out.reshape(B, S, H * dv)
    else:
        mask = attention_mask(positions, kv_pos, None, window)          # (1, 1, S, L)
        out = _mla_on_local_heads(q_nope, q_rope, k_nope, kr_all, v, mask, scale)
        out = out.reshape(B, S, H * dv)
    return out @ p["wo"].to(dt), cache


def _mla_plain(q_nope, q_rope, k_nope, kr_all, v, mask, scale):
    """MLA's plain core: the reference's two-einsum score (the shared
    rotary key kept apart) -> (B, S, H, dv)."""
    scores = (torch.einsum("bshd,bthd->bhst", q_nope, k_nope)
              + torch.einsum("bshd,btd->bhst", q_rope, kr_all))
    scores = at_least_f32(scores) * scale
    scores = torch.where(mask, scores, -1e30)
    probs = torch.softmax(scores, dim=-1).to(v.dtype)
    return torch.einsum("bhst,bthd->bshd", probs, v)


def _mla_on_local_heads(q_nope, q_rope, k_nope, kr_all, v, mask, scale):
    """``_mla_plain``; on DTensors each rank runs it on its own rows and
    heads under ``local_map`` (the heads split over ``model`` where their
    count divides it, the shared rotary key whole on every model rank), so
    a rank computes what one device computes for those heads.  The shared
    key's gradient from a rank is its heads' share: a ``Partial`` sum over
    the head split."""
    if not hasattr(q_nope, "placements"):
        return _mla_plain(q_nope, q_rope, k_nope, kr_all, v, mask, scale)
    from torch.distributed.tensor import Partial, Replicate, Shard
    from torch.distributed.tensor.experimental import local_map

    dm = q_nope.device_mesh
    heads, shared, shared_grad = [], [], []
    for i, name in enumerate(dm.mesh_dim_names):
        batch = name in ("pod", "data")
        split = not batch and name == "model" and q_nope.shape[2] % dm.size(i) == 0
        heads.append(Shard(0) if batch else Shard(2) if split else Replicate())
        shared.append(Shard(0) if batch else Replicate())
        shared_grad.append(Shard(0) if batch else Partial() if split else Replicate())
    heads, shared = tuple(heads), tuple(shared)
    args = [t.redistribute(dm, pl) for t, pl in ((q_nope, heads), (q_rope, heads),
                                                 (k_nope, heads), (kr_all, shared), (v, heads))]
    return local_map(lambda qn, qr, kn, kr, vv: _mla_plain(qn, qr, kn, kr, vv, mask, scale),
                     out_placements=(heads,), in_placements=(heads, heads, heads, shared, heads),
                     in_grad_placements=(heads, heads, heads, tuple(shared_grad), heads),
                     device_mesh=dm)(*args)
