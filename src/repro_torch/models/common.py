"""Shared building blocks: RMS and layer norm, RoPE, SwiGLU, the
initializers, the biased MLP of the DLRM and GNN heads and the LM's cross
entropy (port of ``repro.models.common``).

The arithmetic follows the reference where the two could part: both norms
run in float32, or float64 for a float64 input (the RMS norm scales by
``1 + scale``); RoPE rotates
interleaved (even, odd) pairs by float32 angles of the integer positions.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F
from torch import nn


def at_least_f32(x: torch.Tensor) -> torch.Tensor:
    """``x`` in float32, or in its own dtype when that is wider (float64
    stays float64, so a float64 copy of a model computes in float64)."""
    return x.to(torch.promote_types(x.dtype, torch.float32))


def rms_norm(x: torch.Tensor, scale: torch.Tensor, eps: float = 1e-6) -> torch.Tensor:
    dtype = x.dtype
    x = at_least_f32(x)
    var = x.square().mean(dim=-1, keepdim=True)
    out = x * torch.rsqrt(var + eps) * (1.0 + scale.to(x.dtype))
    return out.to(dtype)


def layer_norm(x: torch.Tensor, scale: torch.Tensor, bias: torch.Tensor,
               eps: float = 1e-5) -> torch.Tensor:
    """``(x - mu) * rsqrt(var + eps) * scale + bias`` over the last axis in
    float32 (float64 stays float64), cast back to x's dtype."""
    dtype = x.dtype
    x = x.to(torch.promote_types(dtype, torch.float32))
    mu = x.mean(dim=-1, keepdim=True)
    var = (x - mu).square().mean(dim=-1, keepdim=True)
    out = (x - mu) * torch.rsqrt(var + eps) * scale + bias
    return out.to(dtype)


def frozen(t: torch.Tensor) -> nn.Parameter:
    """An inference-only parameter (no gradient)."""
    return nn.Parameter(t, requires_grad=False)


def dense_init(generator: torch.Generator, d_in: int, d_out: int,
               dtype: torch.dtype = torch.float32) -> torch.Tensor:
    """(d_in, d_out) normal weights with std 1/sqrt(d_in), drawn in float32
    on the generator's device, then cast."""
    w = torch.randn((d_in, d_out), generator=generator, device=generator.device,
                    dtype=torch.float32)
    return w.mul_(1.0 / d_in ** 0.5).to(dtype)


def embed_init(generator: torch.Generator, vocab: int, d: int,
               dtype: torch.dtype = torch.float32) -> torch.Tensor:
    w = torch.randn((vocab, d), generator=generator, device=generator.device,
                    dtype=torch.float32)
    return w.mul_(0.02).to(dtype)


def mlp_init(generator: torch.Generator, dims: list[int],
             dtype: torch.dtype = torch.float32) -> dict:
    """Simple biased MLP used by the DLRM towers and the GNN heads:
    ``{"w": [(d_i, d_i+1)], "b": [(d_i+1,)]}``, weights as ``dense_init``,
    biases 0."""
    return {
        "w": [dense_init(generator, dims[i], dims[i + 1], dtype) for i in range(len(dims) - 1)],
        "b": [torch.zeros(dims[i + 1], dtype=dtype, device=generator.device)
              for i in range(len(dims) - 1)],
    }


def mlp_apply(params, x: torch.Tensor, act=F.relu, final_act=None) -> torch.Tensor:
    """``x @ w + b`` per layer, weights and biases cast to x's dtype, ``act``
    between layers and ``final_act`` (if any) after the last."""
    n = len(params["w"])
    for i, (w, b) in enumerate(zip(params["w"], params["b"])):
        x = x @ w.to(x.dtype) + b.to(x.dtype)
        if i < n - 1:
            x = act(x)
        elif final_act is not None:
            x = final_act(x)
    return x


def rope_frequencies(d_head: int, theta: float = 10_000.0,
                     device: torch.device | None = None) -> torch.Tensor:
    exps = torch.arange(0, d_head, 2, dtype=torch.float32, device=device) / d_head
    # a Python-scalar base: a tensor made from theta would be a host-to-device
    # copy, which waits for the card, twice per layer
    return 1.0 / torch.pow(theta, exps)


def apply_rope(x: torch.Tensor, positions: torch.Tensor,
               theta: float = 10_000.0) -> torch.Tensor:
    """x: (..., S, H, Dh); positions: (..., S).  Rotates pairs (even, odd)."""
    freqs = rope_frequencies(x.shape[-1], theta, x.device)              # (Dh/2,)
    angles = positions[..., :, None, None].float() * freqs             # (..., S, 1, Dh/2)
    cos, sin = torch.cos(angles), torch.sin(angles)
    x1, x2 = x[..., 0::2], x[..., 1::2]
    out1 = x1 * cos - x2 * sin
    out2 = x2 * cos + x1 * sin
    return torch.stack([out1, out2], dim=-1).reshape(x.shape).to(x.dtype)


def swiglu(gate: torch.Tensor, up: torch.Tensor) -> torch.Tensor:
    return F.silu(gate) * up


def cross_entropy_loss(logits: torch.Tensor, labels: torch.Tensor,
                       mask: torch.Tensor | None = None) -> torch.Tensor:
    """Mean token-level cross entropy in float32 (float64 stays float64):
    the log-sum-exp with its max detached, and the label logit from a masked
    sum over the vocab (the reference's sharding-aware form).  A label
    outside [0, V) gets a logit of 0 there and does not fail, where
    ``gather`` would raise.  ``mask`` weights the tokens, divided by
    ``max(sum(mask), 1)``.  Logits split over the vocabulary (a DTensor)
    take ``_vocab_parallel_ll``: no rank gathers the logits."""
    if hasattr(logits, "device_mesh") and _vocab_split(logits):
        ll = _vocab_parallel_ll(logits, labels)
    else:
        logits = at_least_f32(logits)
        m = logits.amax(dim=-1, keepdim=True).detach()
        lse = torch.log(torch.exp(logits - m).sum(dim=-1)) + m[..., 0]
        vocab = torch.arange(logits.shape[-1], device=logits.device)
        label_logit = torch.where(vocab == labels[..., None], logits, 0.0).sum(dim=-1)
        ll = label_logit - lse
    if mask is None:
        return -ll.mean()
    mask = mask.to(ll.dtype)
    return -(ll * mask).sum() / mask.sum().clamp_min(1.0)


class _VocabParallelLL(torch.autograd.Function):
    """Each token's log-likelihood from this rank's slice of the vocabulary
    (local logits (..., V/n), the slice starting at ``lo``) and the ranks'
    sums over ``groups`` (the vocabulary split): the max, the sum of
    exponentials and the label's logit each all-reduced.  The gradient is
    the local slice of ``onehot(label) - softmax``, exact, with no collective
    (the ranks' token gradients are their own slices)."""

    @staticmethod
    def forward(ctx, logits, labels, lo, groups):
        import torch.distributed as dist

        x = at_least_f32(logits)
        m = x.amax(dim=-1, keepdim=True)
        for g in groups:
            dist.all_reduce(m, op=dist.ReduceOp.MAX, group=g)
        e = torch.exp(x - m)
        total = e.sum(dim=-1, keepdim=True)
        idx = labels.long() - lo
        ok = (idx >= 0) & (idx < x.shape[-1])
        pick = torch.where(ok, x.gather(-1, torch.where(ok, idx, 0)[..., None])[..., 0], 0.0)
        for g in groups:
            dist.all_reduce(total, group=g)
            dist.all_reduce(pick, group=g)
        lse = torch.log(total) + m
        ctx.save_for_backward(e, total, idx, ok)
        ctx.dtype = logits.dtype
        return pick - lse[..., 0]

    @staticmethod
    def backward(ctx, grad):
        e, total, idx, ok = ctx.saved_tensors
        g = -(e / total)
        g.scatter_add_(-1, torch.where(ok, idx, 0)[..., None], ok.to(g.dtype)[..., None])
        return (g * grad[..., None]).to(ctx.dtype), None, None, None


def _vocab_split(logits) -> list:
    """The mesh dims of more than one rank that split DTensor ``logits``'
    vocabulary (its last dim)."""
    last = logits.ndim - 1
    return [i for i, p in enumerate(logits.placements)
            if getattr(p, "dim", None) in (-1, last) and logits.device_mesh.size(i) > 1]


def _vocab_parallel_ll(logits: torch.Tensor, labels: torch.Tensor) -> torch.Tensor:
    """Each token's log-likelihood of DTensor ``logits`` split over the
    vocabulary (and over the batch as ``labels``), under ``local_map`` with
    explicit collectives (Megatron's vocabulary-parallel cross entropy).
    DTensor's own propagation through the reductions gives wrong gradients
    on torch 2.11 when the vocabulary is split; this form needs none."""
    import math

    from torch.distributed.tensor import DTensor, Replicate
    from torch.distributed.tensor.experimental import local_map

    dm = logits.device_mesh
    split = _vocab_split(logits)
    lo = 0
    for i in split:
        lo = lo * dm.size(i) + dm.get_local_rank(i)
    lo *= logits.shape[-1] // math.prod(dm.size(i) for i in split)
    pl = tuple(logits.placements)
    last = logits.ndim - 1
    tok_pl = tuple(Replicate() if getattr(p, "dim", None) in (-1, last) else p for p in pl)
    if not isinstance(labels, DTensor):
        labels = DTensor.from_local(labels, dm, [Replicate()] * dm.ndim, run_check=False)
    groups = [dm.get_group(i) for i in split]
    return local_map(lambda x, y: _VocabParallelLL.apply(x, y, lo, groups),
                     out_placements=(tok_pl,), in_placements=(pl, tok_pl),
                     in_grad_placements=(pl, tok_pl), device_mesh=dm)(
        logits, labels.redistribute(dm, tok_pl))
