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
    sum over the vocab (the reference's sharding-aware form: on logits
    split over the vocabulary, a DTensor, the max and the sums reduce over
    that split and no rank gathers the logits).  A label outside [0, V)
    gets a logit of 0 there and does not fail, where ``gather`` would
    raise.  ``mask``
    weights the tokens, divided by ``max(sum(mask), 1)``."""
    logits = at_least_f32(logits)
    m = logits.amax(dim=-1, keepdim=True).detach()
    lse = torch.log(torch.exp(logits - m).sum(dim=-1)) + m[..., 0]
    vocab = torch.arange(logits.shape[-1], device=logits.device)
    if hasattr(logits, "device_mesh"):
        # a DTensor: the iota split over the vocabulary as the logits are,
        # so that no rank compares its labels with the whole vocabulary
        from torch.distributed.tensor import Replicate, Shard, distribute_tensor

        vocab = distribute_tensor(
            vocab, logits.device_mesh,
            [Shard(0) if p == Shard(logits.ndim - 1) else Replicate() for p in logits.placements],
            src_data_rank=None)
    label_logit = torch.where(vocab == labels[..., None], logits, 0.0).sum(dim=-1)
    ll = label_logit - lse
    if mask is None:
        return -ll.mean()
    mask = mask.to(ll.dtype)
    return -(ll * mask).sum() / mask.sum().clamp_min(1.0)
