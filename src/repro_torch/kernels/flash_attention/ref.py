"""Plain PyTorch version of the fused attention kernel: dense masked
softmax in float32."""

from __future__ import annotations

import torch


def flash_attention_ref(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, scale: float,
                        window: int = 0, causal: bool = True,
                        kv_groups: int = 1) -> torch.Tensor:
    """q (BH, S, dh), k (BH / kv_groups, L, dh) and v (BH / kv_groups, L,
    dv) -> (BH, S, dv) in q's dtype; query head ``bh`` reads key/value head
    ``bh // kv_groups``."""
    if kv_groups > 1:   # head bh reads bh // kv_groups
        k = k.repeat_interleave(kv_groups, dim=0)
        v = v.repeat_interleave(kv_groups, dim=0)
    s = torch.matmul(q.float(), k.float().transpose(1, 2)) * scale
    S, L = s.shape[1], s.shape[2]
    qp = torch.arange(S, device=q.device)[:, None]
    kp = torch.arange(L, device=q.device)[None, :]
    mask = torch.ones((S, L), dtype=torch.bool, device=q.device)
    if causal:
        mask &= qp >= kp
    if window > 0:
        mask &= qp - kp < window
    s = s.masked_fill(~mask, float("-inf"))
    p = torch.exp(s - s.amax(dim=-1, keepdim=True))
    p = torch.where(mask, p, 0.0)          # a row with no key: nan -> 0
    p = p / p.sum(dim=-1, keepdim=True).clamp_min(1e-30)
    return torch.matmul(p, v.float()).to(q.dtype)
