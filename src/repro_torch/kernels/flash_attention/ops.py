"""Public wrapper of the fused attention kernel (``csrc/flash_attention.cu``).

CPU tensors run the plain version (``ref.py``); CUDA tensors launch the
kernel or raise.
"""

from __future__ import annotations

import ctypes

import torch

from repro_torch.kernels.flash_attention.ref import flash_attention_ref
from repro_torch.kernels.runtime import check_launch, load_kernel, require_cuda, stream_ptr

_ARGTYPES = [ctypes.c_void_p] * 4 + [ctypes.c_int, ctypes.c_longlong, ctypes.c_longlong,
                                     ctypes.c_longlong, ctypes.c_int, ctypes.c_int,
                                     ctypes.c_float, ctypes.c_int, ctypes.c_int,
                                     ctypes.c_void_p]
MAX_HEAD_DIM = 256
_TILE_Q = 64  # query rows per block (kTq)


def flash_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                    scale: float | None = None, window: int = 0, causal: bool = True,
                    kv_groups: int = 1) -> torch.Tensor:
    """Fused attention (FlashAttention-2 forward) over q (BH, S, dh) and k, v
    (BH / kv_groups, L, dh), with query head ``bh`` reading key/value head
    ``bh // kv_groups``.  Positions are ``arange(S)`` and ``arange(L)``; a
    pair is kept under ``causal`` (q >= k) and ``window`` (q - k < window,
    0 = global).  float32 or bfloat16 in, float32 scores and softmax, out
    in q's dtype."""
    if scale is None:
        scale = 1.0 / (q.shape[-1] ** 0.5)
    if q.dim() != 3 or k.dim() != 3 or k.shape != v.shape:
        raise ValueError("flash_attention: q must be (BH, S, dh), k and v (BH / kv_groups, L, dh)")
    BH, S, dh = q.shape
    if kv_groups < 1 or k.shape[0] * kv_groups != BH or k.shape[2] != dh:
        raise ValueError(f"flash_attention: q {tuple(q.shape)} and k {tuple(k.shape)} do not "
                         f"match kv_groups={kv_groups}")
    if q.dtype not in (torch.float32, torch.bfloat16) or k.dtype != q.dtype \
            or v.dtype != q.dtype:
        raise ValueError("flash_attention: q, k and v must all be float32 or all bfloat16")
    if window < 0:
        raise ValueError(f"flash_attention: window must be >= 0, got {window}")
    if q.device.type == "cpu":
        return flash_attention_ref(q, k, v, scale, window, causal, kv_groups)
    require_cuda("flash_attention", q, k, v)
    if not (q.is_contiguous() and k.is_contiguous() and v.is_contiguous()):
        raise ValueError("flash_attention: q, k and v must be contiguous")
    if not 1 <= dh <= MAX_HEAD_DIM or BH >= 2**31 or -(-S // _TILE_Q) >= 2**16:
        raise ValueError(f"flash_attention: takes 1 <= dh <= {MAX_HEAD_DIM}, BH < 2^31 and "
                         f"S < {_TILE_Q * 2**16}; got {tuple(q.shape)}")
    out = torch.empty_like(q)
    if BH > 0 and S > 0:
        fn = load_kernel("flash_attention", "flash_attention_launch", _ARGTYPES)
        rc = fn(q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
                int(q.dtype == torch.bfloat16), BH, S, k.shape[1], dh, kv_groups,
                float(scale), int(window), int(bool(causal)), stream_ptr())
        check_launch("flash_attention", rc)
        flash_attention.launches += 1
    return out


flash_attention.launches = 0
