"""Public wrapper of the fused attention kernel (``csrc/flash_attention.cu``).

CPU tensors run the plain version (``ref.py``); CUDA tensors launch the
kernel or raise.
"""

from __future__ import annotations

import ctypes

import torch

from repro_torch.kernels.flash_attention.ref import flash_attention_ref
from repro_torch.kernels.runtime import (check_launch, load_kernel, refuse_grad, require_cuda,
                                         stream_ptr)

_ARGTYPES = [ctypes.c_void_p] * 4 + [ctypes.c_int, ctypes.c_longlong, ctypes.c_longlong,
                                     ctypes.c_longlong, ctypes.c_int, ctypes.c_int,
                                     ctypes.c_int, ctypes.c_float, ctypes.c_int, ctypes.c_int,
                                     ctypes.c_void_p]
MAX_HEAD_DIM = 256
_TILE_Q = 64  # query rows per float32 block (the bf16 blocks take 128)
# (dh, dv) of the bf16 kernel's instantiations (FLASH_BF16_WIDTHS)
BF16_WIDTHS = ((64, 64), (128, 128), (192, 192), (192, 128), (256, 256))


def bf16_widths(dh: int, dv: int) -> tuple[int, int]:
    """The instantiated (dh, dv) that q and k of width ``dh`` and values of
    width ``dv`` are zero-padded to: the narrowest dh, then the narrowest dv
    it is instantiated with."""
    return min((w for w in BF16_WIDTHS if w[0] >= dh and w[1] >= dv),
               key=lambda w: (w[0], w[1]))


def _pad_last(t: torch.Tensor, width: int) -> torch.Tensor:
    return t if t.shape[-1] == width else torch.nn.functional.pad(t, (0, width - t.shape[-1]))


def flash_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                    scale: float | None = None, window: int = 0, causal: bool = True,
                    kv_groups: int = 1) -> torch.Tensor:
    """Fused attention (FlashAttention-2 forward) over q (BH, S, dh), k
    (BH / kv_groups, L, dh) and v (BH / kv_groups, L, dv), dv <= dh, with
    query head ``bh`` reading key/value head ``bh // kv_groups``.  Positions
    are ``arange(S)`` and ``arange(L)``; a pair is kept under ``causal`` (q
    >= k) and ``window`` (q - k < window, 0 = global).  float32 or bfloat16
    in, float32 scores and softmax, out (BH, S, dv) in q's dtype.  The bf16
    kernel rounds the probabilities to bf16 before P.V (the plain version
    keeps them in float32)."""
    refuse_grad("flash_attention", q, k, v)
    if scale is None:
        scale = 1.0 / (q.shape[-1] ** 0.5)
    if q.dim() != 3 or k.dim() != 3 or v.dim() != 3 or k.shape[:2] != v.shape[:2]:
        raise ValueError("flash_attention: q must be (BH, S, dh), k (BH / kv_groups, L, dh) "
                         "and v (BH / kv_groups, L, dv)")
    BH, S, dh = q.shape
    L, dv = k.shape[1], v.shape[2]
    if kv_groups < 1 or k.shape[0] * kv_groups != BH or k.shape[2] != dh:
        raise ValueError(f"flash_attention: q {tuple(q.shape)} and k {tuple(k.shape)} do not "
                         f"match kv_groups={kv_groups}")
    if not 1 <= dv <= dh:
        raise ValueError(f"flash_attention: values must be 1 to {dh} (the keys' width) wide, "
                         f"got {dv}")
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
    if not 1 <= dh <= MAX_HEAD_DIM or BH >= 2**31 or L >= 2**31 \
            or -(-S // _TILE_Q) >= 2**16:
        raise ValueError(f"flash_attention: takes 1 <= dh <= {MAX_HEAD_DIM}, BH, L < 2^31 and "
                         f"S < {_TILE_Q * 2**16}; got {tuple(q.shape)}, L={L}")
    if q.dtype == torch.bfloat16:
        # off the main path: widths the kernel is not instantiated for are
        # zero-padded (zero columns of q and k add nothing to a score, zero
        # columns of v come out zero and are cut off)
        dh_k, dv_k = bf16_widths(dh, dv)
        q, k = _pad_last(q, dh_k), _pad_last(k, dh_k)
    else:
        dh_k = dv_k = dh    # the float32 kernel takes values as wide as the keys
    v = _pad_last(v, dv_k)
    if q.dtype == torch.bfloat16 and any(t.data_ptr() % 16 for t in (q, k, v)):
        raise ValueError("flash_attention: the bf16 kernel's TMA loads need q, k and v to "
                         "start on 16-byte boundaries")
    # no keys: every row is 0, and a tensor map cannot describe an empty k
    out = (torch.empty if L > 0 else torch.zeros)((BH, S, dv_k), dtype=q.dtype, device=q.device)
    if BH > 0 and S > 0 and L > 0:
        fn = load_kernel("flash_attention", "flash_attention_launch", _ARGTYPES)
        rc = fn(q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
                int(q.dtype == torch.bfloat16), BH, S, L, dh_k, dv_k, kv_groups,
                float(scale), int(window), int(bool(causal)), stream_ptr())
        check_launch("flash_attention", rc)
        flash_attention.launches += 1
    return out if dv_k == dv else out[..., :dv].contiguous()


flash_attention.launches = 0
