"""Public wrapper of the grouped matmul kernel (``csrc/grouped_matmul.cu``).

CPU tensors run the plain version (``ref.py``); CUDA tensors launch the
kernel or raise.
"""

from __future__ import annotations

import ctypes

import torch

from repro_torch.kernels.grouped_matmul.ref import grouped_matmul_ref
from repro_torch.kernels.runtime import (check_launch, load_kernel, refuse_grad, require_cuda,
                                         stream_ptr)

_ARGTYPES = [ctypes.c_void_p] * 5 + [ctypes.c_int, ctypes.c_longlong, ctypes.c_int,
                                     ctypes.c_int, ctypes.c_int, ctypes.c_int,
                                     ctypes.c_void_p]
_TILE_ROWS = 64  # output rows of the smallest block (kTm, the decode tiles)


def grouped_matmul(x_sorted: torch.Tensor, weights: torch.Tensor, starts: torch.Tensor,
                   counts: torch.Tensor, max_rows: int | None = None) -> torch.Tensor:
    """Megablocks-style grouped product over expert-sorted rows: (T, D) x
    (E, D, F) -> (T, F).  Expert e owns rows [starts[e], starts[e] +
    min(counts[e], max_rows)); there the product is summed in float32 and
    cast once to x's dtype, and every other row is 0.  ``max_rows`` (default
    T) bounds the rows of a group and the launch's grid: the MoE dispatch
    passes its capacity.  Takes float32 or bfloat16 x and weights of one
    dtype, and int32 ``starts`` and ``counts`` of shape (E,)."""
    refuse_grad("grouped_matmul", x_sorted, weights)
    if x_sorted.dim() != 2 or weights.dim() != 3 or x_sorted.shape[1] != weights.shape[1]:
        raise ValueError(f"grouped_matmul: x must be (T, D) and weights (E, D, F), got "
                         f"{tuple(x_sorted.shape)} and {tuple(weights.shape)}")
    (T, D), (E, _, F) = x_sorted.shape, weights.shape
    if x_sorted.dtype not in (torch.float32, torch.bfloat16) or weights.dtype != x_sorted.dtype:
        raise ValueError(f"grouped_matmul: x and weights must both be float32 or both "
                         f"bfloat16, got {x_sorted.dtype} and {weights.dtype}")
    for name, t in (("starts", starts), ("counts", counts)):
        if t.dtype != torch.int32 or t.shape != (E,) or not t.is_contiguous():
            raise ValueError(f"grouped_matmul: {name} must be contiguous int32 of shape "
                             f"({E},), got {t.dtype} {tuple(t.shape)}")
    max_rows = T if max_rows is None else int(max_rows)
    if max_rows < 0:
        raise ValueError(f"grouped_matmul: max_rows must be >= 0, got {max_rows}")
    tensors = (x_sorted, weights, starts, counts)
    if all(t.device.type == "cpu" for t in tensors):
        return grouped_matmul_ref(x_sorted, weights, starts, counts, max_rows)
    dev = require_cuda("grouped_matmul", *tensors)
    if not (x_sorted.is_contiguous() and weights.is_contiguous()):
        raise ValueError("grouped_matmul: x and weights must be contiguous")
    if E >= 2**16 or -(-max_rows // _TILE_ROWS) >= 2**16 or T >= 2**31 or D >= 2**31 \
            or F >= 2**31:
        raise ValueError(f"grouped_matmul: takes E < 2^16, max_rows < {_TILE_ROWS * 2**16} "
                         f"and T, D, F < 2^31; got E={E}, max_rows={max_rows}, T={T}, D={D}, "
                         f"F={F}")
    bf16 = x_sorted.dtype == torch.bfloat16
    F_k = F
    if bf16 and (D % 8 or F % 8 or x_sorted.data_ptr() % 16 or weights.data_ptr() % 16):
        # off the main path: TMA takes 16-byte aligned rows and bases, so x
        # and w are zero-padded into copies (zero columns of D add nothing,
        # zero columns of F are cut off)
        D8, F_k = -(-D // 8) * 8, -(-F // 8) * 8
        xp, wp = x_sorted.new_zeros((T, D8)), weights.new_zeros((E, D8, F_k))
        xp[:, :D], wp[:, :D, :F] = x_sorted, weights
        x_sorted, weights, D = xp, wp, D8
    out = torch.zeros((T, F_k), dtype=x_sorted.dtype, device=dev)
    if T > 0 and D > 0 and F > 0 and E > 0 and max_rows > 0:
        fn = load_kernel("grouped_matmul", "grouped_matmul_launch", _ARGTYPES)
        rc = fn(x_sorted.data_ptr(), weights.data_ptr(), starts.data_ptr(), counts.data_ptr(),
                out.data_ptr(), int(bf16), T, D, F_k, E, max_rows, stream_ptr())
        check_launch("grouped_matmul", rc)
        grouped_matmul.launches += 1
    return out if F_k == F else out[:, :F].contiguous()


grouped_matmul.launches = 0
