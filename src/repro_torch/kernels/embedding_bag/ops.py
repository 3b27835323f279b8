"""Public wrapper of the embedding-bag kernel (``csrc/embedding_bag.cu``).

CPU tensors run the plain version (``ref.py``); CUDA tensors launch the
kernel or raise.
"""

from __future__ import annotations

import ctypes

import torch

from repro_torch.kernels.embedding_bag.ref import MODES, embedding_bag_ref
from repro_torch.kernels.runtime import (check_launch, load_kernel, refuse_grad, require_cuda,
                                         stream_ptr)

_ARGTYPES = [ctypes.c_void_p] * 3 + [ctypes.c_int, ctypes.c_int, ctypes.c_longlong,
                                     ctypes.c_int, ctypes.c_longlong, ctypes.c_int,
                                     ctypes.c_int, ctypes.c_void_p]
_WARPS = 8  # bags per block (kWarps)


def embedding_bag(table: torch.Tensor, indices: torch.Tensor, mode: str = "sum") -> torch.Tensor:
    """(V, D) table x (B, L) ids -> (B, D) bags by ``mode`` ("sum", "mean"
    or "max"), accumulated in float32, out in the table's dtype.  Ids
    follow ``jnp.take``'s default mode: [-V, 0) wraps, anything else out
    of range makes its bag NaN.  Takes float32 or bfloat16 tables and int32
    or int64 ids."""
    refuse_grad("embedding_bag", table, indices)
    if mode not in MODES:
        raise ValueError(f"embedding_bag: mode must be one of {MODES}, got {mode!r}")
    if table.dim() != 2 or indices.dim() != 2:
        raise ValueError(f"embedding_bag: table must be (V, D) and indices (B, L), got "
                         f"{tuple(table.shape)} and {tuple(indices.shape)}")
    if table.dtype not in (torch.float32, torch.bfloat16):
        raise ValueError(f"embedding_bag: the table must be float32 or bfloat16, got {table.dtype}")
    if indices.dtype not in (torch.int32, torch.int64):
        raise ValueError(f"embedding_bag: ids must be int32 or int64, got {indices.dtype}")
    (V, D), (B, L) = table.shape, indices.shape
    if mode == "max" and L == 0:
        raise ValueError("embedding_bag: max of an empty bag (L = 0) is a zero-size reduction")
    if table.device.type == "cpu" and indices.device.type == "cpu":
        return embedding_bag_ref(table, indices, mode)
    dev = require_cuda("embedding_bag", table, indices)
    if not (table.is_contiguous() and indices.is_contiguous()):
        raise ValueError("embedding_bag: table and indices must be contiguous")
    if D < 1 or D >= 2**31 or L >= 2**31 or -(-B // _WARPS) >= 2**31:
        raise ValueError(f"embedding_bag: takes 1 <= D < 2^31, L < 2^31 and B < "
                         f"{_WARPS} * 2^31; got D={D}, B={B}, L={L}")
    out = torch.empty((B, D), dtype=table.dtype, device=dev)
    if B > 0:
        fn = load_kernel("embedding_bag", "embedding_bag_launch", _ARGTYPES)
        rc = fn(table.data_ptr(), indices.data_ptr(), out.data_ptr(),
                int(table.dtype == torch.bfloat16), int(indices.dtype == torch.int64), V, D, B,
                L, MODES.index(mode), stream_ptr())
        check_launch("embedding_bag", rc)
        embedding_bag.launches += 1
    return out


embedding_bag.launches = 0
