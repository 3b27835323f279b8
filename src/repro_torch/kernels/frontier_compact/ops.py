"""Public wrapper of the stream-compaction kernel
(``csrc/frontier_compact.cu``).

CPU tensors run the plain version (``ref.py``); CUDA tensors launch the
kernel or raise.
"""

from __future__ import annotations

import ctypes
from collections.abc import Sequence

import torch

from repro_torch.kernels.frontier_compact.ref import frontier_compact_ref
from repro_torch.kernels.runtime import (
    check_launch,
    column_args,
    load_kernel,
    pointer_array,
    require_cuda,
    stream_ptr,
)

TILE = 2048  # rows per block of the count and scatter kernels (kTile)
_ARGTYPES = [ctypes.c_void_p] * 3 + [ctypes.c_int] + [ctypes.c_void_p] * 3 \
    + [ctypes.c_longlong, ctypes.c_void_p]


def frontier_compact(columns: Sequence[torch.Tensor], mask: torch.Tensor):
    """Stable partition of the rows of ``columns`` (1-D, ``m`` rows each)
    by ``mask``: rows where it is set first, then the others, each in their
    original order.  Returns (columns, count): count is an int32 0-dim
    tensor on the same device, the number of rows kept."""
    if mask.device.type == "cpu":
        return frontier_compact_ref(columns, mask)
    dev = require_cuda("frontier_compact", mask, *columns)
    m = mask.shape[0]
    if mask.dtype != torch.bool or mask.dim() != 1 or not mask.is_contiguous():
        raise ValueError("frontier_compact: mask must be (m,) contiguous bool")
    if m >= 2**31:
        raise ValueError("frontier_compact: the count is int32, m must be < 2**31")
    ins, sizes = column_args("frontier_compact", columns, m)
    outs = tuple(torch.empty_like(col) for col in columns)
    if m == 0:
        return outs, torch.zeros((), dtype=torch.int32, device=dev)
    # one allocation: the tile counts, then the count the scatter writes
    n_tiles = -(-m // TILE)
    scratch = torch.empty(n_tiles + 1, dtype=torch.int32, device=dev)
    fn = load_kernel("frontier_compact", "frontier_compact_launch", _ARGTYPES)
    rc = fn(ins, pointer_array(outs), sizes, len(columns), mask.data_ptr(),
            scratch.data_ptr() + 4 * n_tiles, scratch.data_ptr(), m, stream_ptr())
    check_launch("frontier_compact", rc)
    frontier_compact.launches += 1
    return outs, scratch[n_tiles]


frontier_compact.launches = 0
