"""Public wrapper of the stream-compaction kernel
(``csrc/frontier_compact.cu``).

CPU tensors run the plain version (``ref.py``); CUDA tensors launch the
kernel or raise.
"""

from __future__ import annotations

import ctypes
from collections.abc import Sequence

import torch

from repro_torch.kernels.frontier_compact.ref import (
    frontier_compact_lanes_ref,
    frontier_compact_ref,
)
from repro_torch.kernels.runtime import (
    check_launch,
    column_args,
    load_kernel,
    refuse_grad,
    pointer_array,
    require_cuda,
    stream_ptr,
)

TILE = 2048  # rows per block of the count and scatter kernels (kTile)
_ARGTYPES = [ctypes.c_void_p] * 3 + [ctypes.c_int] + [ctypes.c_void_p] * 3 \
    + [ctypes.c_longlong, ctypes.c_void_p]
_LANES_ARGTYPES = [ctypes.c_void_p] * 3 + [ctypes.c_int] + [ctypes.c_void_p] * 2 \
    + [ctypes.c_int] + [ctypes.c_void_p] * 2 + [ctypes.c_longlong, ctypes.c_void_p]


def frontier_compact(columns: Sequence[torch.Tensor], mask: torch.Tensor):
    """Stable partition of the rows of ``columns`` (1-D, ``m`` rows each)
    by ``mask``: rows where it is set first, then the others, each in their
    original order.  Returns (columns, count): count is an int32 0-dim
    tensor on the same device, the number of rows kept."""
    refuse_grad("frontier_compact", columns, mask)
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


def frontier_compact_lanes(columns: Sequence[torch.Tensor], mask: torch.Tensor,
                           offsets: torch.Tensor):
    """The lane-batched compaction of graph serving: the rows hold L lanes'
    blocks packed lane after lane (lane l's rows ``offsets[l] :
    offsets[l+1]``; ``offsets`` is (L+1,) int64 from 0 to m), and each
    lane's rows are partitioned by its own mask in place of themselves, as
    ``frontier_compact`` partitions one block.  Returns (columns, counts):
    counts is (L,) int32 on the same device, each lane's kept rows.  One
    launch pair for all lanes."""
    refuse_grad("frontier_compact_lanes", columns, mask)
    if mask.device.type == "cpu":
        return frontier_compact_lanes_ref(columns, mask, offsets)
    dev = require_cuda("frontier_compact_lanes", mask, offsets, *columns)
    m = mask.shape[0]
    n_lanes = offsets.shape[0] - 1
    if mask.dtype != torch.bool or mask.dim() != 1 or not mask.is_contiguous():
        raise ValueError("frontier_compact_lanes: mask must be (m,) contiguous bool")
    if offsets.dtype != torch.int64 or offsets.dim() != 1 or n_lanes < 1 \
            or not offsets.is_contiguous():
        raise ValueError("frontier_compact_lanes: offsets must be (L+1,) contiguous int64, L >= 1")
    if m >= 2**31:
        raise ValueError("frontier_compact_lanes: counts are int32, m must be < 2**31")
    ins, sizes = column_args("frontier_compact_lanes", columns, m)
    outs = tuple(torch.empty_like(col) for col in columns)
    if m == 0:
        return outs, torch.zeros(n_lanes, dtype=torch.int32, device=dev)
    # one allocation: the tile counts (a lane's last tile may be partial),
    # then the lanes' counts the scatter writes
    n_tiles = -(-m // TILE) + n_lanes
    scratch = torch.empty(n_tiles + n_lanes, dtype=torch.int32, device=dev)
    fn = load_kernel("frontier_compact", "frontier_compact_lanes_launch", _LANES_ARGTYPES)
    rc = fn(ins, pointer_array(outs), sizes, len(columns), mask.data_ptr(), offsets.data_ptr(),
            n_lanes, scratch.data_ptr() + 4 * n_tiles, scratch.data_ptr(), m, stream_ptr())
    check_launch("frontier_compact_lanes", rc)
    frontier_compact_lanes.launches += 1
    return outs, scratch[n_tiles:]


frontier_compact_lanes.launches = 0
