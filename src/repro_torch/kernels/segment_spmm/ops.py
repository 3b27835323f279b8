"""Public wrapper of the segment-SpMM kernel (``csrc/segment_spmm.cu``).

CPU tensors run the plain version (``ref.py``); CUDA tensors launch the
kernel or raise.
"""

from __future__ import annotations

import ctypes

import torch

from repro_torch.kernels.runtime import (
    check_launch,
    load_kernel,
    refuse_grad,
    require_cuda,
    stream_ptr,
)
from repro_torch.kernels.segment_spmm.ref import segment_spmm_lanes_ref, segment_spmm_ref

_ARGTYPES = [ctypes.c_void_p] * 4 + [ctypes.c_longlong, ctypes.c_int,
                                     ctypes.c_longlong, ctypes.c_int,
                                     ctypes.c_void_p]
_LANES_ARGTYPES = [ctypes.c_void_p, ctypes.c_void_p, ctypes.POINTER(ctypes.c_longlong),
                   ctypes.c_int, ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong, ctypes.c_int,
                   ctypes.c_void_p, ctypes.c_void_p]


def segment_spmm(
    messages: torch.Tensor,
    seg_ids: torch.Tensor,
    n_segments: int,
    valid: torch.Tensor | None = None,
    combine: str = "sum",
) -> torch.Tensor:
    """Segment-combine (m, d) messages into (n_segments, d) — the FILTER
    engine's destination combine.  ``combine`` is ``"sum"`` or ``"min"``;
    segments receiving no valid message hold the identity (0 / +inf).
    1-D messages give a 1-D result."""
    refuse_grad("segment_spmm", messages, valid)
    if combine not in ("sum", "min"):
        raise ValueError(f"combine must be 'sum' or 'min', got {combine!r}")
    squeeze = messages.dim() == 1
    if messages.device.type == "cpu":
        if squeeze:
            return segment_spmm_ref(messages[:, None], seg_ids, n_segments, valid, combine)[:, 0]
        return segment_spmm_ref(messages, seg_ids, n_segments, valid, combine)
    if valid is None:
        dev = require_cuda("segment_spmm", messages, seg_ids)
    else:
        dev = require_cuda("segment_spmm", messages, seg_ids, valid)
        if valid.shape != seg_ids.shape or valid.dtype != torch.bool \
                or not valid.is_contiguous():
            raise ValueError("segment_spmm: valid must be (m,) contiguous bool")
    m, d = (messages.shape[0], 1) if squeeze else messages.shape
    if messages.dtype != torch.float32 or seg_ids.dtype != torch.int32:
        raise ValueError("segment_spmm: messages must be float32, seg_ids int32")
    if seg_ids.shape != (m,):
        raise ValueError("segment_spmm: seg_ids must be (m,)")
    if not (messages.is_contiguous() and seg_ids.is_contiguous()):
        raise ValueError("segment_spmm: tensors must be contiguous")
    # 1-D messages give a 1-D result: the same (n_segments, 1) layout
    out = torch.empty((n_segments,) if squeeze else (n_segments, d), dtype=torch.float32,
                      device=dev)
    fn = load_kernel("segment_spmm", "segment_spmm_launch", _ARGTYPES)
    rc = fn(messages.data_ptr(), seg_ids.data_ptr(),
            None if valid is None else valid.data_ptr(), out.data_ptr(),
            m, d, n_segments, combine == "min", stream_ptr())
    check_launch("segment_spmm", rc)
    segment_spmm.launches += 1
    return out


segment_spmm.launches = 0


def segment_spmm_lanes(
    messages: torch.Tensor,
    seg_ids: torch.Tensor,
    offsets: torch.Tensor,
    n_segments: int,
    combine: str = "sum",
    lengths=None,
) -> torch.Tensor:
    """The lane-batched combine of graph serving: L lanes' (m_l, d)
    messages packed lane after lane (lane l's rows ``offsets[l] :
    offsets[l+1]``; ``offsets`` is (L+1,) int64 from 0 to M), lane l into
    row l of an (L, n_segments[, d]) result, each row as ``segment_spmm``
    gives it for its lane alone.  ``lengths``: the lanes' row counts as
    host ints (``offsets``' differences), which plan the launch on the host;
    without them the wrapper reads ``offsets`` back, one host sync.  One
    launch for up to 128 lanes."""
    refuse_grad("segment_spmm_lanes", messages)
    if combine not in ("sum", "min"):
        raise ValueError(f"combine must be 'sum' or 'min', got {combine!r}")
    if messages.device.type == "cpu":
        return segment_spmm_lanes_ref(messages, seg_ids, offsets, n_segments, combine, lengths)
    dev = require_cuda("segment_spmm_lanes", messages, seg_ids, offsets)
    squeeze = messages.dim() == 1
    m, d = (messages.shape[0], 1) if squeeze else messages.shape
    n_lanes = offsets.shape[0] - 1
    if messages.dtype != torch.float32 or seg_ids.dtype != torch.int32 \
            or offsets.dtype != torch.int64:
        raise ValueError("segment_spmm_lanes: messages float32, seg_ids int32, offsets int64")
    if seg_ids.shape != (m,) or offsets.dim() != 1 or n_lanes < 1:
        raise ValueError("segment_spmm_lanes: seg_ids must be (m,), offsets (L+1,) with L >= 1")
    if not (messages.is_contiguous() and seg_ids.is_contiguous() and offsets.is_contiguous()):
        raise ValueError("segment_spmm_lanes: tensors must be contiguous")
    lengths = torch.diff(offsets).tolist() if lengths is None else [int(c) for c in lengths]
    if len(lengths) != n_lanes or sum(lengths) != m or min(lengths) < 0:
        raise ValueError("segment_spmm_lanes: lengths must be L counts >= 0 that sum to m")
    shape = (n_lanes, n_segments) if squeeze else (n_lanes, n_segments, d)
    out = torch.empty(shape, dtype=torch.float32, device=dev)
    scratch = torch.empty(2 * n_lanes, dtype=torch.int32, device=dev)
    fn = load_kernel("segment_spmm", "segment_spmm_lanes_launch", _LANES_ARGTYPES)
    rc = fn(messages.data_ptr(), seg_ids.data_ptr(), (ctypes.c_longlong * n_lanes)(*lengths),
            n_lanes, out.data_ptr(), d, n_segments, combine == "min", scratch.data_ptr(),
            stream_ptr())
    check_launch("segment_spmm_lanes", rc)
    segment_spmm_lanes.launches += 1
    return out


segment_spmm_lanes.launches = 0
