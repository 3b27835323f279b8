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
    require_cuda,
    stream_ptr,
)
from repro_torch.kernels.segment_spmm.ref import segment_spmm_ref

_ARGTYPES = [ctypes.c_void_p] * 4 + [ctypes.c_longlong, ctypes.c_int,
                                     ctypes.c_longlong, ctypes.c_int,
                                     ctypes.c_void_p]


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
