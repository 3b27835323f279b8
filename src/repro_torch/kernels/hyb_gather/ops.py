"""Public wrapper of the window-gather kernel (``csrc/hyb_gather.cu``).

CPU tensors run the plain version (``ref.py``); CUDA tensors launch the
kernel or raise.
"""

from __future__ import annotations

import ctypes
from collections.abc import Sequence

import torch

from repro_torch.kernels.hyb_gather.ref import PAD, hyb_gather_ref
from repro_torch.kernels.runtime import (
    check_launch,
    column_args,
    load_kernel,
    refuse_grad,
    pointer_array,
    require_cuda,
    stream_ptr,
)

_ARGTYPES = [ctypes.c_void_p] * 3 + [ctypes.c_int] + [ctypes.c_void_p] * 2 \
    + [ctypes.c_longlong, ctypes.c_longlong, ctypes.c_void_p]


def hyb_gather(columns: Sequence[torch.Tensor], seg_start: torch.Tensor,
               degree: torch.Tensor) -> tuple[torch.Tensor, ...]:
    """Gather each request's PAD-row window of every column (1-D, ``m``
    rows each) — the zero-copy engine's fine-grained fetch.  Returns one
    (a, PAD) tensor per column; lanes past the request's degree, and rows
    outside the columns, are 0."""
    refuse_grad("hyb_gather", columns)
    if seg_start.device.type == "cpu":
        return hyb_gather_ref(columns, seg_start, degree)
    dev = require_cuda("hyb_gather", seg_start, degree, *columns)
    a = seg_start.shape[0]
    if seg_start.dtype != torch.int32 or degree.dtype != torch.int32 \
            or seg_start.shape != (a,) or degree.shape != (a,):
        raise ValueError("hyb_gather: seg_start and degree must be (a,) int32")
    if not (seg_start.is_contiguous() and degree.is_contiguous()):
        raise ValueError("hyb_gather: seg_start and degree must be contiguous")
    m = columns[0].shape[0] if columns else 0
    ins, sizes = column_args("hyb_gather", columns, m)
    outs = tuple(torch.empty((a, PAD), dtype=col.dtype, device=dev) for col in columns)
    if a > 0:
        fn = load_kernel("hyb_gather", "hyb_gather_launch", _ARGTYPES)
        rc = fn(ins, pointer_array(outs), sizes, len(columns), seg_start.data_ptr(),
                degree.data_ptr(), m, a, stream_ptr())
        check_launch("hyb_gather", rc)
        hyb_gather.launches += 1
    return outs


hyb_gather.launches = 0
