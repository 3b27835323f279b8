"""Shared runtime policy of the port: device resolution, the ``use_kernels``
contract, and the loader that builds the hand-written CUDA kernels.

Devices.  Every entry point takes an explicit ``device``.  ``None`` means
``cuda``; with no card that raises — the port never carries on quietly on
the CPU.  Tests pass ``device="cpu"``.

``use_kernels`` (``HyTMConfig.use_kernels``), the reference's tri-state:

* ``"auto"`` — kernels on iff the tensors lie on a CUDA device;
* ``True``  — the kernel wrappers are called on either device (on CPU
  tensors a wrapper runs its plain version, so the engines' code around
  the kernels runs on the CPU too);
* ``False`` — the plain (oracle) engines on either device.

On a CUDA device a kernel that fails to build or launch raises.

Kernels.  Every ``kernels/<name>/csrc/*.cu`` exposes a plain C entry point
and is compiled on first use by ``nvcc`` into its own shared library (one
``nvcc`` per source, all started together), loaded with ``ctypes``.  The
bf16 matrix kernels share ``kernels/common/csrc/hopper.cuh`` (TMA,
mbarrier, wgmma).  The libraries go under
``<repo>/build/repro_torch/<hash of sources+headers+flags>/``,
a directory git ignores, so a fresh checkout builds its kernels itself.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import re
import shutil
import subprocess
from pathlib import Path

import torch

KERNELS_DIR = Path(__file__).resolve().parent
BUILD_ROOT = KERNELS_DIR.parents[2] / "build" / "repro_torch"
# -Xptxas=-v: ptxas reports each kernel's registers and spills, kept in
# lib<stem>.log beside the library (``ptxas_resources``)
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-shared", "-Xcompiler", "-fPIC", "-Xptxas=-v")

_LIBS: dict[str, ctypes.CDLL] = {}
_ENTRIES: dict[tuple[str, str], ctypes._CFuncPtr] = {}


def resolve_device(device: str | torch.device | None) -> torch.device:
    """``None`` -> ``cuda``; raises when the requested CUDA device is
    missing instead of falling back to the CPU."""
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "no CUDA device: pass device='cpu' to run the port on the CPU")
    return dev


def resolve_use_kernels(setting: bool | str, device: torch.device) -> bool:
    """Resolve ``HyTMConfig.use_kernels`` for tensors on ``device``."""
    if isinstance(setting, str):
        if setting != "auto":
            raise ValueError(
                f"use_kernels must be True, False, or 'auto', got {setting!r}")
        return torch.device(device).type == "cuda"
    return bool(setting)


def kernel_sources() -> list[Path]:
    return sorted(KERNELS_DIR.glob("*/csrc/*.cu"))


def _nvcc() -> str:
    nvcc = shutil.which("nvcc") or "/usr/local/cuda/bin/nvcc"
    if not os.path.exists(nvcc):
        raise RuntimeError("nvcc not found: the CUDA kernels cannot be built")
    return nvcc


def kernel_headers() -> list[Path]:
    """The headers the sources include (``kernels/common/csrc/hopper.cuh``
    and any other ``*.cuh`` under ``kernels``)."""
    return sorted(KERNELS_DIR.glob("**/*.cuh"))


def build_dir() -> Path:
    """``BUILD_ROOT/<hash>``: the hash covers the flags and every source and
    header, so a change to a shared header rebuilds the kernels that include
    it."""
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for src in kernel_sources() + kernel_headers():
        h.update(str(src.relative_to(KERNELS_DIR)).encode())
        h.update(src.read_bytes())
    return BUILD_ROOT / h.hexdigest()[:16]


def build_kernels() -> dict[str, Path]:
    """Compile every kernel source that has no library yet, all ``nvcc``
    processes at once; returns ``stem -> library path``."""
    out = build_dir()
    out.mkdir(parents=True, exist_ok=True)
    libs = {src.stem: out / f"lib{src.stem}.so" for src in kernel_sources()}
    todo = [src for src in kernel_sources() if not libs[src.stem].exists()]
    if not todo:
        return libs
    nvcc = _nvcc()
    procs = []
    for src in todo:
        tmp = out / f"lib{src.stem}.so.{os.getpid()}.tmp"
        cmd = [nvcc, *NVCC_FLAGS, "-o", str(tmp), str(src)]
        procs.append((src, tmp, subprocess.Popen(
            cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)))
    errors = []
    for src, tmp, proc in procs:
        log, _ = proc.communicate()
        if proc.returncode != 0:
            errors.append(f"{src.name}:\n{log}")
        else:
            libs[src.stem].with_suffix(".log").write_text(log)
            os.replace(tmp, libs[src.stem])
    if errors:
        raise RuntimeError("kernel build failed:\n" + "\n".join(errors))
    return libs


def ptxas_resources(stem: str) -> list[dict]:
    """Each kernel of ``csrc/<stem>.cu`` as ptxas reported it when it was
    built: mangled name, registers a thread, spill stores and loads (bytes)."""
    log = (build_dir() / f"lib{stem}.log").read_text()
    out = []
    for line in log.splitlines():
        if "Compiling entry function" in line:
            out.append({"name": line.split("'")[1]})
        elif out and (spills := re.search(r"(\d+) bytes spill stores, (\d+) bytes spill loads",
                                          line)):
            out[-1]["spill_stores"], out[-1]["spill_loads"] = map(int, spills.groups())
        elif out and (used := re.search(r"Used (\d+) registers", line)):
            out[-1]["registers"] = int(used.group(1))
    return out


def load_kernel(stem: str, entry: str, argtypes: list) -> ctypes._CFuncPtr:
    """The C entry point ``entry`` of ``csrc/<stem>.cu``, built on first
    use; it returns ``cudaGetLastError()`` as an int."""
    fn = _ENTRIES.get((stem, entry))
    if fn is None:
        lib = _LIBS.get(stem)
        if lib is None:
            lib = _LIBS[stem] = ctypes.CDLL(str(build_kernels()[stem]))
        fn = getattr(lib, entry)
        fn.argtypes = argtypes
        fn.restype = ctypes.c_int
        _ENTRIES[(stem, entry)] = fn
    return fn


def check_launch(name: str, rc: int) -> None:
    if rc != 0:
        raise RuntimeError(f"{name}: CUDA kernel launch failed (cudaError {rc})")


def refuse_grad(name: str, *inputs) -> None:
    """``RuntimeError`` when grad mode is on and an input of the kernel
    ``name`` (a tensor, or a sequence of them) requires grad.  No kernel of
    the port has a backward, as no Pallas kernel of the reference has one:
    its output would be cut from autograd and every gradient before it
    silently lost, so training takes the plain routes
    (``use_kernels=False``).  Checked before the device dispatch, so a CPU
    call refuses as a CUDA one does."""
    if not torch.is_grad_enabled():
        return
    for t in inputs:
        for u in (t if isinstance(t, (list, tuple)) else (t,)):
            if isinstance(u, torch.Tensor) and u.requires_grad:
                raise RuntimeError(
                    f"{name}: an input requires grad and the kernel has no backward; "
                    "train through the plain route (use_kernels=False) or call under "
                    "torch.no_grad()")


def require_cuda(name: str, *tensors: torch.Tensor) -> torch.device:
    """The device all ``tensors`` share; raises unless it is CUDA."""
    dev = tensors[0].device
    for t in tensors:
        if t.device != dev:
            raise ValueError(f"{name}: tensors on {dev} and {t.device}")
    if dev.type != "cuda":
        raise ValueError(f"{name}: no kernel for {dev.type} tensors")
    return dev


def stream_ptr() -> int:
    """The current CUDA stream of the current device, as an address (the
    raw accessor builds no ``torch.cuda.Stream`` object)."""
    return torch._C._cuda_getCurrentRawStream(torch.cuda.current_device())


MAX_COLUMNS = 4  # kMaxCols of the column kernels


def column_args(name: str, columns, m: int):
    """Check the separate 1-D columns that ``frontier_compact`` and
    ``hyb_gather`` move (4-byte words or 1-byte flags, ``m`` rows each,
    contiguous) and return their pointers and element sizes as ctypes
    arrays."""
    c = len(columns)
    if not 1 <= c <= MAX_COLUMNS:
        raise ValueError(f"{name}: takes 1 to {MAX_COLUMNS} columns, got {c}")
    ptrs, sizes = [], []
    for col in columns:
        size = col.element_size()
        if col.dim() != 1 or col.shape[0] != m or size not in (4, 1) \
                or not col.is_contiguous():
            raise ValueError(f"{name}: columns must be 1-D and contiguous, with {m} "
                             "rows of 4-byte words or 1-byte flags")
        ptrs.append(col.data_ptr())
        sizes.append(size)
    return (ctypes.c_void_p * c)(*ptrs), (ctypes.c_int * c)(*sizes)


def pointer_array(tensors) -> ctypes.Array:
    return (ctypes.c_void_p * len(tensors))(*(t.data_ptr() for t in tensors))
