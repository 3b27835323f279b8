"""The kernel loader's build directory: its name hashes the flags, every
kernel source and every header under ``kernels``, so a change to a shared
header (``kernels/common/csrc/hopper.cuh``) rebuilds the kernels that
include it.  CPU only: nothing is compiled."""

import shutil

from repro_torch.kernels import runtime


def _copy_kernels(tmp_path):
    root = tmp_path / "kernels"
    shutil.copytree(runtime.KERNELS_DIR, root,
                    ignore=shutil.ignore_patterns("__pycache__", "*.py"))
    return root


def test_build_dir_hashes_the_shared_header(tmp_path, monkeypatch):
    root = _copy_kernels(tmp_path)
    monkeypatch.setattr(runtime, "KERNELS_DIR", root)
    header = root / "common" / "csrc" / "hopper.cuh"
    assert header in runtime.kernel_headers()
    assert header not in runtime.kernel_sources()     # never compiled alone
    before = runtime.build_dir()
    assert runtime.build_dir() == before               # the same bytes, the same name
    header.write_bytes(header.read_bytes() + b"\n// changed\n")
    after = runtime.build_dir()
    assert after != before and after.parent == before.parent


def test_build_dir_hashes_sources_and_flags(tmp_path, monkeypatch):
    root = _copy_kernels(tmp_path)
    monkeypatch.setattr(runtime, "KERNELS_DIR", root)
    before = runtime.build_dir()
    src = root / "flash_attention" / "csrc" / "flash_attention.cu"
    src.write_bytes(src.read_bytes() + b"\n")
    after_src = runtime.build_dir()
    assert after_src != before
    monkeypatch.setattr(runtime, "NVCC_FLAGS", runtime.NVCC_FLAGS + ("-lineinfo",))
    assert runtime.build_dir() != after_src
