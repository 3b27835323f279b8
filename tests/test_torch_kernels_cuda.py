"""The CUDA kernels against their plain versions on the card.  These tests
import neither jax nor the reference, so they run on the machine with the
card; without one they skip.  Min, compaction and gather are exact; the sum
is float32 atomics in another order, ``rtol=atol=1e-4``.  Attention sums
in another order than its dense plain version: float32 within ``2e-5``,
bfloat16 within ``2e-2`` (one rounding of the output)."""

import importlib

import numpy as np
import pytest
import torch

from repro_torch.kernels import runtime
from repro_torch.kernels.flash_attention.ops import flash_attention
from repro_torch.kernels.flash_attention.ref import flash_attention_ref
from repro_torch.kernels.frontier_compact.ops import frontier_compact
from repro_torch.kernels.frontier_compact.ref import frontier_compact_ref
from repro_torch.kernels.hyb_gather.ops import hyb_gather
from repro_torch.kernels.hyb_gather.ref import hyb_gather_ref
from repro_torch.kernels.segment_spmm.ops import segment_spmm
from repro_torch.kernels.segment_spmm.ref import segment_spmm_ref


def _spmm_inputs(m, d, n, seed, with_inf=False):
    rng = np.random.default_rng(seed)
    msg = rng.standard_normal((m, d)).astype(np.float32)
    if with_inf:
        msg[rng.random((m, d)) < 0.1] = np.inf
        msg[rng.random((m, d)) < 0.05] = -np.inf
    seg = rng.integers(0, n, m).astype(np.int32)
    valid = rng.random(m) < 0.8
    return msg, seg, valid


def _cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the kernels run only on the card)")
    return torch.device("cuda")


@pytest.mark.cuda
@pytest.mark.parametrize("combine", ["min", "sum"])
def test_segment_spmm_kernel_vs_plain_on_card(combine):
    dev = _cuda()
    msg, seg, valid = _spmm_inputs(50_000, 2, 9_000, seed=1, with_inf=combine == "min")
    args = (torch.from_numpy(msg).to(dev), torch.from_numpy(seg).to(dev), 9_100,
            torch.from_numpy(valid).to(dev), combine)
    before = segment_spmm.launches
    got = segment_spmm(*args)
    assert segment_spmm.launches == before + 1
    want = segment_spmm_ref(*args)
    if combine == "min":
        assert torch.equal(got, want)
    else:
        torch.testing.assert_close(got, want, rtol=1e-4, atol=1e-4)


@pytest.mark.cuda
@pytest.mark.parametrize("density", [0.0, 0.3, 1.0])
def test_frontier_compact_kernel_vs_plain_on_card(density):
    dev = _cuda()
    rng = np.random.default_rng(2)
    vals = torch.from_numpy(rng.integers(-2**31, 2**31, (70_001, 3)).astype(np.int32)).to(dev)
    mask = torch.from_numpy(rng.random(70_001) < density).to(dev)
    cols = (vals[:, 0].contiguous(), vals[:, 1].float().contiguous(), vals[:, 2].contiguous(),
            mask)
    before = frontier_compact.launches
    got, cnt = frontier_compact(cols, mask)
    assert frontier_compact.launches == before + 1
    want, wcnt = frontier_compact_ref(cols, mask)
    assert int(cnt) == int(wcnt)
    assert all(torch.equal(g, w) for g, w in zip(got, want))


@pytest.mark.cuda
def test_hyb_gather_kernel_vs_plain_on_card():
    dev = _cuda()
    rng = np.random.default_rng(3)
    edges = torch.from_numpy(rng.integers(0, 1000, (20_000, 3)).astype(np.int32)).to(dev)
    cols = (edges[:, 0].contiguous(), edges[:, 1].contiguous(),
            edges[:, 2].float().contiguous(), edges[:, 0] % 3 == 0)
    starts = torch.from_numpy(rng.integers(-10, 20_100, 3_000).astype(np.int32)).to(dev)
    degs = torch.from_numpy(rng.integers(0, 300, 3_000).astype(np.int32)).to(dev)
    before = hyb_gather.launches
    got = hyb_gather(cols, starts, degs)
    assert hyb_gather.launches == before + 1
    assert all(torch.equal(g, w) for g, w in zip(got, hyb_gather_ref(cols, starts, degs)))


@pytest.mark.cuda
def test_kernel_libraries_load():
    _cuda()
    for stem in ("segment_spmm", "frontier_compact", "hyb_gather", "flash_attention"):
        ops = importlib.import_module(f"repro_torch.kernels.{stem}.ops")
        assert runtime.load_kernel(stem, f"{stem}_launch", ops._ARGTYPES) is not None


@pytest.mark.cuda
@pytest.mark.parametrize("S,L,dh,window,causal,kv_groups", [
    (2048, 2048, 256, 1024, True, 2), (257, 257, 256, 0, True, 2), (300, 300, 128, 64, True, 1),
    (200, 200, 64, 1, True, 1), (90, 333, 32, 0, False, 2), (70, 70, 16, 5, True, 4),
    (1, 1, 256, 0, True, 1)])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_flash_attention_kernel_vs_plain_on_card(S, L, dh, window, causal, kv_groups, dtype):
    dev = _cuda()
    rng = np.random.default_rng(S + dh)
    bh = 4 * kv_groups
    q, k, v = (torch.from_numpy(rng.standard_normal(shape).astype(np.float32)).to(dev, dtype)
               for shape in ((bh, S, dh), (bh // kv_groups, L, dh), (bh // kv_groups, L, dh)))
    before = flash_attention.launches
    got = flash_attention(q, k, v, window=window, causal=causal, kv_groups=kv_groups)
    assert flash_attention.launches == before + 1
    torch.cuda.synchronize()
    want = flash_attention_ref(q, k, v, 1.0 / dh**0.5, window, causal, kv_groups)
    tol = 2e-5 if dtype == torch.float32 else 2e-2
    torch.testing.assert_close(got.float(), want.float(), rtol=tol, atol=tol)


@pytest.mark.cuda
def test_flash_attention_kernel_rejects_strided_inputs():
    dev = _cuda()
    q = torch.zeros(4, 16, 64, device=dev).transpose(0, 1)
    with pytest.raises(ValueError, match="contiguous"):
        flash_attention(q, q, q)
