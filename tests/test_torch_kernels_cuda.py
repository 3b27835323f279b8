"""The CUDA kernels against their plain versions on the card.  These tests
import neither jax nor the reference, so they run on the machine with the
card; without one they skip.  Min, compaction and gather are exact; the sum
is float32 atomics in another order, ``rtol=atol=1e-4``.  Attention sums
in another order than its dense plain version: float32 within ``2e-5``,
bfloat16 within ``2e-2`` (one rounding of the output).  An embedding bag
of one row, and every max, are exact; float32 sums and means of L rows
within ``rtol=1e-5, atol=1e-6 * L``, bfloat16 within one bfloat16 step
(``rtol=2^-7``); NaN bags (ids out of range) in the same places."""

import importlib

import numpy as np
import pytest
import torch

from repro_torch.kernels import runtime
from repro_torch.kernels.embedding_bag.ops import embedding_bag
from repro_torch.kernels.embedding_bag.ref import embedding_bag_ref
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
    for stem in ("segment_spmm", "frontier_compact", "hyb_gather", "flash_attention",
                 "embedding_bag"):
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


@pytest.mark.cuda
@pytest.mark.parametrize("V,D,B,L", [(4096, 128, 5000, 1), (1000, 128, 300, 100), (77, 13, 999, 3),
                                     (500, 130, 64, 4), (300, 1000, 17, 2), (10, 8, 0, 2)])
@pytest.mark.parametrize("mode", ["sum", "mean", "max"])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("id_dtype", [torch.int32, torch.int64])
def test_embedding_bag_kernel_vs_plain_on_card(V, D, B, L, mode, dtype, id_dtype):
    dev = _cuda()
    rng = np.random.default_rng(V + D + L)
    table = torch.from_numpy(rng.standard_normal((V, D)).astype(np.float32)).to(dev, dtype)
    # a few ids wrap (in [-V, 0)) or fall outside the table (NaN bags)
    ids = torch.from_numpy(rng.integers(-V // 8, V + V // 16, (B, L))).to(dev, id_dtype)
    before = embedding_bag.launches
    got = embedding_bag(table, ids, mode)
    assert embedding_bag.launches == before + (B > 0)
    torch.cuda.synchronize()
    want = embedding_bag_ref(table, ids, mode)
    assert got.shape == (B, D) and got.dtype == dtype
    assert torch.equal(torch.isnan(got), torch.isnan(want))
    if L == 1 or mode == "max":
        assert torch.equal(got.nan_to_num(), want.nan_to_num())
    elif dtype == torch.bfloat16:
        torch.testing.assert_close(got.float(), want.float(), rtol=2**-7, atol=1e-6,
                                   equal_nan=True)
    else:
        torch.testing.assert_close(got, want, rtol=1e-5, atol=1e-6 * L, equal_nan=True)


@pytest.mark.cuda
def test_embedding_bag_kernel_empty_bags_on_card():
    """L = 0: sums are 0 and means NaN (0 / 0), as the reference's."""
    dev = _cuda()
    table = torch.ones(10, 8, device=dev)
    ids = torch.zeros(5, 0, dtype=torch.int32, device=dev)
    assert torch.equal(embedding_bag(table, ids, "sum"), torch.zeros(5, 8, device=dev))
    assert bool(embedding_bag(table, ids, "mean").isnan().all())


@pytest.mark.cuda
def test_embedding_bag_kernel_reads_rows_past_2_to_the_31():
    """Row offsets are 64-bit: with D = 128, id * D passes 2^31 at row
    16,777,216; a table of 2^24 + 64 rows (8.6 GB) is read at its end."""
    dev = _cuda()
    V, D = 2**24 + 64, 128
    table = torch.empty((V, D), device=dev)
    table[-128:] = torch.arange(128 * D, device=dev, dtype=torch.float32).view(128, D)
    ids = torch.tensor([[V - 1], [V - 64], [2**24], [-1], [V - 2]], device=dev)
    got = embedding_bag(table, ids, "sum")
    torch.cuda.synchronize()
    assert torch.equal(got, embedding_bag_ref(table, ids, "sum"))
    assert torch.equal(got[0], table[-1]) and torch.equal(got[3], table[-1])
    del table


@pytest.mark.cuda
def test_embedding_bag_kernel_rejects_bad_inputs_on_card():
    dev = _cuda()
    table = torch.zeros(16, 8, device=dev)
    ids = torch.zeros(4, 3, dtype=torch.int32, device=dev)
    with pytest.raises(ValueError, match="contiguous"):
        embedding_bag(table, ids.t())
    with pytest.raises(ValueError, match="tensors on"):
        embedding_bag(table, ids.cpu())
    with pytest.raises(ValueError, match="empty bag"):
        embedding_bag(table, ids[:, :0], "max")
