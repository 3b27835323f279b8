"""The CUDA kernels against their plain versions on the card.  These tests
import neither jax nor the reference, so they run on the machine with the
card; without one they skip.  Min, compaction and gather are exact; the sum
is float32 atomics in another order, ``rtol=atol=1e-4``.  Attention sums
in another order than its dense plain version: float32 within ``2e-5``,
bfloat16 within ``2e-2`` (one rounding of the output, and the kernel's
bf16 probabilities against the plain version's float32).  An embedding bag
of one row, and every max, are exact; float32 sums and means of L rows
within ``rtol=1e-5, atol=1e-6 * L``, bfloat16 within one bfloat16 step
(``rtol=2^-7``); NaN bags (ids out of range) in the same places.  The
grouped matmul sums float32 products in another order than its plain
version: float32 within ``rtol=1e-5, atol=1e-5`` (no TF32 on either side),
bfloat16 within one bfloat16 rounding (``rtol=2^-7``)."""

import ctypes
import importlib

import numpy as np
import pytest
import torch

from repro_torch.kernels import runtime
from repro_torch.kernels.embedding_bag.ops import embedding_bag
from repro_torch.kernels.embedding_bag.ref import embedding_bag_ref
from repro_torch.kernels.flash_attention.ops import flash_attention
from repro_torch.kernels.flash_attention.ref import flash_attention_ref
from repro_torch.kernels.frontier_compact.ops import frontier_compact, frontier_compact_lanes
from repro_torch.kernels.frontier_compact.ref import frontier_compact_lanes_ref, frontier_compact_ref
from repro_torch.kernels.grouped_matmul.ops import grouped_matmul
from repro_torch.kernels.grouped_matmul.ref import grouped_matmul_ref
from repro_torch.kernels.hyb_gather.ops import hyb_gather
from repro_torch.kernels.hyb_gather.ref import hyb_gather_ref
from repro_torch.kernels.segment_spmm.ops import segment_spmm, segment_spmm_lanes
from repro_torch.kernels.segment_spmm.ref import segment_spmm_lanes_ref, segment_spmm_ref


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


def _offset_view(t, offset):
    """``t`` as a contiguous view ``offset`` rows into a larger tensor (a
    storage offset that moves its start off a 16-byte boundary)."""
    big = torch.empty((t.shape[0] + offset, *t.shape[1:]), dtype=t.dtype, device=t.device)
    big[offset:] = t
    return big[offset:]


def _assert_spmm_matches(got, want, combine, count_column=None):
    """min bit for bit (signs included); sum within ``rtol=atol=1e-4`` (float32
    atomics in another order), with a 0/1 count column exact."""
    assert got.shape == want.shape and got.dtype == torch.float32
    if combine == "min":
        assert torch.equal(got.view(torch.int32), want.view(torch.int32))
        return
    if count_column is not None:
        assert torch.equal(got[:, count_column], want[:, count_column])
    torch.testing.assert_close(got, want, rtol=1e-4, atol=1e-4)


@pytest.mark.cuda
@pytest.mark.parametrize("combine", ["min", "sum"])
@pytest.mark.parametrize("d", [1, 2, 3])
@pytest.mark.parametrize("m,offset,mixed,with_valid", [
    (50_001, 0, False, True), (50_003, 1, False, False), (4_099, 3, False, True),
    (4_099, 1, True, True), (7, 2, False, True), (1, 1, False, False), (0, 0, False, True)])
def test_segment_spmm_vector_and_scalar_lanes_on_card(combine, d, m, offset, mixed, with_valid):
    """The redesigned combine: d = 1 (1-D messages, as SSSP passes them), 2
    (float2 atomics for sum) and 3 (the any-d kernel); m not a multiple of
    the 4-lane vector; views ``offset`` rows into their storage, all three
    arrays alike (scalar head lanes before the messages' first vector
    boundary) or only the ids (``mixed``, as on the main path, where the
    ids are a slice of the edge array: shifted 16-byte id loads beside
    vector message loads); ids outside [0, n_segments); valid present and
    absent; m = 0.
    Sum: column 1 of d >= 2 is a 0/1 count."""
    dev = _cuda()
    n = 3_000
    rng = np.random.default_rng(m + d + offset)
    msg = rng.standard_normal((m, d)).astype(np.float32)
    if combine == "min":
        msg[rng.random((m, d)) < 0.2] = np.inf
        msg[rng.random((m, d)) < 0.05] = -np.inf
    elif d >= 2:
        msg[:, 1] = rng.random(m) < 0.5
    msg[rng.random((m, d)) < 0.05] = -0.0
    seg = rng.integers(-5, n + 5, m).astype(np.int32)
    valid = torch.from_numpy(rng.random(m) < 0.8).to(dev) if with_valid else None
    msg_t = torch.from_numpy(msg[:, 0] if d == 1 else msg).to(dev)
    seg_t = torch.from_numpy(seg).to(dev)
    if offset:
        seg_t = _offset_view(seg_t, offset)
        if not mixed:
            msg_t = _offset_view(msg_t, offset)
            valid = None if valid is None else _offset_view(valid, offset)
    before = segment_spmm.launches
    got = segment_spmm(msg_t, seg_t, n, valid, combine)
    assert segment_spmm.launches == before + 1
    torch.cuda.synchronize()
    want = segment_spmm_ref(msg_t.reshape(m, d), seg_t, n, valid, combine)
    _assert_spmm_matches(got.reshape(n, d), want, combine, 1 if d >= 2 else None)


@pytest.mark.cuda
@pytest.mark.parametrize("combine", ["min", "sum"])
@pytest.mark.parametrize("d", [1, 2])
def test_segment_spmm_every_lane_into_one_segment_on_card(combine, d):
    """The worst contention: 200,003 lanes, all into segment 5 (the sum's
    count column reaches 200,003, exact in float32)."""
    dev = _cuda()
    m, n = 200_003, 9
    g = torch.Generator(device=dev).manual_seed(4)
    msg = torch.rand((m, d), generator=g, device=dev) * 1e-3
    if d == 2:
        msg[:, 1] = 1.0
    seg = torch.full((m,), 5, dtype=torch.int32, device=dev)
    got = segment_spmm(msg, seg, n, combine=combine)
    torch.cuda.synchronize()
    want = segment_spmm_ref(msg, seg, n, combine=combine)
    _assert_spmm_matches(got, want, combine, 1 if d == 2 else None)
    if d == 2 and combine == "sum":
        assert float(got[5, 1]) == m


@pytest.mark.cuda
@pytest.mark.parametrize("d", [1, 2])
def test_segment_spmm_min_signed_zeros_and_infinities_on_card(d):
    """±0, ±inf, -3 and 2.5, each in a segment of its own: signs survive bit
    for bit; segments past every id stay +inf.  (Between +0 and -0 in one
    segment the plain version's ``amin`` keeps whichever comes first, so
    that case has no single answer to hold the kernel to.)"""
    dev = _cuda()
    vals = torch.tensor([0.0, -0.0, float("inf"), float("-inf"), -3.0, 2.5], device=dev)
    ids = torch.arange(6, dtype=torch.int32, device=dev)
    msg = vals if d == 1 else torch.stack([vals, -vals], dim=-1)
    got = segment_spmm(msg, ids, 9, combine="min")
    torch.cuda.synchronize()
    want = segment_spmm_ref(msg.reshape(6, d), ids, 9, combine="min")
    _assert_spmm_matches(got.reshape(9, d), want, "min")
    assert bool(torch.signbit(got.reshape(9, d)[1, 0]))
    assert bool(torch.isinf(got.reshape(9, d)[6:]).all())


@pytest.mark.cuda
@pytest.mark.parametrize("m", [1, 2047, 2048, 2049, 4095, 1_073_152])
@pytest.mark.parametrize("density", [0.0, 0.3, 1.0])
def test_frontier_compact_tiles_on_card(m, density):
    """The two-launch compaction at the 2048-row tile size and one row
    either side, two tiles less one, one row, and the main path's block
    (1,073,152 rows, 524 tiles): random, empty and full masks over the
    main path's four columns (i32, i32, f32, bool).  Bit for bit, with the
    count equal and on the device."""
    dev = _cuda()
    rng = np.random.default_rng(m)
    words = torch.from_numpy(rng.integers(-2**31, 2**31, (3, m)).astype(np.int32)).to(dev)
    mask = torch.from_numpy(rng.random(m) < density).to(dev)
    cols = (words[0], words[1], words[2].view(torch.float32), ~mask)
    before = frontier_compact.launches
    got, cnt = frontier_compact(cols, mask)
    assert frontier_compact.launches == before + 1
    torch.cuda.synchronize()
    want, wcnt = frontier_compact_ref(cols, mask)
    assert cnt.device == mask.device and cnt.dtype == torch.int32 and cnt.shape == ()
    assert int(cnt) == int(wcnt)
    for g_, w_ in zip(got, want):
        assert g_.dtype == w_.dtype and torch.equal(g_.view(torch.uint8), w_.view(torch.uint8))


@pytest.mark.cuda
@pytest.mark.parametrize("offset", [1, 3])
def test_frontier_compact_column_views_with_offsets_on_card(offset):
    """Columns and mask that start ``offset`` elements into their storage
    (off a 16-byte boundary: scalar loads), beside an aligned column."""
    dev = _cuda()
    m = 3 * 2048 + 77
    rng = np.random.default_rng(offset)
    a = torch.from_numpy(rng.integers(0, 1000, m).astype(np.int32)).to(dev)
    b = torch.from_numpy(rng.standard_normal(m).astype(np.float32)).to(dev)
    mask = torch.from_numpy(rng.random(m) < 0.4).to(dev)
    cols = (_offset_view(a, offset), b, _offset_view(mask, offset))
    got, cnt = frontier_compact(cols, _offset_view(mask, offset))
    torch.cuda.synchronize()
    want, wcnt = frontier_compact_ref(cols, mask)
    assert int(cnt) == int(wcnt)
    assert all(torch.equal(g_, w_) for g_, w_ in zip(got, want))


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


def _lane_offsets(lengths, dev):
    return torch.tensor(np.concatenate([[0], np.cumsum(lengths)]), dtype=torch.int64, device=dev)


@pytest.mark.cuda
@pytest.mark.parametrize("combine,d", [("min", 1), ("sum", 2), ("min", 2), ("sum", 1)])
@pytest.mark.parametrize("lengths", [(5000,), (0, 3000, 1, 0, 7777), (2048,) * 8])
def test_segment_spmm_lanes_vs_plain_on_card(combine, d, lengths):
    """The lane entry against its plain version (a loop of single-lane
    plain versions): L lanes packed lane after lane, empty lanes included,
    each lane into its own row; min bit for bit, sum within
    ``rtol=atol=1e-4`` with a 0/1 count column exact."""
    dev = _cuda()
    m, n = int(sum(lengths)), 9_000
    msg, seg, valid = _spmm_inputs(m, d, n, seed=len(lengths) + d, with_inf=combine == "min")
    if combine == "sum" and d == 2:
        msg[:, 1] = valid
        msg[:, 0] = np.where(valid, msg[:, 0], 0.0)
    args = (torch.from_numpy(msg if d > 1 else msg[:, 0].copy()).to(dev),
            torch.from_numpy(seg).to(dev), _lane_offsets(lengths, dev), n, combine)
    before = segment_spmm_lanes.launches
    got = segment_spmm_lanes(*args)
    assert segment_spmm_lanes.launches == before + 1
    want = segment_spmm_lanes_ref(*args)
    assert got.shape == want.shape == ((len(lengths), n) if d == 1 else (len(lengths), n, d))
    _assert_spmm_matches(got.reshape(-1, d), want.reshape(-1, d), combine,
                         count_column=1 if combine == "sum" and d == 2 else None)


@pytest.mark.cuda
@pytest.mark.parametrize("density", [0.0, 0.3, 1.0])
@pytest.mark.parametrize("lengths", [(1,), (2047, 0, 2048, 2049, 1), (70_001, 4095, 33)])
def test_frontier_compact_lanes_vs_plain_on_card(density, lengths):
    """Each lane's rows partitioned by its own mask in place of themselves,
    tiles cut at lane bounds: bit for bit against the loop of single-lane
    plain versions, with each lane's count."""
    dev = _cuda()
    m = int(sum(lengths))
    rng = np.random.default_rng(m)
    words = torch.from_numpy(rng.integers(-2**31, 2**31, (3, m)).astype(np.int32)).to(dev)
    mask = torch.from_numpy(rng.random(m) < density).to(dev)
    cols = (words[0], words[1], words[2].view(torch.float32), ~mask)
    offsets = _lane_offsets(lengths, dev)
    before = frontier_compact_lanes.launches
    got, cnt = frontier_compact_lanes(cols, mask, offsets)
    assert frontier_compact_lanes.launches == before + 1
    torch.cuda.synchronize()
    want, wcnt = frontier_compact_lanes_ref(cols, mask, offsets)
    assert cnt.dtype == torch.int32 and torch.equal(cnt, wcnt.to(dev))
    for g_, w_ in zip(got, want):
        assert torch.equal(g_.view(torch.uint8), w_.view(torch.uint8))


@pytest.mark.cuda
def test_hyb_gather_lane_windows_in_one_request_list_on_card():
    """ZEROCOPY's lane path: every lane's windows over the shared columns in
    one request list equal the lanes' requests issued one lane at a time."""
    dev = _cuda()
    rng = np.random.default_rng(4)
    edges = torch.from_numpy(rng.integers(0, 1000, (3, 50_000)).astype(np.int32)).to(dev)
    cols = (edges[0], edges[1], edges[2].view(torch.float32))
    lanes = [(0, 1000), (20_000, 129), (45_000, 5000)]
    per = []
    for start, count in lanes:
        st = torch.arange(start, start + count, 128, dtype=torch.int32, device=dev)
        per.append((st, torch.clamp(start + count - st, max=128).to(torch.int32)))
    got = hyb_gather(cols, torch.cat([p[0] for p in per]), torch.cat([p[1] for p in per]))
    want = [torch.cat(c) for c in zip(*(hyb_gather(cols, *p) for p in per))]
    assert all(torch.equal(g_, w_) for g_, w_ in zip(got, want))


@pytest.mark.cuda
def test_lane_batched_chunk_equals_solo_runs_on_card():
    """hytm_batched_chunk through the lane kernels on the card: each lane of
    a Q=4 batch (one dead lane) equals its solo run_hytm bit for bit."""
    from repro_torch.core import hytm as th
    from repro_torch.graph.algorithms import SSSP
    from repro_torch.graph.generators import rmat_graph
    from repro_torch.kernels.hyb_gather import ops as gather_ops

    dev = _cuda()
    g = rmat_graph(3000, 40_000, seed=5)
    cfg = th.HyTMConfig(n_partitions=8, sync_every=4)
    rt = th.build_runtime(g, cfg, device=dev)
    sources = [0, 17, 1234]
    trip = [SSSP.init_state(g.n_nodes, s, dev) for s in sources]
    trip.append(th.dead_lane_state(SSSP, g.n_nodes, dev))
    state = th.HyTMState(*(torch.stack([t[i] for t in trip]) for i in range(3)))
    launches = (segment_spmm_lanes.launches, frontier_compact_lanes.launches,
                gather_ops.hyb_gather.launches)
    for _ in range(100):
        state, n_done, active, _, _ = th.hytm_batched_chunk(state, rt, SSSP, cfg, 4)
        if not active.any():
            break
    assert not active.any()
    assert sum(launches) < segment_spmm_lanes.launches + frontier_compact_lanes.launches \
        + gather_ops.hyb_gather.launches
    for q, s in enumerate(sources):
        solo = th.run_hytm(None, SSSP, s, cfg, runtime=rt)
        assert np.array_equal(state.values[q].cpu().numpy(), solo.values)
    assert torch.isinf(state.values[3]).all()


@pytest.mark.cuda
def test_kernel_libraries_load():
    _cuda()
    for stem in ("segment_spmm", "frontier_compact", "hyb_gather", "flash_attention",
                 "embedding_bag", "grouped_matmul"):
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
def test_flash_attention_kernel_at_mla_shape():
    """deepseek-v2-lite's prefill: 4 x 16 heads, q and k 192 wide, values
    128 wide zero-padded to 192, as the TPU wrapper pads them (the (192,
    192) instantiation, 148,544 bytes of shared memory)."""
    dev = _cuda()
    g = torch.Generator(device=dev).manual_seed(0)
    q, k, v = (torch.randn((64, 2048, 192), generator=g, device=dev).bfloat16() for _ in range(3))
    v[..., 128:] = 0
    got = flash_attention(q, k, v, scale=192**-0.5)
    torch.cuda.synchronize()
    want = flash_attention_ref(q, k, v, 192**-0.5)
    assert not got[..., 128:].any()
    torch.testing.assert_close(got.float(), want.float(), rtol=2e-2, atol=2e-2)


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


def _groups(rng, T, E, C):
    counts = np.minimum(rng.integers(0, 2 * C, E), C).astype(np.int32)
    counts[rng.random(E) < 0.2] = 0
    starts = np.concatenate([[0], np.cumsum(counts)[:-1]]).astype(np.int32)
    return starts, counts


@pytest.mark.cuda
@pytest.mark.parametrize("T,D,E,F,C", [(1000, 256, 8, 192, 160), (777, 130, 5, 70, 200),
                                       (24, 2048, 64, 1408, 8), (300, 64, 1, 100, 300),
                                       (513, 33, 7, 65, 90)])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_grouped_matmul_kernel_vs_plain_on_card(T, D, E, F, C, dtype):
    """Groups from the MoE layout (packed from row 0, counts capped at C,
    some empty), rows after the last group outside every group; odd D and
    F take the scalar loads."""
    dev = _cuda()
    rng = np.random.default_rng(T + D)
    x = torch.from_numpy(rng.standard_normal((T, D)).astype(np.float32)).to(dev, dtype)
    w = torch.from_numpy((rng.standard_normal((E, D, F)) / np.sqrt(D)).astype(np.float32))
    w = w.to(dev, dtype)
    starts, counts = _groups(rng, T, E, C)
    counts = np.minimum(counts, np.maximum(T - starts, 0)).astype(np.int32)
    s, c = (torch.from_numpy(a).to(dev) for a in (starts, counts))
    before = grouped_matmul.launches
    got = grouped_matmul(x, w, s, c, C)
    assert grouped_matmul.launches == before + 1
    torch.cuda.synchronize()
    want = grouped_matmul_ref(x, w, s, c, C)
    assert got.dtype == dtype and got.shape == (T, F)
    if dtype == torch.float32:
        torch.testing.assert_close(got, want, rtol=1e-5, atol=1e-5)
    else:
        torch.testing.assert_close(got.float(), want.float(), rtol=2**-7, atol=1e-5)
    inside = torch.zeros(T, dtype=torch.bool, device=dev)
    for st, n in zip(starts.tolist(), counts.tolist()):
        inside[st:st + n] = True
    assert not got[~inside].any()


@pytest.mark.cuda
def test_grouped_matmul_kernel_writes_only_its_group():
    """Abutting groups of 1..130 rows: a block never writes past its group's
    count (the TPU body's whole-tile store would), and counts past max_rows
    are cut."""
    dev = _cuda()
    counts = torch.tensor([1, 63, 64, 65, 130, 0, 2], dtype=torch.int32, device=dev)
    starts = torch.cumsum(counts, 0, dtype=torch.int32) - counts
    T = int(counts.sum())
    x = torch.randn(T, 40, device=dev).bfloat16()
    w = torch.randn(7, 40, 72, device=dev).bfloat16()
    for max_rows in (T, 64):
        got = grouped_matmul(x, w, starts, counts, max_rows)
        torch.cuda.synchronize()
        want = grouped_matmul_ref(x, w, starts, counts, max_rows)
        torch.testing.assert_close(got.float(), want.float(), rtol=2**-7, atol=1e-5)


@pytest.mark.cuda
def test_grouped_matmul_kernel_rejects_bad_inputs_on_card():
    dev = _cuda()
    x, w = torch.zeros(8, 4, device=dev), torch.zeros(2, 4, 3, device=dev)
    s = torch.zeros(2, dtype=torch.int32, device=dev)
    with pytest.raises(ValueError, match="contiguous"):
        grouped_matmul(x, w.transpose(1, 2).contiguous().transpose(1, 2), s, s)
    with pytest.raises(ValueError, match="tensors on"):
        grouped_matmul(x, w, s.cpu(), s.cpu())


# ---- the bf16 bodies: wgmma on a TMA/mbarrier ring (kernels/common/csrc/hopper.cuh)

@pytest.mark.cuda
@pytest.mark.parametrize("mn_major", [False, True])
def test_wgmma_tile_vs_matmul_on_card(mn_major):
    """One TMA-loaded, 128-byte-swizzled tile through wgmma m64n128k16 (4
    k16 steps): B K-major ((N, K) rows, as attention's K) and MN-major ((K,
    N) rows, as V and an expert's weights; two 64-column boxes, so the
    descriptor's leading byte offset is used).  bf16 products are exact in
    float32; the sums differ in order only."""
    dev = _cuda()
    g = torch.Generator(device=dev).manual_seed(5)
    a = torch.randn((64, 64), generator=g, device=dev).bfloat16()
    b = torch.randn((64, 128) if mn_major else (128, 64), generator=g, device=dev).bfloat16()
    c = torch.empty((64, 128), device=dev)
    fn = runtime.load_kernel("grouped_matmul", "wgmma_tile_launch",
                             [ctypes.c_void_p] * 3 + [ctypes.c_int, ctypes.c_void_p])
    runtime.check_launch("wgmma_tile", fn(a.data_ptr(), b.data_ptr(), c.data_ptr(),
                                          int(mn_major), runtime.stream_ptr()))
    torch.cuda.synchronize()
    want = a.float() @ (b.float() if mn_major else b.float().T)
    torch.testing.assert_close(c, want, rtol=1e-5, atol=1e-4)


@pytest.mark.cuda
@pytest.mark.parametrize("S,L,dh,dv,window,causal,kv_groups", [
    (257, 257, 64, 64, 0, True, 1), (257, 257, 128, 128, 0, True, 4),
    (257, 257, 192, 128, 0, True, 1), (257, 257, 192, 192, 1024, True, 2),
    (257, 257, 256, 256, 0, True, 2), (1100, 1100, 256, 256, 1024, True, 2),
    (300, 300, 128, 64, 1, True, 1), (130, 400, 64, 64, 0, False, 2),
    (300, 100, 128, 128, 50, False, 1), (97, 97, 96, 80, 5, True, 4),
    (64, 64, 256, 128, 0, True, 1)])
def test_flash_attention_bf16_wgmma_on_card(S, L, dh, dv, window, causal, kv_groups):
    """The bf16 body at each instantiated width and with values narrower than
    the keys (padded widths: dh 96 -> 128, dv 80 -> 128 and (256, 128) ->
    (256, 256)), S = 257 (a partial 128-row tile), window 1 and 1024 across
    64- and 128-key tiles, kv_groups 1/2/4, non-causal with L != S, and rows
    with no key (non-causal, window 50, S > L: rows >= 149 are 0).  It
    rounds P to bf16, the plain version keeps float32: ``2e-2``."""
    dev = _cuda()
    rng = np.random.default_rng(S + dh + dv)
    bh = 2 * kv_groups
    q, k, v = (torch.from_numpy(rng.standard_normal(shape).astype(np.float32)).to(dev).bfloat16()
               for shape in ((bh, S, dh), (bh // kv_groups, L, dh), (bh // kv_groups, L, dv)))
    before = flash_attention.launches
    got = flash_attention(q, k, v, window=window, causal=causal, kv_groups=kv_groups)
    assert flash_attention.launches == before + 1
    torch.cuda.synchronize()
    want = flash_attention_ref(q, k, v, 1.0 / dh**0.5, window, causal, kv_groups)
    assert got.shape == (bh, S, dv) and got.dtype == torch.bfloat16
    torch.testing.assert_close(got.float(), want.float(), rtol=2e-2, atol=2e-2)
    if not causal and window:
        assert not got[:, L - 1 + window:].any()


@pytest.mark.cuda
def test_flash_attention_bf16_takes_values_128_wide_at_mla_shape():
    """deepseek-v2-lite's prefill as ``mla_attention`` now calls it: q and k
    192 wide, values 128 wide (the (192, 128) instantiation, no padding)."""
    dev = _cuda()
    g = torch.Generator(device=dev).manual_seed(1)
    q, k = (torch.randn((64, 2048, 192), generator=g, device=dev).bfloat16() for _ in range(2))
    v = torch.randn((64, 2048, 128), generator=g, device=dev).bfloat16()
    got = flash_attention(q, k, v, scale=192**-0.5)
    torch.cuda.synchronize()
    assert got.shape == (64, 2048, 128)
    torch.testing.assert_close(got.float(), flash_attention_ref(q, k, v, 192**-0.5).float(),
                               rtol=2e-2, atol=2e-2)


@pytest.mark.cuda
def test_flash_attention_bf16_rejects_unaligned_inputs():
    dev = _cuda()
    base = torch.zeros(4 * 16 * 64 + 1, device=dev).bfloat16()
    q = base[1:].view(4, 16, 64)      # contiguous, 2 bytes past a 16-byte boundary
    with pytest.raises(ValueError, match="16-byte"):
        flash_attention(q, q, q)


@pytest.mark.cuda
@pytest.mark.parametrize("T,D,E,F,C,shift", [
    (49_152, 2048, 64, 1408, 960, 0), (49_152, 1408, 64, 2048, 960, 0),
    (24, 2048, 64, 1408, 8, 0), (5000, 256, 8, 192, 700, 37), (40, 512, 16, 256, 4, 3),
    (777, 130, 5, 70, 200, 11), (513, 33, 7, 65, 90, 0)])
def test_grouped_matmul_bf16_wgmma_on_card(T, D, E, F, C, shift):
    """The bf16 body at deepseek-v2-lite's three launch shapes (prefill
    gate/up and down, 128 x 128 tiles; decode, 64 x 64 tiles), groups that
    start mid-tile (``shift`` rows before the first group), empty experts,
    counts above max_rows (cut), D and F that TMA cannot describe (zero-
    padded copies), and rows outside every group that stay 0."""
    dev = _cuda()
    rng = np.random.default_rng(T + D + shift)
    x = torch.from_numpy(rng.standard_normal((T, D)).astype(np.float32)).to(dev).bfloat16()
    w = torch.from_numpy((rng.standard_normal((E, D, F)) / np.sqrt(D)).astype(np.float32))
    w = w.to(dev).bfloat16()
    counts = rng.integers(0, 2 * C, E).astype(np.int32)
    counts[rng.random(E) < 0.2] = 0
    kept = np.minimum(counts, C)
    starts = (shift + np.concatenate([[0], np.cumsum(kept)[:-1]])).astype(np.int32)
    counts = np.minimum(counts, np.maximum(T - starts, 0)).astype(np.int32)
    s, c = (torch.from_numpy(a).to(dev) for a in (starts, counts))
    before = grouped_matmul.launches
    got = grouped_matmul(x, w, s, c, C)
    assert grouped_matmul.launches == before + 1
    torch.cuda.synchronize()
    want = grouped_matmul_ref(x, w, s, c, C)
    assert got.dtype == torch.bfloat16 and got.shape == (T, F)
    torch.testing.assert_close(got.float(), want.float(), rtol=2**-7, atol=1e-4)
    inside = torch.zeros(T, dtype=torch.bool, device=dev)
    for st, n in zip(starts.tolist(), np.minimum(counts, C).tolist()):
        inside[st:st + n] = True
    assert not got[~inside].any()


@pytest.mark.cuda
def test_delta_csr_patches_on_card_as_on_cpu():
    """A DeltaCSR on the card and one on the CPU take the same three
    batches (the third merge-compacts): their device tensors are equal bit
    for bit after each, and the warm SSSP through the kernels equals the
    CPU's run through the wrappers' plain bodies in values, iterations and
    engines."""
    import dataclasses

    from repro_torch.core.hytm import HyTMConfig, run_hytm
    from repro_torch.graph.algorithms import SSSP
    from repro_torch.graph.generators import rmat_graph
    from repro_torch.stream import EdgeBatch, DeltaCSR, random_batch, run_incremental

    _cuda()
    g = rmat_graph(5000, 60_000, seed=5)
    cfg = HyTMConfig(n_partitions=8, sync_every=4, use_kernels=True)
    card = DeltaCSR(g, cfg, slack=0.2)
    cpu = DeltaCSR(g, cfg, slack=0.2, device="cpu")
    assert card.csr.device.type == "cuda"

    def same_tensors():
        for name in ("edge_src", "edge_dst", "edge_weight", "edge_valid", "out_degree",
                     "seg_start"):
            assert torch.equal(getattr(card.csr, name).cpu(), getattr(cpu.csr, name)), name
        for name in ("vertex_start", "edge_start", "part_edges", "vertex_part_id"):
            assert torch.equal(getattr(card.parts, name).cpu(), getattr(cpu.parts, name)), name
        assert card.parts.host == cpu.parts.host
        assert torch.equal(card.zc_req.cpu(), cpu.zc_req)
        for weighted in (False, True):
            assert torch.equal(card._inv_deg(weighted).cpu(), cpu._inv_deg(weighted))

    same_tensors()
    warm_card = run_hytm(None, SSSP, 0, cfg, runtime=card.runtime_for(SSSP))
    warm_cpu = run_hytm(None, SSSP, 0, cfg, runtime=cpu.runtime_for(SSSP))
    np.testing.assert_array_equal(warm_card.values, warm_cpu.values)
    rng_a, rng_b = np.random.default_rng(3), np.random.default_rng(3)
    for i in range(3):
        if i < 2:
            a = random_batch(card, rng_a, n_insert=60, n_delete=60, n_reweight=20)
            b = random_batch(cpu, rng_b, n_insert=60, n_delete=60, n_reweight=20)
        else:
            p = int(np.argmax(card.counts))
            k = card.block_size - int(card.counts[p]) + 1
            src = np.full(k, int(card.vertex_start[p]))
            a = b = EdgeBatch.inserts(src, np.arange(k) % g.n_nodes, np.ones(k, np.float32))
        ra, rb = card.apply(a), cpu.apply(b)
        assert ra.merged == rb.merged == (i == 2)
        same_tensors()
        before = segment_spmm.launches + frontier_compact.launches + hyb_gather.launches
        got = run_incremental(card, SSSP, [ra], warm_card.values, warm_card.delta, 0, cfg)
        assert segment_spmm.launches + frontier_compact.launches + hyb_gather.launches > before
        want = run_incremental(cpu, SSSP, [rb], warm_cpu.values, warm_cpu.delta, 0, cfg)
        np.testing.assert_array_equal(got.values, want.values)
        assert got.iterations == want.iterations
        np.testing.assert_array_equal(got.history["engines"], want.history["engines"])
        warm_card, warm_cpu = got, want
    assert card.layout_version == cpu.layout_version == 1
    # autotune on the card runs and leaves traversal values alone
    tuned = run_hytm(None, SSSP, 0, dataclasses.replace(cfg, autotune=True),
                     runtime=card.runtime_for(SSSP))
    np.testing.assert_array_equal(tuned.values, warm_card.values)


@pytest.mark.cuda
def test_wall_probe_times_the_kernel_engines_on_card():
    """Calibration's wall probe on a 6-point grid through the kernels: finite
    positive seconds for every (point, engine), each graph kernel launched,
    and the probe's realized points those of a CPU probe."""
    from repro_torch.autotune import calibrate, default_grid, wall_probe

    dev = _cuda()
    grid = default_grid(edge_levels=(3.1e4, 4.1e5), n_ratios=3, regimes=("hub", "flat"))[:6]
    wrappers = (segment_spmm, frontier_compact, hyb_gather)
    before = [w.launches for w in wrappers]
    pts, obs = wall_probe(grid, max_edges=100_000, repeats=2, device=dev)
    assert all(b < w.launches for b, w in zip(before, wrappers))
    assert len(obs) == 18
    assert all(np.isfinite(o.seconds) and o.seconds > 0 for o in obs)
    cpu_pts, _ = wall_probe(grid, max_edges=100_000, repeats=1, use_kernels=False,
                            device="cpu")
    assert pts == cpu_pts
    from repro_torch.core.constants import PCIE3

    rep = calibrate(pts, obs, PCIE3, fit_overhead=True)
    assert rep.calibrated_regret <= rep.static_regret


@pytest.mark.cuda
@pytest.mark.parametrize("K", [8, 1])
def test_traced_sssp_reconciles_on_card(K):
    """A traced SSSP through the kernels: reconcile exact, values bit-equal to
    the untraced run."""
    from repro_torch.core.hytm import HyTMConfig, run_hytm
    from repro_torch.graph.algorithms import SSSP
    from repro_torch.graph.generators import rmat_graph
    from repro_torch.obs import TraceRecorder, reconcile

    dev = _cuda()
    g = rmat_graph(20_000, 320_000, seed=5)
    cfg = HyTMConfig(n_partitions=16, sync_every=K)
    rec = TraceRecorder()
    traced = run_hytm(g, SSSP, 0, cfg, obs=rec, device=dev)
    plain = run_hytm(g, SSSP, 0, cfg, device=dev)
    assert reconcile(rec, traced)["ok"]
    np.testing.assert_array_equal(traced.values, plain.values)
    assert traced.iterations == plain.iterations


@pytest.mark.cuda
def test_kill_resume_through_the_kernels_on_card(tmp_path):
    """SSSP through the kernels at K=2, killed by an injected dispatch fault
    at chunks 1-3 and resumed from its checkpoint: values, iterations,
    transfer bytes and the history bit-equal to the uninterrupted card run,
    and the values to the CPU's run through the wrappers' plain bodies."""
    from repro_torch.core.hytm import HyTMConfig, run_hytm
    from repro_torch.graph.algorithms import SSSP
    from repro_torch.graph.generators import rmat_graph
    from repro_torch.resilience import (CheckpointHook, FaultSpec, RetriesExhausted, plan_of,
                                        resume_run)

    dev = _cuda()
    g = rmat_graph(20_000, 320_000, seed=5)
    cfg = HyTMConfig(n_partitions=16, sync_every=2, use_kernels=True)
    base = run_hytm(g, SSSP, 0, cfg, device=dev)
    assert base.iterations > 6
    cpu = run_hytm(g, SSSP, 0, cfg, device="cpu")
    np.testing.assert_array_equal(base.values, cpu.values)
    for k in (1, 2, 3):
        path = tmp_path / f"kill{k}.npz"
        hook = CheckpointHook(path, program=SSSP.name)
        before = segment_spmm.launches + frontier_compact.launches + hyb_gather.launches
        with pytest.raises(RetriesExhausted):
            run_hytm(g, SSSP, 0, cfg, faults=plan_of(FaultSpec("chunk_dispatch", "fail",
                                                                at=(k,))),
                     on_chunk=hook, device=dev)
        assert hook.saved == k
        assert segment_spmm.launches + frontier_compact.launches + hyb_gather.launches > before
        res = resume_run(path, g, SSSP, config=cfg, device=dev)
        np.testing.assert_array_equal(res.values, base.values)
        assert res.iterations == base.iterations
        assert res.total_transfer_bytes == base.total_transfer_bytes
        for key in base.history:
            np.testing.assert_array_equal(res.history[key], base.history[key])


@pytest.mark.cuda
def test_sharded_sweep_at_world_size_one_on_nccl():
    """The sharded sweep at D = 1 on NCCL, through the kernels: SSSP
    bit-equal to the single-device ``async_sweep=False`` run (values,
    iterations, bytes, engines), zero ICI rows, and every graph kernel
    launched."""
    import dataclasses

    from repro_torch.core.hytm import HyTMConfig, run_hytm
    from repro_torch.graph.algorithms import SSSP
    from repro_torch.graph.generators import rmat_graph
    from repro_torch.launch.mesh import RankPool, make_graph_mesh

    dev = _cuda()
    g = rmat_graph(20_000, 320_000, seed=5)
    cfg = HyTMConfig(n_partitions=16, async_sweep=False, sync_every=4)
    one = run_hytm(g, SSSP, 0, cfg, device=dev)
    kernels = (segment_spmm, frontier_compact, hyb_gather)
    for k in kernels:
        k.launches = 0
    with RankPool(1, backend="nccl", timeout_s=60.0):
        res = run_hytm(g, SSSP, 0, dataclasses.replace(cfg, mesh_axis="graph"),
                       mesh=make_graph_mesh(device=dev))
    # each engine the run picked launched its kernel, and no other kernel ran
    picked = set(np.unique(res.history["engines"]).tolist())
    assert [k.launches > 0 for k in kernels] == [e in picked for e in (0, 1, 2)]
    np.testing.assert_array_equal(res.values, one.values)
    assert res.iterations == one.iterations
    assert res.total_transfer_bytes == one.total_transfer_bytes
    np.testing.assert_array_equal(res.history["engines"], one.history["engines"])
    assert res.total_ici_bytes == 0.0 and (res.history["ici_engine"] == -1).all()


@pytest.mark.cuda
def test_owner_layout_at_world_size_one_on_nccl():
    """The owner layout at D = 1 on NCCL, through the kernels: ``n_pad = n``
    and no halo, so SSSP is bit-equal to the replicated layout's and to the
    single-device ``async_sweep=False`` run; Δ-PageRank's sum kernel adds
    with float atomics, so no two card runs of it are bit-equal, and it is
    held to the replicated run within this file's sum tolerance
    (``rtol=atol=1e-4``).  The ICI rows are zero, and every engine the run
    picked launched its kernel."""
    import dataclasses

    from repro_torch.core.hytm import HyTMConfig, run_hytm
    from repro_torch.dist.graph_shard import build_sharded_runtime
    from repro_torch.graph.algorithms import PAGERANK, SSSP
    from repro_torch.graph.generators import rmat_graph
    from repro_torch.launch.mesh import RankPool, make_graph_mesh

    dev = _cuda()
    g = rmat_graph(20_000, 320_000, seed=5)
    cfg = HyTMConfig(n_partitions=16, async_sweep=False, sync_every=4, mesh_axis="graph")
    own = dataclasses.replace(cfg, vertex_sharding="owner")
    one = run_hytm(g, SSSP, 0, dataclasses.replace(cfg, mesh_axis=None), device=dev)
    kernels = (segment_spmm, frontier_compact, hyb_gather)
    with RankPool(1, backend="nccl", timeout_s=60.0):
        mesh = make_graph_mesh(device=dev)
        rt = build_sharded_runtime(g, own, mesh)
        assert (rt.n_pad, rt.halo.halo_counts) == (g.n_nodes, (0,))
        for prog, c in ((SSSP, cfg), (PAGERANK, dataclasses.replace(cfg, cds_mode="delta"))):
            src = 0 if prog is SSSP else None
            rep = run_hytm(g, prog, src, c, mesh=mesh)
            for k in kernels:
                k.launches = 0
            res = run_hytm(g, prog, src, dataclasses.replace(c, vertex_sharding="owner"),
                           mesh=mesh)
            picked = set(np.unique(res.history["engines"]).tolist())
            assert [k.launches > 0 for k in kernels] == [e in picked for e in (0, 1, 2)]
            assert res.total_ici_bytes == 0.0 and (res.history["ici_engine"] == -1).all()
            if prog is SSSP:
                np.testing.assert_array_equal(res.values, rep.values)
                assert res.iterations == rep.iterations
                np.testing.assert_array_equal(res.values, one.values)
                assert res.total_transfer_bytes == one.total_transfer_bytes
            else:
                np.testing.assert_allclose(res.values + res.delta, rep.values + rep.delta,
                                           rtol=1e-4, atol=1e-4)


@pytest.mark.cuda
def test_graph_build_on_card_equals_cpu():
    """``rmat_graph``, ``hub_sort`` and ``csr_from_edges`` (with dedup) give
    the same graph when their arithmetic and sorts run on the card."""
    from repro_torch.graph.csr import csr_from_edges
    from repro_torch.graph.generators import rmat_graph
    from repro_torch.graph.hub_sort import hub_sort

    dev = _cuda()
    g = rmat_graph(2**14, 2**18, seed=5)
    card = rmat_graph(2**14, 2**18, seed=5, device=dev)
    src, dst = g.edge_sources(), g.indices
    both = (np.concatenate([src, dst]), np.concatenate([dst, src]),
            np.concatenate([g.weights, g.weights]))
    for a, b in ((g, card), (hub_sort(g).graph, hub_sort(g, device=dev).graph),
                 (g.symmetrize(), csr_from_edges(g.n_nodes, *both, dedup=True, device=dev))):
        np.testing.assert_array_equal(a.indptr, b.indptr)
        np.testing.assert_array_equal(a.indices, b.indices)
        np.testing.assert_array_equal(a.weights, b.weights)
    np.testing.assert_array_equal(hub_sort(g).perm, hub_sort(g, device=dev).perm)
    empty = csr_from_edges(7, np.zeros(0, np.int64), np.zeros(0, np.int64), device=dev)
    np.testing.assert_array_equal(empty.indptr, np.zeros(8, np.int64))
