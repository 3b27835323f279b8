"""The port's kernels.

On the CPU each wrapper runs its plain version; those are held against the
reference's ``ref.py`` oracles and, for ``segment_spmm``, against the Pallas
kernel in interpret mode (the other two Pallas bodies do not run under the
installed jax).  Tolerances: min, compaction and gather are exact; sums are
float32 sums of the same values in another order, ``rtol=atol=1e-5``.

The kernels themselves are held against their plain versions on the card
in ``test_torch_kernels_cuda.py``.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels.frontier_compact.ref import frontier_compact_ref as j_compact_ref
from repro.kernels.hyb_gather.ref import hyb_gather_ref as j_gather_ref
from repro.kernels.segment_spmm.ops import segment_spmm as j_spmm_pallas
from repro.kernels.segment_spmm.ref import segment_spmm_ref as j_spmm_ref
from repro_torch.kernels import runtime
from repro_torch.kernels.frontier_compact.ops import frontier_compact
from repro_torch.kernels.hyb_gather.ops import PAD, hyb_gather
from repro_torch.kernels.segment_spmm.ops import segment_spmm

SUM_TOL = dict(rtol=1e-5, atol=1e-5)


def _spmm_inputs(m, d, n, seed, with_inf=False):
    rng = np.random.default_rng(seed)
    msg = rng.standard_normal((m, d)).astype(np.float32)
    if with_inf:
        msg[rng.random((m, d)) < 0.1] = np.inf
        msg[rng.random((m, d)) < 0.05] = -np.inf
    seg = rng.integers(0, n, m).astype(np.int32)
    valid = rng.random(m) < 0.8
    return msg, seg, valid


@pytest.mark.parametrize("m,d,n", [(100, 1, 40), (513, 2, 129), (1000, 3, 700), (0, 2, 9)])
@pytest.mark.parametrize("combine", ["sum", "min"])
@pytest.mark.parametrize("with_valid", [False, True])
def test_segment_spmm_plain_vs_reference(m, d, n, combine, with_valid):
    msg, seg, valid = _spmm_inputs(m, d, n, seed=m + d, with_inf=combine == "min")
    v = valid if with_valid else None
    want = np.asarray(j_spmm_ref(jnp.asarray(msg), jnp.asarray(seg), n + 5,
                                 None if v is None else jnp.asarray(v), combine))
    got = segment_spmm(torch.from_numpy(msg), torch.from_numpy(seg), n + 5,
                       None if v is None else torch.from_numpy(v), combine).numpy()
    assert got.shape == (n + 5, d)   # segments past every id hold the identity
    if combine == "min":
        np.testing.assert_array_equal(want, got)
    else:
        np.testing.assert_allclose(want, got, **SUM_TOL)


@pytest.mark.parametrize("m,d,n", [(300, 1, 50), (700, 2, 130)])
@pytest.mark.parametrize("combine", ["sum", "min"])
def test_segment_spmm_plain_vs_pallas_interpret(m, d, n, combine):
    msg, seg, valid = _spmm_inputs(m, d, n, seed=3, with_inf=combine == "min")
    want = np.asarray(j_spmm_pallas(jnp.asarray(msg), jnp.asarray(seg), n,
                                    jnp.asarray(valid), combine))
    got = segment_spmm(torch.from_numpy(msg), torch.from_numpy(seg), n,
                       torch.from_numpy(valid), combine).numpy()
    if combine == "min":
        np.testing.assert_array_equal(want, got)
    else:
        np.testing.assert_allclose(want, got, **SUM_TOL)


def test_segment_spmm_signed_zero_and_inf_like_segment_min():
    msg = np.array([0.0, -0.0, np.inf, -np.inf, 2.0, -2.0], np.float32)
    seg = np.arange(6, dtype=np.int32)
    want = np.asarray(j_spmm_ref(jnp.asarray(msg[:, None]), jnp.asarray(seg), 8,
                                 combine="min"))[:, 0]
    got = segment_spmm(torch.from_numpy(msg), torch.from_numpy(seg), 8, combine="min").numpy()
    np.testing.assert_array_equal(want, got)
    np.testing.assert_array_equal(np.signbit(want), np.signbit(got))


def test_segment_spmm_drops_out_of_range_ids():
    msg = torch.ones(4, 1)
    seg = torch.tensor([0, 5, -1, 2], dtype=torch.int32)
    np.testing.assert_array_equal(segment_spmm(msg, seg, 3)[:, 0].numpy(), [1.0, 0.0, 1.0])


def _columns(arr):
    return tuple(torch.from_numpy(np.ascontiguousarray(arr[:, j])) for j in range(arr.shape[1]))


@pytest.mark.parametrize("m,c,density", [(100, 1, 0.5), (1024, 4, 0.1), (700, 3, 0.9),
                                         (512, 3, 0.0), (300, 2, 1.0), (0, 3, 0.5)])
def test_frontier_compact_plain_vs_reference(m, c, density):
    rng = np.random.default_rng(m + c)
    vals = rng.standard_normal((m, c)).astype(np.float32)
    mask = rng.random(m) < density
    want, wcnt = j_compact_ref(jnp.asarray(vals), jnp.asarray(mask))
    got, cnt = frontier_compact(_columns(vals), torch.from_numpy(mask))
    assert cnt.dtype == torch.int32 and cnt.dim() == 0 and int(cnt) == int(wcnt)
    # the whole stable partition, the tail after the count included
    np.testing.assert_array_equal(np.asarray(want), np.stack([g.numpy() for g in got], -1)
                                  .reshape(m, c))


def test_frontier_compact_moves_raw_words():
    # ids beyond 2**24 survive: the words are never converted to float
    vals = torch.tensor([[2**24 + 1, 7], [2**30 + 3, -5], [123, 9]], dtype=torch.int32)
    (a, b), cnt = frontier_compact((vals[:, 0].contiguous(), vals[:, 1].contiguous()),
                                   torch.tensor([False, True, True]))
    assert int(cnt) == 2 and torch.equal(torch.stack([a, b], -1), vals[[1, 2, 0]])


def test_frontier_compact_partitions_the_mask_column():
    # a bool column beside 4-byte words: the partitioned mask is the
    # "lane < count" validity of the compacted block
    rng = np.random.default_rng(7)
    mask = torch.from_numpy(rng.random(333) < 0.4)
    ids = torch.arange(333, dtype=torch.int32)
    (out_ids, out_mask), cnt = frontier_compact((ids, mask), mask)
    assert torch.equal(out_mask, torch.arange(333) < cnt)
    assert torch.equal(out_ids[:int(cnt)], ids[mask]) and torch.equal(out_ids[int(cnt):], ids[~mask])


@pytest.mark.parametrize("m,c,a", [(300, 1, 8), (1000, 3, 33), (64, 2, 4), (200, 4, 0)])
def test_hyb_gather_plain_vs_reference(m, c, a):
    rng = np.random.default_rng(m + a)
    edges = rng.standard_normal((m, c)).astype(np.float32)
    starts = rng.integers(0, m, a).astype(np.int32)
    degs = rng.integers(0, 2 * PAD, a).astype(np.int32)
    want = np.asarray(j_gather_ref(jnp.asarray(edges), jnp.asarray(starts), jnp.asarray(degs)))
    got = hyb_gather(_columns(edges), torch.from_numpy(starts), torch.from_numpy(degs))
    assert len(got) == c and all(g.shape == (a, PAD) for g in got)
    np.testing.assert_array_equal(want, np.stack([g.numpy() for g in got], -1).reshape(a, PAD, c))


def test_hyb_gather_out_of_range_rows_read_zero():
    edges = torch.arange(1, 11, dtype=torch.int32)
    (out,) = hyb_gather((edges,), torch.tensor([-2, 8], dtype=torch.int32),
                        torch.tensor([4, 5], dtype=torch.int32))
    assert out[0, :4].tolist() == [0, 0, 1, 2] and out[1, :5].tolist() == [9, 10, 0, 0, 0]
    assert int(out[:, 5:].abs().sum()) == 0


def test_hyb_gather_flag_column_reads_false_past_degree():
    flags = torch.ones(300, dtype=torch.bool)
    words = torch.arange(300, dtype=torch.int32)
    w, f = hyb_gather((words, flags), torch.tensor([0, 250], dtype=torch.int32),
                      torch.tensor([128, 40], dtype=torch.int32))
    assert f.dtype == torch.bool and int(f[0].sum()) == 128 and int(f[1].sum()) == 40
    assert w[1, :40].tolist() == list(range(250, 290)) and int(w[1, 40:].abs().sum()) == 0


def test_cpu_wrappers_launch_nothing():
    before = (segment_spmm.launches, frontier_compact.launches, hyb_gather.launches)
    segment_spmm(torch.ones(3, 1), torch.zeros(3, dtype=torch.int32), 2)
    frontier_compact((torch.ones(3),), torch.ones(3, dtype=torch.bool))
    hyb_gather((torch.ones(3),), torch.zeros(1, dtype=torch.int32),
               torch.ones(1, dtype=torch.int32))
    assert (segment_spmm.launches, frontier_compact.launches, hyb_gather.launches) == before


def test_wrappers_raise_on_tensors_they_cannot_take():
    meta = torch.empty(4, 1, device="meta")
    with pytest.raises(ValueError):
        segment_spmm(meta, torch.empty(4, dtype=torch.int32, device="meta"), 3)
    with pytest.raises(ValueError):
        frontier_compact((meta[:, 0],), torch.empty(4, dtype=torch.bool, device="meta"))
    with pytest.raises(ValueError):
        hyb_gather((meta[:, 0],), torch.empty(1, dtype=torch.int32, device="meta"),
                   torch.empty(1, dtype=torch.int32, device="meta"))
    with pytest.raises(ValueError):
        segment_spmm(torch.ones(2, 1), torch.zeros(2, dtype=torch.int32), 2, combine="max")


def test_use_kernels_resolution():
    assert runtime.resolve_use_kernels("auto", torch.device("cpu")) is False
    assert runtime.resolve_use_kernels("auto", torch.device("cuda")) is True
    assert runtime.resolve_use_kernels(True, torch.device("cpu")) is True
    assert runtime.resolve_use_kernels(False, torch.device("cuda")) is False
    with pytest.raises(ValueError):
        runtime.resolve_use_kernels("atuo", torch.device("cpu"))


def test_kernel_sources_and_build_dir():
    names = sorted(p.stem for p in runtime.kernel_sources())
    assert names == ["embedding_bag", "flash_attention", "frontier_compact", "grouped_matmul",
                     "hyb_gather", "segment_spmm"]
    for src in runtime.kernel_sources():
        text = src.read_text()
        assert "Replaces repro/kernels/" in text and "3.35 TB/s" in text
        assert 'extern "C" int' in text
    d = runtime.build_dir()
    assert d.parent == runtime.BUILD_ROOT and d == runtime.build_dir()
    assert "sm_90a" in " ".join(runtime.NVCC_FLAGS)


def test_launch_errors_raise():
    runtime.check_launch("k", 0)
    with pytest.raises(RuntimeError):
        runtime.check_launch("k", 9)
