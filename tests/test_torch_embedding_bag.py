"""The port's ``embedding_bag`` (the CPU wrapper, which runs the plain
version, and the plain version itself) against the reference's oracle
``repro.kernels.embedding_bag.ref.embedding_bag_ref`` (the gather engine of
``repro.models.embedding``: ``jnp.take`` and a reduce), on the same inputs.
The Pallas body itself raises under jax 0.9.0 (no ``pl.load``), so the
oracle is the reference.  The CUDA kernel against the plain version is in
``test_torch_kernels_cuda.py``.

Tolerances.  A bag of one row, and every max, are exact: the row is copied
(bit for bit).  Sums and means of L > 1 float32 rows: ``rtol = 1e-6``,
``atol = 1e-6 * L`` (the same float32 sum in another order; each of the L
additions rounds once).  bfloat16 tables: both
sum in float32 and round once, so a result may sit one bfloat16 step
apart, ``rtol = 2^-7``.  Out-of-range ids give NaN in the same places.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels.embedding_bag.ref import embedding_bag_ref as jax_bag
from repro_torch.kernels.embedding_bag.ops import embedding_bag
from repro_torch.kernels.embedding_bag.ref import embedding_bag_ref

FNS = {"wrapper": embedding_bag, "plain": embedding_bag_ref}
MODES = ["sum", "mean", "max"]


def _inputs(V, D, B, L, seed, lo=0, hi=None, dtype="float32"):
    rng = np.random.default_rng(seed)
    table = rng.standard_normal((V, D)).astype(np.float32)
    ids = rng.integers(lo, V if hi is None else hi, (B, L)).astype(np.int32)
    t = torch.from_numpy(table).to(getattr(torch, dtype))
    # the same (rounded) values for the reference
    return t, torch.from_numpy(ids), jnp.asarray(t.float().numpy(), getattr(jnp, dtype)), \
        jnp.asarray(ids)


def _want(jt, jids, mode):
    return np.asarray(jax_bag(jt, jids, mode=mode).astype(jnp.float32))


def _check(got, want, exact, L, dtype="float32"):
    got = got.float().numpy()
    assert got.shape == want.shape
    if exact:
        np.testing.assert_array_equal(got, want)
    elif dtype == "bfloat16":
        np.testing.assert_allclose(got, want, rtol=2**-7, atol=1e-6)
    else:
        np.testing.assert_allclose(got, want, rtol=1e-6, atol=1e-6 * L)


# tests/test_kernels.py's sweep, plus a multi-hot bag of 100 (the largest
# of MLPerf's DLRM-DCNv2 Criteo setup) and an odd width
@pytest.mark.parametrize("V,D,B,L", [(100, 16, 8, 1), (500, 48, 40, 4), (64, 128, 16, 8),
                                     (1000, 128, 33, 100), (77, 13, 9, 3)])
@pytest.mark.parametrize("mode", MODES)
@pytest.mark.parametrize("fn", list(FNS))
def test_embedding_bag_sweep_matches_reference(V, D, B, L, mode, fn):
    t, ids, jt, jids = _inputs(V, D, B, L, seed=V + D)
    got = FNS[fn](t, ids, mode=mode)
    assert got.dtype == torch.float32
    _check(got, _want(jt, jids, mode), exact=L == 1 or mode == "max", L=L)


@pytest.mark.parametrize("L", [1, 100])
@pytest.mark.parametrize("mode", MODES)
def test_embedding_bag_bfloat16_table(L, mode):
    """The reference's jnp.sum and jnp.mean upcast bfloat16 to float32 and
    round once; so does the port."""
    t, ids, jt, jids = _inputs(300, 64, 24, L, seed=L, dtype="bfloat16")
    got = embedding_bag(t, ids, mode=mode)
    assert got.dtype == torch.bfloat16
    _check(got, _want(jt, jids, mode), exact=L == 1 or mode == "max", L=L, dtype="bfloat16")


@pytest.mark.parametrize("mode", MODES)
def test_embedding_bag_wrapped_and_out_of_range_ids(mode):
    """jnp.take's default mode: ids in [-V, 0) wrap, the rest give NaN rows,
    which the reduce carries into the whole bag."""
    t, ids, jt, jids = _inputs(50, 24, 64, 3, seed=7, lo=-120, hi=120)
    want = _want(jt, jids, mode)
    assert np.isnan(want).any() and not np.isnan(want).all()
    for fn in FNS.values():
        got = fn(t, ids, mode=mode)
        _check(got, want, exact=mode == "max", L=3)
        np.testing.assert_array_equal(np.isnan(got.numpy()), np.isnan(want))


@pytest.mark.parametrize("mode", MODES)
def test_embedding_bag_int64_ids_match_int32(mode):
    t, ids, _, _ = _inputs(200, 32, 16, 5, seed=8, lo=-200)
    assert torch.equal(embedding_bag(t, ids.long(), mode=mode), embedding_bag(t, ids, mode=mode))


@pytest.mark.parametrize("mode", MODES)
def test_embedding_bag_no_bags(mode):
    t, ids, jt, jids = _inputs(40, 16, 0, 4, seed=9)
    for fn in FNS.values():
        got = fn(t, ids, mode=mode)
        assert got.shape == (0, 16) and got.dtype == torch.float32
    assert _want(jt, jids, mode).shape == (0, 16)


def test_embedding_bag_empty_bags():
    """L = 0: the reference's sum is 0 and its mean NaN; its max raises (a
    zero-size reduction), and so does the port's."""
    t, ids, jt, jids = _inputs(40, 16, 5, 0, seed=10)
    for mode in ("sum", "mean"):
        want = _want(jt, jids, mode)
        for fn in FNS.values():
            np.testing.assert_array_equal(fn(t, ids, mode=mode).numpy(), want)
    assert np.isnan(_want(jt, jids, "mean")).all() and not _want(jt, jids, "sum").any()
    with pytest.raises(ValueError):
        _want(jt, jids, "max")
    for fn in FNS.values():
        with pytest.raises(ValueError, match="empty bag|zero-size"):
            fn(t, ids, mode="max")


def test_embedding_bag_wrapper_rejects_bad_inputs():
    t, ids, _, _ = _inputs(40, 16, 5, 2, seed=11)
    bad = [
        (lambda: embedding_bag(t, ids, mode="min"), "mode"),
        (lambda: embedding_bag(t, ids[:, 0]), r"\(B, L\)"),
        (lambda: embedding_bag(t[0], ids), r"\(V, D\)"),
        (lambda: embedding_bag(t.half(), ids), "float32 or bfloat16"),
        (lambda: embedding_bag(t.double(), ids), "float32 or bfloat16"),
        (lambda: embedding_bag(t, ids.float()), "int32 or int64"),
        (lambda: embedding_bag(t, ids.short()), "int32 or int64"),
        # a tensor off the CPU gets the kernel or an error, never the plain version
        (lambda: embedding_bag(t.to("meta"), ids.to("meta")), "no kernel for meta"),
        (lambda: embedding_bag(t, ids.to("meta")), "tensors on"),
    ]
    for call, match in bad:
        with pytest.raises(ValueError, match=match):
            call()
    before = embedding_bag.launches
    embedding_bag(t, ids)
    assert embedding_bag.launches == before   # the CPU runs the plain version
