"""The port's ``grouped_matmul`` against the reference's oracle
``grouped_matmul_ref`` on the same inputs.  The reference's Pallas body
raises under jax 0.9.0 (it uses ``pl.load``/``pl.store``), so its oracle is
the reference here.  On the CPU the port's wrapper runs its plain version;
the CUDA kernel against that plain version is in
``test_torch_kernels_cuda.py``.

Tolerances: float32 bit for bit where a group's sums run in the same order
(a depth of 1: one product), else ``rtol = 1e-6`` with ``atol = 1e-6 *
sqrt(D)`` (the same products summed in another order); bfloat16 within one
bfloat16 rounding of the float32 result (``rtol = 2^-8``), since both
upcast, sum in float32 and round once.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels.grouped_matmul.ref import grouped_matmul_ref as jax_gmm_ref
from repro_torch.kernels.grouped_matmul.ops import grouped_matmul
from repro_torch.kernels.grouped_matmul.ref import grouped_matmul_ref

TORCH = {"float32": torch.float32, "bfloat16": torch.bfloat16}
JAX = {"float32": jnp.float32, "bfloat16": jnp.bfloat16}


def _groups(rng, T, E, gaps=True):
    """Ascending, disjoint groups covering part of [0, T): some empty, some
    rows between and after them outside every group."""
    counts = rng.integers(0, max(2 * T // max(E, 1), 1) + 1, E)
    counts[rng.random(E) < 0.25] = 0
    gap = rng.integers(0, 3, E) if gaps else np.zeros(E, dtype=np.int64)
    starts = np.cumsum(gap + np.concatenate([[0], counts[:-1]]))
    # keep every group inside [0, T)
    counts = np.clip(np.minimum(counts, T - starts), 0, None)
    starts = np.minimum(starts, T)
    return starts.astype(np.int32), counts.astype(np.int32)


def _inputs(T, D, E, F, dtype, seed, gaps=True):
    rng = np.random.default_rng(seed)
    x = rng.standard_normal((T, D)).astype(np.float32)
    w = (rng.standard_normal((E, D, F)) / np.sqrt(max(D, 1))).astype(np.float32)
    starts, counts = _groups(rng, T, E, gaps)
    tx, tw = (torch.from_numpy(a).to(TORCH[dtype]) for a in (x, w))
    # the same (rounded) values for the reference
    jx, jw = (jnp.asarray(a.float().numpy(), JAX[dtype]) for a in (tx, tw))
    return (tx, tw, torch.from_numpy(starts), torch.from_numpy(counts)), (
        jx, jw, jnp.asarray(starts), jnp.asarray(counts))


def _want(j):
    return np.asarray(jax_gmm_ref(*j).astype(jnp.float32))


# (T, D, E, F): the reference's sweep shapes, F not a multiple of 64, E = 1,
# more experts than rows, a depth of 1
CASES = [(64, 32, 3, 16), (256, 128, 8, 64), (200, 48, 5, 100), (130, 64, 1, 70),
         (33, 16, 40, 24), (97, 1, 6, 13)]


@pytest.mark.parametrize("T,D,E,F", CASES)
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_grouped_matmul_matches_reference_oracle(T, D, E, F, dtype):
    t, j = _inputs(T, D, E, F, dtype, seed=T + D + E)
    got = grouped_matmul(*t)
    assert got.dtype == TORCH[dtype] and got.shape == (T, F)
    want = _want(j)
    if dtype == "bfloat16":
        np.testing.assert_allclose(got.float().numpy(), want, rtol=2**-8, atol=1e-6)
    elif D == 1:
        np.testing.assert_array_equal(got.numpy(), want)  # one product: the same order
    else:
        np.testing.assert_allclose(got.numpy(), want, rtol=1e-6, atol=1e-6 * np.sqrt(D))


def test_grouped_matmul_rows_outside_every_group_are_zero():
    t, j = _inputs(120, 32, 6, 40, "float32", seed=3)
    x, w, starts, counts = t
    got = grouped_matmul(x, w, starts, counts).numpy()
    inside = np.zeros(120, dtype=bool)
    for s, c in zip(starts.tolist(), counts.tolist()):
        inside[s:s + c] = True
    assert (~inside).any() and inside.any()
    assert not got[~inside].any()
    assert np.abs(got[inside]).min(axis=1).max() > 0


def test_grouped_matmul_bounds_groups_at_max_rows():
    """``max_rows`` (the MoE capacity) cuts each group to its first rows; the
    result is the reference's on the cut counts."""
    t, _ = _inputs(150, 24, 4, 30, "float32", seed=4, gaps=False)
    x, w, starts, counts = t
    C = int(counts.max()) // 2
    got = grouped_matmul(x, w, starts, counts, max_rows=C)
    cut = counts.clamp(max=C)
    want = jax_gmm_ref(*(jnp.asarray(a.numpy()) for a in (x, w, starts, cut)))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-6, atol=1e-5)
    assert torch.equal(grouped_matmul(x, w, starts, counts, max_rows=0),
                       torch.zeros(150, 30))


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_grouped_matmul_empty_inputs(dtype):
    dt = TORCH[dtype]
    starts = torch.zeros(3, dtype=torch.int32)
    got = grouped_matmul(torch.zeros(0, 8, dtype=dt), torch.ones(3, 8, 5, dtype=dt), starts,
                         starts)
    assert got.shape == (0, 5) and got.dtype == dt
    # every expert empty: all rows zero
    x = torch.ones(10, 8, dtype=dt)
    assert not grouped_matmul(x, torch.ones(3, 8, 5, dtype=dt), starts, starts).any()


def test_grouped_matmul_plain_version_is_the_wrapper_on_cpu():
    from repro_torch.kernels.grouped_matmul import ops

    t, _ = _inputs(90, 16, 5, 20, "float32", seed=5)
    before = grouped_matmul.launches
    assert torch.equal(grouped_matmul(*t, max_rows=7), grouped_matmul_ref(*t, max_rows=7))
    assert grouped_matmul.launches == before  # a CPU call launches no kernel
    assert ops.grouped_matmul is grouped_matmul


@pytest.mark.parametrize("bad", ["rank", "depth", "dtype", "mixed", "starts_dtype",
                                 "counts_shape", "strided_counts", "max_rows"])
def test_grouped_matmul_rejects_bad_inputs(bad):
    x, w = torch.zeros(8, 4), torch.zeros(2, 4, 3)
    starts = torch.zeros(2, dtype=torch.int32)
    counts = torch.zeros(2, dtype=torch.int32)
    kw = {}
    if bad == "rank":
        x = x[None]
    elif bad == "depth":
        w = torch.zeros(2, 5, 3)
    elif bad == "dtype":
        x, w = x.half(), w.half()
    elif bad == "mixed":
        w = w.bfloat16()
    elif bad == "starts_dtype":
        starts = starts.long()
    elif bad == "counts_shape":
        counts = torch.zeros(3, dtype=torch.int32)
    elif bad == "strided_counts":
        counts = torch.zeros(4, dtype=torch.int32)[::2]
    else:
        kw["max_rows"] = -1
    with pytest.raises(ValueError, match="grouped_matmul"):
        grouped_matmul(x, w, starts, counts, **kw)
