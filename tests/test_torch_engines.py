"""The port's three engines against ``repro.core.engines`` with
``use_kernels=False`` on random blocks drawn with numpy.  MIN and peeling
are bit-exact; SUM agrees within ``atol=1e-5`` (float32 sums of the same
messages).  The port's kernel path (``use_kernels=True``, plain kernel
bodies on the CPU) must give the same answers as its oracle path."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import engines as je
from repro.graph import algorithms as jalg
from repro_torch.core import engines as te
from repro_torch.graph import algorithms as talg

PROGRAMS = ["sssp", "bfs", "cc", "pagerank", "php", "kcore"]
ENGINES = ["relax_filter", "relax_compact", "relax_zerocopy"]


def _block(seed, B=700, n=300, density=0.3):
    rng = np.random.default_rng(seed)
    src = rng.integers(0, n, B).astype(np.int32)
    dst = rng.integers(0, n, B).astype(np.int32)
    w = rng.integers(1, 64, B).astype(np.float32)
    w[-37:] = np.inf                       # padding lanes
    active = rng.random(B) < density
    active[-37:] = False
    operand = rng.random(n).astype(np.float32) * 10
    operand[rng.random(n) < 0.2] = np.inf  # unreached vertices
    return n, (src, dst, w, active), operand


@pytest.mark.parametrize("name", PROGRAMS)
@pytest.mark.parametrize("engine", ENGINES)
@pytest.mark.parametrize("use_kernels", [False, True])
@pytest.mark.parametrize("density", [0.0, 0.3, 1.0])
def test_engine_matches_reference_oracle(name, engine, use_kernels, density):
    pj, pt = jalg.ALGORITHMS[name], talg.ALGORITHMS[name]
    n, arrays, operand = _block(PROGRAMS.index(name) * 3 + ENGINES.index(engine), density=density)
    if pj.combine == jalg.SUM:
        operand = np.where(np.isinf(operand), 0.0, operand).astype(np.float32)
    want = getattr(je, engine)(je.EdgeBlock(*map(jnp.asarray, arrays)),
                               jnp.asarray(operand), n, pj, use_kernels=False)
    got = getattr(te, engine)(te.EdgeBlock(*map(torch.from_numpy, arrays)),
                              torch.from_numpy(operand), n, pt, use_kernels=use_kernels)
    np.testing.assert_array_equal(np.asarray(want.touched), got.touched.numpy())
    if pj.combine == jalg.MIN or pj.peel_k is not None:
        np.testing.assert_array_equal(np.asarray(want.agg), got.agg.numpy())
    else:
        np.testing.assert_allclose(np.asarray(want.agg), got.agg.numpy(), rtol=0, atol=1e-5)


@pytest.mark.parametrize("engine_id", [-1, 0, 1, 2])
def test_relax_with_engine_dispatch(engine_id):
    n, arrays, operand = _block(5)
    block = te.EdgeBlock(*map(torch.from_numpy, arrays))
    op = torch.from_numpy(operand)
    got = te.relax_with_engine(engine_id, block, op, n, talg.SSSP)
    want = te.ENGINE_FNS[max(engine_id, 0)](block, op, n, talg.SSSP)
    assert torch.equal(got.agg, want.agg) and torch.equal(got.touched, want.touched)
    jwant = je.relax_with_engine(jnp.int32(engine_id), je.EdgeBlock(*map(jnp.asarray, arrays)),
                                 jnp.asarray(operand), n, jalg.SSSP)
    np.testing.assert_array_equal(np.asarray(jwant.agg), got.agg.numpy())


def test_compact_kernel_path_keeps_large_ids():
    # raw int32 words: ids past 2**24 survive the compaction exactly
    n = 2**25
    src = np.array([2**24 + 1, 3, 2**25 - 1], np.int32)
    dst = np.array([2**24 + 3, 2**25 - 2, 5], np.int32)
    w = np.array([1.0, 2.0, 3.0], np.float32)
    active = np.array([True, False, True])
    operand = torch.zeros(n)
    for kernels in (False, True):
        out = te.relax_compact(te.EdgeBlock(*map(torch.from_numpy, (src, dst, w, active))),
                               operand, n, talg.SSSP, use_kernels=kernels)
        assert out.touched.nonzero().flatten().tolist() == [5, 2**24 + 3]
        assert out.agg[2**24 + 3] == 1.0 and out.agg[5] == 3.0
