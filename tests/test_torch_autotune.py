"""The port's online engine-cost feedback against ``repro.autotune.feedback``
and ``repro.core.hytm``'s autotune wiring, on the same inputs.

Contract:
* ``OnlineCalibrator``: the same (modeled, measured) stream gives the same
  ``correction()``, ``observed()`` and ``n_updates`` bit for bit (the
  arithmetic is NumPy float64 in both), also where the reference misses
  its own ratio property (ROADMAP queue 3);
* ``run_hytm(autotune=True)``: traversal values bit-identical to autotune
  off; SUM within 1e-3 (the reference's own bound, tests/test_autotune.py);
* under a scripted calibrator that ignores the clock, both packages pick
  the same engines bit for bit and feed it the same skip flags; the
  per-engine modeled seconds they feed it agree within rtol 1e-6 (the
  reference's cost model is jitted: its floats may differ in the last
  place, ROADMAP's hazards).
The reference runs with ``use_kernels=False`` (its Pallas bodies do not run
under the installed jax); the port runs its oracle engines and its kernel
wrappers (plain bodies on the CPU).
"""

import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from hypothesis import given, settings
from hypothesis import strategies as st

from repro.autotune.feedback import OnlineCalibrator as JCalibrator
from repro.core import hytm as jh
from repro.graph import algorithms as jalg
from repro.graph import generators as jgen
from repro_torch import convert
from repro_torch.autotune import N_ENGINES, OnlineCalibrator
from repro_torch.core import hytm as th
from repro_torch.graph import algorithms as talg

MODELED_RTOL = 1e-6
SUM_ATOL = 1e-3


def _tconfig(cfg: jh.HyTMConfig, **kw) -> th.HyTMConfig:
    fields = {f.name for f in dataclasses.fields(th.HyTMConfig)} - {"link", "ici_link"}
    vals = {k: getattr(cfg, k) for k in fields}
    vals.update(kw)
    return th.HyTMConfig(link=convert.link_model(dataclasses.asdict(cfg.link)), **vals)


def _same_calibrators(a: JCalibrator, b: OnlineCalibrator) -> None:
    assert a.n_updates == b.n_updates
    np.testing.assert_array_equal(a.observed(), b.observed())
    ca, cb = a.correction(), b.correction()
    assert ca.dtype == cb.dtype and ca.shape == cb.shape == (N_ENGINES,)
    np.testing.assert_array_equal(ca, cb)


# --------------------------------------------------------------------------
# OnlineCalibrator
# --------------------------------------------------------------------------

_modeled = st.lists(
    st.one_of(st.just(0.0), st.floats(1e-9, 1e3)), min_size=N_ENGINES,
    max_size=N_ENGINES)
_measured = st.one_of(st.floats(1e-7, 1e2), st.just(0.0), st.just(-1.0),
                      st.just(float("nan")), st.just(float("inf")))


@settings(deadline=None, max_examples=20)
@given(decay=st.floats(0.01, 1.0), ridge=st.one_of(st.just(0.0), st.floats(1e-6, 1.0)),
       lo=st.floats(1e-3, 0.5), hi=st.floats(1.5, 100.0),
       stream=st.lists(st.tuples(_modeled, _measured), min_size=1, max_size=40))
def test_calibrator_matches_reference_on_streams(decay, ridge, lo, hi, stream):
    """Drawn decay, ridge, clip and streams with zero modeled engines,
    all-zero (norm 0) rows and negative, zero, NaN and infinite walls."""
    a = JCalibrator(decay=decay, ridge=ridge, clip=(lo, hi))
    b = OnlineCalibrator(decay=decay, ridge=ridge, clip=(lo, hi))
    _same_calibrators(a, b)
    for modeled, measured in stream:
        a.update(np.array(modeled), measured)
        b.update(np.array(modeled), measured)
        _same_calibrators(a, b)


def _ratio_stream(cal, scale: float, ratio: float) -> np.ndarray:
    """tests/test_autotune.py's stream: measured = scale * (T_f + ratio *
    T_z), COMPACT never observed."""
    rng = np.random.default_rng(0)
    for _ in range(60):
        t = np.array([rng.uniform(0.5, 2.0), 0.0, rng.uniform(0.5, 2.0)])
        cal.update(t, scale * (t[0] + ratio * t[2]))
    return cal.correction()


def _ratio_property(c: np.ndarray, ratio: float, clip: tuple) -> bool:
    """tests/test_autotune.py::test_online_calibrator_learns_relative_ratio."""
    want = min(ratio, 400.0)
    ends = clip[1] / clip[0]
    return bool(c[1] == 1.0 and (abs(c[2] / c[0] - want) <= 0.25 * want
                                 or abs(c[2] / c[0] - ends) <= 1e-6 * ends))


def test_calibrator_ratio_grid_matches_reference():
    """13 scales x 14 ratios over the reference property test's ranges:
    the corrections are equal at all 182 points, so the port misses the
    ratio property exactly where the reference does (at wall scales of
    1.8e-4 and below: its ridge prior is not scale-free)."""
    misses_ref, misses_port = set(), set()
    for scale in np.geomspace(1e-6, 1e3, 13):
        for ratio in np.geomspace(1.0, 2000.0, 14):
            a, b = JCalibrator(decay=0.2, ridge=1e-4), OnlineCalibrator(decay=0.2, ridge=1e-4)
            ca, cb = _ratio_stream(a, scale, ratio), _ratio_stream(b, scale, ratio)
            np.testing.assert_array_equal(ca, cb)
            if not _ratio_property(ca, ratio, a.clip):
                misses_ref.add((scale, ratio))
            if not _ratio_property(cb, ratio, b.clip):
                misses_port.add((scale, ratio))
    assert misses_port == misses_ref
    assert len(misses_ref) == 29
    assert max(s for s, _ in misses_ref) < 1e-3


def test_calibrator_observe_returns_float32_on_the_device_and_skips():
    cal = OnlineCalibrator()
    ref = torch.zeros(4)
    out = cal.observe_iteration(ref, torch.tensor([1.0, 0.0, 2.0]), 0.0, skip=True)
    assert cal.n_updates == 0 and out.dtype == torch.float32 and out.device == ref.device
    assert torch.equal(out, torch.ones(3))
    out = cal.observe_chunk(ref, np.array([1.0, 0.0, 2.0]), 0.0)
    assert cal.n_updates == 1
    np.testing.assert_array_equal(out.numpy(), cal.correction().astype(np.float32))


def test_calibrator_obs_and_bad_decay_raise():
    # obs= is ported (tests/test_torch_obs.py): one event a folded update
    from repro_torch.obs import TraceRecorder

    rec = TraceRecorder()
    cal = OnlineCalibrator(obs=rec)
    cal.update(np.array([1.0, 0.0, 2.0]), 0.5)
    assert [e.name for e in rec.events] == ["correction_update"]
    assert rec.metrics.counter("autotune.updates").total() == 1
    with pytest.raises(ValueError):
        OnlineCalibrator(decay=0.0)
    with pytest.raises(ValueError, match=r"\(3,\)"):
        OnlineCalibrator().update(np.ones(4), 1.0)


# --------------------------------------------------------------------------
# run_hytm with autotune
# --------------------------------------------------------------------------

@pytest.mark.parametrize("K", [1, 4])
@pytest.mark.parametrize("use_kernels", [False, True])
def test_run_hytm_autotune_traversal_bit_identical(K, use_kernels):
    """tests/test_autotune.py:232's contract on the port."""
    g = jgen.rmat_graph(800, 8000, seed=21)
    cfg = th.HyTMConfig(n_partitions=8, sync_every=K, use_kernels=use_kernels)
    base = th.run_hytm(g, talg.SSSP, 0, cfg, device="cpu")
    tuned = th.run_hytm(g, talg.SSSP, 0, dataclasses.replace(cfg, autotune=True),
                        device="cpu")
    np.testing.assert_array_equal(base.values, tuned.values)
    assert tuned.engine_corrections is not None
    assert tuned.engine_corrections.shape == (3,)
    assert np.all(tuned.engine_corrections > 0)
    assert tuned.history["mispredictions"].shape == (tuned.iterations,)
    assert tuned.total_mispredictions >= 0
    assert base.engine_corrections is None
    assert "mispredictions" in base.history


def test_run_hytm_autotune_accumulative_tolerance_bounded():
    g = jgen.rmat_graph(800, 8000, seed=4)
    pr = dataclasses.replace(talg.PAGERANK, tolerance=1e-7)
    cfg = th.HyTMConfig(n_partitions=8)
    base = th.run_hytm(g, pr, None, cfg, device="cpu")
    tuned = th.run_hytm(g, pr, None, dataclasses.replace(cfg, autotune=True), device="cpu")
    assert np.max(np.abs((base.values + base.delta) - (tuned.values + tuned.delta))) < SUM_ATOL


def test_run_hytm_external_calibrator_keeps_learning():
    """An external calibrator is started from and learned into across runs
    (a service keeps one for its lifetime); without autotune it is not
    read."""
    g = jgen.rmat_graph(600, 5000, seed=3)
    cfg = th.HyTMConfig(n_partitions=8, sync_every=1, autotune=True)
    cal = OnlineCalibrator()
    r1 = th.run_hytm(g, talg.SSSP, 0, cfg, calibrator=cal, device="cpu")
    n1 = cal.n_updates
    assert n1 == r1.iterations - 1  # iteration 1 is not observed
    r2 = th.run_hytm(g, talg.SSSP, 0, cfg, calibrator=cal, device="cpu")
    assert cal.n_updates == n1 + r2.iterations - 1
    np.testing.assert_array_equal(r2.engine_corrections, cal.correction())
    off = th.run_hytm(g, talg.SSSP, 0, dataclasses.replace(cfg, autotune=False),
                      calibrator=object(), device="cpu")
    np.testing.assert_array_equal(off.values, r2.values)
    assert off.engine_corrections is None


# --------------------------------------------------------------------------
# Scripted calibrator: both packages, the same corrections
# --------------------------------------------------------------------------

# corrections steering Algorithm 1 away from the model's own picks
SCRIPT = ([1.0, 1.0, 1.0], [8.0, 0.25, 1.0], [0.1, 6.0, 3.0], [1.0, 12.0, 0.05],
          [0.05, 1.0, 20.0])


class Scripted:
    """Ignores the clock: returns ``SCRIPT``'s corrections in turn (as the
    package's float32 device array) and records what it was fed."""

    def __init__(self, as_array):
        self.as_array = as_array
        self.calls = []

    def correction(self) -> np.ndarray:
        return np.asarray(SCRIPT[len(self.calls) % len(SCRIPT)], np.float64)

    def observe_iteration(self, sync_ref, modeled, t_start, skip=False):
        self.calls.append((np.asarray(modeled, np.float64), bool(skip)))
        return self.as_array(self.correction())

    observe_chunk = observe_iteration


@pytest.mark.parametrize("K", [1, 4])
@pytest.mark.parametrize("name", ["sssp", "pagerank"])
def test_scripted_calibrator_same_picks_as_reference(monkeypatch, K, name):
    monkeypatch.setattr(jh, "_WARM_SIGNATURES", set())
    monkeypatch.setattr(th, "_WARM_SIGNATURES", set())
    g = jgen.rmat_graph(600, 5000, seed=3)
    pj = dataclasses.replace(jalg.ALGORITHMS[name], tolerance=1e-5)
    pt = dataclasses.replace(talg.ALGORITHMS[name], tolerance=1e-5)
    src = None if pj.use_delta else 0
    jcfg = jh.HyTMConfig(n_partitions=8, sync_every=K, use_kernels=False, autotune=True,
                         cds_mode="delta" if pj.use_delta else "hub")
    jcal = Scripted(lambda c: jnp.asarray(c, jnp.float32))
    want = jh.run_hytm(g, pj, source=src, config=jcfg, calibrator=jcal)
    for use_kernels in (False, True):
        tcal = Scripted(lambda c: torch.from_numpy(c.astype(np.float32)))
        got = th.run_hytm(g, pt, src, _tconfig(jcfg, use_kernels=use_kernels),
                          calibrator=tcal, device="cpu")
        assert got.iterations == want.iterations
        np.testing.assert_array_equal(got.history["engines"], want.history["engines"])
        np.testing.assert_array_equal(got.history["mispredictions"],
                                      want.history["mispredictions"])
        assert [s for _, s in tcal.calls] == [s for _, s in jcal.calls]
        for (mt, _), (mj, _) in zip(tcal.calls, jcal.calls):
            np.testing.assert_allclose(mt, mj, rtol=MODELED_RTOL)
        np.testing.assert_array_equal(got.engine_corrections, want.engine_corrections)
        if pt.combine == talg.MIN:
            np.testing.assert_array_equal(got.values, want.values)
            assert got.total_transfer_bytes == want.total_transfer_bytes
        else:
            np.testing.assert_allclose(got.values + got.delta, want.values + want.delta,
                                       rtol=0, atol=1e-5)
    # the skip flags follow _consume_warm: K=1 skips iteration 1, the
    # chunked driver the first dispatch of a fresh signature only
    skips = [s for _, s in jcal.calls]
    assert skips[0] and not any(skips[1:])
    assert len(skips) == (want.iterations if K == 1 else -(-want.iterations // K))
    # a second run of the same signature is warm from its first chunk
    if K > 1:
        again = Scripted(lambda c: torch.from_numpy(c.astype(np.float32)))
        th.run_hytm(g, pt, src, _tconfig(jcfg), calibrator=again, device="cpu")
        assert not again.calls[0][1]


def test_consume_warm_registry():
    reg = set()
    assert not th._consume_warm(("a", 1), reg)
    assert th._consume_warm(("a", 1), reg)
    assert not th._consume_warm(("a", 2), reg)
