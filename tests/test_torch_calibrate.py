"""The port's offline calibration (``repro_torch.autotune`` probe, calibrate,
registry; ``repro_torch.launch.calibrate``) against ``repro.autotune`` on
the same inputs.

Contract:
* ``stats_for`` and ``model_probe`` equal the reference's bit for bit (the
  statistics are rounded once from Python floats to float32; the cost
  model is the eager reference's), with and without noise;
* ``calibrate`` reports equal field by field for the selfcheck's
  (initial, truth, noise) cases, and ``tune_thresholds`` picks and
  regrets equal, with Algorithm 1 evaluated in float64 as the reference
  does (a float32 evaluation picks differently on constructed costs);
* ``_materialize`` blocks and realized points, and ``wall_probe``'s
  realized points on the CPU, equal the reference's;
* profiles written by either package load in the other; corrupt,
  truncated and path-escaping profiles are rejected as the reference
  rejects them;
* ``launch.calibrate --selfcheck --device cpu`` prints the reference's
  regret numbers.
"""

import dataclasses
import importlib
import json
import math
import warnings

import numpy as np
import pytest
import torch

from repro.autotune import probe as jprobe
from repro.autotune import registry as jreg
from repro.core import constants as jconst
from repro.core import cost_model as jcm
from repro_torch.autotune import probe as tprobe
from repro_torch.autotune import registry as treg
from repro_torch.core import constants as tconst
from repro_torch.core import cost_model as tcm
from repro_torch.launch import calibrate as tlaunch

# the packages re-export the function ``calibrate`` under the module's name
jcal = importlib.import_module("repro.autotune.calibrate")
tcal = importlib.import_module("repro_torch.autotune.calibrate")

PROFILES = ("pcie3", "tpu_v5e_hbm", "tpu_v5e_ici")
# the selfcheck's (initial, truth, noise, seed): step 1, step 2, step 4's three
SELFCHECK_CASES = [
    ("pcie3", "tpu_v5e_hbm", 0.0, 0),
    ("tpu_v5e_hbm", "tpu_v5e_hbm", 0.0, 0),
    ("pcie3", "tpu_v5e_hbm", 0.05, 7),
    ("tpu_v5e_hbm", "pcie3", 0.0, 7),
    ("tpu_v5e_hbm", "tpu_v5e_hbm", 0.1, 7),
]


def _links(name):
    key = name.upper()
    return getattr(jconst, key), getattr(tconst, key)


def _same_link(j, t):
    assert dataclasses.asdict(j) == dataclasses.asdict(t)


def _tpoints(jpoints):
    return [tprobe.ProbePoint(**dataclasses.asdict(p)) for p in jpoints]


@pytest.fixture(scope="module")
def grids():
    jg = jprobe.default_grid()
    return jg, tprobe.default_grid()


# --------------------------------------------------------------------------
# profiles, grid, statistics, model probe
# --------------------------------------------------------------------------

@pytest.mark.parametrize("name", PROFILES)
def test_shipped_profiles_equal_the_reference(name):
    _same_link(*_links(name))


def test_default_grid_equals_the_reference(grids):
    jg, tg = grids
    assert [dataclasses.asdict(p) for p in jg] == [dataclasses.asdict(p) for p in tg]
    small = dict(edge_levels=(3.1e4, 1.1e5, 4.1e5), n_ratios=7)
    assert ([dataclasses.asdict(p) for p in jprobe.default_grid(**small)]
            == [dataclasses.asdict(p) for p in tprobe.default_grid(**small)])


@pytest.mark.parametrize("name", PROFILES)
def test_stats_for_rounds_once_as_the_reference(grids, name):
    jg, tg = grids
    jl, tl = _links(name)
    js, ts = jprobe.stats_for(jg, jl), tprobe.stats_for(tg, tl)
    for a, b in zip(js, ts):
        assert b.dtype == torch.float32 and b.device.type == "cpu"
        np.testing.assert_array_equal(np.asarray(a), b.numpy())
    # one rounding from the float64 request count, not two
    want = np.array([p.zc_requests(tl) for p in tg], np.float64).astype(np.float32)
    np.testing.assert_array_equal(ts.zc_requests.numpy(), want)


@pytest.mark.parametrize("truth", PROFILES)
@pytest.mark.parametrize("noise,seed", [(0.0, 0), (0.05, 7)])
def test_model_probe_seconds_bit_equal(grids, truth, noise, seed):
    jg, tg = grids
    jl, tl = _links(truth)
    jo = jprobe.model_probe(jg, jl, noise=noise, seed=seed)
    to = tprobe.model_probe(tg, tl, noise=noise, seed=seed)
    assert [(o.engine, o.seconds) for o in jo] == [(o.engine, o.seconds) for o in to]
    assert all(o.point is tg[i % len(tg)] for i, o in enumerate(to))


def test_observation_matrix_by_identity_then_value(grids):
    _, tg = grids
    obs = tprobe.model_probe(tg, tconst.PCIE3)
    m = tprobe.observation_matrix(tg, obs)
    assert m.shape == (len(tg), 3) and np.isfinite(m).all()
    # deserialized points (equal values, other objects) land in the same rows
    copies = [tprobe.Observation(point=dataclasses.replace(o.point), engine=o.engine,
                                 seconds=o.seconds) for o in obs]
    np.testing.assert_array_equal(tprobe.observation_matrix(tg, copies), m)
    partial = tprobe.observation_matrix(tg, obs[: len(tg)])
    assert np.isnan(partial[:, 1:]).all() and np.isfinite(partial[:, 0]).all()


# --------------------------------------------------------------------------
# fit, tuning, full calibration
# --------------------------------------------------------------------------

def _same_report(jr, tr):
    _same_link(jr.profile, tr.profile)
    _same_link(jr.initial, tr.initial)
    for f in ("static_regret", "calibrated_regret", "oracle_seconds", "n_observations",
              "n_points", "fitted"):
        assert getattr(jr, f) == getattr(tr, f), f
    assert jr.improved == tr.improved


@pytest.mark.parametrize("initial,truth,noise,seed", SELFCHECK_CASES)
def test_calibrate_reports_equal(grids, initial, truth, noise, seed):
    jg, tg = grids
    ji, ti = _links(initial)
    jt, tt = _links(truth)
    jr = jcal.calibrate(jg, jprobe.model_probe(jg, jt, noise=noise, seed=seed), ji)
    tr = tcal.calibrate(tg, tprobe.model_probe(tg, tt, noise=noise, seed=seed), ti)
    _same_report(jr, tr)
    np.testing.assert_array_equal(np.asarray(jcal.selection_on_grid(jg, jr.profile)),
                                  tcal.selection_on_grid(tg, tr.profile))


@pytest.mark.parametrize("initial,truth,noise,seed", SELFCHECK_CASES[:3])
def test_tune_thresholds_equal_on_the_selfcheck_grid(grids, initial, truth, noise, seed):
    jg, tg = grids
    ji, ti = _links(initial)
    jt, tt = _links(truth)
    jm = jprobe.observation_matrix(jg, jprobe.model_probe(jg, jt, noise=noise, seed=seed))
    tm = tprobe.observation_matrix(tg, tprobe.model_probe(tg, tt, noise=noise, seed=seed))
    np.testing.assert_array_equal(jm, tm)
    for min_gain in (0.01, 0.0):
        jp, jreg_ = jcal.tune_thresholds(jg, jm, ji, min_gain=min_gain)
        tp, treg_ = tcal.tune_thresholds(tg, tm, ti, min_gain=min_gain)
        _same_link(jp, tp)
        assert jreg_ == treg_


@pytest.mark.parametrize("fit_overhead", [False, True])
def test_fit_link_equal_on_wall_like_observations(fit_overhead):
    """Affine seconds with a per-call intercept and noise, as a wall probe
    gives: the float64 least squares equals the reference's."""
    jg = jprobe.default_grid(edge_levels=(3.1e4, 1.1e5, 4.1e5), n_ratios=7)
    tg = _tpoints(jg)
    rng = np.random.default_rng(3)
    secs = {}
    for i, p in enumerate(jg):
        for e in range(3):
            secs[i, e] = (4e-5 + p.total_edges * 4 / (5e11 if e == 0 else 2e11)
                          * p.ratio ** (e / 2)) * (1 + 0.05 * rng.standard_normal())
    jo = [jprobe.Observation(jg[i], e, s) for (i, e), s in secs.items()]
    to = [tprobe.Observation(tg[i], e, s) for (i, e), s in secs.items()]
    jl = jcal.fit_link(jg, jo, jconst.PCIE3, fit_overhead=fit_overhead)
    tl = tcal.fit_link(tg, to, tconst.PCIE3, fit_overhead=fit_overhead)
    _same_link(jl, tl)
    _same_report(jcal.calibrate(jg, jo, jconst.PCIE3, fit_overhead=fit_overhead),
                 tcal.calibrate(tg, to, tconst.PCIE3, fit_overhead=fit_overhead))


def _hazard_costs():
    """(N,) float32 costs (as float64) with, at each point, ``tec`` between
    ``alpha * tef`` rounded to float32 (float32 ``alpha``, float32 product)
    and the float64 product: ``tec`` is the float32 product where that lies
    below the float64 one, so ``tec < alpha * tef`` holds in float64 and
    fails in float32.  ``tiz`` is large, so the COMPACT test is decided by
    the product's precision alone; ``alpha`` is a candidate of the grid."""
    alpha = float(np.linspace(0.05, 1.0, 20)[15])
    rng = np.random.default_rng(0)
    tef, tec = [], []
    for t in rng.uniform(1e-4, 1e-2, 4096).astype(np.float32):
        p64 = alpha * float(t)
        p32 = np.float32(np.float32(alpha) * t)
        if float(p32) < p64:
            tef.append(float(t))
            tec.append(float(p32))
        if len(tef) == 8:
            break
    assert len(tef) == 8
    tef, tec = np.array(tef), np.array(tec)
    return alpha, tef, tec, tef * 1e3


def test_tune_thresholds_evaluates_algorithm1_in_float64():
    alpha, tef, tec, tiz = _hazard_costs()
    active = np.ones(len(tef), bool)
    # measured: COMPACT best where the float64 rule picks it, else FILTER
    measured = np.stack([tef * 2, tec, tiz], axis=1)
    alphas, betas = np.array([alpha, 0.5]), np.array([1.0, 1.0])
    want = np.asarray(jcm.algorithm1_engines(tef[None, :], tec[None, :], tiz[None, :],
                                             alphas[:, None], betas[:, None]))
    want = np.where(active[None, :], want, jcm.NONE)
    np.testing.assert_array_equal(
        tcal._threshold_regrets(tef, tec, tiz, active, measured, alphas, betas),
        jcal._regret_rows(want, measured))
    # float32 throughout (the runtime's select_engines arithmetic) picks
    # otherwise at every point
    f32 = tcm.algorithm1_engines(*(torch.tensor(a, dtype=torch.float32)
                                   for a in (tef, tec, tiz)),
                                 torch.tensor(alpha, dtype=torch.float32),
                                 torch.tensor(1.0, dtype=torch.float32)).numpy()
    f64 = want[0]
    assert (f64 != f32).all(), (f64, f32)
    assert set(f64.tolist()) <= {tcm.COMPACT, tcm.FILTER} and len(set(f64 ^ f32)) == 1


# --------------------------------------------------------------------------
# materialized probes
# --------------------------------------------------------------------------

SMALL_GRID = dict(edge_levels=(3.1e4, 4.1e5), n_ratios=3, regimes=("hub", "flat"))


@pytest.mark.parametrize("max_edges", [5_000, 200_000])
def test_materialize_equals_the_reference(max_edges):
    jg = jprobe.default_grid(**SMALL_GRID)
    for i, (jp, tp) in enumerate(zip(jg, _tpoints(jg))):
        jb, jop, jn, jr = jprobe._materialize(jp, max_edges, 11 + i)
        tb, top, tn, tr = tprobe._materialize(tp, max_edges, 11 + i, "cpu")
        assert jn == tn and dataclasses.asdict(jr) == dataclasses.asdict(tr)
        for a, b, dt in zip(jb, tb, (torch.int32, torch.int32, torch.float32, torch.bool)):
            assert b.dtype == dt
            np.testing.assert_array_equal(np.asarray(a), b.numpy())
        np.testing.assert_array_equal(np.asarray(jop), top.numpy())


def test_wall_probe_on_the_cpu_returns_the_reference_points():
    jg = jprobe.default_grid(**SMALL_GRID)[:6]
    jpts, jobs = jprobe.wall_probe(jg, max_edges=4_000, repeats=1, use_kernels=False)
    tpts, tobs = tprobe.wall_probe(_tpoints(jg), max_edges=4_000, repeats=1,
                                   use_kernels=False, device="cpu")
    assert [dataclasses.asdict(p) for p in jpts] == [dataclasses.asdict(p) for p in tpts]
    assert [(o.engine, dataclasses.asdict(o.point)) for o in jobs] == \
        [(o.engine, dataclasses.asdict(o.point)) for o in tobs]
    assert all(o.point is tpts[i // 3] for i, o in enumerate(tobs))
    assert all(math.isfinite(o.seconds) and o.seconds > 0 for o in tobs)
    m = tprobe.observation_matrix(tpts, tobs)
    assert np.isfinite(m).all()
    # a wall-probe fit goes through (PCIE3's shape; the CPU's numbers)
    rep = tcal.calibrate(tpts, tobs, tconst.PCIE3, fit_overhead=True)
    assert rep.calibrated_regret <= rep.static_regret and rep.n_observations == 18


# --------------------------------------------------------------------------
# registry
# --------------------------------------------------------------------------

@pytest.mark.parametrize("direction", ["reference_to_port", "port_to_reference"])
def test_registry_round_trip_across_packages(tmp_path, grids, direction):
    jg, tg = grids
    jr = jcal.calibrate(jg, jprobe.model_probe(jg, jconst.TPU_V5E_HBM), jconst.PCIE3)
    tr = tcal.calibrate(tg, tprobe.model_probe(tg, tconst.TPU_V5E_HBM), tconst.PCIE3)
    meta = {"static_regret": jr.static_regret}
    if direction == "reference_to_port":
        path = jreg.save_profile(jr.profile, device_kind="nvidia-h100-80gb-hbm3",
                                 base=tmp_path, meta=meta)
        loaded, got_meta = treg.load_profile("nvidia-h100-80gb-hbm3", tmp_path,
                                             with_meta=True)
        assert isinstance(loaded, tconst.LinkModel)
        _same_link(jr.profile, loaded)
        assert loaded == tr.profile
    else:
        path = treg.save_profile(tr.profile, device_kind="nvidia-h100-80gb-hbm3",
                                 base=tmp_path, meta=meta)
        loaded, got_meta = jreg.load_profile("nvidia-h100-80gb-hbm3", tmp_path,
                                             with_meta=True)
        _same_link(loaded, tr.profile)
        assert loaded == jr.profile
    assert path == tmp_path / "nvidia-h100-80gb-hbm3.json" and got_meta == meta
    doc = json.loads(path.read_text())
    assert doc["schema"] == 1 and doc["device_kind"] == "nvidia-h100-80gb-hbm3"
    np.testing.assert_array_equal(np.asarray(jcal.selection_on_grid(jg, jr.profile)),
                                  tcal.selection_on_grid(tg, treg.load_profile(
                                      "nvidia-h100-80gb-hbm3", tmp_path)))
    assert list(treg.list_profiles(tmp_path)) == list(jreg.list_profiles(tmp_path))
    assert treg.has_profile("nvidia-h100-80gb-hbm3", tmp_path)


def _good_doc():
    return {"schema": 1, "device_kind": "x",
            "profile": dataclasses.asdict(tconst.PCIE3), "meta": {}}


def _with(**profile):
    doc = _good_doc()
    doc["profile"].update(profile)
    return json.dumps(doc)


def _truncated():
    doc = _good_doc()
    del doc["profile"]["gamma"]
    return json.dumps(doc)


BAD_PROFILES = {
    "invalid_json": "{not json",
    "wrong_schema": json.dumps({**_good_doc(), "schema": 2}),
    "truncated": _truncated(),
    "alien_field": _with(warp_speed=9),
    "bad_value": _with(bandwidth=-1.0),
    "misaligned_granule": _with(m=130.0),
    "no_profile": json.dumps({"schema": 1}),
    "profile_not_a_dict": json.dumps({"schema": 1, "profile": [1, 2]}),
}


@pytest.mark.parametrize("case", sorted(BAD_PROFILES))
def test_corrupt_profiles_rejected_as_the_reference(tmp_path, case):
    (tmp_path / "x.json").write_text(BAD_PROFILES[case])
    with pytest.raises(Exception) as jerr:
        jreg.load_profile("x", tmp_path)
    with pytest.raises(type(jerr.value)):
        treg.load_profile("x", tmp_path)
    with warnings.catch_warnings(record=True) as jw:
        warnings.simplefilter("always")
        jgot = jreg.load_profile_or_default("x", tmp_path)
    with warnings.catch_warnings(record=True) as tw:
        warnings.simplefilter("always")
        tgot = treg.load_profile_or_default("x", tmp_path)
    _same_link(jgot, tgot)
    assert tgot == tconst.PCIE3
    assert [w.category for w in jw] == [w.category for w in tw] == [RuntimeWarning]
    assert str(tmp_path / "x.json") in str(tw[0].message)
    assert treg.list_profiles(tmp_path).keys() == jreg.list_profiles(tmp_path).keys()


@pytest.mark.parametrize("kind", ["../escape", "a/b", "..", ".", "", "x y"])
def test_path_escaping_kinds_rejected_as_the_reference(tmp_path, kind):
    for reg in (jreg, treg):
        with pytest.raises(ValueError, match="invalid device kind"):
            reg.profile_path(kind, tmp_path)
        with pytest.raises(ValueError, match="invalid device kind"):
            reg.save_profile(tconst.PCIE3 if reg is treg else jconst.PCIE3, kind, tmp_path)
        with pytest.raises(ValueError, match="invalid device kind"):
            reg.load_profile_or_default(kind, tmp_path)


def test_missing_profile_falls_back_silently_and_env_var_names_the_registry(
        tmp_path, monkeypatch):
    with warnings.catch_warnings():
        warnings.simplefilter("error")
        assert treg.load_profile_or_default("nobody", tmp_path) == tconst.PCIE3
    with pytest.raises(FileNotFoundError, match="repro_torch.launch.calibrate"):
        treg.load_profile("nobody", tmp_path)
    monkeypatch.setenv("REPRO_AUTOTUNE_REGISTRY", str(tmp_path / "env"))
    assert treg.registry_dir() == jreg.registry_dir() == tmp_path / "env"
    monkeypatch.delenv("REPRO_AUTOTUNE_REGISTRY")
    assert treg.registry_dir() == jreg.registry_dir()


def test_default_device_kind_raises_without_a_card():
    assert treg.default_device_kind("cpu") == "cpu" == jreg.default_device_kind()
    assert treg._sanitize("NVIDIA H100 80GB HBM3") == "nvidia-h100-80gb-hbm3"
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present: its kind is its name")
    for call in (treg.default_device_kind, lambda: treg.profile_path(),
                 lambda: treg.load_profile_or_default(),
                 lambda: treg.save_profile(tconst.PCIE3)):
        with pytest.raises(RuntimeError, match="no CUDA device"):
            call()


# --------------------------------------------------------------------------
# launcher
# --------------------------------------------------------------------------

def test_selfcheck_on_cpu_prints_the_reference_numbers(capsys):
    tlaunch.main(["--selfcheck", "--device", "cpu"])
    out = capsys.readouterr().out
    assert "mis-specified: regret 7.718e-04 -> 4.832e-08 (oracle total 3.775e-03 s)" in out
    assert "correctly-specified: no-op (0/108 decisions changed)" in out
    assert "online loop (cpu): SSSP bit-identical" in out
    assert out.rstrip().endswith("SELFCHECK OK")


def test_model_mode_cli_saves_under_the_simulation_and_loads_in_the_reference(
        tmp_path, capsys):
    tlaunch.main(["--mode", "model", "--truth", "tpu_v5e_hbm", "--registry",
                  str(tmp_path)])
    out = capsys.readouterr().out
    assert "model-tpu_v5e_hbm" in out and "regret: static 7.718e-04 s" in out
    jg = jprobe.default_grid()
    want = jcal.calibrate(jg, jprobe.model_probe(jg, jconst.TPU_V5E_HBM), jconst.PCIE3)
    _same_link(want.profile, jreg.load_profile("model-tpu_v5e_hbm", tmp_path))
    tlaunch.main(["--mode", "model", "--dry-run", "--registry", str(tmp_path / "dry"),
                  "--device-kind", "k"])
    assert not (tmp_path / "dry").exists()
