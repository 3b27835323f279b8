"""Fit a :class:`LinkModel` to measured engine costs (the "fit" half).

Two stages, mirroring how the paper tunes its platform constants (§V-A
"alpha and beta are tuned empirically per platform"):

1. **Parameter fit** (:func:`fit_link`) — least squares on the smooth
   (de-ceiled) forms of Eqs. 1-3:

   * FILTER observations are affine in the partition bytes:
     ``t = E*d1 / bandwidth + intercept`` -> fits ``bandwidth`` (the
     intercept refits ``launch_overhead_s`` only for wall probes, which
     actually pay per-call dispatch — see :func:`fit_link`);
   * COMPACT observations are affine in the compacted bytes with slope
     ``1/bandwidth + 1/compaction_bandwidth`` -> given the FILTER fit,
     recovers ``compaction_bandwidth`` (0 when the pass is unmeasurable);
   * ZEROCOPY observations divide out the request-group term, leaving
     ``gamma + (1-gamma)*ratio`` — a 1-D regression for ``gamma``.

   Hardware-topology constants (``m``, ``mr``, ``d1``, ``d2``) and the
   selection-semantics flag are *not* fitted: they come from the initial
   profile.

2. **Threshold tuning** (:func:`tune_thresholds`) — grid search over
   ``alpha`` / ``beta`` minimizing total *regret*: the summed gap between
   the measured time of the engine Algorithm 1 selects and the measured
   best engine, over the probe grid.  The tuned pair is adopted only when
   it beats the fitted-but-untuned profile by more than ``min_gain`` of
   the oracle's total time — so a correctly-specified profile calibrates
   to a no-op (selection decisions unchanged) instead of chasing noise.

Precision, as in the reference (``repro/autotune/calibrate.py``): the fit
is NumPy float64; :func:`selection_on_grid` runs Algorithm 1 through
``select_engines`` in float32 (the runtime's rule); :func:`tune_thresholds`
evaluates the same rule on the float32 costs *upcast to float64* against
float64 candidate thresholds, so ``alpha * tef`` and the comparisons run
in float64 there — a float32 evaluation picks differently where ``tec``
lies between the two roundings of the product.
"""

from __future__ import annotations

from dataclasses import dataclass, field

import numpy as np
import torch

from repro_torch.autotune.probe import (
    ENGINES,
    Observation,
    ProbePoint,
    observation_matrix,
    stats_for,
)
from repro_torch.core.constants import LinkModel
from repro_torch.core.cost_model import (
    COMPACT,
    FILTER,
    NONE,
    ZEROCOPY,
    algorithm1_engines,
    engine_costs,
    select_engines,
)


def selection_on_grid(points: list[ProbePoint], link: LinkModel) -> np.ndarray:
    """Algorithm-1 engine choice per probe point under ``link``."""
    stats = stats_for(points, link)
    return select_engines(stats, engine_costs(stats, link), link).numpy()


def _regret_rows(engines2d: np.ndarray, measured: np.ndarray) -> np.ndarray:
    """(K, N) engine choices -> (K,) total regrets vs the measured best.

    NONE (-1) entries — zero-active partitions the selection skips —
    contribute zero regret (nothing is transferred for them)."""
    idx = np.asarray(engines2d, int)
    best = np.nanmin(measured, axis=1)
    picked = measured[np.arange(measured.shape[0])[None, :], np.clip(idx, 0, 2)]
    return np.nansum(np.where(idx >= 0, picked - best[None, :], 0.0), axis=1)


def total_regret(engines: np.ndarray, measured: np.ndarray) -> float:
    """Sum over points of measured[selected] - measured[best]."""
    return float(_regret_rows(np.asarray(engines)[None, :], measured)[0])


def _affine_fit(x: np.ndarray, y: np.ndarray) -> tuple[float, float]:
    """y ~= slope * x + intercept (least squares, slope floor at 0)."""
    A = np.stack([x, np.ones_like(x)], axis=1)
    (slope, intercept), *_ = np.linalg.lstsq(A, y, rcond=None)
    return max(float(slope), 0.0), max(float(intercept), 0.0)


def fit_link(
    points: list[ProbePoint],
    observations: list[Observation],
    initial: LinkModel,
    fit_overhead: bool = False,
) -> LinkModel:
    """Least-squares fit of (bandwidth, compaction_bandwidth, gamma) from
    per-engine observations; every other field is inherited from
    ``initial``.

    ``launch_overhead_s`` is refit only when ``fit_overhead`` is set:
    model-probe observations carry no overhead signal (their affine
    intercept is pure ceil-rounding bias, ~rtt/2).  Wall probes DO pay
    real per-call dispatch, so the wall path opts in and the rounding bias
    is subtracted out.
    """
    by_engine: dict[int, list[Observation]] = {e: [] for e in ENGINES}
    for o in observations:
        by_engine[o.engine].append(o)

    bandwidth = initial.bandwidth
    overhead = initial.launch_overhead_s
    if by_engine[FILTER]:
        x = np.array([o.point.total_edges * initial.d1 for o in by_engine[FILTER]])
        y = np.array([o.seconds for o in by_engine[FILTER]])
        slope, intercept = _affine_fit(x, y)
        if slope > 0:
            bandwidth = 1.0 / slope
        if fit_overhead:
            rtt_fit = initial.m * initial.mr / bandwidth
            overhead = max(intercept - 0.5 * rtt_fit, 0.0)

    compaction_bw = initial.compaction_bandwidth
    if by_engine[COMPACT]:
        x = np.array([
            o.point.active_edges * initial.d1 + o.point.active_vertices * initial.d2
            for o in by_engine[COMPACT]
        ])
        y = np.array([o.seconds for o in by_engine[COMPACT]])
        slope, _ = _affine_fit(x, y)
        extra = slope - 1.0 / bandwidth
        # a pass FASTER than ~1000x the link contributes nothing
        # measurable — model it as free (compaction_bandwidth = 0 means
        # "no modeled pass" per engine_costs' > 0 guard)
        compaction_bw = 1.0 / extra if extra > 1e-3 / bandwidth else 0.0

    gamma = initial.gamma
    if by_engine[ZEROCOPY]:
        rtt = initial.m * initial.mr / bandwidth
        num = den = 0.0
        for o in by_engine[ZEROCOPY]:
            groups = np.ceil(o.point.zc_requests(initial) / initial.mr)
            if groups <= 0:
                continue
            yy = o.seconds / (groups * rtt)     # == gamma + (1-gamma)*ratio
            r = o.point.ratio
            num += (yy - r) * (1.0 - r)
            den += (1.0 - r) ** 2
        if den > 0:
            gamma = float(np.clip(num / den, 1e-3, 1.0))

    return initial.with_(
        bandwidth=bandwidth,
        launch_overhead_s=overhead,
        compaction_bandwidth=compaction_bw,
        gamma=gamma,
    )


def _threshold_regrets(tef: np.ndarray, tec: np.ndarray, tiz: np.ndarray,
                       active: np.ndarray, measured: np.ndarray,
                       alphas: np.ndarray, betas: np.ndarray) -> np.ndarray:
    """(K,) candidate thresholds -> (K,) regrets, one broadcast call
    through the SAME Algorithm-1 rule the runtime executes, evaluated in
    float64: the (N,) float64 costs against the (K,) float64 thresholds."""
    def f64(a):
        return torch.from_numpy(np.asarray(a, np.float64))

    eng = algorithm1_engines(f64(tef)[None, :], f64(tec)[None, :], f64(tiz)[None, :],
                             f64(alphas)[:, None], f64(betas)[:, None]).numpy()
    eng = np.where(np.asarray(active)[None, :], eng, NONE)
    return _regret_rows(eng, measured)


def tune_thresholds(
    points: list[ProbePoint],
    measured: np.ndarray,
    profile: LinkModel,
    min_gain: float = 0.01,
    grid: int = 20,
) -> tuple[LinkModel, float]:
    """Regret-minimizing (alpha, beta) grid search.

    Returns ``(profile', regret)``.  The incumbent (``profile``'s own
    thresholds) is always a candidate and wins unless a challenger beats
    it by more than ``min_gain * sum(measured best)`` — the stability
    margin that makes calibration of a correct profile a no-op.
    """
    stats = stats_for(points, profile)
    costs = engine_costs(stats, profile)
    tef = costs.tef.numpy().astype(float)
    tec = costs.tec.numpy().astype(float)
    tiz = costs.tiz.numpy().astype(float)
    active = stats.active_edges.numpy().astype(float) > 0

    def regrets_for(alphas: np.ndarray, betas: np.ndarray) -> np.ndarray:
        return _threshold_regrets(tef, tec, tiz, active, measured, alphas, betas)

    incumbent = float(regrets_for(
        np.array([profile.alpha]), np.array([profile.beta]))[0])
    oracle = float(np.nansum(np.nanmin(measured, axis=1)))
    cand = np.linspace(0.05, 1.0, grid)
    aa, bb = np.meshgrid(cand, cand, indexing="ij")
    regrets = regrets_for(aa.ravel(), bb.ravel())
    k = int(np.argmin(regrets))  # first minimum: same tie-break as a scan
    if regrets[k] < incumbent - min_gain * oracle:
        return (profile.with_(alpha=float(aa.ravel()[k]), beta=float(bb.ravel()[k])),
                float(regrets[k]))
    return profile, incumbent


@dataclass(frozen=True)
class CalibrationReport:
    profile: LinkModel             # calibrated profile
    initial: LinkModel
    static_regret: float           # regret of the *initial* profile's selection
    calibrated_regret: float       # regret of the calibrated selection
    oracle_seconds: float          # sum of measured-best times (scale)
    n_observations: int
    n_points: int
    fitted: dict = field(default_factory=dict)

    @property
    def improved(self) -> bool:
        return self.calibrated_regret < self.static_regret


def calibrate(
    points: list[ProbePoint],
    observations: list[Observation],
    initial: LinkModel,
    fit_params: bool = True,
    tune: bool = True,
    min_gain: float = 0.01,
    fit_overhead: bool = False,
) -> CalibrationReport:
    """Full calibration: parameter fit, then threshold tuning, then the
    static-vs-calibrated regret comparison on the probe grid.
    ``fit_overhead``: see :func:`fit_link` — set it for wall-probe
    observations only."""
    measured = observation_matrix(points, observations)
    static_regret = total_regret(selection_on_grid(points, initial), measured)

    profile = (fit_link(points, observations, initial, fit_overhead=fit_overhead)
               if fit_params else initial)
    if tune:
        profile, regret = tune_thresholds(points, measured, profile, min_gain=min_gain)
    else:
        regret = total_regret(selection_on_grid(points, profile), measured)
    if regret > static_regret:
        # never ship a profile that is worse than the initial one on the
        # very probe set it was fitted on (degenerate fits under noise)
        profile, regret = initial, static_regret

    return CalibrationReport(
        profile=profile,
        initial=initial,
        static_regret=static_regret,
        calibrated_regret=regret,
        oracle_seconds=float(np.nansum(np.nanmin(measured, axis=1))),
        n_observations=len(observations),
        n_points=len(points),
        fitted={
            "bandwidth": profile.bandwidth,
            "gamma": profile.gamma,
            "compaction_bandwidth": profile.compaction_bandwidth,
            "launch_overhead_s": profile.launch_overhead_s,
            "alpha": profile.alpha,
            "beta": profile.beta,
        },
    )
