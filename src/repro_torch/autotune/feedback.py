"""Online feedback: per-engine cost corrections from measured sweep times.

Each HyTM iteration (or chunk of iterations) yields one noisy linear
observation

    measured_seconds ~= sum_e  c_e * modeled_e

where ``modeled_e`` is the modeled time the plan attributed to engine
``e``.  :class:`OnlineCalibrator` keeps the exponentially forgotten normal
equations of that regression (EWMA recursive least squares) and solves for
the correction vector ``c``.

Wall time on the measuring host need not be in the modeled link's units,
so the solved vector is normalized to geometric mean 1 over the engines
observed so far: Algorithm 1 compares engines against each other, so only
the relative corrections matter.  Engines with no evidence stay at 1.0.

The arithmetic is the reference's (``repro/autotune/feedback.py``), in
NumPy float64 step for step, so the same (modeled, measured) stream gives
the same corrections bit for bit.  The correction multiplies the
per-engine selection costs (``core.cost_model.apply_correction``) as a
(3,) float32 tensor on the run's device.
"""

from __future__ import annotations

import time

import numpy as np
import torch

N_ENGINES = 3  # FILTER, COMPACT, ZEROCOPY


class OnlineCalibrator:
    """EWMA recursive least squares for per-engine correction factors."""

    def __init__(self, decay: float = 0.25, ridge: float = 0.05,
                 clip: tuple[float, float] = (0.05, 20.0), obs=None):
        if not 0.0 < decay <= 1.0:
            raise ValueError(f"decay must lie in (0, 1], got {decay}")
        self.decay = decay
        self.ridge = ridge
        self.clip = clip
        self._A = np.zeros((N_ENGINES, N_ENGINES))
        self._b = np.zeros(N_ENGINES)
        self.n_updates = 0
        # optional repro_torch.obs.TraceRecorder: each folded observation
        # emits one correction-update event (host-side; obs=None records
        # nothing and skips even the correction re-solve)
        self.obs = obs

    def update(self, modeled: np.ndarray, measured_seconds: float) -> None:
        """Fold in one observation: (3,) modeled per-engine seconds and the
        measured wall time.  Each sample is normalized by its modeled
        magnitude, so observations weigh alike whatever the frontier size.
        A non-finite or non-positive measurement, or modeled times of norm
        0, are ignored."""
        t = np.asarray(modeled, dtype=float).reshape(-1)
        if t.shape != (N_ENGINES,):
            raise ValueError(f"expected ({N_ENGINES},) modeled times, got {t.shape}")
        norm = float(np.linalg.norm(t))
        if not np.isfinite(measured_seconds) or measured_seconds <= 0 or norm <= 0:
            return
        u = t / norm
        f = 1.0 - self.decay
        self._A = f * self._A + np.outer(u, u)
        self._b = f * self._b + u * (measured_seconds / norm)
        self.n_updates += 1
        if self.obs is not None:
            c = self.correction()
            m = self.obs.metrics
            m.counter("autotune.updates", "calibrator observations").inc(1)
            for e, name in enumerate(("filter", "compact", "zerocopy")):
                m.gauge("autotune.correction",
                        "per-engine cost correction").set(float(c[e]), engine=name)
            self.obs.instant(
                "correction_update", cat="autotune", track="autotune",
                vt=float(self.n_updates), measured_seconds=float(measured_seconds),
                modeled=[float(x) for x in t], correction=[float(x) for x in c],
            )

    def observed(self) -> np.ndarray:
        """(3,) bool: the engines with accumulated evidence."""
        return np.diag(self._A) > 1e-9

    def correction(self) -> np.ndarray:
        """(3,) float64 multiplicative per-engine correction, geometric
        mean 1 over the observed engines; all ones before the first
        update."""
        if self.n_updates == 0:
            return np.ones(N_ENGINES)
        # ridge prior toward the uncorrected model
        A = self._A + self.ridge * np.eye(N_ENGINES)
        b = self._b + self.ridge * np.ones(N_ENGINES)
        try:
            c = np.linalg.solve(A, b)
        except np.linalg.LinAlgError:
            return np.ones(N_ENGINES)
        c = np.clip(c, 1e-6, None)
        obs = self.observed()
        if obs.any():
            gm = float(np.exp(np.mean(np.log(c[obs]))))
            if gm > 0:
                c = c / gm
        c = np.where(obs, np.clip(c, *self.clip), 1.0)
        return c.astype(float)

    def observe_iteration(self, sync_ref: torch.Tensor, per_engine_modeled,
                          t_start: float, skip: bool = False) -> torch.Tensor:
        """Wait for the device work behind ``sync_ref`` (so the elapsed wall
        time covers the whole iteration), fold the measurement against the
        (3,) modeled per-engine seconds unless ``skip`` (a first dispatch,
        whose wall time includes kernel builds and allocator growth), and
        return the refreshed correction as a (3,) float32 tensor on
        ``sync_ref``'s device."""
        if sync_ref.device.type == "cuda":
            torch.cuda.synchronize(sync_ref.device)
        if not skip:
            modeled = (per_engine_modeled.cpu().numpy()
                       if torch.is_tensor(per_engine_modeled) else per_engine_modeled)
            self.update(np.asarray(modeled, dtype=float), time.monotonic() - t_start)
        # float64 -> float32 rounds to nearest, as jnp.asarray(c, float32)
        return torch.from_numpy(self.correction().astype(np.float32)).to(sync_ref.device)

    def observe_chunk(self, sync_ref: torch.Tensor, per_engine_modeled_sum,
                      t_start: float, skip: bool = False) -> torch.Tensor:
        """Chunk-granularity observation for the chunked driver
        (``HyTMConfig.sync_every > 1``): the target is one chunk's wall
        time against the (3,) per-engine modeled seconds summed over its
        executed iterations.  The model is linear in the per-engine
        regressors, so this identifies the same correction at one
        measurement a dispatch.  ``skip`` marks a signature's first
        dispatch."""
        return self.observe_iteration(sync_ref, per_engine_modeled_sum, t_start, skip=skip)
