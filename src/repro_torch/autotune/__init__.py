"""repro_torch.autotune — measured-cost calibration for the HyTM cost model
(the reference's ``repro.autotune``).

The Eq. 1-3 cost model ships with hand-set platform constants
(``core.constants.PCIE3``); this subpackage validates and corrects them
against what the engines actually cost on the device running them:

  probe     — timed micro-benchmarks of FILTER/COMPACT/ZEROCOPY over
              synthetic partitions spanning the activity-ratio spectrum
              (wall clock on a device, or a ground-truth model as a
              hardware simulator)
  calibrate — least-squares LinkModel fit + regret-minimizing
              alpha/beta threshold tuning against the measured-best oracle
  registry  — JSON profile persistence keyed by device kind
  feedback  — OnlineCalibrator: EWMA per-engine corrections from measured
              iteration or chunk times (HyTMConfig.autotune)

CLI: ``python -m repro_torch.launch.calibrate`` (``--selfcheck`` for CI).
"""

from repro_torch.autotune.calibrate import (
    CalibrationReport,
    calibrate,
    fit_link,
    selection_on_grid,
    total_regret,
    tune_thresholds,
)
from repro_torch.autotune.feedback import N_ENGINES, OnlineCalibrator
from repro_torch.autotune.probe import (
    Observation,
    ProbePoint,
    default_grid,
    model_probe,
    observation_matrix,
    stats_for,
    wall_probe,
)
from repro_torch.autotune.registry import (
    default_device_kind,
    has_profile,
    list_profiles,
    load_profile,
    load_profile_or_default,
    profile_from_dict,
    profile_path,
    profile_to_dict,
    registry_dir,
    save_profile,
)

__all__ = [
    "CalibrationReport", "calibrate", "fit_link", "selection_on_grid",
    "total_regret", "tune_thresholds",
    "N_ENGINES", "OnlineCalibrator",
    "Observation", "ProbePoint", "default_grid", "model_probe",
    "observation_matrix", "stats_for", "wall_probe",
    "default_device_kind", "has_profile", "list_profiles", "load_profile",
    "load_profile_or_default",
    "profile_from_dict", "profile_path", "profile_to_dict", "registry_dir",
    "save_profile",
]
