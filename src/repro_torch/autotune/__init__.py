"""repro_torch.autotune — online engine-cost feedback for the HyTM cost
model (``HyTMConfig.autotune``).

  feedback — OnlineCalibrator: EWMA per-engine corrections from measured
             iteration or chunk times

The reference's offline calibration (``probe``, ``calibrate``,
``registry``) is ROADMAP queue 1, item 8: Calibration.
"""

from repro_torch.autotune.feedback import N_ENGINES, OnlineCalibrator

__all__ = ["N_ENGINES", "OnlineCalibrator"]
