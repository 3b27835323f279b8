"""Link models for the HyTM cost equations (paper Eqs. 1-3).

The cost model is parameterized by the transfer link: ``m`` (payload of one
outstanding memory request), ``MR`` (outstanding requests per transaction
group / TLP), ``RTT`` (round trip of one saturated group), the zero-copy
dumping factor ``gamma`` and the selection thresholds ``alpha``/``beta``.

``PCIE3`` is the paper's platform (GTX 2080Ti over PCIe 3.0 x16): the
modeled transfer volume and time it yields are accounting units of the
paper's link, not measurements of the card the port runs on.

``TPU_V5E_HBM`` and ``TPU_V5E_ICI`` are the reference's other two shipped
profiles, copied as they are.  They are accounting constants of the
reference's TPU target, not timings of any card: the port uses them as
simulated ground truths for calibration (``launch.calibrate --mode model
--truth tpu_v5e_hbm`` and the selfcheck).  There is no shipped H100
profile.  On the card, the card's profile is whatever calibration
(``repro_torch.autotune``: wall probes of the three engines, a least
squares fit, threshold tuning) writes to the registry under the card's
device kind; ``autotune.load_profile_or_default`` reads it back.
"""

from __future__ import annotations

from dataclasses import dataclass, replace


@dataclass(frozen=True)
class LinkModel:
    name: str
    d1: float = 4.0      # bytes per edge entry (neighbour id)
    d2: float = 4.0      # bytes per compaction index entry
    m: float = 128.0     # bytes per outstanding memory request (saturated)
    mr: float = 256.0    # outstanding requests per transaction group (TLP)
    bandwidth: float = 12.3e9  # practical link bytes/s
    gamma: float = 0.625      # zero-copy dumping factor (paper §V-A)
    alpha: float = 0.8        # Tec < alpha*Tef  threshold (Subway's 80%)
    beta: float = 0.4         # Tec < beta*Tiz   threshold
    launch_overhead_s: float = 5e-6  # per-task scheduling overhead (kernel launch)
    compaction_bandwidth: float = 0.0  # >0: model the compaction pass (bytes/s)
    # paper §V-A: selection compares transfer-only Tec (alpha/beta absorb
    # the unmodeled CPU pass); on TPU the on-device pass IS modelable and
    # enters selection directly (DESIGN.md §2).
    selection_uses_full_compaction_cost: bool = False

    def __post_init__(self) -> None:
        for fname in ("d1", "d2", "m", "mr", "bandwidth"):
            v = getattr(self, fname)
            if not v > 0:
                raise ValueError(
                    f"LinkModel {self.name!r}: {fname} must be > 0, got {v}")
        if float(self.m) % float(self.d1) != 0.0:
            # zc_request_counts' alignment test uses the integer granule
            # m // d1; a non-divisor would silently produce wrong request
            # counts for every zero-copy partition.
            raise ValueError(
                f"LinkModel {self.name!r}: d1={self.d1} must divide "
                f"m={self.m} (the Eq. 3 request-alignment granule is m/d1)")
        for fname in ("alpha", "beta", "gamma"):
            v = getattr(self, fname)
            if not 0.0 < v <= 1.0:
                raise ValueError(
                    f"LinkModel {self.name!r}: {fname} must be in (0, 1], "
                    f"got {v}")
        for fname in ("launch_overhead_s", "compaction_bandwidth"):
            v = getattr(self, fname)
            if v < 0:
                raise ValueError(
                    f"LinkModel {self.name!r}: {fname} must be >= 0, got {v}")

    @property
    def rtt(self) -> float:
        """Seconds to move one saturated transaction group (m * mr bytes)."""
        return self.m * self.mr / self.bandwidth

    def with_(self, **kw) -> "LinkModel":
        return replace(self, **kw)


# Paper platform: PCIe 3.0 x16, 12.3 GB/s practical (paper §I), 128 B
# requests, 256 outstanding per TLP (paper §II-C).  CPU compaction modeled
# only through the transfer term, as the paper does (§V-A "In practice, we
# compute Tec_i by considering only the transfer overhead").
# CPU compaction throughput ~6 GB/s calibrates the pass to ~1/3 of a
# Subway-like run (paper Fig. 3(c): 34.5% of runtime).
PCIE3 = LinkModel(name="pcie3", m=128.0, mr=256.0, bandwidth=12.3e9,
                  compaction_bandwidth=6e9)


# The reference's TPU v5e HBM->VMEM profile (819 GB/s HBM; m = 512 B, one
# float32 (1, 128) lane row; mr = 64 descriptors a DMA batch; the on-device
# compaction pass an extra read + write of the active bytes).  Accounting
# constants of the reference's target, used here as a simulated ground
# truth only.
TPU_V5E_HBM = LinkModel(
    name="tpu_v5e_hbm",
    m=512.0,
    mr=64.0,
    bandwidth=819e9,
    compaction_bandwidth=819e9 / 2,  # read + write pass
    launch_overhead_s=2e-6,
    selection_uses_full_compaction_cost=True,
)

# The reference's TPU v5e ICI link (~50 GB/s a link and direction): its
# distributed level.
TPU_V5E_ICI = LinkModel(
    name="tpu_v5e_ici",
    m=512.0,
    mr=64.0,
    bandwidth=50e9,
    launch_overhead_s=1e-6,
)
