"""Engine micro-benchmark probes (the "measure" half of calibration).

A :class:`ProbePoint` is one synthetic partition described by the same
activity statistics the cost model consumes (Eqs. 1-3): total edges
``E``, active edges ``Ea``, active vertices ``|A|``, and the fraction of
active vertices whose neighbour segment is misaligned.  The default grid
spans the activity-ratio spectrum (the x-axis of the paper's Fig. 3
"Prefer" analysis) crossed with the degree regimes that separate the
three engines: few high-degree hubs (EMOGI's zero-copy regime), a
mid-degree band, and a flat deg~1 frontier (compaction's regime).

Two measurement backends produce ``(point, engine, seconds)``
observations:

* :func:`model_probe` — evaluates a *ground-truth* :class:`LinkModel` as
  a hardware simulator, on the host.  Deterministic (optionally noised),
  arbitrarily large ``E``; the ``--selfcheck`` acceptance run uses it:
  calibrating profile X against ``model_probe(truth=Y)`` must recover
  Y-shaped selection.  Its seconds equal the reference's bit for bit.
* :func:`wall_probe` — materializes each point as a real edge block on a
  device (``cuda`` unless given) and wall-times the three engine
  relaxations (``relax_with_engine``), through the kernels on the card.
  This is the path a deployment calibrates with; points are capped to
  sizes that fit comfortably in memory.

The arithmetic is the reference's (``repro/autotune/probe.py``): the
statistics are rounded once from Python floats to float32, the cost model
runs eagerly on the CPU, and the materialized blocks draw the reference's
NumPy streams in the reference's order.
"""

from __future__ import annotations

import math
import time
from dataclasses import dataclass

import numpy as np
import torch

from repro_torch.core.constants import LinkModel
from repro_torch.core.cost_model import (
    COMPACT,
    FILTER,
    ZEROCOPY,
    PartitionStats,
    engine_costs,
)

ENGINES = (FILTER, COMPACT, ZEROCOPY)


@dataclass(frozen=True)
class ProbePoint:
    """One synthetic partition, described by its activity statistics.

    Active vertices share a uniform out-degree ``Ea / |A|`` so the
    zero-copy request count (Eq. 3) is computable under *any* candidate
    link model — the request granule ``m/d1`` differs per profile, so
    requests are re-derived from the degree rather than stored.
    """

    total_edges: float      # E_i
    active_edges: float     # Ea_i
    active_vertices: float  # |A_i|
    mis_frac: float = 0.5   # fraction of active vertices with a misaligned segment

    @property
    def ratio(self) -> float:
        return self.active_edges / max(self.total_edges, 1.0)

    @property
    def degree(self) -> float:
        return self.active_edges / max(self.active_vertices, 1.0)

    def zc_requests(self, link: LinkModel) -> float:
        """Eq. 3's REQ_i under ``link``: |A| * (ceil(deg*d1/m) + am)."""
        per_vertex = math.ceil(self.degree * link.d1 / link.m) + self.mis_frac
        return self.active_vertices * per_vertex


def stats_for(points: list[ProbePoint], link: LinkModel) -> PartitionStats:
    """Stack a probe grid into one (P,) :class:`PartitionStats` under
    ``link`` (the request counts are link-dependent), on the CPU: each
    statistic is computed per point in Python float64 and rounded once to
    float32."""
    def col(values):
        return torch.tensor(values, dtype=torch.float32)

    return PartitionStats(
        active_edges=col([p.active_edges for p in points]),
        active_vertices=col([p.active_vertices for p in points]),
        zc_requests=col([p.zc_requests(link) for p in points]),
        total_edges=col([p.total_edges for p in points]),
    )


# Degree regimes: |A| as a function of Ea.  Hub = few high-degree sources
# (Table III / EMOGI's sweet spot), flat = deg~1 frontier (compaction's).
_REGIMES = {
    "hub": lambda ea: max(1.0, ea / 128.0),
    "mid": lambda ea: max(1.0, ea / 8.0),
    "flat": lambda ea: ea,
}


def default_grid(
    edge_levels: tuple[float, ...] = (1.0e6, 4.3e6, 1.7e7, 6.7e7),
    n_ratios: int = 9,
    regimes: tuple[str, ...] = ("hub", "mid", "flat"),
    mis_frac: float = 0.5,
) -> list[ProbePoint]:
    """Probe grid spanning the activity spectrum x degree regimes.

    Ratio endpoints are deliberately non-round so grid points do not land
    on exact cost ties (Algorithm 1 uses strict comparisons; a tie would
    make "selection unchanged" checks flaky under infinitesimal fits).
    """
    ratios = np.geomspace(1.07e-3, 0.93, n_ratios)
    points = []
    for E in edge_levels:
        for r in ratios:
            ea = max(1.0, float(round(E * r)))
            for name in regimes:
                a = min(float(round(_REGIMES[name](ea))), ea)
                points.append(ProbePoint(
                    total_edges=float(E), active_edges=ea,
                    active_vertices=a, mis_frac=mis_frac,
                ))
    return points


@dataclass(frozen=True)
class Observation:
    point: ProbePoint
    engine: int
    seconds: float


def model_probe(
    points: list[ProbePoint],
    truth: LinkModel,
    noise: float = 0.0,
    seed: int = 0,
) -> list[Observation]:
    """Simulate measurements by evaluating ``truth`` as the hardware.

    Per point the three engines cost what the ground-truth model says
    *execution* pays — ``tef`` / ``tec_full`` (the compaction pass is
    physically paid whether or not selection models it) / ``tiz`` —
    optionally perturbed by multiplicative gaussian noise.
    """
    costs = engine_costs(stats_for(points, truth), truth)
    per_engine = {
        FILTER: costs.tef.numpy().astype(float),
        COMPACT: costs.tec_full.numpy().astype(float),
        ZEROCOPY: costs.tiz.numpy().astype(float),
    }
    rng = np.random.default_rng(seed)
    obs = []
    for eng in ENGINES:
        t = per_engine[eng]
        if noise > 0:
            t = t * np.clip(1.0 + noise * rng.standard_normal(len(points)), 0.05, None)
        for i, p in enumerate(points):
            obs.append(Observation(point=p, engine=eng, seconds=float(t[i])))
    return obs


def _materialize(point: ProbePoint, max_edges: int, seed: int,
                 device: str | torch.device = "cpu"):
    """Build a real edge block on ``device`` realizing (a capped version of)
    ``point``; also returns the operand, the vertex count ``n = E`` and
    the ProbePoint describing what was *actually* built."""
    from repro_torch.core.engines import EdgeBlock

    scale = min(1.0, max_edges / max(point.total_edges, 1.0))
    E = max(int(point.total_edges * scale), 4)
    Ea = min(max(int(point.active_edges * scale), 1), E)
    A = min(max(int(point.active_vertices * scale), 1), Ea)
    deg = max(Ea // A, 1)
    rng = np.random.default_rng(seed)
    n = E  # enough vertices that inactive edges have distinct sources
    src = np.empty(E, np.int32)
    # active sources 0..A-1, `deg` consecutive edges each (CSR-contiguous)
    n_act = min(A * deg, E)
    src[:n_act] = np.repeat(np.arange(A, dtype=np.int32), deg)[:n_act]
    src[n_act:] = rng.integers(A, n, size=E - n_act)
    dst = rng.integers(0, n, size=E).astype(np.int32)
    w = rng.random(E).astype(np.float32) + 0.5
    frontier = np.zeros(n, bool)
    frontier[:A] = True
    active = frontier[src]
    block = EdgeBlock(*(torch.from_numpy(a).to(device) for a in (src, dst, w, active)))
    operand = torch.from_numpy(rng.random(n).astype(np.float32)).to(device)
    realized = ProbePoint(
        total_edges=float(E), active_edges=float(n_act),
        active_vertices=float(A), mis_frac=point.mis_frac,
    )
    return block, operand, n, realized


def wall_probe(
    points: list[ProbePoint],
    max_edges: int = 200_000,
    repeats: int = 3,
    seed: int = 0,
    use_kernels: bool | str = "auto",
    device: str | torch.device | None = None,
) -> tuple[list[ProbePoint], list[Observation]]:
    """Wall-time the three engines over materialized probe partitions on
    ``device`` (``cuda`` unless given; raises without a card).

    Each requested point is scaled (preserving its activity ratio and
    degree regime) to at most ``max_edges`` edges and the observations
    describe the *materialized* grid with UNSCALED measured seconds —
    rescaling capped points would also multiply the constant per-call
    dispatch component and bias the ``fit_overhead`` intercept upward.
    Returns ``(materialized_points, observations)``; calibrate against
    the returned points, not the requested ones.

    Each (point, engine) gets one warm-up call (on the card the first one
    also pays the kernels' build), then ``repeats`` timed calls, of which
    the median is kept.  A timed call is wall clock: ``time.monotonic()``
    around the relax and a ``torch.cuda.synchronize`` — the host dispatch
    the runtime pays is part of what is measured, and ``fit_link``'s
    intercept reads it.

    ``use_kernels`` mirrors :class:`HyTMConfig.use_kernels` ("auto" turns
    the kernels on for a CUDA device): calibration must time the SAME
    engine implementations the runtime will dispatch.
    """
    from repro_torch.core.engines import ENGINE_FNS
    from repro_torch.graph.algorithms import SSSP
    from repro_torch.kernels.runtime import resolve_device, resolve_use_kernels

    dev = resolve_device(device)
    uk = resolve_use_kernels(use_kernels, dev)

    def sync():
        if dev.type == "cuda":
            torch.cuda.synchronize(dev)

    realized_points = []
    obs = []
    for i, p in enumerate(points):
        block, operand, n, realized = _materialize(p, max_edges, seed + i, dev)
        realized_points.append(realized)
        for eng in ENGINES:
            fn = ENGINE_FNS[eng]
            fn(block, operand, n, SSSP, uk)  # warm-up (and the kernels' build)
            sync()
            times = []
            for _ in range(repeats):
                t0 = time.monotonic()
                fn(block, operand, n, SSSP, uk)
                sync()
                times.append(time.monotonic() - t0)
            obs.append(Observation(
                point=realized, engine=eng,
                seconds=float(np.median(times)),
            ))
        del block, operand
    return realized_points, obs


def observation_matrix(
    points: list[ProbePoint], observations: list[Observation]
) -> np.ndarray:
    """(N, 3) measured seconds, column index == engine id; NaN = missing."""
    index = {id(p): i for i, p in enumerate(points)}
    out = np.full((len(points), 3), np.nan)
    for o in observations:
        i = index.get(id(o.point))
        if i is None:  # fall back to value identity (deserialized points)
            i = points.index(o.point)
        out[i, o.engine] = o.seconds
    return out
