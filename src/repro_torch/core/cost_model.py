"""HyTM cost model — paper §V-A, Eqs. (1)-(3) — vectorized over partitions.

Per iteration, for every partition i the model estimates the cost of the
three engines from the active-vertex statistics, then Algorithm 1's
selection rule picks the cheapest:

  Tef_i = ceil(E_i * d1 / m / MR) * RTT                          (Eq. 1)
  Tec_i = ceil((Ea_i*d1 + |A_i|*d2) / m / MR) * RTT [+ cpt]      (Eq. 2)
  Tiz_i = ceil(REQ_i / MR) * RTT_zc                              (Eq. 3)
  RTT_zc = gamma*RTT + (1-gamma) * (Ea_i/E_i) * RTT

Selection (Algorithm 1, lines 4-12):
  if Tec < alpha*Tef and Tec < beta*Tiz: COMPACT
  elif Tef < Tiz:                         FILTER
  else:                                   ZEROCOPY
Partitions with no active edges are skipped (engine NONE).

Every equation runs in float32 with the reference's association order, and
every link constant enters as a 0-dim float32 tensor on the tensors'
device: on CUDA, dividing by a Python scalar multiplies by its reciprocal
(one ulp away from a true division), and an engine pick flips at the
alpha/beta thresholds on one ulp.
"""

from __future__ import annotations

import functools
from typing import NamedTuple

import torch

from repro_torch.core.constants import LinkModel
from repro_torch.core.partition import DevicePartitions

# Engine ids.
NONE, FILTER, COMPACT, ZEROCOPY = -1, 0, 1, 2
ENGINE_NAMES = {NONE: "none", FILTER: "filter", COMPACT: "compact", ZEROCOPY: "zerocopy"}


class PartitionStats(NamedTuple):
    """Per-partition activity statistics for one iteration (all (P,) f32)."""

    active_edges: torch.Tensor     # Ea_i
    active_vertices: torch.Tensor  # |A_i|
    zc_requests: torch.Tensor      # REQ_i
    total_edges: torch.Tensor      # E_i


@functools.lru_cache(maxsize=64)
def _consts(link: LinkModel, device: torch.device) -> dict[str, torch.Tensor]:
    """The link's constants as 0-dim float32 tensors on ``device``, each
    rounded from the same Python double the reference's weak-typed scalar
    is rounded from (``gamma * rtt`` is a Python product there too)."""
    def f(x):
        return torch.full((), x, dtype=torch.float32, device=device)

    rtt = link.rtt
    return {
        "d1": f(link.d1), "d2": f(link.d2), "m": f(link.m), "mr": f(link.mr),
        "group": f(link.m * link.mr), "rtt": f(rtt),
        "gamma_rtt": f(link.gamma * rtt), "one_minus_gamma": f(1.0 - link.gamma),
        "compaction_bandwidth": f(link.compaction_bandwidth),
        "alpha": f(link.alpha), "beta": f(link.beta),
        "launch_overhead_s": f(link.launch_overhead_s),
        "one": f(1.0), "zero": f(0.0),
    }


def link_constants(link: LinkModel, device) -> dict[str, torch.Tensor]:
    return _consts(link, torch.device(device))


def zc_request_counts(
    out_degree: torch.Tensor, seg_start: torch.Tensor, link: LinkModel
) -> torch.Tensor:
    """Per-vertex zero-copy request count: ceil(deg*d1/m) + am(v), where
    am(v)=1 when the vertex has edges and its segment start is not
    m-aligned."""
    c = link_constants(link, out_degree.device)
    deg = out_degree.to(torch.float32)
    base = torch.ceil(deg * c["d1"] / c["m"])
    granule = max(int(link.m // link.d1), 1)
    misaligned = torch.remainder(seg_start, granule) != 0
    am = torch.where(misaligned & (out_degree > 0), c["one"], c["zero"])
    return base + am


def partition_stats(
    frontier: torch.Tensor,           # (n,) bool
    out_degree: torch.Tensor,         # (n,) int32
    zc_req_per_vertex: torch.Tensor,  # (n,) float32
    parts: DevicePartitions,
) -> PartitionStats:
    """Segment-reduce per-vertex activity into per-partition statistics.

    Every statistic is a sum of integers.  The reference sums them in
    float32, exact while every partial sum stays below 2**24; the port sums
    them exactly in int64 and rounds once, which gives the same float32
    values in that range (at RMAT scale 22 in 64 partitions a partition
    holds about 1.05M edges).  Partitions are contiguous vertex ranges, so
    a partition's sum is the difference of a running sum at its bounds: a
    scan, where a scatter-add into P bins would serialize n atomics on P
    addresses."""
    act = frontier.to(torch.int64)

    def seg_sum(x):
        run = torch.cat([x.new_zeros(1), torch.cumsum(x, dim=0)])
        at_bounds = torch.index_select(run, 0, parts.vertex_start)
        return (at_bounds[1:] - at_bounds[:-1]).to(torch.float32)

    return PartitionStats(
        active_edges=seg_sum(act * out_degree),
        active_vertices=seg_sum(act),
        zc_requests=seg_sum(act * zc_req_per_vertex.to(torch.int64)),
        total_edges=parts.part_edges.to(torch.float32),
    )


class EngineCosts(NamedTuple):
    tef: torch.Tensor       # (P,) seconds
    tec: torch.Tensor       # selection value (transfer-only, paper §V-A)
    tiz: torch.Tensor
    tec_full: torch.Tensor  # + the compaction pass — what execution pays


def engine_costs(stats: PartitionStats, link: LinkModel) -> EngineCosts:
    c = link_constants(link, stats.total_edges.device)
    tef = torch.ceil(stats.total_edges * c["d1"] / c["group"]) * c["rtt"]
    cbytes = stats.active_edges * c["d1"] + stats.active_vertices * c["d2"]
    tec = torch.ceil(cbytes / c["group"]) * c["rtt"]
    tec_full = tec
    if link.compaction_bandwidth > 0:
        tec_full = tec + cbytes / c["compaction_bandwidth"]
    if link.selection_uses_full_compaction_cost:
        tec = tec_full
    ratio = torch.where(
        stats.total_edges > 0,
        stats.active_edges / torch.maximum(stats.total_edges, c["one"]),
        c["zero"],
    )
    rtt_zc = c["gamma_rtt"] + c["one_minus_gamma"] * ratio * c["rtt"]
    tiz = torch.ceil(stats.zc_requests / c["mr"]) * rtt_zc
    return EngineCosts(tef=tef, tec=tec, tiz=tiz, tec_full=tec_full)


def apply_correction(costs: EngineCosts, correction: torch.Tensor | None) -> EngineCosts:
    """Scale per-engine costs by a (3,) correction vector (index == engine
    id); ``None`` is the identity."""
    if correction is None:
        return costs
    return EngineCosts(
        tef=costs.tef * correction[FILTER],
        tec=costs.tec * correction[COMPACT],
        tiz=costs.tiz * correction[ZEROCOPY],
        tec_full=costs.tec_full * correction[COMPACT],
    )


def algorithm1_engines(tef, tec, tiz, alpha, beta) -> torch.Tensor:
    """Algorithm 1 lines 4-12 on raw per-engine selection costs;
    ``alpha``/``beta`` are 0-dim tensors or tensors broadcastable against
    the costs."""
    pick_compact = (tec < alpha * tef) & (tec < beta * tiz)
    pick_filter = tef < tiz
    return torch.where(pick_compact, COMPACT, torch.where(pick_filter, FILTER, ZEROCOPY))


def select_engines(
    stats: PartitionStats,
    costs: EngineCosts,
    link: LinkModel,
    correction: torch.Tensor | None = None,
) -> torch.Tensor:
    """Algorithm 1 → (P,) int32 engine ids (NONE for inactive).  The
    correction steers selection only; accounting stays in model units."""
    c = link_constants(link, stats.total_edges.device)
    costs = apply_correction(costs, correction)
    eng = algorithm1_engines(costs.tef, costs.tec, costs.tiz, c["alpha"], c["beta"])
    return torch.where(stats.active_edges > 0, eng, NONE).to(torch.int32)


def modeled_best_engines(
    stats: PartitionStats,
    costs: EngineCosts,
    correction: torch.Tensor | None = None,
) -> torch.Tensor:
    """(P,) engine whose (corrected) execution cost is minimal — the
    model's own oracle (ties go to the lower engine id)."""
    costs = apply_correction(costs, correction)
    stacked = torch.stack([costs.tef, costs.tec_full, costs.tiz])
    best = torch.argmin(stacked, dim=0).to(torch.int32)
    return torch.where(stats.active_edges > 0, best, NONE).to(torch.int32)


def selection_diagnostics(
    engines: torch.Tensor,
    transfer_time: torch.Tensor,
    stats: PartitionStats,
    costs: EngineCosts,
    correction: torch.Tensor | None = None,
) -> tuple[torch.Tensor, torch.Tensor]:
    """(3,) modeled seconds attributed to each engine and the int32 count
    of processed partitions where Algorithm 1 diverged from the modeled
    best engine."""
    zero = torch.zeros((), dtype=transfer_time.dtype, device=transfer_time.device)
    per_engine_time = torch.stack([
        torch.where(engines == e, transfer_time, zero).sum()
        for e in (FILTER, COMPACT, ZEROCOPY)
    ])
    best = modeled_best_engines(stats, costs, correction)
    mispredictions = ((engines != best) & (engines != NONE)).sum(dtype=torch.int32)
    return per_engine_time, mispredictions


def modeled_transfer_bytes(
    stats: PartitionStats, engines: torch.Tensor, link: LinkModel
) -> torch.Tensor:
    """Modeled bytes each partition moves under its engine (Table VI):
    filter E_i*d1, compact Ea_i*d1 + |A_i|*d2, zerocopy REQ_i*m."""
    c = link_constants(link, stats.total_edges.device)
    b_f = stats.total_edges * c["d1"]
    b_c = stats.active_edges * c["d1"] + stats.active_vertices * c["d2"]
    b_z = stats.zc_requests * c["m"]
    out = torch.where(engines == FILTER, b_f, c["zero"])
    out = torch.where(engines == COMPACT, b_c, out)
    return torch.where(engines == ZEROCOPY, b_z, out)


def engine_bandwidths(stats: PartitionStats, costs: EngineCosts, link: LinkModel) -> torch.Tensor:
    """(3, P) modeled effective bandwidth (bytes/second) of each engine,
    row index == engine id: the Table-VI bytes of ``modeled_transfer_bytes``
    for every engine over its execution seconds (``tec_full`` for compact,
    whose pass is paid).  A partition whose modeled time is 0 reports 0."""
    c = link_constants(link, stats.total_edges.device)
    bytes_ = torch.stack([
        stats.total_edges * c["d1"],
        stats.active_edges * c["d1"] + stats.active_vertices * c["d2"],
        stats.zc_requests * c["m"],
    ])
    secs = torch.stack([costs.tef, costs.tec_full, costs.tiz])
    return torch.where(secs > 0, bytes_ / torch.clamp_min(secs, 1e-30), c["zero"])


def modeled_time_seconds(costs: EngineCosts, engines: torch.Tensor) -> torch.Tensor:
    """Reported (execution) time — charges the compaction pass that the
    selection rule leaves out."""
    zero = torch.zeros((), dtype=costs.tef.dtype, device=costs.tef.device)
    t = torch.where(engines == FILTER, costs.tef, zero)
    t = torch.where(engines == COMPACT, costs.tec_full, t)
    return torch.where(engines == ZEROCOPY, costs.tiz, t)


# --------------------------------------------------------------------------
# Telemetry key constants: the one definition of every history / stats key
# --------------------------------------------------------------------------

KEY_ENGINES = "engines"
KEY_TRANSFER_BYTES = "transfer_bytes"
KEY_TRANSFER_TIME = "transfer_time"
KEY_ACTIVE_VERTICES = "active_vertices"
KEY_ACTIVE_EDGES = "active_edges"
KEY_N_TASKS = "n_tasks"
KEY_MISPREDICTIONS = "mispredictions"
KEY_PER_ENGINE_TIME = "per_engine_time"
KEY_MERGED_ENTRIES = "merged_entries"
KEY_ICI_BYTES = "ici_bytes"
KEY_ICI_TIME = "ici_time"
KEY_ICI_ENGINE = "ici_engine"
KEY_HALO_ENTRIES = "halo_entries"
KEY_STATE_BYTES_PER_DEVICE = "state_bytes_per_device"
KEY_WARM_CACHE = "warm_cache"
KEY_ENGINE_CORRECTIONS = "engine_corrections"

# float32 values + float32 Δ + bool frontier, one entry each per vertex
STATE_BYTES_PER_VERTEX = 4 + 4 + 1


def vertex_state_bytes(n_nodes: int, n_devices: int = 1,
                       vertex_sharding: str = "replicated", halo: int = 0) -> int:
    """Per-device bytes of the (values, Δ, frontier) triple: the whole
    ``(n,)`` triple under ``"replicated"``; under ``"owner"`` the device's
    ``ceil(n/D)`` owned slice plus ``halo`` boundary entries.  Host
    integer arithmetic, as in the reference."""
    if vertex_sharding == "owner":
        n_loc = -(-n_nodes // max(n_devices, 1))
        return STATE_BYTES_PER_VERTEX * (n_loc + halo)
    return STATE_BYTES_PER_VERTEX * n_nodes

# The iteration-info keys that persist into ``HyTMResult.history``, one row
# per iteration; ``next_active`` is read by the driver, not buffered.
HISTORY_KEYS = (
    KEY_ENGINES, KEY_TRANSFER_BYTES, KEY_TRANSFER_TIME, KEY_ACTIVE_VERTICES,
    KEY_ACTIVE_EDGES, KEY_N_TASKS, KEY_MISPREDICTIONS, KEY_PER_ENGINE_TIME,
)


def history_shapes(n_partitions: int) -> dict[str, tuple[tuple, torch.dtype]]:
    """``key -> (shape, dtype)`` of one iteration's info row."""
    f32, i32 = torch.float32, torch.int32
    return {
        KEY_ENGINES: ((n_partitions,), i32),
        KEY_TRANSFER_BYTES: ((n_partitions,), f32),
        KEY_TRANSFER_TIME: ((), f32),
        KEY_ACTIVE_VERTICES: ((), i32),
        KEY_ACTIVE_EDGES: ((), f32),
        KEY_N_TASKS: ((), i32),
        KEY_MISPREDICTIONS: ((), i32),
        KEY_PER_ENGINE_TIME: ((3,), f32),
    }


def init_history_buffers(
    info_shapes: dict, chunk: int, keys: tuple = HISTORY_KEYS,
    device: str | torch.device = "cpu",
) -> dict[str, torch.Tensor]:
    """Preallocated device history: ``key -> zeros((chunk, *shape))``,
    from ``info_shapes`` (``key -> (shape, dtype)``, see
    ``history_shapes``)."""
    return {
        k: torch.zeros((chunk,) + tuple(info_shapes[k][0]),
                       dtype=info_shapes[k][1], device=device)
        for k in keys
    }
