"""Batched graph-query serving over a live ``DeltaCSR``, on one device or
a mesh.

The reference's ``GraphService`` (``repro/stream/service.py``).  It
multiplexes concurrent vertex queries (SSSP / BFS / CC / Δ-PR / Δ-PPR /
k-core) over one graph container:

* **source-lane batching** — pending single-source queries run through
  the continuous lane scheduler (``repro_torch.serve.scheduler``): sources
  stack into a (Q, n) state padded to a static lane bucket and sweep
  through ``core.hytm.hytm_batched_chunk``, each lane with its own cost
  model, engine picks and schedule, so each lane equals its standalone run
  (bit for bit for MIN programs).  Converged lanes free their slot at
  chunk boundaries and the scheduler backfills them mid-flight;
* **tiered result cache** — converged (values, Δ) keyed by ``(program,
  source)`` in a two-tier warm cache (``repro_torch.serve.warm_cache``).
  A repeat query at the same version is a pure hit: zero sweep
  iterations.  An update batch turns entries into warm states for
  incremental recomputation against the reports applied since;
* **updates** — ``update(batch)`` applies an ``EdgeBatch`` through the
  container (device tensors patched in place) and logs the report for
  later warm starts (bounded by ``max_reports``).

Global programs (accumulative ones that are not personalized, and k-core)
run one ``run_hytm`` on the container's runtime; their cache key is
``source=None``.  Traversals and Δ-PPR key per source and ride the lanes.
With ``HyTMConfig.autotune`` the service carries one ``OnlineCalibrator``
for its lifetime, fed by every lane chunk and every run.

``obs`` (a ``repro_torch.obs.TraceRecorder``) is threaded into every
consumer the service owns: the lane scheduler (request spans, admission,
device bytes, occupancy, backfill), the warm cache's tier events, the
calibrator's correction updates and the ``run_hytm``/``run_incremental``
dispatches.  ``obs=None`` records nothing anywhere.

``faults`` (a ``repro_torch.resilience.FaultPlan``) reaches every fault
site the service owns: the warm cache's promote and spill, the lane
scheduler's dispatch and allocation, and the ``run_hytm``/
``run_incremental`` dispatches; ``supervisor`` (a
``repro_torch.resilience.Supervisor``) supplies the retry policy and the
load-shed rung.  Both ``None`` take the unguarded paths.

The service runs on ``cuda`` unless given ``device="cpu"``, which it
passes to its ``DeltaCSR``.

With ``HyTMConfig.mesh_axis`` set it serves from a mesh (``mesh``, a
``launch.mesh.GraphMesh``, by default ``make_graph_mesh`` over the default
group): the container lives on the mesh's device, lane chunks run the
sharded lane sweep over its sharded view
(``DeltaCSR.sharded_runtime_for``), global programs go down
``run_hytm_sharded`` and incremental refreshes down
``run_incremental(mesh=)``; under ``vertex_sharding="owner"`` the warm
cache holds owned slices (``serve.warm_cache.OwnerPlacement``).  Each
answer equals the single-device ``async_sweep=False`` service's (bit for
bit for MIN programs).  The ranks run one process each (SPMD): every rank
of the group builds the same service and makes the same calls in the same
order, and every rank gets the same canonical ``(n,)`` answers.  Without
``mesh_axis``, ``mesh`` is not read.
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import Sequence

import numpy as np
import torch

from repro_torch.core.cost_model import (
    KEY_ENGINE_CORRECTIONS,
    KEY_MISPREDICTIONS,
    KEY_WARM_CACHE,
)
from repro_torch.core.hytm import HyTMConfig, run_hytm
from repro_torch.graph.algorithms import VertexProgram
from repro_torch.graph.csr import CSRGraph
from repro_torch.serve.scheduler import LaneScheduler
from repro_torch.serve.warm_cache import OwnerPlacement, TierPolicy, WarmCache
from repro_torch.stream.delta_csr import DeltaCSR, EdgeBatch, UpdateReport
from repro_torch.stream.incremental import run_incremental


@dataclass
class QueryResult:
    source: int | None
    values: np.ndarray
    iterations: int        # sweep iterations this query paid for
    cache_hit: bool
    mode: str              # 'cache' | 'incremental' | 'batched'


@dataclass
class ServiceStats:
    n_queries: int = 0
    n_cache_hits: int = 0
    n_incremental: int = 0
    n_full: int = 0
    n_updates: int = 0
    sweep_iterations: int = 0
    update_edges: int = 0
    extra: dict = field(default_factory=dict)


class GraphService:
    def __init__(
        self,
        graph: CSRGraph,
        config: HyTMConfig | None = None,
        max_lanes: int = 8,
        incremental: bool = True,
        max_reports: int = 256,
        mesh=None,
        device_budget_bytes: int | None = None,
        lane_buckets: Sequence[int] | None = None,
        obs=None,
        faults=None,
        supervisor=None,
        device: str | torch.device | None = None,
        **delta_kw,
    ):
        self.config = config if config is not None else HyTMConfig()
        self.obs = obs
        self.mesh = None
        if self.config.mesh_axis is not None:
            if mesh is None:
                from repro_torch.launch.mesh import make_graph_mesh

                mesh = make_graph_mesh(axis=self.config.mesh_axis, device=device)
            if mesh.axis != self.config.mesh_axis:
                raise ValueError(f"config.mesh_axis={self.config.mesh_axis!r} is not the "
                                 f"mesh's axis {mesh.axis!r}")
            self.mesh = mesh
            device = mesh.device
        self.faults = faults
        self.supervisor = supervisor
        self.dcsr = DeltaCSR(graph, self.config, device=device, **delta_kw)
        self.device = self.dcsr.device
        self.max_lanes = max_lanes
        self.incremental = incremental
        # upper bound on retained UpdateReports; overflow drops the oldest
        # and evicts the cache entries that would have needed them
        self.max_reports = max_reports
        # keyed by the (frozen, hashable) program itself, not its name:
        # variants like dataclasses.replace(PAGERANK, tolerance=1e-8) must
        # not collide
        # owner-sharded serving holds cache entries (and counts the byte
        # budget) at owned-slice granularity
        placement = None
        if self.mesh is not None and self.config.vertex_sharding == "owner":
            placement = OwnerPlacement(self.mesh, graph.n_nodes)
        self.cache = WarmCache(TierPolicy(
            device_budget_bytes=device_budget_bytes,
            max_reports=max_reports,
        ), obs=obs, faults=faults, placement=placement, device=self.device)
        self._reports: list[UpdateReport] = []
        self.stats = ServiceStats()
        # one calibrator for the service's lifetime
        self._calibrator = None
        self._correction = None
        if self.config.autotune:
            from repro_torch.autotune.feedback import OnlineCalibrator

            self._calibrator = OnlineCalibrator(decay=self.config.autotune_decay, obs=obs)
        self.scheduler = LaneScheduler(
            self, buckets=tuple(lane_buckets) if lane_buckets else None,
            supervisor=supervisor)

    # ----------------------------------------------------------------- update
    @property
    def version(self) -> int:
        return self.dcsr.version

    def update(self, batch: EdgeBatch, batch_id=None, faults=None) -> UpdateReport:
        """Apply an edge-update batch.  All cached results become stale for
        direct hits (version bump) and turn into warm states.  A
        redelivered ``batch_id`` returns the original report without
        re-applying (the contract ``resilience.deliver_update`` relies on).
        ``faults`` forwards to ``DeltaCSR.apply`` (injected delivery
        drops)."""
        v0 = self.dcsr.version
        rep = self.dcsr.apply(batch, batch_id=batch_id, faults=faults)
        if self.dcsr.version == v0:
            return rep
        self._reports.append(rep)
        self._prune_reports()
        self.stats.n_updates += 1
        self.stats.update_edges += len(batch)
        return rep

    def _prune_reports(self) -> None:
        """Drop reports no warm state can need; past ``max_reports`` drop
        the oldest and evict every entry too old to replay the retained
        suffix (both tiers)."""
        if not self.incremental or not len(self.cache):
            self._reports.clear()
            return
        floor = min(e.version for e in self.cache.values())
        self._reports = [r for r in self._reports if r.version > floor]
        if len(self._reports) > self.max_reports:
            drop = len(self._reports) - self.max_reports
            self._reports = self._reports[drop:]
            min_replayable = (self._reports[0].version - 1
                              if self._reports else self.version)
            for k in [k for k, e in self.cache.items() if e.version < min_replayable]:
                del self.cache[k]

    def _reports_since(self, version: int) -> list[UpdateReport]:
        return [r for r in self._reports if r.version > version]

    # ------------------------------------------------------------------ query
    def key_source(self, program: VertexProgram, s: int | None) -> int | None:
        """Cache-key source: global accumulative programs and peeling
        programs collapse to ``None``; traversals and personalized
        accumulative programs (Δ-PPR) key per source."""
        if program.peel_k is not None:
            return None
        if program.use_delta and not program.personalized:
            return None
        return s

    def query(
        self, program: VertexProgram, sources: Sequence[int | None] | int | None
    ) -> list[QueryResult]:
        """Answer a batch of queries; one ``QueryResult`` per requested
        source, in order.  Duplicate sources share one computation."""
        if sources is None or isinstance(sources, int):
            sources = [sources]
        keyed = [self.key_source(program, s) for s in sources]
        results: dict[int | None, QueryResult] = {}
        fresh: list[int | None] = []
        for s in dict.fromkeys(keyed):  # dedupe, keep order
            entry = self.cache.check((program, s))
            if entry is not None and entry.version == self.version:
                results[s] = QueryResult(
                    source=s, values=entry.host_values(), iterations=0,
                    cache_hit=True, mode="cache",
                )
                self.stats.n_cache_hits += 1
            elif entry is not None and self.incremental:
                results[s] = self._query_incremental(program, s)
            else:
                fresh.append(s)
        if fresh:
            results.update(self._query_fresh(program, fresh))
        self.stats.n_queries += len(sources)
        self.stats.extra[KEY_WARM_CACHE] = self.cache.stats.as_dict()
        return [results[k] for k in keyed]

    def _store(self, program, s, values, delta) -> None:
        self.cache.put(
            (program, s), self.version, values, delta,
            reserved_bytes=self.scheduler.pinned_bytes,
        )
        self._prune_reports()  # refreshed entries may raise the floor

    def _record_feedback(self, mispredictions, correction=None) -> None:
        """Refresh the cached correction and accumulate the misprediction
        count into ``stats.extra``."""
        if self._calibrator is None:
            return
        if correction is None and self.mesh is not None:
            # only rank 0's calibrator observes: its correction, on every rank
            from repro_torch.dist.graph_shard import _rank0_correction

            correction = _rank0_correction(self._calibrator, self.mesh)[1]
        elif correction is None:
            correction = torch.from_numpy(
                np.asarray(self._calibrator.correction(), np.float64).astype(np.float32)
            ).to(self.device)
        self._correction = correction
        self.stats.extra[KEY_ENGINE_CORRECTIONS] = self._correction.cpu().numpy().tolist()
        self.stats.extra[KEY_MISPREDICTIONS] = (
            self.stats.extra.get(KEY_MISPREDICTIONS, 0) + int(mispredictions))

    def _absorb_run(self, res) -> None:
        self._record_feedback(res.total_mispredictions)

    def _query_incremental(self, program, s) -> QueryResult:
        # spilled warm states come back through the device tier first
        # (bit-exact round trip), then replay the reports since their
        # version; a corrupt entry or an injected promote OOM falls back to
        # a full recompute
        entry = self.cache.promote((program, s))
        if entry is None:
            return self._query_fresh(program, [s])[s]
        res = run_incremental(
            self.dcsr, program, self._reports_since(entry.version),
            entry.host_values(), entry.host_delta(),
            source=s, config=self.config, calibrator=self._calibrator, mesh=self.mesh,
            obs=self.obs, faults=self.faults, retry=self._retry_policy(),
        )
        self._absorb_run(res)
        self._store(program, s, res.values, res.delta)
        self.stats.n_incremental += 1
        self.stats.sweep_iterations += res.iterations
        return QueryResult(
            source=s, values=res.values, iterations=res.iterations,
            cache_hit=False, mode="incremental",
        )

    def _runtime_for(self, program: VertexProgram):
        """The container's runtime for ``program``: its sharded view on the
        mesh, else its single-device view."""
        if self.mesh is not None:
            return self.dcsr.sharded_runtime_for(
                program, mesh=self.mesh, axis=self.config.mesh_axis,
                vertex_sharding=self.config.vertex_sharding)
        return self.dcsr.runtime_for(program)

    def _retry_policy(self):
        return self.supervisor.policy if self.supervisor is not None else None

    def _query_fresh(self, program, sources) -> dict:
        out: dict[int | None, QueryResult] = {}
        if program.peel_k is not None or (program.use_delta and not program.personalized):
            # global programs: a single full run each
            for s in sources:
                res = run_hytm(
                    None, program, source=s, config=self.config,
                    runtime=self._runtime_for(program), mesh=self.mesh,
                    calibrator=self._calibrator, obs=self.obs, faults=self.faults,
                    retry=self._retry_policy(),
                )
                self._absorb_run(res)
                self._store(program, s, res.values, res.delta)
                self.stats.n_full += 1
                self.stats.sweep_iterations += res.iterations
                out[s] = QueryResult(
                    source=s, values=res.values, iterations=res.iterations,
                    cache_hit=False, mode="batched",
                )
            return out
        # per-source programs ride the continuous scheduler's lanes
        served = self.scheduler.run_batch(program, sources)
        for s in sources:
            r = served[s]
            if r.mode == "rejected":
                raise RuntimeError(
                    f"device_budget_bytes={self.cache.policy.device_budget_bytes} "
                    f"cannot fit one lane ({self.scheduler.lane_bytes} bytes) — "
                    "query rejected")
            out[s] = QueryResult(
                source=s, values=r.values, iterations=r.iterations,
                cache_hit=False, mode=r.mode,
            )
        return out
