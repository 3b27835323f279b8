"""Continuous lane-batching scheduler (repro_torch.serve).

The reference's scheduler (``repro/serve/scheduler.py``) on one device.
The scheduler keeps the device busy with whatever work is ready instead of
blocking on fixed ``max_lanes`` batches:

* **static lane buckets** — lane counts come from a small static set
  (default ``{1, 2, 4, ..., max_lanes}``), and a partial batch is padded up
  to its bucket with *dead lanes* (``core.hytm.dead_lane_state``: empty
  frontier, zero Δ — no-ops that plan NONE everywhere and launch nothing);
* **continuous backfill** — each chunk dispatch
  (``core.hytm.hytm_batched_chunk``) returns the per-lane ``next_active``
  vector, so a lane that converges frees its slot at the chunk boundary
  and the scheduler backfills it from the queue mid-flight, writing the
  new lane's seed into the freed row of the (Q, n) state in place, while
  straggler lanes keep relaxing;
* **admission control** — slots are filled through ``RequestQueue.admit``
  (per-tenant quotas, deadline-first ordering, device byte budget); the
  warm cache spills to host RAM before a batch pins its lane state, so
  device-resident bytes (in-flight lanes + warm tier) never exceed
  ``TierPolicy.device_budget_bytes``;
* **warm lanes** — a request whose key has a warm (stale) cache entry is
  admitted as an *incremental* lane seeded by ``incremental_state``
  (promoting the entry from the host tier first if it was spilled).

Equivalence: lanes never interact, so every lane's answer equals its
standalone ``run_hytm`` / ``run_incremental`` run (bit for bit for MIN
programs, within tolerance for SUM), whatever the bucket padding, the
backfill timing or the other tenants.  The scheduler moves latency only.

Latency is tracked on two clocks: wall time and a deterministic virtual
clock (cumulative engine iterations executed).  Iteration counts are chunk
granular: a chunk's ``n_done`` is added to every live lane, its no-op
iterations after its own convergence included, as in the reference.

With the service's ``obs`` (a ``repro_torch.obs.TraceRecorder``) the
scheduler records one span a served request on its tenant's track
(``tenant:<name>``) and the ``serve.requests`` counter, the admission
outcome counters, the device bytes a batch pins (gauge and counter
sample), the lane occupancy a chunk, and one instant a backfill, all from
host state it keeps anyway.

With the service's ``faults`` (a ``repro_torch.resilience.FaultPlan``)
two sites fire: ``lane_dispatch`` guards every chunk dispatch
(``guarded_dispatch``, retried under the supervisor's policy), and
``lane_alloc`` fires at every batch and backfill formation: an OOM halves
the slots, and a streak the ``supervisor`` deems sustained sheds the
pending requests of the lower tiers (mode ``"shed"``).  Without a plan
neither site costs anything.

Sharded serving (the service's ``mesh``): each chunk runs
``dist.graph_shard.make_sharded_batched_chunk`` over the container's
sharded view, behind the same ``lane_dispatch`` guard, and charges the
second transfer-management level one chunk row at a time.  Under the
owner layout a lane pins its owned ``(n_loc,)`` slice (``lane_bytes`` is
``9·n_loc``), the lane state stacks each lane's owned slice, and the done
lanes' rows are gathered to canonical ``(n,)`` rows in one collective.
The ranks run one process each, so every host decision (admission,
buckets, backfill, the virtual clock, the byte budget of modeled bytes,
the cache's spills, promotes and evictions, the lane-done gather) is made
from values equal on every rank; wall time differs by rank, so only rank
0's calibrator observes and its correction is broadcast, and
``submit_wall``/``done_wall`` are per-rank statistics that decide nothing.
"""

from __future__ import annotations

import functools
import time
from dataclasses import dataclass
from typing import TYPE_CHECKING

import numpy as np
import torch

from repro_torch.core.cost_model import KEY_ICI_BYTES, KEY_ICI_TIME
from repro_torch.core.hytm import (
    HyTMState,
    _consume_warm,
    dead_lane_state,
    hytm_batched_chunk,
)
from repro_torch.graph.algorithms import VertexProgram
from repro_torch.resilience.supervisor import guarded_dispatch, record_fault_event
from repro_torch.serve.queue import Request, RequestQueue

if TYPE_CHECKING:  # pragma: no cover - type hints only
    from repro_torch.stream.service import GraphService


def default_buckets(max_lanes: int) -> tuple[int, ...]:
    """The static lane-count buckets: powers of two up to ``max_lanes``,
    plus ``max_lanes`` itself (padding waste bounded by 2x)."""
    if max_lanes < 1:
        raise ValueError(f"max_lanes must be >= 1, got {max_lanes}")
    buckets = []
    b = 1
    while b < max_lanes:
        buckets.append(b)
        b *= 2
    buckets.append(max_lanes)
    return tuple(buckets)


# state bytes one lane pins on device: values f32 + delta f32 + frontier
# bool, each (n,)
LANE_STATE_BYTES_PER_NODE = 4 + 4 + 1


@dataclass
class ServedResult:
    request: Request
    values: np.ndarray | None
    delta: np.ndarray | None
    iterations: int            # engine iterations this request's lane ran
    mode: str   # 'cache' | 'incremental' | 'batched' | 'rejected' | 'shed'
    submit_vt: float = 0.0
    done_vt: float = 0.0
    submit_wall: float = 0.0
    done_wall: float = 0.0

    @property
    def vt_latency(self) -> float:
        """Deterministic latency: engine iterations between submit and
        completion (queue wait + stragglers included)."""
        return self.done_vt - self.submit_vt

    @property
    def wall_latency(self) -> float:
        return self.done_wall - self.submit_wall


@dataclass
class SchedulerStats:
    chunks: int = 0
    engine_iterations: int = 0   # the virtual clock
    lane_iterations: int = 0     # live-lane iterations (occupancy numerator)
    slot_iterations: int = 0     # bucket-width iterations (denominator)
    backfills: int = 0
    batches: int = 0
    max_device_bytes: int = 0    # peak in-flight lanes + device-tier cache

    @property
    def occupancy(self) -> float:
        """Fraction of dispatched lane-slots that carried live work."""
        return self.lane_iterations / max(self.slot_iterations, 1)


@dataclass
class _LaneJob:
    request: Request
    mode: str                  # 'batched' | 'incremental'
    init: tuple                # (values, delta, frontier) on the device
    iters: int = 0


class LaneScheduler:
    """Continuous scheduler over one :class:`GraphService`'s container.

    ``GraphService._query_fresh`` drives it in degenerate single-tenant
    mode (no deadlines, no quotas); multi-tenant serving drives
    :meth:`pump` with a :class:`RequestQueue`."""

    def __init__(self, service: "GraphService",
                 buckets: tuple[int, ...] | None = None,
                 backfill: bool = True, supervisor=None):
        self.svc = service
        # optional repro_torch.resilience.Supervisor: the retry policy of
        # lane dispatches, OOM-streak tracking and tiered load shedding
        self.supervisor = supervisor
        # backfill=False degrades to the fixed-batch baseline: a batch runs
        # to full convergence before the queue is consulted again
        self.backfill = backfill
        self.buckets = tuple(sorted(set(
            buckets if buckets is not None
            else default_buckets(service.max_lanes))))
        if self.buckets[0] < 1:
            raise ValueError(f"lane buckets must be >= 1: {self.buckets}")
        self.stats = SchedulerStats()
        self.in_flight: dict[str, int] = {}   # tenant -> live lanes
        # device bytes pinned by the in-flight batch's lane state — the
        # warm cache reserves around this when entries are stored mid-flight
        self.pinned_bytes = 0

    # ------------------------------------------------------------- geometry
    @property
    def vt(self) -> int:
        return self.stats.engine_iterations

    @property
    def lane_bytes(self) -> int:
        """Device bytes one lane pins on a rank: its ``(n,)`` row, or under
        the owner layout its owned ``(n_loc,)`` slice."""
        n = self.svc.dcsr.n_nodes
        if self._owner_mode():
            n = -(-n // self.svc.mesh.size)
        return LANE_STATE_BYTES_PER_NODE * n

    def _owner_mode(self) -> bool:
        svc = self.svc
        return svc.mesh is not None and svc.config.vertex_sharding == "owner"

    def bucket_for(self, q: int) -> int:
        for b in self.buckets:
            if b >= q:
                return b
        return self.buckets[-1]

    def _budget_bucket_cap(self) -> int | None:
        """Largest admissible lane count under the device byte budget
        (the warm cache can spill to zero; in-flight lane state cannot)."""
        budget = self.svc.cache.policy.device_budget_bytes
        if budget is None:
            return None
        fit = [b for b in self.buckets if b * self.lane_bytes <= budget]
        return max(fit) if fit else 0

    # ------------------------------------------------------------ admission
    def _resolve_or_job(self, req: Request) -> ServedResult | _LaneJob:
        """Turn an admitted request into a finished result (exact-version
        cache hit) or a lane job seeded fresh / from the warm cache."""
        svc = self.svc
        key = (req.program, svc.key_source(req.program, req.source))
        entry = svc.cache.get(key)
        if entry is not None and entry.version == svc.version:
            svc.stats.n_cache_hits += 1
            return self._finish(req, entry.host_values(), entry.host_delta(), 0, "cache")
        if entry is not None and svc.incremental:
            # the reverse import edge (stream owns a scheduler) stays lazy
            from repro_torch.stream.incremental import incremental_state

            entry = svc.cache.promote(key)
            if entry is not None:
                state = incremental_state(
                    req.program, entry.host_values(), entry.host_delta(),
                    svc._reports_since(entry.version), svc.dcsr, key[1],
                )
                svc.stats.n_incremental += 1
                return _LaneJob(req, "incremental",
                                (state.values, state.delta, state.frontier))
        values, delta, frontier = req.program.init_state(
            svc.dcsr.n_nodes, key[1], svc.dcsr.device)
        svc.stats.n_full += 1
        return _LaneJob(req, "batched", (values, delta, frontier))

    def _finish(self, req: Request, values, delta, iters: int,
                mode: str) -> ServedResult:
        done_wall = time.monotonic()
        res = ServedResult(
            request=req, values=values, delta=delta, iterations=iters,
            mode=mode, submit_vt=req.submit_vt, done_vt=self.vt,
            submit_wall=req.submit_wall, done_wall=done_wall,
        )
        obs = self.svc.obs
        if obs is not None:
            # one span per served request on its tenant's track: wall
            # coordinates are the submit -> done monotonic stamps, the
            # virtual window submit_vt -> the scheduler's clock
            wall0 = obs.wall_at(req.submit_wall) if req.submit_wall else obs.wall()
            obs.span(
                f"request:{mode}", cat="serve", track=f"tenant:{req.tenant}",
                wall=wall0, wall_dur=max(obs.wall_at(done_wall) - wall0, 0.0),
                vt=float(req.submit_vt), vt_dur=float(self.vt - req.submit_vt),
                iterations=iters, program=req.program.name,
                source=-1 if req.source is None else int(req.source),
            )
            obs.metrics.counter("serve.requests", "served requests by mode/tenant").inc(
                1, mode=mode, tenant=req.tenant)
        return res

    def _admit_jobs(
        self, queue: RequestQueue, program: VertexProgram, n_slots: int,
        results: list[ServedResult],
    ) -> list[_LaneJob]:
        """Admit up to ``n_slots`` lane jobs for ``program``: requests
        resolved instantly by the cache do not consume a slot, so keep
        admitting until the slots are full or nothing admissible is left.
        Rejections and instant cache resolutions land in ``results``."""
        budget = self.svc.cache.policy.device_budget_bytes
        obs = self.svc.obs
        qs = queue.stats
        before = (qs.admitted, qs.deferred, qs.rejected)
        jobs: list[_LaneJob] = []
        while True:
            admitted = queue.admit(
                n_slots - len(jobs), self.in_flight, program=program,
                free_bytes=budget, bytes_per_lane=self.lane_bytes,
                total_budget=budget,
                on_reject=lambda r: results.append(
                    self._finish(r, None, None, 0, "rejected")),
            )
            if not admitted:
                break
            for req in admitted:
                out = self._resolve_or_job(req)
                if isinstance(out, ServedResult):
                    results.append(out)
                else:
                    jobs.append(out)
                    self.in_flight[req.tenant] = self.in_flight.get(req.tenant, 0) + 1
            if len(jobs) >= n_slots:
                break
        if obs is not None:
            m = obs.metrics
            for name, prev, cur in zip(("admitted", "deferred", "rejected"), before,
                                       (qs.admitted, qs.deferred, qs.rejected)):
                if cur > prev:
                    m.counter(f"admission.{name}", "queue admission outcomes").inc(cur - prev)
        return jobs

    # ------------------------------------------------------------- dispatch
    def _lane_triple(self, program: VertexProgram, triple) -> tuple:
        """One lane's ``(n,)`` (values, Δ, frontier) as the lane state holds
        it: as it is, or under the owner layout this rank's owned slice of
        it padded with the program's inert fills
        (``dist.graph_shard.owner_state_pad_values``)."""
        if not self._owner_mode():
            return triple
        from repro_torch.dist.graph_shard import _owner_place_state

        st = _owner_place_state(self.svc._runtime_for(program), program, *triple)
        return st.values, st.delta, st.frontier

    def _stack_state(self, program: VertexProgram,
                     jobs: list[_LaneJob | None], bucket: int) -> HyTMState:
        n = self.svc.dcsr.n_nodes
        dead = dead_lane_state(program, n, self.svc.dcsr.device)
        triples = [j.init if j is not None else dead for j in jobs]
        triples += [dead] * (bucket - len(jobs))
        triples = [self._lane_triple(program, t) for t in triples]
        return HyTMState(
            values=torch.stack([t[0] for t in triples]),
            delta=torch.stack([t[1] for t in triples]),
            frontier=torch.stack([t[2] for t in triples]),
        )

    def _dispatch(self, program: VertexProgram, state: HyTMState,
                  bucket: int, correction):
        """One chunk dispatch over the bucketed lane batch; returns
        ``(state, n_done, lane_active, correction)`` with ``lane_active`` a
        host list and the calibrator fed once per chunk."""
        svc = self.svc
        cfg = svc.config
        chunk = max(cfg.sync_every, 1)
        if svc.mesh is not None:
            return self._dispatch_sharded(program, state, bucket, correction, chunk)
        rt = svc.dcsr.runtime_for(program)
        # the reference's compile key: a signature's first chunk pays for
        # kernel builds and allocator growth, so it does not feed the
        # calibrator
        warm = _consume_warm((
            "serve-lanes", program, cfg, rt.n_hub_partitions,
            bucket, svc.dcsr.n_nodes, rt.csr.capacity,
            rt.parts.n_partitions, rt.parts.block_size,
            chunk, correction is not None,
        ))
        t_chunk = time.monotonic()
        # faults fire before the dispatch, and the chunk never modifies its
        # input state, so a retry is bit-identical
        sup = self.supervisor
        state, n_done, lane_active, pe_sum, mp_sum = guarded_dispatch(
            functools.partial(hytm_batched_chunk, state, rt, program, cfg, chunk,
                              correction),
            site="lane_dispatch", faults=svc.faults,
            policy=sup.policy if sup is not None else None, obs=svc.obs,
            stats=sup.counters if sup is not None else None, bucket=bucket)
        correction = self._observe(pe_sum, mp_sum, t_chunk, warm, correction)
        return state, n_done, lane_active.tolist(), correction

    def _dispatch_sharded(self, program, state, bucket, correction, chunk):
        """:meth:`_dispatch` on the mesh: one
        ``make_sharded_batched_chunk`` over the container's sharded view,
        then the second level's charge of each iteration the chunk ran (all
        lanes merge in one batched collective: ``halo_level_cost`` of the
        lane-summed merged entries capped at ``bucket·halo_total`` under
        the owner layout, ``ici_level_cost`` of ``bucket·n`` entries
        otherwise), into ``stats.extra`` and ``obs``."""
        from repro_torch.dist.graph_shard import (halo_level_cost, ici_level_cost,
                                                  make_sharded_batched_chunk)

        svc = self.svc
        cfg, mesh = svc.config, svc.mesh
        rt = svc._runtime_for(program)
        warm = _consume_warm((
            "serve-lanes-sharded", program, cfg, bucket, rt.n_nodes, rt.n_pad,
            rt.n_partitions, rt.parts.block_size, mesh.rank, mesh.size, chunk,
            correction is not None,
        ))
        t_chunk = time.monotonic()
        sup = self.supervisor
        state, n_done, lane_active, pe_sum, mp_sum, merged = guarded_dispatch(
            functools.partial(make_sharded_batched_chunk(rt, program, cfg, chunk), state,
                              correction),
            site="lane_dispatch", faults=svc.faults,
            policy=sup.policy if sup is not None else None, obs=svc.obs,
            stats=sup.counters if sup is not None else None, bucket=bucket, mesh=True)
        # lane_active and the merged rows reach the host in one copy
        host = torch.cat([lane_active, merged]).tolist()
        lane_active, merged = host[:bucket], host[bucket:]
        correction = self._observe(pe_sum, mp_sum, t_chunk, warm, correction)
        corr_np = (correction.cpu().numpy().astype(float)
                   if correction is not None else None)
        n, base, obs = svc.dcsr.n_nodes, self.stats.engine_iterations, svc.obs
        for k, me in enumerate(merged):
            halo_entries = None
            if rt.halo is not None:
                # each lane's compacted exchange is capped by the same halo
                cap = float(bucket) * float(rt.halo.halo_total)
                halo_entries = min(float(me), cap)
                ib, it_, ie = halo_level_cost(bucket * n, float(me), cap, mesh.size,
                                              cfg.ici_link, corr_np)
            else:
                ib, it_, ie = ici_level_cost(bucket * n, float(me), mesh.size,
                                             cfg.ici_link, corr_np)
            svc.stats.extra[KEY_ICI_BYTES] = svc.stats.extra.get(KEY_ICI_BYTES, 0.0) + ib
            svc.stats.extra[KEY_ICI_TIME] = svc.stats.extra.get(KEY_ICI_TIME, 0.0) + it_
            if obs is not None:
                from repro_torch.obs.record import record_ici

                record_ici(obs, track="ici", it=base + k, bytes_=ib, seconds=it_, engine=ie,
                           merged_entries=float(me), halo_entries=halo_entries)
        return state, n_done, lane_active, correction

    def _observe(self, pe_sum, mp_sum, t_chunk, warm, correction):
        """Feed the service's calibrator one chunk (on a mesh rank 0's
        alone: the ranks' wall clocks differ) and return the correction
        every rank then holds."""
        svc = self.svc
        if svc._calibrator is None:
            return correction
        refreshed = None
        if svc.mesh is None or svc.mesh.rank == 0:
            refreshed = svc._calibrator.observe_chunk(
                pe_sum, pe_sum.cpu().numpy().astype(float), t_chunk, skip=not warm)
        # on a mesh _record_feedback broadcasts rank 0's correction
        svc._record_feedback(int(mp_sum), refreshed if svc.mesh is None else None)
        return svc._correction

    def _done_rows(self, state: HyTMState, done_idx: list) -> tuple:
        """The done lanes' canonical ``(k, n)`` (values, Δ) rows on the
        device: under the owner layout the rank's ``(k, n_loc)`` slices of
        both gathered in ONE collective, the pads sliced off."""
        rows = [torch.stack([getattr(state, f)[i] for i in done_idx])
                for f in ("values", "delta")]
        if not self._owner_mode():
            return tuple(rows)
        from repro_torch.dist.graph_shard import all_gather_owned

        both = all_gather_owned(torch.cat(rows), self.svc.mesh)[:, :self.svc.dcsr.n_nodes]
        k = len(done_idx)
        return both[:k], both[k:]

    def _alloc_pressure(self, queue: RequestQueue, slots: int,
                        results: list, floor: int) -> int:
        """Fire the ``lane_alloc`` fault site for one batch (or backfill)
        formation.  An injected OOM halves the slot count for this round
        (not below ``floor``): lanes are independent, so a narrower batch
        defers work without changing any lane's answer.  A sustained OOM
        streak trips the supervisor's load-shed rung: pending requests of
        tenants below the top waiting tier are withdrawn and finished as
        mode ``"shed"``.  No-op (returns ``slots``) without a fault plan."""
        svc = self.svc
        if svc.faults is None:
            return slots
        oom = svc.faults.fire("lane_alloc") == "oom"
        if oom:
            slots = max(slots // 2, floor)
            record_fault_event(svc.obs, "injected", site="lane_alloc", kind="oom")
        sup = self.supervisor
        if sup is not None and sup.note_alloc_pressure(oom):
            for req in sup.shed_candidates(queue.pending()):
                if queue.withdraw(req):
                    sup.record_shed(req)
                    results.append(self._finish(req, None, None, 0, "shed"))
        return slots

    # ------------------------------------------------------------ main loop
    def pump(self, queue: RequestQueue) -> list[ServedResult]:
        """Drain ``queue``: form program-homogeneous bucketed lane batches,
        dispatch chunks, free converged lanes at chunk boundaries, and
        backfill freed slots from the queue mid-flight.  Returns every
        request served this call (including instant cache resolutions and
        rejections), in completion order."""
        svc = self.svc
        obs = svc.obs
        results: list[ServedResult] = []
        while queue:
            cap = self._budget_bucket_cap()
            max_slots = self.buckets[-1] if cap is None else cap
            max_slots = self._alloc_pressure(queue, max_slots, results, floor=1)
            if not queue:
                break  # everything pending was shed
            program = queue.peek_program()
            pending_before = len(queue)
            jobs = self._admit_jobs(queue, program, max(max_slots, 0), results)
            if not jobs:
                if len(queue) == pending_before:
                    # nothing admitted, resolved, or rejected, and no lane in
                    # flight: no chunk boundary can unblock the rest
                    break
                continue  # all resolved/rejected instantly; queue shrank
            bucket = self.bucket_for(len(jobs))
            # warm states yield the device to live lanes: spill the cache
            # until lanes + device tier fit the budget, then record peak
            self.pinned_bytes = bucket * self.lane_bytes
            svc.cache.shrink_to_budget(reserved_bytes=self.pinned_bytes)
            self.stats.max_device_bytes = max(
                self.stats.max_device_bytes, self.pinned_bytes + svc.cache.device_bytes)
            self.stats.batches += 1
            if obs is not None:
                obs.metrics.gauge(
                    "serve.device_bytes", "in-flight lanes + device-tier cache bytes").set(
                    float(self.pinned_bytes + svc.cache.device_bytes))
                obs.counter("device_bytes", self.pinned_bytes + svc.cache.device_bytes,
                            cat="serve", track="scheduler", vt=float(self.vt))
            lane_jobs: list[_LaneJob | None] = list(jobs) + [None] * (bucket - len(jobs))
            state = self._stack_state(program, lane_jobs, bucket)
            correction = svc._correction
            if svc._calibrator is not None and correction is None:
                correction = torch.ones(3, dtype=torch.float32, device=svc.dcsr.device)

            while any(j is not None for j in lane_jobs):
                state, n_done, lane_active, correction = self._dispatch(
                    program, state, bucket, correction)
                live = sum(j is not None for j in lane_jobs)
                self.stats.chunks += 1
                self.stats.engine_iterations += n_done
                self.stats.lane_iterations += live * n_done
                self.stats.slot_iterations += bucket * n_done
                if obs is not None:
                    obs.metrics.gauge(
                        "serve.occupancy", "live-lane fraction of dispatched slots").set(
                        self.stats.occupancy)
                    obs.counter("lane_occupancy", live / bucket, cat="serve",
                                track="scheduler", vt=float(self.vt))
                for j in lane_jobs:
                    if j is not None:
                        j.iters += n_done
                # a lane is done when its frontier drained — or it hit the
                # iteration cap (max_iters at chunk granularity)
                done_idx = [
                    i for i, j in enumerate(lane_jobs)
                    if j is not None and (
                        lane_active[i] == 0 or j.iters >= svc.config.max_iters)
                ]
                if not done_idx:
                    continue
                # the done rows to the host in one copy each; the cache gets
                # its own device copies (WarmCache.put), so the backfill
                # below may overwrite these rows in place
                values_dev, deltas_dev = self._done_rows(state, done_idx)
                values, deltas = values_dev.cpu().numpy(), deltas_dev.cpu().numpy()
                freed = 0
                for k, i in enumerate(done_idx):
                    job = lane_jobs[i]
                    key_src = svc.key_source(program, job.request.source)
                    svc._store(program, key_src, values_dev[k], deltas_dev[k])
                    svc.stats.sweep_iterations += job.iters
                    results.append(self._finish(
                        job.request, values[k], deltas[k], job.iters, job.mode))
                    lane_jobs[i] = None
                    self.in_flight[job.request.tenant] -= 1
                    if self.in_flight[job.request.tenant] <= 0:
                        del self.in_flight[job.request.tenant]
                    freed += 1
                del values_dev, deltas_dev
                # backfill freed slots mid-flight: the bucket never changes;
                # new jobs drop into the freed rows at the chunk boundary
                if self.backfill and queue:
                    # a backfill is a batch formation too: floor 0, since the
                    # outer loop re-forms batches, admitting nothing here
                    # cannot deadlock
                    freed = self._alloc_pressure(queue, freed, results, floor=0)
                if self.backfill and queue:
                    refill = self._admit_jobs(queue, program, freed, results)
                    slots = [i for i, j in enumerate(lane_jobs) if j is None]
                    for slot, job in zip(slots, refill):
                        lane_jobs[slot] = job
                        v, d, f = self._lane_triple(program, job.init)
                        state.values[slot].copy_(v)
                        state.delta[slot].copy_(d)
                        state.frontier[slot].copy_(f)
                        self.stats.backfills += 1
                        if obs is not None:
                            obs.metrics.counter("serve.backfills",
                                                "mid-flight lane refills").inc(1)
                            obs.instant("backfill", cat="serve", track="scheduler",
                                        vt=float(self.vt), slot=slot,
                                        tenant=job.request.tenant, mode=job.mode)
            self.pinned_bytes = 0
        return results

    # ------------------------------------------------- service entry point
    def run_batch(self, program: VertexProgram, sources) -> dict:
        """Degenerate single-tenant mode for ``GraphService._query_fresh``:
        wrap ``sources`` as quota-free requests, drain them, and return
        ``{source: ServedResult}``."""
        q = RequestQueue()
        for s in sources:
            q.submit(Request(tenant="_local", program=program, source=s,
                             submit_vt=self.vt, submit_wall=time.monotonic()))
        served = self.pump(q)
        return {r.request.source: r for r in served}
