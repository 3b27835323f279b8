"""Supervised execution: retries, deadlines, and the degradation ladder.

The reference's ``repro/resilience/supervisor.py`` on one device.
:func:`guarded_dispatch` wraps one dispatch site with the fault plane and
a :class:`RetryPolicy` — exponential backoff, deadline-aware timeout
accounting, every attempt observable on the ``faults`` obs track.
Injected faults fire **before** the real dispatch, and the port's chunk
entry points never modify their input state, so a retry re-issues the
bit-identical dispatch.  A real exception out of the dispatch itself (a
kernel that fails to build or launch, a device error) is *not* retried
and *not* degraded: it propagates out of :func:`guarded_dispatch`,
``run_hytm`` and :func:`run_supervised` untouched.

:class:`Supervisor` adds the explicit degradation ladder on top.  Each
rung trades capability for an execution path whose *answers are
unchanged* — degradation here means slower, never wronger:

1. ``kernels -> oracle``: drop the hand-written CUDA kernels for their
   plain PyTorch versions (bit-identical for MIN programs by the kernel
   equivalence contract);
2. ``mesh -> single-device``: replay on one device with
   ``async_sweep=False``; on a mesh every rank replays on its own device,
   and rank 0 alone writes the replay's checkpoints;
3. ``cache-promote -> full recompute``: a warm entry that fails promotion
   (corrupt or OOM) is dropped and the request recomputes from scratch
   (handled in ``serve.warm_cache``/``serve.scheduler``);
4. ``load-shed``: under sustained allocation pressure the lowest-tier
   tenants' pending requests are shed (mode ``"shed"``) so admitted work
   still meets quota/budget invariants.

The ladder is taken on :class:`RetriesExhausted` from *injected* faults
only.  Every transition is emitted as a ``repro_torch.obs`` instant on
the ``faults`` track plus ``faults.*`` metric counters.
"""

from __future__ import annotations

import dataclasses
import time
from dataclasses import dataclass

import torch

from repro_torch.kernels.runtime import resolve_device, resolve_use_kernels
from repro_torch.resilience.faults import (
    DispatchTimeout,
    FaultError,
    FaultPlan,
    UpdateLost,
    error_for,
)


@dataclass(frozen=True)
class RetryPolicy:
    """Retry/backoff/deadline policy for one dispatch site.

    ``max_attempts`` bounds total tries (first attempt included).  Backoff
    for attempt ``i`` (0-based failure count) is
    ``min(backoff_s * factor**i, max_backoff_s)``.  ``deadline_s``, when
    set, is a wall budget for the whole site: injected timeouts charge
    ``timeout_charge_s`` of simulated elapsed time against it, and a retry
    that cannot fit before the deadline raises :class:`RetriesExhausted`
    at once."""

    max_attempts: int = 4
    backoff_s: float = 0.0
    factor: float = 2.0
    max_backoff_s: float = 2.0
    deadline_s: float | None = None
    timeout_charge_s: float = 0.0

    def backoff_for(self, failures: int) -> float:
        return min(self.backoff_s * self.factor ** failures, self.max_backoff_s)


class RetriesExhausted(RuntimeError):
    """A guarded dispatch ran out of attempts (or deadline)."""

    def __init__(self, site: str, attempts: int, last: BaseException,
                 reason: str = "attempts"):
        super().__init__(
            f"{site}: gave up after {attempts} attempt(s) ({reason}); last: {last}")
        self.site = site
        self.attempts = attempts
        self.last = last
        self.reason = reason


def record_fault_event(obs, name: str, **args) -> None:
    """Emit one fault-plane event on the ``faults`` obs track (no-op when
    ``obs`` is None)."""
    if obs is None:
        return
    from repro_torch.obs.export import CAT_FAULTS

    obs.instant(name, cat=CAT_FAULTS, track="faults", **args)
    obs.metrics.counter(f"faults.{name}").inc()


def guarded_dispatch(fn, *, site: str, faults: FaultPlan | None = None,
                     policy: RetryPolicy | None = None, obs=None,
                     stats: dict | None = None, sleep=time.sleep,
                     clock=time.monotonic, **ctx):
    """Run ``fn()`` under the fault plane with retry/backoff/deadline.

    With ``faults=None`` this is exactly ``fn()``.  With a plan but no
    ``policy``, an injected fault raises straight out (single attempt).
    ``ctx`` is matched against each spec's ``when`` filter.  Only injected
    faults are retried: whatever ``fn()`` itself raises propagates at
    once.  ``sleep``/``clock`` are injectable for deterministic tests."""
    if faults is None:
        return fn()
    attempts = policy.max_attempts if policy is not None else 1
    t0 = clock()
    elapsed_charge = 0.0
    failures = 0
    last: FaultError | None = None
    while True:
        kind = faults.fire(site, **ctx)
        if kind is None or kind not in ("fail", "timeout"):
            if kind is not None:
                # a non-dispatch kind (oom) injected at a dispatch site:
                # surface it, retrying would not help here
                raise error_for(kind, site, 0)
            return fn()
        occ = faults._site(site).occurrences - 1
        last = error_for(kind, site, occ)
        failures += 1
        if isinstance(last, DispatchTimeout) and policy is not None:
            elapsed_charge += policy.timeout_charge_s
        record_fault_event(obs, "injected", site=site, kind=kind,
                           occurrence=occ, attempt=failures)
        if stats is not None:
            stats["faults"] = stats.get("faults", 0) + 1
        if failures >= attempts:
            raise RetriesExhausted(site, failures, last)
        if policy is not None and policy.deadline_s is not None:
            spent = (clock() - t0) + elapsed_charge
            if spent + policy.backoff_for(failures - 1) >= policy.deadline_s:
                raise RetriesExhausted(site, failures, last, reason="deadline")
        backoff = policy.backoff_for(failures - 1) if policy else 0.0
        if backoff > 0.0:
            sleep(backoff)
        record_fault_event(obs, "retry", site=site, attempt=failures + 1)
        if stats is not None:
            stats["retries"] = stats.get("retries", 0) + 1


def next_rung(config, device: str | torch.device):
    """The next degradation rung for ``config`` on ``device``: ``(label,
    degraded config)`` or ``None`` when the ladder is exhausted.
    ``use_kernels="auto"`` resolves as the drivers resolve it, so on the
    CPU it has no kernels rung."""
    if resolve_use_kernels(config.use_kernels, torch.device(device)):
        return ("kernels->oracle", dataclasses.replace(config, use_kernels=False))
    if config.mesh_axis is not None:
        return ("mesh->single-device",
                dataclasses.replace(config, mesh_axis=None, async_sweep=False))
    return None


class Supervisor:
    """Shared retry policy + degradation/shedding state for a serving
    stack (one per ``GraphService``/``LaneScheduler``)."""

    def __init__(self, policy: RetryPolicy | None = None,
                 faults: FaultPlan | None = None, obs=None,
                 tenant_tiers: dict[str, int] | None = None,
                 shed_after: int = 3):
        self.policy = policy if policy is not None else RetryPolicy()
        self.faults = faults
        self.obs = obs
        # higher tier = more protected; unknown tenants get tier 0
        self.tenant_tiers = dict(tenant_tiers or {})
        self.shed_after = max(int(shed_after), 1)
        self.counters = {"faults": 0, "retries": 0, "degradations": 0, "shed": 0}
        self.degradations: list[tuple[str, str]] = []
        self._oom_streak = 0

    def dispatch(self, fn, *, site: str, **ctx):
        return guarded_dispatch(fn, site=site, faults=self.faults,
                                policy=self.policy, obs=self.obs,
                                stats=self.counters, **ctx)

    def degrade(self, rung: str, reason: str) -> None:
        self.degradations.append((rung, reason))
        self.counters["degradations"] += 1
        record_fault_event(self.obs, "degrade", rung=rung, reason=reason)

    # --- load shedding ---------------------------------------------------
    def note_alloc_pressure(self, oom: bool) -> bool:
        """Track consecutive allocation failures; True when the streak has
        been sustained long enough to shed."""
        self._oom_streak = self._oom_streak + 1 if oom else 0
        return self._oom_streak >= self.shed_after

    def tier(self, tenant: str) -> int:
        return self.tenant_tiers.get(tenant, 0)

    def shed_candidates(self, pending) -> list:
        """Pending requests to shed: everything from tenants strictly below
        the highest tier currently waiting.  A uniform-tier queue sheds
        nothing (pressure resolves through smaller batches)."""
        if not pending:
            return []
        top = max(self.tier(r.tenant) for r in pending)
        return [r for r in pending if self.tier(r.tenant) < top]

    def record_shed(self, request) -> None:
        self.counters["shed"] += 1
        record_fault_event(self.obs, "shed", tenant=request.tenant,
                           source=int(request.source))


def run_supervised(g, program, source=0, config=None, *, n_hubs: int = 0,
                   runtime=None, mesh=None, supervisor: Supervisor | None = None,
                   faults: FaultPlan | None = None,
                   policy: RetryPolicy | None = None,
                   ckpt_path=None, anchor: tuple[int, int] = (0, 0),
                   checkpoint_every: int = 1, obs=None, calibrator=None,
                   initial_state=None, device: str | torch.device | None = None):
    """``run_hytm`` under supervision: guarded dispatches, checkpoint at
    chunk boundaries, and the degradation ladder on retry exhaustion.

    When retries at a dispatch site are exhausted, the run restores from
    the last checkpoint (cold restart if none) and re-enters one rung
    down the ladder; the final answer is bit-identical for MIN programs
    at every rung.  Raises :class:`RetriesExhausted` only once the ladder
    itself is exhausted; any other exception propagates at once.  Runs on
    the runtime's device, else the mesh's on a mesh (every rank of it calls
    this with the same arguments), else on ``device`` (``cuda`` unless
    given ``device="cpu"``)."""
    from repro_torch.core.hytm import HyTMConfig, run_hytm
    from repro_torch.launch.mesh import make_graph_mesh
    from repro_torch.resilience.checkpoint import CheckpointHook, resume_run

    cfg = config if config is not None else HyTMConfig()
    # on a mesh: the group whose rank 0 alone writes checkpoints, on every
    # rung (the single-device replay runs on every rank)
    writers = None
    if cfg.mesh_axis is not None:
        if mesh is None:
            mesh = runtime.mesh if runtime is not None else make_graph_mesh(
                cfg.mesh_axis, device=device)
        writers = mesh
    if runtime is not None:
        dev = runtime.device
    else:
        dev = writers.device if writers is not None else resolve_device(device)
    sup = supervisor if supervisor is not None else Supervisor(
        policy=policy, faults=faults, obs=obs)
    rt = runtime
    have_ckpt = False
    while True:
        hook = None
        if ckpt_path is not None and cfg.sync_every > 1:
            n_nodes = g.n_nodes if g is not None else rt.n_nodes
            hook = CheckpointHook(
                ckpt_path, program=program.name, anchor=anchor,
                every=checkpoint_every, state_layout=cfg.vertex_sharding,
                n_nodes=n_nodes, mesh=writers)
        try:
            if have_ckpt:
                return resume_run(
                    ckpt_path, g, program, config=cfg, source=source,
                    n_hubs=n_hubs, runtime=rt, mesh=mesh,
                    expect_anchor=anchor, obs=obs, faults=sup.faults,
                    retry=sup.policy, checkpoint=hook, device=dev)
            return run_hytm(
                g, program, source=source, config=cfg, n_hubs=n_hubs,
                runtime=rt, mesh=mesh, initial_state=initial_state,
                calibrator=calibrator, obs=obs, faults=sup.faults,
                retry=sup.policy, on_chunk=hook, device=dev)
        except RetriesExhausted as e:
            rung = next_rung(cfg, dev)
            if rung is None:
                raise
            if hook is not None and hook.committed > 0:
                have_ckpt = True
            label, degraded = rung
            if "mesh" in label:
                # the runtime was built for the mesh; the single-device
                # replay rebuilds its own view
                rt = None
            sup.degrade(label, str(e))
            cfg = degraded


def deliver_update(target, batch, *, batch_id, faults: FaultPlan | None = None,
                   policy: RetryPolicy | None = None, obs=None,
                   sleep=time.sleep):
    """At-least-once update delivery with idempotent redelivery.

    ``target`` is a ``GraphService`` (``.update``) or ``DeltaCSR``
    (``.apply``).  An injected ``drop`` (site ``update_delivery``, fired
    inside the target before any mutation) is retried under ``policy``; an
    injected ``duplicate`` (site ``update_redeliver``) re-sends the same
    ``batch_id`` after success — the target's dedup cache returns the
    original report without bumping ``version``."""
    apply_fn = target.update if hasattr(target, "update") else target.apply
    attempts = policy.max_attempts if policy is not None else 1
    failures = 0
    while True:
        try:
            report = apply_fn(batch, batch_id=batch_id, faults=faults)
        except UpdateLost as e:
            failures += 1
            record_fault_event(obs, "injected", site="update_delivery",
                               kind="drop", attempt=failures)
            if failures >= attempts:
                raise RetriesExhausted("update_delivery", failures, e)
            backoff = policy.backoff_for(failures - 1) if policy else 0.0
            if backoff > 0.0:
                sleep(backoff)
            continue
        if faults is not None and faults.fire("update_redeliver") == "duplicate":
            record_fault_event(obs, "injected", site="update_redeliver",
                               kind="duplicate", batch_id=str(batch_id))
            dup = apply_fn(batch, batch_id=batch_id)
            if dup.version != report.version:
                raise RuntimeError("redelivery bumped the version: dedup broken")
        return report
