"""Multi-tenant request queue with admission control (repro_torch.serve).

The reference's module (``repro/serve/queue.py``), pure Python, in the
port's own copy.

The queue is the front door of the continuous serving scheduler
(``repro_torch.serve.scheduler``): callers ``submit`` :class:`Request` objects
(tenant, program, source, deadline) and the scheduler pulls work through
:meth:`RequestQueue.admit` whenever lane slots free up.  Admission
enforces three policies, in this order:

* **per-tenant quotas** — a tenant never holds more than
  ``quota[tenant]`` in-flight lanes at once, whatever it submitted;
  excess requests stay queued (deferred, not dropped) until one of the
  tenant's lanes converges;
* **device-resident state budget** — each admitted request pins
  ``bytes_per_lane`` of device state (its (values, Δ, frontier) lane
  rows); admission stops as soon as the next admit would exceed the free
  byte budget the scheduler computed from
  ``TierPolicy.device_budget_bytes`` (a request that could *never* fit —
  ``bytes_per_lane`` above the whole budget — is rejected outright
  instead of deferred forever);
* **deadline-aware priority ordering** — among the requests eligible
  under the two constraints above, admission is strictly
  earliest-deadline-first (ties broken by arrival order), so an urgent
  query overtakes a backlog of lax ones.

Deferral is the default failure mode: a request that cannot be admitted
*now* (quota or budget) stays in the queue, keeps its deadline priority,
and is retried at the next chunk boundary.  ``stats`` counts admitted /
deferred / rejected outcomes; ``quota_violations`` stays 0 by
construction.
"""

from __future__ import annotations

import itertools
from dataclasses import dataclass, field
from typing import Callable

from repro_torch.graph.algorithms import VertexProgram

_SEQ = itertools.count()


@dataclass
class Request:
    """One serving request: run ``program`` from ``source`` for
    ``tenant``, wanted by ``deadline`` (any monotone priority scalar —
    the scheduler uses its virtual iteration clock; smaller = sooner;
    ``inf`` = best-effort).  ``arrival`` is a process-wide sequence
    number breaking deadline ties FIFO."""

    tenant: str
    program: VertexProgram
    source: int | None
    deadline: float = float("inf")
    arrival: int = field(default_factory=lambda: next(_SEQ))
    # filled in by the serving loop
    submit_vt: float = 0.0     # virtual time (engine iterations) at submit
    submit_wall: float = 0.0   # wall clock at submit


@dataclass
class QueueStats:
    submitted: int = 0
    admitted: int = 0
    deferred: int = 0          # admit() passes that left the request queued
    rejected: int = 0          # could never fit the device budget
    shed: int = 0              # withdrawn under sustained pressure
    quota_violations: int = 0  # stays 0 by construction


class RequestQueue:
    """Pending-request pool with quota/budget/deadline admission.

    ``quota`` is the default per-tenant in-flight lane cap;
    ``tenant_quotas`` overrides it per tenant.  ``None`` means unlimited
    (the degenerate single-tenant mode ``GraphService._query_fresh``
    uses)."""

    def __init__(self, quota: int | None = None,
                 tenant_quotas: dict[str, int] | None = None):
        self.quota = quota
        self.tenant_quotas = dict(tenant_quotas or {})
        self._pending: list[Request] = []
        self.stats = QueueStats()

    def __len__(self) -> int:
        return len(self._pending)

    def __bool__(self) -> bool:
        return bool(self._pending)

    def quota_for(self, tenant: str) -> int | None:
        return self.tenant_quotas.get(tenant, self.quota)

    def submit(self, req: Request) -> None:
        self._pending.append(req)
        self.stats.submitted += 1

    def pending(self) -> list[Request]:
        """Snapshot of the queued requests (shedding candidates)."""
        return list(self._pending)

    def withdraw(self, req: Request) -> bool:
        """Remove a pending request without serving it (load shedding —
        the supervisor's last degradation rung).  Counted in
        ``stats.shed``; returns False if ``req`` was not pending."""
        try:
            self._pending.remove(req)
        except ValueError:
            return False
        self.stats.shed += 1
        return True

    def peek_program(self) -> VertexProgram | None:
        """Program of the deadline-first pending request (the scheduler
        forms program-homogeneous lane batches, so the head request picks
        which program the next batch runs)."""
        if not self._pending:
            return None
        head = min(self._pending, key=lambda r: (r.deadline, r.arrival))
        return head.program

    def admit(
        self,
        n_slots: int,
        in_flight: dict[str, int],
        program: VertexProgram | None = None,
        free_bytes: float | None = None,
        bytes_per_lane: float = 0.0,
        total_budget: float | None = None,
        on_reject: Callable[[Request], None] | None = None,
    ) -> list[Request]:
        """Admit up to ``n_slots`` pending requests into lane slots.

        Selection is earliest-deadline-first (ties FIFO by ``arrival``)
        over the pending set, restricted to ``program`` when given (lane
        batches are program-homogeneous — one lane-batched sweep runs one
        program).  A candidate is **deferred** (left queued, retried at
        the next chunk boundary) when its tenant is at quota — counting
        both lanes already in flight (``in_flight``) and lanes admitted
        earlier in this same call — or when admitting it would push the
        pinned lane state past the free device byte budget
        (``free_bytes`` / ``bytes_per_lane``, as computed by the
        scheduler from ``TierPolicy.device_budget_bytes`` after warm-
        cache spilling).  It is **rejected** (removed, ``on_reject``
        called) only when it could *never* run: ``bytes_per_lane``
        exceeds ``total_budget``, or its tenant's quota is zero —
        deferral would just spin forever.

        Equivalence guarantee: admission decides *when* a request's lane
        starts, never what it computes — an admitted request's lane is
        seeded exactly as its standalone run (``program.init_state`` or
        the warm-cache replay state) and the lane-batched sweep keeps
        lanes independent, so deferral/reordering cannot change any result;
        only latency moves.  Invariants enforced here (and property-
        tested in ``tests/test_torch_serve.py``): no tenant ever exceeds its
        quota, admitted sets are deadline-ordered among eligible
        requests, and the pinned byte total never exceeds the budget.
        """
        admitted: list[Request] = []
        counts = dict(in_flight)
        budget_left = free_bytes
        eligible = [r for r in self._pending
                    if program is None or r.program == program]
        eligible.sort(key=lambda r: (r.deadline, r.arrival))
        # reject sweep first (even with n_slots=0): a request that can
        # never run must not sit deferred forever
        never_fits = (total_budget is not None
                      and bytes_per_lane > total_budget)
        doomed = [r for r in eligible
                  if never_fits
                  or (self.quota_for(r.tenant) is not None
                      and self.quota_for(r.tenant) <= 0)]
        for req in doomed:
            self._pending.remove(req)
            eligible.remove(req)
            self.stats.rejected += 1
            if on_reject is not None:
                on_reject(req)
        deferred_this_pass = 0
        for req in eligible:
            if len(admitted) >= n_slots:
                break
            quota = self.quota_for(req.tenant)
            if quota is not None and counts.get(req.tenant, 0) >= quota:
                deferred_this_pass += 1
                continue
            if budget_left is not None and bytes_per_lane > budget_left:
                deferred_this_pass += 1
                continue
            self._pending.remove(req)
            admitted.append(req)
            counts[req.tenant] = counts.get(req.tenant, 0) + 1
            if budget_left is not None:
                budget_left -= bytes_per_lane
        self.stats.admitted += len(admitted)
        self.stats.deferred += deferred_this_pass
        return admitted
