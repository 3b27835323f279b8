"""Deterministic, seeded fault-injection plane (the reference's
``repro/resilience/faults.py``, a host-side copy: one plan gives one fault
schedule and one corruption in both packages).

A :class:`FaultPlan` is the single source of injected failure for a run.
It is threaded through the stack exactly like ``obs=None``: every
instrumented site takes an optional ``faults`` handle and pays **zero
overhead when it is absent** — the no-faults code path is byte-for-byte
the unhooked one, so a run with ``faults=None`` is bit-identical to a
run on a build without the resilience plane at all.

Sites (the strings passed to :meth:`FaultPlan.fire`):

========================  ==================  =============================
site                      kinds               where it is checked
========================  ==================  =============================
``chunk_dispatch``        fail, timeout       ``core.hytm`` chunk and
                                              iteration drivers, before the
                                              dispatch
``lane_dispatch``         fail, timeout       ``serve.scheduler`` batched
                                              lane dispatch
``lane_alloc``            oom                 ``serve.scheduler`` batch
                                              formation (halves capacity)
``cache_promote``         oom                 ``serve.warm_cache`` host→
                                              device promotion
``host_spill``            corrupt             ``serve.warm_cache`` device→
                                              host spill
``update_delivery``       drop                ``stream.delta_csr.apply``
                                              (batch never arrives)
``update_redeliver``      duplicate           ``resilience.supervisor.
                                              deliver_update`` (batch
                                              arrives twice)
========================  ==================  =============================

Determinism: each site draws from its own ``numpy`` Generator seeded
from ``[plan.seed, crc32(site)]`` — *not* Python ``hash()``, which is
process-salted — so the same plan produces the same fault schedule in
any process, which is what makes the chaos gates replayable.  Faults
always fire *before* the real dispatch, and a chunk never modifies its
input state, so retrying the identical dispatch is bit-exact.
"""

from __future__ import annotations

import zlib
from dataclasses import dataclass

import numpy as np


class FaultError(RuntimeError):
    """Base class for injected failures (never raised by real code)."""

    def __init__(self, site: str, occurrence: int, msg: str | None = None):
        super().__init__(msg or f"injected fault at {site}#{occurrence}")
        self.site = site
        self.occurrence = occurrence


class DispatchFault(FaultError):
    """Injected ``fail``: the dispatch is lost before it starts."""


class DispatchTimeout(FaultError):
    """Injected ``timeout``: the dispatch hangs past its deadline."""


class DeviceOOM(FaultError):
    """Injected ``oom``: a device allocation request is refused."""


class UpdateLost(FaultError):
    """Injected ``drop``: an update batch never reaches the target."""


_ERRORS = {
    "fail": DispatchFault,
    "timeout": DispatchTimeout,
    "oom": DeviceOOM,
    "drop": UpdateLost,
}


def error_for(kind: str, site: str, occurrence: int) -> FaultError:
    """The exception modelling an injected ``kind`` at ``site``."""
    cls = _ERRORS.get(kind, FaultError)
    return cls(site, occurrence, f"injected {kind} at {site}#{occurrence}")


@dataclass(frozen=True)
class FaultSpec:
    """One scheduled failure mode at one site.

    ``at`` lists explicit 0-based occurrence indices (attempt-granular:
    ``at=(0,)`` fails the first attempt, the retry succeeds); ``p`` adds
    an independent per-occurrence probability on top.  ``max_fires``
    bounds the total injections from this spec; ``when`` restricts
    firing to occurrences whose call-site context matches every listed
    key (e.g. ``when={"kernels": True}`` stops firing once the ladder
    has degraded to the oracle path)."""

    site: str
    kind: str
    p: float = 0.0
    at: tuple[int, ...] = ()
    max_fires: int | None = None
    when: dict | None = None


@dataclass(frozen=True)
class FaultEvent:
    """One injected fault, as recorded in :attr:`FaultPlan.events`."""

    site: str
    kind: str
    occurrence: int


@dataclass
class _SiteState:
    rng: np.random.Generator
    occurrences: int = 0


class FaultPlan:
    """A seeded schedule of injected failures.

    Instrumented sites call :meth:`fire` once per attempt; it returns
    the fault ``kind`` to inject (or ``None``).  :meth:`check` is the
    raising convenience used by dispatch sites.  The plan records every
    injection in :attr:`events` so tests and the chaos bench can assert
    recovery cost is bounded *and observable*.
    """

    def __init__(self, specs: list[FaultSpec] | tuple = (), seed: int = 0):
        self.seed = int(seed)
        self.specs = tuple(specs)
        self.events: list[FaultEvent] = []
        self._sites: dict[str, _SiteState] = {}
        self._fires: dict[int, int] = {i: 0 for i in range(len(self.specs))}
        self._by_site: dict[str, list[int]] = {}
        for i, s in enumerate(self.specs):
            self._by_site.setdefault(s.site, []).append(i)

    def _site(self, site: str) -> _SiteState:
        st = self._sites.get(site)
        if st is None:
            # crc32, not hash(): stable across processes for replayable
            # cross-process chaos schedules
            st = _SiteState(np.random.default_rng(
                [self.seed, zlib.crc32(site.encode())]))
            self._sites[site] = st
        return st

    def fire(self, site: str, **ctx) -> str | None:
        """Advance ``site``'s occurrence counter; return the fault kind
        to inject at this occurrence, or ``None``."""
        st = self._site(site)
        occ = st.occurrences
        st.occurrences += 1
        for i in self._by_site.get(site, ()):
            spec = self.specs[i]
            if spec.max_fires is not None and self._fires[i] >= spec.max_fires:
                continue
            if spec.when is not None and any(
                    ctx.get(k) != v for k, v in spec.when.items()):
                continue
            hit = occ in spec.at
            if not hit and spec.p > 0.0:
                hit = float(st.rng.random()) < spec.p
            if hit:
                self._fires[i] += 1
                self.events.append(FaultEvent(site, spec.kind, occ))
                return spec.kind
        return None

    def check(self, site: str, **ctx) -> None:
        """:meth:`fire`, raising the matching :class:`FaultError`."""
        kind = self.fire(site, **ctx)
        if kind is not None:
            raise error_for(kind, site, self._site(site).occurrences - 1)

    def corrupt(self, arr: np.ndarray) -> np.ndarray:
        """A copy of ``arr`` with one deterministically chosen bit
        flipped (the host-spill corruption model)."""
        rng = self._site("__corrupt__").rng
        buf = np.array(arr, copy=True)
        flat = buf.reshape(-1).view(np.uint8)
        flat[int(rng.integers(0, flat.size))] ^= 0x80
        return buf

    @property
    def injected(self) -> int:
        """Total faults injected so far."""
        return len(self.events)

    def counts(self) -> dict[tuple[str, str], int]:
        """``{(site, kind): n_injected}`` summary."""
        out: dict[tuple[str, str], int] = {}
        for e in self.events:
            out[(e.site, e.kind)] = out.get((e.site, e.kind), 0) + 1
        return out

    def replace(self, **kw) -> "FaultPlan":
        """A fresh plan (zeroed counters) with fields overridden."""
        return FaultPlan(kw.get("specs", self.specs),
                         seed=kw.get("seed", self.seed))


def plan_of(*specs: FaultSpec, seed: int = 0) -> FaultPlan:
    """Convenience constructor: ``plan_of(FaultSpec(...), seed=3)``."""
    return FaultPlan(list(specs), seed=seed)
