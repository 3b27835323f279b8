"""Tiered warm-state cache for the serving stack (repro_torch.serve).

The reference's two-tier cache (``repro/serve/warm_cache.py``) on one
device.  Converged (values, Δ) states are the serving stack's working set:
a repeat query at the same graph version is a pure hit, and a stale state
warm-starts incremental recomputation (``repro_torch.stream.incremental``)
instead of a from-scratch sweep.  Two tiers, after Totem's hybrid
host/device state placement:

* **device tier** — entries held as torch tensors on the cache's device,
  usable as warm-start seeds with no transfer.  Bounded by
  ``TierPolicy.device_budget_bytes`` (LRU): inserting or touching past the
  budget *spills* the least-recently-used device entries to...
* **host tier** — the same states as numpy arrays in host RAM.  A query
  that hits a host entry *promotes* it back to the device tier
  (:meth:`WarmCache.promote`).  Both copies are byte copies, so the
  spill → promote round trip is bit-exact;
* entries **too stale to replay** the retained report suffix are evicted
  outright from either tier (``GraphService._prune_reports``).

The device tier owns its tensors: :meth:`WarmCache.put` copies what it is
given, so an entry never views a lane row of the scheduler's (Q, n) state,
which the next backfill overwrites in place.

With ``obs`` (a ``repro_torch.obs.TraceRecorder``) per-tier hits,
misses and the tier transitions (spill, promote, evict, a checksum
mismatch and an injected promote OOM) emit one instant and one
``cache.<event>`` counter each on the ``cache`` track.

With ``faults`` (a ``repro_torch.resilience.FaultPlan``) two sites fire:
``cache_promote`` (``oom``: the promote is refused, the entry stays on the
host and :meth:`WarmCache.promote` returns ``None``) and ``host_spill``
(``corrupt``: the spilled bytes are damaged *after* the checksum is taken,
so the check at promote catches them).

With an :class:`OwnerPlacement` (sharded serving under the owner layout)
a device-tier entry holds this rank's owned ``(n_loc,)`` slice and the
budget counts that per-rank share; the host tier stays canonical ``(n,)``,
so reading a device entry's values gathers the slices, a collective every
rank of the group makes alike.
"""

from __future__ import annotations

import zlib
from dataclasses import dataclass
from typing import Iterator

import numpy as np
import torch

from repro_torch.kernels.runtime import resolve_device

DEVICE, HOST = "device", "host"


def state_checksum(values, delta) -> int:
    """crc32 over the float32 (values, Δ) byte images — the reference's
    integers for the same arrays.  Computed at spill time and re-verified
    at promote time."""
    crc = zlib.crc32(np.ascontiguousarray(_host(values)).tobytes())
    return zlib.crc32(np.ascontiguousarray(_host(delta)).tobytes(), crc)


def _host(arr) -> np.ndarray:
    return arr.detach().cpu().numpy() if torch.is_tensor(arr) else np.asarray(arr)


def _nbytes(t) -> int:
    return int(t.numel() * t.element_size()) if torch.is_tensor(t) else int(t.nbytes)


@dataclass(frozen=True)
class OwnerPlacement:
    """Owner-sharded device-tier placement for one rank of ``mesh`` (a
    ``launch.mesh.GraphMesh``): a device entry is this rank's ``(n_loc,)``
    slice of the state padded to ``n_pad = n_loc·D`` (zeros on the last
    rank), so one cached state costs a rank ``8·n_loc`` bytes, the
    granularity the budget counts.  :meth:`to_host` gathers the slices
    back to the canonical ``(n,)`` array (one ``all_gather``), so checksums
    cover the canonical bytes and the spill and promote round trip is
    bit-exact."""

    mesh: object
    n_nodes: int

    @property
    def n_loc(self) -> int:
        return -(-self.n_nodes // self.mesh.size)

    @property
    def n_pad(self) -> int:
        return self.n_loc * self.mesh.size

    def to_device(self, arr) -> torch.Tensor:
        """This rank's owned slice of a canonical ``(n,)`` host array or
        tensor, copied to the mesh's device."""
        lo = self.mesh.rank * self.n_loc
        hi = min(lo + self.n_loc, self.n_nodes)
        x = arr.detach() if torch.is_tensor(arr) else torch.from_numpy(np.asarray(arr))
        real = x[lo:max(lo, hi)].to(self.mesh.device, copy=True)
        extra = self.n_loc - real.shape[0]
        return torch.cat([real, real.new_zeros(extra)]) if extra else real

    def to_host(self, arr: torch.Tensor) -> np.ndarray:
        """The canonical ``(n,)`` array of a device entry's slices."""
        from repro_torch.dist.graph_shard import all_gather_owned

        return all_gather_owned(arr, self.mesh)[:self.n_nodes].cpu().numpy()


@dataclass(frozen=True)
class TierPolicy:
    """``device_budget_bytes``: LRU byte budget of the device tier (``None``
    = unbounded); ``max_reports``: how many update reports are retained
    for promote-time replay."""

    device_budget_bytes: int | None = None
    max_reports: int = 256


@dataclass
class CacheStats:
    device_hits: int = 0
    host_hits: int = 0
    misses: int = 0
    spills: int = 0        # device -> host demotions
    promotions: int = 0    # host -> device
    evictions: int = 0     # dropped from both tiers (unreplayable / dead)
    corrupt: int = 0       # host entries failing checksum on promote
    promote_failures: int = 0  # promotes refused (corrupt or device OOM)

    def as_dict(self) -> dict:
        return {
            "device_hits": self.device_hits, "host_hits": self.host_hits,
            "misses": self.misses, "spills": self.spills,
            "promotions": self.promotions, "evictions": self.evictions,
            "corrupt": self.corrupt,
            "promote_failures": self.promote_failures,
        }


@dataclass
class WarmEntry:
    version: int
    values: object          # torch.Tensor (device tier) | np.ndarray (host)
    delta: object
    tier: str = DEVICE
    nbytes: int = 0
    lru: int = 0
    checksum: int | None = None  # set at spill, verified at promote
    placement: OwnerPlacement | None = None  # device entries: owned slices

    def _canonical(self, arr) -> np.ndarray:
        if self.tier == DEVICE and self.placement is not None:
            return self.placement.to_host(arr)
        return _host(arr)

    def host_values(self) -> np.ndarray:
        """The values as a host ``(n,)`` array (a copy for a device entry;
        under an owner placement the slices gathered, a collective)."""
        return self._canonical(self.values)

    def host_delta(self) -> np.ndarray:
        return self._canonical(self.delta)


class WarmCache:
    """Two-tier LRU warm-state cache, dict-like over ``(program, source)``
    keys.  Device-tier entries live on ``device`` (``cuda`` unless given),
    or, with ``placement``, as owned slices on the placement mesh's
    device."""

    def __init__(self, policy: TierPolicy | None = None, obs=None,
                 faults=None, placement: OwnerPlacement | None = None,
                 device: str | torch.device | None = None):
        self.policy = policy or TierPolicy()
        self.placement = placement
        self.device = (placement.mesh.device if placement is not None
                       else resolve_device(device))
        self._entries: dict = {}
        self._clock = 0
        self.stats = CacheStats()
        self.obs = obs
        self.faults = faults

    def _obs_event(self, name: str, key=None, **args) -> None:
        if self.obs is None:
            return
        self.obs.metrics.counter(f"cache.{name}", "warm-cache tier events").inc(
            1, **({"tier": args["tier"]} if "tier" in args else {}))
        if key is not None:
            args["key"] = repr(key)
        self.obs.instant(name, cat="cache", track="cache",
                         vt=float(self._clock), **args)

    # ------------------------------------------------------------- dict-like
    def __contains__(self, key) -> bool:
        return key in self._entries

    def __len__(self) -> int:
        return len(self._entries)

    def __delitem__(self, key) -> None:
        self.evict(key)

    def keys(self):
        return self._entries.keys()

    def values(self):
        return self._entries.values()

    def items(self):
        return self._entries.items()

    def __iter__(self) -> Iterator:
        return iter(self._entries)

    # ------------------------------------------------------------------ core
    @property
    def device_bytes(self) -> int:
        return sum(e.nbytes for e in self._entries.values() if e.tier == DEVICE)

    def _touch(self, entry: WarmEntry) -> None:
        self._clock += 1
        entry.lru = self._clock

    def _to_device(self, arr) -> torch.Tensor:
        """A copy of ``arr`` on the cache's device that nothing else views
        (the rank's owned slice of it under a placement)."""
        if self.placement is not None:
            return self.placement.to_device(arr)
        if torch.is_tensor(arr):
            return arr.detach().to(self.device, copy=True)
        return torch.from_numpy(np.array(arr, copy=True)).to(self.device)

    def peek(self, key) -> WarmEntry | None:
        """Counter-free lookup (still bumps LRU)."""
        entry = self._entries.get(key)
        if entry is not None:
            self._touch(entry)
        return entry

    def check(self, key) -> WarmEntry | None:
        """:meth:`peek` plus integrity verification of a host-tier entry
        against its spill-time checksum: a mismatch is counted, evicted and
        ``None`` returned."""
        entry = self.peek(key)
        if entry is None:
            return None
        if (entry.tier == HOST and entry.checksum is not None
                and state_checksum(entry.values, entry.delta) != entry.checksum):
            self.stats.corrupt += 1
            self._obs_event("corrupt", key, nbytes=entry.nbytes)
            self.evict(key)
            return None
        return entry

    def get(self, key) -> WarmEntry | None:
        """Look up without tier movement, bumping LRU and the per-tier
        hit/miss counters."""
        entry = self._entries.get(key)
        if entry is None:
            self.stats.misses += 1
            self._obs_event("miss", key)
            return None
        self._touch(entry)
        if entry.tier == DEVICE:
            self.stats.device_hits += 1
        else:
            self.stats.host_hits += 1
        self._obs_event("hit", key, tier=entry.tier)
        return entry

    def put(self, key, version: int, values, delta,
            reserved_bytes: int = 0) -> WarmEntry:
        """Insert/refresh ``key`` in the device tier (copies of ``values``
        and ``delta``), then spill LRU entries to host until the tier fits
        the budget minus ``reserved_bytes`` (in-flight lane state)."""
        values = self._to_device(values)
        delta = self._to_device(delta)
        entry = WarmEntry(version=version, values=values, delta=delta, tier=DEVICE,
                          nbytes=_nbytes(values) + _nbytes(delta), placement=self.placement)
        self._touch(entry)
        self._entries[key] = entry
        self.shrink_to_budget(reserved_bytes)
        return entry

    def promote(self, key, reserved_bytes: int = 0) -> WarmEntry | None:
        """Promote ``key``'s state back to the device tier, spilling colder
        entries if the budget requires; the round trip is bit-exact.  A host
        entry whose bytes no longer match its spill-time checksum is
        counted, evicted, and ``None`` returned; an injected
        ``cache_promote`` OOM returns ``None`` and leaves the entry on the
        host."""
        entry = self._entries.get(key)
        if entry is None:
            return None
        if entry.tier == HOST:
            if entry.checksum is not None and state_checksum(
                    entry.values, entry.delta) != entry.checksum:
                self.stats.corrupt += 1
                self.stats.promote_failures += 1
                self._obs_event("corrupt", key, nbytes=entry.nbytes)
                self.evict(key)
                return None
            if self.faults is not None and self.faults.fire("cache_promote") == "oom":
                self.stats.promote_failures += 1
                self._obs_event("promote_oom", key, nbytes=entry.nbytes)
                return None
            entry.values = self._to_device(entry.values)
            entry.delta = self._to_device(entry.delta)
            entry.tier = DEVICE
            entry.nbytes = _nbytes(entry.values) + _nbytes(entry.delta)
            entry.checksum = None
            self.stats.promotions += 1
            self._obs_event("promote", key, nbytes=entry.nbytes)
            self._touch(entry)
            self.shrink_to_budget(reserved_bytes, keep=key)
        return entry

    def _spill(self, key) -> None:
        entry = self._entries[key]
        entry.values = entry.host_values()
        entry.delta = entry.host_delta()
        entry.tier = HOST
        entry.nbytes = _nbytes(entry.values) + _nbytes(entry.delta)
        entry.checksum = state_checksum(entry.values, entry.delta)
        if self.faults is not None and self.faults.fire("host_spill") == "corrupt":
            # the spilled bytes land damaged; the checksum (taken from the
            # intact state) catches this at promote time
            entry.values = self.faults.corrupt(entry.values)
        self.stats.spills += 1
        self._obs_event("spill", key, nbytes=entry.nbytes)

    def shrink_to_budget(self, reserved_bytes: int = 0, keep=None) -> None:
        """Spill LRU device entries to host until ``device_bytes <=
        device_budget_bytes - reserved_bytes``; ``keep`` is exempt (the
        entry just promoted)."""
        budget = self.policy.device_budget_bytes
        if budget is None:
            return
        limit = max(0, budget - reserved_bytes)
        if self.device_bytes <= limit:
            return
        device_keys = sorted(
            (k for k, e in self._entries.items() if e.tier == DEVICE),
            key=lambda k: self._entries[k].lru,
        )
        for k in device_keys:
            if self.device_bytes <= limit:
                break
            if k == keep:
                continue
            self._spill(k)

    def evict(self, key) -> None:
        del self._entries[key]
        self.stats.evictions += 1
        self._obs_event("evict", key)

    def clear(self) -> None:
        self.stats.evictions += len(self._entries)
        self._entries.clear()
