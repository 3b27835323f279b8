"""repro_torch.serve — continuous multi-tenant serving on top of
``GraphService``, on one device or a mesh.

Three pieces (one file each), as in the reference ``repro.serve``:

* :mod:`repro_torch.serve.queue` — request queue with per-tenant quotas,
  deadline-aware ordering, and admission control against the
  device-resident state budget;
* :mod:`repro_torch.serve.scheduler` — continuous lane batching over
  static bucket sizes, freeing converged lanes at chunk boundaries and
  backfilling them mid-flight;
* :mod:`repro_torch.serve.warm_cache` — two-tier (device LRU → host RAM)
  warm-state cache with promote-and-replay, owner-sharded on a mesh
  (:class:`OwnerPlacement`).

``GraphService`` owns one :class:`LaneScheduler` and one
:class:`WarmCache`; multi-tenant serving drives the scheduler's ``pump``.
"""

from repro_torch.serve.queue import QueueStats, Request, RequestQueue
from repro_torch.serve.scheduler import (
    LaneScheduler,
    SchedulerStats,
    ServedResult,
    default_buckets,
)
from repro_torch.serve.warm_cache import (
    CacheStats,
    OwnerPlacement,
    TierPolicy,
    WarmCache,
    WarmEntry,
)

__all__ = [
    "QueueStats",
    "Request",
    "RequestQueue",
    "LaneScheduler",
    "SchedulerStats",
    "ServedResult",
    "default_buckets",
    "CacheStats",
    "OwnerPlacement",
    "TierPolicy",
    "WarmCache",
    "WarmEntry",
]
