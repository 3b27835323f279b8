"""Resilience plane: fault injection, checkpoint/recovery, supervision
(the reference's ``repro.resilience``, on one device and on a mesh).

Exactness-under-faults contract: under any seeded
:class:`~repro_torch.resilience.faults.FaultPlan`, every request that
completes returns answers bit-identical to the fault-free run for
MIN-combine programs (tolerance-bounded for SUM), quota and device-byte
budgets still hold, and recovery cost is bounded and observable (obs
``faults`` track + ``faults.*`` counters).  With ``faults=None`` every
hook is zero-overhead — the same launches, copies and syncs as a build
without this package.  The sharded ``chunk_dispatch`` site is guarded in
``dist.graph_shard.run_hytm_sharded``; on a mesh, in either vertex layout,
rank 0 alone writes checkpoints, every rank resumes from the same file,
and ``run_supervised`` degrades to a single-device replay on every rank.
"""

from repro_torch.resilience.checkpoint import (
    CheckpointError,
    CheckpointHook,
    RunCheckpoint,
    calibrator_state,
    load_reports,
    migrate_state_layout,
    restore,
    restore_calibrator,
    resume_run,
    save,
    save_reports,
    stitch,
)
from repro_torch.resilience.faults import (
    DeviceOOM,
    DispatchFault,
    DispatchTimeout,
    FaultError,
    FaultEvent,
    FaultPlan,
    FaultSpec,
    UpdateLost,
    plan_of,
)
from repro_torch.resilience.supervisor import (
    RetriesExhausted,
    RetryPolicy,
    Supervisor,
    deliver_update,
    guarded_dispatch,
    next_rung,
    record_fault_event,
    run_supervised,
)

__all__ = [
    "CheckpointError", "CheckpointHook", "RunCheckpoint",
    "calibrator_state", "load_reports", "migrate_state_layout",
    "restore", "restore_calibrator",
    "resume_run", "save", "save_reports", "stitch",
    "DeviceOOM", "DispatchFault", "DispatchTimeout", "FaultError",
    "FaultEvent", "FaultPlan", "FaultSpec", "UpdateLost", "plan_of",
    "RetriesExhausted", "RetryPolicy", "Supervisor", "deliver_update",
    "guarded_dispatch", "next_rung", "record_fault_event",
    "run_supervised",
]
