"""repro_torch.stream — dynamic-graph updates and incremental HyTM
recomputation, on one device.

Layers:
  delta_csr   — versioned graph container: per-partition edge log,
                in-place device patching, merge-compaction, dirty tracking
  incremental — warm-start recomputation seeded from the vertices an
                update affects

The reference's query-serving front end (``GraphService``,
``QueryResult``) is ROADMAP queue 1, item 7: Serving.
"""

from repro_torch.stream.delta_csr import (
    OP_DELETE,
    OP_INSERT,
    OP_REWEIGHT,
    DeltaCSR,
    EdgeBatch,
    InvalidBatchError,
    UpdateReport,
    random_batch,
)
from repro_torch.stream.incremental import incremental_state, run_incremental

__all__ = [
    "OP_DELETE", "OP_INSERT", "OP_REWEIGHT",
    "DeltaCSR", "EdgeBatch", "InvalidBatchError", "UpdateReport",
    "random_batch",
    "incremental_state", "run_incremental",
]

_NOT_PORTED = {"GraphService", "QueryResult"}


def __getattr__(name: str):
    if name in _NOT_PORTED:
        raise NotImplementedError(
            f"repro_torch.stream.{name} is not ported yet (ROADMAP queue 1, "
            "item 7: Serving)")
    raise AttributeError(f"module {__name__!r} has no attribute {name!r}")
