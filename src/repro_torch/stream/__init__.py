"""repro_torch.stream — dynamic-graph updates, incremental HyTM
recomputation, and a batched graph-query serving front end, on one device.

Layers:
  delta_csr   — versioned graph container: per-partition edge log,
                in-place device patching, merge-compaction, dirty tracking
  incremental — warm-start recomputation seeded from the vertices an
                update affects
  service     — source-lane-batched query serving with a
                (graph_version, program, source)-keyed result cache
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
from repro_torch.stream.service import GraphService, QueryResult

__all__ = [
    "OP_DELETE", "OP_INSERT", "OP_REWEIGHT",
    "DeltaCSR", "EdgeBatch", "InvalidBatchError", "UpdateReport",
    "random_batch",
    "incremental_state", "run_incremental",
    "GraphService", "QueryResult",
]
