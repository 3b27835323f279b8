"""Versioned dynamic-graph container over ``CSRGraph``/``DeviceCSR``.

Streaming workloads change the edge set in small batches; rebuilding the
CSR, the partition layout and the device buffers for each batch would cost
more than the recomputation it enables.  ``DeltaCSR`` instead keeps the
partition edge-block layout (core/partition.py) fixed between merges and
treats each partition's edge range as a log-structured segment:

* every partition gets ``slack`` spare lanes at build time: its live
  edges fill a dense prefix of a fixed-capacity block;
* **insert** appends into the partition of the edge's source vertex
  (partition bounds are vertex-aligned, so that is the only legal home);
* **delete** swap-removes inside the block (the combiners commute, so
  edge order inside a partition is free): the live prefix stays dense, so
  the sweep relaxes a block's first ``part_edges[p]`` lanes and needs no
  tombstones;
* **reweight** patches the weight lane in place.

Device buffers are patched in place (one indexed copy per edge column over
the touched lanes, plus the (P,) live counts and the (n,) vectors), never
rebuilt.  When a partition's block overflows, a **merge-compaction** folds
the log into a fresh CSR, re-partitions and re-uploads (``layout_version``
bumps).

Versioning: ``version`` bumps once per applied batch; a result computed at
version v is valid while the container is still at v.  ``dirty_partitions``
in each ``UpdateReport`` names the blocks a batch touched.

The host-side semantics are the reference's (``repro/stream/delta_csr.py``)
step for step, so the same batches leave the same host log and the same
device tensors.  ``apply(faults=)`` injects delivery drops
(``repro_torch.resilience``).

Sharded views: ``sharded_runtime_for(program, mesh)`` gives a rank of a
``torch.distributed`` group (``launch.mesh.GraphMesh``) a
``dist.graph_shard.ShardedRuntime`` over the blocked log.  The partition
count pads to ``P_pad = ceil(P/D)·D`` with empty partitions (capacity
start ``p·B``, no live edge), and rank ``d`` holds the lanes of its
partitions ``[d·P_local, (d+1)·P_local)`` as slices of this container's
device columns, so every in-place patch reaches the views.  Every rank
keeps the whole log on its device, as the reference keeps it on device 0.
The views are registered: each ``apply`` refreshes their live counts and
per-vertex vectors (and under the owner layout their ``HaloPlan``), and a
merge-compaction refills them from the re-blocked log.
"""

from __future__ import annotations

import dataclasses
import time
from collections import defaultdict
from dataclasses import dataclass, field

import numpy as np
import torch

from repro_torch.core.cost_model import link_constants, zc_request_counts
from repro_torch.core.hytm import HyTMConfig, Runtime
from repro_torch.core.partition import DevicePartitions, PartitionTable, partition_graph
from repro_torch.graph.algorithms import VertexProgram
from repro_torch.graph.csr import CSRGraph, DeviceCSR, csr_from_edges
from repro_torch.kernels.runtime import resolve_device

OP_INSERT, OP_DELETE, OP_REWEIGHT = 0, 1, 2


def _placed(device) -> torch.device:
    """Where a tensor on ``device`` lands (``cuda`` names the current card)."""
    return torch.empty(0, device=device).device


class InvalidBatchError(ValueError):
    """An ``EdgeBatch`` failed validation; the whole batch was rejected
    atomically: no host-log or device-buffer change happened and
    ``version`` did not move.  ``index`` is the offending entry."""

    def __init__(self, msg: str, index: int | None = None):
        super().__init__(msg if index is None
                         else f"batch entry {index}: {msg}")
        self.index = index


@dataclass
class EdgeBatch:
    """One update batch: parallel arrays of (op, src, dst, weight).

    ``weight`` is the new weight for INSERT/REWEIGHT and ignored for
    DELETE.  Ops apply in order (multigraph semantics: INSERT always adds
    a parallel edge; DELETE/REWEIGHT match the first live (src, dst))."""

    op: np.ndarray
    src: np.ndarray
    dst: np.ndarray
    weight: np.ndarray

    def __post_init__(self):
        self.op = np.asarray(self.op, dtype=np.int32)
        self.src = np.asarray(self.src, dtype=np.int64)
        self.dst = np.asarray(self.dst, dtype=np.int64)
        self.weight = np.asarray(self.weight, dtype=np.float32)
        if not (self.op.shape == self.src.shape == self.dst.shape
                == self.weight.shape):
            raise ValueError(
                "EdgeBatch fields must be parallel arrays; got shapes "
                f"op={self.op.shape} src={self.src.shape} "
                f"dst={self.dst.shape} weight={self.weight.shape}")

    def __len__(self) -> int:
        return len(self.op)

    @classmethod
    def inserts(cls, src, dst, weight) -> "EdgeBatch":
        src = np.asarray(src)
        return cls(np.full(len(src), OP_INSERT), src, dst, weight)

    @classmethod
    def deletes(cls, src, dst) -> "EdgeBatch":
        src = np.asarray(src)
        return cls(
            np.full(len(src), OP_DELETE), src, dst, np.zeros(len(src), np.float32)
        )


@dataclass
class UpdateReport:
    """What one ``apply`` did: everything the incremental layer needs.

    REWEIGHT is reported as delete(old weight) + insert(new weight), so the
    seeding rules (``stream.incremental``) see one op algebra.
    ``pre_adj``/``post_adj`` hold the out-adjacency (dsts, weights) of every
    affected source before and after the batch; the SUM programs'
    correction deltas are computed from exactly these."""

    version: int
    dirty_partitions: np.ndarray
    merged: bool
    ins_src: np.ndarray
    ins_dst: np.ndarray
    ins_w: np.ndarray
    del_src: np.ndarray
    del_dst: np.ndarray
    del_w: np.ndarray
    pre_adj: dict[int, tuple[np.ndarray, np.ndarray]] = field(default_factory=dict)
    post_adj: dict[int, tuple[np.ndarray, np.ndarray]] = field(default_factory=dict)

    @property
    def affected_vertices(self) -> np.ndarray:
        """Sources and destinations of changed edges."""
        return np.unique(
            np.concatenate([self.ins_src, self.ins_dst, self.del_src, self.del_dst])
        )


class DeltaCSR:
    """Mutable, versioned graph with a ``run_hytm``-ready runtime, on
    ``cuda`` unless ``device`` says otherwise (with no card that raises).

    The vertex set is fixed at construction (updates are edge-only).
    Invariants between merge-compactions:

      * partition p's live edges are ``_src/_dst/_w[p*B : p*B + counts[p]]``
        (B = ``block_size``, one capacity for every block); the tail lanes
        are self-loops on vertex 0 with weight +inf and ``edge_valid``
        False;
      * the device tensors mirror the host log exactly (patched per batch);
      * ``seg_start`` (per-vertex segment starts, the zero-copy alignment
        term of Eq. 3): with ``refresh_seg_start=True`` the dirty
        partitions re-derive it on every patch from the live-degree prefix
        sum, the layout the next merge will realize; ``False`` keeps it
        frozen at the last merge, so its alignment term drifts as deletes
        accumulate (the request-count base uses the live out-degrees
        either way).
    """

    def __init__(self, g: CSRGraph, config: HyTMConfig | None = None,
                 slack: float = 0.5, min_slack: int = 128,
                 refresh_seg_start: bool = True,
                 device: str | torch.device | None = None):
        self.device = resolve_device(device)
        self.config = config if config is not None else HyTMConfig()
        self.n_nodes = g.n_nodes
        self.slack = slack
        self.min_slack = min_slack
        self.refresh_seg_start = refresh_seg_start
        self.version = 0
        self.layout_version = 0
        self.dirty: set[int] = set()  # dirty partitions since the last merge
        # bounded batch_id -> UpdateReport memory: a redelivered batch is
        # not applied twice
        self._applied: dict = {}
        self.dedup_window = 64
        self._inv_deg_cache: dict[bool, torch.Tensor] = {}
        # registered sharded views: (axis, group ranks, weighted,
        # vertex_sharding) -> ShardedRuntime
        self._sharded_views: dict = {}
        # seconds the last in-place patch spent refreshing the views (the
        # owner layout's halo plans apart); 0 after a merge-compaction
        self.view_seconds = {"patch": 0.0, "halo": 0.0}
        self._build_layout(g)

    # ------------------------------------------------------------ construction
    @classmethod
    def from_graph(cls, g: CSRGraph, config: HyTMConfig | None = None,
                   **kw) -> "DeltaCSR":
        return cls(g, config, **kw)

    def _up(self, a: np.ndarray, dtype: np.dtype) -> torch.Tensor:
        # a copy on the CPU too: the device tensors never alias the host log
        return torch.from_numpy(np.ascontiguousarray(a, dtype=dtype)).to(self.device, copy=True)

    def _build_layout(self, g: CSRGraph) -> None:
        cfg = self.config
        table: PartitionTable = partition_graph(
            g, n_partitions=cfg.n_partitions,
            partition_bytes=cfg.partition_bytes, d1=cfg.link.d1,
        )
        P = table.n_partitions
        epp = table.edges_per_partition
        max_epp = int(epp.max(initial=1))
        B = max_epp + max(self.min_slack, int(np.ceil(max_epp * self.slack)))
        B = max(128, -(-B // 128) * 128)
        cap = P * B

        src = np.zeros(cap, np.int32)
        dst = np.zeros(cap, np.int32)
        w = np.full(cap, np.float32(np.inf), np.float32)
        valid = np.zeros(cap, bool)
        src_all = g.edge_sources()
        dst_all = g.indices
        w_all = g.weights if g.weights is not None else np.ones(g.n_edges, np.float32)
        counts = epp.astype(np.int64)
        for p in range(P):
            e0, e1 = int(table.edge_start[p]), int(table.edge_start[p + 1])
            k = e1 - e0
            src[p * B:p * B + k] = src_all[e0:e1]
            dst[p * B:p * B + k] = dst_all[e0:e1]
            w[p * B:p * B + k] = w_all[e0:e1]
            valid[p * B:p * B + k] = True

        part_id = np.repeat(
            np.arange(P, dtype=np.int32), table.vertices_per_partition
        )
        # per-vertex segment start relocated into the blocked layout
        seg_start = (
            part_id.astype(np.int64) * B
            + g.indptr[:-1] - table.edge_start[part_id]
        )

        self._src, self._dst, self._w, self._valid = src, dst, w, valid
        self.counts = counts
        self.block_size = B
        self.n_partitions = P
        self.vertex_start = table.vertex_start
        self.vertex_part = part_id
        self.out_deg = g.out_degrees.copy()
        self._seg_start_host = seg_start

        cap_start = np.arange(P + 1, dtype=np.int64) * B
        i32 = np.int32
        # drop the old layout's tensors (the views' slices of them too)
        # before the new ones are allocated
        self.csr = self.parts = self.zc_req = None
        self._inv_deg_cache.clear()
        for rt in self._sharded_views.values():
            rt.edge_src = rt.edge_dst = rt.edge_weight = None
        self.parts = DevicePartitions(
            vertex_start=self._up(table.vertex_start, i32),
            edge_start=self._up(cap_start, i32),
            part_edges=self._up(counts, i32),
            vertex_part_id=self._up(part_id, i32),
            n_partitions=P,
            block_size=B,
        )
        self.csr = DeviceCSR(
            edge_src=self._up(src, i32),
            edge_dst=self._up(dst, i32),
            edge_weight=self._up(w, np.float32),
            edge_valid=self._up(valid, bool),
            out_degree=self._up(self.out_deg, i32),
            seg_start=self._up(seg_start, i32),
            n_nodes=self.n_nodes,
            n_edges=int(counts.sum()),  # live count at the last merge
        )
        self.zc_req = zc_request_counts(
            self.csr.out_degree, self.csr.seg_start, self.config.link
        )
        # a merge-compaction re-blocks the log: every view is refilled
        self.view_seconds = {"patch": 0.0, "halo": 0.0}
        for key, rt in self._sharded_views.items():
            self._refill_sharded_view(rt, key[2])

    # ------------------------------------------------------------- inspection
    @property
    def n_edges(self) -> int:
        return int(self.counts.sum())

    def live_edges(self) -> tuple[np.ndarray, np.ndarray, np.ndarray]:
        """(src, dst, weight) of the current edge multiset (host copies)."""
        mask = self._valid
        return self._src[mask], self._dst[mask], self._w[mask]

    def to_host_graph(self) -> CSRGraph:
        """The current edge set as a fresh ``CSRGraph`` (what a run from
        scratch would be given)."""
        s, d, w = self.live_edges()
        return csr_from_edges(self.n_nodes, s.astype(np.int64),
                              d.astype(np.int64), w)

    def _out_edges(self, u: int, extra=None) -> tuple[np.ndarray, np.ndarray]:
        p = int(self.vertex_part[u])
        lo = p * self.block_size
        hi = lo + int(self.counts[p])
        m = self._src[lo:hi] == u
        dsts, ws = self._dst[lo:hi][m].copy(), self._w[lo:hi][m].copy()
        if extra and extra.get(p):
            ex = [(v, ew) for (eu, v, ew) in extra[p] if eu == u]
            if ex:
                dsts = np.concatenate([dsts, np.array([v for v, _ in ex], dsts.dtype)])
                ws = np.concatenate([ws, np.array([ew for _, ew in ex], np.float32)])
        return dsts, ws

    # ---------------------------------------------------------------- updates
    def validate_batch(self, batch: EdgeBatch) -> None:
        """Reject a malformed batch before any change: unknown ops,
        negative or out-of-range endpoints, non-finite weights on
        INSERT/REWEIGHT, and the delete of an absent edge (checked against
        the live multiset with the batch's own earlier entries applied, so
        insert-then-delete inside one batch is legal).  Raises
        :class:`InvalidBatchError`; on return ``apply`` succeeds."""
        n = self.n_nodes
        if len(batch) == 0:
            return
        bad = np.nonzero(~np.isin(batch.op, (OP_INSERT, OP_DELETE,
                                             OP_REWEIGHT)))[0]
        if bad.size:
            i = int(bad[0])
            raise InvalidBatchError(f"unknown op {int(batch.op[i])}", i)
        bad = np.nonzero((batch.src < 0) | (batch.src >= n)
                         | (batch.dst < 0) | (batch.dst >= n))[0]
        if bad.size:
            i = int(bad[0])
            raise InvalidBatchError(
                f"edge endpoint out of range: ({int(batch.src[i])}, "
                f"{int(batch.dst[i])}) with n_nodes={n} (vertex set is "
                "fixed)", i)
        writes = (batch.op == OP_INSERT) | (batch.op == OP_REWEIGHT)
        bad = np.nonzero(writes & ~np.isfinite(batch.weight))[0]
        if bad.size:
            i = int(bad[0])
            raise InvalidBatchError(
                f"non-finite weight {float(batch.weight[i])}", i)
        # delete-of-absent: walk the batch against lazily seeded live (u, v)
        # multiset counts, apply's multigraph semantics (DELETE matches one
        # live parallel copy; REWEIGHT of an absent edge inserts)
        counts: dict[tuple[int, int], int] = {}
        seeded: set[int] = set()
        for i in range(len(batch)):
            u, v = int(batch.src[i]), int(batch.dst[i])
            if u not in seeded:
                seeded.add(u)
                dsts, _ = self._out_edges(u)
                for d, c in zip(*np.unique(dsts, return_counts=True)):
                    counts[(u, int(d))] = int(c)
            o = int(batch.op[i])
            if o == OP_INSERT:
                counts[(u, v)] = counts.get((u, v), 0) + 1
            elif o == OP_DELETE:
                c = counts.get((u, v), 0)
                if c <= 0:
                    raise InvalidBatchError(
                        f"delete of absent edge ({u}, {v})", i)
                counts[(u, v)] = c - 1
            elif counts.get((u, v), 0) == 0:
                counts[(u, v)] = 1  # reweight-of-absent inserts

    def apply(self, batch: EdgeBatch, batch_id=None, faults=None) -> UpdateReport:
        """Apply one batch; patch the device tensors (or merge-compact on
        overflow); bump ``version``; return the report.

        :meth:`validate_batch` runs first, so a batch that would fail
        raises :class:`InvalidBatchError` with no side effect.  A
        ``batch_id`` seen within the last ``dedup_window`` batches returns
        the original report without applying again.  ``faults`` (a
        ``repro_torch.resilience.FaultPlan``) injects delivery drops at site
        ``update_delivery``: after the dedup lookup and before validation or
        any mutation, a dropped batch raises ``UpdateLost``, as if it never
        arrived."""
        if batch_id is not None and batch_id in self._applied:
            return self._applied[batch_id]
        if faults is not None and faults.fire("update_delivery") == "drop":
            from repro_torch.resilience.faults import UpdateLost

            raise UpdateLost("update_delivery", 0,
                             f"injected drop of batch {batch_id!r}")
        self.validate_batch(batch)

        affected = np.unique(batch.src)
        pre_adj = {int(u): self._out_edges(int(u)) for u in affected}

        touched: set[int] = set()
        dirty: set[int] = set()
        extra: dict[int, list] = defaultdict(list)
        ins_rec: list[tuple] = []
        del_rec: list[tuple] = []

        for i in range(len(batch)):
            o = int(batch.op[i])
            u, v = int(batch.src[i]), int(batch.dst[i])
            wt = float(batch.weight[i])
            p = int(self.vertex_part[u])
            dirty.add(p)
            if o == OP_INSERT:
                self._insert(u, v, wt, p, touched, extra)
                ins_rec.append((u, v, wt))
            elif o == OP_DELETE:
                old = self._delete(u, v, p, touched, extra)
                if old is not None:
                    del_rec.append((u, v, old))
            else:  # OP_REWEIGHT (validate_batch rejected every other op)
                old = self._reweight(u, v, wt, p, touched, extra)
                if old is None:  # absent edge: reweight degenerates to insert
                    self._insert(u, v, wt, p, touched, extra)
                else:
                    del_rec.append((u, v, old))
                ins_rec.append((u, v, wt))

        post_adj = {int(u): self._out_edges(int(u), extra) for u in affected}

        merged = any(extra.values())
        if merged:
            s, d, w = self.live_edges()
            for p, lst in extra.items():
                if not lst:
                    continue
                es = np.array([e[0] for e in lst], np.int64)
                ed = np.array([e[1] for e in lst], np.int64)
                ew = np.array([e[2] for e in lst], np.float32)
                s = np.concatenate([s.astype(np.int64), es])
                d = np.concatenate([d.astype(np.int64), ed])
                w = np.concatenate([w, ew])
            self._build_layout(csr_from_edges(self.n_nodes, s, d, w))
            self.layout_version += 1
            self.dirty = set()
            dirty = set(range(self.n_partitions))
        else:
            self._patch_device(touched, dirty)
            self.dirty |= dirty

        self.version += 1

        def _cols(rec, j, dt):
            return np.array([r[j] for r in rec], dtype=dt)

        report = UpdateReport(
            version=self.version,
            dirty_partitions=np.array(sorted(dirty), np.int64),
            merged=merged,
            ins_src=_cols(ins_rec, 0, np.int64),
            ins_dst=_cols(ins_rec, 1, np.int64),
            ins_w=_cols(ins_rec, 2, np.float32),
            del_src=_cols(del_rec, 0, np.int64),
            del_dst=_cols(del_rec, 1, np.int64),
            del_w=_cols(del_rec, 2, np.float32),
            pre_adj=pre_adj,
            post_adj=post_adj,
        )
        if batch_id is not None:
            self._applied[batch_id] = report
            while len(self._applied) > self.dedup_window:
                self._applied.pop(next(iter(self._applied)))
        return report

    def _insert(self, u, v, wt, p, touched, extra):
        B = self.block_size
        if int(self.counts[p]) < B and not extra.get(p):
            slot = p * B + int(self.counts[p])
            self._src[slot], self._dst[slot] = u, v
            self._w[slot], self._valid[slot] = wt, True
            self.counts[p] += 1
            touched.add(slot)
        else:
            # block full (or already spilling): spill to the merge log
            extra[p].append((u, v, wt))
        self.out_deg[u] += 1

    def _find_slot(self, u, v, p) -> int | None:
        lo = p * self.block_size
        hi = lo + int(self.counts[p])
        hits = np.nonzero((self._src[lo:hi] == u) & (self._dst[lo:hi] == v))[0]
        return int(lo + hits[0]) if len(hits) else None

    def _delete(self, u, v, p, touched, extra) -> float | None:
        slot = self._find_slot(u, v, p)
        if slot is None:
            for j, (eu, ev, ew) in enumerate(extra.get(p, ())):
                if eu == u and ev == v:
                    extra[p].pop(j)
                    self.out_deg[u] -= 1
                    return float(ew)
            return None  # unreachable after validate_batch
        old = float(self._w[slot])
        last = p * self.block_size + int(self.counts[p]) - 1
        # swap-remove keeps the live prefix dense (edge order is free)
        self._src[slot], self._dst[slot] = self._src[last], self._dst[last]
        self._w[slot] = self._w[last]
        self._src[last], self._dst[last] = 0, 0
        self._w[last], self._valid[last] = np.float32(np.inf), False
        self.counts[p] -= 1
        touched.add(slot)
        touched.add(last)
        self.out_deg[u] -= 1
        return old

    def _reweight(self, u, v, wt, p, touched, extra) -> float | None:
        slot = self._find_slot(u, v, p)
        if slot is None:
            for j, (eu, ev, ew) in enumerate(extra.get(p, ())):
                if eu == u and ev == v:
                    extra[p][j] = (u, v, wt)
                    return float(ew)
            return None
        old = float(self._w[slot])
        self._w[slot] = wt
        touched.add(slot)
        return old

    def _patch_device(self, touched: set[int], dirty: set[int] = frozenset()) -> None:
        """Copy the touched lanes into the device edge columns in place and
        refresh the (P,) and (n,) vectors; shapes never change here.  The
        partitions are rebuilt (not mutated) so that their host copy of
        ``part_edges``, which the sweep's per-partition dispatch reads,
        follows the live counts."""
        if touched:
            idx = np.fromiter(sorted(touched), np.int64, len(touched))
            lanes = torch.from_numpy(idx).to(self.device)
            for col, host in ((self.csr.edge_src, self._src),
                              (self.csr.edge_dst, self._dst),
                              (self.csr.edge_weight, self._w),
                              (self.csr.edge_valid, self._valid)):
                col.index_copy_(0, lanes, torch.from_numpy(host[idx]).to(self.device))
        self.csr = dataclasses.replace(
            self.csr, out_degree=self._up(self.out_deg, np.int32))
        self.parts = dataclasses.replace(
            self.parts, part_edges=self._up(self.counts, np.int32))
        if self.refresh_seg_start:
            self._refresh_seg_start(dirty)
        # the request-count base follows the live degrees; the alignment
        # term the refreshed (or, without refresh, last-merge) seg_start
        self.zc_req = zc_request_counts(
            self.csr.out_degree, self.csr.seg_start, self.config.link
        )
        self._inv_deg_cache.clear()
        self.view_seconds = {"patch": 0.0, "halo": 0.0}
        for key, rt in self._sharded_views.items():
            self._patch_sharded_view(rt, key[2], bool(touched))

    def _refresh_seg_start(self, dirty) -> None:
        """Recompute ``seg_start`` for the ``dirty`` partitions: vertex v's
        segment starts at the partition base plus the live degrees of the
        vertices before it, the dense layout the next merge realizes.
        O(vertices of the dirty partitions) on the host; uploaded as one
        (n,) vector when it changed."""
        changed = False
        B = self.block_size
        for p in sorted(dirty):
            v0, v1 = int(self.vertex_start[p]), int(self.vertex_start[p + 1])
            if v1 <= v0:
                continue
            deg = self.out_deg[v0:v1].astype(np.int64)
            seg = p * B + np.concatenate(([0], np.cumsum(deg[:-1])))
            if not np.array_equal(seg, self._seg_start_host[v0:v1]):
                self._seg_start_host[v0:v1] = seg
                changed = True
        if changed:
            self.csr = dataclasses.replace(
                self.csr, seg_start=self._up(self._seg_start_host, np.int32))

    # ---------------------------------------------------------------- runtime
    def _inv_deg(self, weighted: bool) -> torch.Tensor:
        inv = self._inv_deg_cache.get(weighted)
        if inv is None:
            if weighted:
                # the live weights summed on the host in float64, divided
                # in float64, rounded once to float32 (the reference's
                # formula, not build_runtime's float32 device sum);
                # bincount adds in index order, as np.add.at does
                s, _, w = self.live_edges()
                wsum = np.bincount(s, weights=w.astype(np.float64),
                                   minlength=self.n_nodes)
                inv = self._up(1.0 / np.maximum(wsum, 1e-30), np.float32)
            else:
                one = link_constants(self.config.link, self.device)["one"]
                inv = one / torch.maximum(self.csr.out_degree.to(torch.float32), one)
            self._inv_deg_cache[weighted] = inv
        return inv

    def runtime_for(self, program: VertexProgram) -> Runtime:
        """A ``core.hytm.Runtime`` view of the current version.  It shares
        the device tensors, which the next ``apply`` patches in place."""
        weighted = bool(program.use_delta and program.weighted)
        return Runtime(
            csr=self.csr, parts=self.parts, zc_req=self.zc_req,
            inv_deg=self._inv_deg(weighted), n_hub_partitions=0,
        )

    # --------------------------------------------------------- sharded runtime
    def sharded_runtime_for(self, program: VertexProgram, mesh=None,
                            axis: str | None = None, vertex_sharding: str | None = None):
        """This rank's ``dist.graph_shard.ShardedRuntime`` view of the
        current version, on ``mesh`` (a ``launch.mesh.GraphMesh``, by
        default ``make_graph_mesh`` over the default group on this
        container's device) under ``vertex_sharding`` (by default
        ``config.vertex_sharding``; ``run_incremental`` passes its run's).

        The view is registered under (axis, the group's ranks, weighted,
        vertex_sharding) and returned again on the next call: each
        ``apply`` refreshes it, so a sharded run over it plans the same
        engines and charges the same bytes as a run over
        :meth:`runtime_for` at every version.  ``axis`` defaults to
        ``config.mesh_axis``; with neither, or an axis the mesh does not
        have, this raises ``ValueError``."""
        from repro_torch.dist.graph_shard import ShardedRuntime, _check_vertex_sharding
        from repro_torch.launch.mesh import group_ranks, make_graph_mesh

        axis = axis if axis is not None else self.config.mesh_axis
        if axis is None:
            raise ValueError(
                "no mesh axis: set config.mesh_axis or pass axis= (runtime_for() is the "
                "single-device view)")
        if mesh is None:
            mesh = make_graph_mesh(axis=axis, device=self.device)
        if axis != mesh.axis:
            raise ValueError(
                f"config.mesh_axis={axis!r} is not the mesh's axis {mesh.axis!r}")
        if _placed(mesh.device) != _placed(self.device):
            raise ValueError(
                f"the mesh's device {mesh.device} is not the DeltaCSR's {self.device}: "
                "the view slices the container's device columns")
        weighted = bool(program.use_delta and program.weighted)
        sharding = _check_vertex_sharding(vertex_sharding if vertex_sharding is not None
                                          else self.config.vertex_sharding)
        key = (axis, group_ranks(mesh), weighted, sharding)
        rt = self._sharded_views.get(key)
        if rt is None:
            rt = ShardedRuntime(
                mesh=mesh, parts=None, edge_src=None, edge_dst=None, edge_weight=None,
                edge_base=0, out_degree=None, zc_req=None, inv_deg=None,
                n_nodes=self.n_nodes, n_partitions=0, n_hub_partitions=0,
                vertex_sharding=sharding)
            self._refill_sharded_view(rt, weighted)
            self._sharded_views[key] = rt
        return rt

    def _halo_plan(self, rt):
        from repro_torch.dist.graph_shard import blocked_halo_plan

        return blocked_halo_plan(self._src, self._dst, self.counts, self.block_size,
                                 self.n_nodes, rt.mesh.size)

    def _refill_sharded_view(self, rt, weighted: bool) -> None:
        """(Re)build a view from the current layout: the build path and the
        merge-compaction path."""
        from repro_torch.dist.graph_shard import blocked_ranges, shard_edge_range

        D, P, B = rt.mesh.size, self.n_partitions, self.block_size
        P_pad = -(-P // D) * D
        e0, e1 = blocked_ranges(P, B, D)[rt.mesh.rank]
        rt.edge_src, rt.edge_dst, rt.edge_weight = shard_edge_range(
            (self.csr.edge_src, self.csr.edge_dst, self.csr.edge_weight), e0, e1, self.device)
        rt.edge_base = e0
        rt.n_partitions = P_pad
        rt.halo = self._halo_plan(rt) if rt.vertex_sharding == "owner" else None
        pad = P_pad - P
        vstart = np.concatenate([self.vertex_start, np.full(pad, self.vertex_start[-1])])
        i32 = np.int32
        rt.parts = DevicePartitions(
            vertex_start=self._up(vstart, i32),
            edge_start=self._up(np.arange(P_pad + 1, dtype=np.int64) * B, i32),
            part_edges=self._view_counts(rt),
            vertex_part_id=self.parts.vertex_part_id,
            n_partitions=P_pad,
            block_size=B,
        )
        self._place_view_vectors(rt, weighted)

    def _view_counts(self, rt) -> torch.Tensor:
        """The live counts padded to the view's ``P_pad`` with zeros."""
        pad = rt.n_partitions - self.n_partitions
        return self._up(np.concatenate([self.counts, np.zeros(pad, np.int64)]), np.int32)

    def _place_view_vectors(self, rt, weighted: bool) -> None:
        """A view's per-vertex vectors, the container's (padded under the
        owner layout)."""
        from repro_torch.dist.graph_shard import place_vertex_vectors

        place_vertex_vectors(rt, self.csr.out_degree, self.zc_req, self._inv_deg(weighted),
                             rt.parts.vertex_part_id)

    def _patch_sharded_view(self, rt, weighted: bool, moved: bool) -> None:
        """Refresh a view between merges.  Its edge columns are slices of the
        device columns ``_patch_device`` just patched in place; its live
        counts and per-vertex vectors follow the container's, and under the
        owner layout, when lanes ``moved``, its halo plan is rebuilt from
        the host log (the plan steers only the ICI charge, which must see
        the live boundary)."""
        t = time.monotonic()
        if rt.vertex_sharding == "owner" and moved:
            rt.halo = self._halo_plan(rt)
        t_halo = time.monotonic()
        rt.parts = dataclasses.replace(rt.parts, part_edges=self._view_counts(rt))
        self._place_view_vectors(rt, weighted)
        self.view_seconds["halo"] += t_halo - t
        self.view_seconds["patch"] += time.monotonic() - t_halo


def random_batch(
    dcsr: DeltaCSR,
    rng: np.random.Generator,
    n_insert: int = 0,
    n_delete: int = 0,
    n_reweight: int = 0,
    max_weight: float = 64.0,
) -> EdgeBatch:
    """Sample a plausible batch against the current edge set: deletions and
    reweights pick live edges, insertions pick uniform endpoints."""
    ls, ld, _ = dcsr.live_edges()
    ops, src, dst, w = [], [], [], []
    if n_delete or n_reweight:
        k = min(n_delete + n_reweight, len(ls))
        pick = rng.choice(len(ls), size=k, replace=False) if k else []
        for j, e in enumerate(pick):
            is_del = j < min(n_delete, k)
            ops.append(OP_DELETE if is_del else OP_REWEIGHT)
            src.append(int(ls[e]))
            dst.append(int(ld[e]))
            w.append(float(rng.integers(1, max_weight)))
    for _ in range(n_insert):
        ops.append(OP_INSERT)
        src.append(int(rng.integers(0, dcsr.n_nodes)))
        dst.append(int(rng.integers(0, dcsr.n_nodes)))
        w.append(float(rng.integers(1, max_weight)))
    return EdgeBatch(np.array(ops), np.array(src), np.array(dst),
                     np.array(w, np.float32))
