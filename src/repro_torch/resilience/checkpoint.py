"""Versioned checkpoint/restore for chunked HyTM runs.

The reference's ``repro/resilience/checkpoint.py``, on one device and on a
mesh (``launch.mesh.GraphMesh``: every rank runs the same chunks, rank 0
alone writes, and every rank passes a barrier after the write, so all of
them resume from the same file).  The
file format is the reference's (schema v2; v1 still reads), so a
checkpoint or report log written by either package restores in the other.

A checkpoint captures everything a killed run needs to resume from its
last chunk boundary **bit-identically** for MIN programs: the
``HyTMState`` arrays, the drained history rows up to that boundary, the
iteration cursor, the
:class:`~repro_torch.autotune.feedback.OnlineCalibrator` normal
equations, and the graph anchor ``(graph_version, layout_version)`` the
state was computed against.  A second codec
(:func:`save_reports`/:func:`load_reports`) persists the DeltaCSR
version/report log so a restarted serving process can resume
incremental replay from the same anchor.

Format: a single ``.npz`` written atomically (tmp + ``os.replace``).
Metadata travels as a JSON blob embedded as a ``uint8`` array under
``__meta__`` and carries a per-array ``crc32`` table; :func:`restore`
re-verifies every checksum (and ``zipfile`` independently verifies
entry CRCs on read), so any byte flip surfaces as a typed
:class:`CheckpointError` rather than silently corrupt state.

Resume contract (what "bit-identical" requires):

* the kill happens at a chunk boundary strictly before convergence —
  :class:`CheckpointHook` only ever writes at boundaries, so this holds
  by construction when the dispatch itself failed;
* MIN combine (values are a fixpoint of improvements; SUM resumes are
  tolerance-bounded because delta draining is order-sensitive);
* autotune off, or the calibrator restored via the checkpoint — the
  resumed process pays first-dispatch costs again, so the warm-signature
  skip schedule matches only when the calibrator state travels too.
"""

from __future__ import annotations

import dataclasses
import json
import os
import struct
import zipfile
import zlib
from dataclasses import dataclass, field
from pathlib import Path

import numpy as np
import torch

from repro_torch.dist.graph_shard import all_gather_owned, owner_state_pad_values
from repro_torch.kernels.runtime import resolve_device
from repro_torch.launch.mesh import mesh_barrier

# v2 adds the vertex-state layout fields (state_layout, n_nodes) for
# owner-sharded runs; v1 checkpoints still load (implicitly replicated)
SCHEMA_VERSION = 2
_SUPPORTED_SCHEMAS = (1, 2)
_META_KEY = "__meta__"
# what np.load raises on a missing, truncated or bit-flipped .npz
_UNREADABLE = (zipfile.BadZipFile, zlib.error, struct.error, ValueError,
               OSError, EOFError, KeyError, NotImplementedError)


class CheckpointError(RuntimeError):
    """Raised when a checkpoint is missing, corrupt, or mismatched."""


def _crc(arr: np.ndarray) -> int:
    return zlib.crc32(np.ascontiguousarray(arr).tobytes())


def _to_host(*tensors: torch.Tensor) -> list[np.ndarray]:
    """Host copies of ``tensors`` in ONE device-to-host transfer (one sync
    on a card): their bytes concatenated on the device, split on the host."""
    flat = [t.detach().contiguous().view(-1).view(torch.uint8) for t in tensors]
    host = torch.cat(flat).cpu().numpy()
    out, pos = [], 0
    for t, f in zip(tensors, flat):
        dtype = torch.empty(0, dtype=t.dtype).numpy().dtype
        out.append(host[pos:pos + f.numel()].view(dtype).reshape(t.shape))
        pos += f.numel()
    return out


def calibrator_state(calib) -> dict | None:
    """Serialize an ``OnlineCalibrator`` (or ``None``) to plain JSON."""
    if calib is None:
        return None
    return {
        "decay": float(calib.decay),
        "ridge": float(calib.ridge),
        "clip": [float(c) for c in calib.clip],
        "n_updates": int(calib.n_updates),
        "A": np.asarray(calib._A, dtype=float).tolist(),
        "b": np.asarray(calib._b, dtype=float).tolist(),
    }


def restore_calibrator(state: dict | None):
    """Rebuild an ``OnlineCalibrator`` from :func:`calibrator_state`."""
    if state is None:
        return None
    from repro_torch.autotune.feedback import OnlineCalibrator

    calib = OnlineCalibrator(decay=state["decay"], ridge=state["ridge"],
                             clip=tuple(state["clip"]))
    calib._A = np.asarray(state["A"], dtype=float)
    calib._b = np.asarray(state["b"], dtype=float)
    calib.n_updates = int(state["n_updates"])
    return calib


@dataclass
class RunCheckpoint:
    """One resumable chunk-boundary snapshot of a ``run_hytm`` call."""

    program: str
    iterations: int
    graph_version: int = 0
    layout_version: int = 0
    values: np.ndarray | None = None
    delta: np.ndarray | None = None
    frontier: np.ndarray | None = None
    history: dict[str, np.ndarray] = field(default_factory=dict)
    calibrator: dict | None = None
    # vertex-state layout the snapshot was taken under ("replicated" |
    # "owner").  Owner snapshots hold the gathered (n_pad,) arrays;
    # n_nodes records the real vertex count so resume/migration can
    # slice the ghost pads off.  v1 checkpoints restore as
    # ("replicated", 0).
    state_layout: str = "replicated"
    n_nodes: int = 0

    @property
    def anchor(self) -> tuple[int, int]:
        return (self.graph_version, self.layout_version)


def save(ckpt: RunCheckpoint, path: str | os.PathLike) -> Path:
    """Atomically write ``ckpt`` to ``path`` (single ``.npz``).

    The write goes to a sibling tmp file first and is published with
    ``os.replace``, so a crash mid-save leaves the previous checkpoint
    intact — the invariant recovery depends on."""
    path = Path(path)
    arrays: dict[str, np.ndarray] = {}
    for name in ("values", "delta", "frontier"):
        arr = getattr(ckpt, name)
        if arr is not None:
            arrays[name] = np.asarray(arr)
    for key, arr in ckpt.history.items():
        arrays[f"hist::{key}"] = np.asarray(arr)
    meta = {
        "schema": SCHEMA_VERSION,
        "program": ckpt.program,
        "iterations": int(ckpt.iterations),
        "graph_version": int(ckpt.graph_version),
        "layout_version": int(ckpt.layout_version),
        "state_layout": ckpt.state_layout,
        "n_nodes": int(ckpt.n_nodes),
        "calibrator": ckpt.calibrator,
        "crc": {k: _crc(v) for k, v in arrays.items()},
    }
    arrays[_META_KEY] = np.frombuffer(
        json.dumps(meta).encode(), dtype=np.uint8)
    tmp = path.with_name(path.name + ".tmp")
    with open(tmp, "wb") as f:
        np.savez(f, **arrays)
    os.replace(tmp, path)
    return path


def restore(path: str | os.PathLike,
            expect_anchor: tuple[int, int] | None = None,
            program: str | None = None) -> RunCheckpoint:
    """Load and verify a checkpoint written by :func:`save`.

    Every failure mode — missing file, truncated/bit-flipped zip
    payload, schema drift, checksum mismatch, anchor or program
    mismatch — raises :class:`CheckpointError` so callers have exactly
    one thing to catch before falling back to a cold start."""
    path = Path(path)
    try:
        with np.load(path) as z:
            arrays = {k: z[k] for k in z.files}
    except FileNotFoundError as e:
        raise CheckpointError(f"checkpoint missing: {path}") from e
    except _UNREADABLE as e:
        raise CheckpointError(f"checkpoint unreadable: {path}: {e}") from e
    blob = arrays.pop(_META_KEY, None)
    if blob is None:
        raise CheckpointError(f"checkpoint has no metadata: {path}")
    try:
        meta = json.loads(bytes(blob.tobytes()).decode())
    except (ValueError, UnicodeDecodeError) as e:
        raise CheckpointError(f"checkpoint metadata corrupt: {path}") from e
    if meta.get("schema") not in _SUPPORTED_SCHEMAS:
        raise CheckpointError(
            f"checkpoint schema {meta.get('schema')!r} not in "
            f"{_SUPPORTED_SCHEMAS}")
    for k, want in meta.get("crc", {}).items():
        if k not in arrays:
            raise CheckpointError(f"checkpoint array missing: {k}")
        got = _crc(arrays[k])
        if got != want:
            raise CheckpointError(
                f"checkpoint checksum mismatch on {k}: {got} != {want}")
    if program is not None and meta["program"] != program:
        raise CheckpointError(
            f"checkpoint is for program {meta['program']!r}, not "
            f"{program!r}")
    ckpt = RunCheckpoint(
        program=meta["program"],
        iterations=int(meta["iterations"]),
        graph_version=int(meta["graph_version"]),
        layout_version=int(meta["layout_version"]),
        values=arrays.get("values"),
        delta=arrays.get("delta"),
        frontier=arrays.get("frontier"),
        history={k[len("hist::"):]: v for k, v in arrays.items()
                 if k.startswith("hist::")},
        calibrator=meta.get("calibrator"),
        state_layout=meta.get("state_layout", "replicated"),
        n_nodes=int(meta.get("n_nodes", 0)),
    )
    if expect_anchor is not None and ckpt.anchor != tuple(expect_anchor):
        raise CheckpointError(
            f"checkpoint anchored at {ckpt.anchor}, run expects "
            f"{tuple(expect_anchor)} — graph/layout changed underneath")
    return ckpt


class CheckpointHook:
    """``on_chunk`` consumer for ``run_hytm(..., on_chunk=hook)``.

    Called at every chunk boundary with the live (on-device) state; every
    ``every``-th boundary copies ``values``, ``delta`` and ``frontier`` to
    the host (the one sync it adds) and persists them via :func:`save`.

    On a mesh the sharded driver passes its ``mesh``: under the owner
    layout the hook all-gathers the ranks' slices into the ``(n_pad,)``
    arrays the reference saves (a collective: every rank reaches it at the
    same boundary), rank 0 alone writes, and every rank passes a barrier
    on the group before it goes on.  ``mesh`` given here does the same for
    a single-device replay that every rank of that mesh runs (the
    supervisor's ``mesh->single-device`` rung).  ``saved`` counts this
    process's writes, ``committed`` the checkpoints the group has
    written."""

    def __init__(self, path: str | os.PathLike, *, program: str = "",
                 anchor: tuple[int, int] = (0, 0), every: int = 1,
                 base_iterations: int = 0,
                 state_layout: str = "replicated", n_nodes: int = 0, mesh=None):
        self.path = Path(path)
        self.program = program
        self.anchor = (int(anchor[0]), int(anchor[1]))
        self.every = max(int(every), 1)
        self.base_iterations = int(base_iterations)
        # owner-sharded snapshots record their layout + the real vertex
        # count so restore can slice the pads off
        self.state_layout = state_layout
        self.n_nodes = int(n_nodes)
        self.mesh = mesh
        self.n_chunks = 0
        self.saved = 0
        self.committed = 0

    def __call__(self, *, state, iterations: int, rows: dict,
                 calibrator=None, last_active: int | None = None, mesh=None) -> None:
        self.n_chunks += 1
        if self.n_chunks % self.every:
            return
        tensors = (state.values, state.delta, state.frontier)
        if mesh is not None and self.state_layout == "owner":
            tensors = tuple(all_gather_owned(t, mesh) for t in tensors)
        group = mesh if mesh is not None else self.mesh
        if group is None or group.rank == 0:
            values, delta, frontier = _to_host(*tensors)
            ckpt = RunCheckpoint(
                program=self.program,
                iterations=self.base_iterations + int(iterations),
                graph_version=self.anchor[0],
                layout_version=self.anchor[1],
                values=values,
                delta=delta,
                frontier=frontier,
                history={k: (np.concatenate(v) if v else np.zeros((0,)))
                         for k, v in rows.items()},
                calibrator=calibrator_state(calibrator),
                state_layout=self.state_layout,
                n_nodes=self.n_nodes,
            )
            save(ckpt, self.path)
            self.saved += 1
        if group is not None:
            mesh_barrier(group)
        self.committed += 1


def migrate_state_layout(ckpt: RunCheckpoint, to_layout: str, *,
                         n_devices: int = 1,
                         program=None) -> RunCheckpoint:
    """Convert a checkpoint's vertex-state arrays between layouts.

    ``owner -> replicated`` slices the gathered ``(n_pad,)`` arrays down
    to the recorded ``n_nodes``; ``replicated -> owner`` pads them with
    the program's inert fills (:func:`owner_state_pad_values`) up to
    ``ceil(n/D)*D`` for ``n_devices``.  The real-vertex bytes are
    untouched either way, so migrate -> resume stays bit-identical to a
    same-layout resume.  ``program`` (a ``VertexProgram``) is needed for
    ``-> owner`` to pick the fills; omitted, it is looked up by the
    checkpoint's program name in
    ``repro_torch.graph.algorithms.ALGORITHMS``.
    """
    if to_layout not in ("replicated", "owner"):
        raise ValueError(f"unknown state layout {to_layout!r}")
    if ckpt.state_layout == to_layout:
        return ckpt
    if ckpt.values is None:
        raise CheckpointError("checkpoint holds no state arrays to migrate")
    if to_layout == "replicated":
        if not ckpt.n_nodes:
            raise CheckpointError(
                "owner-layout checkpoint lacks n_nodes; cannot slice pads")
        n = ckpt.n_nodes
        return dataclasses.replace(
            ckpt, values=ckpt.values[:n], delta=ckpt.delta[:n],
            frontier=ckpt.frontier[:n], state_layout="replicated",
            n_nodes=n)
    if program is None:
        from repro_torch.graph.algorithms import ALGORITHMS

        program = ALGORITHMS.get(ckpt.program)
        if program is None:
            raise CheckpointError(
                f"cannot infer pad fills for unknown program "
                f"{ckpt.program!r}; pass program= explicitly")
    n = ckpt.values.shape[0]
    n_pad = -(-n // max(int(n_devices), 1)) * max(int(n_devices), 1)
    pad_v, pad_d = owner_state_pad_values(program)

    def _pad(arr, fill):
        extra = n_pad - arr.shape[0]
        if extra <= 0:
            return arr
        return np.concatenate(
            [arr, np.full(extra, fill, dtype=arr.dtype)])

    return dataclasses.replace(
        ckpt, values=_pad(ckpt.values, pad_v),
        delta=_pad(ckpt.delta, pad_d),
        frontier=_pad(ckpt.frontier, False),
        state_layout="owner", n_nodes=n)


def stitch(ckpt: RunCheckpoint, result):
    """Compose a resumed ``HyTMResult`` with its checkpoint prefix so
    the caller sees one run: history concatenated, iteration and
    transfer totals re-summed over the combined rows."""
    from repro_torch.core.cost_model import (
        KEY_MISPREDICTIONS,
        KEY_TRANSFER_BYTES,
        KEY_TRANSFER_TIME,
    )

    history = {}
    for k, tail in result.history.items():
        head = ckpt.history.get(k)
        if head is None or head.size == 0:
            history[k] = tail
        elif tail.size == 0:
            history[k] = head
        else:
            history[k] = np.concatenate([head, tail])
    return dataclasses.replace(
        result,
        iterations=ckpt.iterations + result.iterations,
        history=history,
        modeled_seconds=float(np.sum(history[KEY_TRANSFER_TIME])),
        total_transfer_bytes=float(np.sum(history[KEY_TRANSFER_BYTES])),
        total_mispredictions=int(np.sum(history[KEY_MISPREDICTIONS])),
    )


def resume_run(path: str | os.PathLike, g, program, *, config, source=0,
               n_hubs: int = 0, runtime=None, mesh=None,
               expect_anchor: tuple[int, int] | None = None, obs=None,
               faults=None, retry=None, checkpoint=None,
               device: str | torch.device | None = None):
    """Restore the checkpoint at ``path`` and continue the run.

    Re-enters ``run_hytm`` with the restored state, the restored
    calibrator, and the *remaining* iteration budget, then stitches the
    checkpoint prefix back on — for MIN programs without autotune the
    composed result is bit-identical (values, iterations, transfer
    bytes, engine picks) to the uninterrupted run, because the engine
    choice is a pure function of the state at each chunk boundary.  The
    run takes the runtime's device, else the mesh's on a mesh, else
    ``device`` (``cuda`` unless given ``device="cpu"``).  On a mesh every
    rank calls it with the same arguments and restores the same file."""
    from repro_torch.core.hytm import HyTMState, run_hytm

    ckpt = restore(path, expect_anchor=expect_anchor, program=program.name)
    if config.sync_every < 2:
        raise ValueError("resume_run requires the chunked driver "
                         "(sync_every >= 2)")
    run_layout = getattr(config, "vertex_sharding", "replicated")
    if ckpt.state_layout != run_layout:
        raise CheckpointError(
            f"checkpoint state_layout={ckpt.state_layout!r} does not match "
            f"the run's vertex_sharding={run_layout!r}; convert it with "
            f"migrate_state_layout first")
    remaining = config.max_iters - ckpt.iterations
    if remaining <= 0:
        raise CheckpointError(
            f"checkpoint already holds {ckpt.iterations} iterations >= "
            f"max_iters={config.max_iters}")
    values, delta, frontier = ckpt.values, ckpt.delta, ckpt.frontier
    if ckpt.state_layout == "owner" and ckpt.n_nodes:
        # drop the gathered ghost pads
        values = values[:ckpt.n_nodes]
        delta = delta[:ckpt.n_nodes]
        frontier = frontier[:ckpt.n_nodes]
    if runtime is not None:
        dev = runtime.device
    elif mesh is not None and config.mesh_axis is not None:
        dev = mesh.device
    else:
        dev = resolve_device(device)
    state = HyTMState(values=torch.from_numpy(np.array(values)).to(dev),
                      delta=torch.from_numpy(np.array(delta)).to(dev),
                      frontier=torch.from_numpy(np.array(frontier)).to(dev))
    if checkpoint is not None:
        checkpoint.base_iterations = ckpt.iterations
    result = run_hytm(
        g, program, source=source,
        config=dataclasses.replace(config, max_iters=remaining),
        n_hubs=n_hubs, runtime=runtime, mesh=mesh, initial_state=state,
        calibrator=restore_calibrator(ckpt.calibrator), obs=obs,
        faults=faults, retry=retry, on_chunk=checkpoint, device=dev)
    return stitch(ckpt, result)


# --- DeltaCSR report-log persistence -----------------------------------


def _pack_adj(adj: dict) -> dict[str, np.ndarray]:
    keys = np.asarray(sorted(adj), dtype=np.int64)
    offs = np.zeros(keys.size + 1, dtype=np.int64)
    dsts, ws = [], []
    for i, u in enumerate(keys):
        d, w = adj[int(u)]
        offs[i + 1] = offs[i] + len(d)
        dsts.append(np.asarray(d, dtype=np.int64))
        ws.append(np.asarray(w, dtype=np.float32))
    cat = (lambda xs, dt: np.concatenate(xs) if xs
           else np.zeros((0,), dtype=dt))
    return {"keys": keys, "offs": offs,
            "dst": cat(dsts, np.int64), "w": cat(ws, np.float32)}


def _unpack_adj(keys, offs, dst, w) -> dict:
    return {int(u): (dst[offs[i]:offs[i + 1]].copy(),
                     w[offs[i]:offs[i + 1]].copy())
            for i, u in enumerate(keys)}


def save_reports(reports, path: str | os.PathLike,
                 graph_version: int, layout_version: int) -> Path:
    """Persist a list of ``UpdateReport`` (the DeltaCSR version/report
    log) with the same anchor + checksum discipline as :func:`save`."""
    path = Path(path)
    arrays: dict[str, np.ndarray] = {}
    meta_rows = []
    for i, r in enumerate(reports):
        p = f"r{i}::"
        arrays[p + "dirty"] = np.asarray(r.dirty_partitions, dtype=np.int64)
        for nm in ("ins_src", "ins_dst", "del_src", "del_dst"):
            arrays[p + nm] = np.asarray(getattr(r, nm), dtype=np.int64)
        for nm in ("ins_w", "del_w"):
            arrays[p + nm] = np.asarray(getattr(r, nm), dtype=np.float32)
        for side in ("pre_adj", "post_adj"):
            for nm, arr in _pack_adj(getattr(r, side)).items():
                arrays[f"{p}{side}::{nm}"] = arr
        meta_rows.append({"version": int(r.version), "merged": bool(r.merged)})
    meta = {
        "schema": SCHEMA_VERSION,
        "graph_version": int(graph_version),
        "layout_version": int(layout_version),
        "reports": meta_rows,
        "crc": {k: _crc(v) for k, v in arrays.items()},
    }
    arrays[_META_KEY] = np.frombuffer(
        json.dumps(meta).encode(), dtype=np.uint8)
    tmp = path.with_name(path.name + ".tmp")
    with open(tmp, "wb") as f:
        np.savez(f, **arrays)
    os.replace(tmp, path)
    return path


def load_reports(path: str | os.PathLike,
                 expect_anchor: tuple[int, int] | None = None):
    """Restore :func:`save_reports` output: ``(reports, anchor)``."""
    from repro_torch.stream.delta_csr import UpdateReport

    path = Path(path)
    try:
        with np.load(path) as z:
            arrays = {k: z[k] for k in z.files}
    except FileNotFoundError as e:
        raise CheckpointError(f"report log missing: {path}") from e
    except _UNREADABLE as e:
        raise CheckpointError(f"report log unreadable: {path}: {e}") from e
    blob = arrays.pop(_META_KEY, None)
    if blob is None:
        raise CheckpointError(f"report log has no metadata: {path}")
    meta = json.loads(bytes(blob.tobytes()).decode())
    if meta.get("schema") not in _SUPPORTED_SCHEMAS:
        raise CheckpointError(
            f"report log schema {meta.get('schema')!r} not in "
            f"{_SUPPORTED_SCHEMAS}")
    for k, want in meta.get("crc", {}).items():
        if k not in arrays or _crc(arrays[k]) != want:
            raise CheckpointError(f"report log checksum mismatch on {k}")
    anchor = (int(meta["graph_version"]), int(meta["layout_version"]))
    if expect_anchor is not None and anchor != tuple(expect_anchor):
        raise CheckpointError(
            f"report log anchored at {anchor}, expected "
            f"{tuple(expect_anchor)}")
    reports = []
    for i, row in enumerate(meta["reports"]):
        p = f"r{i}::"
        adj = {}
        for side in ("pre_adj", "post_adj"):
            adj[side] = _unpack_adj(
                arrays[f"{p}{side}::keys"], arrays[f"{p}{side}::offs"],
                arrays[f"{p}{side}::dst"], arrays[f"{p}{side}::w"])
        reports.append(UpdateReport(
            version=row["version"],
            dirty_partitions=arrays[p + "dirty"],
            merged=row["merged"],
            ins_src=arrays[p + "ins_src"], ins_dst=arrays[p + "ins_dst"],
            ins_w=arrays[p + "ins_w"],
            del_src=arrays[p + "del_src"], del_dst=arrays[p + "del_dst"],
            del_w=arrays[p + "del_w"],
            pre_adj=adj["pre_adj"], post_adj=adj["post_adj"],
        ))
    return reports, anchor
