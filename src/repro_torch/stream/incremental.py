"""Warm-start incremental recomputation after edge-update batches.

Instead of re-running ``run_hytm`` from ``program.init_state`` on the
updated graph, seed the frontier from the vertices the updates affect and
let the unchanged Algorithm-1 machinery (cost model, engine selection,
priority sweep) converge the residual work.

Seeding rules by program family (the reference's,
``repro/stream/incremental.py``):

* **MIN (traversal)**: relaxation can absorb improvements but never undo
  a value, so
    - insertions (and reweights to a smaller weight) activate the edge's
      source: the new edge relaxes in the next sweep;
    - deletions (and reweights to a larger weight) invalidate every vertex
      whose value was routed through a removed edge,
      ``values[v] == edge_message(values[u], w_old)``, then propagate the
      invalidation along the same relation over the live edges to a
      fixpoint.  Invalidated vertices reset to their init values; their
      live in-neighbours (and, for programs with finite init values such
      as CC, the reset vertices themselves) seed the frontier.
  The relation and the fixpoint run with torch on the DeltaCSR's device,
  over its own edge tensors masked by ``edge_valid``, in float32 (the
  sweep's arithmetic).  The result is a vertex set, so the lane order
  inside a block does not matter.
* **SUM (accumulative)**: after u's out-distribution changes from p_old
  to p_new, the mass ``values[u]`` already pushed is corrected by signed
  deltas ``damping * values[u] * (p_new(x) - p_old(x))`` at each
  neighbour x, in NumPy float64 over the batch's adjacency snapshots
  (work proportional to the batch, not the graph), rounded once to
  float32.

Contract: the warm run equals a run from scratch on the updated graph bit
for bit for MIN programs (the fixpoint is unique) and within the tolerance
for SUM programs.
"""

from __future__ import annotations

from typing import Iterable, Sequence

import numpy as np
import torch

from repro_torch.core.hytm import HyTMConfig, HyTMResult, HyTMState, run_hytm
from repro_torch.graph.algorithms import MIN, VertexProgram
from repro_torch.stream.delta_csr import DeltaCSR, UpdateReport


def _routed_through(
    program: VertexProgram,
    values: torch.Tensor,   # (n,) f32, the pre-update converged values
    src: torch.Tensor,
    dst: torch.Tensor,
    w: torch.Tensor,
) -> torch.Tensor:
    """Mask of edges whose destination value equals the edge's message:
    the destination's value may have been derived through this edge."""
    vs = torch.index_select(values, 0, src)
    msg = program.edge_message(vs, w)
    return torch.isfinite(vs) & (torch.index_select(values, 0, dst) == msg)


def _cat(reports: Sequence[UpdateReport], name: str, dtype) -> np.ndarray:
    return (np.concatenate([getattr(r, name) for r in reports]) if reports
            else np.zeros(0, dtype))


def seed_min(
    program: VertexProgram,
    values: np.ndarray,
    reports: Sequence[UpdateReport],
    dcsr: DeltaCSR,
    source: int | None,
) -> HyTMState:
    """Frontier and state seed for traversal programs (see the module
    docstring), on the DeltaCSR's device."""
    n, dev = dcsr.n_nodes, dcsr.device
    vals = torch.from_numpy(np.array(values, np.float32)).to(dev)
    init_vals = program.init_state(n, source, dev)[0]

    def up(name, dtype):
        return torch.from_numpy(_cat(reports, name, dtype)).to(dev)

    ins_src = up("ins_src", np.int64)
    del_src, del_dst = up("del_src", np.int64), up("del_dst", np.int64)
    del_w = up("del_w", np.float32)

    suspect = torch.zeros(n, dtype=torch.bool, device=dev)
    routed = _routed_through(program, vals, del_src, del_dst, del_w)
    suspect[del_dst[routed]] = True
    if source is not None:
        suspect[source] = False

    csr = dcsr.csr
    ls, ld, valid = csr.edge_src, csr.edge_dst, csr.edge_valid
    routed_live = valid & _routed_through(program, vals, ls, ld, csr.edge_weight)
    if source is not None:
        # the source is never invalidated.  The reference instead clears
        # it after each round, so a routed edge into the source (CC with a
        # source: every label edge is routed) re-grows forever and its
        # loop never ends; wherever the reference's loop ends, no such
        # edge ever grew, and the two give the same set
        routed_live &= ld != source
    while True:
        grow = (routed_live & torch.index_select(suspect, 0, ls)
                & ~torch.index_select(suspect, 0, ld))
        if not bool(grow.any()):
            break
        suspect[ld[grow]] = True

    new_vals = torch.where(suspect, init_vals, vals)
    finite = torch.isfinite(new_vals)
    frontier = torch.zeros(n, dtype=torch.bool, device=dev)
    if len(ins_src):
        frontier[ins_src[torch.index_select(finite, 0, ins_src)]] = True
    feeds = (valid & torch.index_select(suspect, 0, ld)
             & torch.index_select(finite, 0, ls))
    frontier[ls[feeds]] = True
    # programs with finite init values (CC) must push the reset labels out
    frontier |= suspect & finite

    return HyTMState(values=new_vals,
                     delta=torch.zeros(n, dtype=torch.float32, device=dev),
                     frontier=frontier)


def seed_sum(
    program: VertexProgram,
    values: np.ndarray,
    delta: np.ndarray,
    reports: Sequence[UpdateReport],
    dcsr: DeltaCSR,
) -> HyTMState:
    """Correction-delta seed for accumulative programs."""
    values = np.asarray(values, np.float32)
    new_delta = np.asarray(delta, np.float64).copy()
    damping = program.damping
    weighted = program.weighted

    for rep in reports:
        for u, (pre_d, pre_w) in rep.pre_adj.items():
            post_d, post_w = rep.post_adj[u]
            v_u = float(values[u])
            if v_u == 0.0:
                continue
            if weighted:
                w_old = float(pre_w.sum())
                w_new = float(post_w.sum())
                p_old = pre_w / w_old if w_old > 0 else pre_w
                p_new = post_w / w_new if w_new > 0 else post_w
            else:
                p_old = np.full(len(pre_d), 1.0 / max(len(pre_d), 1))
                p_new = np.full(len(post_d), 1.0 / max(len(post_d), 1))
            if len(pre_d):
                np.subtract.at(new_delta, pre_d, damping * v_u * p_old)
            if len(post_d):
                np.add.at(new_delta, post_d, damping * v_u * p_new)

    new_delta = new_delta.astype(np.float32)
    frontier = np.abs(new_delta) > program.tolerance
    dev = dcsr.device
    return HyTMState(
        values=torch.from_numpy(values.copy()).to(dev),
        delta=torch.from_numpy(new_delta).to(dev),
        frontier=torch.from_numpy(frontier).to(dev),
    )


def incremental_state(
    program: VertexProgram,
    values: np.ndarray,
    delta: np.ndarray,
    reports: Iterable[UpdateReport],
    dcsr: DeltaCSR,
    source: int | None,
) -> HyTMState:
    reports = list(reports)
    if program.combine == MIN:
        return seed_min(program, values, reports, dcsr, source)
    return seed_sum(program, values, delta, reports, dcsr)


def run_incremental(
    dcsr: DeltaCSR,
    program: VertexProgram,
    reports: Iterable[UpdateReport],
    values: np.ndarray,
    delta: np.ndarray,
    source: int | None = 0,
    config: HyTMConfig | None = None,
    calibrator=None,
    mesh=None,
    obs=None,
    faults=None,
    retry=None,
) -> HyTMResult:
    """Converge the updated graph from the warm (values, Δ) host arrays of
    an earlier converged run, seeding only the vertices the updates
    affect.

    ``reports`` are the ``DeltaCSR.apply`` reports of every batch applied
    since ``values``/``delta`` were computed, in order.  The run takes
    ``config`` (default ``dcsr.config``) on the DeltaCSR's device, its
    chunked driver included, and learns into ``calibrator`` with
    ``config.autotune``, and records into ``obs`` and guards its dispatches
    with ``faults``/``retry`` as ``run_hytm`` does.

    With ``config.mesh_axis`` set the warm triple goes to the sharded sweep
    over ``dcsr.sharded_runtime_for(program, mesh)`` (``mesh`` a
    ``launch.mesh.GraphMesh``; every rank of its group makes the same
    call), which places an owner-layout state itself.  The seeding is the
    same, and the sharded sweep reproduces the single-device
    ``async_sweep=False`` run, so the result equals the single-device
    warm run with ``async_sweep=False`` bit for bit for MIN programs
    (values, iterations, bytes, engine rows) and within the tolerance for
    SUM programs.  Without ``mesh_axis``, ``mesh`` is not read."""
    config = config if config is not None else dcsr.config
    state = incremental_state(program, values, delta, reports, dcsr, source)
    if config.mesh_axis is not None:
        runtime = dcsr.sharded_runtime_for(program, mesh=mesh, axis=config.mesh_axis,
                                           vertex_sharding=config.vertex_sharding)
        return run_hytm(
            None, program, source=source, config=config, runtime=runtime,
            mesh=runtime.mesh, initial_state=state, calibrator=calibrator, obs=obs,
            faults=faults, retry=retry,
        )
    return run_hytm(
        None, program, source=source, config=config,
        runtime=dcsr.runtime_for(program), initial_state=state,
        calibrator=calibrator, obs=obs, faults=faults, retry=retry,
    )
