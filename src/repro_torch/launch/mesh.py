"""Process groups for the sharded graph sweep (``dist.graph_shard``) and
for models over a mesh (``models.moe``, ``models.transformer``).

The reference's ``make_graph_mesh`` (``repro/launch/mesh.py:44``) builds a
1-D JAX mesh that one process drives.  Here a *mesh* is a 1-D
``torch.distributed`` group with one process a rank: :class:`GraphMesh`
names the group, its axis, this rank and this rank's device, and every
rank of the group calls the sharded entry points with the same arguments
(SPMD).

:class:`RankPool` starts a group on one host with no network: this process
is rank 0, ranks ``1..world_size-1`` are spawned processes, and the ranks
meet through a ``FileStore`` in a temporary directory.  ``run(fn, *args)``
calls ``fn(group, *args)`` on every rank (``group`` is ``None`` for the
whole world) and returns the ranks' results in rank order.  Every group
has a timeout and every wait for a rank a limit, so a deadlock on a
collective fails the call instead of hanging it.

:class:`ModelMesh` is the counterpart of the reference's
``make_debug_mesh`` (``repro/launch/mesh.py:34``): an (optional ``pod``)
x ``data`` x ``model`` mesh, one process a rank, ranks laid out row-major
as ``jax.make_mesh`` lays out devices (rank ``(p * n_data + d) * n_model +
m`` sits at ``(p, d, m)``).  It holds one process group for each axis set
that a collective runs over (each axis alone, and ``("pod", "data")``), so
an MoE layer can exchange over its expert axes and reduce over
``model``, and a gloo group of the whole mesh for host-side checks.
``make_production_mesh`` is the reference's 16 x 16 (or 2 x 16 x 16) mesh
over whatever default group exists (the dry run's fake one), and
``device_mesh`` a mesh's ``DeviceMesh`` for DTensor placements.
"""

from __future__ import annotations

import datetime
import itertools
import math
import os
import shutil
import tempfile
import time
import traceback
from dataclasses import dataclass
from queue import Empty

import numpy as np
import torch
import torch.distributed as dist

from repro_torch.kernels.runtime import resolve_device


@dataclass(frozen=True)
class GraphMesh:
    """One rank's view of a 1-D process group."""

    group: object          # a torch.distributed ProcessGroup
    axis: str
    size: int
    rank: int
    device: torch.device   # this rank's device


def make_graph_mesh(axis: str = "graph", group=None,
                    device: str | torch.device | None = None) -> GraphMesh:
    """This rank's :class:`GraphMesh` over ``group`` (the default group
    when ``None``; ``torch.distributed`` must be initialized).  The device
    is ``cuda:<rank % device count>`` unless the caller passes one
    (``"cpu"``, or ``"cuda:0"`` for several ranks on one card); with no
    card that raises, as ``resolve_device`` does."""
    if device is None and not torch.cuda.is_available():
        resolve_device(None)   # raises: no CUDA device
    if not dist.is_initialized():
        raise RuntimeError(
            "make_graph_mesh: torch.distributed is not initialized (start the "
            "ranks with RankPool or init_process_group first)")
    group = dist.group.WORLD if group is None else group
    if device is None:
        device = f"cuda:{dist.get_rank() % torch.cuda.device_count()}"
    return GraphMesh(group=group, axis=axis, size=dist.get_world_size(group),
                     rank=dist.get_rank(group), device=resolve_device(device))


def group_ranks(mesh: GraphMesh) -> tuple:
    """The global ranks of ``mesh``'s group, in group order (``range(size)``
    for a mesh with no group)."""
    if mesh.group is None or not dist.is_initialized():
        return tuple(range(mesh.size))
    return tuple(dist.get_process_group_ranks(mesh.group))


# per group (its global ranks), the number of barriers this process has
# entered since the default group was made: the same on every rank (SPMD)
_BARRIERS: dict = {}


def _barrier_key(ranks: tuple) -> str:
    default = dist.group.WORLD
    if _BARRIERS.get("world") is not default:   # a new default group: count afresh
        _BARRIERS.clear()
        _BARRIERS["world"] = default
    n = _BARRIERS.get(ranks, 0)
    _BARRIERS[ranks] = n + 1
    return f"mesh_barrier/{'-'.join(map(str, ranks))}/{n}"


def _arrivals(store, key: str, ranks: tuple) -> dict:
    """{rank: its wall-clock arrival} of the ranks that recorded one."""
    out = {}
    for r in ranks:
        if store.check([f"{key}/{r}"]):
            out[r] = float(store.get(f"{key}/{r}").decode())
    return out


def mesh_barrier(mesh: GraphMesh) -> None:
    """Return on each rank only once every rank of ``mesh`` has called it:
    one ``all_reduce`` of one element on the mesh's device, waited for on
    the host (the same on gloo and NCCL).  No-op on a one-rank mesh.

    Each rank first writes its wall-clock time of arrival into the default
    group's store under the barrier's key (the group's ranks and the count
    of barriers it has passed).  When the ``all_reduce`` fails (a gloo
    timeout, a rank gone), the ``RuntimeError`` names the ranks that had
    not arrived and gives each arrival's time."""
    if mesh.size == 1:
        return
    ranks = group_ranks(mesh)
    key = _barrier_key(ranks)
    store = dist.distributed_c10d._get_default_store()
    me = dist.get_rank()
    t_in = time.time()
    store.set(f"{key}/{me}", repr(t_in))
    token = torch.zeros(1, device=mesh.device)
    try:
        dist.all_reduce(token, group=mesh.group)
        token.item()
    except RuntimeError as exc:
        waited = time.time() - t_in
        seen = _arrivals(store, key, ranks)
        late = [r for r in ranks if r not in seen]
        first = min(seen.values())
        times = ", ".join(f"rank {r} at +{t - first:.3f} s" for r, t in sorted(seen.items()))
        raise RuntimeError(
            f"mesh_barrier {key} failed on rank {me} after {waited:.1f} s: ranks {late} had "
            f"not arrived; arrivals (from the first, at {first:.3f}): {times}") from exc


def _timeout(seconds: float) -> datetime.timedelta:
    return datetime.timedelta(seconds=seconds)


# the timeout RankPool gave this process's groups (None outside a pool)
_POOL_TIMEOUT_S: float | None = None
DEFAULT_TIMEOUT_S = 60.0

MESH_AXES = ("pod", "data", "model")


@dataclass(frozen=True)
class ModelMesh:
    """One rank's view of a (pod x) data x model mesh.

    ``groups`` maps an axis tuple to the process group of the ranks that
    share this rank's coordinates on every other axis (the ranks a
    collective over those axes spans, in row-major order of the axes);
    ``host_group`` is a gloo group of the whole mesh for checks on host
    values (``None`` on a one-rank mesh)."""

    axis_names: tuple
    shape: tuple
    coords: tuple          # this rank's index on each axis
    rank: int              # this rank's index in the mesh, row-major
    group: object          # the whole mesh
    host_group: object
    groups: dict
    device: torch.device

    @property
    def size(self) -> int:
        return math.prod(self.shape)

    def axes(self, axes) -> tuple:
        """``axes`` (a name or a tuple of names) as a tuple; raises
        ``ValueError`` for an axis the mesh lacks."""
        axes = (axes,) if isinstance(axes, str) else tuple(axes)
        missing = [a for a in axes if a not in self.axis_names]
        if missing or not axes:
            raise ValueError(f"mesh axes {self.axis_names} lack {missing or 'an axis'}")
        return axes

    def axis_size(self, axes) -> int:
        return math.prod(self.shape[self.axis_names.index(a)] for a in self.axes(axes))

    def axis_index(self, axes) -> int:
        """This rank's index along ``axes``, row-major over them (the order
        in which a tiled collective over them concatenates)."""
        i = 0
        for a in self.axes(axes):
            k = self.axis_names.index(a)
            i = i * self.shape[k] + self.coords[k]
        return i

    def group_of(self, axes):
        """The process group over ``axes``; raises ``ValueError`` for an
        axis set the mesh made no group for."""
        axes = self.axes(axes)
        key = tuple(a for a in self.axis_names if a in axes)
        if key not in self.groups:
            raise ValueError(f"the mesh has no group over {axes} (it has {sorted(self.groups)})")
        return self.groups[key]


_MESHES: dict = {}


def _axis_sets(names: tuple) -> list:
    sets = [(a,) for a in names]
    if "pod" in names:
        sets.append(("pod", "data"))
    return sets


def make_debug_mesh(n_data: int = 2, n_model: int = 2, pods: int = 0, ranks=None,
                    device: str | torch.device | None = None) -> ModelMesh | None:
    """This rank's :class:`ModelMesh` of shape (n_data, n_model), or (pods,
    n_data, n_model) with a ``pod`` axis, over the global ``ranks`` (all of
    the default group when ``None``) in row-major order.

    Every rank of the default group must call it, in the same order as
    the others (``dist.new_group``'s rule); a rank outside ``ranks`` gets
    ``None``.  Groups are made once a process and mesh and reused, each
    with the timeout ``RankPool`` gave this process's groups (60 s outside
    a pool).  The device is ``cuda:<rank % device count>`` unless the
    caller passes one; with no card that raises, as ``make_graph_mesh``
    does."""
    if device is None and not torch.cuda.is_available():
        resolve_device(None)   # raises: no CUDA device
    if not dist.is_initialized():
        raise RuntimeError(
            "make_debug_mesh: torch.distributed is not initialized (start the "
            "ranks with RankPool or init_process_group first)")
    shape = (pods, n_data, n_model) if pods else (n_data, n_model)
    names = MESH_AXES if pods else MESH_AXES[1:]
    if min(shape) < 1:
        raise ValueError(f"make_debug_mesh: mesh shape {shape} must be positive")
    world = dist.get_world_size()
    ranks = tuple(range(world)) if ranks is None else tuple(int(r) for r in ranks)
    if len(ranks) != math.prod(shape) or list(ranks) != sorted(set(ranks)):
        # ascending, so that each group's order (dist.new_group sorts) is the mesh's
        raise ValueError(f"make_debug_mesh: {math.prod(shape)} distinct ascending ranks for a "
                         f"mesh of shape {shape}, got {ranks}")
    timeout = _timeout(_POOL_TIMEOUT_S or DEFAULT_TIMEOUT_S)
    key = (ranks, shape, timeout)
    default = dist.group.WORLD
    if _MESHES.get("world") is not default:   # a new default group: drop the old meshes
        _MESHES.clear()
        _MESHES["world"] = default
    if key not in _MESHES:
        def make(members):
            if len(members) == world:
                return default
            return dist.new_group(list(members), timeout=timeout)

        grid = np.array(ranks).reshape(shape)
        whole = make(ranks)
        groups = {}
        for axes in _axis_sets(names):
            ks = [names.index(a) for a in axes]
            # one row a group: the ranks along ``axes``, row-major over them
            rows = np.moveaxis(grid, ks, range(-len(ks), 0)).reshape(
                -1, math.prod(shape[k] for k in ks))
            for row in rows.tolist():
                groups[(axes, tuple(row))] = whole if len(row) == len(ranks) else make(row)
        host = None
        if len(ranks) > 1:
            # the dry run's fake group answers host checks itself
            host = whole if dist.get_backend() in ("gloo", "fake") else dist.new_group(
                list(ranks), timeout=timeout, backend="gloo")
        _MESHES[key] = (grid, whole, groups, host)
    grid, whole, groups, host = _MESHES[key]
    me = dist.get_rank()
    if me not in ranks:
        return None
    coords = tuple(int(c) for c in np.argwhere(grid == me)[0])
    mine = {axes: g for (axes, members), g in groups.items() if me in members}
    if device is None:
        device = f"cuda:{me % torch.cuda.device_count()}"
    return ModelMesh(axis_names=names, shape=shape, coords=coords, rank=ranks.index(me),
                     group=whole, host_group=host, groups=mine, device=resolve_device(device))


def make_production_mesh(*, multi_pod: bool = False,
                         device: str | torch.device | None = None) -> ModelMesh | None:
    """The reference's production mesh (``repro/launch/mesh.py:27-31``):
    16 x 16 = 256 ranks on (``data``, ``model``), or 2 x 16 x 16 = 512 on
    (``pod``, ``data``, ``model``), over the default process group, which
    must have that many ranks (the dry run's fake group has)."""
    return make_debug_mesh(16, 16, pods=2 if multi_pod else 0, device=device)


_DEVICE_MESHES: dict = {}


def _forget_sharding_decisions() -> None:
    """Clear DTensor's caches of sharding decisions.  They are keyed by a
    mesh's value (ranks, shape, names, device type), not its process
    groups, so a mesh of a new default group equal to one of an old group
    would reuse the old decisions and with them the old mesh, whose groups
    are destroyed: its next collective waits forever."""
    from torch.distributed.tensor import debug

    clear = getattr(debug, "_clear_sharding_prop_cache", None)
    if clear is not None:
        clear()
        return
    from torch.distributed.tensor import DTensor

    DTensor._op_dispatcher.sharding_propagator.propagate_op_sharding.cache_clear()


def device_mesh(mesh: ModelMesh):
    """The ``torch.distributed.device_mesh.DeviceMesh`` of ``mesh`` (its
    ranks in row-major order, ``mesh_dim_names = mesh.axis_names``, the
    mesh's device type), for DTensor placements (``dist.sharding``).  It
    is built from the mesh's own process groups, one an axis
    (``DeviceMesh.from_group``), so it makes no group and runs no
    collective; made once a mesh and reused."""
    from torch.distributed.device_mesh import DeviceMesh

    resolve_device(mesh.device)   # a CUDA mesh without a card raises
    default = dist.group.WORLD
    if _DEVICE_MESHES.get("world") is not default:   # a new default group
        _DEVICE_MESHES.clear()
        _DEVICE_MESHES["world"] = default
        _forget_sharding_decisions()
    key = (tuple(dist.get_process_group_ranks(mesh.group)), mesh.shape, mesh.axis_names,
           mesh.device.type)
    if key not in _DEVICE_MESHES:
        grid = torch.tensor(key[0], dtype=torch.int).reshape(mesh.shape)
        groups = [mesh.group_of(a) for a in mesh.axis_names]
        _DEVICE_MESHES[key] = DeviceMesh.from_group(
            groups, mesh.device.type, mesh=grid, mesh_dim_names=mesh.axis_names)
    return _DEVICE_MESHES[key]


# the longest a rank waits at the store for the others to arrive: a spawned
# rank imports torch first, which on a loaded host can take longer than a
# short group timeout, and gloo's connection set-up is bounded by the
# group's timeout, so every rank waits for the others before it starts
RENDEZVOUS_S = 300.0


def _join_group(rank: int, world_size: int, backend: str, store: str,
                timeout_s: float, subgroups) -> dict:
    """Initialize the default group and every subgroup (collectively, in
    order, on every rank); returns ``{ranks: group}``.  Every rank first
    waits at the store (up to ``max(timeout_s, RENDEZVOUS_S)``) until all
    have arrived; the groups and their collectives time out after
    ``timeout_s``."""
    global _POOL_TIMEOUT_S
    file_store = dist.FileStore(store, world_size)
    file_store.set_timeout(_timeout(max(timeout_s, RENDEZVOUS_S)))
    file_store.set(f"arrived/{rank}", "1")
    file_store.wait([f"arrived/{r}" for r in range(world_size)])
    dist.init_process_group(backend, store=file_store, rank=rank, world_size=world_size,
                            timeout=_timeout(timeout_s))
    _POOL_TIMEOUT_S = timeout_s
    return {tuple(r): dist.new_group(list(r), timeout=_timeout(timeout_s))
            for r in subgroups}


def _rank_main(rank, world_size, backend, store, timeout_s, subgroups, threads,
               tasks, results):
    """A spawned rank: run tasks until the ``None`` sentinel."""
    if threads is not None:
        torch.set_num_threads(threads)
    groups = _join_group(rank, world_size, backend, store, timeout_s, subgroups)
    try:
        while (task := tasks.get()) is not None:
            fn, args, ranks = task
            if rank not in ranks:
                continue
            try:
                results.put((rank, True, fn(groups.get(ranks), *args)))
            except Exception:   # reported to rank 0, which raises
                results.put((rank, False, traceback.format_exc()))
    finally:
        dist.destroy_process_group()


class RankPool:
    """``world_size`` ranks on this host: this process is rank 0, the others
    spawned processes (``torch.multiprocessing``, ``spawn``) that run tasks
    until :meth:`close`.  ``subgroups`` lists rank tuples to make groups of
    (``run(..., ranks=(0, 1))`` runs on one); ``threads`` sets the spawned
    ranks' ``torch.set_num_threads``.  Every group gets ``timeout_s``, and
    :meth:`run` waits at most 30 s longer than that for a rank.
    After a failed run the pool refuses further runs: its groups may be
    mid-collective."""

    def __init__(self, world_size: int, backend: str = "gloo", timeout_s: float = 60.0,
                 subgroups=(), threads: int | None = None):
        self.world_size = world_size
        # a rank blocked in a collective raises after timeout_s
        self.wait_s = timeout_s + 30.0
        self._dir = tempfile.mkdtemp(prefix="repro_torch_ranks_")
        store = os.path.join(self._dir, "store")
        ctx = torch.multiprocessing.get_context("spawn")
        self._tasks = [ctx.SimpleQueue() for _ in range(world_size - 1)]
        self._results = ctx.Queue()
        self._procs = [
            ctx.Process(target=_rank_main, daemon=True, args=(
                rank, world_size, backend, store, timeout_s, tuple(subgroups), threads,
                self._tasks[rank - 1], self._results))
            for rank in range(1, world_size)]
        self.broken = False
        self._joined = False
        try:
            for p in self._procs:
                p.start()
            self._groups = _join_group(0, world_size, backend, store, timeout_s, subgroups)
            self._joined = True
        except BaseException:
            self.close()
            raise

    def run(self, fn, *args, ranks=None) -> list:
        """``fn(group, *args)`` on each rank of ``ranks`` (all when
        ``None``; else one of the pool's ``subgroups``), this process's call
        included; their results in rank order.  ``fn`` and ``args`` are
        pickled to the spawned ranks (``fn`` by its import path)."""
        if self.broken:
            raise RuntimeError("RankPool: an earlier run failed; the pool is unusable")
        ranks = tuple(range(self.world_size)) if ranks is None else tuple(ranks)
        for task in self._tasks:
            task.put((fn, args, ranks))
        self.broken = True   # until every rank has reported
        out, errors = {}, []
        try:
            if 0 in ranks:
                out[0] = fn(self._groups.get(ranks), *args)
        except Exception:
            errors.append("rank 0:\n" + traceback.format_exc())
        finally:
            for _ in range(sum(r != 0 for r in ranks)):
                try:
                    rank, ok, value = self._results.get(timeout=self.wait_s)
                except Empty:
                    errors.append(f"a rank gave no result within {self.wait_s:.0f} s")
                    break
                if ok:
                    out[rank] = value
                else:
                    errors.append(f"rank {rank}:\n{value}")
        if errors:
            raise RuntimeError("RankPool.run failed:\n" + "\n".join(errors))
        self.broken = False
        return [out[r] for r in ranks]

    def close(self) -> None:
        """Stop the spawned ranks (each joined within a limit, killed
        otherwise) and destroy this process's group."""
        for task, p in zip(self._tasks, self._procs):
            if p.is_alive():
                task.put(None)
        for p in self._procs:
            if p.pid is not None:
                p.join(timeout=10)
                if p.is_alive():
                    p.kill()
                    p.join(timeout=10)
        if self._joined:
            dist.destroy_process_group()
            self._joined = False
        shutil.rmtree(self._dir, ignore_errors=True)

    def __enter__(self) -> "RankPool":
        return self

    def __exit__(self, *exc) -> None:
        self.close()


class PoolKeeper:
    """One :class:`RankPool` at a time for a run of cases (a test module's
    pool): :meth:`get` returns the live pool, or closes a broken one (a run
    of it failed) and starts a fresh one with the same arguments, so one
    failed run fails one case and not every case after it."""

    def __init__(self, *args, **kwargs):
        self._args, self._kwargs = args, kwargs
        self._pool: RankPool | None = None
        self.started = 0

    def get(self) -> RankPool:
        if self._pool is not None and self._pool.broken:
            self._pool.close()
            self._pool = None
        if self._pool is None:
            self._pool = RankPool(*self._args, **self._kwargs)
            self.started += 1
        return self._pool

    def close(self) -> None:
        if self._pool is not None:
            self._pool.close()
            self._pool = None

    def __enter__(self) -> "PoolKeeper":
        return self

    def __exit__(self, *exc) -> None:
        self.close()
