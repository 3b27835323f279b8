"""The rank pool's failure path: a timed-out ``mesh_barrier`` names the rank
that had not arrived, and ``PoolKeeper`` hands the next case a working pool
after a run that broke the last one; and a new pool's DTensor mesh takes
none of an old pool's cached sharding (two gloo ranks on the CPU)."""

import pytest
import torch
import torch.distributed as dist

from repro_torch.launch.mesh import PoolKeeper, make_graph_mesh, mesh_barrier


def _rank(group):
    """No collective: the spawned rank imports this module on its first task,
    which must not count against a timed collective."""
    return dist.get_rank()


def _healthy(group):
    """Every rank passes a barrier and sums a one."""
    mesh_barrier(make_graph_mesh(device="cpu"))
    t = torch.ones(1)
    dist.all_reduce(t)
    return float(t[0])


def _one_rank_raises(group, failing: int):
    """``failing`` raises before the barrier; the others wait in it."""
    mesh = make_graph_mesh(device="cpu")
    if dist.get_rank() == failing:
        raise ValueError("this rank fails before the barrier")
    mesh_barrier(mesh)


def test_late_rank_is_named_and_the_next_case_gets_a_fresh_pool():
    with PoolKeeper(2, threads=1, timeout_s=2.0) as keeper:
        pool = keeper.get()
        assert pool.run(_rank) == [0, 1]
        assert pool.run(_healthy) == [2.0, 2.0]
        with pytest.raises(RuntimeError) as err:
            pool.run(_one_rank_raises, 1)
        msg = str(err.value)
        # rank 0's barrier timed out after the 2 s and named rank 1 as late
        assert "ranks [1] had not arrived" in msg, msg
        assert "rank 0 at +0.000 s" in msg, msg
        assert "this rank fails before the barrier" in msg, msg
        assert pool.broken
        assert keeper.get() is not pool and keeper.started == 2
        # the fresh pool's barriers count from 0 again, on both ranks
        assert keeper.get().run(_rank) == [0, 1]
        assert keeper.get().run(_healthy) == [2.0, 2.0]
        assert keeper.get().run(_healthy) == [2.0, 2.0]
        assert keeper.started == 2


def _placed_sum(group, first: bool):
    """A DTensor reduction on a (2, 1) mesh of ranks 0 and 1 (a subgroup
    of the pool's three; rank 2 makes the groups too and returns None): the
    whole sum of ``arange(8)`` split over ``data``.  ``first``: a (1, 2)
    mesh's groups are made before, so that the two pools' groups of the
    (2, 1) mesh differ in name."""
    from torch.distributed.tensor import Shard, distribute_tensor

    from repro_torch.launch.mesh import device_mesh, make_debug_mesh

    if first:
        make_debug_mesh(1, 2, ranks=(0, 1), device="cpu")
    mesh = make_debug_mesh(2, 1, ranks=(0, 1), device="cpu")
    if mesh is None:
        return None
    dm = device_mesh(mesh)
    x = distribute_tensor(torch.arange(8.0), dm, [Shard(0), Shard(0)], src_data_rank=None)
    return float(x.sum().full_tensor())


def test_a_new_pool_does_not_reuse_an_old_meshs_sharding():
    """Two pools in turn, each with a (2, 1) mesh on a subgroup equal by
    value to the other's: DTensor caches its sharding decisions by a mesh's
    value, so the second pool's step would take the first's mesh and wait
    on its destroyed groups unless ``device_mesh`` clears them for a new
    default group.  A short timeout turns that wait into a failure."""
    for first in (True, False):
        with PoolKeeper(3, threads=1, timeout_s=10.0) as keeper:
            assert keeper.get().run(_placed_sum, first) == [28.0, 28.0, None]
