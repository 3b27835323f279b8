"""The rank pool's failure path: a timed-out ``mesh_barrier`` names the rank
that had not arrived, and ``PoolKeeper`` hands the next case a working pool
after a run that broke the last one (two gloo ranks on the CPU)."""

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
