"""The port's convergence loop against the reference under the schedule
options: cds_mode hub / delta / none, the synchronous sweep, and the
forced-engine baselines (the paper's ExpTM-F / ExpTM-C / ImpTM-ZC).  The
contract and tolerances are those of ``test_torch_hytm.py``."""

import numpy as np
import pytest

from repro.core import hytm as jh
from repro.graph import algorithms as jalg
from repro_torch.core import hytm as th
from repro_torch.graph import algorithms as talg
from test_torch_hytm import GRAPHS, _check, _source, _tconfig, reference_runs  # noqa: F401


@pytest.mark.parametrize("name", ["sssp", "bfs", "pagerank", "php", "ppr"])
@pytest.mark.parametrize("cds_mode", ["hub", "delta", "none"])
@pytest.mark.parametrize("async_sweep", [True, False])
def test_schedule_modes_match_reference(reference_runs, name, cds_mode, async_sweep):
    cfg = jh.HyTMConfig(n_partitions=12, sync_every=1, use_kernels=False,
                        cds_mode=cds_mode, async_sweep=async_sweep)
    want = reference_runs("rmat", jalg.ALGORITHMS[name], cfg)
    prog = talg.ALGORITHMS[name]
    got = th.run_hytm(GRAPHS["rmat"](), prog, source=_source(prog),
                      config=_tconfig(cfg, sync_every=4), device="cpu")
    _check(want, got, prog)


@pytest.mark.parametrize("name", ["sssp", "pagerank", "kcore"])
@pytest.mark.parametrize("engine", [0, 1, 2])
def test_forced_engine_baselines_match_reference(reference_runs, name, engine):
    cfg = jh.HyTMConfig(n_partitions=8, sync_every=1, use_kernels=False,
                        forced_engine=engine)
    want = reference_runs("uniform", jalg.ALGORITHMS[name], cfg)
    prog = talg.ALGORITHMS[name]
    got = th.run_hytm(GRAPHS["uniform"](), prog, source=_source(prog),
                      config=_tconfig(cfg, sync_every=4, use_kernels=True), device="cpu")
    _check(want, got, prog)
    assert set(np.unique(got.history["engines"])) <= {-1, engine}
