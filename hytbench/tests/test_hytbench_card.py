"""One short traced run of each cell on the card, at a small scale: the
kernels build, the profiler's trace holds device time, and the answers
match the reference.  Skips without a card (decided inside the test)."""

import pytest
import torch

from hytbench import harness


@pytest.mark.cuda
@pytest.mark.parametrize("cell", ["kron-sssp", "kron-pagerank", "urand-sssp"])
def test_traced_run_on_the_card(cell):
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    spec = harness.load_spec()
    entry = harness.find(spec["workloads"], cell, "workload")
    cfg = dict(harness.config_of(spec, entry), scale=16)
    out = harness.run_cell(spec, entry, 2**31 + 3, 1.0, True, torch.device("cuda", 0),
                           t_start=0.0, cfg=cfg)
    assert out["correct"] and out["device"]["busy_s"] > 0
    assert set(out["metrics"]) == {m["name"] for m in harness.metrics_of(spec, cell, True)}
    assert 0 < out["metrics"][f"relax_roofline.{harness.traffic_of(entry['traffic'])['algorithm']}"]["value"] < 100
