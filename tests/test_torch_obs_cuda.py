"""``run_hytm``'s host spans against the card's trace, and its host-sync
counter against PyTorch's sync debug mode.  These tests import neither jax
nor the reference, so they run on the machine with the card; without one
they skip.

* One clock: in a traced ``run_hytm`` under ``torch.profiler``, every
  kernel starts at or after its launch; once the spans are moved by
  ``obs.device.clock_offset_ns``, every launch lies inside the run span
  but the initial state's fills (launched before the run's clock starts),
  and the work a ``sync`` span waits on ends before that span ends.
* The counter misses no sync: the synchronizing calls that
  ``torch.cuda.set_sync_debug_mode("warn")`` reports in one run equal the
  run's ``hytm.host_syncs`` total, for SSSP and Δ-PageRank, K = 8 and 1.
"""

import dataclasses
import gc
import time
import warnings

import pytest
import torch

from repro_torch import obs
from repro_torch.core import hytm
from repro_torch.graph import algorithms as alg
from repro_torch.graph.generators import rmat_graph
from repro_torch.obs import device as obs_device

# The offset read before and after the segment may differ (the wall clock
# is slewed); the spans' placement is good to that, and to the rounding of
# a monotonic stamp in float seconds.
ROUNDING_NS = 1_000


def _cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the device trace and its syncs exist only there)")
    return torch.device("cuda")


@pytest.fixture(scope="module")
def runtime():
    from torch.profiler import ProfilerActivity, profile

    dev = _cuda()
    g = rmat_graph(1 << 14, 1 << 18, seed=3)
    cfg = hytm.HyTMConfig(n_partitions=16, sync_every=8)
    rt = hytm.build_runtime(g, cfg, device=dev)
    # A process's first profiling session may place its first device
    # records early, up to 61 us before their own launches on the H100
    # (torch 2.11); later sessions do not.  Spend that first session here.
    with profile(activities=[ProfilerActivity.CUDA]):
        hytm.run_hytm(None, alg.SSSP, 0, cfg, runtime=rt)
        torch.cuda.synchronize()
    return rt, cfg


def _program(name: str):
    if name == "sssp":
        return alg.SSSP, 0, {}
    return dataclasses.replace(alg.PAGERANK, tolerance=1e-4), None, {"cds_mode": "delta"}


@pytest.mark.cuda
@pytest.mark.parametrize("name", ["sssp", "pagerank"])
def test_spans_and_device_trace_share_one_clock(runtime, name):
    from torch.profiler import ProfilerActivity, profile

    rt, cfg = runtime
    prog, source, over = _program(name)
    cfg = dataclasses.replace(cfg, **over)
    hytm.run_hytm(None, prog, source, cfg, runtime=rt)  # builds and loads the kernels
    rec = obs.TraceRecorder()
    torch.cuda.synchronize()
    off0 = obs_device.clock_offset_ns()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        called = time.monotonic_ns()
        hytm.run_hytm(None, prog, source, cfg, runtime=rt, obs=rec)
        torch.cuda.synchronize()
        returned = time.monotonic_ns()
    off1 = obs_device.clock_offset_ns()
    slack = abs(off1 - off0) + ROUNDING_NS
    spans = obs_device.program_spans(rec, (off0 + off1) // 2)
    ops = obs_device.launched_ops(prof.profiler.kineto_results)
    launched = [op for op in ops if op.launch_ns is not None]
    assert launched and len(launched) == len(ops), {op.name for op in ops} - \
        {op.name for op in launched}
    (run,) = [s for s in spans if s.name == "hytm_run"]
    offset = (off0 + off1) // 2
    for op in launched:
        assert op.start_ns >= op.launch_ns, op
        assert called + offset - slack <= op.launch_ns <= returned + offset + slack, op
        # the run's clock starts once its initial state is on the card
        assert op.launch_ns <= run.end_ns + slack, op
    # those before it fill the initial state (SSSP: five fills)
    before = [op for op in launched if op.launch_ns < run.start_ns - slack]
    assert len(before) <= 5 and all("Fill" in op.name or "Memset" in op.name
                                    for op in before), before
    syncs = [s for s in spans if s.name == "sync"]
    assert syncs
    for s in syncs:
        waited = [op for op in launched if op.launch_ns <= s.end_ns - slack]
        assert max(op.end_ns for op in waited) <= s.end_ns + slack, s
    got = obs_device.charge(ops, spans, min(op.start_ns for op in ops),
                            max(op.end_ns for op in ops))
    outside = got.device_s.get("outside the spans", 0.0)
    assert outside <= 0.05 * sum(got.device_s.values()), got.device_s


# what the sync debug mode warns at each synchronizing call (c10's
# warn_or_error_on_sync); its other warnings, such as a note on the mode
# itself, are not syncs
SYNC_WARNING = "called a synchronizing CUDA operation"


def _warnings(fn) -> list:
    with warnings.catch_warnings(record=True) as seen:
        warnings.simplefilter("always")
        torch.cuda.set_sync_debug_mode("warn")
        try:
            fn()
        finally:
            torch.cuda.set_sync_debug_mode("default")
    return [(str(w.message), f"{w.filename}:{w.lineno}") for w in seen]


@pytest.mark.cuda
@pytest.mark.parametrize("K", [8, 1])
@pytest.mark.parametrize("name", ["sssp", "pagerank"])
def test_host_sync_counter_misses_no_sync(runtime, name, K):
    rt, cfg = runtime
    prog, source, over = _program(name)
    cfg = dataclasses.replace(cfg, sync_every=K, **over)
    hytm.run_hytm(None, prog, source, cfg, runtime=rt)
    torch.cuda.synchronize()
    gc.collect()  # no earlier object's finalizer may sync inside the count
    before = dict(hytm.host_syncs)
    seen = _warnings(lambda: hytm.run_hytm(None, prog, source, cfg, runtime=rt))
    counted = sum(hytm.host_syncs[k] - before[k] for k in hytm.SYNC_SITES)
    syncs = [where for message, where in seen if SYNC_WARNING in message]
    others = {message for message, _ in seen if SYNC_WARNING not in message}
    assert counted > 0 and len(syncs) == counted, (counted, syncs, others)
