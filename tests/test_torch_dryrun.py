"""The dry run (``repro_torch.launch.dryrun``) on the CPU: its census of a
step's collectives against the same step run for real, the per-device
state of a production cell against the reference's shard shapes, and the
CLI's verdicts.

* The census: reduced deepseek-v2-lite's train step (MLA, a dense layer,
  two MoE layers; 2 microbatches, remat) on a (2, 2) mesh, once as rank 0
  of a fake group of 4 under fake tensors (a subprocess: the fake group
  needs its own process) and once for real on 4 gloo ranks.  Kind by kind
  (all-gather, all-reduce, reduce-scatter, all-to-all), the fake census's
  counts and result bytes equal the real run's, read by the same meter,
  and its counts equal DTensor's ``CommDebugMode`` on the real run.  The
  MoE's exchanges are in it: 6 all-to-alls a MoE layer and microbatch
  (dispatch and return, forward, remat's forward and backward).
* internlm2-1.8b's ``train_4k`` on ``pod16x16``: the dry run's per-device
  train state (the local shards of the parameters and AdamW's moments)
  equals the reference's sum of ``NamedSharding.shard_shape`` bytes of its
  state (its int32 step counter aside), computed in a forced-256-device
  subprocess; both are printed beside the reference's own record in
  ``experiments/dryrun/`` (a record older than today's reference).
* The CLI exits 1 and writes a FAIL record when a cell fails (one injected
  into a builder); a skipped shape's record carries the reason; an OK
  record has the reference's keys.
"""

import json
import subprocess
import sys
import textwrap
from pathlib import Path

import numpy as np
import pytest
import torch

from repro.launch.mesh import forced_host_device_env
from repro_torch.launch.mesh import PoolKeeper

ROOT = Path(__file__).resolve().parents[1]
MOE_LAYERS, MICROBATCHES = 2, 2
KINDS = ("all-gather", "all-reduce", "reduce-scatter", "all-to-all", "collective-permute")

_CELL = """
    from repro_torch.configs import get_arch
    from repro_torch.configs.common import lm_train_cell, reduce_lm_config
    from repro_torch.configs.deepseek_v2_lite_16b import OPT

    def census_cell(mesh):
        cfg = reduce_lm_config(get_arch("deepseek-v2-lite-16b").model_config)
        return lm_train_cell(cfg, OPT.replace(warmup_steps=0), 8, 17, 2)(mesh)
"""

_FAKE = _CELL + """
    import json, sys
    from torch._subclasses.fake_tensor import FakeTensorMode
    from repro_torch.launch import dryrun
    from repro_torch.launch.mesh import device_mesh, make_debug_mesh, make_production_mesh

    out = {}
    dryrun.fake_process_group(4)
    mesh = make_debug_mesh(2, 2, device="cpu")
    dm = device_mesh(mesh)
    build = census_cell(mesh)
    with FakeTensorMode(allow_non_fake_inputs=True):
        out["census"] = dryrun.measure(build, dm)["collectives"]
    dryrun.fake_process_group(256)
    mesh = make_production_mesh(device="cpu")
    dm = device_mesh(mesh)
    build = get_arch("internlm2-1.8b").cells["train_4k"](mesh)
    with FakeTensorMode(allow_non_fake_inputs=True):
        args = dryrun.place(build, dm)
        out["state_bytes"] = dryrun.storage_bytes(dryrun.local_leaves(args[0]))[0]
        out["argument_bytes"] = dryrun.storage_bytes(dryrun.local_leaves(args))[0]
    out["skip"] = dryrun.run_cell("internlm2-1.8b", "long_500k", False)
    out["ok"] = dryrun.run_cell("dlrm-mlperf", "serve_p99", False)
    json.dump(out, open(sys.argv[1], "w"))
"""

_REFERENCE = """
    import json, sys
    import jax, numpy as np
    from repro.configs import get_arch
    from repro.launch.mesh import make_production_mesh
    assert len(jax.devices()) == 256
    b = get_arch("internlm2-1.8b").cells["train_4k"](make_production_mesh())
    state, sh = b.args[0], b.in_shardings[0]
    leaves = jax.tree.leaves(state)
    shs = jax.tree.leaves(sh, is_leaf=lambda x: isinstance(x, jax.sharding.Sharding))
    step = int(np.prod(state.step.shape)) * state.step.dtype.itemsize
    total = sum(int(np.prod(s.shard_shape(x.shape))) * x.dtype.itemsize
                for x, s in zip(leaves, shs))
    json.dump({"state_bytes": total - step, "step_bytes": step}, open(sys.argv[1], "w"))
"""

_INJECTED = """
    import sys
    from repro_torch.configs import get_arch
    from repro_torch.launch import dryrun

    def broken(mesh):
        raise RuntimeError("injected failure")

    get_arch("internlm2-1.8b").cells["train_4k"] = broken
    dryrun.main(["--arch", "internlm2-1.8b", "--shape", "train_4k", "--mesh", "single",
                 "--out", sys.argv[1]])
"""


def _start(script: str, out: Path, env=None) -> subprocess.Popen:
    return subprocess.Popen([sys.executable, "-c", textwrap.dedent(script), str(out)],
                            stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True, env=env)


def _wait(proc: subprocess.Popen, timeout: float = 600) -> str:
    out, err = proc.communicate(timeout=timeout)
    assert proc.returncode == 0, f"stdout:\n{out}\nstderr:\n{err[-4000:]}"
    return out


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """The fake run and the reference's shard shapes, two subprocesses
    started with the module (``src`` on the path for both)."""
    tmp = tmp_path_factory.mktemp("dryrun")
    env = forced_host_device_env(256)
    procs = {"fake": _start(_FAKE, tmp / "fake.json"),
             "reference": _start(_REFERENCE, tmp / "reference.json", env)}
    yield {name: (proc, tmp / f"{name}.json") for name, proc in procs.items()}
    for proc in procs.values():
        if proc.poll() is None:
            proc.kill()
        proc.communicate()


def _result(runs, name: str) -> dict:
    proc, path = runs[name]
    if proc.returncode is None:
        _wait(proc)
    return json.loads(path.read_text())


@pytest.fixture(scope="module")
def pools(runs):
    with PoolKeeper(4, threads=1, timeout_s=60.0) as keeper:
        yield keeper


def _op_kind(op) -> str | None:
    from repro_torch.launch.dryrun import _KINDS

    name = getattr(op, "_qualified_op_name", None) or str(op)
    return _KINDS.get(name.split("::")[-1].split(".")[-1])


class _NoModules:
    """A stand-in for ``CommDebugMode``'s module tracker: every op in one
    unnamed module."""

    name, is_bw, activation_checkpointing = "Global", False, False
    module_helper_dict, module_parameters_dict, sharding_dict = {}, {}, {}
    module_parents_dict = {"Global": set()}

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        return None


def _real_rank(group):
    """One gloo rank's run of the census cell with real shards (seeded
    normal floats, zero ids): the meter's census and ``CommDebugMode``'s
    counts by kind."""
    import logging
    import warnings

    logging.getLogger("torch.distributed").setLevel(logging.ERROR)
    warnings.filterwarnings("ignore")
    from torch.distributed.tensor.debug import CommDebugMode

    from repro_torch.launch import dryrun
    from repro_torch.launch.mesh import device_mesh, make_debug_mesh

    namespace = {}
    exec(textwrap.dedent(_CELL), namespace)
    mesh = make_debug_mesh(2, 2, device="cpu")
    gen = torch.Generator().manual_seed(0)

    def real(t, shape):
        if t.dtype.is_floating_point:
            x = torch.randn(shape, generator=gen).mul_(0.02).to(t.dtype)
        else:
            x = torch.zeros(shape, dtype=t.dtype)
        return x.requires_grad_(t.requires_grad)

    build = namespace["census_cell"](mesh)
    comm = CommDebugMode()
    # its per-module tracker fails on remat's recompute in the backward (an
    # IndexError in its forward hook); the counts need no module names
    comm.advanced_module_tracker = _NoModules()
    with comm:
        rec = dryrun.measure(build, device_mesh(mesh), real)
    counts = {}
    for op, n in comm.get_comm_counts().items():
        kind = _op_kind(op)
        assert kind is not None, op
        counts[kind] = counts.get(kind, 0) + n
    return rec["collectives"], counts


def test_fake_census_equals_the_real_run(runs, pools):
    fake = _result(runs, "fake")["census"]
    results = pools.get().run(_real_rank)
    real, counts = results[0]
    for other, other_counts in results[1:]:
        assert other == real and other_counts == counts
    assert set(fake) == set(real) == set(counts), (fake, real, counts)
    for kind in fake:
        assert kind in KINDS
        assert fake[kind]["count"] == real[kind]["count"] == counts[kind], kind
        assert fake[kind]["result_bytes"] == real[kind]["result_bytes"], kind
        assert fake[kind]["wire_bytes"] == real[kind]["wire_bytes"], kind
    # the MoE exchanges: dispatch and return in the forward, remat's forward
    # and the backward, for each MoE layer and microbatch
    assert fake["all-to-all"]["count"] == 6 * MOE_LAYERS * MICROBATCHES


def test_internlm2_train_4k_state_matches_reference_shard_shapes(runs):
    got, want = _result(runs, "fake"), _result(runs, "reference")
    record = json.loads((ROOT / "experiments/dryrun/internlm2-1.8b__train_4k__pod16x16.json")
                        .read_text())
    print(f"internlm2-1.8b train_4k pod16x16, per device: the port's state "
          f"{got['state_bytes']:,} bytes (its arguments with the batch {got['argument_bytes']:,}); "
          f"the reference's shard shapes {want['state_bytes']:,} (+ its step counter "
          f"{want['step_bytes']}); the reference's record: argument_bytes "
          f"{record['memory']['argument_bytes']:,}, output_bytes "
          f"{record['memory']['output_bytes']:,}")
    assert got["state_bytes"] == want["state_bytes"]


def test_skip_record_carries_the_reason(runs):
    rec = _result(runs, "fake")["skip"]
    assert rec["status"] == "SKIP" and rec["mesh"] == "pod16x16" and rec["n_devices"] == 256
    assert "sub-quadratic" in rec["reason"]


def test_cli_exits_1_on_a_failed_cell(tmp_path):
    proc = subprocess.run([sys.executable, "-c", textwrap.dedent(_INJECTED), str(tmp_path)],
                          capture_output=True, text=True, timeout=300)
    assert proc.returncode == 1, proc.stderr[-4000:]
    assert "[FAIL] internlm2-1.8b__train_4k__pod16x16: RuntimeError: injected failure" \
        in proc.stdout
    assert "1 FAILURES" in proc.stdout
    rec = json.loads((tmp_path / "internlm2-1.8b__train_4k__pod16x16.json").read_text())
    assert rec["status"] == "FAIL" and "injected failure" in rec["error"]
    assert "traceback" in rec


def test_ok_record_keeps_the_reference_keys(runs):
    """An OK record (dlrm-mlperf's serve_p99 on pod16x16) has every key of
    the reference's record, its memory and cost keys, and a census of
    known kinds; peak = argument + output + temp - alias."""
    from repro_torch.launch import dryrun

    ref = json.loads((ROOT / "experiments/dryrun/internlm2-1.8b__train_4k__pod16x16.json")
                     .read_text())
    rec = _result(runs, "fake")["ok"]
    assert rec["status"] == "OK"
    assert set(ref) <= set(rec), set(ref) - set(rec)
    assert set(ref["memory"]) <= set(rec["memory"]) and set(ref["cost"]) <= set(rec["cost"])
    m = rec["memory"]
    assert m["peak_device_bytes"] == (m["argument_bytes"] + m["output_bytes"] + m["temp_bytes"]
                                      - m["alias_bytes"])
    assert m["peak_device_bytes"] >= m["argument_bytes"] > 0 and rec["cost"]["flops"] > 0
    assert set(rec["collectives"]) <= set(KINDS)
    for v in rec["collectives"].values():
        assert set(v) == {"count", "result_bytes", "wire_bytes"}
    assert np.isclose(dryrun.wire_bytes("all-reduce", 100.0, 4), 150.0)
    assert np.isclose(dryrun.wire_bytes("reduce-scatter", 100.0, 4), 300.0)
    assert np.isclose(dryrun.wire_bytes("all-gather", 100.0, 4), 75.0)
    assert np.isclose(dryrun.wire_bytes("all-to-all", 100.0, 4), 75.0)
    assert np.isclose(dryrun.wire_bytes("collective-permute", 100.0, 1), 100.0)
