"""The port's checkpoints, fault-tolerant loop and training launcher
(``repro_torch.train.checkpoint``, ``train.fault_tolerance``,
``launch.train``), with the reference's loop on the same problem.

Tolerances: a restored state is bit-equal to the saved one; a replayed run
bit-equal to the uninterrupted one (the same ops on the same CPU); the
port's loop against the reference's: parameters within 1e-6 of each
leaf's largest after 20 steps with two faults (float32 sums in another
order).
"""

import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.train import fault_tolerance as jft
from repro.train import optimizer as jopt
from repro.train import train_step as jstep
from repro_torch.configs.common import reduce_lm_config
from repro_torch.configs import get_arch
from repro_torch.launch import train as launch_train
from repro_torch.models.transformer import init_transformer, lm_loss
from repro_torch.train import checkpoint as ckpt
from repro_torch.train.compression import CompressionConfig
from repro_torch.train.fault_tolerance import FaultInjector, FaultTolerantLoop, StragglerMonitor
from repro_torch.train.optimizer import OptimizerConfig
from repro_torch.train.train_step import init_train_state, make_train_step, named_params


def _quad_params():
    return {"w": torch.ones((64, 64)), "b": torch.zeros(64)}


def _quad_loss(p, batch):
    return (batch["x"] @ p["w"] + p["b"] - batch["y"]).square().mean()


def _quad_batch(step):
    rng = np.random.default_rng(step)
    x = rng.standard_normal((8, 64)).astype(np.float32)
    return {"x": x, "y": (x @ (0.5 * np.eye(64))).astype(np.float32)}


def _torch_batch(step):
    return {k: torch.from_numpy(v) for k, v in _quad_batch(step).items()}


def _tiny_lm():
    cfg = reduce_lm_config(get_arch("kimi-k2-1t-a32b").model_config)
    return cfg, init_transformer(cfg, torch.Generator().manual_seed(0), "cpu")


def _same_state(a, b) -> None:
    fa, fb = dict(ckpt._flatten(a)), dict(ckpt._flatten(b))
    assert fa.keys() == fb.keys()
    for k in fa:
        if isinstance(fa[k], torch.Tensor):
            assert fa[k].dtype == fb[k].dtype, k
            assert torch.equal(fa[k], fb[k]), k
        else:
            assert fa[k] == fb[k], k


def test_checkpoint_roundtrip_and_atomicity(tmp_path):
    """A whole LM train state (per-layer parameters, stacked AdamW state,
    int8 residuals, the step) round-trips into a fresh state of the same
    structure, in place; a stale ``.tmp`` directory is ignored and
    reaped; keys are the port's names."""
    cfg, model = _tiny_lm()
    oc, cc = OptimizerConfig(), CompressionConfig(kind="int8")
    st = init_train_state(model, oc, cc, device="cpu")
    step_fn = make_train_step(lambda m, b: lm_loss(m, b), oc, cc)
    tokens = torch.from_numpy(np.random.default_rng(0).integers(0, cfg.vocab, (2, 9)))
    st, _ = step_fn(st, tokens)
    d = str(tmp_path)
    ckpt.save_checkpoint(d, 7, st)
    os.makedirs(os.path.join(d, "step_00000099.tmp"))
    assert ckpt.latest_steps(d) == [7]
    keys = dict(ckpt._flatten(st))
    assert "params.layers.1.moe.w_gate" in keys and "opt_state.m.layers.moe.w_gate" in keys
    assert "error_state.layers.attn.wq" in keys and "step" in keys
    _, other = _tiny_lm()
    fresh = init_train_state(other, oc, cc, device="cpu")
    params_before = next(other.parameters())
    step, restored = ckpt.restore_checkpoint(d, fresh)
    assert step == 7 and restored.step == 1
    assert restored.params is other and next(other.parameters()) is params_before
    _same_state(restored, st)
    ckpt.save_checkpoint(d, 8, st)
    assert not os.path.exists(os.path.join(d, "step_00000099.tmp"))


def test_bfloat16_leaves_roundtrip(tmp_path):
    tree = {"w": torch.randn(5, 3).to(torch.bfloat16), "n": 3}
    ckpt.save_checkpoint(str(tmp_path), 1, tree)
    step, out = ckpt.restore_checkpoint(str(tmp_path), {"w": torch.zeros(5, 3,
                                                                         dtype=torch.bfloat16),
                                                        "n": 0})
    assert step == 1 and out["n"] == 3 and torch.equal(out["w"], tree["w"])


def test_async_snapshot_is_a_copy_hazard_g(tmp_path):
    """Hazard (g): ``save_checkpoint`` snapshots before it returns; an
    in-place update of the live tensors made right after (while the writer
    thread may not have started) does not reach the file."""
    w = torch.arange(200_000, dtype=torch.float32)
    want = w.clone()
    ckpt._WRITE_LOCK.acquire()          # hold the writer until the update is made
    try:
        t = ckpt.save_checkpoint(str(tmp_path), 3, {"w": w}, async_write=True)
        w.add_(1.0)
        assert t.is_alive()
    finally:
        ckpt._WRITE_LOCK.release()
    t.join(timeout=60)
    assert not t.is_alive()
    _, out = ckpt.restore_checkpoint(str(tmp_path), {"w": torch.zeros_like(w)})
    assert torch.equal(out["w"], want)


def test_fault_tolerant_loop_replays_deterministically(tmp_path):
    oc = OptimizerConfig(learning_rate=1e-2, warmup_steps=0, schedule="constant")
    step_fn = make_train_step(_quad_loss, oc)
    loop = FaultTolerantLoop(step_fn=step_fn, batch_fn=_torch_batch,
                             ckpt_dir=str(tmp_path / "a"), ckpt_every=5,
                             injector=FaultInjector(fail_at_steps=(7, 13)), async_ckpt=True)
    final, log, restarts = loop.run(init_train_state(_quad_params(), oc, device="cpu"), 20)
    assert restarts == 2 and final.step == 20
    assert [m["step"] for m in log][-1] == 19
    loop2 = FaultTolerantLoop(step_fn=step_fn, batch_fn=_torch_batch,
                              ckpt_dir=str(tmp_path / "b"), ckpt_every=5)
    final2, _, restarts2 = loop2.run(init_train_state(_quad_params(), oc, device="cpu"), 20)
    assert restarts2 == 0
    for k in final.params:
        assert torch.equal(final.params[k], final2.params[k]), k


def test_fault_tolerant_loop_matches_the_reference():
    """The same problem, faults and checkpoints through the reference's
    loop: the final parameters agree."""
    import tempfile

    oc = dict(learning_rate=1e-2, warmup_steps=3, total_steps=20)
    with tempfile.TemporaryDirectory() as td:
        jloop = jft.FaultTolerantLoop(
            step_fn=jstep.make_train_step(
                lambda p, b: jnp.mean(jnp.square(b["x"] @ p["w"] + p["b"] - b["y"])),
                jopt.OptimizerConfig(**oc)),
            batch_fn=lambda s: jax.tree.map(jnp.asarray, _quad_batch(s)), ckpt_dir=td,
            ckpt_every=5, injector=jft.FaultInjector(fail_at_steps=(7, 13)), async_ckpt=False)
        jfinal, _, jr = jloop.run(jstep.init_train_state(
            {"w": jnp.ones((64, 64)), "b": jnp.zeros((64,))}, jopt.OptimizerConfig(**oc)), 20)
    with tempfile.TemporaryDirectory() as td:
        loop = FaultTolerantLoop(step_fn=make_train_step(_quad_loss, OptimizerConfig(**oc)),
                                 batch_fn=_torch_batch, ckpt_dir=td, ckpt_every=5,
                                 injector=FaultInjector(fail_at_steps=(7, 13)))
        final, _, r = loop.run(init_train_state(_quad_params(), OptimizerConfig(**oc),
                                                device="cpu"), 20)
    assert r == jr == 2
    for k in ("w", "b"):
        want = np.asarray(jfinal.params[k])
        err = float(np.abs(final.params[k].detach().numpy() - want).max())
        assert err <= 1e-6 * float(np.abs(want).max()), (k, err)


def test_straggler_monitor_flags():
    mon = StragglerMonitor(factor=3.0)
    for i in range(10):
        mon.record(i, 0.01)
    assert mon.record(10, 0.5) is True
    assert 10 in mon.flagged


def test_launch_train_runs_on_the_cpu(tmp_path, capsys):
    """``python -m repro_torch.launch.train --arch internlm2-1.8b --device
    cpu --steps 2`` trains the reduced config and checkpoints it."""
    out = launch_train.main(["--arch", "internlm2-1.8b", "--device", "cpu", "--steps", "2",
                             "--ckpt-dir", str(tmp_path)])
    assert len(out["log"]) == 2 and all(np.isfinite(m["loss"]) for m in out["log"])
    assert ckpt.latest_steps(str(tmp_path)) == [1, 2]
    text = capsys.readouterr().out
    assert "reduced: 4L d=64 moe=no attn=gqa" in text and "loss " in text


@pytest.mark.parametrize("arch", ["pna", "dlrm-mlperf", "hytgraph"])
def test_launch_train_refuses_non_lm_archs(arch):
    with pytest.raises(SystemExit, match="arch; use examples/torch_train_gnn.py"):
        launch_train.main(["--arch", arch, "--device", "cpu"])


def test_microbatched_lm_step_matches_the_full_batch():
    """``microbatches=2`` on an LM: the accumulated gradients equal the full
    batch's to float32 rounding (hazard (e)), through the train step."""
    cfg, model = _tiny_lm()
    _, other = _tiny_lm()
    tokens = torch.from_numpy(np.random.default_rng(1).integers(0, cfg.vocab, (4, 9)))
    oc = OptimizerConfig(learning_rate=1e-3, warmup_steps=0, schedule="constant",
                         grad_clip=1e9)
    a = init_train_state(model, oc, device="cpu")
    b = init_train_state(other, oc, device="cpu")
    a, ma = make_train_step(lambda m, t: lm_loss(m, t), oc)(a, tokens)
    b, mb = make_train_step(lambda m, t: lm_loss(m, t), oc, microbatches=2)(b, tokens)
    pa, pb = named_params(a.params), named_params(b.params)
    for k in pa:
        err = float((pa[k] - pb[k]).detach().abs().max())
        assert err <= 1e-5 * float(pa[k].abs().max()) + 1e-7, k
