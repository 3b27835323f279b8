"""Train a ~20M-param LM (MoE, with HyTM sorted dispatch) on the PyTorch/CUDA
port for a few hundred steps with int8 gradient compression + error
feedback and fault-tolerant checkpointing (twin of
``examples/train_lm.py``).  Runs on the card unless given ``--device
cpu``; pass --wide for a ~100M dense model.

    PYTHONPATH=src python examples/torch_train_lm.py [--steps 200] [--device cpu]
"""

import argparse
import sys
import tempfile
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parents[1] / "src"))

import numpy as np
import torch

from repro_torch.data.pipeline import LMBatches
from repro_torch.kernels.runtime import resolve_device
from repro_torch.models.moe import MoEConfig
from repro_torch.models.transformer import (Transformer, TransformerConfig, init_transformer,
                                            lm_loss)
from repro_torch.train.compression import CompressionConfig
from repro_torch.train.fault_tolerance import FaultInjector, FaultTolerantLoop
from repro_torch.train.optimizer import OptimizerConfig
from repro_torch.train.train_step import init_train_state, make_train_step


def lm_config(wide: bool = False) -> TransformerConfig:
    if wide:
        return TransformerConfig(
            name="lm-100m", n_layers=8, d_model=512, n_heads=8, n_kv_heads=4,
            d_head=64, d_ff=2048, vocab=32_000, dtype="float32", param_dtype="float32")
    return TransformerConfig(
        name="lm-20m-moe", n_layers=4, d_model=256, n_heads=8, n_kv_heads=4,
        d_head=32, d_ff=512, vocab=8_192,
        moe=MoEConfig(n_experts=8, top_k=2, d_ff=512, capacity_factor=2.0, dispatch="sorted"),
        dtype="float32", param_dtype="float32")


def setup(cfg: TransformerConfig, steps: int, device, batch: int = 8, seq_len: int = 128):
    """(state, step_fn, batch_fn): the model from a seeded generator on the
    device, AdamW with warmup and cosine decay, int8 compression with error
    feedback, and ``LMBatches``."""
    dev = resolve_device(device)
    model = init_transformer(cfg, torch.Generator(device=dev).manual_seed(0), dev)
    oc = OptimizerConfig(learning_rate=1e-3, warmup_steps=20, total_steps=steps)
    cc = CompressionConfig(kind="int8")
    pipe = LMBatches(vocab=cfg.vocab, batch=batch, seq_len=seq_len)
    step_fn = make_train_step(lambda m, b: lm_loss(m, b["tokens"]), oc, cc)
    state = init_train_state(model, oc, cc, device=dev)

    def batch_fn(step: int) -> dict:
        return {"tokens": torch.from_numpy(pipe.make(step)["tokens"]).to(dev)}

    return state, step_fn, batch_fn


def train(cfg: TransformerConfig, steps: int, device, ckpt_every: int = 50,
          fail_at: tuple | None = None, ckpt_dir: str | None = None, **batch_kw):
    """Run the fault-tolerant loop for ``steps`` (a fault at ``steps // 2``
    unless ``fail_at`` says otherwise); (state, metrics log, restarts)."""
    state, step_fn, batch_fn = setup(cfg, steps, device, **batch_kw)
    fail_at = (steps // 2,) if fail_at is None else fail_at
    with tempfile.TemporaryDirectory() as td:
        loop = FaultTolerantLoop(step_fn=step_fn, batch_fn=batch_fn, ckpt_dir=ckpt_dir or td,
                                 ckpt_every=ckpt_every,
                                 injector=FaultInjector(fail_at_steps=fail_at))
        return loop.run(state, steps)


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser()
    ap.add_argument("--steps", type=int, default=200)
    ap.add_argument("--wide", action="store_true")
    ap.add_argument("--device", default=None, help="cuda (default) or cpu")
    args = ap.parse_args(argv)

    cfg = lm_config(args.wide)
    n = sum(p.numel() for p in Transformer(cfg, torch.device("meta")).parameters())
    print(f"model: {n/1e6:.1f}M params ({'dense' if cfg.moe is None else 'MoE sorted-dispatch'})")
    state, log, restarts = train(cfg, args.steps, args.device)
    first = np.mean([m["loss"] for m in log[:10]])
    last = np.mean([m["loss"] for m in log[-10:]])
    print(f"steps={args.steps} restarts={restarts} (int8-compressed grads + EF)")
    print(f"loss: {first:.4f} -> {last:.4f}  ({'improved' if last < first else 'NO IMPROVEMENT'})")
    if not last < first:
        raise SystemExit("training did not reduce the loss")
    return {"log": log, "restarts": restarts}


if __name__ == "__main__":
    main()
