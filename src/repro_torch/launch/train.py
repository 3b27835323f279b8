"""Training launcher: ``--arch <id>`` selects an LM architecture, reduced
as the reference's launcher reduces it (``configs.common.reduce_lm_config``),
and runs the fault-tolerant training loop on one device (port of
``repro.launch.train``).

    PYTHONPATH=src python -m repro_torch.launch.train --arch internlm2-1.8b --steps 50
    PYTHONPATH=src python -m repro_torch.launch.train --arch internlm2-1.8b --device cpu

It runs on the card unless given ``--device cpu`` (and raises without
one).  Weights come from a seeded ``torch.Generator`` on the device, the
batches from ``data.pipeline.LMBatches``; checkpoints go to ``--ckpt-dir``
or a temporary directory.  Non-LM archs are refused, as the reference
refuses them.
"""

from __future__ import annotations

import argparse
import tempfile

import torch

from repro_torch.configs import get_arch
from repro_torch.configs.common import reduce_lm_config
from repro_torch.data.pipeline import LMBatches
from repro_torch.kernels.runtime import resolve_device
from repro_torch.models.dlrm import DLRMConfig
from repro_torch.models.gnn import GNNConfig
from repro_torch.models.transformer import TransformerConfig, init_transformer, lm_loss
from repro_torch.train.fault_tolerance import FaultTolerantLoop
from repro_torch.train.optimizer import OptimizerConfig
from repro_torch.train.train_step import init_train_state, make_train_step


def _family(cfg) -> str:
    if isinstance(cfg, TransformerConfig):
        return "lm"
    if isinstance(cfg, GNNConfig):
        return "gnn"
    if isinstance(cfg, DLRMConfig):
        return "recsys"
    return "graph"


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", required=True)
    ap.add_argument("--steps", type=int, default=50)
    ap.add_argument("--batch", type=int, default=4)
    ap.add_argument("--seq", type=int, default=128)
    ap.add_argument("--ckpt-dir", default=None)
    ap.add_argument("--device", default=None, help="cuda (default) or cpu")
    args = ap.parse_args(argv)

    arch = get_arch(args.arch).model_config
    family = _family(arch)
    if family != "lm":
        raise SystemExit(
            f"{args.arch} is a {family} arch; use examples/torch_train_gnn.py "
            "or examples/ for non-LM training drivers.")
    dev = resolve_device(args.device)
    # reduced config of the same family (full configs are mesh-scale)
    cfg = reduce_lm_config(arch)
    print(f"arch={args.arch} (reduced: {cfg.n_layers}L d={cfg.d_model} "
          f"moe={'yes' if cfg.moe else 'no'} attn={cfg.attention})")

    oc = OptimizerConfig(learning_rate=1e-3, warmup_steps=10, total_steps=args.steps)
    gen = torch.Generator(device=dev).manual_seed(0)
    model = init_transformer(cfg, gen, dev)
    state = init_train_state(model, oc, device=dev)
    pipe = LMBatches(vocab=cfg.vocab, batch=args.batch, seq_len=args.seq)
    step = make_train_step(lambda m, b: lm_loss(m, b["tokens"]), oc)

    def batch_fn(s: int) -> dict:
        return {"tokens": torch.from_numpy(pipe.make(s)["tokens"]).to(dev)}

    ckpt = args.ckpt_dir or tempfile.mkdtemp(prefix="repro-torch-ckpt-")
    loop = FaultTolerantLoop(step_fn=step, batch_fn=batch_fn, ckpt_dir=ckpt,
                             ckpt_every=max(args.steps // 4, 1))
    state, log, _ = loop.run(state, args.steps)
    print(f"loss {log[0]['loss']:.4f} -> {log[-1]['loss']:.4f} (checkpoints in {ckpt})")
    return {"log": log, "ckpt_dir": ckpt}


if __name__ == "__main__":
    main()
