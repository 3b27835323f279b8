"""End-to-end GNN training on the PyTorch/CUDA port: GraphSAGE on a
synthetic reddit-like power-law graph with real neighbour sampling,
fault-tolerant loop with async checkpointing, a few hundred steps (twin of
``examples/train_gnn.py``).  Runs on the card unless given ``--device
cpu``; the graph, features, labels and samples are the reference's
(host NumPy draws from the same seeds), the weights come from a seeded
``torch.Generator`` on the device.

    PYTHONPATH=src python examples/torch_train_gnn.py [--steps 300] [--device cpu]
"""

import argparse
import sys
import tempfile
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parents[1] / "src"))

import numpy as np
import torch
import torch.nn.functional as F

from repro_torch.data.pipeline import GraphBatches
from repro_torch.graph.generators import rmat_graph
from repro_torch.graph.sampler import sample_neighbors
from repro_torch.kernels.runtime import resolve_device
from repro_torch.models.gnn import GNNConfig, graphsage_minibatch_forward, init_gnn
from repro_torch.train.fault_tolerance import FaultInjector, FaultTolerantLoop
from repro_torch.train.optimizer import OptimizerConfig
from repro_torch.train.train_step import init_train_state, make_train_step


def setup(n_nodes: int, n_edges: int, steps: int, device, batch_nodes: int = 512,
          d_feat: int = 64, n_classes: int = 16):
    """(state, step_fn, batch_fn) of GraphSAGE on an RMAT graph with planted
    labels (class = argmax of the features' projection)."""
    dev = resolve_device(device)
    g = rmat_graph(n_nodes, n_edges, seed=0)
    rng = np.random.default_rng(0)
    feats_np = rng.standard_normal((n_nodes, d_feat)).astype(np.float32)
    proj = rng.standard_normal((d_feat, n_classes))
    labels = torch.from_numpy(np.argmax(feats_np @ proj, axis=1)).to(dev)
    feats = torch.from_numpy(feats_np).to(dev)

    cfg = GNNConfig(name="sage", arch="graphsage", n_layers=2, d_hidden=128,
                    d_in=d_feat, d_out=n_classes, sample_sizes=(15, 10))
    model = init_gnn(cfg, torch.Generator(device=dev).manual_seed(0), dev)
    oc = OptimizerConfig(learning_rate=3e-3, warmup_steps=20, total_steps=steps)
    fan = cfg.sample_sizes

    def loss_fn(m, batch):
        lf = [feats[batch[f"hop{k}"]] for k in range(len(fan) + 1)]
        logits = graphsage_minibatch_forward(m, lf, cfg)
        logp = F.log_softmax(logits.float(), dim=-1)
        return -logp.gather(-1, batch["y"][:, None]).mean()

    pipe = GraphBatches(n_nodes=n_nodes, batch_nodes=batch_nodes, n_classes=n_classes)

    def batch_fn(step: int) -> dict:
        seeds = pipe.make(step)["seeds"]
        hops = sample_neighbors(g, seeds, fan, seed=step)
        batch = {f"hop{k}": torch.from_numpy(h).to(dev) for k, h in enumerate(hops)}
        batch["y"] = labels[batch["hop0"]]
        return batch

    return init_train_state(model, oc, device=dev), make_train_step(loss_fn, oc), batch_fn


def train(n_nodes: int, n_edges: int, steps: int, device, ckpt_every: int = 50,
          fail_at: tuple | None = None, **kw):
    """The fault-tolerant loop for ``steps`` (a fault at ``steps // 2``
    unless ``fail_at`` says otherwise); (state, metrics log, restarts)."""
    state, step_fn, batch_fn = setup(n_nodes, n_edges, steps, device, **kw)
    fail_at = (steps // 2,) if fail_at is None else fail_at
    with tempfile.TemporaryDirectory() as td:
        loop = FaultTolerantLoop(step_fn=step_fn, batch_fn=batch_fn, ckpt_dir=td,
                                 ckpt_every=ckpt_every,
                                 injector=FaultInjector(fail_at_steps=fail_at))
        return loop.run(state, steps)


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser()
    ap.add_argument("--steps", type=int, default=300)
    ap.add_argument("--nodes", type=int, default=50_000)
    ap.add_argument("--edges", type=int, default=1_000_000)
    ap.add_argument("--device", default=None, help="cuda (default) or cpu")
    args = ap.parse_args(argv)

    state, log, restarts = train(args.nodes, args.edges, args.steps, args.device)
    first = np.mean([m["loss"] for m in log[:20]])
    last = np.mean([m["loss"] for m in log[-20:]])
    print(f"steps={args.steps} restarts={restarts} (injected fault survived)")
    print(f"loss: {first:.4f} -> {last:.4f}  ({'improved' if last < first else 'NO IMPROVEMENT'})")
    if not last < first:
        raise SystemExit("training did not reduce the loss")
    return {"log": log, "restarts": restarts}


if __name__ == "__main__":
    main()
