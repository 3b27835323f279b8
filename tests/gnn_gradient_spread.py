"""How far float32 gradients of ``gnn_loss`` lie from float64, for the port
and for the reference, on ``chip_smoke.py`` phase 18 leg (d)'s cells (the
measurement behind that leg's per-arch tolerances).

    PYTHONPATH=src python tests/gnn_gradient_spread.py

For PNA and MeshGraphNet at full width and depth on ``full_graph_sm`` and
``molecule``, three draws each (weights and inputs from a seeded
``torch.Generator`` on the CPU, as the leg draws them), it prints the
worst leaf's max |float32 - float64| over that leaf's largest |float64|
gradient: the port's (its float64 copy as the truth) and the reference's
(jax with 64-bit floats enabled, on the same weights and inputs).  Runs on
the CPU in a few minutes.
"""

import copy
import dataclasses
import sys
from pathlib import Path

import jax

jax.config.update("jax_enable_x64", True)

import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402
import torch  # noqa: E402

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))

import chip_smoke  # noqa: E402
from repro.models import gnn as jax_gnn  # noqa: E402
from repro_torch.configs import get_arch  # noqa: E402
from repro_torch.configs.common import gnn_cells  # noqa: E402
from repro_torch.graph.generators import batched_molecule_graphs, rmat_graph  # noqa: E402
from repro_torch.models.gnn import gnn_loss, init_gnn  # noqa: E402


def _tree(node):
    """The reference's parameter tree of a port module (numpy arrays)."""
    if isinstance(node, (torch.nn.ParameterList, torch.nn.ModuleList)):
        return [_tree(x) for x in node]
    if isinstance(node, torch.Tensor):
        return node.detach().numpy()
    names = [k for k, _ in node.named_children()]
    names += [k for k, _ in node.named_parameters(recurse=False)]
    return {k: _tree(getattr(node, k)) for k in names}


def _worst(pairs) -> float:
    return max(float(np.abs(np.asarray(a, np.float64) - np.asarray(b)).max()
                     / np.abs(np.asarray(b)).max()) for a, b in pairs)


def main() -> None:
    for name in ("pna", "meshgraphnet"):
        cells = gnn_cells(get_arch(name))
        for cell_name in ("full_graph_sm", "molecule"):
            cell = cells[cell_name]
            if cell_name == "molecule":
                g = batched_molecule_graphs(cell["n_graphs"], 30, 128, seed=0)
                extra = {"graph_ids": torch.arange(cell["n_graphs"]).repeat_interleave(30),
                         "n_graphs": cell["n_graphs"]}
            else:
                g = rmat_graph(cell["n_nodes"], cell["n_edges"], seed=0)
                extra = {}
            src, dst = torch.from_numpy(g.edge_sources()), torch.from_numpy(g.indices)
            jcfg = jax_gnn.GNNConfig(**dataclasses.asdict(cell["cfg"]))
            for seed in range(3):
                gen = torch.Generator().manual_seed(seed)
                model = init_gnn(cell["cfg"], gen, "cpu")
                inp = chip_smoke.gnn_inputs(torch, cell["cfg"], g.n_nodes, g.n_edges, gen, extra)
                kw = {k: extra[k] for k in ("graph_ids", "n_graphs") if k in extra}
                grads = {}
                for dt in (torch.float32, torch.float64):
                    m = copy.deepcopy(model).to(dt)
                    for p in m.parameters():
                        p.requires_grad_(True)
                    gnn_loss(m, None, inp["feats"].to(dt), src, dst, inp["labels"],
                             edge_feats=inp["edge_feats"].to(dt), **kw).backward()
                    grads[dt] = {n: p.grad for n, p in m.named_parameters()}
                port = _worst((grads[torch.float32][n], grads[torch.float64][n].numpy())
                              for n in grads[torch.float64])
                tree = _tree(model)
                jkw = {"graph_ids": jnp.asarray(extra["graph_ids"].numpy()),
                       "n_graphs": extra["n_graphs"]} if extra else {}

                def loss(p, dt):
                    p = jax.tree.map(lambda a: jnp.asarray(a, dt), p)
                    return jax_gnn.gnn_loss(
                        p, jcfg, jnp.asarray(inp["feats"].numpy(), dt), jnp.asarray(src.numpy()),
                        jnp.asarray(dst.numpy()), jnp.asarray(inp["labels"].numpy()),
                        edge_feats=jnp.asarray(inp["edge_feats"].numpy(), dt), **jkw)

                r32 = jax.grad(lambda p: loss(p, jnp.float32))(tree)
                r64 = jax.grad(lambda p: loss(p, jnp.float64))(tree)
                ref = _worst(zip(jax.tree.leaves(r32), jax.tree.leaves(r64)))
                print(f"{name} {cell_name} draw {seed}: float32 against float64, the worst "
                      f"leaf: port {port:.3e}, reference {ref:.3e}")


if __name__ == "__main__":
    main()
