"""Quickstart on the PyTorch/CUDA port: the paper's workload end to end
(twin of ``examples/quickstart.py``).

Generates an RMAT graph, hub-sorts it, and runs SSSP + Δ-PageRank through
the full HyTM pipeline (cost-aware engine selection + contribution-driven
scheduling), printing the per-iteration engine mix — the Fig. 7
"execution path" — and validating against the numpy references.  Runs on
the card unless given ``--device cpu``.

    PYTHONPATH=src python examples/torch_quickstart.py [--device cpu]
"""

import argparse
import dataclasses
import sys
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parents[1] / "src"))

import numpy as np

from repro_torch.core.constants import PCIE3
from repro_torch.core.cost_model import ENGINE_NAMES
from repro_torch.core.hytm import HyTMConfig, run_hytm
from repro_torch.graph.algorithms import PAGERANK, SSSP, reference_pagerank, reference_sssp
from repro_torch.graph.generators import rmat_graph
from repro_torch.graph.hub_sort import hub_sort
from repro_torch.kernels.runtime import resolve_device


def quickstart_config() -> HyTMConfig:
    return HyTMConfig(link=PCIE3.with_(mr=4.0), n_partitions=64, cds_mode="hub")


def run_sssp(g, hs, cfg: HyTMConfig, device):
    """SSSP from the top hub (old vertex 0); (result, correct, reference)."""
    res = run_hytm(hs.graph, SSSP, source=int(hs.perm[0]), config=cfg, n_hubs=hs.n_hubs,
                   device=device)
    ref = reference_sssp(g, 0)
    return res, bool(np.allclose(hs.values_to_old(res.values), ref)), ref


def run_pagerank(g, hs, cfg: HyTMConfig, device):
    """Δ-PageRank with Δ-driven scheduling; (result, max error)."""
    prog = dataclasses.replace(PAGERANK, tolerance=1e-5)
    res = run_hytm(hs.graph, prog, source=None, config=dataclasses.replace(cfg, cds_mode="delta"),
                   n_hubs=hs.n_hubs, device=device)
    err = float(np.max(np.abs(hs.values_to_old(res.values + res.delta) - reference_pagerank(g))))
    return res, err


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser()
    ap.add_argument("--device", default=None, help="cuda (default) or cpu")
    ap.add_argument("--nodes", type=int, default=50_000)
    ap.add_argument("--edges", type=int, default=800_000)
    args = ap.parse_args(argv)
    dev = resolve_device(args.device)

    print("== HyTGraph quickstart ==")
    g = rmat_graph(args.nodes, args.edges, seed=0)
    print(f"graph: {g.n_nodes:,} vertices / {g.n_edges:,} edges (RMAT)")

    hs = hub_sort(g)
    print(f"hub-sorted: top {hs.n_hubs:,} vertices (8%) moved to CSR front")
    cfg = quickstart_config()

    # ---------------- SSSP
    res, ok, _ = run_sssp(g, hs, cfg, dev)
    print(f"\nSSSP: {res.iterations} iterations, correct={ok}")
    print(f"  modeled transfer: {res.total_transfer_bytes/2**20:.1f} MiB "
          f"({res.total_transfer_bytes/(g.n_edges*4):.2f}x edge bytes)")
    print(f"  modeled PCIe time: {res.modeled_seconds*1e3:.2f} ms | wall: {res.wall_seconds:.2f}s")
    _print_path(res)

    # ---------------- Δ-PageRank with Δ-driven scheduling
    pr, err = run_pagerank(g, hs, cfg, dev)
    print(f"\nPageRank: {pr.iterations} iterations, max err {err:.2e}")
    print(f"  modeled transfer: {pr.total_transfer_bytes/2**20:.1f} MiB")
    _print_path(pr)
    return {"sssp": res, "sssp_correct": ok, "pagerank": pr, "pagerank_err": err}


def _print_path(res, max_iters=10):
    print("  engine mix per iteration (paper Fig. 7):")
    eng = res.history["engines"]
    for i in range(min(max_iters, eng.shape[0])):
        row = eng[i]
        mix = {ENGINE_NAMES[e]: int((row == e).sum()) for e in (-1, 0, 1, 2)}
        print(f"    iter {i:2d}: " + "  ".join(f"{k}={v}" for k, v in mix.items()))
    if eng.shape[0] > max_iters:
        print(f"    ... ({eng.shape[0] - max_iters} more)")


if __name__ == "__main__":
    main()
