"""The control of ``correct``: the plain reference put in the program's
place and computed in bfloat16, the precision below the program's
float32, read by the cell's own comparison at the cell's own size.

    python3 hytbench/control.py --workload <cell> --seeds <n> [<n> ...] [--runs k]

For each seed it draws the cell's graph and requests as a run does, and
prints one JSON line: the number the cell compares, for the control,
against its limit.  The control has to fail the limit; ``PERF.md`` keeps
the readings each limit was set from.  The benchmark's own runs never run
this.  It needs a CUDA card.
"""

import argparse
import json
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
sys.path[:0] = [str(ROOT)]


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", type=int, nargs="+", required=True)
    ap.add_argument("--runs", type=int, default=3, help="SSSP sources a seed")
    args = ap.parse_args(argv)

    import torch

    from hytbench import harness
    from hytbench.reference import Arcs
    from hytbench.reference.pagerank import pagerank
    from hytbench.reference.sssp import sssp

    if not torch.cuda.is_available():
        print("control: needs a CUDA card", file=sys.stderr)
        return 2
    dev = torch.device("cuda", 0)
    spec = harness.load_spec()
    cell = harness.find(spec["workloads"], args.workload, "workload")
    cfg, traffic = harness.config_of(spec, cell), harness.traffic_of(cell["traffic"])
    for seed in args.seeds:
        t = time.monotonic()
        g = harness.draw_graph(cfg, traffic, seed % 2**63, dev)
        arcs = Arcs.of(g.indptr, g.indices, g.weights, dev)
        readings = []
        if traffic["algorithm"] == "sssp":
            requests = harness.Requests(traffic, g, seed % 2**63)
            for _ in range(args.runs):
                s = requests.next()
                want = sssp(arcs, s).cpu().numpy()
                got = sssp(arcs, s, dtype=torch.bfloat16).cpu().numpy()
                readings.append(harness.sssp_gap(got, want))
        else:
            want = pagerank(arcs, traffic["damping"]).cpu().numpy()
            got = pagerank(arcs, traffic["damping"], dtype=torch.bfloat16).cpu().numpy()
            readings.append(harness.pagerank_gap(got, want))
        print(json.dumps({"workload": args.workload, "seed": seed, "control": readings,
                          "limit": traffic["check"]["limit"], "name": traffic["check"]["name"],
                          "seconds": time.monotonic() - t}), flush=True)
        del arcs, g
        harness.release(dev)
    return 0


if __name__ == "__main__":
    sys.exit(main())
