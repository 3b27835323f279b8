"""Run one cell of the benchmark once and print its result line.

    python3 hytbench/run.py --workload <cell> --seed <n> --seconds <s> --trace <0|1>

The cells, their configurations, traffic mixes and metrics are named in
``BENCHMARK.json`` at the root of the checkout.  The last line of standard
output is the result as one JSON object; progress goes to standard error,
whose last lines are each compared number beside its limit.  Exits with a
non-zero code, and prints no result, without a CUDA card (there is no CPU
fallback: the CPU rehearsal lives in ``hytbench/tests``), or when JAX or
the JAX package was loaded.  The program's kernels build once into the
checkout's ``build/`` and load from there on later runs.
"""

import time

T0 = time.monotonic()

import argparse  # noqa: E402
import json  # noqa: E402
import math  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

ROOT = Path(__file__).resolve().parents[1]
sys.path[:0] = [str(ROOT), str(ROOT / "src")]


def finite(x):
    """``x`` with non-finite floats as strings, so the line stays JSON."""
    if isinstance(x, float) and not math.isfinite(x):
        return str(x)
    if isinstance(x, dict):
        return {k: finite(v) for k, v in x.items()}
    if isinstance(x, list):
        return [finite(v) for v in x]
    return x


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)

    import torch

    from hytbench import harness

    spec = harness.load_spec()
    cell = harness.find(spec["workloads"], args.workload, "workload")
    if not torch.cuda.is_available() or torch.cuda.device_count() < cell["chips"]:
        print(f"hytbench: {args.workload} needs {cell['chips']} CUDA card(s); "
              f"found {torch.cuda.device_count() if torch.cuda.is_available() else 0}",
              file=sys.stderr)
        return 2
    result = harness.run_cell(spec, cell, args.seed, args.seconds, bool(args.trace),
                              torch.device("cuda", 0), t_start=T0)
    found = harness.forbidden_modules()
    if found:
        print(f"hytbench: the process loaded {', '.join(found)}", file=sys.stderr)
        return 3
    for name, c in result["checks"].items():
        print(f"check {name}: {c['value']!r} (limit {c['limit']!r})", file=sys.stderr)
    print(json.dumps(finite(result)), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
