#!/usr/bin/env python3
"""Where the time of the port's main path goes, on one NVIDIA GPU.

    python3 profile_port.py              # RMAT scale 22, the graph of chip_smoke.py
    python3 profile_port.py --scale 16   # a quick rehearsal
    python3 profile_port.py --dlrm       # dlrm-mlperf serving instead of the graph

For SSSP (K=8) and Δ-PageRank, each through the kernels and through the
plain engines (``use_kernels=False``):

1. turns: the wall seconds of whole runs in the order plain, kernels,
   kernels, plain, three rounds; the median, min and max of each path;
2. profile: one run under ``torch.profiler`` (Δ-PageRank: its first 10
   iterations, since the profiler's own post-processing grows with its
   events).  From that one run: the span from the first device event's
   start to the last one's end, the device-busy time (the union of the
   device events' intervals), busy over span, and the largest device and
   host entries;
3. syncs: the host syncs of one run, counted by the port's source line
   that issued them (PyTorch's CUDA sync debug mode);
4. host cost: the host time to issue one relax of each engine on the main
   path's first block (30% of its lanes active, SSSP), through the kernels
   and through the plain engines, and one call of each kernel wrapper.

With ``--dlrm`` it builds dlrm-mlperf as ``chip_smoke.py`` does (full
width, 25M rows a table) and, for serve_p99 and serve_bulk, takes the legs
kernel, plain and all_gather of ``chip_smoke.DLRM_LEGS``: turns of
``serve_dlrm`` (5 timed batches each) in the order plain, kernel,
all_gather, all_gather, kernel, plain, three rounds; then one forward of
each leg under the profiler (span, busy share, the largest device and host
entries) and its host syncs by source line.

A diagnostic: it checks nothing that ``chip_smoke.py`` does not check.
The last line is one JSON object of the turns and profile numbers.
"""

from __future__ import annotations

import argparse
import collections
import dataclasses
import json
import sys
import time
import traceback
import warnings

import numpy as np

import chip_smoke as smoke
from chip_smoke import log

ROUNDS = 3  # rounds of (plain, kernels, kernels, plain) runs


def device_busy(prof) -> tuple[float, float]:
    """(span, busy) in seconds over the device events of one profiled run:
    span from the first event's start to the last one's end, busy the
    length of the union of their intervals."""
    from torch.autograd import DeviceType

    ivs = sorted((e.time_range.start, e.time_range.end)
                 for e in prof.events() if e.device_type == DeviceType.CUDA)
    if not ivs:
        return 0.0, 0.0
    busy, (lo, hi) = 0.0, ivs[0]
    for s, e in ivs[1:]:
        if s > hi:
            busy += hi - lo
            lo, hi = s, e
        else:
            hi = max(hi, e)
    busy += hi - lo
    span = max(e for _, e in ivs) - ivs[0][0]
    return span / 1e6, busy / 1e6


def profile_run(torch, fn, top: int = 6) -> dict:
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t = time.monotonic()
        fn()
        torch.cuda.synchronize()
        wall = time.monotonic() - t
    span, busy = device_busy(prof)
    events = prof.key_averages()
    device = sorted((e for e in events if e.device_type == DeviceType.CUDA),
                    key=lambda e: -e.self_device_time_total)[:top]
    host = sorted((e for e in events if e.device_type == DeviceType.CPU),
                  key=lambda e: -e.self_cpu_time_total)[:top]
    return dict(
        wall_s=wall, span_s=span, busy_s=busy, busy_share=busy / span if span else None,
        top_device=[(e.key[:60], e.count, e.self_device_time_total / 1e3) for e in device],
        top_host=[(e.key[:60], e.count, e.self_cpu_time_total / 1e3) for e in host])


def sync_sites(torch, fn) -> dict:
    """Run ``fn`` with PyTorch's CUDA sync debugging on: the count of
    synchronizing calls by the port's source line that issued them."""
    sites = collections.Counter()

    def record(message, category, filename, lineno, file=None, line=None):
        frames = [f for f in traceback.extract_stack() if "repro_torch" in f.filename]
        where = (f"{frames[-1].filename.split('src/')[-1]}:{frames[-1].lineno}"
                 if frames else f"{filename}:{lineno}")
        sites[where] += 1

    # catch_warnings puts warnings.showwarning back on exit
    with warnings.catch_warnings():
        warnings.simplefilter("always")
        warnings.showwarning = record
        torch.cuda.set_sync_debug_mode("warn")
        try:
            fn()
        finally:
            torch.cuda.set_sync_debug_mode("default")
    return dict(sites.most_common())


def host_us(torch, fn, calls: int = 50, reps: int = 5) -> float:
    """Host time to issue one call of ``fn``, in µs: the median over
    ``reps`` of ``calls`` calls issued back to back with no sync (the
    device's queue holds their launches), divided by ``calls``."""
    fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(reps):
        t = time.perf_counter()
        for _ in range(calls):
            fn()
        times.append((time.perf_counter() - t) / calls * 1e6)
        torch.cuda.synchronize()
    return float(np.median(times))


def host_costs(torch, rt) -> dict:
    from repro_torch.core.engines import EdgeBlock, relax_with_engine
    from repro_torch.graph.algorithms import SSSP
    from repro_torch.kernels.frontier_compact.ops import frontier_compact
    from repro_torch.kernels.hyb_gather.ops import PAD, hyb_gather
    from repro_torch.kernels.segment_spmm.ops import segment_spmm

    n, B, dev = rt.csr.n_nodes, rt.parts.block_size, rt.device
    gen = torch.Generator(device=dev)
    gen.manual_seed(smoke.SEED)
    src = rt.csr.edge_src[:B]
    block = EdgeBlock(src=src, dst=rt.csr.edge_dst[:B], weight=rt.csr.edge_weight[:B],
                      active=torch.rand(B, device=dev, generator=gen) < 0.3)
    operand = torch.rand(n, device=dev, generator=gen)
    out = {}
    for eng, name in enumerate(("filter", "compact", "zerocopy")):
        for kern in (True, False):
            key = f"{name}_{'kernels' if kern else 'plain'}"
            out[key] = host_us(torch, lambda: relax_with_engine(
                eng, block, operand, n, SSSP, kern))
    msg = torch.where(block.active, operand[src.long()], float("inf"))
    starts = torch.arange(0, -(-B // PAD) * PAD, PAD, dtype=torch.int32, device=dev)
    degs = torch.clamp(B - starts, max=PAD)
    out["wrapper_segment_spmm"] = host_us(
        torch, lambda: segment_spmm(msg, block.dst, n, combine="min"))
    out["wrapper_frontier_compact"] = host_us(
        torch, lambda: frontier_compact(block, block.active))
    out["wrapper_hyb_gather"] = host_us(torch, lambda: hyb_gather(block, starts, degs))
    out["torch_add"] = host_us(torch, lambda: msg + 1.0)
    return out


def log_profile(name: str, p: dict) -> None:
    log(f"profile {name}: wall {p['wall_s']:.4f} s under the profiler; device events "
        f"span {p['span_s']:.4f} s, busy {p['busy_s']:.4f} s = "
        f"{100 * p['busy_share']:.1f}% of the span")
    for key, count, ms in p["top_device"]:
        log(f"    device {ms:9.3f} ms  {count:6d}x  {key}")
    for key, count, ms in p["top_host"]:
        log(f"    host   {ms:9.3f} ms  {count:6d}x  {key}")


def dlrm_main(torch, smi: str) -> dict:
    sys.path.insert(0, str(smoke.ROOT / "src"))
    from repro_torch.configs.dlrm_mlperf import CELLS
    from repro_torch.kernels.runtime import build_kernels
    from repro_torch.launch.serve import dlrm_serve_config, dlrm_traffic, serve_dlrm
    from repro_torch.models.dlrm import dlrm_forward, init_dlrm

    torch.backends.cuda.matmul.allow_tf32 = False   # as chip_smoke.setup states it
    build_kernels()
    cfg = dlrm_serve_config(reduced=False)
    gen = torch.Generator(device="cuda")
    gen.manual_seed(smoke.SEED)
    model = init_dlrm(cfg, gen, "cuda")
    torch.cuda.synchronize()
    log(f"dlrm-mlperf: {sum(cfg.vocab_sizes):,} table rows on the card")
    out = {"card": smi}
    legs = {leg: smoke.DLRM_LEGS[leg] for leg in ("kernel", "plain", "all_gather")}
    for cell in ("serve_p99", "serve_bulk"):
        ms = {leg: [] for leg in legs}
        for r in range(ROUNDS):
            for leg in ("plain", "kernel", "all_gather", "all_gather", "kernel", "plain"):
                use, engine, _ = legs[leg]
                ms[leg].append(serve_dlrm(model, cell, 5, use, cfg.replace(table_engine=engine),
                                          seed=smoke.SEED + 10 + r)["ms_per_batch"])
        for leg, w in ms.items():
            out[f"turns_{cell}_{leg}"] = dict(median_ms=float(np.median(w)), min_ms=min(w),
                                              max_ms=max(w), runs=len(w))
            log(f"turns {cell} {leg}: median {np.median(w):.3f} ms/batch (min {min(w):.3f}, "
                f"max {max(w):.3f}) over {len(w)} runs of 5 batches [{smi}]")
        traffic = dlrm_traffic(cfg, CELLS[cell]["batch"], gen)
        for leg, (use, engine, _) in legs.items():
            c = cfg.replace(table_engine=engine)

            def forward():
                return dlrm_forward(model, *traffic, c, use)

            forward()
            torch.cuda.synchronize()
            p = profile_run(torch, forward, top=10)
            if not p["busy_s"]:
                log(f"profile {cell} {leg}: device time not measured (no device events)")
                continue
            log_profile(f"{cell} {leg}", p)
            sites = sync_sites(torch, forward)
            log(f"syncs {cell} {leg}: {sum(sites.values())} host syncs a forward: {sites}")
            out[f"profile_{cell}_{leg}"] = {k: p[k] for k in ("wall_s", "span_s", "busy_s",
                                                              "busy_share", "top_device")}
    return out


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--scale", type=int, default=22,
                    help="RMAT scale: 2**scale vertices, 16 * 2**scale edges")
    ap.add_argument("--dlrm", action="store_true",
                    help="profile dlrm-mlperf serving instead of the graph path")
    args = ap.parse_args()

    import torch

    if not torch.cuda.is_available():
        print("profile_port: no CUDA device", file=sys.stderr)
        return 1
    smi = smoke.card_line()
    log(f"card: {smi}; torch {torch.__version__}, CUDA {torch.version.cuda}")
    if args.dlrm:
        print(json.dumps(dlrm_main(torch, smi)))
        return 0
    cfg, _, source, rt = smoke.setup(torch, args.scale)
    from repro_torch.core.hytm import run_hytm

    legs = smoke.main_path_legs(cfg, source)
    pairs = {"sssp": ("sssp_k8", "sssp_plain"), "pagerank": ("pagerank", "pagerank_plain")}
    out = {"card": smi, "scale": args.scale}
    for name, (kern, plain) in pairs.items():
        walls = {"kernels": [], "plain": []}
        for _ in range(ROUNDS):
            for which in ("plain", "kernels", "kernels", "plain"):
                prog, src, c = legs[kern if which == "kernels" else plain]
                walls[which].append(run_hytm(None, prog, src, c, runtime=rt).wall_seconds)
        for which, w in walls.items():
            out[f"turns_{name}_{which}"] = dict(median_s=float(np.median(w)), min_s=min(w),
                                                max_s=max(w), runs=len(w))
            log(f"turns {name} {which}: median {np.median(w):.4f} s (min {min(w):.4f}, "
                f"max {max(w):.4f}) over {len(w)} runs")

    for leg in ("sssp_k8", "sssp_plain", "pagerank", "pagerank_plain"):
        prog, src, c = legs[leg]
        if leg.startswith("pagerank"):
            leg, c = f"{leg}[:10]", dataclasses.replace(c, max_iters=10)
        p = profile_run(torch, lambda: run_hytm(None, prog, src, c, runtime=rt))
        if not p["busy_s"]:
            log(f"profile {leg}: device time not measured (no device events recorded)")
            continue
        log_profile(leg, p)
        sites = sync_sites(torch, lambda: run_hytm(None, prog, src, c, runtime=rt))
        log(f"syncs {leg}: {sum(sites.values())} host syncs: {sites}")
        out[f"profile_{leg}"] = {k: p[k] for k in ("wall_s", "span_s", "busy_s", "busy_share")}
    host = host_costs(torch, rt)
    log("host µs to issue one call (SSSP relax on the first block, 30% active): "
        + ", ".join(f"{k} {v:.1f}" for k, v in host.items()))
    out["host_us"] = host
    print(json.dumps(out))
    return 0


if __name__ == "__main__":
    sys.exit(main())
