#!/usr/bin/env python3
"""Where the time of the port's main path goes, on one NVIDIA GPU.

    python3 profile_port.py              # RMAT scale 22, the graph of chip_smoke.py
    python3 profile_port.py --scale 16   # a quick rehearsal
    python3 profile_port.py --dlrm       # dlrm-mlperf serving instead of the graph
    python3 profile_port.py --against parent=DIR   # this tree against another, in turns
    python3 profile_port.py --mesh       # the sharded sweep over every card, both layouts
    python3 profile_port.py --mesh --lm-only   # kimi-k2 (2 layers) over every card alone
    python3 profile_port.py --train      # internlm2-1.8b's train step, as chip_smoke.py leg (a)
    python3 profile_port.py --train-mesh # that step at 4096 positions on (2, 2) and (1, 4) meshes
    python3 profile_port.py --train-mesh --moe  # deepseek-v2-lite's on (4, 1) and (2, 2)

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

With ``--against NAME=DIR`` (repeatable; DIR is another checkout of the
repo, for example the parent commit unpacked with ``git archive``) it
compares trees in turns on one card.  Each tree runs in a worker process of
its own, with its own ``repro_torch`` and kernels; the first worker (this
tree) builds the graph and writes it under ``build/``, the others read it.
In the order of the trees and then back (this tree, A, B, B, A, this tree),
``AB_ROUNDS`` times, each worker: times ``segment_spmm`` min and sum and
``frontier_compact`` on partition 0's and the last partition's blocks
(warm and cold device ms, host µs a call, as ``chip_smoke.py`` times them),
issues one call of each kernel wrapper (host µs), and runs Δ-PageRank and
SSSP (K=8), each through the kernels and plain (wall seconds).  When
every tree has ``repro_torch.stream``, each worker also builds a
``DeltaCSR`` of the graph (blocks 1.5x the main path's, as
``chip_smoke.py`` phase 10) and runs cold SSSP (K=8) and Δ-PageRank over it
through the kernels in the same turns, then one profiled SSSP run over it
(device busy, the largest device entries).

With ``--train`` it builds internlm2-1.8b as ``chip_smoke.py`` phase 18 leg
(a) trains it (full width and depth, float32 parameters, bf16
activations, remat, AdamW, 2 microbatches of 2 x 1024 tokens), takes two
warm steps, then one step under the profiler (span, busy share, the
largest device and host entries), ``apply_updates`` alone under the
profiler on that step's gradients, and a step's host syncs by source line.

With ``--mesh`` (two or more cards) it runs the sharded sweep with one
rank a card over NCCL (``launch.mesh.RankPool``: this process rank 0 on
card 0), the graph handed to the other ranks as ``.npy`` files, in both
vertex layouts: SSSP (K=8) and Δ-PageRank, each once instrumented as
``chip_smoke.py`` phase 14 instruments a leg (the collectives' device ms
an iteration by CUDA events, the peak allocated device memory), then
``MESH_ROUNDS`` rounds of (single-device sync on rank 0, replicated,
owner) in turns.  It holds SSSP bit-equal to the single-device sync run
and Δ-PageRank within phase 4's bound in both layouts, and every rank's
result equal.  Then (alone with ``--lm-only``) kimi-k2-1t-a32b at full
width cut to ``chip_smoke.KIMI_LAYERS`` layers over the same cards,
expert-parallel (mesh (cards, 1), E/cards experts a card, one of the 4 x
2048 prompts a card): every rank draws the whole model from the seed,
serves its own request on its card alone (``generate`` without a mesh:
the capacity of one request's tokens), keeps its experts and frees the
rest, then runs ``generate(mesh=)``; each rank's prefill logits and tokens
must equal its one-card run's (bit for bit, or the logits within
``chip_smoke.MOE_LAYER_TOL``).  It prints the exchanges' MB and device ms
by kind (NVLink), prefill seconds, decode ms a step and each rank's peak.

With ``--train-mesh`` (four cards) it trains internlm2-1.8b as
``chip_smoke.py`` phase 19 leg (b) does (full width and depth, float32
parameters, bf16 activations, remat, 2 microbatches; here 4 rows of 4096
positions a step) on the one card 0, then on (2, 2) and (1, 4) NCCL meshes
of DTensor placements (``dist.sharding``), one rank a card: 3 steps timed
and one more, on rank 0 under the profiler (device busy, the NCCL
kernels' device time and share of it), each rank's peak, every rank's
losses equal and within
``chip_smoke.TRAIN_MB_TOL`` relative of the single device's (bf16
activations sum in another order on a mesh).  With ``--moe`` it trains
deepseek-v2-lite-16b at full width cut to ``MOE_MESH_LAYERS`` layers
(float32, 4 rows of 1024 positions, the MoE chunked a row so that each row
routes with its own capacity on one card and on every mesh) on (4, 1)
(EP 4) and (2, 2) (EP 2, TP 2): the same numbers, the exchanges' device ms
by kind, every rank's losses within ``MOE_MESH_LOSS_TOL`` of one card's and
its first two grad norms within ``MOE_MESH_NORM_TOL``.

A diagnostic: it checks nothing that ``chip_smoke.py`` does not check.
The last line is one JSON object of the turns and profile numbers.
"""

from __future__ import annotations

import argparse
import collections
import contextlib
import dataclasses
import json
import subprocess
import sys
import time
import traceback
import warnings
from pathlib import Path

import numpy as np

import chip_smoke as smoke
from chip_smoke import log

ROUNDS = 3  # rounds of (plain, kernels, kernels, plain) runs
AB_ROUNDS = 2  # rounds of the trees in turns (--against)
AB_LEGS = ("pagerank", "pagerank_plain", "sssp_k8", "sssp_plain")
AB_STREAM_LEGS = ("stream_sssp_k8", "stream_pagerank")  # over a DeltaCSR
MESH_ROUNDS = 3  # rounds of (single-device sync, replicated, owner) runs (--mesh)


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
    nccl = sum(e.self_device_time_total for e in events
               if e.device_type == DeviceType.CUDA and "nccl" in e.key.lower())
    return dict(
        wall_s=wall, span_s=span, busy_s=busy, busy_share=busy / span if span else None,
        nccl_s=nccl / 1e6,
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


def host_costs(torch, rt) -> dict:
    from repro_torch.core.engines import EdgeBlock, relax_with_engine
    from repro_torch.graph.algorithms import SSSP
    from repro_torch.kernels.frontier_compact.ops import frontier_compact
    from repro_torch.kernels.hyb_gather.ops import PAD, hyb_gather
    from repro_torch.kernels.segment_spmm.ops import segment_spmm

    # partition 0's block: its own edges, as the sweep slices it
    n, B, dev = rt.csr.n_nodes, rt.parts.host[2][0], rt.device
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
            out[key] = smoke.host_us(torch, lambda: relax_with_engine(
                eng, block, operand, n, SSSP, kern))
    msg = torch.where(block.active, operand[src.long()], float("inf"))
    starts = torch.arange(0, -(-B // PAD) * PAD, PAD, dtype=torch.int32, device=dev)
    degs = torch.clamp(B - starts, max=PAD)
    out["wrapper_segment_spmm"] = smoke.host_us(
        torch, lambda: segment_spmm(msg, block.dst, n, combine="min"))
    out["wrapper_frontier_compact"] = smoke.host_us(
        torch, lambda: frontier_compact(block, block.active))
    out["wrapper_hyb_gather"] = smoke.host_us(torch, lambda: hyb_gather(block, starts, degs))
    out["torch_add"] = smoke.host_us(torch, lambda: msg + 1.0)
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


def block_rows(torch, rt) -> dict:
    """``segment_spmm`` min and sum and ``frontier_compact`` on partition 0's
    and the last partition's blocks (30% of the lanes active; ids and
    columns at the partition's offset from a 16-byte boundary, as the sweep
    passes them; the activity column fresh): warm and cold device ms and
    host µs a call."""
    from repro_torch.kernels.frontier_compact.ops import frontier_compact
    from repro_torch.kernels.segment_spmm.ops import segment_spmm

    dev, n, B = rt.device, rt.csr.n_nodes, rt.parts.block_size
    gen = torch.Generator(device=dev)
    gen.manual_seed(smoke.SEED)
    active_all = torch.rand(B, device=dev, generator=gen) < 0.3
    vals_all = torch.rand(B, device=dev, generator=gen) * 100.0 + 1.0
    _, edge_start, part_edges = rt.parts.host

    def spmm_min(msg, dst):
        return segment_spmm(msg, dst, n, combine="min")

    def spmm_sum(packed, dst):
        return segment_spmm(packed, dst, n)

    def compact(*cols):
        return frontier_compact(cols, cols[3])

    out = {}
    for part in (0, len(part_edges) - 1):
        # a block is the partition's own edges, as the sweep slices it
        start, m = edge_start[part], part_edges[part]
        act, vals = active_all[:m], vals_all[:m]
        csr = rt.csr
        cols = tuple(c[start:start + m] for c in (csr.edge_src, csr.edge_dst, csr.edge_weight))
        cols += (act,)
        msg = torch.where(act, vals, float("inf"))
        packed = torch.stack([torch.where(act, vals * 1e-5, 0.0), act.to(torch.float32)], -1)
        cases = {
            "segment_spmm_min": (spmm_min, lambda: (msg.clone(), smoke.offset_copy(torch, cols[1])),
                                 m * 8 + n * 4),
            "segment_spmm_sum": (spmm_sum,
                                 lambda: (packed.clone(), smoke.offset_copy(torch, cols[1])),
                                 m * 12 + n * 8),
            "frontier_compact": (compact,
                                 lambda: tuple(smoke.offset_copy(torch, c) for c in cols),
                                 2 * m * 13 + 4),
        }
        for name, (fn, make_args, set_bytes) in cases.items():
            args = make_args()
            out[f"{name}_part{part}"] = dict(
                warm_ms=smoke.graph_ms(torch, lambda: fn(*args)),
                cold_ms=smoke.cold_ms(torch, fn, make_args, set_bytes),
                host_us=smoke.host_us(torch, lambda: fn(*args)))
    return out


def ab_worker(args) -> int:
    """One tree of ``--against``: set up, reply ``@@ {}``, then answer one
    JSON request a line on stdin (``{"op": "rows" | "host" | "leg", ...}``)
    with one ``@@ <json>`` line, until stdin closes."""
    import torch

    cfg, hs, source, rt = smoke.setup(torch, args.scale, src=Path(args.worker),
                                      graph_file=Path(args.graph_file))
    from repro_torch.core.hytm import run_hytm

    legs = smoke.main_path_legs(cfg, source)
    dcsr = None
    print("@@ {}", flush=True)
    for line in sys.stdin:
        req = json.loads(line)
        if req["op"] == "rows":
            reply = block_rows(torch, rt)
        elif req["op"] == "host":
            reply = host_costs(torch, rt)
        elif req["op"] in ("stream", "stream_profile"):
            if dcsr is None:
                from repro_torch.stream import DeltaCSR

                dcsr = DeltaCSR(hs.graph, cfg, device=rt.device)
            prog, src, c = legs[req["leg"]]
            fn = lambda: run_hytm(None, prog, src, c, runtime=dcsr.runtime_for(prog))
            if req["op"] == "stream":
                reply = {"wall_s": fn().wall_seconds}
            else:
                p = profile_run(torch, fn, top=8)
                reply = {k: p[k] for k in ("wall_s", "span_s", "busy_s", "busy_share",
                                           "top_device", "top_host")}
        else:
            prog, src, c = legs[req["leg"]]
            reply = {"wall_s": run_hytm(None, prog, src, c, runtime=rt).wall_seconds}
        print("@@ " + json.dumps(reply), flush=True)
    return 0


def ab_main(args, smi: str) -> dict:
    """This tree against the ``--against`` trees in turns (module docstring)."""
    trees = {"change": smoke.ROOT, **{name: Path(d).resolve() for name, d in
                                       (a.split("=", 1) for a in args.against)}}
    graph_file = smoke.ROOT / "build" / "ab_graph" / f"rmat{args.scale}.pkl"
    graph_file.unlink(missing_ok=True)
    workers = {}

    def ask(name: str, req: dict | None) -> dict:
        w = workers[name]
        if req is not None:
            w.stdin.write(json.dumps(req) + "\n")
            w.stdin.flush()
        for line in w.stdout:
            if line.startswith("@@ "):
                return json.loads(line[3:])
            log(f"{name}: {line.rstrip()}")
        raise RuntimeError(f"worker {name} ended (rc {w.wait()})")

    try:
        for name, tree in trees.items():   # one at a time: the first writes the graph
            workers[name] = subprocess.Popen(
                [sys.executable, str(Path(__file__).resolve()), "--worker", str(tree / "src"),
                 "--scale", str(args.scale), "--graph-file", str(graph_file)],
                stdin=subprocess.PIPE, stdout=subprocess.PIPE, text=True)
            ask(name, None)
        order = list(trees) + list(trees)[::-1]
        rows = {name: [] for name in trees}
        host = {name: [] for name in trees}
        streams = all((t / "src" / "repro_torch" / "stream").is_dir() for t in trees.values())
        stream_legs = AB_STREAM_LEGS if streams else ()
        walls = {leg: {name: [] for name in trees} for leg in AB_LEGS + stream_legs}
        for _ in range(AB_ROUNDS):
            for name in order:
                rows[name].append(ask(name, {"op": "rows"}))
            for name in order:
                host[name].append(ask(name, {"op": "host"}))
            for leg in AB_LEGS + stream_legs:
                op, main_leg = (("stream", leg.removeprefix("stream_"))
                                if leg in stream_legs else ("leg", leg))
                for name in order:
                    walls[leg][name].append(ask(name, {"op": op, "leg": main_leg})["wall_s"])
        profiles = {name: ask(name, {"op": "stream_profile", "leg": "sssp_k8"})
                    for name in trees} if streams else {}
    finally:
        for w in workers.values():
            w.stdin.close()
            w.wait(timeout=120)
    out = {"card": smi, "scale": args.scale, "trees": {k: str(v) for k, v in trees.items()}}
    for name in trees:
        med = {key: {k: float(np.median([r[key][k] for r in rows[name]])) for k in rows[name][0][key]}
               for key in rows[name][0]}
        med_host = {k: float(np.median([h[k] for h in host[name]])) for k in host[name][0]}
        out[name] = {"rows": med, "host_us": med_host,
                     "legs": {leg: {"median_s": float(np.median(walls[leg][name])),
                                    "runs": walls[leg][name]} for leg in walls}}
        for key, r in med.items():
            log(f"ab {name} {key}: warm {r['warm_ms']:.4f} ms, cold {r['cold_ms']:.4f} ms, "
                f"host {r['host_us']:.1f} µs (medians of {len(rows[name])} turns)")
        log(f"ab {name} host µs: " + ", ".join(f"{k} {v:.1f}" for k, v in med_host.items()))
        for leg in walls:
            w = walls[leg][name]
            log(f"ab {name} {leg}: median {np.median(w):.4f} s (min {min(w):.4f}, max "
                f"{max(w):.4f}) over {len(w)} runs [{smi}]")
        if name in profiles:
            out[name]["stream_profile_sssp_k8"] = p = profiles[name]
            if p["busy_s"]:
                log_profile(f"ab {name} stream_sssp_k8", p)
            else:
                log(f"ab {name} stream_sssp_k8: device time not measured (no device events)")
    return out


def mesh_rank(group, graph_dir: str, cfg, source: int, n_hubs: int) -> dict:
    """One rank of ``--mesh`` on its own card: the graph from ``graph_dir``,
    its sharded runtimes in both layouts, SSSP (K=8) and Δ-PageRank
    instrumented in each, then the turns (rank 0 also runs the
    single-device sync legs; the other ranks meanwhile wait in their next
    collective)."""
    import torch

    from repro_torch.core.hytm import build_runtime, run_hytm
    from repro_torch.dist.graph_shard import build_sharded_runtime
    from repro_torch.graph.csr import CSRGraph
    from repro_torch.launch.mesh import make_graph_mesh

    mesh = make_graph_mesh(group=group)
    torch.cuda.set_device(mesh.device)
    d = Path(graph_dir)
    g = CSRGraph(np.load(d / "indptr.npy"), np.load(d / "indices.npy"),
                 np.load(d / "weights.npy"))
    legs = {k: v for k, v in smoke.shard_legs(cfg, source).items() if k in smoke.OWNER_LEGS}
    configs = {name: {"replicated": dataclasses.replace(c, mesh_axis="graph"),
                      "owner": dataclasses.replace(c, mesh_axis="graph",
                                                   vertex_sharding="owner")}
               for name, (_, _, c) in legs.items()}
    rts = {layout: build_sharded_runtime(g, configs["sssp_k8"][layout], mesh, n_hubs=n_hubs)
           for layout in ("replicated", "owner")}
    rt1 = build_runtime(g, cfg, n_hubs=n_hubs, device=mesh.device) if mesh.rank == 0 else None
    smoke.align_ranks(torch, mesh)
    out = {"rank": mesh.rank, "size": mesh.size, "info": {}, "walls": {},
           "halo": {"counts": rts["owner"].halo.halo_counts,
                    "total": rts["owner"].halo.halo_total},
           "state_bytes": smoke.owner_state_bytes(rts["owner"], *legs["sssp_k8"][:2])}
    for name, (prog, src, c) in legs.items():
        for layout, rt_ in rts.items():
            smoke.reset_launch_counts()
            info = smoke.instrumented(
                torch, lambda rec, k=configs[name][layout], r=rt_:
                run_hytm(None, prog, src, k, runtime=r, obs=rec), count_syncs=False)
            info["launches"] = smoke.read_launch_counts()
            out["info"][(layout, name)] = info
        out["walls"][name] = smoke.shard_turns(
            {"single": (lambda k=c: run_hytm(None, prog, src, k, runtime=rt1).wall_seconds)
             if rt1 is not None else None,
             **{layout: (lambda k=configs[name][layout], r=rt_:
                         run_hytm(None, prog, src, k, runtime=r).wall_seconds)
                for layout, rt_ in rts.items()}},
            rounds=MESH_ROUNDS)
        if mesh.rank == 0:
            log(f"  mesh rank 0: {name} done")
    return out


def mesh_lm_rank(group, seed: int) -> dict:
    """One rank of ``--mesh``'s kimi leg on its own card (see the module
    docstring); its numbers on the host."""
    import gc

    import torch
    import torch.distributed as dist

    from repro_torch.launch.mesh import make_debug_mesh
    from repro_torch.launch.serve import generate
    from repro_torch.models.transformer import batch_shard, init_transformer, shard_transformer

    n = dist.get_world_size()
    dev = torch.device(f"cuda:{dist.get_rank() % torch.cuda.device_count()}")
    torch.cuda.set_device(dev)
    cfg = smoke.kimi_config()
    gen = torch.Generator(device=dev)
    gen.manual_seed(seed)
    full = init_transformer(cfg, gen, dev)
    gen.manual_seed(seed + 1)
    prompts = torch.randint(0, cfg.vocab, (smoke.LM_REQUESTS, smoke.LM_PROMPT), generator=gen,
                            device=dev)
    mesh = make_debug_mesh(n, 1, device=dev)
    mine = batch_shard(prompts, mesh)
    generate(full, mine[:, :64], 2)
    torch.cuda.synchronize()
    one = generate(full, mine, smoke.LM_GEN)
    model = shard_transformer(full, mesh)
    for layer in model.layers:        # own the expert slices; free the whole bank
        if layer.moe is not None:
            layer.moe.update({name: torch.nn.Parameter(w.clone(), requires_grad=False)
                              for name, w in layer.moe.items()})
    del full
    gc.collect()
    torch.cuda.empty_cache()
    out = smoke.mesh_generate(torch, model, mine, mesh)
    a, b = out["prefill_logits"].float(), one["prefill_logits"].float()
    return {"rank": mesh.rank, "experts": model.layers[1].moe["w_gate"].shape[0],
            "bit_equal": torch.equal(out["prefill_logits"], one["prefill_logits"]),
            "max_abs_err": float((a - b).abs().max()), "max_abs": float(b.abs().max()),
            "tokens_equal": torch.equal(out["tokens"], one["tokens"]),
            "all_tokens": out["all_tokens"].cpu(), "launches": out["launches"],
            "exchange": out["exchange"], "prefill_s": out["prefill_s"],
            "decode_ms": out["decode_s_per_step"] * 1e3, "one_card_prefill_s": one["prefill_s"],
            "one_card_decode_ms": one["decode_s_per_step"] * 1e3, "peak_gb": out["peak_gb"]}


def mesh_lm(n_cards: int, smi: str) -> dict:
    """The kimi leg of ``--mesh`` over ``n_cards`` cards."""
    import torch

    from repro_torch.launch.mesh import RankPool

    t = time.monotonic()
    with RankPool(n_cards, backend="nccl", timeout_s=600.0) as pool:
        ranks = pool.run(mesh_lm_rank, smoke.SEED)
    out = {"card": smi, "cards": n_cards, "layers": smoke.KIMI_LAYERS}
    for r in ranks:
        smoke.check(r["bit_equal"] or r["max_abs_err"] <= smoke.MOE_LAYER_TOL * r["max_abs"],
                    f"--mesh kimi rank {r['rank']}: logits vs its one-card run out of tolerance")
        smoke.check(torch.equal(r["all_tokens"], ranks[0]["all_tokens"]),
                    f"--mesh kimi rank {r['rank']}: gathered tokens differ from rank 0's")
        log(f"mesh kimi ({smoke.KIMI_LAYERS} layers) rank {r['rank']} of {n_cards}: "
            f"{r['experts']} experts; vs its one-card run bit-equal {r['bit_equal']} (max |err| "
            f"{r['max_abs_err']:.4g} of {r['max_abs']:.3f}), tokens equal {r['tokens_equal']}; "
            f"prefill {r['prefill_s']:.3f} s (one card {r['one_card_prefill_s']:.3f}), decode "
            f"{r['decode_ms']:.2f} ms/step (one card {r['one_card_decode_ms']:.2f}); peak "
            f"{r['peak_gb']:.1f} GB; launches {r['launches']}; exchanges: prefill "
            f"{smoke.exchange_line(r['exchange']['prefill'])}; decode "
            f"{smoke.exchange_line(r['exchange']['decode'])} [{smi}]")
        out[f"rank{r['rank']}"] = {k: v for k, v in r.items() if k != "all_tokens"}
    out["seconds"] = time.monotonic() - t
    log(f"mesh kimi leg took {out['seconds']:.1f} s")
    return out


def mesh_main(args, smi: str) -> dict:
    """``--mesh``: the sharded sweep over every card, both layouts, then the
    kimi leg (only that with ``--lm-only``)."""
    import tempfile

    import torch

    n_cards = torch.cuda.device_count()
    if n_cards < 2:
        raise SystemExit(f"profile_port --mesh: needs two or more cards, found {n_cards}")
    if args.lm_only:
        sys.path.insert(0, str(smoke.ROOT / "src"))
        from repro_torch.kernels.runtime import build_kernels

        build_kernels()
        return {"kimi": mesh_lm(n_cards, smi)}
    cfg, hs, source, rt = smoke.setup(torch, args.scale)   # puts src on the path
    from repro_torch.core.hytm import run_hytm
    from repro_torch.launch.mesh import RankPool

    legs = {k: v for k, v in smoke.shard_legs(cfg, source).items() if k in smoke.OWNER_LEGS}
    single = {name: run_hytm(None, prog, src, c, runtime=rt)
              for name, (prog, src, c) in legs.items()}
    with tempfile.TemporaryDirectory(prefix="mesh_") as tmp:
        g = hs.graph
        for key, arr in (("indptr", g.indptr), ("indices", g.indices),
                         ("weights", g.weights if g.weights is not None
                          else np.ones(g.n_edges, np.float32))):
            np.save(Path(tmp) / f"{key}.npy", arr)
        with RankPool(n_cards, backend="nccl", timeout_s=300.0) as pool:
            ranks = pool.run(mesh_rank, tmp, cfg, source, hs.n_hubs)
    out = {"card": smi, "scale": args.scale, "cards": n_cards,
           "halo": ranks[0]["halo"], "state_bytes": ranks[0]["state_bytes"]}
    smoke.check(all(r["halo"] == ranks[0]["halo"] for r in ranks),
                "--mesh: the ranks' halo plans differ")
    log(f"mesh: {n_cards} ranks, NCCL, one card each; owner halo counts "
        f"{ranks[0]['halo']['counts']}, total {ranks[0]['halo']['total']}; state triple "
        f"{ranks[0]['state_bytes']}")
    for name in legs:
        s = single[name]
        for layout in ("replicated", "owner"):
            res = ranks[0]["info"][(layout, name)]["res"]
            for r in ranks[1:]:
                other = r["info"][(layout, name)]["res"]
                smoke.check(np.array_equal(res.values, other.values)
                            and all(np.array_equal(res.history[k], other.history[k])
                                    for k in res.history),
                            f"--mesh {layout} {name}: rank {r['rank']}'s result differs")
            if name == "pagerank":
                a, b = res.values + res.delta, s.values + s.delta
                err = float(np.max(np.abs(a - b)))
                smoke.check(bool(np.all(np.isfinite(a))) and np.allclose(a, b, rtol=1e-4,
                                                                         atol=1e-3),
                            f"--mesh {layout} Δ-PageRank: max |err| {err:.3e}")
            else:
                err = 0.0
                smoke.check(smoke.same_min_run(res, s),
                            f"--mesh {layout} SSSP != the single-device sync run")
            walls = ranks[0]["walls"][name]
            med = {k: float(np.median(v)) for k, v in walls.items() if v}
            row = {"iterations": res.iterations, "median_s": med, "walls": walls,
                   "max_abs_err": err,
                   "ici_engines": {int(e): int(c) for e, c in zip(
                       *np.unique(res.history["ici_engine"], return_counts=True))}}
            for r in ranks:
                info = r["info"][(layout, name)]
                row[f"rank{r['rank']}"] = {k: info[k] for k in (
                    "collective_ms_per_iter", "collectives", "peak_bytes", "peak_above_start",
                    "launches")}
            out[f"{layout}_{name}"] = row
            coll = [row[f"rank{r['rank']}"]["collective_ms_per_iter"] for r in ranks]
            peaks = [row[f"rank{r['rank']}"]["peak_above_start"] for r in ranks]
            log(f"mesh {layout} {name}: {res.iterations} iterations, median wall "
                f"{med[layout]:.4f} s (single-device sync {med['single']:.4f} s, of "
                f"{len(walls[layout])} each in turns); max |err| {err:.3e}; collectives "
                f"{min(coll):.3f}-{max(coll):.3f} ms an iteration by rank "
                f"({ranks[0]['info'][(layout, name)]['collectives']}); peak above the run's "
                f"start {min(peaks)}-{max(peaks)} B by rank; ICI engines {row['ici_engines']}")
    del rt, hs
    torch.cuda.empty_cache()
    out["kimi"] = mesh_lm(n_cards, smi)
    return out


def train_main(torch, smi: str) -> dict:
    sys.path.insert(0, str(smoke.ROOT / "src"))
    from repro_torch.configs.internlm2_1p8b import CONFIG, OPT
    from repro_torch.data.pipeline import LMBatches
    from repro_torch.models.transformer import init_transformer, lm_loss
    from repro_torch.train import train_step as ts
    from repro_torch.train.optimizer import apply_updates, clip_by_global_norm

    torch.backends.cuda.matmul.allow_tf32 = False   # as chip_smoke.setup states it
    cfg = CONFIG.replace(param_dtype="float32", dtype="bfloat16", remat=True)
    opt = OPT.replace(warmup_steps=smoke.TRAIN_LM_WARMUP, total_steps=smoke.TRAIN_LM_STEPS)
    gen = torch.Generator(device="cuda").manual_seed(smoke.SEED)
    model = init_transformer(cfg, gen, "cuda")
    state = {"s": ts.init_train_state(model, opt, device="cuda")}
    pipe = LMBatches(vocab=cfg.vocab, batch=smoke.TRAIN_LM_BATCH, seq_len=smoke.TRAIN_LM_SEQ,
                     seed=smoke.SEED)
    batches = [torch.from_numpy(pipe.make(i)["tokens"]).cuda() for i in range(5)]

    def loss_fn(m, b):
        return lm_loss(m, b)

    step_fn = ts.make_train_step(loss_fn, opt, microbatches=smoke.TRAIN_LM_MICROBATCHES)

    def step(i):
        state["s"], m = step_fn(state["s"], batches[i])
        return float(m["loss"])

    step(0)
    step(1)
    out = {"card": smi}
    p = profile_run(torch, lambda: step(2), top=12)
    if p["busy_s"]:
        log_profile("train step", p)
        out["profile_step"] = p
    else:
        log("profile train step: device time not measured (no device events)")
    s = state["s"]
    named = ts.named_params(s.params)
    _, grads = ts.value_and_grads(loss_fn, s.params, batches[3], smoke.TRAIN_LM_MICROBATCHES)
    grads, _ = clip_by_global_norm(grads, opt.grad_clip)
    torch.cuda.synchronize()
    p = profile_run(torch, lambda: apply_updates(opt, named, grads, s.opt_state, s.step,
                                                 s.leaves), top=8)
    if p["busy_s"]:
        log_profile("apply_updates", p)
        out["profile_apply_updates"] = p
    del grads
    sites = sync_sites(torch, lambda: step(4))
    log(f"syncs train step: {sum(sites.values())} host syncs a step: {sites} [{smi}]")
    out["syncs"] = sites
    return out


TRAIN_MESH_SHAPES = ((2, 2), (1, 4))
TRAIN_MESH_ROWS = 4     # 2 microbatches of 2 rows: a row a data rank at (2, 2)
TRAIN_MESH_STEPS = 3    # a warm-up, then 2 timed; then one more under the profiler
# --moe: deepseek-v2-lite-16b at full width, float32, its dense layer and
# MOE_MESH_LAYERS - 1 MoE layers: 419M embedding and unembedding, 81M dense
# layer, 585M a MoE layer (554M of it experts) -> 2.84B parameters at 5
# layers, 45.4 GB of float32 parameters, gradients and AdamW moments on the
# one card, about 8 GB of activations at 4 x 1024 tokens beside them:
# within 64 GB, 80 GB less 20%, where a sixth layer (55.8 GB + 8) is not
MOE_MESH_LAYERS = 5
MOE_MESH_SHAPES = ((4, 1), (2, 2))   # EP 4; EP 2 with TP 2
MOE_MESH_SEQ = 1024     # a row's next-token positions, and the MoE's chunk: each
#                         row routes with its own capacity on every layout
# relative to one card's: the grad norms of the first two steps (the same
# parameters: the schedule is 0 at step 0) hold float32 sums in another
# order; the losses after AdamW's first update also hold its sign-like
# steps, where a gradient within rounding of 0 may point the other way
MOE_MESH_NORM_TOL = 1e-5
MOE_MESH_LOSS_TOL = 1e-3


def train_mesh_run(torch, dev, seed: int, mesh=None, profiled: bool = False,
                   moe: bool = False, layers: int = MOE_MESH_LAYERS) -> dict:
    """``--train-mesh``'s run on ``dev``: internlm2-1.8b as ``chip_smoke.py``
    phase 19 leg (b) trains it, on ``TRAIN_MESH_ROWS`` rows of 4096
    positions a step, or with ``moe`` deepseek-v2-lite (``layers`` layers,
    float32, one microbatch, ``TRAIN_MESH_ROWS`` rows of ``MOE_MESH_SEQ``
    positions, its MoE chunked a row: each row's capacity from its own
    tokens, on one card and on every mesh alike), on ``mesh`` (a
    ``ModelMesh``) placed by ``lm_rule`` and ``lm_batch_spec``, or on the
    one device: ``TRAIN_MESH_STEPS`` steps timed and one more, under the
    profiler when ``profiled``; the losses, seconds, profile, peak and (on a
    mesh) the MoE exchanges' device ms."""
    import gc

    from torch.distributed.tensor import distribute_tensor

    from repro_torch.data.pipeline import LMBatches
    from repro_torch.dist.sharding import (distribute, lm_batch_spec, lm_rule, placements,
                                           tree_shardings)
    from repro_torch.launch.mesh import device_mesh
    from repro_torch.models.moe import ExchangeTimer
    from repro_torch.models.transformer import init_transformer, lm_loss
    from repro_torch.train import train_step as ts

    card = dev.type == "cuda"
    sync = torch.cuda.synchronize if card else (lambda: None)
    if moe:
        from repro_torch.configs.deepseek_v2_lite_16b import CONFIG, OPT

        cfg = CONFIG.replace(n_layers=layers, dtype="float32", param_dtype="float32",
                             moe=CONFIG.moe.replace(chunk_tokens=MOE_MESH_SEQ))
        opt = OPT.replace(warmup_steps=1, total_steps=TRAIN_MESH_STEPS + 1)
        seq, microbatches = MOE_MESH_SEQ + 1, 1
    else:
        from repro_torch.configs.internlm2_1p8b import CONFIG, OPT

        cfg = CONFIG.replace(param_dtype="float32", dtype="bfloat16", remat=True)
        opt = OPT.replace(warmup_steps=smoke.TRAIN_LM_WARMUP, total_steps=TRAIN_MESH_STEPS + 1)
        seq, microbatches = smoke.BLOCKED_SEQ + 1, smoke.TRAIN_LM_MICROBATCHES
    pipe = LMBatches(vocab=cfg.vocab, batch=TRAIN_MESH_ROWS, seq_len=seq, seed=seed)
    batches = [torch.from_numpy(pipe.make(i)["tokens"]).to(dev)
               for i in range(TRAIN_MESH_STEPS + 1)]
    if card:
        torch.cuda.reset_peak_memory_stats(dev)
    model = init_transformer(cfg, torch.Generator(device=dev).manual_seed(seed), dev)
    state = {"s": ts.init_train_state(model, opt, device=dev)}
    if mesh is not None:
        dm = device_mesh(mesh)
        state["s"] = distribute(state["s"], dm, tree_shardings(state["s"], mesh, lm_rule(mesh)))
        batches = [distribute_tensor(b, dm, placements(lm_batch_spec(mesh), 2, dm),
                                     src_data_rank=None) for b in batches]
    step_fn = ts.make_train_step(lambda m, b: lm_loss(m, b, mesh=mesh), opt,
                                 microbatches=microbatches)

    out = {"losses": [], "norms": [], "secs": []}

    def step(i):
        state["s"], m = step_fn(state["s"], batches[i])
        out["norms"].append(float(m["grad_norm"]))
        return float(m["loss"])

    timer = ExchangeTimer()
    for i in range(TRAIN_MESH_STEPS):
        # the first step (NCCL's set-up) untimed by the exchange timer
        with timer if i else contextlib.nullcontext():
            sync()
            t = time.monotonic()
            out["losses"].append(step(i))
            sync()
            out["secs"].append(time.monotonic() - t)
    if moe and mesh is not None:
        out["exchanges"] = timer.summary()
    if profiled:
        out["profile"] = profile_run(torch, lambda: out["losses"].append(
            step(TRAIN_MESH_STEPS)), top=8)
    else:
        out["losses"].append(step(TRAIN_MESH_STEPS))
    if card:
        out["peak_gb"] = torch.cuda.max_memory_allocated(dev) / 1e9
    del state, model, batches
    gc.collect()
    if card:
        torch.cuda.empty_cache()
    return out


def train_mesh_rank(group, shape: tuple, seed: int, device_type: str, moe: bool = False,
                    layers: int = MOE_MESH_LAYERS) -> dict:
    """One rank of ``--train-mesh`` on its own card (``device_type``
    ``cuda``; ``cpu`` to rehearse on gloo ranks): the run on a ``shape``
    (data, model) mesh."""
    import torch
    import torch.distributed as dist

    from repro_torch.launch.mesh import make_debug_mesh

    warnings.filterwarnings("ignore")
    if device_type == "cuda":
        dev = torch.device(f"cuda:{dist.get_rank() % torch.cuda.device_count()}")
        torch.cuda.set_device(dev)
        torch.backends.cuda.matmul.allow_tf32 = False   # as chip_smoke.setup states it
    else:
        dev = torch.device("cpu")
    mesh = make_debug_mesh(*shape, device=dev)
    # rank 0 alone under the profiler: the others run the same step
    return {"rank": mesh.rank, **train_mesh_run(
        torch, dev, seed, mesh, profiled=device_type == "cuda" and mesh.rank == 0, moe=moe,
        layers=layers)}


def train_mesh_main(torch, n_cards: int, smi: str, device_type: str = "cuda",
                    moe: bool = False, layers: int = MOE_MESH_LAYERS) -> dict:
    """internlm2-1.8b's train step at full depth on (2, 2) and (1, 4) NCCL
    meshes, one rank a card, against the single-device step on card 0, or
    with ``moe`` deepseek-v2-lite's on (4, 1) and (2, 2): seconds a step,
    the collectives' share of a profiled step's device time, each rank's
    peak, the losses (every rank's equal, and within a tolerance of one
    card's: ``TRAIN_MB_TOL`` for internlm2's bf16, ``MOE_MESH_LOSS_TOL``
    and ``MOE_MESH_NORM_TOL`` for the float32 MoE)."""
    from repro_torch.launch.mesh import RankPool

    card = device_type == "cuda"
    dev = torch.device("cuda:0" if card else "cpu")
    single = train_mesh_run(torch, dev, smoke.SEED, moe=moe, layers=layers)
    out = {"card": smi, "cards": n_cards, "model": "deepseek-v2-lite-16b" if moe
           else "internlm2-1.8b", "single": single}
    log(f"train mesh: single device: losses {[round(x, 5) for x in single['losses']]}, steps "
        f"{[round(x, 3) for x in single['secs']]} s" + (
            f", peak {single['peak_gb']:.1f} GB" if card else ""))
    tol = MOE_MESH_LOSS_TOL if moe else smoke.TRAIN_MB_TOL
    norm_tol = MOE_MESH_NORM_TOL if moe else smoke.TRAIN_MB_TOL
    with RankPool(n_cards, backend="nccl" if card else "gloo", timeout_s=900.0) as pool:
        for shape in MOE_MESH_SHAPES if moe else TRAIN_MESH_SHAPES:
            ranks = pool.run(train_mesh_rank, shape, smoke.SEED, device_type, moe, layers)
            name = f"{shape[0]}x{shape[1]}"
            rel = max(abs(a - b) / abs(b) for a, b in zip(ranks[0]["losses"],
                                                          single["losses"]))
            smoke.check(all(r["losses"] == ranks[0]["losses"] for r in ranks),
                        f"--train-mesh {name}: the ranks' losses differ")
            norm_rel = max(abs(a - b) / abs(b) for a, b in zip(ranks[0]["norms"][:2],
                                                               single["norms"][:2]))
            smoke.check(rel <= tol and norm_rel <= norm_tol, f"--train-mesh {name}: losses "
                        f"{ranks[0]['losses']} and grad norms {ranks[0]['norms']} against the "
                        f"single device's {single['losses']} and {single['norms']}")
            for r in ranks:
                prof = r.get("profile")
                share = (f"; a profiled step: device busy {prof['busy_s']:.3f} s of a "
                         f"{prof['span_s']:.3f} s span, NCCL {prof['nccl_s']:.3f} s = "
                         f"{prof['nccl_s'] / prof['busy_s']:.1%} of busy"
                         if prof and prof["busy_s"] else "")
                if card:
                    share += f"; peak {r['peak_gb']:.1f} GB"
                if "exchanges" in r:
                    share += f"; the MoE exchanges over steps 2-{TRAIN_MESH_STEPS}: " + ", ".join(
                        f"{k} {v['calls']} calls {v['bytes'] / 1e6:.1f} MB"
                        + (f" {v['ms']:.2f} ms" if v["ms"] is not None else "")
                        for k, v in r["exchanges"].items())
                if prof:
                    log_profile(f"train mesh {name} rank {r['rank']}", prof)
                log(f"train mesh {name} rank {r['rank']}: losses "
                    f"{[round(x, 5) for x in r['losses']]} (within {rel:.2e} relative of the "
                    f"single device's), the first two grad norms within {norm_rel:.2e}, steps "
                    f"{[round(x, 3) for x in r['secs']]} s{share} [{smi}]")
            out[name] = {f"rank{r['rank']}": r for r in ranks}
    return out


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--scale", type=int, default=22,
                    help="RMAT scale: 2**scale vertices, 16 * 2**scale edges")
    ap.add_argument("--dlrm", action="store_true",
                    help="profile dlrm-mlperf serving instead of the graph path")
    ap.add_argument("--against", action="append", default=[], metavar="NAME=DIR",
                    help="compare this tree with the checkout DIR in turns")
    ap.add_argument("--mesh", action="store_true",
                    help="the sharded sweep over every card (NCCL), both vertex layouts")
    ap.add_argument("--lm-only", action="store_true",
                    help="with --mesh: the kimi leg alone, no graph")
    ap.add_argument("--train", action="store_true",
                    help="internlm2-1.8b's train step (chip_smoke.py phase 18 leg (a))")
    ap.add_argument("--train-mesh", action="store_true",
                    help="internlm2-1.8b's train step at 4096 positions on (2, 2) and (1, 4) "
                         "NCCL meshes over four cards")
    ap.add_argument("--moe", action="store_true",
                    help="with --train-mesh: deepseek-v2-lite-16b's (5 layers, float32) on "
                         "(4, 1) and (2, 2)")
    ap.add_argument("--worker", help=argparse.SUPPRESS)       # a tree's src, for --against
    ap.add_argument("--graph-file", help=argparse.SUPPRESS)
    args = ap.parse_args()
    if args.worker:
        return ab_worker(args)

    import torch

    if not torch.cuda.is_available():
        print("profile_port: no CUDA device", file=sys.stderr)
        return 1
    smi = smoke.card_line()
    log(f"card: {smi}; torch {torch.__version__}, CUDA {torch.version.cuda}")
    if args.dlrm:
        print(json.dumps(dlrm_main(torch, smi)))
        return 0
    if args.train:
        print(json.dumps(train_main(torch, smi), default=str))
        return 0
    if args.train_mesh:
        sys.path.insert(0, str(smoke.ROOT / "src"))
        n_cards = torch.cuda.device_count()
        if n_cards < 4:
            print(f"profile_port: --train-mesh needs four cards, found {n_cards}",
                  file=sys.stderr)
            return 1
        print(json.dumps(train_mesh_main(torch, 4, smi, moe=args.moe), default=str))
        return 0
    if args.against:
        print(json.dumps(ab_main(args, smi)))
        return 0
    if args.mesh:
        print(json.dumps(mesh_main(args, smi), default=str))
        return 0
    cfg, _, source, rt = smoke.setup(torch, args.scale)
    from repro_torch.core.hytm import run_hytm

    legs = smoke.main_path_legs(cfg, source)
    out = {"card": smi, "scale": args.scale}
    for name, (kern, plain) in smoke.TURN_PAIRS.items():
        walls = smoke.leg_turns({"plain": smoke.run_wall(rt, legs[plain]),
                                 "kernels": smoke.run_wall(rt, legs[kern])}, ROUNDS)
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
