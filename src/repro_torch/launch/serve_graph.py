"""Graph-query serving launcher: a ``repro_torch.stream.GraphService``
driven by a synthetic query/update trace, on ``cuda`` unless ``--device``
says otherwise.

    PYTHONPATH=src python -m repro_torch.launch.serve_graph --nodes 5000 \\
        --edges 80000 --algorithm sssp --queries 32 --update-batches 4

    PYTHONPATH=src python -m repro_torch.launch.serve_graph --selfcheck --device cpu

``--selfcheck`` runs the serving equivalence contract on a small graph
(batched == independent runs, cached repeat == zero sweeps, incremental
after updates == from-scratch, a mesh-sharded sweep == a single-device
run, the multi-tenant scheduler's quotas and byte budget) and exits
non-zero on any violation.  The sharded step runs on the default process
group when one exists, else on a one-rank group of its own (gloo on
``--device cpu``, NCCL on the card), so it is never skipped.
``--algorithm wcc`` symmetrizes the graph first.

``--trace PATH`` records the run through ``repro_torch.obs`` and writes a
Chrome trace-event JSON to PATH.  ``--calibrated`` serves under the
calibrated ``LinkModel`` of the serving device's kind from the autotune
registry (``python -m repro_torch.launch.calibrate`` writes it); a
missing profile gives the shipped ``PCIE3``, a corrupt one warns and
gives ``PCIE3``.
"""

from __future__ import annotations

import argparse
import dataclasses
import time

import numpy as np


def selfcheck(device: str = "cuda") -> None:
    from repro_torch.core.hytm import HyTMConfig, run_hytm
    from repro_torch.graph.algorithms import PAGERANK, PPR, SSSP
    from repro_torch.graph.generators import rmat_graph
    from repro_torch.serve import Request, RequestQueue
    from repro_torch.stream import GraphService, random_batch

    g = rmat_graph(500, 4000, seed=17)
    cfg = HyTMConfig(n_partitions=8)
    svc = GraphService(g, cfg, max_lanes=4, device=device)
    rng = np.random.default_rng(17)

    # 1. batched lanes == independent single-source runs (bit-exact)
    sources = [0, 3, 77, 210]
    batched = svc.query(SSSP, sources)
    for s, r in zip(sources, batched):
        solo = run_hytm(g, SSSP, source=s, config=cfg, device=device)
        np.testing.assert_array_equal(r.values, solo.values)
    assert all(r.mode == "batched" for r in batched)

    # 2. cached repeat: zero sweep iterations
    again = svc.query(SSSP, sources)
    assert all(r.cache_hit and r.iterations == 0 for r in again)

    # 3. update invalidates the cache; incremental matches from-scratch
    svc.update(random_batch(svc.dcsr, rng, n_insert=16, n_delete=16))
    post = svc.query(SSSP, sources)
    assert all(r.mode == "incremental" for r in post)
    g2 = svc.dcsr.to_host_graph()
    for s, r in zip(sources, post):
        fs = run_hytm(g2, SSSP, source=s, config=cfg, device=device)
        np.testing.assert_array_equal(r.values, fs.values)

    # 4. accumulative program: tolerance-bounded incremental equivalence
    pr = dataclasses.replace(PAGERANK, tolerance=1e-7)
    svc.query(pr, None)
    svc.update(random_batch(svc.dcsr, rng, n_insert=8, n_delete=8))
    inc = svc.query(pr, None)[0]
    assert inc.mode == "incremental"
    fs = run_hytm(svc.dcsr.to_host_graph(), pr, source=None, config=cfg, device=device)
    assert np.max(np.abs(inc.values - fs.values)) < 1e-3

    # 5. the serving path coexists with the sharded sweep: a fresh query
    # equals a mesh-sharded run of the same graph
    np.testing.assert_array_equal(
        _sharded_sssp(g2, cfg, device), run_hytm(g2, SSSP, source=0, config=cfg,
                                                 device=device).values)

    # 6. multi-tenant scheduler contract: EDF admission under per-tenant
    # quotas + a device byte budget small enough to force cache spills —
    # answers must still equal solo runs, the budget must hold
    n = svc.dcsr.n_nodes
    tiny = GraphService(svc.dcsr.to_host_graph(), cfg, max_lanes=2,
                        device_budget_bytes=2 * 9 * n, device=device)
    q = RequestQueue(quota=2, tenant_quotas={"bronze": 1})
    for i, s in enumerate([0, 3, 77, 210, 3, 9]):
        tenant = ["gold", "silver", "bronze"][i % 3]
        q.submit(Request(tenant=tenant, program=SSSP, source=s, deadline=float(i)))
    served = tiny.scheduler.pump(q)
    assert len(served) == 6 and q.stats.rejected == 0
    g3 = tiny.dcsr.to_host_graph()
    for r in served:
        solo = run_hytm(g3, SSSP, source=r.request.source, config=cfg, device=device)
        np.testing.assert_array_equal(r.values, solo.values)
    assert tiny.scheduler.stats.max_device_bytes <= 2 * 9 * n

    # personalized PageRank serves through the same lanes
    ppr = dataclasses.replace(PPR, tolerance=1e-7)
    r = tiny.query(ppr, [0])[0]
    assert r.mode == "batched" and r.iterations > 0

    print(f"SELFCHECK OK (device {device}) — stats: {svc.stats}; "
          f"serve: {tiny.scheduler.stats} cache: {tiny.cache.stats.as_dict()}")


def _sharded_sssp(g, cfg, device: str) -> np.ndarray:
    """SSSP from vertex 0 through ``run_hytm`` with ``mesh_axis="graph"``:
    on the default process group when one exists, else on a one-rank group
    of its own (gloo on the CPU, NCCL on the card)."""
    import torch
    import torch.distributed as dist

    from repro_torch.core.hytm import run_hytm
    from repro_torch.graph.algorithms import SSSP
    from repro_torch.launch.mesh import RankPool, make_graph_mesh

    mesh_cfg = dataclasses.replace(cfg, async_sweep=False, mesh_axis="graph")
    if dist.is_initialized():
        return run_hytm(g, SSSP, 0, mesh_cfg, mesh=make_graph_mesh(device=device)).values
    backend = "nccl" if torch.device(device).type == "cuda" else "gloo"
    with RankPool(1, backend=backend):
        return run_hytm(g, SSSP, 0, mesh_cfg, mesh=make_graph_mesh(device=device)).values


def main(argv=None) -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--selfcheck", action="store_true")
    ap.add_argument("--device", default="cuda",
                    help="torch device to serve on (default cuda; the CPU only when asked)")
    ap.add_argument("--nodes", type=int, default=5000)
    ap.add_argument("--edges", type=int, default=80_000)
    ap.add_argument("--partitions", type=int, default=32)
    ap.add_argument("--algorithm", default="sssp",
                    choices=["sssp", "bfs", "cc", "wcc", "pagerank", "php", "ppr"])
    ap.add_argument("--queries", type=int, default=16)
    ap.add_argument("--lanes", type=int, default=8)
    ap.add_argument("--update-batches", type=int, default=4)
    ap.add_argument("--update-size", type=int, default=64)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--device-budget-bytes", type=int, default=None,
                    help="device byte budget for in-flight lane state + the warm "
                         "cache's device tier (overflow spills to host RAM; "
                         "default: unbounded)")
    ap.add_argument("--lane-buckets", default=None,
                    help="comma-separated static lane bucket sizes for the serving "
                         "scheduler (default: powers of two up to --lanes)")
    ap.add_argument("--trace", default=None, metavar="PATH",
                    help="record the run through repro_torch.obs and write a Chrome "
                         "trace-event JSON to PATH (chrome://tracing / Perfetto)")
    ap.add_argument("--calibrated", action="store_true",
                    help="use the calibrated LinkModel profile of the serving device's "
                         "kind from the autotune registry if one exists; a corrupt "
                         "profile warns and falls back to the shipped constants")
    args = ap.parse_args(argv)

    if args.selfcheck:
        selfcheck(args.device)
        return

    from repro_torch.core.hytm import HyTMConfig
    from repro_torch.graph.algorithms import ALGORITHMS
    from repro_torch.graph.generators import rmat_graph
    from repro_torch.stream import GraphService, random_batch

    program = ALGORITHMS[args.algorithm]
    g = rmat_graph(args.nodes, args.edges, seed=args.seed)
    if program.symmetrize:
        # WCC sweeps the undirected edge set; the streaming runtime is
        # built straight from this graph, so symmetrize before serving
        g = g.symmetrize()
    cfg = HyTMConfig(n_partitions=args.partitions)
    if args.calibrated:
        from repro_torch.autotune.registry import default_device_kind, load_profile_or_default

        cfg = dataclasses.replace(
            cfg, link=load_profile_or_default(default_device_kind(args.device)))
    buckets = (tuple(int(b) for b in args.lane_buckets.split(","))
               if args.lane_buckets else None)
    rec = None
    if args.trace:
        from repro_torch.obs import TraceRecorder

        rec = TraceRecorder()
    svc = GraphService(g, cfg, max_lanes=args.lanes,
                       device_budget_bytes=args.device_budget_bytes,
                       lane_buckets=buckets, obs=rec, device=args.device)
    rng = np.random.default_rng(args.seed)

    sources = rng.integers(0, args.nodes, size=args.queries).tolist()
    t0 = time.monotonic()
    svc.query(program, sources)
    t_cold = time.monotonic() - t0

    t0 = time.monotonic()
    for _ in range(args.update_batches):
        svc.update(random_batch(
            svc.dcsr, rng,
            n_insert=args.update_size // 2, n_delete=args.update_size // 2,
        ))
        svc.query(program, sources[: max(1, args.lanes)])
    t_stream = time.monotonic() - t0

    s = svc.stats
    print(f"{args.algorithm}: {args.queries} cold queries in {t_cold:.2f}s "
          f"({args.queries / max(t_cold, 1e-9):.1f} q/s) on {svc.device}")
    print(f"streaming: {args.update_batches} update batches "
          f"(x{args.update_size} edges) + warm queries in {t_stream:.2f}s")
    print(f"stats: hits={s.n_cache_hits} incremental={s.n_incremental} "
          f"full={s.n_full} sweeps={s.sweep_iterations} "
          f"updated_edges={s.update_edges} version={svc.version}")
    print(f"cache tiers: {svc.cache.stats.as_dict()} "
          f"(device_bytes={svc.cache.device_bytes})")
    if args.calibrated:
        print(f"link profile: {cfg.link.name!r} (bandwidth {cfg.link.bandwidth:.6g} B/s, "
              f"launch overhead {cfg.link.launch_overhead_s:.6g} s, "
              f"alpha {cfg.link.alpha:.6g}, beta {cfg.link.beta:.6g})")
    if rec is not None:
        from repro_torch.obs import write_chrome_trace

        write_chrome_trace(rec, args.trace)
        print(f"trace: {len(rec)} events -> {args.trace}")


if __name__ == "__main__":
    main()
