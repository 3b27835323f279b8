#!/usr/bin/env python3
"""Smoke test of the PyTorch/CUDA port (``src/repro_torch``) on one NVIDIA GPU.

    python3 chip_smoke.py               # RMAT scale 22 (Graph500 edge factor 16)
    python3 chip_smoke.py --scale 16    # a quick rehearsal at a smaller scale

Phases, in order; any failure exits nonzero and prints no result line:

1. environment: the card's name and power limit, torch/CUDA versions, the
   kernels' build time, and the graph and runtime set-up; after phase 2's
   graph kernels, the bf16 wgmma kernels' registers, spills and shared
   memory (``cudaFuncGetAttributes``);
2. every hand-written kernel against its plain PyTorch version on the card,
   at the shapes of the main path plus edge cases, with its device time
   (CUDA-graph replay, median of 20), the time of one call from the host,
   the plain version's and one library call's time, and the least time the
   card could take (bytes moved / 3.35 TB/s, or for ``flash_attention`` the
   larger of that and its flops at the type's peak).  The three graph
   kernels are timed warm (one argument set, L2-resident) and on a cold L2
   (``cold_ms``), with the host time to issue a call (each launch's device
   time comes in phase 4); ``segment_spmm`` min and sum also on the last
   partition's block; then the registers and spills ptxas reported for
   ``segment_spmm`` and ``frontier_compact`` (none may spill).  ``flash_attention``
   runs at gemma3-12b's prefill shapes (a local and a global layer: q (64,
   2048, 256) bf16 over 8 kv heads), at deepseek-v2-lite's MLA prefill (q
   and k (64, 2048, 192) bf16, values 128 wide, unpadded) and at
   edge cases (S = 257, dh 128 in float32 with one kv head per query head,
   window 1, non-causal with S != L); its library yardstick is
   ``scaled_dot_product_attention``.  ``grouped_matmul`` runs at
   deepseek-v2-lite's MoE shapes (a 4 x 2048-token prefill's gate/up and
   down launches, 49,152 rows over 64 experts capped at C = 960, and a
   decode step's 24 rows, bf16) and at edge cases (odd D and F, float32,
   one expert, empty experts, groups cut at the row bound, T = 0); its
   library yardsticks are ``torch._grouped_mm`` and the reference's own
   ``torch.bmm`` over the capacity-padded buffer;
3. the cost model on the card against the CPU, bit for bit, on the
   frontiers of the first SSSP iterations and on random frontiers;
4. the main path at full size: ``run_hytm`` SSSP (K=8 and K=1), Δ-PageRank
   and the three forced-engine baselines through the kernels, held against
   ``use_kernels=False`` on the card.  The launch counts are set to 0
   before each leg and read after it: each leg must launch the kernels of
   its engines (the hybrid SSSP legs all three, Δ-PageRank ``segment_spmm``
   with its sum combine, each forced leg its own engine's kernel and no
   other), and the plain legs none.  Then SSSP (K=8) and Δ-PageRank run in
   turns (plain, kernels, kernels, plain, once): their median wall
   seconds.  Only then, after every host timing of the graph, does the
   profiler run (``torch.profiler``): phase 2's graph rows' device time a
   launch, by kernel, and their host time a call again, to show what the
   profiler leaves behind; and the device time of the port's kernels in
   one more kernel run of each pair;
5. the oracle leg: SSSP and PageRank on the quickstart graph against the
   numpy references;
10. (run right after phase 5, on phase 4's graph and configuration) dynamic
   graphs and the online calibrator: SSSP (K=8) and Δ-PageRank with
   ``autotune=True`` on the main runtime against phase 4's runs; a
   ``DeltaCSR`` of the graph on the card (blocks 1.5x the main path's) and
   cold SSSP and Δ-PageRank over it; three ``random_batch`` updates of 576
   ops, each patched in device memory and followed by warm
   ``run_incremental`` legs (SSSP through the kernels, plain and with a
   calibrator that lives across the batches; Δ-PageRank through the
   kernels and plain), kernels held to plain; the last warm answers
   against ``to_host_graph`` + ``build_runtime`` + a cold run (SSSP equal
   with strictly fewer warm iterations) and the time to fresh answers both
   ways; then a ``DeltaCSR`` with no slack takes 512 inserts into its
   largest block and merge-compacts, and its warm SSSP is held to plain and
   to scratch.  Every leg's launch counts are read after that leg alone:
   a kernel leg must launch a graph kernel and nothing else, a plain leg
   nothing;
11. (right after phase 10, same graph and configuration, K=8) graph
   serving: a ``GraphService`` over a ``DeltaCSR`` of the graph with 8
   lanes answers 32 SSSP sources (vertices with out-edges, drawn from the
   seed) with backfill, each bit-equal to its solo ``run_hytm`` over the
   service's runtime; the same 32 queries batched against a loop of solo
   runs in turns (batched, solo; once each): queries/s, lane
   occupancy, peak device memory, host syncs a chunk (PyTorch's sync debug
   mode) and the kernels' device ms in one traced batched run; a
   three-tenant ``pump`` of 24 SSSP/BFS requests under quotas with a
   budget of 4 lanes and 2 cached states (answers equal solo runs, budget
   and quotas held at every dispatch); 8 Δ-PPR lanes within phase 4's SUM
   bound; phase 10's three update batches and a re-query of 8 of the
   pump's sources, each incremental and equal to a solo run over the
   updated runtime; then each lane entry (``segment_spmm_lanes`` min and
   sum, ``frontier_compact_lanes``, ``hyb_gather``'s one request list for
   all lanes) against its plain version at the phase's shapes, warm and
   cold, against its bytes bound.  A lane leg must launch a lane entry and
   no solo ``segment_spmm``/``frontier_compact``;
12. (right after phase 11, same graph and configuration) offline
   calibration and observability.  12a: ``autotune.wall_probe`` over
   ``default_grid()`` (4 edge levels x 9 activity ratios x 3 degree
   regimes, 108 points, E capped at 4.3M: a scale-22 partition holds
   about 1.05M edges) through the kernels, whose launches of each graph
   kernel are checked, and again plain: per engine the wall seconds a
   relax and the kernel/plain ratio; on each of the 108 blocks the probe
   draws, each engine through its kernel against plain (SSSP, aggregates
   and touched flags bit-equal); ``calibrate`` from ``PCIE3`` with the
   intercept refit (the fitted fields, static and calibrated regret, the
   oracle, the grid's picks under both profiles); the
   ``launch.calibrate`` selfcheck on the card and its CLI in wall mode
   into a temporary registry; the fitted profile saved under the card's
   device kind and reloaded equal; SSSP (K=8) and Δ-PageRank under the
   calibrated profile against ``PCIE3`` in turns (1 round; SSSP
   bit-equal, Δ-PageRank within phase 4's bound).  12b: a traced SSSP on
   both drivers (``reconcile`` exact, values bit-equal to untraced, every
   host sync equal traced and untraced, site by site, the traced/untraced wall
   in turns, 1 round), a traced ``GraphService`` answering 8 SSSP
   queries through 8 lanes (the Chrome trace valid, with the scheduler,
   cache and tenant tracks; ``serve.requests`` totals the queries; written
   under ``build/``), and ``launch.serve_graph`` at its defaults with
   ``--trace`` and ``--calibrated`` against the temporary registry;
13. (right after phase 12, same graph) resilience.  SSSP (K=2) through the
   kernels with a ``CheckpointHook`` every chunk, killed by an injected
   ``chunk_dispatch`` fault at chunks 1, 2 and 3 (no retry) and resumed with
   ``resume_run``: values, iterations, transfer bytes and every history row
   bit-equal to the uninterrupted run; each checkpoint read back with numpy
   alone (schema 2, the crc table) and held to the state copied from the
   card at that boundary; its bytes and the save, restore and resume
   times.  Δ-PageRank (K=8) killed at chunk 1 and resumed, within phase 4's
   bound.  Hooked against unhooked SSSP in turns (1 round), and the
   hook's one host sync a checkpoint.  The
   degradation ladder: ``run_supervised`` with ``use_kernels="auto"`` and
   faults at chunk 2 while the kernels run degrades once
   (``kernels->oracle``), bit-equal to the kernel run, with the graph
   kernels' launches those of a kernel run capped at 4 iterations.  The
   chaos trace through a ``GraphService`` at phase 11's lanes and budget
   (8 SSSP queries from three tenants, an update batch delivered exactly
   once, the 8 sources again): clean, then under lane dispatch fail and
   timeout with retries (traced: one ``injected`` a fault and one ``retry``
   a retry on the ``faults`` track, the Chrome trace valid), lane
   allocation and promote OOM with tiered shedding, and spill corruption
   with an update drop and a redelivery on a two-lane budget: every
   completed request bit-equal to the clean replay, the version equal, the
   budget held, no top-tier request shed, a corrupt spill detected; then an
   empty ``FaultPlan`` against none in turns, bit-equal, with the port's
   host syncs (PyTorch's sync debug mode) equal site by site;
14. (right after phase 13, same graph and configuration) the sharded sweep
   (``run_hytm`` with ``mesh_axis="graph"``, ``dist.graph_shard``) through
   the kernels.  Leg (a): NCCL at world size 1 in this process, SSSP (K=8,
   K=1) and Δ-PageRank against the single-device ``async_sweep=False``
   runs (SSSP bit-equal in values, iterations, bytes and engines;
   Δ-PageRank within phase 4's bound; ICI rows zero).  Leg (b): two gloo
   ranks on the one card (this process rank 0, one spawned rank; the graph
   handed over as ``.npy`` files), SSSP (K=8) and Δ-PageRank held to the
   same contract, both ranks' results equal, SSSP's ``merged_entries``
   equal to leg (a)'s and the D = 2 ICI rows ``ici_level_cost`` of them, a
   seeded ``chunk_dispatch`` plan firing alike on both ranks with SSSP
   bit-equal.  Legs (c) and (d): the owner layout
   (``vertex_sharding="owner"``) in the same processes: at D = 1 SSSP (K=8)
   bit-equal to leg (a) and Δ-PageRank within bound of it, ICI rows zero;
   at D = 2 SSSP bit-equal to the sync run, Δ-PageRank within bound, both
   ranks equal, their halo counts equal, SSSP's ``merged_entries`` equal to
   leg (a)'s and the ICI rows ``halo_level_cost`` of them, and SSSP (K=2)
   killed at chunk 2 on both ranks and resumed bit-equal, rank 0 alone
   writing the owner checkpoint.  Every leg launches the kernels of the
   engines its rank picked and no other.  Wall seconds in turns of the
   single-device sync run and both layouts (1 round; at D = 2 Δ-PageRank
   none: the checked runs' walls), the collectives' device ms an iteration (CUDA events; gloo stages
   them through the host), host syncs a dispatch, each rank's peak
   allocated memory in each layout and the owner state triple's bytes
   against ``vertex_state_bytes``;
15. (right after phase 14, same graph and configuration) the sharded
   stream and serving paths (``DeltaCSR.sharded_runtime_for``,
   ``run_incremental`` and ``GraphService`` on a mesh) through the graph
   kernels' solo and lane entries.  Leg (e), NCCL at world size 1 in this
   process, both layouts: one DeltaCSR (K=8) with both views registered
   before phase 10's three batches; after each, a warm SSSP on the mesh
   bit-equal to the single-device sync warm run (values, iterations, bytes,
   engines); after the last, fewer iterations than a cold sharded run and
   a warm Δ-PageRank within phase 4's bound; each batch's ``apply`` seconds
   (the views' refresh and the owner halo plan apart) and warm seconds
   against phase 10's; phase 10's no-slack merge-compaction with the views
   refilled and a warm SSSP on the mesh bit-equal.  Leg (f), the same
   group: a single-device sync ``GraphService`` and one on the mesh in each
   layout, 8 lanes, 16 SSSP sources with out-edges: answers bit-equal in
   values and iterations, the repeat all cache hits, one update and an
   incremental re-query bit-equal, k-core down the global path, the owner
   service's ``lane_bytes`` 9 n_loc, an owner budget that spills and then
   promotes bit-equal, and queries/s in turns (1 round) with host syncs a
   chunk.  Leg (g): two gloo ranks on the one card, the owner layout at 63
   partitions (a padding partition: the CUDA ``segment_reduce`` of an
   empty segment runs in the warm Δ-PageRank's plan): one batch, warm SSSP
   bit-equal to rank 0's single-device sync run, warm Δ-PageRank within
   bound, an owner service with 4 lanes answering 8 SSSP queries, one
   update and the re-query, all bit-equal to solo sync runs, both ranks
   equal; each rank's launches and peak allocated memory;
16. (right after phase 8, on its model) models over a mesh
   (``launch.mesh.make_debug_mesh``, ``moe_ffn(mesh=)``,
   ``launch.serve.generate(mesh=)``) through ``flash_attention`` and
   ``grouped_matmul``.  Leg (h): deepseek-v2-lite-16b through
   ``generate(mesh=)`` on a one-rank NCCL mesh (the expert exchange a copy):
   prefill logits and all 16 tokens bit-equal to phase 8's kernel leg, and
   the same launches.  Leg (i): kimi-k2-1t-a32b at full width with its
   depth cut to 2 layers (the dense first layer and one 384-expert MoE
   layer, 39.8 GB in bf16), 4 x 2048 prompts, 16 generated: NCCL at D = 1,
   then two gloo ranks on the one card (this process rank 0; rank 1 maps
   rank 0's weights by CUDA IPC, so the card holds one copy), EP = 2 with
   192 experts a rank, each rank 2 requests; kimi's ``chunk_tokens`` 4096
   cuts D = 1's 8192 prefill tokens into the two ranks' halves, so
   capacities and drops agree and each rank's prefill logits must equal
   D = 1's rows (bit for bit, or within ``MOE_LAYER_TOL``) and its
   gathered tokens D = 1's.  Leg (j): one deepseek MoE layer at full width
   on the same two ranks as mesh (1, 2), TP = 2, within ``MOE_LAYER_TOL``
   of the one-device layer, and as (2, 1), EP = 2, bit-equal to
   ``_moe_core`` on each rank's tokens.  It prints each rank's peak
   allocated memory, each exchange's MB and device ms (CUDA events) by leg
   and kind, the launches by leg and rank, and the phase's seconds;
17. (right after phase 16's clean-up, before the DLRM phase; everything it
   allocates is freed before that phase) the GNN side: graphsage-reddit,
   pna, gatedgcn and meshgraphnet at full width and depth in float32,
   through ``configs.get_arch``, ``models.gnn.init_gnn``, ``gnn_forward``
   and ``gnn_loss``, on the reference's shape cells
   (``configs.common.gnn_cells``): ``full_graph_sm`` (an R-MAT graph of
   2,708 vertices and 10,556 arcs, 1,433 features), ``molecule``
   (``batched_molecule_graphs(128, 30, 128)``, the graph task or
   MeshGraphNet's regression), ``minibatch_lg`` (a reddit-shaped CSR of
   232,965 vertices and 114,615,892 arcs drawn on the card, 1,024 seeds
   sampled 15-10 by ``graph.sampler.sample_neighbors_device``, the hop
   sizes and every id checked against its parent's row; GraphSAGE through
   ``graphsage_minibatch_forward``, the others on the sampled block as an
   edge list of 169,984 vertices and 168,960 arcs, the loss masked to the
   seeds) and, for GraphSAGE only, ``ogb_products`` (2,449,029 vertices,
   61,859,140 arcs drawn on the card).  Each leg is held against a
   float64 copy of the module on the CPU on the same inputs (outputs
   within ``GNN_TOL`` of the largest output, the loss within
   ``GNN_LOSS_TOL``); ``ogb_products`` must be finite and its two runs
   agree within ``GNN_ATOMICS_TOL``.  No leg may launch a kernel of the
   port (the reference aggregates outside Pallas).  It prints each leg's
   forward ms (CUDA events, median of warm runs), loss and peak allocated
   memory beside the least time the card could take (the reference's
   forward flops at 67 TF/s against the per-edge gathers and scatters at
   3.35 TB/s), and the phase's seconds;
18. (right after phase 17, before the DLRM phase; everything it allocates
   is freed before that phase) training on one device, through
   ``repro_torch.train`` on the plain routes (no kernel has a backward, and
   each training leg must launch none of the six).  Leg (a):
   internlm2-1.8b at full width and depth (float32 parameters, bf16
   activations, remat, its AdamW ``OPT`` with warmup cut to 2 steps),
   ``LMBatches`` of 4 x 1025 tokens, 2 microbatches: the first batch's
   microbatched gradients against the unsplit batch's (each leaf within
   ``TRAIN_MB_TOL`` of its largest), then 8 steps through
   ``make_train_step``: seconds a step, tokens/s, 6*N*tokens against 989
   TF/s, ``apply_updates``' ms (CUDA events), the losses (falling) and
   grad norms, peak memory.  Leg (b): internlm2-1.8b at 2 layers in
   float32: the loss and every gradient against a float64 copy on the CPU,
   and one AdamW and one Adafactor update on the card against the CPU in
   float32.  Leg (c): deepseek-v2-lite-16b at 2 layers (a dense and a MoE
   layer) in float32, 3 steps, the aux loss.  Leg (d): the four GNN
   configs on ``full_graph_sm`` and ``molecule``, gradients against
   float64 copies, then the ``torch_train_gnn`` twin (40 steps, a fault at
   20).  Leg (e): the reduced dlrm-mlperf against float64, then 20 steps on
   Zipf ``RecSysBatches``.  Leg (f): the ``torch_train_lm`` twin's MoE with
   int8 compression, 40 steps with checkpoints every 10 and a fault at 20
   against none, under deterministic algorithms: bit-equal; the async save
   and restore times.  Leg (g): the ``torch_quickstart`` twin's SSSP and
   Δ-PageRank on the card, and ``torch_serve_lm`` at its defaults;
19. (right after phase 18, before the DLRM phase; everything it allocates
   is freed before that phase) training past 2048 x 2048 attention scores
   and over a model mesh; no leg may launch a kernel.  Leg (a): the blocked
   attention with its FlashAttention-2 backward (``attention._flash_sdpa``)
   at S = L = 4096, batch 1, on internlm2-1.8b's heads, gemma3-12b's local
   (window 1024) and global layers and deepseek-v2-lite's MLA (keys 192,
   values 128 wide), in float32 and bf16: the output and the three
   gradients against the plain S x S core in float64 on the card (each
   within ``BLOCKED_TOL`` of its largest), its forward+backward ms beside
   the plain core's.  Leg (b): internlm2-1.8b at full width and depth,
   ``lm_loss`` at 4096 positions (train_4k's sequence; its 256 rows cut to
   2), its AdamW ``OPT`` with 2 microbatches and remat: seconds a step
   (median of 2 after a warm-up), tokens/s, 6*N*tokens plus the blocked
   attention's products against 989 TF/s, peak memory, the blocked core's
   calls, and the first batch's loss falling.  Leg (c): internlm2-1.8b at
   full width cut to 2 layers, float32, two steps of the train step on
   DTensor placements (``dist.sharding``) on a (1, 1) NCCL mesh, held to
   the single-device step (losses and grad norms within 1e-5 relative, the
   parameters after the first step within 1e-5 of each leaf's largest;
   two gloo ranks sharing the card crash on DTensor's collectives, so the
   two- and four-rank meshes run across cards, ``profile_port.py
   --train-mesh``).  Leg (d): phase 18 leg (c)'s run (deepseek-v2-lite-16b
   at full width, its dense layer and one MoE layer, float32, the same
   seed and batches) on a (1, 1) NCCL mesh, its MoE layer through
   ``moe.moe_ffn_placed`` and the exchanges' adjoints: the losses, grad
   norms and final parameters bit-equal to leg (c)'s (``MOE_REFERENCE``),
   seconds a step, the peak, the exchanges' device ms (``ExchangeTimer``),
   and the dry run's prediction of the same step on a fake (1, 1) mesh
   (``launch.dryrun``, a CPU subprocess running beside phase 19's legs): its
   argument bytes equal to the leg's state and batch bytes on the card,
   its peak beside the card's;
6. LM serving: the reduced gemma3-12b config on the card against the CPU
   (float32, logits within 1e-4, greedy tokens equal), then gemma3-12b at
   full width (11.8B parameters in bf16, random weights from the seed):
   4 requests of 2048 prompt tokens, prefill plus 15 greedy decode steps
   through ``repro_torch.launch.serve.generate``, once with
   ``use_kernels="auto"`` and once with the plain attention, both on the
   card.  Every launch count is set to 0 before each leg and read after
   it (``generate`` also reads ``flash_attention``'s count between its
   prefill and its decode): the kernel leg must launch ``flash_attention``
   48 times in its prefill (one per layer) and none in its decode, the
   plain leg none, and neither leg a graph kernel.  The two legs'
   last-token logits must agree within a stated bf16 tolerance and their
   first tokens wherever the top-2 margin exceeds it.  It prints prefill
   seconds and tokens/s, decode ms/step and peak memory beside the least
   times the card could take;
7. ``embedding_bag`` against its plain version (right after phase 2's
   ``grouped_matmul`` rows): the bulk serving cell's field shape (a 2^22 x 128 float32 table,
   B = 262,144, L = 1, sum; its library yardstick is
   ``F.embedding_bag``), multi-hot bags of L = 100 by sum, mean and max, a
   bfloat16 table, int64 ids, D = 13, B = 0 and ids that wrap or fall out
   of range (NaN bags);
8. MoE serving, after gemma3-12b is freed: the reduced deepseek-v2-lite-16b
   config on the card against the CPU (float32, logits within 1e-4, greedy
   tokens equal), one full-width MoE layer fed the same hidden states
   through the kernel route and the plain route (a prefill's 8192 tokens
   and a decode step's 4; they route alike and must agree within a stated
   bf16 tolerance), then deepseek-v2-lite-16b at full width (15.7B
   parameters in bf16, random weights from the seed): 4 requests of 2048
   prompt tokens, 16 generated, through ``launch.serve.generate`` with the
   kernels and with the plain routes.  The kernel leg must launch
   ``flash_attention`` 27 times in its prefill and none in its decode, and
   ``grouped_matmul`` 78 times in its prefill and 78 in each decode step;
   the plain leg neither.  The legs' logits must agree within a stated
   bf16 tolerance; the share of (token, k) expert picks that differ
   between the legs in the first and last MoE layers is printed, with
   prefill seconds and tokens/s, decode ms/step, peak memory and host syncs
   beside the least times the card could take.  A third leg (the MoE
   kernels with the plain attention) must pick exactly as the plain leg,
   and each leg's picks are counted against a float32 run of the first
   ``MOE_F32_LAYERS`` layers;
9. DLRM serving, after deepseek-v2-lite-16b is freed: the reduced
   dlrm-mlperf config on the card against the CPU (logits within 1e-4),
   then dlrm-mlperf at
   full width with every table capped at 25M rows (129,066,304 rows, 66.1
   GB of float32 tables, random from the seed; the 64-bit row offsets are
   checked on a capped table's last rows).  Its serving cells serve_p99
   (B = 512) and serve_bulk (B = 262,144) run through
   ``repro_torch.launch.serve.serve_dlrm`` in four legs: the kernel leg
   (``use_kernels="auto"``, the reference's engine picks: 18
   ``embedding_bag`` launches a forward in both cells), the plain leg, and
   both again with every table forced to the gather engine (26 launches a
   forward).  Kernel logits must equal plain logits bit for bit.
   retrieval_cand (one query against 1M candidates, top 100) is checked
   against a plain recomputation.  It prints ms per batch (median of 10
   after a warm-up), samples/s and peak memory beside the least time the
   card could take.

``profile_port.py`` times the same legs in turns and profiles them.

The last line is ``{"ok": true, "device": {...}}``.  The script needs no
network; the kernels build from the sources under ``src/repro_torch`` into
``build/repro_torch``.
"""

from __future__ import annotations

import argparse
import contextlib
import copy
import dataclasses
import functools
import gc
import inspect
import itertools
import json
import math
import os
import pickle
import re
import subprocess
import sys
import time
import traceback
import warnings
import zlib
from pathlib import Path

import numpy as np

ROOT = Path(__file__).resolve().parent
HBM_BYTES_PER_S = 3.35e12  # H100 SXM device memory, NVIDIA's data sheet
L2_BYTES = 50e6            # H100 L2 cache, NVIDIA's data sheet
# H100 SXM dense peaks (NVIDIA's data sheet): bf16 tensor cores, float32 CUDA cores
PEAK_FLOPS = {"bfloat16": 989e12, "float32": 67e12}
REPS = 20
SEED = 0
T0 = time.monotonic()


def log(msg: str) -> None:
    print(f"[{time.monotonic() - T0:7.1f}s] {msg}", flush=True)


def fail(msg: str) -> None:
    raise SystemExit(f"chip_smoke: FAILED: {msg}")


def check(ok: bool, msg: str) -> None:
    if not ok:
        fail(msg)


def call_ms(torch, fn, reps: int = REPS) -> float:
    """Median over ``reps`` of one call issued to an idle device, between
    CUDA events: the call's host work (Python, argument checks,
    allocation) shows as device time when it is longer than the work."""
    for _ in range(3):
        fn()
    times = []
    for _ in range(reps):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end))
    return float(np.median(times))


def graph_ms(torch, fn, calls: int = 10, reps: int = REPS) -> float:
    """Device time of one call: ``calls`` calls captured in a CUDA graph,
    the graph replayed ``reps`` times between CUDA events; the median
    replay over ``calls``.  No host work is in it."""
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        for _ in range(3):
            fn()
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for _ in range(calls):
            fn()
    graph.replay()
    torch.cuda.synchronize()
    times = []
    for _ in range(reps):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        graph.replay()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end) / calls)
    return float(np.median(times))


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


def launch_split(torch, fn, calls: int = REPS) -> dict:
    """Device µs of each kernel that one call of ``fn`` launches, by kernel
    name: the mean over ``calls`` eager calls under ``torch.profiler``."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(calls):
            fn()
        torch.cuda.synchronize()
    return {re.sub(r"^void |\(.*$", "", e.key.replace("(anonymous namespace)::", "")):
            e.self_device_time_total / calls
            for e in prof.key_averages() if e.device_type == DeviceType.CUDA}


def host_syncs(torch, call) -> dict:
    """Host syncs that ``call`` issues, counted by PyTorch's sync debug mode,
    by the port's source line that issued them (a sync with no frame of the
    port: its line, and the innermost caller outside PyTorch)."""
    found = {}

    def record(message, category, filename, lineno, file=None, line=None):
        stack = traceback.extract_stack()[:-1]
        frames = [f for f in stack if "repro_torch" in f.filename]
        if frames:
            where = f"{frames[-1].filename.split('src/')[-1]}:{frames[-1].lineno}"
        else:
            outer = [f for f in stack if f"{os.sep}torch{os.sep}" not in f.filename
                     and not f.filename.endswith("warnings.py")]
            where = f"{filename}:{lineno}" + "".join(
                f" from {Path(f.filename).name}:{f.lineno} ({f.name})" for f in outer[-1:])
        found[where] = found.get(where, 0) + 1

    torch.cuda.synchronize()
    with warnings.catch_warnings():
        warnings.simplefilter("always")
        warnings.showwarning = record
        torch.cuda.set_sync_debug_mode("warn")
        try:
            call()
        finally:
            torch.cuda.set_sync_debug_mode("default")
    return found


def cold_ms(torch, fn, make_args, set_bytes: float, reps: int = REPS) -> float:
    """Device time of one call on a cold L2: ``graph_ms`` over one call on
    each of ``n`` copies of the arguments (``make_args()`` each), every
    call's output kept alive, with ``n`` such that the other copies touch
    more than three L2s (``set_bytes`` each: the inputs a call reads and
    the output it writes) between two uses of one copy."""
    n = max(3, math.ceil(3 * L2_BYTES / set_bytes) + 1)
    sets = itertools.cycle([make_args() for _ in range(n)])
    outs = []
    ms = graph_ms(torch, lambda: outs.append(fn(*next(sets))), calls=n, reps=reps)
    del outs, sets
    return ms


def offset_copy(torch, t):
    """A copy of the 1-D ``t`` at the same offset from a 16-byte boundary
    (the main path's blocks are views at a partition's first edge)."""
    off = (t.data_ptr() % 16) // t.element_size()
    big = torch.empty(t.shape[0] + off, dtype=t.dtype, device=t.device)
    big[off:] = t
    return big[off:]


def bound_ms(n_bytes: float) -> float:
    return n_bytes / HBM_BYTES_PER_S * 1e3


# ---------------------------------------------------------------------------
# Phase 2: kernels against their plain versions
# ---------------------------------------------------------------------------

def phase_kernels(torch, rt, seed: int) -> dict:
    """The three graph kernels against their plain versions on a main-path
    block (partition 0's edges, 30% of the lanes active), then their times:
    warm (one argument set replayed, L2-resident: the min set is about 25 MB
    and the sum set 46 MB) and cold (``cold_ms``), one call from the host,
    the plain version's and one library call's.  ``segment_spmm`` min and
    sum are also timed on the last partition's block, whose ids are a view
    at an unaligned offset."""
    from repro_torch.kernels.frontier_compact.ops import frontier_compact
    from repro_torch.kernels.frontier_compact.ref import frontier_compact_ref
    from repro_torch.kernels.hyb_gather.ops import PAD, hyb_gather
    from repro_torch.kernels.hyb_gather.ref import hyb_gather_ref
    from repro_torch.kernels.segment_spmm.ops import segment_spmm
    from repro_torch.kernels.segment_spmm.ref import segment_spmm_ref

    dev = rt.device
    n = rt.csr.n_nodes
    _, edge_start, part_edges = rt.parts.host
    # the main path's block: partition 0's edges (the hub partition), as
    # many lanes as it has edges
    B = part_edges[0]
    gen = torch.Generator(device=dev)
    gen.manual_seed(seed)
    dst = rt.csr.edge_dst[:B].contiguous()
    src = rt.csr.edge_src[:B].contiguous()
    w = rt.csr.edge_weight[:B].contiguous()
    active = torch.rand(B, device=dev, generator=gen) < 0.3
    rows = {}

    def timed(kernel, plain, library, make_args, set_bytes, library_by_call=False, **row):
        """The row's times: ``kernel``, ``plain`` and ``library`` take the
        arguments ``make_args()`` returns."""
        args = make_args()
        row.update(
            ms=graph_ms(torch, lambda: kernel(*args)),
            call_ms=call_ms(torch, lambda: kernel(*args)),
            host_us=host_us(torch, lambda: kernel(*args)),
            cold_ms=cold_ms(torch, kernel, make_args, set_bytes),
            plain_ms=graph_ms(torch, lambda: plain(*args)),
            # boolean-mask indexing reads its output size back to the host,
            # so it cannot be captured in a graph: timed as one call
            library_ms=(call_ms if library_by_call else graph_ms)(torch, lambda: library(*args)),
            bound_ms=bound_ms(set_bytes), bound_by="bytes",
            # for phase_graph_profiles, which runs the profiler after
            # every host timing of the graph
            call=lambda: kernel(*args))
        return row

    # -- segment_spmm, min (SSSP's FILTER combine: d=1, n_segments=n)
    msg = torch.where(active, torch.rand(B, device=dev, generator=gen) * 100.0 + 1.0,
                      float("inf"))
    msg[:3] = torch.tensor([float("-inf"), -0.0, -3.5], device=dev)
    k = segment_spmm(msg, dst, n, combine="min")
    p = segment_spmm_ref(msg[:, None], dst, n, combine="min")[:, 0]
    check(torch.equal(k.view(torch.int32), p.view(torch.int32)),
          "segment_spmm min differs from its plain version (bits, signs included)")

    # the arguments: messages, ids and the ids as int64 for the library call
    def spmm_min(m_, d_, d64):
        return segment_spmm(m_, d_, n, combine="min")

    def spmm_min_plain(m_, d_, d64):
        return segment_spmm_ref(m_[:, None], d_, n, combine="min")

    def spmm_min_library(m_, d_, d64):
        return torch.full((n,), float("inf"), device=dev).scatter_reduce_(0, d64, m_, "amin")

    rows["segment_spmm"] = timed(
        spmm_min, spmm_min_plain, spmm_min_library,
        lambda: (msg.clone(), dst.clone(), dst.long()),
        B * 4 + B * 4 + n * 4, max_abs_err=0.0, shape=f"min m={B} d=1 n_segments={n}",
        replaces="src/repro/kernels/segment_spmm/segment_spmm.py:113",
        source="src/repro_torch/kernels/segment_spmm/csrc/segment_spmm.cu")
    # the last (non-hub) partition's block, its ids a view at the
    # partition's first edge, as the sweep passes them
    last = len(part_edges) - 1
    start = edge_start[last]
    m_last = min(part_edges[last], B)
    dst_last = rt.csr.edge_dst[start:start + m_last]
    active_last = active[:m_last]
    msg_last = torch.where(active_last, msg[:m_last], float("inf"))
    check(torch.equal(spmm_min(msg_last, dst_last, None).view(torch.int32),
                      spmm_min_plain(msg_last, dst_last, None)[:, 0].view(torch.int32)),
          "segment_spmm min (last partition) differs from its plain version")
    rows["segment_spmm_last"] = timed(
        spmm_min, spmm_min_plain, spmm_min_library,
        lambda: (msg_last.clone(), offset_copy(torch, dst_last), dst_last.long()),
        m_last * 4 + m_last * 4 + n * 4,
        max_abs_err=0.0, shape=f"min m={m_last} d=1 n_segments={n}, partition {last} (ids at "
        f"edge {start}, {start % 4} words past a 16-byte boundary; "
        f"{int(active_last.sum())} lanes active)")
    # ±0 and ±inf, each in a segment of its own: signs must survive
    ids = torch.arange(6, dtype=torch.int32, device=dev)
    vals = torch.tensor([0.0, -0.0, float("inf"), float("-inf"), 1.0, -1.0], device=dev)
    k = segment_spmm(vals, ids, 8, combine="min")
    check(torch.equal(torch.signbit(k), torch.signbit(segment_spmm_ref(vals[:, None], ids, 8, combine="min")[:, 0]))
          and torch.equal(k[6:], torch.full((2,), float("inf"), device=dev)),
          "segment_spmm min: signed zeros / empty segments")

    # -- segment_spmm, sum (PageRank's FILTER combine: packed [msg, active])
    pmsg = torch.where(active, torch.rand(B, device=dev, generator=gen) * 1e-3, 0.0)
    packed = torch.stack([pmsg, active.to(torch.float32)], dim=-1)
    k = segment_spmm(packed, dst, n)
    p = segment_spmm_ref(packed, dst, n)
    check(torch.equal(k[:, 1], p[:, 1]), "segment_spmm sum: count column not exact")
    # float atomics add in another order than index_add_: rtol 1e-4 covers
    # the reassociation of up to ~1e5 terms of one sign
    check(torch.allclose(k[:, 0], p[:, 0], rtol=1e-4, atol=1e-9),
          "segment_spmm sum outside rtol=1e-4")
    def spmm_sum(m_, d_):
        return segment_spmm(m_, d_, n)

    def spmm_sum_plain(m_, d_):
        return segment_spmm_ref(m_, d_, n)

    def spmm_sum_library(m_, d_):
        return torch.zeros((n, 2), device=dev).index_add_(0, d_, m_)

    rows["segment_spmm_sum"] = timed(
        spmm_sum, spmm_sum_plain, spmm_sum_library, lambda: (packed.clone(), dst.clone()),
        B * 8 + B * 4 + n * 8, max_abs_err=float((k[:, 0] - p[:, 0]).abs().max()),
        shape=f"sum m={B} d=2 n_segments={n}")
    # the sum on the last partition's block too
    packed_last = torch.stack([torch.where(active_last, pmsg[:m_last], 0.0),
                               active_last.to(torch.float32)], dim=-1)
    k = spmm_sum(packed_last, dst_last)
    p = spmm_sum_plain(packed_last, dst_last)
    check(torch.equal(k[:, 1], p[:, 1]) and torch.allclose(k[:, 0], p[:, 0], rtol=1e-4, atol=1e-9),
          "segment_spmm sum (last partition) differs from its plain version")
    rows["segment_spmm_sum_last"] = timed(
        spmm_sum, spmm_sum_plain, spmm_sum_library,
        lambda: (packed_last.clone(), offset_copy(torch, dst_last)),
        m_last * 8 + m_last * 4 + n * 8, max_abs_err=float((k[:, 0] - p[:, 0]).abs().max()),
        shape=f"sum m={m_last} d=2 n_segments={n}, partition {last}")
    # m == 0 and a valid mask
    empty = segment_spmm(torch.empty((0, 2), device=dev),
                         torch.empty(0, dtype=torch.int32, device=dev), 5)
    check(torch.equal(empty, torch.zeros((5, 2), device=dev)), "segment_spmm m=0")
    valid = torch.rand(B, device=dev, generator=gen) < 0.5
    check(torch.equal(segment_spmm(msg, dst, n, valid=valid, combine="min"),
                      segment_spmm_ref(msg[:, None], dst, n, valid=valid, combine="min")[:, 0]),
          "segment_spmm min with a valid mask")

    # -- frontier_compact (COMPACT: the block's four columns, mask = active)
    cols = (src, dst, w, active)
    for name, mask in (("random", active), ("empty", torch.zeros_like(active)),
                       ("full", torch.ones_like(active))):
        out, cnt = frontier_compact(cols, mask)
        ref_out, ref_cnt = frontier_compact_ref(cols, mask)
        check(int(cnt) == int(ref_cnt) and all(map(torch.equal, out, ref_out)),
              f"frontier_compact ({name} mask) differs from its plain version")
    out, cnt = frontier_compact(tuple(c[:0] for c in cols), active[:0])
    check(int(cnt) == 0 and all(o.shape == (0,) for o in out), "frontier_compact m=0")
    row_bytes = 4 + 4 + 4 + 1

    def words_of(c):
        """The library yardstick's input: the rows packed into one (B, 4)
        array (boolean-mask indexing writes the kept rows only)."""
        return torch.stack([c[0], c[1], c[2].view(torch.int32), c[3].to(torch.int32)], dim=-1)

    def compact_args():
        c = tuple(t.clone() for t in cols)
        return c, words_of(c)

    rows["frontier_compact"] = timed(
        lambda c, words: frontier_compact(c, c[3]), lambda c, words: frontier_compact_ref(c, c[3]),
        lambda c, words: words[c[3]], compact_args, 2 * B * row_bytes + 4, library_by_call=True, max_abs_err=0.0,
        shape=f"m={B} columns=(i32, i32, f32, bool) kept={int(active.sum())}",
        replaces="src/repro/kernels/frontier_compact/frontier_compact.py:62",
        source="src/repro_torch/kernels/frontier_compact/csrc/frontier_compact.cu")

    # -- hyb_gather (ZEROCOPY: the block's four columns as PAD-lane windows)
    n_win = -(-B // PAD)
    starts = torch.arange(0, n_win * PAD, PAD, dtype=torch.int32, device=dev)
    degs = torch.clamp(B - starts, max=PAD)
    k = hyb_gather(cols, starts, degs)
    check(all(map(torch.equal, k, hyb_gather_ref(cols, starts, degs))),
          "hyb_gather differs from its plain version")
    # random windows: starts past the end, degrees over PAD, degree 0
    rs = torch.randint(-5, B + 200, (512,), dtype=torch.int32, device=dev, generator=gen)
    rd = torch.randint(0, 2 * PAD, (512,), dtype=torch.int32, device=dev, generator=gen)
    check(all(map(torch.equal, hyb_gather(cols, rs, rd), hyb_gather_ref(cols, rs, rd))),
          "hyb_gather (random windows) differs from its plain version")
    check(all(o.shape == (0, PAD) for o in hyb_gather(cols, starts[:0], degs[:0])),
          "hyb_gather a=0")
    lane = torch.arange(PAD, device=dev)
    idx = starts.long()[:, None] + lane
    idx = torch.where(lane < degs.long()[:, None], idx, B)

    def gather_args():
        c = tuple(t.clone() for t in cols)
        # advanced indexing of the rows packed into one (B + 1, 4) array
        words = words_of(c)
        return c, torch.cat([words, words.new_zeros((1, 4))])

    rows["hyb_gather"] = timed(
        lambda c, padded: hyb_gather(c, starts, degs),
        lambda c, padded: hyb_gather_ref(c, starts, degs), lambda c, padded: padded[idx],
        gather_args, int(degs.sum()) * row_bytes + n_win * 8 + n_win * PAD * row_bytes,
        max_abs_err=0.0, shape=f"a={n_win} columns=(i32, i32, f32, bool) of {B}",
        replaces="src/repro/kernels/hyb_gather/hyb_gather.py:42",
        source="src/repro_torch/kernels/hyb_gather/csrc/hyb_gather.cu")
    for name, r in rows.items():
        log(f"kernel {name}: {r['shape']} ms={r['ms']:.4f} (warm) cold_ms={r['cold_ms']:.4f} "
            f"call_ms={r['call_ms']:.4f} host_us={r['host_us']:.1f} plain_ms={r['plain_ms']:.4f} "
            f"library_ms={r['library_ms']:.4f} "
            f"bound_ms={r['bound_ms']:.4f} max_abs_err={r['max_abs_err']:.3g}")
    return rows


def ptxas_report(stems=("segment_spmm", "frontier_compact")) -> dict:
    """Registers and spills of every kernel of ``stems``, as ptxas reported
    them when the kernels were built (``-Xptxas=-v``); no kernel may spill."""
    from repro_torch.kernels.runtime import ptxas_resources

    report = {}
    for stem in stems:
        fns = report[stem] = ptxas_resources(stem)
        regs = [f["registers"] for f in fns]
        spills = sum(f["spill_stores"] + f["spill_loads"] for f in fns)
        # the kernel's name in the mangled one (its template arguments follow)
        names = [re.search(r"\d+([A-Za-z_]*kernel)", f["name"]).group(1) for f in fns]
        log(f"ptxas {stem}: {len(fns)} kernels, {min(regs)}-{max(regs)} registers a thread, "
            f"{spills} bytes of spill stores and loads: "
            + ", ".join(f"{n} {f['registers']}" for n, f in zip(names, fns)))
        check(spills == 0, f"{stem}: a kernel spills registers")
    return report


# ---------------------------------------------------------------------------
# Phase 2b: flash_attention against its plain version
# ---------------------------------------------------------------------------

# name: (B*H, S, L, dh, kv_groups, window, causal, dtype).  The first two are
# gemma3-12b's prefill at 4 x 2048 tokens: 16 query heads over 8 kv heads,
# dh 256, a local (window 1024) and a global layer; the third is
# deepseek-v2-lite's MLA prefill (16 heads, q and k 192 wide, values 128
# wide, as ``mla_attention`` passes them); the rest are edge cases.
FLASH_ROWS = {
    "gemma3_local": (64, 2048, 2048, 256, 2, 1024, True, "bfloat16"),
    "gemma3_global": (64, 2048, 2048, 256, 2, 0, True, "bfloat16"),
    "deepseek_mla": (64, 2048, 2048, 192, 1, 0, True, "bfloat16"),
    "s257": (8, 257, 257, 256, 2, 0, True, "bfloat16"),
    "dh128_f32_kv1": (16, 1000, 1000, 128, 1, 64, True, "float32"),
    "window1": (8, 300, 300, 64, 1, 1, True, "bfloat16"),
    "noncausal_f32": (8, 200, 333, 64, 2, 0, False, "float32"),
}
# the value width of a row whose values are narrower than its keys
FLASH_DV = {"deepseek_mla": 128}


def attention_pairs(S: int, L: int, window: int, causal: bool) -> int:
    """The (query, key) pairs the masks keep."""
    q = np.arange(S)
    hi = np.minimum(L, q + 1) if causal else np.full(S, L)
    lo = np.maximum(0, q - window + 1) if window > 0 else np.zeros(S, dtype=np.int64)
    return int(np.maximum(hi - lo, 0).sum())


def flash_bound(bh, S, L, dh, g, window, causal, dtype, dv=None) -> tuple[float, str, float]:
    """(bound ms, what bounds it, flops): 2 * (dh + dv) flops per kept pair
    (q.k and p.v) at the type's peak, against one read of q, k, v and one
    write of o, with values ``dv`` wide (default dh)."""
    dv = dh if dv is None else dv
    flops = 2.0 * (dh + dv) * attention_pairs(S, L, window, causal) * bh
    size = 2 if dtype == "bfloat16" else 4
    n_bytes = size * ((dh + dv) * bh * S + (dh + dv) * (bh // g) * L)
    t_ops, t_bytes = flops / PEAK_FLOPS[dtype] * 1e3, bound_ms(n_bytes)
    return max(t_ops, t_bytes), "operations" if t_ops >= t_bytes else "bytes", flops


def kernel_resources() -> dict:
    """The bf16 wgmma kernels' resources from ``cudaFuncGetAttributes``:
    registers a thread at launch (the consumer warpgroups of the 384-thread
    kernels raise theirs to 232 with setmaxnreg), local memory a thread
    (spills), dynamic shared memory and threads a block."""
    import ctypes

    from repro_torch.kernels.flash_attention.ops import BF16_WIDTHS
    from repro_torch.kernels.runtime import load_kernel

    keys = ("registers", "local_bytes", "dynamic_smem_bytes", "threads")
    out_t = ctypes.POINTER(ctypes.c_int)
    flash = load_kernel("flash_attention", "flash_attention_bf16_attributes",
                        [ctypes.c_int, ctypes.c_int, out_t])
    gmm = load_kernel("grouped_matmul", "grouped_matmul_bf16_attributes", [ctypes.c_int, out_t])
    calls = {f"flash_attention bf16 dh={dh} dv={dv}": (flash, (dh, dv))
             for dh, dv in BF16_WIDTHS}
    calls.update({"grouped_matmul bf16 prefill tiles": (gmm, (0,)),
                  "grouped_matmul bf16 decode tiles": (gmm, (1,))})
    res = {}
    for name, (fn, args) in calls.items():
        buf = (ctypes.c_int * 4)()
        rc = fn(*args, buf)
        check(rc == 0, f"{name}: cudaFuncGetAttributes failed ({rc})")
        res[name] = r = dict(zip(keys, buf))
        log(f"resources {name}: {r['registers']} registers a thread at launch, "
            f"{r['local_bytes']} bytes of local memory (spills) a thread, "
            f"{r['dynamic_smem_bytes']} bytes of dynamic shared memory, {r['threads']} threads")
    return res


def phase_flash(torch, dev, seed: int) -> dict:
    import torch.nn.functional as F

    from repro_torch.kernels.flash_attention.ops import flash_attention
    from repro_torch.kernels.flash_attention.ref import flash_attention_ref

    gen = torch.Generator(device=dev)
    gen.manual_seed(seed)
    rows = {}
    for name, (bh, S, L, dh, g, window, causal, dtype) in FLASH_ROWS.items():
        dt = getattr(torch, dtype)
        dv = FLASH_DV.get(name, dh)
        q, k, v = (torch.randn(shape, generator=gen, device=dev).to(dt)
                   for shape in ((bh, S, dh), (bh // g, L, dh), (bh // g, L, dv)))
        scale = 1.0 / dh ** 0.5

        def kernel():
            return flash_attention(q, k, v, scale, window, causal, g)

        def plain():
            return flash_attention_ref(q, k, v, scale, window, causal, g)

        got, want = kernel(), plain()
        torch.cuda.synchronize()
        # float32: the same sums in another order; bfloat16: one rounding of
        # the output (2^-8 relative) on values of magnitude up to ~4, and the
        # kernel's bf16 probabilities against the plain version's float32
        tol = 2e-5 if dtype == "float32" else 2e-2
        err = float((got.float() - want.float()).abs().max())
        check(got.shape == (bh, S, dv) and bool(torch.isfinite(got).all()) and bool(
            ((got.float() - want.float()).abs() <= tol + tol * want.float().abs()).all()),
            f"flash_attention {name} differs from its plain version (max |err| {err:.3g})")
        # the yardstick: SDPA over q, k, v as (B, H, S, dh), with k and v
        # expanded to the query heads once, outside the timing (its fused
        # backends take no GQA map with a mask)
        q4 = q.view(bh // 16 if bh % 16 == 0 else 1, -1, S, dh)
        k4, v4 = (t[:, None].expand(bh // g, g, L, t.shape[-1])
                  .reshape(q4.shape[0], -1, L, t.shape[-1]).contiguous() for t in (k, v))
        qp, kp = torch.arange(S, device=dev)[:, None], torch.arange(L, device=dev)[None]
        mask = (qp >= kp) if causal else torch.ones((S, L), dtype=torch.bool, device=dev)
        if window > 0:
            mask = mask & (qp - kp < window)

        def library():
            if causal and window == 0 and S == L:
                return F.scaled_dot_product_attention(q4, k4, v4, is_causal=True, scale=scale)
            return F.scaled_dot_product_attention(q4, k4, v4, attn_mask=mask, scale=scale)

        lib_err = float((library().reshape(bh, S, dv).float() - want.float()).abs().max())
        big = S * L > 2**20
        calls, reps = (3, 10) if big else (10, REPS)
        bound, bound_by, flops = flash_bound(bh, S, L, dh, g, window, causal, dtype, dv)
        rows[name] = r = dict(
            shape=f"q ({bh}, {S}, {dh}) {dtype}, L={L}, kv_groups={g}, window={window}, "
                  f"causal={causal}" + (f", values {dv} wide" if dv < dh else ""),
            max_abs_err=err, library_max_abs_err=lib_err,
            ms=graph_ms(torch, kernel, calls, reps), call_ms=call_ms(torch, kernel, reps),
            plain_ms=graph_ms(torch, plain, calls, reps),
            library_ms=graph_ms(torch, library, calls, reps),
            bound_ms=bound, bound_by=bound_by, gflop=flops / 1e9)
        r["tflops"] = flops / (r["ms"] * 1e-3) / 1e12
        log(f"kernel flash_attention {name}: {r['shape']} ms={r['ms']:.4f} "
            f"call_ms={r['call_ms']:.4f} plain_ms={r['plain_ms']:.4f} "
            f"library_ms={r['library_ms']:.4f} bound_ms={r['bound_ms']:.4f} ({bound_by}, "
            f"{r['gflop']:.1f} GFLOP, {r['tflops']:.2f} TFLOP/s) max_abs_err={err:.3g} "
            f"(SDPA {lib_err:.3g})")
        del q, k, v, q4, k4, v4, got, want
    torch.cuda.empty_cache()
    return rows


# ---------------------------------------------------------------------------
# Phase 2c: grouped_matmul against its plain version
# ---------------------------------------------------------------------------

# name: (assignments T, D, F, capacity C).  deepseek-v2-lite's MoE layer at
# the main path's shapes: a prefill of 4 x 2048 tokens (T*K = 49,152, C = 960)
# through the gate or up weights and through the down weights, and a
# decode step of 4 tokens (24 rows, C = 8).  64 experts, bf16.
GMM_E = 64
GMM_ROWS = {
    "prefill_gate_up": (49_152, 2048, 1408, 960),
    "prefill_down": (49_152, 1408, 2048, 960),
    "decode_gate_up": (24, 2048, 1408, 8),
}


def gmm_groups(torch, gen, dev, T: int, E: int, C: int):
    """(starts, counts) int32 of the MoE layout: T assignments drawn
    uniformly over E experts, each expert's count capped at C, groups packed
    from row 0 (the rows of dropped assignments follow the last group)."""
    drawn = torch.multinomial(torch.full((E,), 1.0 / E, device=dev), T, replacement=True,
                              generator=gen)
    counts = torch.zeros(E, dtype=torch.int32, device=dev).index_add_(
        0, drawn, torch.ones(T, dtype=torch.int32, device=dev)).clamp_(max=C)
    return (torch.cumsum(counts, 0, dtype=torch.int32) - counts).contiguous(), counts


def gmm_bound(counts, T: int, D: int, F: int, dtype: str) -> tuple[float, str, float]:
    """(bound ms, what bounds it, flops) of one launch on this data: 2 * D *
    F flops a grouped row at the type's peak, against one read of the
    grouped rows and of the active experts' weights, and one write of the
    (T, F) output."""
    rows, active = int(counts.sum()), int((counts > 0).sum())
    size = 2 if dtype == "bfloat16" else 4
    flops = 2.0 * rows * D * F
    n_bytes = size * (rows * D + active * D * F + T * F) + 8 * counts.numel()
    t_ops, t_bytes = flops / PEAK_FLOPS[dtype] * 1e3, bound_ms(n_bytes)
    return max(t_ops, t_bytes), "operations" if t_ops >= t_bytes else "bytes", flops


def gmm_check(torch, name: str, got, want, starts, counts, max_rows, tol) -> float:
    """The kernel's output against the plain version's within ``tol`` (rtol,
    atol), rows outside every group exactly 0; returns the max |err|."""
    check(got.shape == want.shape and got.dtype == want.dtype,
          f"grouped_matmul {name}: {tuple(got.shape)} {got.dtype} against "
          f"{tuple(want.shape)} {want.dtype}")
    diff = (got.float() - want.float()).abs()
    err = float(diff.max()) if diff.numel() else 0.0
    inside = torch.zeros(got.shape[0], dtype=torch.bool, device=got.device)
    rows = counts.clamp(max=max_rows)
    for st, n in zip(starts.tolist(), rows.tolist()):
        inside[st:st + n] = True
    check(bool((diff <= tol[1] + tol[0] * want.float().abs()).all())
          and not bool(got[~inside].any()),
          f"grouped_matmul {name} differs from its plain version (max |err| {err:.3g})")
    return err


def phase_grouped_matmul(torch, dev, seed: int) -> dict:
    from repro_torch.kernels.grouped_matmul.ops import grouped_matmul
    from repro_torch.kernels.grouped_matmul.ref import grouped_matmul_ref

    gen = torch.Generator(device=dev)
    gen.manual_seed(seed)
    rows = {}
    # bf16: both sum float32 products and round once, in another order: one
    # bf16 step (2^-8 relative) apart at most, on sums of 2048 products
    bf16_tol = (2**-7, 1e-4)
    for name, (T, D, F, C) in GMM_ROWS.items():
        x = torch.randn((T, D), generator=gen, device=dev).bfloat16()
        w = torch.randn((GMM_E, D, F), generator=gen, device=dev).div_(D ** 0.5).bfloat16()
        starts, counts = gmm_groups(torch, gen, dev, T, GMM_E, C)
        before = grouped_matmul.launches
        got = grouped_matmul(x, w, starts, counts, C)
        check(grouped_matmul.launches == before + 1, "grouped_matmul did not launch")
        torch.cuda.synchronize()
        err = gmm_check(torch, name, got, grouped_matmul_ref(x, w, starts, counts, C),
                        starts, counts, C, bf16_tol)
        # the yardsticks: the reference's own formulation (one bmm over the
        # capacity-padded (E, C, D) buffer), and PyTorch's grouped product
        # over the packed groups where the installed torch has it
        buf = torch.randn((GMM_E, C, D), generator=gen, device=dev).bfloat16()
        offs = torch.cumsum(counts, 0, dtype=torch.int32)
        library = {"torch.bmm (E, C, D) capacity buffer":
                   graph_ms(torch, lambda: torch.bmm(buf, w))}
        try:
            library["torch._grouped_mm"] = graph_ms(
                torch, lambda: torch._grouped_mm(x, w, offs=offs))
        except (AttributeError, RuntimeError) as e:
            log(f"kernel grouped_matmul {name}: torch._grouped_mm did not run ({e})")
        lib_name = "torch._grouped_mm" if "torch._grouped_mm" in library else \
            "torch.bmm (E, C, D) capacity buffer"
        bound, bound_by, flops = gmm_bound(counts, T, D, F, "bfloat16")
        rows[name] = r = dict(
            shape=f"x ({T}, {D}) bf16 x w ({GMM_E}, {D}, {F}), C={C}, "
                  f"{int(counts.sum())} rows in {int((counts > 0).sum())} groups",
            max_abs_err=err, ms=graph_ms(torch, lambda: grouped_matmul(x, w, starts, counts, C)),
            call_ms=call_ms(torch, lambda: grouped_matmul(x, w, starts, counts, C)),
            # the plain version reads the groups to the host: one call, timed
            plain_ms=call_ms(torch, lambda: grouped_matmul_ref(x, w, starts, counts, C), 5),
            library_ms=library[lib_name], library=lib_name, library_all=library,
            bound_ms=bound, bound_by=bound_by, gflop=flops / 1e9)
        r["tflops"] = flops / (r["ms"] * 1e-3) / 1e12
        log(f"kernel grouped_matmul {name}: {r['shape']} ms={r['ms']:.4f} "
            f"call_ms={r['call_ms']:.4f} plain_ms={r['plain_ms']:.4f} library_ms="
            f"{r['library_ms']:.4f} ({lib_name}; {library}) bound_ms={bound:.4f} ({bound_by}, "
            f"{r['gflop']:.1f} GFLOP, {r['tflops']:.2f} TFLOP/s) max_abs_err={err:.3g}")
        del x, w, buf, got

    # edge rows: F not a multiple of 64 and odd D (scalar loads), E = 1, empty
    # experts, rows outside every group and groups past max_rows, float32
    # (CUDA-core FMAs, no TF32: the same sums in another order), T = 0
    for name, (T, D, E, F, C, dtype) in {
            "odd_f32": (3000, 130, 7, 100, 700, "float32"),
            "odd_bf16": (3000, 33, 7, 65, 300, "bfloat16"),
            "one_expert": (500, 256, 1, 192, 500, "bfloat16"),
            "float32_main": (4096, 2048, 64, 1408, 64, "float32")}.items():
        dt = getattr(torch, dtype)
        x = torch.randn((T, D), generator=gen, device=dev).to(dt)
        w = torch.randn((E, D, F), generator=gen, device=dev).div_(D ** 0.5).to(dt)
        starts, counts = gmm_groups(torch, gen, dev, T * 3 // 4, E, 2 * C)
        if E > 1:
            counts[::3] = 0     # empty experts, whose rows fall outside every group
        tol = (1e-5, 1e-5) if dtype == "float32" else bf16_tol
        for bound_rows in (C, 2 * C):
            gmm_check(torch, name, grouped_matmul(x, w, starts, counts, bound_rows),
                      grouped_matmul_ref(x, w, starts, counts, bound_rows), starts, counts,
                      bound_rows, tol)
        if name == "float32_main":
            rows[name] = dict(shape=f"x ({T}, {D}) float32 x w ({E}, {D}, {F}), C={C}",
                              ms=graph_ms(torch, lambda: grouped_matmul(x, w, starts, counts, C)),
                              gflop=2.0 * int(counts.clamp(max=C).sum()) * D * F / 1e9)
    before = grouped_matmul.launches
    empty = grouped_matmul(x[:0], w, starts, counts, C)
    check(empty.shape == (0, F) and grouped_matmul.launches == before,
          "grouped_matmul T=0: shape or launch")
    log("kernel grouped_matmul edge rows: odd D and F in float32 and bf16, one expert, empty "
        "experts, rows outside every group, groups cut at max_rows, float32 at the main "
        f"widths ({rows['float32_main']['ms']:.4f} ms for {rows['float32_main']['gflop']:.1f} "
        "GFLOP), T=0: all held")
    del x, w
    torch.cuda.empty_cache()
    return rows


# ---------------------------------------------------------------------------
# Phase 7: embedding_bag against its plain version
# ---------------------------------------------------------------------------

EB_ROWS_LOG2, EB_DIM, EB_BULK = 22, 128, 262_144


def bag_bytes(B: int, L: int, D: int, esize: int, id_size: int = 4) -> int:
    """Each looked-up row read once, each bag written once, the ids read once."""
    return B * L * D * esize + B * D * esize + B * L * id_size


def bag_err(torch, name: str, got, want, rtol: float = 0.0, atol: float = 0.0) -> float:
    """Check the kernel's bags against the plain version's: NaN in the same
    places, the rest within ``atol + rtol * |want|`` (exact when both are
    0); returns the largest |difference|."""
    check(got.shape == want.shape and got.dtype == want.dtype,
          f"embedding_bag {name}: {tuple(got.shape)} {got.dtype} against "
          f"{tuple(want.shape)} {want.dtype}")
    nan = torch.isnan(want)
    check(torch.equal(torch.isnan(got), nan), f"embedding_bag {name}: NaN bags differ")
    diff = (got.float() - want.float()).abs().nan_to_num(0.0)
    ok = bool((diff <= atol + rtol * want.float().abs().nan_to_num(0.0)).all())
    err = float(diff.max()) if diff.numel() else 0.0
    check(ok, f"embedding_bag {name} differs from its plain version (max |err| {err:.3g})")
    return err


def phase_embedding_bag(torch, dev, seed: int) -> dict:
    import torch.nn.functional as F

    from repro_torch.kernels.embedding_bag.ops import embedding_bag
    from repro_torch.kernels.embedding_bag.ref import embedding_bag_ref

    gen = torch.Generator(device=dev)
    gen.manual_seed(seed)
    V, D = 2**EB_ROWS_LOG2, EB_DIM
    table = torch.randn((V, D), generator=gen, device=dev).div_(D ** 0.5)
    rows = {}

    def timed(name, t, ids, mode, err, shape):
        B, L = ids.shape
        r = rows[name] = dict(
            shape=shape, max_abs_err=err,
            ms=graph_ms(torch, lambda: embedding_bag(t, ids, mode)),
            call_ms=call_ms(torch, lambda: embedding_bag(t, ids, mode)),
            plain_ms=graph_ms(torch, lambda: embedding_bag_ref(t, ids, mode)),
            # one PyTorch call of the same function on in-range ids
            library_ms=graph_ms(torch, lambda: F.embedding_bag(ids, t, mode=mode)),
            bound_ms=bound_ms(bag_bytes(B, L, D, t.element_size(), ids.element_size())),
            bound_by="bytes")
        log(f"kernel embedding_bag {name}: {shape} ms={r['ms']:.4f} call_ms={r['call_ms']:.4f} "
            f"plain_ms={r['plain_ms']:.4f} "
            f"library_ms={r['library_ms']:.4f} (F.embedding_bag) bound_ms={r['bound_ms']:.4f} "
            f"(bytes) max_abs_err={err:.3g}")

    # -- the bulk cell's field: B = 262,144 one-hot bags of a 2^22-row table,
    # 2.1 GB, far beyond the 50 MB L2; a bag of one row is copied exactly
    ids = torch.randint(0, V, (EB_BULK, 1), generator=gen, device=dev, dtype=torch.int32)
    before = embedding_bag.launches
    got = embedding_bag(table, ids, "sum")
    check(embedding_bag.launches == before + 1, "embedding_bag did not launch")
    torch.cuda.synchronize()
    err = bag_err(torch, "bulk", got, embedding_bag_ref(table, ids, "sum"))
    check(torch.equal(got, table[ids[:, 0].long()]), "embedding_bag bulk: not the table's rows")
    timed("bulk", table, ids, "sum", err,
          f"sum V=2^{EB_ROWS_LOG2} D={D} float32, B={EB_BULK} L=1 int32")
    ids64 = ids.long()
    bag_err(torch, "bulk_int64", embedding_bag(table, ids64, "sum"),
            embedding_bag_ref(table, ids64, "sum"))

    # -- multi-hot: L = 100 (the largest multi-hot size of MLPerf's
    # DLRM-DCNv2 Criteo setup).  Sums and means add 100 float32 rows in
    # another order than the plain version: rtol 1e-5 and 1e-6 per row
    # added; max is exact
    multi = torch.randint(0, V, (16_384, 100), generator=gen, device=dev, dtype=torch.int32)
    for mode in ("sum", "mean", "max"):
        tol = (0.0, 0.0) if mode == "max" else (1e-5, 1e-4)
        err = bag_err(torch, f"L100_{mode}", embedding_bag(table, multi, mode),
                      embedding_bag_ref(table, multi, mode), *tol)
        timed(f"L100_{mode}", table, multi, mode, err,
              f"{mode} V=2^{EB_ROWS_LOG2} D={D} float32, B=16384 L=100 int32")

    # -- bfloat16: both accumulate in float32 and round once; one row is
    # exact, a mean of 100 may sit one bfloat16 step (2^-8 relative) apart
    half = table.to(torch.bfloat16)
    err = bag_err(torch, "bf16_bulk", embedding_bag(half, ids, "sum"),
                  embedding_bag_ref(half, ids, "sum"))
    timed("bf16_bulk", half, ids, "sum", err,
          f"sum V=2^{EB_ROWS_LOG2} D={D} bfloat16, B={EB_BULK} L=1 int32")
    bag_err(torch, "bf16_L100_mean", embedding_bag(half, multi, "mean"),
            embedding_bag_ref(half, multi, "mean"), 2**-7, 1e-6)
    del half, multi

    # -- D = 13 (scalar loads), B = 0, wrapped and out-of-range ids
    small = torch.randn((100_000, 13), generator=gen, device=dev)
    odd = torch.randint(0, 100_000, (65_536, 4), generator=gen, device=dev, dtype=torch.int32)
    bag_err(torch, "d13_sum", embedding_bag(small, odd, "sum"),
            embedding_bag_ref(small, odd, "sum"), 1e-6, 4e-6)
    bag_err(torch, "d13_max", embedding_bag(small, odd.long(), "max"),
            embedding_bag_ref(small, odd.long(), "max"))
    before = embedding_bag.launches
    empty = embedding_bag(table, ids[:0], "sum")
    check(empty.shape == (0, D) and embedding_bag.launches == before,
          "embedding_bag B=0: shape or launch")
    wild = torch.randint(-2 * 1000, 2 * 1000, (4096, 3), generator=gen, device=dev,
                         dtype=torch.int32)
    for mode in ("sum", "max"):
        tol = (0.0, 0.0) if mode == "max" else (1e-6, 3e-6)
        got = embedding_bag(table[:1000], wild, mode)
        bag_err(torch, f"wrap_{mode}", got, embedding_bag_ref(table[:1000], wild, mode), *tol)
        check(0 < int(torch.isnan(got[:, 0]).sum()) < 4096, f"embedding_bag wrap_{mode}: "
              "expected some NaN bags and some finite ones")
    log("kernel embedding_bag edge rows: int64 ids, bfloat16 mean of 100, D=13 sum and max, "
        "B=0, wrapped and out-of-range ids (NaN bags in the same places): all held")
    del table, small
    torch.cuda.empty_cache()
    return rows


# ---------------------------------------------------------------------------
# Phase 3: cost model, card against CPU
# ---------------------------------------------------------------------------

def phase_cost_model(torch, cfg, rt, rt_cpu, source: int, seed: int) -> None:
    from repro_torch.core.cost_model import partition_stats
    from repro_torch.core.hytm import HyTMState, hytm_iteration
    from repro_torch.core.scheduler import make_schedule
    from repro_torch.core.task_generation import generate_tasks
    from repro_torch.graph.algorithms import SSSP

    frontiers = []
    vals, delta, front = SSSP.init_state(rt.csr.n_nodes, source, rt.device)
    state = HyTMState(vals, delta, front)
    for _ in range(6):
        frontiers.append(state.frontier)
        state, _ = hytm_iteration(state, rt, SSSP, cfg)
    rng = np.random.default_rng(seed)
    for density in (1e-4, 1e-3, 1e-2, 0.1, 0.5):
        frontiers.append(torch.from_numpy(rng.random(rt.csr.n_nodes) < density).to(rt.device))

    def plan(r, frontier):
        stats = partition_stats(frontier, r.csr.out_degree, r.zc_req, r.parts)
        tp = generate_tasks(stats, cfg.link, combine_k=cfg.combine_k)
        sched = make_schedule(tp.engines, torch.zeros_like(stats.total_edges),
                              r.n_hub_partitions, "hub", True)
        return [*stats, tp.engines, tp.n_tasks, tp.transfer_bytes, tp.transfer_time,
                *tp.costs, sched.order, sched.second_pass]

    for i, f in enumerate(frontiers):
        on_card = [t.cpu() for t in plan(rt, f)]
        on_cpu = plan(rt_cpu, f.cpu())
        for a, b in zip(on_card, on_cpu):
            check(a.dtype == b.dtype and torch.equal(a, b),
                  f"cost model differs between card and CPU on frontier {i}")
    log(f"cost model: card == CPU bit for bit on {len(frontiers)} frontiers "
        "(stats, costs, engines, n_tasks, transfer bytes/time, order, second_pass)")


# ---------------------------------------------------------------------------
# Phase 4: the main path
# ---------------------------------------------------------------------------

def engine_mix(res, max_rows: int = 12) -> str:
    eng = res.history["engines"]
    lines = []
    for i in range(min(max_rows, eng.shape[0])):
        row = eng[i]
        lines.append(f"    iter {i:2d}: none={int((row == -1).sum())} "
                     f"filter={int((row == 0).sum())} compact={int((row == 1).sum())} "
                     f"zerocopy={int((row == 2).sum())}")
    if eng.shape[0] > max_rows:
        lines.append(f"    ... ({eng.shape[0] - max_rows} more)")
    return "\n".join(lines)


def same_min_run(a, b) -> bool:
    """Two MIN runs bit-equal in values, iterations, bytes and engine rows;
    ``a`` may be a sharded run whose table pads ``b``'s partitions (its
    padding partitions' rows NONE)."""
    P = b.history["engines"].shape[1]
    eng = a.history["engines"]
    return (a.iterations == b.iterations and np.array_equal(a.values, b.values)
            and a.total_transfer_bytes == b.total_transfer_bytes
            and np.array_equal(eng[:, :P], b.history["engines"])
            and bool((eng[:, P:] == -1).all()))


TURN_ROUNDS = 1   # rounds of (plain, kernels, kernels, plain) whole runs
# the kernels each leg must launch; every leg but Δ-PageRank launches no other
ALL_KERNELS = ("segment_spmm", "frontier_compact", "hyb_gather")
LEG_KERNELS = {
    "sssp_k8": ALL_KERNELS, "sssp_k1": ALL_KERNELS, "pagerank": ("segment_spmm",),
    "forced_filter": ("segment_spmm",), "forced_compact": ("frontier_compact",),
    "forced_zerocopy": ("hyb_gather",), "sssp_plain": (), "pagerank_plain": (),
}


def main_path_legs(cfg, source: int) -> dict:
    """The main path's legs: name -> (program, source, config)."""
    from repro_torch.core.cost_model import COMPACT, FILTER, ZEROCOPY
    from repro_torch.graph.algorithms import PAGERANK, SSSP

    pr = dataclasses.replace(PAGERANK, tolerance=1e-5)
    cfg8 = dataclasses.replace(cfg, sync_every=8)
    plain = dataclasses.replace(cfg8, use_kernels=False)
    return {
        "sssp_k8": (SSSP, source, cfg8),
        "sssp_k1": (SSSP, source, dataclasses.replace(cfg, sync_every=1)),
        "pagerank": (pr, None, dataclasses.replace(cfg8, cds_mode="delta")),
        **{f"forced_{name}": (SSSP, source, dataclasses.replace(cfg8, forced_engine=eng))
           for name, eng in (("filter", FILTER), ("compact", COMPACT),
                             ("zerocopy", ZEROCOPY))},
        "sssp_plain": (SSSP, source, plain),
        "pagerank_plain": (pr, None, dataclasses.replace(plain, cds_mode="delta")),
    }


def kernel_wrappers() -> dict:
    """Every kernel wrapper of the port, by kernel name."""
    from repro_torch.kernels.embedding_bag.ops import embedding_bag
    from repro_torch.kernels.flash_attention.ops import flash_attention
    from repro_torch.kernels.frontier_compact.ops import frontier_compact
    from repro_torch.kernels.hyb_gather.ops import hyb_gather
    from repro_torch.kernels.segment_spmm.ops import segment_spmm

    from repro_torch.kernels.grouped_matmul.ops import grouped_matmul
    from repro_torch.kernels.frontier_compact.ops import frontier_compact_lanes
    from repro_torch.kernels.segment_spmm.ops import segment_spmm_lanes

    return {"segment_spmm": segment_spmm, "frontier_compact": frontier_compact,
            "hyb_gather": hyb_gather, "flash_attention": flash_attention,
            "embedding_bag": embedding_bag, "grouped_matmul": grouped_matmul,
            "segment_spmm_lanes": segment_spmm_lanes,
            "frontier_compact_lanes": frontier_compact_lanes}


def reset_launch_counts() -> None:
    for w in kernel_wrappers().values():
        w.launches = 0


def read_launch_counts() -> dict:
    return {name: w.launches for name, w in kernel_wrappers().items()}


def counts_zero() -> dict:
    return {name: 0 for name in kernel_wrappers()}


TURN_PAIRS = {"sssp": ("sssp_k8", "sssp_plain"), "pagerank": ("pagerank", "pagerank_plain")}


def leg_turns(runs: dict, rounds: int) -> dict:
    """Wall seconds of two legs in turns, a, b, b, a, ``rounds`` times:
    ``runs`` maps each leg's name, a first, to a call that runs the leg once
    and returns its wall seconds; name -> list."""
    (a, run_a), (b, run_b) = runs.items()
    walls = {a: [], b: []}
    for _ in range(rounds):
        for name, run in ((a, run_a), (b, run_b), (b, run_b), (a, run_a)):
            walls[name].append(run())
    return walls


def run_wall(rt, leg: tuple, traced: bool = False):
    """A call that runs ``leg`` (program, source, config) once through
    ``run_hytm`` and returns its wall seconds; ``traced``: each run into a
    fresh ``TraceRecorder``."""
    from repro_torch.core.hytm import run_hytm
    from repro_torch.obs import TraceRecorder

    prog, src, c = leg
    return lambda: run_hytm(None, prog, src, c, runtime=rt,
                            obs=TraceRecorder() if traced else None).wall_seconds


def traced_device_ms(torch, fn, top: int = 0) -> tuple | None:
    """One run of ``fn`` under ``torch.profiler`` (device activity only):
    (the device ms of the port's own kernels, every one of which is in an
    anonymous namespace; the device ms of every kernel and copy), or None
    when the trace holds no device event.  With ``top``, a third element:
    the ``top`` kernels by device ms, {name: ms}."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        fn()
        torch.cuda.synchronize()
    events = [e for e in prof.key_averages() if e.device_type == DeviceType.CUDA]
    if not events:
        return None
    port = sum(e.self_device_time_total for e in events
               if e.key.removeprefix("void ").startswith("(anonymous namespace)::"))
    total = sum(e.self_device_time_total for e in events) / 1e3
    if not top:
        return port / 1e3, total
    ranked = sorted(events, key=lambda e: -e.self_device_time_total)[:top]
    return port / 1e3, total, {
        re.sub(r"^void |\(.*$", "", e.key.replace("(anonymous namespace)::", ""))[:60]:
        round(e.self_device_time_total / 1e3, 3) for e in ranked}


def phase_turns(rt, legs: dict, launches: dict) -> dict:
    """SSSP (K=8) and Δ-PageRank through the kernels and plain, in turns:
    their median wall seconds (``phase_graph_profiles`` adds the kernels'
    device time in one traced run)."""
    out = {}
    for name, (kern, plain) in TURN_PAIRS.items():
        walls = leg_turns({"plain": run_wall(rt, legs[plain]),
                           "kernels": run_wall(rt, legs[kern])}, TURN_ROUNDS)
        med = {which: float(np.median(walls[which])) for which in ("kernels", "plain")}
        out[name] = {"median_s": med, "runs": {w: walls[w] for w in med},
                     "launches": {k: launches[kern][k] for k in ALL_KERNELS}}
        log(f"turns {name}: median wall {med['kernels']:.4f} s (kernels) vs {med['plain']:.4f} s "
            f"(plain) over {2 * TURN_ROUNDS} runs each ({out[name]['launches']} launches)")
    return out


def phase_graph_profiles(torch, rt, legs: dict, rows: dict, turns: dict) -> None:
    """The graph's profiler runs, after every host timing of the graph (a
    process that has run the profiler may issue work more slowly): each
    graph row's device µs a launch by kernel (``launch_split``) and its
    host µs a call again, after the profiler; each turn pair's kernel leg
    once under the profiler, the port's kernels' device ms and all device
    ms of the run (``traced_device_ms``)."""
    from repro_torch.core.hytm import run_hytm

    for name, r in rows.items():
        fn = r.pop("call")
        r["split_us"] = launch_split(torch, fn)
        r["host_us_after_profiler"] = host_us(torch, fn)
        log(f"kernel {name}: host_us={r['host_us']:.1f} before the profiler, "
            f"{r['host_us_after_profiler']:.1f} after; device µs a launch, by kernel "
            "(torch.profiler, eager): " + ", ".join(f"{k} {v:.2f}" for k, v in r["split_us"].items()))
    for name, (kern, _) in TURN_PAIRS.items():
        prog, src, c = legs[kern]
        traced = traced_device_ms(torch, lambda: run_hytm(None, prog, src, c, runtime=rt))
        turns[name]["kernel_device_ms"] = traced and traced[0]
        turns[name]["device_ms"] = traced and traced[1]
        log(f"traced {name}: " + (f"the port's kernels {traced[0]:.2f} ms of {traced[1]:.2f} ms "
                                  "device time in one kernel run" if traced else
                                  "device time not measured (no device events)"))


def phase_main(torch, cfg, rt, source: int) -> dict:
    from repro_torch.core.hytm import run_hytm

    runs, launches = {}, {}
    for leg, (prog, src, c) in main_path_legs(cfg, source).items():
        reset_launch_counts()
        runs[leg] = r = run_hytm(None, prog, src, c, runtime=rt)
        launches[leg] = counts = read_launch_counts()
        check(counts["flash_attention"] == counts["embedding_bag"]
              == counts["grouped_matmul"] == 0,
              f"{leg} launched flash_attention, embedding_bag or grouped_matmul")
        log(f"{leg}: {r.iterations} iterations, wall {r.wall_seconds:.3f} s, modeled "
            f"{r.total_transfer_bytes / 2**20:.1f} MiB / {r.modeled_seconds * 1e3:.2f} ms; "
            f"launches {counts}")
        for name in ALL_KERNELS:
            if name in LEG_KERNELS[leg]:
                check(counts[name] > 0, f"{leg} did not launch {name}")
            elif leg != "pagerank":   # Δ-PageRank may pick any engine
                check(counts[name] == 0, f"{leg} launched {name}")

    s8, s1, sp = runs["sssp_k8"], runs["sssp_k1"], runs["sssp_plain"]
    check(same_min_run(s8, sp), "SSSP kernels != plain (values/iterations/bytes/engines)")
    check(same_min_run(s8, s1), "SSSP K=8 != K=1 (values/iterations/bytes/engines)")
    for name in ("forced_filter", "forced_compact", "forced_zerocopy"):
        check(np.array_equal(runs[name].values, s8.values),
              f"{name} SSSP values differ from the hybrid run")
    log("SSSP: kernels == plain and K=8 == K=1 bit for bit; forced baselines == hybrid")
    log("SSSP engine mix per iteration (Fig. 7 path):\n" + engine_mix(s8))

    a = runs["pagerank"].values + runs["pagerank"].delta
    b = runs["pagerank_plain"].values + runs["pagerank_plain"].delta
    check(bool(np.all(np.isfinite(a))), "PageRank values not finite")
    # SUM: float atomics reorder the additions and a vertex whose |Δ| sits
    # at the 1e-5 tolerance may stay active in one run only; the pending
    # mass it leaves is bounded by tolerance/(1 - damping) ≈ 6.7e-5
    err = float(np.max(np.abs(a - b)))
    log(f"PageRank: kernels vs plain max |err| {err:.3e} (tolerance 1e-3 + 1e-4 rel), "
        f"iterations {runs['pagerank'].iterations} vs {runs['pagerank_plain'].iterations}")
    check(np.allclose(a, b, rtol=1e-4, atol=1e-3), "PageRank kernels vs plain out of tolerance")
    return {leg: counts for leg, counts in launches.items() if LEG_KERNELS[leg]}, runs


# ---------------------------------------------------------------------------
# Phase 5: oracles on the quickstart graph
# ---------------------------------------------------------------------------

def phase_oracle(torch, dev) -> None:
    from repro_torch.core.constants import PCIE3
    from repro_torch.core.hytm import HyTMConfig, run_hytm
    from repro_torch.graph.algorithms import (PAGERANK, SSSP, reference_pagerank,
                                              reference_sssp)
    from repro_torch.graph.generators import rmat_graph
    from repro_torch.graph.hub_sort import hub_sort

    g = rmat_graph(50_000, 800_000, seed=0)
    hs = hub_sort(g)
    cfg = HyTMConfig(link=PCIE3.with_(mr=4.0), n_partitions=64)
    res = run_hytm(hs.graph, SSSP, int(hs.perm[0]), cfg, n_hubs=hs.n_hubs, device=dev)
    check(np.allclose(hs.values_to_old(res.values), reference_sssp(g, 0)),
          "SSSP on the card != reference_sssp")
    pr = dataclasses.replace(PAGERANK, tolerance=1e-5)
    res_pr = run_hytm(hs.graph, pr, None, dataclasses.replace(cfg, cds_mode="delta"),
                      n_hubs=hs.n_hubs, device=dev)
    err = float(np.max(np.abs(hs.values_to_old(res_pr.values + res_pr.delta)
                              - reference_pagerank(g))))
    log(f"oracle leg: SSSP == reference_sssp ({res.iterations} iterations); "
        f"PageRank max |err| vs reference_pagerank {err:.3e} ({res_pr.iterations} iterations)")
    # Δ-PageRank stops once every pending |Δ| <= 1e-5; the mass left pending
    # bounds the error (the CPU run of this leg gives 8.2e-3)
    check(err < 2e-2, "PageRank on the card too far from reference_pagerank")


# ---------------------------------------------------------------------------
# Phase 10: dynamic graphs (DeltaCSR, warm-start recompute) and autotune
# ---------------------------------------------------------------------------

STREAM_BATCHES = 3
STREAM_OPS = dict(n_insert=256, n_delete=256, n_reweight=64)
MERGE_INSERTS = 512


def pr_close(a, b, prog) -> tuple[bool, float, str]:
    """Two converged Δ-PageRank runs (values + Δ) held to phase 4's bound
    (``rtol=1e-4, atol=1e-3``) or, where that fails, to the bound the
    program's tolerance implies.  Derivation: a run with residual Δ
    reports r = values + Δ = x* - sum_{k>=1} (dM)^k Δ, where x* is the
    fixed point and M pushes a vertex's mass to its out-neighbours (each
    column sums to 1, or 0 for a vertex without edges).  A run ends only
    when every |Δ_v| <= tol, so |r1 - r2| <= 2 tol sum_{k>=1} (dM)^k 1 =
    2 tol (x*/(1 - d) - 1), since x* = (1 - d) sum_{k>=0} (dM)^k 1.  So
    |r1 - r2|_v <= 2 tol / (1 - d) * x*_v: 1.33e-4 relative at tol 1e-5
    and d 0.85, more than phase 4's rtol.  x*_v is bounded by 1.001
    max(r1_v, r2_v) (each r lies within 6.7e-5 relative of x*), and
    phase 4's atol stays for the float32 rounding.  Returns (held, max
    |r1 - r2|, which bound held)."""
    x, y = a.values + a.delta, b.values + b.delta
    err = float(np.max(np.abs(x - y)))
    if np.allclose(x, y, rtol=1e-4, atol=1e-3):
        return True, err, "phase 4's"
    rel = 2.0 * prog.tolerance / (1.0 - prog.damping) * 1.001
    ok = bool(np.all(np.abs(x - y) <= 1e-3 + rel * np.maximum(np.abs(x), np.abs(y))))
    return ok, err, f"the tolerance's ({rel:.3e} relative)"


def device_bytes(dcsr) -> int:
    """Bytes of a DeltaCSR's device tensors: the blocked edge columns, the
    partition vectors and the (n,) vectors."""
    tensors = [getattr(dcsr.csr, k) for k in ("edge_src", "edge_dst", "edge_weight",
                                               "edge_valid", "out_degree", "seg_start")]
    tensors += [getattr(dcsr.parts, k) for k in ("vertex_start", "edge_start", "part_edges",
                                                  "vertex_part_id")]
    tensors += [dcsr.zc_req, *dcsr._inv_deg_cache.values()]
    return sum(t.numel() * t.element_size() for t in tensors)


def phase_stream(torch, cfg, hs, rt, source: int, main_runs: dict, turns: dict,
                 smi: str) -> dict:
    """Phase 10: the online calibrator on the main runtime, then a DeltaCSR
    of the main graph patched in device memory by three update batches,
    each followed by warm-start runs through the kernels and plain, then
    the warm answers against a run from scratch, then a merge-compaction.
    Returns the phase's numbers and, under ``launches``, every kernel
    leg's launch counts (each read after that leg alone)."""
    from repro_torch.autotune import OnlineCalibrator
    from repro_torch.core.hytm import build_runtime, run_hytm
    from repro_torch.graph.algorithms import SSSP
    from repro_torch.stream import DeltaCSR, EdgeBatch, random_batch, run_incremental

    class RecordingCalibrator(OnlineCalibrator):
        """Records which observations were skipped as cold."""

        def __init__(self, **kw):
            super().__init__(**kw)
            self.skips = []

        def observe_iteration(self, sync_ref, modeled, t_start, skip=False):
            self.skips.append(bool(skip))
            return super().observe_iteration(sync_ref, modeled, t_start, skip=skip)

    legs = main_path_legs(cfg, source)
    _, _, cfg8 = legs["sssp_k8"]
    pr, _, cfg_pr = legs["pagerank"]
    plain8, plain_pr = legs["sssp_plain"][2], legs["pagerank_plain"][2]
    sssp_ref, pr_ref = main_runs["sssp_k8"], main_runs["pagerank"]
    launches, out = {}, {"card": smi}

    def leg(name, fn, kernels: bool = True):
        """Run ``fn`` with every launch count set to 0 just before and read
        just after; a kernel leg must launch a graph kernel and nothing
        else, a plain leg nothing."""
        reset_launch_counts()
        t = time.monotonic()
        res = fn()
        torch.cuda.synchronize()
        wall = time.monotonic() - t
        counts = read_launch_counts()
        others = {k: v for k, v in counts.items() if k not in ALL_KERNELS and v}
        check(not others, f"{name} launched {others}")
        graph = sum(counts[k] for k in ALL_KERNELS)
        if kernels:
            check(graph > 0, f"{name} launched no graph kernel")
            launches[name] = counts
        else:
            check(graph == 0, f"{name} (plain) launched {counts}")
        return res, wall, {k: counts[k] for k in ALL_KERNELS}

    # -- 1. autotune on the main runtime
    auto = {}
    for name, prog, src, c in (("sssp", SSSP, source, cfg8), ("pagerank", pr, None, cfg_pr)):
        cal = RecordingCalibrator(decay=cfg.autotune_decay)
        res, wall, counts = leg(f"autotune_{name}", lambda: run_hytm(
            None, prog, src, dataclasses.replace(c, autotune=True), runtime=rt, calibrator=cal))
        if name == "sssp":
            check(np.array_equal(res.values, sssp_ref.values),
                  "autotune SSSP values != phase 4's SSSP")
            err, held = 0.0, "bit-for-bit"
        else:
            ok, err, held = pr_close(res, pr_ref, pr)
            check(ok, f"autotune Δ-PageRank vs phase 4's out of tolerance ({err:.3e})")
        auto[name] = {"wall_s": res.wall_seconds, "iterations": res.iterations,
                      "engine_corrections": res.engine_corrections.tolist(),
                      "total_mispredictions": res.total_mispredictions,
                      "n_updates": cal.n_updates, "skipped_cold": cal.skips,
                      "max_abs_err_vs_phase4": err, "bound": held, "launches": counts}
        log(f"autotune {name}: {res.iterations} iterations, wall {res.wall_seconds:.4f} s, "
            f"corrections {np.array2string(res.engine_corrections, precision=4)}, "
            f"mispredictions {res.total_mispredictions}, calibrator updates {cal.n_updates}, "
            f"chunks skipped as cold {cal.skips}, |err| vs phase 4 {err:.3e} ({held} bound); "
            f"launches {counts}")
    out["autotune"] = auto

    # -- 2. DeltaCSR of the main graph, cold runs over it
    t = time.monotonic()
    dcsr = DeltaCSR(hs.graph, cfg, device=rt.device)
    torch.cuda.synchronize()
    build_s = time.monotonic() - t
    B, cap = dcsr.block_size, dcsr.csr.capacity
    free = B - dcsr.counts
    log(f"DeltaCSR: built in {build_s:.2f} s; {dcsr.n_partitions} blocks of B = {B:,} lanes "
        f"(largest partition {int(dcsr.counts.max()):,} edges; the main path's blocks "
        f"{rt.parts.block_size:,}), capacity {cap:,}, free lanes {int(free.min()):,}-{int(free.max()):,} a block, "
        f"{device_bytes(dcsr) / 1e9:.3f} GB on the card")
    out["delta_csr"] = {"build_s": build_s, "block_size": B, "capacity": cap,
                        "device_bytes": device_bytes(dcsr),
                        "free_lanes_min": int(free.min())}
    cold, wall, counts = leg("stream_cold_sssp", lambda: run_hytm(
        None, SSSP, source, cfg8, runtime=dcsr.runtime_for(SSSP)))
    check(np.array_equal(cold.values, sssp_ref.values),
          "SSSP over the DeltaCSR != phase 4's SSSP")
    cold_pr, _, counts_pr = leg("stream_cold_pagerank", lambda: run_hytm(
        None, pr, None, cfg_pr, runtime=dcsr.runtime_for(pr)))
    ok, err, held = pr_close(cold_pr, pr_ref, pr)
    check(ok, f"Δ-PageRank over the DeltaCSR vs phase 4's out of tolerance ({err:.3e})")
    log(f"DeltaCSR cold SSSP == phase 4's SSSP ({cold.iterations} iterations, wall "
        f"{cold.wall_seconds:.4f} s vs {sssp_ref.wall_seconds:.4f} s); cold Δ-PageRank "
        f"{cold_pr.iterations} iterations, wall {cold_pr.wall_seconds:.4f} s, |err| vs phase 4 "
        f"{err:.3e} ({held} bound); launches {counts}, {counts_pr}")
    # the kernels' device time a launch over the DeltaCSR's blocks, against
    # phase 4's traced SSSP run over the main graph's
    reset_launch_counts()
    traced = traced_device_ms(torch, lambda: run_hytm(
        None, SSSP, source, cfg8, runtime=dcsr.runtime_for(SSSP)))
    n_traced = sum(read_launch_counts()[k] for k in ALL_KERNELS)
    main_n = sum(turns["sssp"]["launches"].values())
    main_ms = turns["sssp"].get("kernel_device_ms")
    per_launch = {"delta_csr_us": traced and n_traced and traced[0] * 1e3 / n_traced,
                  "delta_csr_launches": n_traced,
                  "main_us": main_ms and main_ms * 1e3 / main_n, "main_launches": main_n}
    out["traced_sssp"] = {"kernel_device_ms": traced and traced[0],
                          "device_ms": traced and traced[1], **per_launch}
    log("traced cold SSSP over the DeltaCSR: " + (
        f"the port's kernels {traced[0]:.2f} ms of {traced[1]:.2f} ms device time, "
        f"{per_launch['delta_csr_us'] or float('nan'):.2f} µs a launch over {n_traced} "
        f"launches; phase 4's "
        f"SSSP over the main blocks {per_launch['main_us'] or float('nan'):.2f} µs a launch "
        f"over {main_n}" if traced else "device time not measured (no device events)"))
    out["cold"] = {"sssp": {"wall_s": cold.wall_seconds, "iterations": cold.iterations},
                   "pagerank": {"wall_s": cold_pr.wall_seconds, "iterations": cold_pr.iterations,
                                "max_abs_err_vs_phase4": err, "bound": held}}

    # -- 3. update batches, warm runs
    warm_sssp, warm_pr = cold, cold_pr
    cal = RecordingCalibrator(decay=cfg.autotune_decay)   # one for the service's lifetime
    auto8 = dataclasses.replace(cfg8, autotune=True)
    batches = []
    for i in range(STREAM_BATCHES):
        batch = random_batch(dcsr, np.random.default_rng(SEED + i), **STREAM_OPS)
        t = time.monotonic()
        rep = dcsr.apply(batch)
        torch.cuda.synchronize()
        apply_s = time.monotonic() - t
        check(not rep.merged, f"batch {i} merged")
        row = {"apply_s": apply_s, "ops": len(batch), "dirty_partitions": len(rep.dirty_partitions)}

        def warm(prog, st, src, c, r=rep):
            return lambda: run_incremental(dcsr, prog, [r], st.values, st.delta, src, config=c)

        ker, wall, counts = leg(f"stream_sssp_b{i}", warm(SSSP, warm_sssp, source, cfg8))
        pla, _, _ = leg(f"stream_sssp_plain_b{i}", warm(SSSP, warm_sssp, source, plain8),
                        kernels=False)
        check(same_min_run(ker, pla), f"batch {i}: warm SSSP kernels != plain "
              "(values/iterations/bytes/engines)")
        seen = len(cal.skips)
        aut, _, counts_a = leg(f"stream_sssp_autotune_b{i}", lambda: run_incremental(
            dcsr, SSSP, [rep], warm_sssp.values, warm_sssp.delta, source, config=auto8,
            calibrator=cal))
        check(np.array_equal(aut.values, ker.values), f"batch {i}: autotune warm SSSP values differ")
        pk, wall_pr, counts_pr = leg(f"stream_pagerank_b{i}", warm(pr, warm_pr, None, cfg_pr))
        pp, _, _ = leg(f"stream_pagerank_plain_b{i}", warm(pr, warm_pr, None, plain_pr),
                       kernels=False)
        ok, err, held = pr_close(pk, pp, pr)
        check(ok, f"batch {i}: warm Δ-PageRank kernels vs plain out of tolerance ({err:.3e})")
        row.update({
            "sssp": {"wall_s": ker.wall_seconds, "call_s": wall,
                     "seed_s": wall - ker.wall_seconds, "iterations": ker.iterations,
                     "plain_wall_s": pla.wall_seconds, "launches": counts},
            "sssp_autotune": {"wall_s": aut.wall_seconds, "iterations": aut.iterations,
                              "corrections": aut.engine_corrections.tolist(),
                              "n_updates": cal.n_updates,
                              "skipped_cold": cal.skips[seen:],
                              "launches": counts_a},
            "pagerank": {"wall_s": pk.wall_seconds, "call_s": wall_pr,
                         "seed_s": wall_pr - pk.wall_seconds, "iterations": pk.iterations,
                         "plain_wall_s": pp.wall_seconds, "max_abs_err_vs_plain": err,
                         "bound": held, "launches": counts_pr}})
        batches.append(row)
        log(f"batch {i}: {len(batch)} ops, apply {apply_s:.3f} s (host + patch), "
            f"{len(rep.dirty_partitions)} dirty blocks; warm SSSP {ker.iterations} iterations "
            f"(cold {cold.iterations}), seed {wall - ker.wall_seconds:.3f} s + run "
            f"{ker.wall_seconds:.4f} s (plain {pla.wall_seconds:.4f} s), kernels == plain; "
            f"autotune leg corrections {np.array2string(aut.engine_corrections, precision=4)}, "
            f"{cal.n_updates} updates so far; warm Δ-PageRank {pk.iterations} iterations, seed "
            f"{wall_pr - pk.wall_seconds:.3f} s + run {pk.wall_seconds:.4f} s (plain "
            f"{pp.wall_seconds:.4f} s), |err| kernels vs plain {err:.3e} ({held} bound); launches {counts}, "
            f"{counts_a}, {counts_pr}")
        warm_sssp, warm_pr = ker, pk
    out["batches"] = batches
    out["calibrator_skips"] = cal.skips

    # -- 4. the last batch's warm answers against a run from scratch
    t = time.monotonic()
    g_new = dcsr.to_host_graph()
    host_s = time.monotonic() - t
    t = time.monotonic()
    rt_new = build_runtime(g_new, cfg, n_hubs=hs.n_hubs, device=rt.device)
    torch.cuda.synchronize()
    upload_s = time.monotonic() - t
    fs, fs_wall, counts = leg("stream_scratch_sssp", lambda: run_hytm(
        None, SSSP, source, cfg8, runtime=rt_new))
    fs_pr, fs_pr_wall, counts_pr = leg("stream_scratch_pagerank", lambda: run_hytm(
        None, pr, None, cfg_pr, runtime=rt_new))
    del rt_new, g_new
    check(np.array_equal(warm_sssp.values, fs.values), "warm SSSP != SSSP from scratch")
    check(warm_sssp.iterations < fs.iterations,
          f"warm SSSP took {warm_sssp.iterations} iterations, scratch {fs.iterations}")
    ok, err, held = pr_close(warm_pr, fs_pr, pr)
    check(ok, f"warm Δ-PageRank vs scratch out of tolerance ({err:.3e})")
    last = batches[-1]
    fresh = {"sssp": {"warm_s": last["apply_s"] + last["sssp"]["call_s"],
                      "scratch_s": host_s + upload_s + fs_wall},
             "pagerank": {"warm_s": last["apply_s"] + last["pagerank"]["call_s"],
                          "scratch_s": host_s + upload_s + fs_pr_wall}}
    out["scratch"] = {"to_host_graph_s": host_s, "build_runtime_s": upload_s,
                      "sssp": {"wall_s": fs.wall_seconds, "iterations": fs.iterations},
                      "pagerank": {"wall_s": fs_pr.wall_seconds, "iterations": fs_pr.iterations,
                                   "max_abs_err_vs_warm": err, "bound": held},
                      "time_to_fresh_answers_s": fresh}
    log(f"scratch after batch {STREAM_BATCHES - 1}: to_host_graph {host_s:.2f} s, build_runtime "
        f"{upload_s:.2f} s; SSSP {fs.iterations} iterations ({fs.wall_seconds:.4f} s) == warm "
        f"({warm_sssp.iterations} iterations); Δ-PageRank {fs_pr.iterations} iterations "
        f"({fs_pr.wall_seconds:.4f} s) vs warm {warm_pr.iterations}, |err| {err:.3e} ({held} "
        f"bound); "
        f"launches {counts}, {counts_pr}")
    for name, f in fresh.items():
        log(f"time to fresh answers, {name}: warm {f['warm_s']:.3f} s (apply + seed + run) vs "
            f"scratch {f['scratch_s']:.3f} s (to_host_graph + build_runtime + cold run) [{smi}]")
    del dcsr, warm_pr
    torch.cuda.empty_cache()

    # -- 5. merge-compaction at full size: no slack, 512 inserts into the
    # largest partition's block (at most 255 free lanes)
    dcsr = DeltaCSR(hs.graph, cfg, slack=0.0, device=rt.device)
    p = int(np.argmax(dcsr.counts))
    v0, v1 = int(dcsr.vertex_start[p]), int(dcsr.vertex_start[p + 1])
    rng = np.random.default_rng(SEED + STREAM_BATCHES)
    batch = EdgeBatch.inserts(rng.integers(v0, v1, MERGE_INSERTS),
                              rng.integers(0, dcsr.n_nodes, MERGE_INSERTS),
                              rng.integers(1, 64, MERGE_INSERTS).astype(np.float32))
    free = dcsr.block_size - int(dcsr.counts[p])
    t = time.monotonic()
    rep = dcsr.apply(batch)
    torch.cuda.synchronize()
    merge_s = time.monotonic() - t
    check(rep.merged and dcsr.layout_version == 1,
          f"{MERGE_INSERTS} inserts into {free} free lanes did not merge")
    ker, _, counts = leg("stream_merge_sssp", lambda: run_incremental(
        dcsr, SSSP, [rep], sssp_ref.values, sssp_ref.delta, source, config=cfg8))
    pla, _, _ = leg("stream_merge_sssp_plain", lambda: run_incremental(
        dcsr, SSSP, [rep], sssp_ref.values, sssp_ref.delta, source, config=plain8),
        kernels=False)
    check(same_min_run(ker, pla), "after the merge: warm SSSP kernels != plain")
    rt_new = build_runtime(dcsr.to_host_graph(), cfg, n_hubs=hs.n_hubs, device=rt.device)
    fs, _, counts_fs = leg("stream_merge_scratch_sssp", lambda: run_hytm(
        None, SSSP, source, cfg8, runtime=rt_new))
    check(np.array_equal(ker.values, fs.values), "after the merge: warm SSSP != scratch")
    out["merge"] = {"free_lanes": free, "inserts": MERGE_INSERTS, "merge_s": merge_s,
                    "block_size": dcsr.block_size, "warm_iterations": ker.iterations,
                    "scratch_iterations": fs.iterations, "warm_wall_s": ker.wall_seconds}
    log(f"merge: {MERGE_INSERTS} inserts into partition {p} ({free} free lanes) merged in "
        f"{merge_s:.2f} s (layout_version 1, B {dcsr.block_size:,}); warm SSSP "
        f"{ker.iterations} iterations == plain == scratch ({fs.iterations} iterations); "
        f"launches {counts}, {counts_fs}")
    del dcsr, rt_new
    torch.cuda.empty_cache()
    out["launches"] = launches
    return out


# ---------------------------------------------------------------------------
# Phase 11: graph serving (GraphService, lane scheduler, warm cache)
# ---------------------------------------------------------------------------

SERVE_LANES = 8
SERVE_QUERIES = 32
SERVE_PUMP = 24
SERVE_PPR = 8
SERVE_REQUERY = 8
SERVE_TURNS = ("batched", "solo")   # the serving leg's timed runs, in this order
# the lane entries each graph kernel gains (hyb_gather's lane path is its own
# entry with every lane's windows in one request list)
LANE_ENTRIES = {"segment_spmm": "segment_spmm_lanes",
                "frontier_compact": "frontier_compact_lanes", "hyb_gather": "hyb_gather"}
SERVE_KERNELS = ALL_KERNELS + ("segment_spmm_lanes", "frontier_compact_lanes")
SOLO_ONLY = ("segment_spmm", "frontier_compact")   # no lane leg may launch these


def lane_kernel_rows(torch, dcsr, seed: int) -> dict:
    """Each lane entry against its plain version (a loop of single-lane
    plain versions) at the serving phase's shapes: 8 lanes, lane l on
    partition 8l of the DeltaCSR (its own edges, packed lane after lane),
    30% of the edges active.  Warm and cold-L2 device ms, the plain
    version's ms (one call: it reads the lane bounds back to the host) and
    one library call's where there is one, against the bytes bound."""
    from repro_torch.core.engines import packed_ranges
    from repro_torch.kernels.frontier_compact.ops import frontier_compact_lanes
    from repro_torch.kernels.frontier_compact.ref import frontier_compact_lanes_ref
    from repro_torch.kernels.hyb_gather.ops import PAD, hyb_gather
    from repro_torch.kernels.hyb_gather.ref import hyb_gather_ref
    from repro_torch.kernels.segment_spmm.ops import segment_spmm_lanes
    from repro_torch.kernels.segment_spmm.ref import segment_spmm_lanes_ref

    dev, n = dcsr.device, dcsr.n_nodes
    _, edge_start, part_edges = dcsr.parts.host
    parts = [8 * l for l in range(SERVE_LANES)]
    L = len(parts)
    lengths = [part_edges[p] for p in parts]
    M = sum(lengths)
    offsets = torch.tensor([0, *np.cumsum(lengths)], dtype=torch.int64, device=dev)
    starts = torch.tensor([edge_start[p] for p in parts], dtype=torch.int64, device=dev)
    lane, idx = packed_ranges(starts, offsets, M)
    src, dst = dcsr.csr.edge_src[idx], dcsr.csr.edge_dst[idx]
    w = dcsr.csr.edge_weight[idx]
    gen = torch.Generator(device=dev)
    gen.manual_seed(seed)
    active = torch.rand(M, device=dev, generator=gen) < 0.3
    msg = torch.where(active, torch.rand(M, device=dev, generator=gen) * 100.0 + 1.0,
                      float("inf"))
    flat = lane * n + dst.long()
    shape = (f"L={L} lanes (partitions {parts[0]}..{parts[-1]} step 8) M={M} packed edges "
             f"n={n}")
    rows = {}

    def timed(kernel, plain, library, make_args, set_bytes, **row):
        args = make_args()
        row.update(ms=graph_ms(torch, lambda: kernel(*args)),
                   cold_ms=cold_ms(torch, kernel, make_args, set_bytes),
                   plain_ms=call_ms(torch, lambda: plain(*args), reps=5),
                   library_ms=None if library is None else graph_ms(torch, lambda: library(*args)),
                   bound_ms=bound_ms(set_bytes), bound_by="bytes")
        return row

    # -- segment_spmm_lanes: min (SSSP's FILTER) and sum with the activity column
    k = segment_spmm_lanes(msg, dst, offsets, n, "min")
    p = segment_spmm_lanes_ref(msg, dst, offsets, n, "min")
    check(torch.equal(k.view(torch.int32), p.view(torch.int32)),
          "segment_spmm_lanes min differs from its plain version")
    rows["segment_spmm"] = timed(
        lambda m_, d_, f_: segment_spmm_lanes(m_, d_, offsets, n, "min"),
        lambda m_, d_, f_: segment_spmm_lanes_ref(m_, d_, offsets, n, "min"),
        lambda m_, d_, f_: torch.full((L * n,), float("inf"), device=dev).scatter_reduce_(
            0, f_, m_, "amin"),
        lambda: (msg.clone(), dst.clone(), flat), M * 4 + M * 4 + (L + 1) * 8 + L * n * 4,
        max_abs_err=0.0, shape="min d=1 " + shape,
        source="src/repro_torch/kernels/segment_spmm/csrc/segment_spmm.cu "
               "(segment_spmm_lanes_launch)")
    pmsg = torch.where(active, torch.rand(M, device=dev, generator=gen) * 1e-3, 0.0)
    packed = torch.stack([pmsg, active.to(torch.float32)], dim=-1)
    k = segment_spmm_lanes(packed, dst, offsets, n)
    p = segment_spmm_lanes_ref(packed, dst, offsets, n)
    check(torch.equal(k[..., 1], p[..., 1])
          and torch.allclose(k[..., 0], p[..., 0], rtol=1e-4, atol=1e-9),
          "segment_spmm_lanes sum differs from its plain version")
    rows["segment_spmm"]["sum_d2"] = timed(
        lambda m_, d_, f_: segment_spmm_lanes(m_, d_, offsets, n),
        lambda m_, d_, f_: segment_spmm_lanes_ref(m_, d_, offsets, n),
        lambda m_, d_, f_: torch.zeros((L * n, 2), device=dev).index_add_(0, f_, m_),
        lambda: (packed.clone(), dst.clone(), flat), M * 8 + M * 4 + (L + 1) * 8 + L * n * 8,
        max_abs_err=float((k[..., 0] - p[..., 0]).abs().max()), shape="sum d=2 " + shape)

    # -- frontier_compact_lanes: COMPACT's four packed columns, each lane by its mask
    cols = (src, dst, w, active)
    out, cnt = frontier_compact_lanes(cols, active, offsets)
    ref_out, ref_cnt = frontier_compact_lanes_ref(cols, active, offsets)
    check(torch.equal(cnt, ref_cnt.to(dev)) and all(map(torch.equal, out, ref_out)),
          "frontier_compact_lanes differs from its plain version")
    rows["frontier_compact"] = timed(
        lambda c: frontier_compact_lanes(c, c[3], offsets),
        lambda c: frontier_compact_lanes_ref(c, c[3], offsets), None,
        lambda: (tuple(t.clone() for t in cols),), 2 * M * 13 + (L + 1) * 8 + L * 4,
        max_abs_err=0.0, shape=f"{shape} columns=(i32, i32, f32, bool) "
                               f"kept={int(active.sum())}",
        source="src/repro_torch/kernels/frontier_compact/csrc/frontier_compact.cu "
               "(frontier_compact_lanes_launch)")

    # -- hyb_gather, lane path: every lane's windows in one request list over
    # the shared CSR columns (the existing body; active is computed after it)
    n_win = [-(-c // PAD) for c in lengths]
    wstart = torch.tensor([edge_start[p] + PAD * k_ for p, nw in zip(parts, n_win)
                           for k_ in range(nw)], dtype=torch.int32, device=dev)
    wdeg = torch.tensor([min(PAD, c - PAD * k_) for c, nw in zip(lengths, n_win)
                         for k_ in range(nw)], dtype=torch.int32, device=dev)
    shared = (dcsr.csr.edge_src, dcsr.csr.edge_dst, dcsr.csr.edge_weight)
    check(all(map(torch.equal, hyb_gather(shared, wstart, wdeg),
                  hyb_gather_ref(shared, wstart, wdeg))),
          "hyb_gather (lane windows) differs from its plain version")
    cap = shared[0].shape[0]
    k_ = torch.arange(PAD, device=dev)
    gidx = wstart.long()[:, None] + k_
    gidx = torch.where(k_ < wdeg.long()[:, None], gidx, cap)

    def gather_args():
        c = tuple(t.clone() for t in shared)
        words = torch.stack([c[0], c[1], c[2].view(torch.int32)], dim=-1)
        return c, torch.cat([words, words.new_zeros((1, 3))])

    a = sum(n_win)
    rows["hyb_gather"] = timed(
        lambda c, padded: hyb_gather(c, wstart, wdeg),
        lambda c, padded: hyb_gather_ref(c, wstart, wdeg), lambda c, padded: padded[gidx],
        gather_args, M * 12 + a * 8 + a * PAD * 12, max_abs_err=0.0,
        shape=f"a={a} windows of {L} lanes ({M} edges) over the shared (i32, i32, f32) "
              "columns",
        source="src/repro_torch/kernels/hyb_gather/csrc/hyb_gather.cu (the existing body)")
    for name, r in rows.items():
        log(f"lane entry of {name}: {r['shape']} ms={r['ms']:.4f} (warm) cold_ms="
            f"{r['cold_ms']:.4f} plain_ms={r['plain_ms']:.4f} library_ms="
            f"{r['library_ms'] if r['library_ms'] is None else round(r['library_ms'], 4)} "
            f"bound_ms={r['bound_ms']:.4f}")
    s2 = rows["segment_spmm"]["sum_d2"]
    log(f"lane entry of segment_spmm, sum: {s2['shape']} ms={s2['ms']:.4f} cold_ms="
        f"{s2['cold_ms']:.4f} plain_ms={s2['plain_ms']:.4f} library_ms={s2['library_ms']:.4f} "
        f"bound_ms={s2['bound_ms']:.4f} max_abs_err={s2['max_abs_err']:.3g}")
    return rows


def phase_serve(torch, cfg, hs, rt, smi: str) -> dict:
    """Phase 11: graph serving over a DeltaCSR of the main graph.  32 SSSP
    sources through 8 lanes with backfill, each answer held to a solo run;
    the batched queries against a loop of solo runs over the same sources
    in turns; a three-tenant pump under quotas and a byte budget; 8 Δ-PPR
    lanes; three update batches and a warm re-query; the lane entries
    against their plain versions.  Every leg's launch counts are read after
    that leg alone; a lane leg must launch a lane entry and no solo
    ``segment_spmm``/``frontier_compact``."""
    from types import SimpleNamespace

    from repro_torch.core.hytm import run_hytm
    from repro_torch.graph.algorithms import BFS, PPR, SSSP
    from repro_torch.serve import Request, RequestQueue, TierPolicy
    from repro_torch.stream import GraphService, random_batch

    cfg8 = dataclasses.replace(cfg, sync_every=8)
    n = hs.graph.n_nodes
    rng = np.random.default_rng(SEED + 11)
    # sources a user would ask about: vertices with out-edges
    live = np.flatnonzero(np.diff(hs.graph.indptr) > 0)
    sources = [int(v) for v in rng.choice(live, SERVE_QUERIES, replace=False)]
    launches, out = {}, {"card": smi, "sources": sources}

    def leg(name, fn, lanes: bool = True, solo: bool = False):
        reset_launch_counts()
        t = time.monotonic()
        res = fn()
        torch.cuda.synchronize()
        wall = time.monotonic() - t
        counts = read_launch_counts()
        others = {k: v for k, v in counts.items() if k not in SERVE_KERNELS and v}
        check(not others, f"{name} launched {others}")
        if lanes and not solo:
            check(all(counts[k] == 0 for k in SOLO_ONLY),
                  f"{name} (lanes only) launched a solo kernel: {counts}")
        if not lanes:
            check(counts["segment_spmm_lanes"] == counts["frontier_compact_lanes"] == 0,
                  f"{name} (solo) launched a lane entry: {counts}")
        check(sum(counts[k] for k in SERVE_KERNELS) > 0, f"{name} launched no graph kernel")
        launches[name] = {k: counts[k] for k in SERVE_KERNELS}
        return res, wall

    t = time.monotonic()
    svc = GraphService(hs.graph, cfg8, max_lanes=SERVE_LANES, device=rt.device)
    torch.cuda.synchronize()
    out["service_build_s"] = time.monotonic() - t
    lane_bytes = svc.scheduler.lane_bytes
    log(f"serving: GraphService over a DeltaCSR of the main graph built in "
        f"{out['service_build_s']:.2f} s; {SERVE_LANES} lanes, buckets "
        f"{svc.scheduler.buckets}, {lane_bytes / 1e6:.1f} MB of lane state a lane")

    def solo_runs(prog, srcs):
        rt_p = svc.dcsr.runtime_for(prog)
        return [run_hytm(None, prog, s, cfg8, runtime=rt_p) for s in srcs]

    # -- 1. 32 SSSP sources through the lanes, with backfill
    st0 = dataclasses.replace(svc.scheduler.stats)
    res, wall = leg("serve_sssp", lambda: svc.query(SSSP, sources))
    st1 = svc.scheduler.stats
    check(all(r.mode == "batched" for r in res), "serving: a fresh SSSP query was not batched")
    check(st1.backfills > st0.backfills, "serving: 32 sources over 8 lanes backfilled nothing")
    solos = solo_runs(SSSP, sources)
    for s, r, so in zip(sources, res, solos):
        check(np.array_equal(r.values, so.values),
              f"serving: SSSP lane of source {s} != its solo run_hytm")
    occ = ((st1.lane_iterations - st0.lane_iterations)
           / max(st1.slot_iterations - st0.slot_iterations, 1))
    out["sssp"] = {"wall_s": wall, "chunks": st1.chunks - st0.chunks,
                   "engine_iterations": st1.engine_iterations - st0.engine_iterations,
                   "backfills": st1.backfills - st0.backfills, "occupancy": occ,
                   "solo_iterations": [so.iterations for so in solos],
                   "lane_iterations": [r.iterations for r in res]}
    log(f"serving SSSP: {SERVE_QUERIES} sources bit-equal to their solo runs; {wall:.3f} s, "
        f"{out['sssp']['chunks']} chunks, {out['sssp']['engine_iterations']} engine iterations, "
        f"{out['sssp']['backfills']} backfills, lane occupancy {occ:.3f}; solo iterations "
        f"{min(so.iterations for so in solos)}-{max(so.iterations for so in solos)}; "
        f"launches {launches['serve_sssp']}")

    # -- 2. batched against a loop of solo runs over the same sources, in turns
    def batched():
        svc.cache.clear()
        return svc.query(SSSP, sources)

    def solo_loop():
        return solo_runs(SSSP, sources)

    turns = {"batched": [], "solo": []}
    for i, kind in enumerate(SERVE_TURNS):
        if i == 0:
            torch.cuda.reset_peak_memory_stats()
            base = torch.cuda.memory_allocated()
        _, wall = leg(f"serve_turn{i}_{kind}", batched if kind == "batched" else solo_loop,
                      lanes=kind == "batched")
        if i == 0:
            out["peak_device_bytes"] = torch.cuda.max_memory_allocated()
            out["peak_over_base_bytes"] = out["peak_device_bytes"] - base
        turns[kind].append(wall)
    rate = {k: SERVE_QUERIES / float(np.median(v)) for k, v in turns.items()}
    out["turns"] = {"wall_s": turns, "queries_per_s": rate}
    log(f"serving turns {SERVE_TURNS}: batched {turns['batched']} s, solo "
        f"{turns['solo']} s; {rate['batched']:.2f} queries/s batched against "
        f"{rate['solo']:.2f} solo (median of {len(turns['solo'])} each) [{smi}]; peak device "
        f"memory {out['peak_device_bytes'] / 1e9:.3f} GB "
        f"({out['peak_over_base_bytes'] / 1e9:.3f} GB over the leg's start)")

    # -- 3. host syncs a chunk, and the kernels' device time in one traced run
    st0 = dataclasses.replace(svc.scheduler.stats)
    sites = host_syncs(torch, batched)
    chunks = svc.scheduler.stats.chunks - st0.chunks
    out["host_syncs"] = {"total": sum(sites.values()), "chunks": chunks,
                         "per_chunk": sum(sites.values()) / max(chunks, 1), "sites": sites}
    log(f"serving host syncs: {sum(sites.values())} in {chunks} chunks "
        f"({out['host_syncs']['per_chunk']:.2f} a chunk), by source line: {sites}")
    # one bucket's worth (8 queries): the profiler's cost grows with the
    # launches it records
    def batched8():
        svc.cache.clear()
        return svc.query(SSSP, sources[:SERVE_LANES])

    reset_launch_counts()
    traced = traced_device_ms(torch, batched8, top=8)
    out["traced"] = {"queries": SERVE_LANES, "kernel_device_ms": traced and traced[0],
                     "device_ms": traced and traced[1], "top_device_ms": traced and traced[2],
                     "launches": {k: v for k, v in read_launch_counts().items()
                                  if k in SERVE_KERNELS}}
    log(f"traced batched SSSP ({SERVE_LANES} queries): " + (
        f"the port's kernels {traced[0]:.2f} ms of {traced[1]:.2f} ms device time; top "
        f"device kernels (ms): {traced[2]}" if traced
        else "device time not measured (no device events)"))

    # -- 4. three tenants under quotas and a budget of 4 lanes + 2 cached states
    budget = 4 * lane_bytes + 2 * 8 * n
    svc.cache.clear()
    svc.cache.policy = TierPolicy(device_budget_bytes=budget, max_reports=svc.max_reports)
    quotas = {"gold": 3, "silver": 2, "bronze": 1}
    q = RequestQueue(quota=3, tenant_quotas=quotas)
    tenants = ("gold", "silver", "bronze")
    pump_sources = [int(v) for v in rng.choice(live, SERVE_PUMP, replace=False)]
    for i, s in enumerate(pump_sources):
        q.submit(Request(tenant=tenants[i % 3], program=SSSP if i % 2 == 0 else BFS,
                         source=s, deadline=float(i % 5)))
    # the leg's own peaks, read at every dispatch (the scheduler's
    # max_device_bytes is a lifetime peak: the unbudgeted 8-lane batches
    # above are in it)
    peak: dict = {}
    peak_bytes = [0]
    dispatch = svc.scheduler._dispatch

    def spying(*a, **k):
        for tenant, c in svc.scheduler.in_flight.items():
            peak[tenant] = max(peak.get(tenant, 0), c)
        peak_bytes[0] = max(peak_bytes[0],
                            svc.scheduler.pinned_bytes + svc.cache.device_bytes)
        return dispatch(*a, **k)

    svc.scheduler._dispatch = spying
    spills0 = svc.cache.stats.spills
    try:
        served, wall = leg("serve_pump", lambda: svc.scheduler.pump(q))
    finally:
        del svc.scheduler._dispatch
    check(len(served) == SERVE_PUMP and q.stats.rejected == 0,
          f"pump served {len(served)} of {SERVE_PUMP}, rejected {q.stats.rejected}")
    peak_bytes[0] = max(peak_bytes[0], svc.cache.device_bytes)
    check(peak_bytes[0] <= budget,
          f"pump: {peak_bytes[0]} device bytes over the budget {budget}")
    check(all(peak[t] <= quotas[t] for t in peak), f"pump: quota exceeded {peak}")
    for r in served:
        so = solo_runs(r.request.program, [r.request.source])[0]
        check(np.array_equal(r.values, so.values),
              f"pump: {r.request.program.name} lane of {r.request.source} != its solo run")
    out["pump"] = {"wall_s": wall, "budget_bytes": budget, "max_device_bytes": peak_bytes[0],
                   "peak_in_flight": peak, "queue": dataclasses.asdict(q.stats),
                   "spills": svc.cache.stats.spills - spills0,
                   "order": [(r.request.tenant, r.request.program.name, r.request.source)
                             for r in served]}
    log(f"serving pump: {SERVE_PUMP} SSSP/BFS requests of 3 tenants (quotas {quotas}) in "
        f"{wall:.3f} s, every answer == its solo run; peak in flight {peak}; device bytes "
        f"{peak_bytes[0]:,} <= budget {budget:,} (lanes + device tier at each dispatch); "
        f"{out['pump']['spills']} spills; launches {launches['serve_pump']}")
    svc.cache.policy = TierPolicy(max_reports=svc.max_reports)

    # -- 5. 8 Δ-PPR lanes within phase 4's SUM bound
    ppr = dataclasses.replace(PPR, tolerance=1e-5)
    ppr_sources = sources[:SERVE_PPR]
    res, wall = leg("serve_ppr", lambda: svc.query(ppr, ppr_sources))
    errs = []
    for s, r, so in zip(ppr_sources, res, solo_runs(ppr, ppr_sources)):
        lane = SimpleNamespace(values=r.values, delta=svc.cache.peek((ppr, s)).host_delta())
        ok, err, held = pr_close(lane, so, ppr)
        check(ok, f"serving: Δ-PPR lane of {s} vs its solo run out of tolerance ({err:.3e})")
        errs.append((err, held))
    out["ppr"] = {"wall_s": wall, "max_abs_err": max(e for e, _ in errs),
                  "bounds": sorted({h for _, h in errs}),
                  "iterations": [r.iterations for r in res]}
    log(f"serving Δ-PPR: {SERVE_PPR} lanes in {wall:.3f} s, max |err| vs solo "
        f"{out['ppr']['max_abs_err']:.3e} ({out['ppr']['bounds']} bound); launches "
        f"{launches['serve_ppr']}")

    # -- 6. three update batches, then a warm re-query
    # (phase 10's batches: the same seeds and sizes); the re-query takes the
    # pump's SSSP sources, whose states the budget spilled to the host tier
    applies = []
    for i in range(STREAM_BATCHES):
        batch = random_batch(svc.dcsr, np.random.default_rng(SEED + i), **STREAM_OPS)
        t = time.monotonic()
        svc.update(batch)
        torch.cuda.synchronize()
        applies.append(time.monotonic() - t)
    requery = pump_sources[0::2][:SERVE_REQUERY]
    promotions0 = svc.cache.stats.promotions
    res, wall = leg("serve_requery", lambda: svc.query(SSSP, requery), solo=True)
    check(all(r.mode == "incremental" for r in res), "serving: a re-query was not incremental")
    for s, r, so in zip(requery, res, solo_runs(SSSP, requery)):
        check(np.array_equal(r.values, so.values),
              f"serving: warm SSSP of {s} != a solo run over the updated runtime")
    out["requery"] = {"apply_s": applies, "wall_s": wall,
                      "promotions": svc.cache.stats.promotions - promotions0,
                      "iterations": [r.iterations for r in res]}
    log(f"serving updates: {STREAM_BATCHES} batches of {STREAM_OPS} applied in "
        f"{[round(a, 3) for a in applies]} s; {SERVE_REQUERY} re-queries all incremental and "
        f"== solo runs over the updated runtime ({out['requery']['promotions']} promoted from "
        f"the host tier), {wall:.3f} s; launches {launches['serve_requery']}")

    lane_legs = [k for k in launches if k != "serve_requery" and "solo" not in k]
    for name in ("segment_spmm_lanes", "frontier_compact_lanes", "hyb_gather"):
        check(sum(launches[k][name] for k in lane_legs) > 0,
              f"the serving lanes never launched {name}")
    out["stats"] = {"service": {k: v for k, v in dataclasses.asdict(svc.stats).items()
                                if k != "extra"},
                    "scheduler": dataclasses.asdict(svc.scheduler.stats),
                    "cache": svc.cache.stats.as_dict()}
    rows = lane_kernel_rows(torch, svc.dcsr, SEED)
    del svc
    torch.cuda.empty_cache()
    out["launches"] = launches
    # the legs that run the lanes (hyb_gather's lane path is its own entry)
    out["lane_legs"] = lane_legs
    return out, rows


# ---------------------------------------------------------------------------
# Phase 12: offline calibration and observability
# ---------------------------------------------------------------------------

PROBE_MAX_EDGES = 4_300_000   # a scale-22 partition holds about 1.05M edges
PROBE_REPEATS = 1
CALIB_ROUNDS = 1              # rounds of (pcie3, calibrated, calibrated, pcie3)
OBS_ROUNDS = 1                # rounds of (untraced, traced, traced, untraced)
OBS_LANES = 8


def engine_totals(res) -> dict:
    eng = res.history["engines"]
    return {name: int((eng == e).sum()) for e, name in ((0, "filter"), (1, "compact"),
                                                        (2, "zerocopy"))}


def spread(a) -> dict:
    a = np.asarray(a, float)
    return {"min": float(np.min(a)), "median": float(np.median(a)), "max": float(np.max(a))}


PROBE_KERNELS = {"filter": "segment_spmm", "compact": "frontier_compact",
                 "zerocopy": "hyb_gather"}   # the engines in ENGINE_FNS order


def probe_against_plain(torch, grid: list, dev) -> dict:
    """Each graph kernel against its plain version on every block that the
    probe times: ``_materialize`` with ``wall_probe``'s seeds (up to
    ``PROBE_MAX_EDGES`` edges, n = E, every degree regime and activity),
    each engine once through its kernel and once plain on the same block
    and operand.  SSSP combines by min, exact in any order, so the
    aggregates and the touched flags must be bit-equal.  Returns the
    blocks compared a kernel."""
    from repro_torch.autotune.probe import _materialize
    from repro_torch.core.engines import ENGINE_FNS
    from repro_torch.graph.algorithms import SSSP

    compared = dict.fromkeys(PROBE_KERNELS.values(), 0)
    for i, p in enumerate(grid):
        block, operand, n, real = _materialize(p, PROBE_MAX_EDGES, i, dev)
        for fn, (eng, kern) in zip(ENGINE_FNS, PROBE_KERNELS.items()):
            before = kernel_wrappers()[kern].launches
            k = fn(block, operand, n, SSSP, True)
            check(kernel_wrappers()[kern].launches > before,
                  f"probe block {i}: {eng} did not launch {kern}")
            q = fn(block, operand, n, SSSP, False)
            check(torch.equal(k.agg, q.agg) and torch.equal(k.touched, q.touched),
                  f"probe block {i} ({real}): {eng} through {kern} != plain")
            compared[kern] += 1
        del block, operand
    return compared


def phase_calibrate(torch, cfg, hs, rt, source: int, smi: str) -> tuple[dict, dict, dict]:
    """Phase 12: offline calibration (12a) and observability (12b) on the
    card.  Returns (numbers, launch counts of the solo-kernel legs, launch
    counts of the traced serving leg); each leg's counts are read after
    that leg alone."""
    import contextlib
    import io
    import tempfile

    from repro_torch.autotune import (calibrate, default_device_kind, default_grid,
                                      load_profile, observation_matrix, save_profile,
                                      selection_on_grid, wall_probe)
    from repro_torch.core.constants import PCIE3
    from repro_torch.core.hytm import run_hytm
    from repro_torch.graph.algorithms import SSSP
    from repro_torch.launch import calibrate as calibrate_cli
    from repro_torch.launch import serve_graph
    from repro_torch.obs import (TraceRecorder, reconcile, summary, to_chrome_trace,
                                 validate_chrome_trace, write_chrome_trace)
    from repro_torch.stream import GraphService

    out, launches, serve_launches = {"card": smi}, {}, {}
    names = ("filter", "compact", "zerocopy")

    def leg(name, fn, want=(), none=False):
        reset_launch_counts()
        res = fn()
        torch.cuda.synchronize()
        counts = read_launch_counts()
        for k in want:
            check(counts[k] > 0, f"{name} did not launch {k}")
        if none:
            check(not any(counts.values()), f"{name} (plain) launched {counts}")
        others = {k: v for k, v in counts.items() if k not in SERVE_KERNELS and v}
        check(not others, f"{name} launched {others}")
        return res, counts

    # -- 12a. wall probes through the kernels and plain, the fit, the registry
    grid = default_grid()
    t = time.monotonic()
    (pts, obs_k), launches["probe_kernels"] = leg(
        "probe_kernels", lambda: wall_probe(grid, max_edges=PROBE_MAX_EDGES,
                                            repeats=PROBE_REPEATS, device=rt.device),
        want=ALL_KERNELS)
    probe_s = time.monotonic() - t
    t = time.monotonic()
    (pts_p, obs_p), _ = leg(
        "probe_plain", lambda: wall_probe(grid, max_edges=PROBE_MAX_EDGES,
                                          repeats=PROBE_REPEATS, use_kernels=False,
                                          device=rt.device), none=True)
    probe_plain_s = time.monotonic() - t
    check(pts == pts_p, "the kernel and plain probes realized different points")
    t = time.monotonic()
    compared = probe_against_plain(torch, grid, rt.device)
    against_s = time.monotonic() - t
    log(f"probe blocks, each kernel against its plain version (SSSP, bit-equal): "
        f"{compared} of {len(grid)} blocks, E up to {PROBE_MAX_EDGES:,}, in {against_s:.1f} s")
    mk, mp = observation_matrix(pts, obs_k), observation_matrix(pts_p, obs_p)
    check(bool(np.isfinite(mk).all() and (mk > 0).all()), "probe: a non-positive time")
    out["probe"] = {
        "points": len(pts), "max_edges": PROBE_MAX_EDGES, "repeats": PROBE_REPEATS,
        "seconds": {"kernels": probe_s, "plain": probe_plain_s, "against_plain": against_s},
        "bit_equal_to_plain": compared,
        "launches": {k: launches["probe_kernels"][k] for k in ALL_KERNELS},
        "observed_s": {n: spread(mk[:, e]) for e, n in enumerate(names)},
        "plain_s": {n: spread(mp[:, e]) for e, n in enumerate(names)},
        "kernel_over_plain": {n: spread(mk[:, e] / mp[:, e]) for e, n in enumerate(names)},
        "kernels_s": mk.tolist(), "plain_rows_s": mp.tolist(),
        "realized": [[p.total_edges, p.active_edges, p.active_vertices] for p in pts],
    }
    log(f"probe: {len(pts)} points (E capped at {PROBE_MAX_EDGES:,}), {PROBE_REPEATS} timed "
        f"calls each, {probe_s:.1f} s through the kernels, {probe_plain_s:.1f} s plain; "
        f"launches {out['probe']['launches']} [{smi}]")
    for e, n in enumerate(names):
        o, r = out["probe"]["observed_s"][n], out["probe"]["kernel_over_plain"][n]
        log(f"probe {n}: wall s a relax min {o['min']:.3e} median {o['median']:.3e} max "
            f"{o['max']:.3e}; kernel/plain min {r['min']:.3f} median {r['median']:.3f} "
            f"max {r['max']:.3f}")

    rep = calibrate(pts, obs_k, PCIE3, fit_overhead=True)
    prof = rep.profile
    sel0, sel1 = selection_on_grid(pts, PCIE3), selection_on_grid(pts, prof)
    picks = {"pcie3": {n: int((sel0 == e).sum()) for e, n in enumerate(names)},
             "calibrated": {n: int((sel1 == e).sum()) for e, n in enumerate(names)}}
    out["fit"] = {"fitted": rep.fitted, "static_regret_s": rep.static_regret,
                  "calibrated_regret_s": rep.calibrated_regret,
                  "oracle_s": rep.oracle_seconds, "picks": picks,
                  "changed": int((sel0 != sel1).sum()),
                  "bandwidth_over_pcie3": prof.bandwidth / PCIE3.bandwidth}
    log("calibrated from 'pcie3' (fit_overhead): " + ", ".join(
        f"{k} {v:.6g}" for k, v in rep.fitted.items()))
    log(f"regret: static {rep.static_regret:.6e} s -> calibrated {rep.calibrated_regret:.6e} s "
        f"(oracle {rep.oracle_seconds:.6e} s); grid picks under pcie3 {picks['pcie3']}, "
        f"calibrated {picks['calibrated']} ({out['fit']['changed']} of {len(pts)} changed)")

    t = time.monotonic()
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        calibrate_cli.selfcheck("cuda")
    check("SELFCHECK OK" in buf.getvalue(), "launch.calibrate selfcheck on the card")
    log(f"launch.calibrate selfcheck on the card ({time.monotonic() - t:.1f} s):\n"
        + buf.getvalue().rstrip())
    kind = default_device_kind(rt.device)
    with tempfile.TemporaryDirectory() as reg:
        t = time.monotonic()
        buf = io.StringIO()
        with contextlib.redirect_stdout(buf):
            _, launches["calibrate_cli"] = leg(
                "calibrate_cli", lambda: calibrate_cli.main(["--registry", reg]),
                want=ALL_KERNELS)
        cli = load_profile(kind, reg)
        out["cli"] = {"seconds": time.monotonic() - t, "profile": dataclasses.asdict(cli)}
        log(f"launch.calibrate (wall mode, {out['cli']['seconds']:.1f} s):\n"
            + buf.getvalue().rstrip())
        path = save_profile(prof, device_kind=kind, base=reg,
                            meta={"initial": "pcie3", "mode": "wall", "grid": "default_grid",
                                  "max_edges": PROBE_MAX_EDGES, "card": smi})
        check(load_profile(kind, reg) == prof, "the saved profile reloaded unequal")
        log(f"profile saved under device kind {kind!r} ({path.name}), reloaded equal")

        # -- SSSP (K=8) and Δ-PageRank under the calibrated profile against pcie3
        check(prof.m == cfg.link.m and prof.d1 == cfg.link.d1,
              "the calibrated profile changes the runtime's request granule")
        legs = main_path_legs(cfg, source)
        calib = {}
        for name, leg_name in (("sssp", "sssp_k8"), ("pagerank", "pagerank")):
            prog, src, c = legs[leg_name]
            last = {}

            def under(which, link):
                def run():
                    reset_launch_counts()
                    last[which] = r = run_hytm(None, prog, src, dataclasses.replace(c, link=link),
                                               runtime=rt)
                    launches[f"calib_{name}_{which}"] = read_launch_counts()
                    return r.wall_seconds
                return run

            runs = leg_turns({"pcie3": under("pcie3", PCIE3),
                              "calibrated": under("calibrated", prof)}, CALIB_ROUNDS)
            a, b = last["pcie3"], last["calibrated"]
            if name == "sssp":
                check(np.array_equal(a.values, b.values),
                      "SSSP under the calibrated profile != under pcie3")
                held = "bit-equal"
            else:
                ok, err, held = pr_close(a, b, prog)
                check(ok, f"Δ-PageRank under the calibrated profile out of bound ({err:.3e})")
                held = f"max |err| {err:.3e} ({held} bound)"
            calib[name] = {
                "median_s": {w: float(np.median(v)) for w, v in runs.items()}, "runs": runs,
                "iterations": {w: r.iterations for w, r in last.items()},
                "engines": {w: engine_totals(r) for w, r in last.items()}, "held": held}
            log(f"calibrated {name}: median wall {calib[name]['median_s']['calibrated']:.4f} s "
                f"against {calib[name]['median_s']['pcie3']:.4f} s under pcie3 "
                f"({2 * CALIB_ROUNDS} runs each, in turns); iterations "
                f"{calib[name]['iterations']}; engine picks {calib[name]['engines']}; {held}")
        out["calibrated_runs"] = calib

        # -- 12b. traced runs on both drivers: reconcile, values, syncs, walls
        traced = {}
        for leg_name in ("sssp_k8", "sssp_k1"):
            prog, src, c = legs[leg_name]
            rec = TraceRecorder()
            reset_launch_counts()
            tr = run_hytm(None, prog, src, c, runtime=rt, obs=rec)
            launches[f"obs_{leg_name}"] = read_launch_counts()
            un = run_hytm(None, prog, src, c, runtime=rt)
            recon = reconcile(rec, tr)
            check(recon["ok"], f"traced {leg_name}: reconcile failed {recon['checks']}")
            check(same_min_run(tr, un), f"traced {leg_name} != untraced")
            # every host sync of a run, traced against untraced, with the
            # collector off so that no finalizer of an earlier object runs
            # inside the window
            gc.collect()
            gc.disable()
            try:
                sync_u = host_syncs(torch, run_wall(rt, legs[leg_name]))
                sync_t = host_syncs(torch, run_wall(rt, legs[leg_name], traced=True))
            finally:
                gc.enable()
            check(sync_t == sync_u and sum(sync_t.values()) > 0,
                  f"traced {leg_name} host syncs {sync_t} != untraced {sync_u}")
            chunks = -(-tr.iterations // c.sync_every)
            walls = leg_turns({"untraced": run_wall(rt, legs[leg_name]),
                               "traced": run_wall(rt, legs[leg_name], traced=True)}, OBS_ROUNDS)
            med = {w: float(np.median(v)) for w, v in walls.items()}
            traced[leg_name] = {
                "iterations": tr.iterations, "events": len(rec), "reconcile": recon["ok"],
                "host_syncs": sum(sync_t.values()), "chunks": chunks,
                "syncs_per_chunk": sum(sync_t.values()) / chunks,
                "sync_sites": {"traced": sync_t, "untraced": sync_u},
                "median_s": med, "runs": walls, "ratio": med["traced"] / med["untraced"]}
            log(f"traced {leg_name}: reconcile exact, values bit-equal, {len(rec)} events; host "
                f"syncs {sum(sync_t.values())} traced == {sum(sync_u.values())} untraced, site "
                f"by site ({traced[leg_name]['syncs_per_chunk']:.2f} a chunk; {sync_t}); median "
                f"wall {med['traced']:.4f} s traced vs {med['untraced']:.4f} s (ratio "
                f"{traced[leg_name]['ratio']:.3f}, {2 * OBS_ROUNDS} runs each, in turns)")
        out["traced"] = traced

        # -- traced serving: 8 SSSP queries through 8 lanes on the main graph
        rng = np.random.default_rng(SEED + 11)
        live = np.flatnonzero(np.diff(hs.graph.indptr) > 0)
        sources = [int(v) for v in rng.choice(live, SERVE_QUERIES, replace=False)][:OBS_LANES]
        rec = TraceRecorder()
        t = time.monotonic()
        svc = GraphService(hs.graph, legs["sssp_k8"][2], max_lanes=OBS_LANES, obs=rec,
                           device=rt.device)
        build_s = time.monotonic() - t
        reset_launch_counts()
        t = time.monotonic()
        res = svc.query(SSSP, sources)
        torch.cuda.synchronize()
        query_s = time.monotonic() - t
        counts = read_launch_counts()
        serve_launches["obs_serve"] = {k: counts[k] for k in SERVE_KERNELS}
        check(all(r.mode == "batched" for r in res), "traced serving: a query not batched")
        doc = to_chrome_trace(rec)
        n_ev = validate_chrome_trace(doc)
        tracks = {e.track for e in rec.events}
        check({"scheduler", "cache"} <= tracks and any(x.startswith("tenant:") for x in tracks),
              f"traced serving tracks {sorted(tracks)}")
        total = rec.metrics.counter("serve.requests").total()
        check(total == len(sources), f"serve.requests {total} != {len(sources)}")
        trace_path = ROOT / "build" / "phase12_serve_trace.json"
        trace_path.parent.mkdir(parents=True, exist_ok=True)
        write_chrome_trace(rec, str(trace_path))
        summ = summary(rec)
        out["serve_trace"] = {
            "queries": len(sources), "service_build_s": build_s, "query_s": query_s,
            "chrome_events": n_ev, "bytes": trace_path.stat().st_size,
            "tracks": sorted(tracks), "by_cat": summ["by_cat"],
            "counters": {k: v for k, v in summ["metrics"].items()
                         if k.split(".")[0] in ("serve", "admission", "cache")},
            "launches": serve_launches["obs_serve"]}
        log(f"traced serving: {len(sources)} SSSP queries through {OBS_LANES} lanes in "
            f"{query_s:.3f} s (service built in {build_s:.2f} s); Chrome trace valid, "
            f"{n_ev} events, {trace_path.stat().st_size:,} bytes -> "
            f"{os.path.relpath(trace_path, ROOT)}; tracks {sorted(tracks)}; by category "
            f"{summ['by_cat']}; launches {serve_launches['obs_serve']}")
        del svc, res

        # -- the launcher at its defaults with --trace and --calibrated
        cli_trace = ROOT / "build" / "phase12_serve_graph_trace.json"
        old_env = os.environ.get("REPRO_AUTOTUNE_REGISTRY")
        os.environ["REPRO_AUTOTUNE_REGISTRY"] = reg
        buf = io.StringIO()
        t = time.monotonic()
        try:
            with contextlib.redirect_stdout(buf):
                serve_graph.main(["--trace", str(cli_trace), "--calibrated"])
        finally:
            if old_env is None:
                del os.environ["REPRO_AUTOTUNE_REGISTRY"]
            else:
                os.environ["REPRO_AUTOTUNE_REGISTRY"] = old_env
        text = buf.getvalue()
        check(f"bandwidth {prof.bandwidth:.6g} B/s" in text,
              "serve_graph --calibrated did not serve under the saved profile")
        validate_chrome_trace(json.loads(cli_trace.read_text()))
        out["serve_graph_cli"] = {"seconds": time.monotonic() - t, "output": text.splitlines()}
        log(f"serve_graph --trace --calibrated ({out['serve_graph_cli']['seconds']:.1f} s):\n"
            + text.rstrip())
    torch.cuda.empty_cache()
    return out, launches, serve_launches


# ---------------------------------------------------------------------------
# Phase 13: resilience (fault plane, checkpoint/resume, supervisor, chaos)
# ---------------------------------------------------------------------------

CKPT_ROUNDS = 1       # rounds of (unhooked, hooked, hooked, unhooked) SSSP runs
CHAOS_QUERIES = 8     # a trace's queries before and after its update batch
CHAOS_TIERS = {"gold": 2, "silver": 1, "bronze": 0}
CHAOS_OPS = dict(n_insert=12, n_delete=12)   # the chaos trace's update batch


def chaos_plans(n: int, lane_bytes: int) -> dict:
    """The three fault plans of the chaos trace: name -> (fault specs,
    ``shed_after`` of a supervisor or None for none, device budget bytes).
    Plan 1's seed gives no run of more than 2 faults in a row, inside its
    4 attempts.  Plans 2 and 3 run at a budget that holds two lanes and no
    cached state, so every stored state spills: the promote that a warm
    start of a spilled state needs is plan 2's ``cache_promote`` target
    (at phase 11's budget the halved batches leave room for every cached
    state, nothing spills and that spec never fires), and the spill is
    plan 3's ``host_spill`` target."""
    from repro_torch.resilience import FaultSpec

    budget = 4 * lane_bytes + 2 * 8 * n    # phase 11's pump budget
    return {
        "dispatch": ([FaultSpec("lane_dispatch", "fail", p=0.3, max_fires=6),
                      FaultSpec("lane_dispatch", "timeout", p=0.2, max_fires=4)], 3, budget),
        "alloc": ([FaultSpec("lane_alloc", "oom", p=1.0, max_fires=100),
                   FaultSpec("cache_promote", "oom", p=0.5, max_fires=10)], 2, 2 * lane_bytes),
        "corrupt": ([FaultSpec("host_spill", "corrupt", at=(0, 1)),
                     FaultSpec("update_delivery", "drop", at=(0,)),
                     FaultSpec("update_redeliver", "duplicate", at=(0,))], None, 2 * lane_bytes),
    }


def phase_resilience(torch, cfg, hs, rt, source: int, main_runs: dict, smi: str) -> dict:
    """Phase 13: the resilience plane through the graph kernels.  SSSP (K=2)
    killed by an injected dispatch fault after chunks 1, 2 and 3 and resumed
    from its checkpoint, bit-equal to the uninterrupted run; Δ-PageRank
    (K=8) killed after chunk 1 and resumed within phase 4's bound; the
    checkpoint file read back with numpy alone (schema, crc table) and
    against the state copied from the card; hooked against unhooked SSSP in
    turns; the kernels->oracle rung of ``run_supervised``, whose launches
    must equal a kernel run capped at the degrade; the chaos trace through a
    ``GraphService`` (8 SSSP queries from three tenants, one update batch
    delivered exactly once, the 8 sources again) clean, under the three
    fault plans and with an empty plan against none in turns.  Every leg's
    launch counts are read after that leg alone."""
    import zlib

    from repro_torch.core.hytm import run_hytm
    from repro_torch.graph.algorithms import SSSP
    from repro_torch.obs import TraceRecorder, to_chrome_trace, validate_chrome_trace
    from repro_torch.resilience import (CheckpointHook, FaultPlan, FaultSpec, RetriesExhausted,
                                        RetryPolicy, Supervisor, deliver_update, plan_of,
                                        restore, resume_run, run_supervised, save)
    from repro_torch.serve import Request, RequestQueue
    from repro_torch.serve.scheduler import LANE_STATE_BYTES_PER_NODE
    from repro_torch.stream import GraphService, random_batch

    work = ROOT / "build" / "phase13"
    work.mkdir(parents=True, exist_ok=True)
    cfg2 = dataclasses.replace(cfg, sync_every=2)
    n = hs.graph.n_nodes
    out, launches = {"card": smi}, {}

    def counted(name, fn, need=()):
        """``fn()`` with the launch counts set to 0 before and read after:
        only graph kernels, each of ``need``, and at least one."""
        reset_launch_counts()
        res = fn()
        torch.cuda.synchronize()
        counts = read_launch_counts()
        others = {k: v for k, v in counts.items() if k not in SERVE_KERNELS and v}
        check(not others, f"{name} launched {others}")
        check(all(counts[k] > 0 for k in need) and sum(counts[k] for k in SERVE_KERNELS) > 0,
              f"{name} did not launch {need or 'a graph kernel'}: {counts}")
        launches[name] = {k: counts[k] for k in SERVE_KERNELS}
        return res

    def killed(prog, src, c, k, on_chunk) -> bool:
        """Whether ``run_hytm`` under ``on_chunk`` is killed by an injected
        fault at chunk dispatch ``k`` (no retry policy)."""
        plan = plan_of(FaultSpec("chunk_dispatch", "fail", at=(k,)), seed=SEED + k)
        try:
            run_hytm(None, prog, src, c, runtime=rt, faults=plan, on_chunk=on_chunk)
        except RetriesExhausted:
            return True
        return False

    # -- 13.1 kill and resume
    base = counted("resil_sssp_k2", lambda: run_hytm(None, SSSP, source, cfg2, runtime=rt),
                   ALL_KERNELS)
    kills = {}
    for k in (1, 2, 3):
        path = work / f"sssp_kill{k}.npz"
        hook = CheckpointHook(path, program=SSSP.name)
        snap = {}

        def on_chunk(*, state, **kw):
            hook(state=state, **kw)
            snap["state"] = [t.clone() for t in (state.values, state.delta, state.frontier)]

        check(counted(f"resil_kill{k}", lambda: killed(SSSP, source, cfg2, k, on_chunk)),
              f"the injected kill at chunk {k} did not fire")
        check(hook.saved == k, f"SSSP killed at chunk {k} after {hook.saved} checkpoints")
        t = time.monotonic()
        ck = restore(path, expect_anchor=(0, 0), program=SSSP.name)
        restore_s = time.monotonic() - t
        # 13.2 the file read back with numpy alone: the schema both packages
        # read, the crc table, the arrays the card held at the boundary
        with np.load(path) as z:
            arrays = {name: z[name] for name in z.files}
        meta = json.loads(arrays.pop("__meta__").tobytes().decode())
        check(meta["schema"] == 2 and meta["program"] == "sssp" and meta["iterations"] == 2 * k
              and meta["state_layout"] == "replicated" and set(meta["crc"]) == set(arrays),
              f"checkpoint {k}: metadata {dict(meta, crc=len(meta['crc']))}")
        check(all(zlib.crc32(np.ascontiguousarray(a).tobytes()) == meta["crc"][name]
                  for name, a in arrays.items()), f"checkpoint {k}: crc table does not hold")
        for name, want in zip(("values", "delta", "frontier"), snap["state"]):
            got = getattr(ck, name)
            want = want.cpu().numpy()
            check(got.dtype == want.dtype and np.array_equal(got, want),
                  f"checkpoint {k}: {name} != the state copied from the card")
        t = time.monotonic()
        res = counted(f"resil_resume{k}", lambda: resume_run(
            path, None, SSSP, config=cfg2, source=source, runtime=rt, expect_anchor=(0, 0)))
        resume_s = time.monotonic() - t
        check(same_min_run(res, base) and all(np.array_equal(res.history[h], base.history[h])
                                              for h in base.history),
              f"SSSP killed at chunk {k} and resumed != the uninterrupted K=2 run")
        kills[k] = {"restore_s": restore_s, "resume_s": resume_s, "bytes": path.stat().st_size,
                    "iterations_saved": ck.iterations}
    ck = restore(work / "sssp_kill1.npz")
    save_s = []
    for i in range(3):
        t = time.monotonic()
        save(ck, work / "save.npz")
        save_s.append(time.monotonic() - t)
    out["kill_resume"] = {"sssp_iterations": base.iterations, "kills": kills,
                          "checkpoint_bytes": kills[1]["bytes"], "save_s": save_s}
    log(f"resilience: SSSP (K=2, {base.iterations} iterations) killed at chunks 1, 2, 3 and "
        f"resumed: values, iterations, transfer bytes and history bit-equal to the "
        f"uninterrupted run; checkpoint {kills[1]['bytes']:,} bytes (numpy reads its schema 2, "
        f"crc table holds, arrays == the card's state); save {[round(s, 4) for s in save_s]} s, "
        f"restore {[round(v['restore_s'], 4) for v in kills.values()]} s, resume "
        f"{[round(v['resume_s'], 4) for v in kills.values()]} s [{smi}]")

    prog, _, cpr = main_path_legs(cfg, source)["pagerank"]
    path = work / "pagerank_kill1.npz"
    hook = CheckpointHook(path, program=prog.name)
    check(counted("resil_pagerank_kill1", lambda: killed(prog, None, cpr, 1, hook),
                  ("segment_spmm",)) and hook.saved == 1,
          "the injected Δ-PageRank kill did not fire after chunk 1")
    res = counted("resil_pagerank_resume", lambda: resume_run(
        path, None, prog, config=cpr, runtime=rt), ("segment_spmm",))
    full = main_runs["pagerank"]
    a, b = res.values + res.delta, full.values + full.delta
    err = float(np.max(np.abs(a - b)))
    check(np.allclose(a, b, rtol=1e-4, atol=1e-3),
          f"Δ-PageRank killed and resumed vs phase 4's run out of phase 4's bound ({err:.3e})")
    out["pagerank"] = {"iterations": res.iterations, "phase4_iterations": full.iterations,
                       "max_abs_err": err}
    log(f"resilience: Δ-PageRank (K=8) killed at chunk 1 and resumed: {res.iterations} "
        f"iterations (phase 4: {full.iterations}), max |err| {err:.3e} within phase 4's bound")

    turn_path = work / "turns.npz"
    walls = leg_turns({
        "unhooked": lambda: run_hytm(None, SSSP, source, cfg2, runtime=rt).wall_seconds,
        "hooked": lambda: run_hytm(None, SSSP, source, cfg2, runtime=rt, on_chunk=CheckpointHook(
            turn_path, program=SSSP.name)).wall_seconds,
    }, CKPT_ROUNDS)
    med = {k: float(np.median(v)) for k, v in walls.items()}
    chunks = -(-base.iterations // 2)
    # the hook's one host sync a saved boundary: its three arrays in one copy
    plain_syncs = host_syncs(torch, lambda: run_hytm(None, SSSP, source, cfg2, runtime=rt))
    hook = CheckpointHook(turn_path, program=SSSP.name)
    hooked_syncs = host_syncs(torch, lambda: run_hytm(None, SSSP, source, cfg2, runtime=rt,
                                                      on_chunk=hook))
    added = sum(hooked_syncs.values()) - sum(plain_syncs.values())
    check(added == hook.saved == chunks,
          f"the hook added {added} host syncs over {hook.saved} checkpoints: {hooked_syncs} "
          f"against {plain_syncs}")
    out["hook_turns"] = {"wall_s": walls, "median_s": med, "chunks": chunks,
                         "host_syncs": {"unhooked": sum(plain_syncs.values()),
                                        "hooked": sum(hooked_syncs.values())},
                         "ratio": med["hooked"] / med["unhooked"],
                         "per_chunk_s": (med["hooked"] - med["unhooked"]) / chunks}
    log(f"resilience: SSSP (K=2) hooked (a checkpoint every chunk) vs unhooked in turns over "
        f"{CKPT_ROUNDS} rounds: median {med['hooked']:.4f} s vs {med['unhooked']:.4f} s, "
        f"{out['hook_turns']['ratio']:.2f}x, {out['hook_turns']['per_chunk_s'] * 1e3:.1f} ms a "
        f"checkpoint over {chunks} chunks; host syncs {sum(hooked_syncs.values())} hooked vs "
        f"{sum(plain_syncs.values())} unhooked (one a checkpoint) [{smi}]")

    # -- 13.3 the degradation ladder: kernels -> oracle after chunk 2
    plan = plan_of(FaultSpec("chunk_dispatch", "fail", at=(2, 3), when={"kernels": True}),
                   seed=SEED)
    sup = Supervisor(policy=RetryPolicy(max_attempts=2), faults=plan)
    t = time.monotonic()
    res = counted("resil_ladder", lambda: run_supervised(
        None, SSSP, source, dataclasses.replace(cfg2, use_kernels="auto"), runtime=rt,
        supervisor=sup, ckpt_path=work / "ladder.npz"))
    ladder_s = time.monotonic() - t
    counted("resil_capped", lambda: run_hytm(
        None, SSSP, source, dataclasses.replace(cfg2, max_iters=4), runtime=rt))
    check([r for r, _ in sup.degradations] == ["kernels->oracle"],
          f"ladder: degradations {sup.degradations}")
    check(same_min_run(res, base), "ladder: the supervised answer != the kernel run")
    check(launches["resil_ladder"] == launches["resil_capped"],
          f"ladder: launches {launches['resil_ladder']} != a kernel run capped at 4 iterations "
          f"{launches['resil_capped']}")
    out["ladder"] = {"degradations": [r for r, _ in sup.degradations], "wall_s": ladder_s,
                     "counters": sup.counters, "faults": len(plan.events),
                     "launches": launches["resil_ladder"]}
    log(f"resilience ladder: one kernels->oracle degrade after {len(plan.events)} injected "
        f"faults, answer bit-equal to the kernel run, {ladder_s:.3f} s; graph kernel launches "
        f"{launches['resil_ladder']} == a kernel run capped at 4 iterations")

    # -- 13.4 the chaos trace: clean, under each plan, empty plan against none
    cfg8 = dataclasses.replace(cfg, sync_every=8)
    lane_bytes = LANE_STATE_BYTES_PER_NODE * n
    plans = chaos_plans(n, lane_bytes)
    budget = plans["dispatch"][2]
    rng = np.random.default_rng(SEED + 13)
    live = np.flatnonzero(np.diff(hs.graph.indptr) > 0)
    srcs = [int(v) for v in rng.choice(live, CHAOS_QUERIES, replace=False)]
    tenants = tuple(CHAOS_TIERS)
    trace = ([(tenants[i % 3], s) for i, s in enumerate(srcs)],
             [(tenants[(i + 2) % 3], s) for i, s in enumerate(reversed(srcs))])
    policy = RetryPolicy(max_attempts=4)
    batch = []

    def replay(faults=None, supervisor=None, obs=None, budget=budget):
        """The trace through a fresh service: completed (phase, tenant,
        source) -> values, the shed keys, the service, the wall seconds."""
        svc = GraphService(hs.graph, cfg8, max_lanes=SERVE_LANES, device_budget_bytes=budget,
                           faults=faults, supervisor=supervisor, obs=obs, device=rt.device)
        if not batch:
            batch.append(random_batch(svc.dcsr, np.random.default_rng(SEED + 13), **CHAOS_OPS))
        completed, shed = {}, []
        t = time.monotonic()
        for phase, specs in enumerate(trace):
            q = RequestQueue(quota=2, tenant_quotas={"bronze": 1})
            for i, (tenant, s) in enumerate(specs):
                q.submit(Request(tenant=tenant, program=SSSP, source=s, deadline=float(i)))
            for r in svc.scheduler.pump(q):
                key = (phase, r.request.tenant, r.request.source)
                if r.mode == "shed":
                    shed.append(key)
                elif r.mode != "rejected":
                    completed[key] = r.values
            check(q.stats.quota_violations == 0, f"chaos: quota violated {q.stats}")
            if phase == 0:
                deliver_update(svc, batch[0], batch_id="chaos-trace", faults=faults,
                               policy=policy, obs=obs)
        torch.cuda.synchronize()
        return completed, shed, svc, time.monotonic() - t

    def lanes(name, fn):
        res = counted(name, fn, ("segment_spmm_lanes", "hyb_gather"))
        check(all(launches[name][k] == 0 for k in SOLO_ONLY),
              f"{name} (lanes only) launched a solo kernel: {launches[name]}")
        return res

    t = time.monotonic()
    clean, _, svc, wall = lanes("resil_chaos_clean", replay)
    check(len(clean) == 2 * CHAOS_QUERIES and svc.version == 1,
          f"chaos: the clean replay completed {len(clean)}, version {svc.version}")
    chaos = {"clean": {"wall_s": wall, "completed": len(clean),
                       "scheduler": dataclasses.asdict(svc.scheduler.stats),
                       "cache": svc.cache.stats.as_dict()}}
    del svc
    for i, (name, (specs, shed_after, plan_budget)) in enumerate(plans.items(), start=1):
        plan = plan_of(*specs, seed=SEED + i)
        rec = TraceRecorder() if name == "dispatch" else None
        sup = None if shed_after is None else Supervisor(
            policy=policy, faults=plan, obs=rec, tenant_tiers=CHAOS_TIERS, shed_after=shed_after)
        got, shed, svc, wall = lanes(f"resil_chaos_{name}", lambda: replay(
            plan, sup, rec, plan_budget))
        check(set(got) <= set(clean) and not set(clean) - set(got) - set(shed),
              f"chaos {name}: requests lost without a shed record")
        check(all(np.array_equal(v, clean[k]) for k, v in got.items()),
              f"chaos {name}: a completed request != the clean replay")
        check(svc.version == 1, f"chaos {name}: version {svc.version} (update lost or doubled)")
        peak = svc.scheduler.stats.max_device_bytes
        check(peak <= plan_budget, f"chaos {name}: {peak} device bytes over {plan_budget}")
        check(all(CHAOS_TIERS[t] < max(CHAOS_TIERS[u] for u, _ in trace[p]) for p, t, _ in shed),
              f"chaos {name}: a top-tier request was shed {shed}")
        fired = plan.counts()
        check(all(fired.get((f.site, f.kind), 0) > 0 for f in specs),
              f"chaos {name}: a fault spec never fired {fired}")
        row = {"wall_s": wall, "completed": len(got), "shed": len(shed),
               "faults": {f"{s}/{k}": c for (s, k), c in plan.counts().items()},
               "supervisor": sup and sup.counters, "max_device_bytes": peak,
               "budget_bytes": plan_budget, "cache": svc.cache.stats.as_dict()}
        if name == "corrupt":
            check(svc.cache.stats.corrupt >= 1, f"chaos corrupt: no corrupt spill detected "
                  f"{svc.cache.stats.as_dict()}")
        if rec is not None:
            # 13.6 the faults track: one injected per plan event, one retry per retry
            track = [e.name for e in rec.events if e.track == "faults"]
            check(track.count("injected") == len(plan.events)
                  and track.count("retry") == sup.counters["retries"] > 0,
                  f"chaos {name}: faults track {track} vs {len(plan.events)} events, "
                  f"{sup.counters}")
            doc = to_chrome_trace(rec)
            row["trace_events"] = validate_chrome_trace(doc)
            with open(ROOT / "build" / "phase13_chaos_trace.json", "w") as f:
                json.dump(doc, f)
        chaos[name] = row
        del svc
        log(f"chaos {name}: {len(got)} completed bit-equal to the clean replay, {len(shed)} shed "
            f"(none top-tier), version 1, {peak:,} <= {plan_budget:,} device bytes; faults "
            f"{row['faults']}; supervisor {row['supervisor']}; cache {row['cache']}; "
            f"{wall:.3f} s (clean {chaos['clean']['wall_s']:.3f} s)"
            + (f"; Chrome trace valid, {row['trace_events']} events" if rec is not None else ""))

    # -- 13.5 zero overhead: an empty plan against none, in turns
    # (a service and its scheduler hold each other: collect the last
    # replay's before each turn, on both sides alike)
    turns = {"none": [], "empty": []}
    syncs = {"none": [], "empty": []}
    for i, kind in enumerate(("none", "empty", "empty", "none")):
        faults = FaultPlan(seed=SEED) if kind == "empty" else None
        gc.collect()
        runs = []
        sites = host_syncs(torch, lambda: runs.append(replay(faults)))
        got, shed, svc, wall = runs.pop()
        check(not shed and set(got) == set(clean)
              and all(np.array_equal(v, clean[k]) for k, v in got.items()),
              f"zero overhead: the {kind} replay != the clean replay")
        turns[kind].append(wall)
        syncs[kind].append({"chunks": svc.scheduler.stats.chunks, "sites": sites})
        del svc
    # every turn's host syncs, site by site, wherever they were issued
    sites = [r["sites"] for r in syncs["none"] + syncs["empty"]]
    chunks = syncs["none"][0]["chunks"]
    check(all(p == sites[0] for p in sites)
          and all(r["chunks"] == chunks for r in syncs["none"] + syncs["empty"]),
          f"zero overhead: the host syncs differ, site by site: {syncs}")
    med = {k: float(np.median(v)) for k, v in turns.items()}
    total = sum(sites[0].values())
    out["zero_overhead"] = {"wall_s": turns, "ratio": med["empty"] / med["none"],
                            "host_syncs": total, "chunks": chunks,
                            "syncs_per_chunk": total / max(chunks, 1), "sites": sites[0]}
    out["chaos"] = chaos
    out["chaos_s"] = time.monotonic() - t
    log(f"zero overhead (none, empty, empty, none): empty plan {turns['empty']} s vs none "
        f"{turns['none']} s, ratio {out['zero_overhead']['ratio']:.4f}; host syncs {total} in "
        f"{chunks} chunks ({total / max(chunks, 1):.2f} a chunk) in every turn, site by site "
        f"{sites[0]} [{smi}]")
    out["lane_legs"] = [k for k in launches if k.startswith("resil_chaos")]
    for name in ("segment_spmm_lanes", "frontier_compact_lanes", "hyb_gather"):
        check(sum(launches[k][name] for k in out["lane_legs"]) > 0,
              f"the chaos replays never launched {name}")
    out["launches"] = launches
    torch.cuda.empty_cache()
    return out


# ---------------------------------------------------------------------------
# Phase 14: the sharded sweep (dist.graph_shard, replicated and owner layouts)
# ---------------------------------------------------------------------------

SHARD_TURNS = 1       # rounds of (single-device sync, replicated, owner) runs, alternating
# legs (b) and (d)'s Δ-PageRank: no turns; each of its sharded runs stages
# 568 16-MB all_reduces through the host (12-26 s a run on the card), so its
# walls are the checked runs' against leg (a)'s single-device sync run
GLOO_PAGERANK_TURNS = 0
OWNER_LEGS = ("sssp_k8", "pagerank")   # the legs that also run the owner layout
KILL_AT = 2           # leg (d): the seeded chunk_dispatch plan fails chunk 2 (K=2)


def shard_legs(cfg, source: int) -> dict:
    """Phase 14's legs: name -> (program, source, single-device sync config);
    the sharded run of a leg is its config with ``mesh_axis="graph"``."""
    legs = main_path_legs(dataclasses.replace(cfg, async_sweep=False), source)
    return {name: legs[name] for name in ("sssp_k8", "sssp_k1", "pagerank")}


def engine_launches_match(res, counts: dict, cols=slice(None)) -> bool:
    """Each graph kernel launched iff the run picked its engine for one of
    the partitions ``cols`` (a rank's own), COMPACT and ZEROCOPY combining
    with the plain combine, and no other kernel ran."""
    picked = set(np.unique(res.history["engines"][:, cols]).tolist())
    return ([counts[k] > 0 for k in ALL_KERNELS] == [e in picked for e in (0, 1, 2)]
            and all(v == 0 for k, v in counts.items() if k not in ALL_KERNELS))


class TimedCollectives:
    """CUDA events around every ``torch.distributed`` ``all_reduce``,
    ``all_gather`` and ``reduce_scatter`` while entered (``graph_shard``
    reads the functions at each call); ``counts`` by collective."""

    NAMES = ("all_reduce", "all_gather", "reduce_scatter")

    def __init__(self, torch):
        self.torch, self.pairs = torch, []
        self.counts = {name: 0 for name in self.NAMES}

    def __enter__(self):
        import torch.distributed as dist

        self.dist, self.real = dist, {name: getattr(dist, name) for name in self.NAMES}

        def timed(name):
            real = self.real[name]

            def call(*args, **kwargs):
                start = self.torch.cuda.Event(enable_timing=True)
                end = self.torch.cuda.Event(enable_timing=True)
                start.record()
                out = real(*args, **kwargs)
                end.record()
                self.pairs.append((start, end))
                self.counts[name] += 1
                return out
            return call

        for name in self.NAMES:
            setattr(dist, name, timed(name))
        return self

    def __exit__(self, *exc):
        for name, real in self.real.items():
            setattr(self.dist, name, real)

    def ms(self) -> float:
        self.torch.cuda.synchronize()
        return float(sum(s.elapsed_time(e) for s, e in self.pairs))


def align_ranks(torch, mesh) -> None:
    """One small all_reduce on the group, waited for: the ranks leave it
    together (a rank that built its runtime faster does not charge the
    wait to its first timed collective), and NCCL builds its communicator
    at its first collective, outside the measured runs."""
    import torch.distributed as dist

    dist.all_reduce(torch.zeros(1, device=mesh.device), group=mesh.group)
    torch.cuda.synchronize()


def instrumented(torch, run, count_syncs: bool = True) -> dict:
    """One run of ``run(obs)`` with a ``TraceRecorder``, the collectives
    timed, the peak of allocated device memory reset before it and read
    after it, and (``count_syncs``) the host syncs counted: the result, the
    ICI instants' ``merged_entries`` and ``halo_entries`` and the result's
    ICI rows (the same run's: a SUM program's run on the card is not
    repeatable bit for bit), the collectives' ms an iteration, host syncs a
    dispatch, and the peak bytes (absolute, and above what was allocated
    when the run began)."""
    from repro_torch.obs import TraceRecorder, reconcile
    from repro_torch.obs.export import CAT_ICI

    rec, box = TraceRecorder(), {}
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    before = torch.cuda.memory_allocated()
    with TimedCollectives(torch) as coll:
        def call():
            box["res"] = run(rec)
        syncs = host_syncs(torch, call) if count_syncs else {}
        if not count_syncs:
            call()
    torch.cuda.synchronize()
    peak = torch.cuda.max_memory_allocated()
    res = box["res"]
    # dispatches: the chunks, or the K = 1 loop's iterations
    dispatches = sum(1 for ev in rec.events if ev.name == "chunk") or res.iterations
    check(reconcile(rec, res)["ok"], "sharded run: reconcile not exact")
    ici = [ev.args for ev in rec.events if ev.cat == CAT_ICI]
    return {"res": res, "merged": [a["merged_entries"] for a in ici],
            "halo": [a.get("halo_entries") for a in ici],
            "ici_rows": list(zip(*(res.history[k].tolist()
                                   for k in ("ici_bytes", "ici_time", "ici_engine")))),
            "collective_ms_per_iter": coll.ms() / res.iterations, "n_collectives": len(coll.pairs),
            "collectives": dict(coll.counts),
            "syncs": syncs, "dispatches": dispatches,
            "syncs_per_dispatch": sum(syncs.values()) / dispatches,
            "peak_bytes": peak, "peak_above_start": peak - before}


def shard_turns(runs: dict, rounds: int = SHARD_TURNS) -> dict:
    """Wall seconds of ``rounds`` rounds of the ``runs`` (name -> a call
    returning a wall time, or None on a rank that does not run it), the
    order reversed every other round."""
    walls = {name: [] for name in runs}
    order = list(runs)
    for r in range(rounds):
        for name in order if r % 2 == 0 else order[::-1]:
            if runs[name] is not None:
                walls[name].append(runs[name]())
    return walls


def owner_state_bytes(rt, program, source: int | None) -> dict:
    """The state triple's bytes on this rank, measured on the tensors the
    owner layout places (``dist.graph_shard._owner_place_state`` of the
    program's cold start), against ``cost_model.vertex_state_bytes`` of the
    owner layout with the largest halo and of the replicated layout."""
    from repro_torch.core.cost_model import vertex_state_bytes
    from repro_torch.dist.graph_shard import _owner_place_state

    st = _owner_place_state(rt, program, *program.init_state(rt.n_nodes, source, rt.device))
    D = rt.mesh.size
    return {"measured": sum(t.numel() * t.element_size()
                            for t in (st.values, st.delta, st.frontier)),
            "model_owner": vertex_state_bytes(rt.n_nodes, D, "owner", halo=rt.halo.max_halo),
            "model_owner_no_halo": vertex_state_bytes(rt.n_nodes, D, "owner"),
            "model_replicated": vertex_state_bytes(rt.n_nodes, D, "replicated")}


def owner_kill_resume(torch, g, prog, src, c, ort, path: str) -> dict:
    """Leg (d)'s kill and resume on one rank: SSSP (K=2) under the owner
    layout uninterrupted, then with a ``CheckpointHook`` and a seeded
    ``chunk_dispatch`` plan that fails chunk ``KILL_AT``, resumed by
    ``resume_run`` from the file rank 0 wrote."""
    from repro_torch.core.hytm import run_hytm
    from repro_torch.resilience import (CheckpointHook, FaultSpec, RetriesExhausted, plan_of,
                                        restore, resume_run)

    base = run_hytm(None, prog, src, c, runtime=ort)
    hook = CheckpointHook(path, program=prog.name, state_layout="owner", n_nodes=g.n_nodes)
    plan = plan_of(FaultSpec("chunk_dispatch", "fail", at=(KILL_AT,)), seed=SEED)
    killed = False
    try:
        run_hytm(None, prog, src, c, runtime=ort, faults=plan, on_chunk=hook)
    except RetriesExhausted:
        killed = True
    res = resume_run(path, g, prog, config=c, source=src, runtime=ort)
    ck = restore(path)
    return {"base": base, "res": res, "killed": killed, "saved": hook.saved,
            "committed": hook.committed, "fired": [(e.site, e.kind, e.occurrence)
                                                   for e in plan.events],
            "file": {"state_layout": ck.state_layout, "n_nodes": ck.n_nodes,
                     "iterations": ck.iterations, "shape": tuple(ck.values.shape)}}


def shard_rank(group, graph_dir: str, cfg, source: int, n_hubs: int) -> dict:
    """Legs (b) and (d) on one rank of a two-rank gloo group on one card:
    the graph from ``graph_dir`` (``.npy`` files), its sharded runtimes in
    both layouts, then SSSP (K=8) and Δ-PageRank instrumented in each
    layout, SSSP under a seeded ``chunk_dispatch`` plan, the owner layout's
    kill and resume (its checkpoint in ``graph_dir``), and the turns; rank 0
    also runs the single-device sync legs in the turns (rank 1 meanwhile
    waits in its next collective).
    Both ranks make the same sharded calls in the same order.  Rank 1
    counts the host syncs of its instrumented runs (its process logs no
    C++ warning: gloo's worker threads, which stage every collective
    through the host, sync outside the Python thread's site table)."""
    import torch

    from repro_torch.core.hytm import build_runtime, run_hytm
    from repro_torch.dist.graph_shard import build_sharded_runtime
    from repro_torch.graph.csr import CSRGraph
    from repro_torch.launch.mesh import make_graph_mesh
    from repro_torch.resilience import FaultSpec, RetryPolicy, plan_of

    t = time.monotonic()
    d = Path(graph_dir)
    g = CSRGraph(np.load(d / "indptr.npy"), np.load(d / "indices.npy"),
                 np.load(d / "weights.npy"))
    mesh = make_graph_mesh(group=group, device="cuda:0")
    legs = {k: v for k, v in shard_legs(cfg, source).items() if k != "sssp_k1"}
    shard = {k: dataclasses.replace(c, mesh_axis="graph") for k, (_, _, c) in legs.items()}
    owner = {k: dataclasses.replace(c, vertex_sharding="owner") for k, c in shard.items()}
    srt = build_sharded_runtime(g, shard["sssp_k8"], mesh, n_hubs=n_hubs)
    ort = build_sharded_runtime(g, owner["sssp_k8"], mesh, n_hubs=n_hubs)
    lead = mesh.rank == 0
    rt1 = build_runtime(g, cfg, n_hubs=n_hubs, device=mesh.device) if lead else None
    align_ranks(torch, mesh)

    def step(msg):
        if lead:
            log(f"  (b, d) rank 0: {msg} ({time.monotonic() - t:.1f} s into its task)")

    step("graph loaded, runtimes built")
    out = {"rank": mesh.rank, "launches": {}, "info": {}, "owner": {}, "walls": {},
           "halo": {"counts": ort.halo.halo_counts, "total": ort.halo.halo_total,
                    "n_pad": ort.n_pad}}
    for name, (prog, src, _) in legs.items():
        for layout, rt_, box in (("replicated", srt, out["info"]), ("owner", ort, out["owner"])):
            c = shard[name] if layout == "replicated" else owner[name]
            reset_launch_counts()
            box[name] = instrumented(
                torch, lambda rec, p=prog, s=src, cc=c, r=rt_:
                run_hytm(None, p, s, cc, runtime=r, obs=rec), count_syncs=not lead)
            out["launches"][(layout, name)] = read_launch_counts()
            step(f"{name} ({layout}) checked")
    prog, src, _ = legs["sssp_k8"]
    plan = plan_of(FaultSpec("chunk_dispatch", "fail", at=(0, 1)), seed=SEED)
    out["faulted"] = run_hytm(None, prog, src, shard["sssp_k8"], runtime=srt, faults=plan,
                              retry=RetryPolicy(max_attempts=4))
    out["fired"] = [(e.site, e.kind, e.occurrence) for e in plan.events]
    t_kill = time.monotonic()
    out["kill"] = owner_kill_resume(
        torch, g, prog, src, dataclasses.replace(owner["sssp_k8"], sync_every=2), ort,
        str(d / "owner.ckpt.npz"))
    out["kill"]["seconds"] = time.monotonic() - t_kill
    out["state_bytes"] = owner_state_bytes(ort, prog, src)
    step("owner kill and resume checked")
    for name, (prog, src, c) in legs.items():
        out["walls"][name] = shard_turns(
            {"single": (lambda p=prog, s=src, cc=c: run_hytm(None, p, s, cc,
                                                             runtime=rt1).wall_seconds)
             if lead else None,
             "sharded": lambda p=prog, s=src, cc=shard[name]: run_hytm(
                 None, p, s, cc, runtime=srt).wall_seconds,
             "owner": lambda p=prog, s=src, cc=owner[name]: run_hytm(
                 None, p, s, cc, runtime=ort).wall_seconds},
            rounds=GLOO_PAGERANK_TURNS if name == "pagerank" else SHARD_TURNS)
        step(f"{name} turns")
    return out


def shard_summary(name: str, single: dict, walls: dict, res, info: dict,
                  against: str = "single", checked: dict | None = None) -> dict:
    """One leg's line: its median wall against the ``against`` side of the
    same turns, the collectives' device ms an iteration, host syncs a
    dispatch and the run's peak device memory.  Where no turns ran, the
    walls are ``checked``'s: the checked runs' own (side -> [seconds])."""
    side = "owner" if against == "sharded" else "sharded"
    how = "in turns"
    if not walls[side]:
        walls, how = checked, "the checked runs"
    med = {k: float(np.median(v)) for k, v in walls.items() if v}
    log(f"  {name}: {res.iterations} iterations; median wall {med[side]:.4f} s vs "
        f"{med[against]:.4f} s {'replicated' if against == 'sharded' else 'single-device sync'}"
        f" (of {len(walls[side])} each, {how}; the instrumented run "
        f"{res.wall_seconds:.4f} s); collectives {info['collective_ms_per_iter']:.3f} ms an "
        f"iteration ({info['collectives']}); {info['syncs_per_dispatch']:.2f} host syncs a "
        f"dispatch ({info['dispatches']} dispatches: {info['syncs']}); peak allocated "
        f"{info['peak_bytes'] / 2**20:.1f} MiB ({info['peak_above_start'] / 2**20:.1f} MiB "
        "above the run's start)")
    return {"iterations": res.iterations, "median_s": med, "walls": walls,
            "instrumented_s": res.wall_seconds,
            "single_iterations": single["iterations"],
            **{k: info[k] for k in ("collective_ms_per_iter", "n_collectives", "collectives",
                                    "syncs", "dispatches", "syncs_per_dispatch", "peak_bytes",
                                    "peak_above_start")}}


def phase_sharded(torch, cfg, hs, rt, source: int, smi: str) -> dict:
    """Phase 14: ``run_hytm`` with ``mesh_axis="graph"`` through the kernels
    at full size.  Leg (a): NCCL at world size 1 in this process, SSSP
    (K=8, K=1) and Δ-PageRank against the single-device ``async_sweep=False``
    runs on the card (SSSP bit-equal in values, iterations, bytes and
    engines; Δ-PageRank within phase 4's bound; ICI rows zero).  Leg (b):
    two ranks on this one card over gloo (this process rank 0, one spawned
    rank 1; the graph handed over as ``.npy`` files): the same SSSP (K=8)
    and Δ-PageRank held to the same contract, both ranks' results equal,
    the ``merged_entries`` rows equal leg (a)'s (touched sets are unions) so
    the D = 2 ICI rows are ``ici_level_cost`` of them, and a seeded
    ``chunk_dispatch`` plan that fires on both ranks leaves SSSP bit-equal.
    Legs (c) and (d): the owner layout (``vertex_sharding="owner"``) in the
    same processes as legs (a) and (b).  At D = 1 (c) ``n_pad = n`` and the
    halo is empty: SSSP (K=8) bit-equal to leg (a) and to the sync run,
    Δ-PageRank within phase 4's bound of leg (a) (its sum kernel's atomics
    make no two card runs bit-equal), ICI rows zero.  At D = 2 (d): SSSP
    bit-equal to the sync run, Δ-PageRank within bound, both ranks equal,
    SSSP's ``merged_entries`` equal to leg (a)'s and the ICI rows
    ``halo_level_cost`` of them under the halo both ranks computed alike;
    SSSP (K=2) killed at chunk 2 on both ranks and resumed bit-equal, rank
    0 alone writing an owner checkpoint with the real ``n_nodes``.
    Each leg's launches: the kernels of the engines it picked, and no
    other.  Wall seconds in turns of the single-device sync run, the
    replicated and the owner layout (1 round; at D = 2 Δ-PageRank none:
    the checked runs' walls), the
    collectives' device ms an iteration (CUDA events; gloo stages them
    through the host), host syncs a dispatch, each rank's peak allocated
    memory in each layout, and the owner state triple's bytes against
    ``vertex_state_bytes``."""
    import tempfile

    from repro_torch.core.hytm import run_hytm
    from repro_torch.dist.graph_shard import (build_sharded_runtime, halo_level_cost,
                                              ici_level_cost)
    from repro_torch.launch.mesh import RankPool, make_graph_mesh

    legs = shard_legs(cfg, source)
    shard = {k: dataclasses.replace(c, mesh_axis="graph") for k, (_, _, c) in legs.items()}
    owner = {k: dataclasses.replace(shard[k], vertex_sharding="owner") for k in OWNER_LEGS}
    out, launches = {"card": smi}, {}
    single = {}
    for name, (prog, src, c) in legs.items():
        single[name] = run_hytm(None, prog, src, c, runtime=rt)

    def held(name, res, where, against=None):
        s = single[name] if against is None else against
        if name == "pagerank":
            a, b = res.values + res.delta, s.values + s.delta
            err = float(np.max(np.abs(a - b)))
            check(bool(np.all(np.isfinite(a))) and np.allclose(a, b, rtol=1e-4, atol=1e-3),
                  f"{where} Δ-PageRank vs single-device sync: max |err| {err:.3e}")
            return {"max_abs_err": err}
        check(same_min_run(res, s),
              f"{where} {name} != single-device sync (values/iterations/bytes/engines)")
        return {"bit_equal": True}

    def memory_line(where, rep, own, state):
        log(f"  {where} peak allocated: owner {own['peak_bytes']} B vs replicated "
            f"{rep['peak_bytes']} B ({own['peak_above_start']} B vs {rep['peak_above_start']} B "
            f"above the run's start); state triple {state['measured']} B measured vs "
            f"vertex_state_bytes owner {state['model_owner']} B (largest halo; "
            f"{state['model_owner_no_halo']} B without), replicated "
            f"{state['model_replicated']} B")

    # -- legs (a) and (c): NCCL, world size 1, this process
    t = time.monotonic()
    a, c_leg = {}, {}
    with RankPool(1, backend="nccl", timeout_s=120.0):
        mesh = make_graph_mesh(device=rt.device)
        srt = build_sharded_runtime(hs.graph, shard["sssp_k8"], mesh, n_hubs=hs.n_hubs)
        ort = build_sharded_runtime(hs.graph, owner["sssp_k8"], mesh, n_hubs=hs.n_hubs)
        check(ort.n_pad == hs.graph.n_nodes and ort.halo.halo_counts == (0,),
              f"leg (c): n_pad {ort.n_pad}, halo {ort.halo.halo_counts} at D = 1")
        align_ranks(torch, mesh)
        summary, infos = {}, {}
        for name, (prog, src, c) in legs.items():
            sides = [("replicated", srt, shard[name], a)]
            if name in owner:
                sides.append(("owner", ort, owner[name], c_leg))
            for layout, r_, cc, box in sides:
                reset_launch_counts()
                info = infos[(layout, name)] = instrumented(
                    torch, lambda rec, p=prog, s=src, k=cc, r=r_:
                    run_hytm(None, p, s, k, runtime=r, obs=rec))
                key = f"sharded_nccl_{name}" if layout == "replicated" else \
                    f"owner_nccl_{name}"
                counts = launches[key] = read_launch_counts()
                res = info["res"]
                where = "leg (a)" if layout == "replicated" else "leg (c)"
                check(engine_launches_match(res, counts),
                      f"{where} {name}: launches {counts} do not match its engines")
                check(res.total_ici_bytes == 0.0
                      and bool((res.history["ici_engine"] == -1).all())
                      and not res.history["ici_time"].any(), f"{where} {name}: ICI rows not zero")
                box[name] = {"merged": info["merged"], **held(name, res, where)}
            if name in owner:
                rep, own = infos[("replicated", name)]["res"], infos[("owner", name)]["res"]
                if name == "pagerank":
                    c_leg[name]["vs_replicated"] = held(name, own, "leg (c) vs leg (a)", rep)
                    c_leg[name]["bit_equal_replicated"] = bool(
                        np.array_equal(own.values, rep.values)
                        and np.array_equal(own.delta, rep.delta))
                else:
                    check(same_min_run(own, rep) and np.array_equal(own.delta, rep.delta),
                          f"leg (c) {name} != leg (a)")
                    c_leg[name]["bit_equal_replicated"] = True
            walls = shard_turns(
                {"single": lambda p=prog, s=src, k=c: run_hytm(None, p, s, k,
                                                               runtime=rt).wall_seconds,
                 "sharded": lambda p=prog, s=src, k=shard[name]: run_hytm(
                     None, p, s, k, runtime=srt).wall_seconds,
                 "owner": (lambda p=prog, s=src, k=owner[name]: run_hytm(
                     None, p, s, k, runtime=ort).wall_seconds) if name in owner else None})
            summary[name] = shard_summary(f"(a) nccl D=1 {name}", vars(single[name]), walls,
                                          infos[("replicated", name)]["res"],
                                          infos[("replicated", name)])
            if name in owner:
                c_leg[name].update(shard_summary(
                    f"(c) nccl D=1 owner {name}", vars(single[name]), walls,
                    infos[("owner", name)]["res"], infos[("owner", name)], against="sharded"))
                memory_line(f"(c) {name}", infos[("replicated", name)], infos[("owner", name)],
                            owner_state_bytes(ort, prog, src))
        c_leg["state_bytes"] = owner_state_bytes(ort, *legs["sssp_k8"][:2])
        log("phase 14 leg (a), NCCL at world size 1: SSSP (K=8, K=1) bit-equal to the "
            "single-device sync runs, Δ-PageRank within phase 4's bound "
            f"(max |err| {a['pagerank']['max_abs_err']:.3e}), ICI rows zero; leg (c), the owner "
            "layout: SSSP (K=8) bit-equal to leg (a), Δ-PageRank within bound of leg (a) "
            f"(max |err| {c_leg['pagerank']['vs_replicated']['max_abs_err']:.3e}, bit-equal "
            f"{c_leg['pagerank']['bit_equal_replicated']}), ICI rows zero; launches "
            + str({k: {kk: v for kk, v in c.items() if kk in ALL_KERNELS}
                   for k, c in launches.items()}))
        del srt, ort
    torch.cuda.empty_cache()
    out["nccl_d1"] = summary
    out["owner_nccl_d1"] = c_leg
    out["nccl_d1"]["seconds"] = time.monotonic() - t
    log(f"phase 14 legs (a) and (c) took {out['nccl_d1']['seconds']:.1f} s")

    # -- legs (b) and (d): gloo, two ranks on this card
    t = time.monotonic()
    with tempfile.TemporaryDirectory(prefix="phase14_") as tmp:
        g = hs.graph
        for key, arr in (("indptr", g.indptr), ("indices", g.indices),
                         ("weights", g.weights if g.weights is not None
                          else np.ones(g.n_edges, np.float32))):
            np.save(Path(tmp) / f"{key}.npy", arr)
        # the spawned rank logs no C++ warning (its gloo threads' syncs
        # under the sync debug mode), so its host-sync count stays readable
        level = os.environ.get("TORCH_CPP_LOG_LEVEL")
        os.environ["TORCH_CPP_LOG_LEVEL"] = "ERROR"
        try:
            pool = RankPool(2, backend="gloo", timeout_s=300.0)
        finally:
            if level is None:
                del os.environ["TORCH_CPP_LOG_LEVEL"]
            else:
                os.environ["TORCH_CPP_LOG_LEVEL"] = level
        with pool:
            ranks = pool.run(shard_rank, tmp, cfg, source, hs.n_hubs)
    r0, r1 = ranks
    half = rt.parts.n_partitions // 2
    b, d = {}, {}
    check(r0["halo"] == r1["halo"],
          f"leg (d): the ranks' halo plans differ: {r0['halo']} vs {r1['halo']}")
    halo_total = r0["halo"]["total"]
    for layout, box, key in (("replicated", b, "info"), ("owner", d, "owner")):
        where = "leg (b)" if layout == "replicated" else "leg (d)"
        for name in ("sssp_k8", "pagerank"):
            res, other = r0[key][name]["res"], r1[key][name]["res"]
            for r in ranks:
                counts = r["launches"][(layout, name)]
                tag = "sharded_gloo" if layout == "replicated" else "owner_gloo"
                launches[f"{tag}_{name}_rank{r['rank']}"] = counts
                own = slice(r["rank"] * half, (r["rank"] + 1) * half)
                check(engine_launches_match(r[key][name]["res"], counts, own),
                      f"{where} {name} rank {r['rank']}: launches {counts} do not match its "
                      "engines")
            check(all(np.array_equal(res.history[k], other.history[k]) for k in res.history)
                  and np.array_equal(res.values, other.values)
                  and np.array_equal(res.delta, other.delta),
                  f"{where} {name}: the two ranks' results differ")
            box[name] = held(name, res, where)
            merged = r0[key][name]["merged"]
            check(merged == r1[key][name]["merged"],
                  f"{where} {name}: the two ranks' merged_entries differ")
            # touched sets are unions, so a MIN program's rows equal leg (a)'s; a
            # SUM program's frontier may move at its tolerance with the merge's
            # float order, and with it the rows (reported, not required)
            box[name]["merged_equal_leg_a"] = merged == a[name]["merged"]
            check(box[name]["merged_equal_leg_a"] or name == "pagerank",
                  f"{where} {name}: merged_entries differ from leg (a)'s")
            if layout == "replicated":
                want = [ici_level_cost(g.n_nodes, m, 2, cfg.ici_link) for m in merged]
            else:
                want = [halo_level_cost(g.n_nodes, m, halo_total, 2, cfg.ici_link)
                        for m in merged]
                check(r0[key][name]["halo"] == [min(m, float(halo_total)) for m in merged],
                      f"{where} {name}: the ici instants' halo_entries are not the capped rows")
            check(r0[key][name]["ici_rows"] == [tuple(w) for w in want],
                  f"{where} {name}: ICI rows != the model's cost of the merged entries")
            box[name]["ici_engines"] = {int(e): int(n) for e, n in zip(
                *np.unique(res.history["ici_engine"], return_counts=True))}
    check(bool(r0["fired"]) and r0["fired"] == r1["fired"],
          f"leg (b): the fault plan fired {r0['fired']} on rank 0, {r1['fired']} on rank 1")
    check(same_min_run(r0["faulted"], r0["info"]["sssp_k8"]["res"])
          and same_min_run(r1["faulted"], r0["info"]["sssp_k8"]["res"]),
          "leg (b): SSSP under the fault plan != the clean run")
    for r in ranks:
        k = r["kill"]
        check(k["killed"] and k["fired"] == r0["kill"]["fired"],
              f"leg (d) rank {r['rank']}: the kill at chunk {KILL_AT} did not fire alike")
        # the resumed history's ICI rows are the resumed part's only
        check(same_min_run(k["res"], k["base"])
              and all(np.array_equal(k["res"].history[h], k["base"].history[h])
                      for h in k["base"].history if not h.startswith("ici_")),
              f"leg (d) rank {r['rank']}: the resumed SSSP != the uninterrupted owner run")
        check(k["saved"] == (KILL_AT if r["rank"] == 0 else 0) and k["committed"] == KILL_AT,
              f"leg (d) rank {r['rank']}: saved {k['saved']}, committed {k['committed']}")
        check(k["file"]["state_layout"] == "owner" and k["file"]["n_nodes"] == g.n_nodes
              and k["file"]["shape"] == (r0["halo"]["n_pad"],),
              f"leg (d): the checkpoint says {k['file']}")
    check(same_min_run(r0["kill"]["base"], r1["kill"]["base"]),
          "leg (d): the ranks' uninterrupted K=2 runs differ")
    log(f"phase 14 leg (b), gloo at D=2 on one card: SSSP bit-equal to the single-device sync "
        f"run, Δ-PageRank within phase 4's bound (max |err| {b['pagerank']['max_abs_err']:.3e}), "
        f"both ranks equal, merged_entries equal leg (a)'s (Δ-PageRank: "
        f"{b['pagerank']['merged_equal_leg_a']}), ICI engines "
        f"{ {k: v['ici_engines'] for k, v in b.items()} }; faults {r0['fired']} on both ranks, "
        "SSSP bit-equal")
    log(f"phase 14 leg (d), the owner layout on the same ranks: n_pad {r0['halo']['n_pad']}, "
        f"halo counts {r0['halo']['counts']} (rank 0) and {r1['halo']['counts']} (rank 1), "
        f"halo_total {halo_total} on both; SSSP bit-equal to the sync run, Δ-PageRank within "
        f"bound (max |err| {d['pagerank']['max_abs_err']:.3e}), both ranks equal, SSSP's "
        f"merged_entries equal leg (a)'s, ICI rows halo_level_cost of them, ICI engines "
        f"{ {k: v['ici_engines'] for k, v in d.items()} }; SSSP (K=2) killed at chunk {KILL_AT} "
        f"on both ranks ({r0['kill']['fired']}), resumed bit-equal "
        f"({r0['kill']['res'].iterations} iterations) in {r0['kill']['seconds']:.1f} s, saved "
        f"{r0['kill']['saved']} (rank 0) and {r1['kill']['saved']} (rank 1), the file "
        f"{r0['kill']['file']}")
    # the walls and collective times are rank 0's, the host syncs rank 1's
    syncs_of = ("syncs", "dispatches", "syncs_per_dispatch")
    checked = {name: {"single": [single[name].wall_seconds],
                      "sharded": [r0["info"][name]["res"].wall_seconds],
                      "owner": [r0["owner"][name]["res"].wall_seconds]}
               for name in ("sssp_k8", "pagerank")}
    out["gloo_d2"] = {name: {**b[name], **shard_summary(
        f"(b) gloo D=2 {name}", vars(single[name]), r0["walls"][name], r0["info"][name]["res"],
        {**r0["info"][name], **{k: r1["info"][name][k] for k in syncs_of}},
        checked=checked[name])} for name in ("sssp_k8", "pagerank")}
    out["owner_gloo_d2"] = {name: {**d[name], **shard_summary(
        f"(d) gloo D=2 owner {name}", vars(single[name]), r0["walls"][name],
        r0["owner"][name]["res"], {**r0["owner"][name],
                                   **{k: r1["owner"][name][k] for k in syncs_of}},
        against="sharded", checked=checked[name])} for name in ("sssp_k8", "pagerank")}
    for r in ranks:
        for name in ("sssp_k8", "pagerank"):
            memory_line(f"(d) rank {r['rank']} {name}", r["info"][name], r["owner"][name],
                        r["state_bytes"])
        out["owner_gloo_d2"][f"memory_rank{r['rank']}"] = {
            name: {layout: {k: r[key][name][k] for k in ("peak_bytes", "peak_above_start")}
                   for layout, key in (("replicated", "info"), ("owner", "owner"))}
            for name in ("sssp_k8", "pagerank")}
        out["owner_gloo_d2"][f"state_bytes_rank{r['rank']}"] = r["state_bytes"]
    out["owner_gloo_d2"]["halo"] = {"rank0": r0["halo"], "rank1": r1["halo"]}
    out["owner_gloo_d2"]["kill_resume_s"] = r0["kill"]["seconds"]
    out["gloo_d2"]["fired"] = r0["fired"]
    out["gloo_d2"]["seconds"] = time.monotonic() - t
    log(f"phase 14 legs (b) and (d) took {out['gloo_d2']['seconds']:.1f} s (collectives staged "
        "through the host by gloo; the exchange between two devices is not measured: one card)")
    out["launches"] = launches
    return out


# ---------------------------------------------------------------------------
# Phase 15: the sharded stream and serving paths (DeltaCSR views,
# run_incremental and GraphService on a mesh)
# ---------------------------------------------------------------------------

MESH_LAYOUTS = ("replicated", "owner")
MESH_SERVE_LANES = 8
MESH_SERVE_QUERIES = 16
MESH_TURN_ROUNDS = 1   # rounds of (single-device sync, replicated, owner) services, alternating
G_PARTITIONS = 63      # leg (g): P_pad 64 at D = 2, so one padding partition
G_LANES, G_QUERIES = 4, 8


def mesh_stream_configs(cfg) -> tuple:
    """Phase 15's configs: the single-device sync SSSP (K=8) and Δ-PageRank
    configs, and each layout's sharded counterpart of both."""
    pr_cfg = main_path_legs(cfg, 0)["pagerank"][2]
    sync8 = dataclasses.replace(cfg, sync_every=8, async_sweep=False)
    sync_pr = dataclasses.replace(pr_cfg, async_sweep=False)

    def on_mesh(c):
        return {l: dataclasses.replace(c, mesh_axis="graph", vertex_sharding=l)
                for l in MESH_LAYOUTS}
    return sync8, sync_pr, on_mesh(sync8), on_mesh(sync_pr)


def view_is_slice(dcsr, view) -> bool:
    """A view's edge columns are slices of the container's device columns
    (so its in-place patches reach them) over the rank's partitions."""
    from repro_torch.dist.graph_shard import blocked_ranges

    e0, e1 = blocked_ranges(dcsr.n_partitions, dcsr.block_size, view.mesh.size)[view.mesh.rank]
    return (view.edge_base == e0 and view.edge_src.shape[0] == e1 - e0
            and view.edge_src.data_ptr() == dcsr.csr.edge_src[e0:].data_ptr()
            and view.parts.part_edges[:dcsr.n_partitions].tolist() == dcsr.counts.tolist())


def counted(torch, name: str, fn, launches: dict, lanes: bool = False):
    """Run ``fn`` with every launch count set to 0 just before and read just
    after; returns (result, wall seconds, counts).  A leg launches graph
    kernels only; a lane leg at least one lane entry and no solo
    ``segment_spmm``/``frontier_compact``."""
    reset_launch_counts()
    t = time.monotonic()
    res = fn()
    torch.cuda.synchronize()
    wall = time.monotonic() - t
    counts = read_launch_counts()
    others = {k: v for k, v in counts.items() if k not in SERVE_KERNELS and v}
    check(not others, f"{name} launched {others}")
    check(sum(counts[k] for k in SERVE_KERNELS) > 0, f"{name} launched no graph kernel")
    if lanes:
        check(all(counts[k] == 0 for k in SOLO_ONLY),
              f"{name} (lanes only) launched a solo kernel: {counts}")
    launches[name] = {k: counts[k] for k in SERVE_KERNELS}
    return res, wall, launches[name]


def mesh_stream_leg(torch, cfg, hs, rt, source: int, stream: dict, mesh, launches: dict) -> dict:
    """Leg (e): one DeltaCSR of the main graph with both layouts' views
    registered before the first batch; phase 10's three batches, each
    followed by a warm SSSP on the mesh in both layouts held bit-equal to
    the single-device sync warm run; after the last, fewer iterations than
    a cold sharded run and a warm Δ-PageRank within phase 4's bound; then
    the no-slack merge-compaction with the views refilled."""
    from repro_torch.core.hytm import run_hytm
    from repro_torch.graph.algorithms import SSSP
    from repro_torch.stream import DeltaCSR, EdgeBatch, random_batch, run_incremental

    pr = main_path_legs(cfg, source)["pagerank"][0]
    sync8, sync_pr, shard, shard_pr = mesh_stream_configs(cfg)
    out = {}
    t = time.monotonic()
    dcsr = DeltaCSR(hs.graph, shard["replicated"], device=rt.device)
    views = {l: dcsr.sharded_runtime_for(SSSP, mesh, vertex_sharding=l) for l in MESH_LAYOUTS}
    torch.cuda.synchronize()
    out["build_s"] = time.monotonic() - t
    check(all(view_is_slice(dcsr, v) for v in views.values()),
          "leg (e): a view's columns are not the container's")
    cold, _, _ = counted(torch, "mesh_stream_single_cold", lambda: run_hytm(
        None, SSSP, source, sync8, runtime=dcsr.runtime_for(SSSP)), launches)
    cold_pr, _, _ = counted(torch, "mesh_stream_single_cold_pagerank", lambda: run_hytm(
        None, pr, None, sync_pr, runtime=dcsr.runtime_for(pr)), launches)
    warm, reps, rows = cold, [], []
    for i in range(STREAM_BATCHES):
        batch = random_batch(dcsr, np.random.default_rng(SEED + i), **STREAM_OPS)
        t = time.monotonic()
        rep = dcsr.apply(batch)
        torch.cuda.synchronize()
        row = {"apply_s": time.monotonic() - t, **{f"view_{k}_s": v
                                                   for k, v in dcsr.view_seconds.items()},
               "phase10_apply_s": stream["batches"][i]["apply_s"],
               "phase10_warm_s": stream["batches"][i]["sssp"]["wall_s"]}
        check(not rep.merged, f"leg (e) batch {i} merged")
        reps.append(rep)
        single, _, _ = counted(torch, f"mesh_stream_single_b{i}", lambda: run_incremental(
            dcsr, SSSP, [rep], warm.values, warm.delta, source, config=sync8), launches)
        row["single"] = {"wall_s": single.wall_seconds, "iterations": single.iterations}
        for l in MESH_LAYOUTS:
            res, _, counts = counted(torch, f"mesh_stream_{l}_b{i}", lambda l=l: run_incremental(
                dcsr, SSSP, [rep], warm.values, warm.delta, source, config=shard[l], mesh=mesh),
                launches)
            check(same_min_run(res, single),
                  f"leg (e) batch {i}: warm SSSP on the mesh ({l}) != the single-device sync "
                  "warm run (values/iterations/bytes/engines)")
            check(engine_launches_match(res, counts),
                  f"leg (e) batch {i} ({l}): launches {counts} do not match its engines")
            row[l] = {"wall_s": res.wall_seconds, "iterations": res.iterations}
        rows.append(row)
        log(f"  (e) batch {i}: {len(batch)} ops, apply {row['apply_s']:.3f} s (view refresh "
            f"{row['view_patch_s']:.3f} s, owner halo {row['view_halo_s']:.3f} s; phase 10 "
            f"{row['phase10_apply_s']:.3f} s); warm SSSP {single.iterations} iterations, "
            f"single-device sync {single.wall_seconds:.4f} s, replicated "
            f"{row['replicated']['wall_s']:.4f} s, owner {row['owner']['wall_s']:.4f} s "
            f"(phase 10's async warm run {row['phase10_warm_s']:.4f} s), bit-equal")
        warm = single
    out["batches"] = rows
    out["cold"] = {}
    for l in MESH_LAYOUTS:
        c, _, _ = counted(torch, f"mesh_stream_{l}_cold", lambda l=l: run_hytm(
            None, SSSP, source, shard[l], runtime=views[l]), launches)
        check(np.array_equal(c.values, warm.values) and warm.iterations < c.iterations,
              f"leg (e) ({l}): warm {warm.iterations} iterations vs cold {c.iterations}, or "
              "different values")
        out["cold"][l] = {"iterations": c.iterations, "wall_s": c.wall_seconds}
    single_pr, _, _ = counted(torch, "mesh_stream_single_pagerank", lambda: run_incremental(
        dcsr, pr, reps, cold_pr.values, cold_pr.delta, None, config=sync_pr), launches)
    out["pagerank"] = {"single": {"iterations": single_pr.iterations,
                                  "wall_s": single_pr.wall_seconds}}
    for l in MESH_LAYOUTS:
        res, _, _ = counted(torch, f"mesh_stream_{l}_pagerank", lambda l=l: run_incremental(
            dcsr, pr, reps, cold_pr.values, cold_pr.delta, None, config=shard_pr[l],
            mesh=mesh), launches)
        ok, err, held = pr_close(res, single_pr, pr)
        check(ok, f"leg (e) ({l}): warm Δ-PageRank vs single-device out of bound ({err:.3e})")
        out["pagerank"][l] = {"iterations": res.iterations, "wall_s": res.wall_seconds,
                              "max_abs_err": err, "bound": held}
    log(f"  (e) after batch {STREAM_BATCHES - 1}: warm SSSP {warm.iterations} iterations < cold "
        f"sharded {out['cold']['replicated']['iterations']} (replicated), "
        f"{out['cold']['owner']['iterations']} (owner); warm Δ-PageRank over the three reports "
        f"{single_pr.iterations} iterations, |err| vs single-device "
        f"{out['pagerank']['replicated']['max_abs_err']:.3e} (replicated), "
        f"{out['pagerank']['owner']['max_abs_err']:.3e} (owner)")
    del dcsr, views
    torch.cuda.empty_cache()

    # the no-slack merge-compaction of phase 10, the views registered first
    dcsr = DeltaCSR(hs.graph, shard["replicated"], slack=0.0, device=rt.device)
    views = {l: dcsr.sharded_runtime_for(SSSP, mesh, vertex_sharding=l) for l in MESH_LAYOUTS}
    p = int(np.argmax(dcsr.counts))
    v0, v1 = int(dcsr.vertex_start[p]), int(dcsr.vertex_start[p + 1])
    rng = np.random.default_rng(SEED + STREAM_BATCHES)
    batch = EdgeBatch.inserts(rng.integers(v0, v1, MERGE_INSERTS),
                              rng.integers(0, dcsr.n_nodes, MERGE_INSERTS),
                              rng.integers(1, 64, MERGE_INSERTS).astype(np.float32))
    t = time.monotonic()
    rep = dcsr.apply(batch)
    torch.cuda.synchronize()
    merge_s = time.monotonic() - t
    check(rep.merged and dcsr.layout_version == 1 and all(
        view_is_slice(dcsr, v) for v in views.values()),
        "leg (e): the merge did not happen, or did not refill the views")
    single, _, _ = counted(torch, "mesh_stream_merge_single", lambda: run_incremental(
        dcsr, SSSP, [rep], cold.values, cold.delta, source, config=sync8), launches)
    for l in MESH_LAYOUTS:
        res, _, _ = counted(torch, f"mesh_stream_merge_{l}", lambda l=l: run_incremental(
            dcsr, SSSP, [rep], cold.values, cold.delta, source, config=shard[l], mesh=mesh),
            launches)
        check(same_min_run(res, single), f"leg (e): after the merge, warm SSSP ({l}) != "
              "the single-device sync warm run")
    out["merge"] = {"merge_s": merge_s, "iterations": single.iterations,
                    "block_size": dcsr.block_size}
    log(f"  (e) merge: {MERGE_INSERTS} inserts into partition {p} merged in {merge_s:.2f} s "
        f"with both views refilled; warm SSSP on the mesh bit-equal in both layouts "
        f"({single.iterations} iterations)")
    del dcsr, views
    torch.cuda.empty_cache()
    return out


def mesh_serve_leg(torch, cfg, hs, rt, mesh, smi: str, launches: dict) -> dict:
    """Leg (f): a single-device sync ``GraphService`` and one on the mesh in
    each layout, 8 lanes, over the same 16 SSSP sources: answers bit-equal,
    a repeat all cache hits, one update batch and an incremental re-query
    bit-equal, one k-core query down the global path, the owner service's
    ``lane_bytes``, an owner budget that spills and then promotes, and the
    services' queries/s in turns with host syncs a chunk."""
    from repro_torch.graph.algorithms import ALGORITHMS, SSSP
    from repro_torch.serve import TierPolicy
    from repro_torch.stream import GraphService, random_batch

    sync8, _, shard, _ = mesh_stream_configs(cfg)
    n = hs.graph.n_nodes
    rng = np.random.default_rng(SEED + 15)
    live = np.flatnonzero(np.diff(hs.graph.indptr) > 0)
    sources = [int(v) for v in rng.choice(live, MESH_SERVE_QUERIES, replace=False)]
    out = {"sources": sources}
    t = time.monotonic()
    svcs = {"single": GraphService(hs.graph, sync8, max_lanes=MESH_SERVE_LANES,
                                   device=rt.device),
            **{l: GraphService(hs.graph, shard[l], max_lanes=MESH_SERVE_LANES, mesh=mesh)
               for l in MESH_LAYOUTS}}
    torch.cuda.synchronize()
    out["build_s"] = time.monotonic() - t
    single = svcs["single"]
    want = {}
    for name, svc in svcs.items():
        res, wall, _ = counted(torch, f"mesh_serve_{name}", lambda s=svc: s.query(SSSP, sources),
                               launches, lanes=True)
        check(all(r.mode == "batched" for r in res), f"leg (f) {name}: a query was not batched")
        if name == "single":
            want["cold"] = res
        else:
            check(all(np.array_equal(a.values, b.values) and a.iterations == b.iterations
                      for a, b in zip(want["cold"], res)),
                  f"leg (f) {name}: answers != the single-device sync service's")
        hits = svc.query(SSSP, sources)
        check(all(r.cache_hit and r.iterations == 0 for r in hits),
              f"leg (f) {name}: the repeat was not all cache hits")
        out[name] = {"cold_s": wall}
    batch = random_batch(single.dcsr, np.random.default_rng(SEED), **STREAM_OPS)
    for name, svc in svcs.items():
        t = time.monotonic()
        svc.update(batch)
        torch.cuda.synchronize()
        out[name]["apply_s"] = time.monotonic() - t
        res, wall, _ = counted(torch, f"mesh_serve_{name}_requery",
                               lambda s=svc: s.query(SSSP, sources), launches)
        check(all(r.mode == "incremental" for r in res),
              f"leg (f) {name}: a re-query was not incremental")
        if name == "single":
            want["requery"] = res
        else:
            check(all(np.array_equal(a.values, b.values) and a.iterations == b.iterations
                      for a, b in zip(want["requery"], res)),
                  f"leg (f) {name}: incremental answers != the single-device sync service's")
        out[name]["requery_s"] = wall
    kcore = ALGORITHMS["kcore"]
    kc = {}
    for name in ("single", "owner"):
        res, wall, _ = counted(torch, f"mesh_serve_{name}_kcore",
                               lambda s=svcs[name]: s.query(kcore, [None]), launches)
        kc[name] = res[0]
        check(res[0].mode == "batched", f"leg (f) {name}: k-core did not take the global path")
        out[name]["kcore_s"] = wall
    check(np.array_equal(kc["single"].values, kc["owner"].values)
          and kc["single"].iterations == kc["owner"].iterations,
          "leg (f): k-core on the mesh (owner) != single-device")
    own = svcs["owner"]
    n_loc = -(-n // mesh.size)
    check(own.scheduler.lane_bytes == 9 * n_loc,
          f"leg (f): owner lane_bytes {own.scheduler.lane_bytes} != 9 * {n_loc}")

    # an owner budget of 4 lanes and 2 cached states: 8 sources spill, and an
    # update's re-query promotes them
    budget = 4 * own.scheduler.lane_bytes + 2 * 8 * n_loc
    own.cache.clear()
    own.cache.policy = TierPolicy(device_budget_bytes=budget, max_reports=own.max_reports)
    few = sources[:8]
    own.query(SSSP, few)
    spills = own.cache.stats.spills
    batch2 = random_batch(single.dcsr, np.random.default_rng(SEED + 1), **STREAM_OPS)
    for svc in (single, own):
        svc.update(batch2)
    promotions = own.cache.stats.promotions
    got, want2 = own.query(SSSP, few), single.query(SSSP, few)
    check(spills > 0 and own.cache.stats.promotions > promotions,
          f"leg (f): owner budget {budget}: {spills} spills, "
          f"{own.cache.stats.promotions - promotions} promotions")
    check(all(np.array_equal(a.values, b.values) and a.iterations == b.iterations
              for a, b in zip(want2, got)), "leg (f): promoted owner answers != single-device")
    own.cache.policy = TierPolicy(max_reports=own.max_reports)
    out["budget"] = {"bytes": budget, "spills": spills,
                     "promotions": own.cache.stats.promotions - promotions,
                     "lane_bytes": own.scheduler.lane_bytes}

    # queries/s in turns, host syncs a chunk
    def batched(svc):
        svc.cache.clear()
        return svc.query(SSSP, sources)

    walls = shard_turns({name: (lambda s=svc: counted(
        torch, "mesh_serve_turn", lambda: batched(s), launches, lanes=True)[1])
        for name, svc in svcs.items()}, rounds=MESH_TURN_ROUNDS)
    launches.pop("mesh_serve_turn")
    out["queries_per_s"] = {k: MESH_SERVE_QUERIES / float(np.median(v)) for k, v in walls.items()}
    out["turn_walls"] = walls
    for name in ("single", "owner"):
        svc = svcs[name]
        c0 = svc.scheduler.stats.chunks
        sites = host_syncs(torch, lambda s=svc: batched(s))
        chunks = svc.scheduler.stats.chunks - c0
        out[name]["host_syncs"] = {"total": sum(sites.values()), "chunks": chunks,
                                   "per_chunk": sum(sites.values()) / max(chunks, 1),
                                   "sites": sites}
    out["ici"] = {l: {k: svcs[l].stats.extra.get(k, 0.0) for k in ("ici_bytes", "ici_time")}
                  for l in MESH_LAYOUTS}
    log(f"  (f) {MESH_SERVE_QUERIES} SSSP sources on {MESH_SERVE_LANES} lanes: the mesh services "
        f"(both layouts) bit-equal to the single-device sync service, repeats all hits, an "
        f"update's re-query incremental and bit-equal, k-core (owner) bit-equal "
        f"({kc['owner'].iterations} iterations); owner lane_bytes {own.scheduler.lane_bytes:,} "
        f"= 9 n_loc; budget {budget:,} B: {spills} spills, {out['budget']['promotions']} "
        f"promotions, bit-equal; queries/s (median of {MESH_TURN_ROUNDS}) "
        + ", ".join(f"{k} {v:.2f}" for k, v in out["queries_per_s"].items())
        + f"; host syncs a chunk single {out['single']['host_syncs']['per_chunk']:.2f}, owner "
        f"{out['owner']['host_syncs']['per_chunk']:.2f} [{smi}]")
    # a service and its scheduler hold each other: collect them now, or
    # their DeltaCSRs stay on the card for the phases after this one
    del svcs, single, own, svc
    gc.collect()
    torch.cuda.empty_cache()
    return out


def stream_shard_rank(group, graph_dir: str, cfg, source: int, sources: list) -> dict:
    """Leg (g) on one rank of a two-rank gloo group on one card, the owner
    layout at 63 partitions (padded to 64): a DeltaCSR with its view, one
    batch, a warm SSSP and a warm Δ-PageRank on the mesh (rank 0 also runs
    the single-device sync warm runs), then an owner service with 4 lanes:
    8 SSSP queries, one update and the re-query (rank 0 also runs each
    source's solo sync run before and after the update).  Each rank's
    launches and peak allocated memory."""
    from types import SimpleNamespace

    import torch
    import torch.distributed as dist

    from repro_torch.core.hytm import run_hytm
    from repro_torch.graph.algorithms import SSSP
    from repro_torch.graph.csr import CSRGraph
    from repro_torch.launch.mesh import make_graph_mesh
    from repro_torch.stream import DeltaCSR, GraphService, random_batch, run_incremental

    d = Path(graph_dir)
    g = CSRGraph(np.load(d / "indptr.npy"), np.load(d / "indices.npy"),
                 np.load(d / "weights.npy"))
    mesh = make_graph_mesh(group=group, device="cuda:0")
    lead = mesh.rank == 0
    c63 = dataclasses.replace(cfg, n_partitions=G_PARTITIONS)
    sync8, sync_pr, shard, shard_pr = mesh_stream_configs(c63)
    pr = main_path_legs(cfg, source)["pagerank"][0]
    own, own_pr = shard["owner"], shard_pr["owner"]
    out = {"rank": mesh.rank, "launches": {}}
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    start_bytes = torch.cuda.memory_allocated()
    t = time.monotonic()
    dcsr = DeltaCSR(g, own, device=mesh.device)
    view = dcsr.sharded_runtime_for(SSSP, mesh)
    out["view"] = {"P_pad": view.n_partitions, "P": dcsr.n_partitions, "n_pad": view.n_pad,
                   "halo": view.halo.halo_counts, "is_slice": view_is_slice(dcsr, view)}
    align_ranks(torch, mesh)
    cold = run_hytm(None, SSSP, source, own, runtime=view)
    # the Δ-PageRank warm start: rank 0's single-device sync run, broadcast
    # (a cold owner run through gloo would take ~15 s of the leg)
    pr_state = torch.empty((2, g.n_nodes), dtype=torch.float32, device=mesh.device)
    if lead:
        base = run_hytm(None, SSSP, source, sync8, runtime=dcsr.runtime_for(SSSP))
        base_pr = run_hytm(None, pr, None, sync_pr, runtime=dcsr.runtime_for(pr))
        out["single_cold_equal"] = same_min_run(cold, base)
        pr_state.copy_(torch.from_numpy(np.stack([base_pr.values, base_pr.delta])))
    dist.broadcast(pr_state, src=dist.get_global_rank(mesh.group, 0), group=mesh.group)
    cold_pr = SimpleNamespace(values=pr_state[0].cpu().numpy(), delta=pr_state[1].cpu().numpy())
    batch = random_batch(dcsr, np.random.default_rng(SEED), **STREAM_OPS)
    t_apply = time.monotonic()
    rep = dcsr.apply(batch)
    out["apply_s"] = time.monotonic() - t_apply
    out["view_s"] = dict(dcsr.view_seconds)
    out["halo_after"] = view.halo.halo_counts
    reset_launch_counts()
    out["warm"] = run_incremental(dcsr, SSSP, [rep], cold.values, cold.delta, source,
                                  config=own, mesh=mesh)
    out["launches"]["warm_sssp"] = read_launch_counts()
    reset_launch_counts()
    out["warm_pr"] = run_incremental(dcsr, pr, [rep], cold_pr.values, cold_pr.delta, None,
                                     config=own_pr, mesh=mesh)
    out["launches"]["warm_pagerank"] = read_launch_counts()
    if lead:
        out["single_warm"] = run_incremental(dcsr, SSSP, [rep], base.values, base.delta,
                                             source, config=sync8)
        out["single_warm_pr"] = run_incremental(dcsr, pr, [rep], base_pr.values,
                                                base_pr.delta, None, config=sync_pr)
    out["stream_s"] = time.monotonic() - t
    del dcsr, view
    torch.cuda.empty_cache()

    t = time.monotonic()
    svc = GraphService(g, own, max_lanes=G_LANES, mesh=mesh)
    if lead:
        rt1 = svc.dcsr.runtime_for(SSSP)
        out["solo"] = [run_hytm(None, SSSP, s, sync8, runtime=rt1).values for s in sources]
    align_ranks(torch, mesh)
    reset_launch_counts()
    t_serve = time.monotonic()
    served = [r.values for r in svc.query(SSSP, sources)]
    out["serve_query_s"] = time.monotonic() - t_serve
    out["serve_iterations"] = svc.scheduler.stats.engine_iterations
    out["launches"]["serve"] = read_launch_counts()
    svc.update(batch)
    if lead:
        rt1 = svc.dcsr.runtime_for(SSSP)
        solo2 = [run_hytm(None, SSSP, s, sync8, runtime=rt1).values for s in sources]
    align_ranks(torch, mesh)
    reset_launch_counts()
    res = svc.query(SSSP, sources)
    out["launches"]["requery"] = read_launch_counts()
    requery = [r.values for r in res]
    out["requery_modes"] = sorted({r.mode for r in res})
    # rank 0 holds the answers to the solo runs; the ranks compare crc32s
    if lead:
        out["served_ok"] = all(np.array_equal(a, b) for a, b in zip(served, out.pop("solo")))
        out["requery_ok"] = all(np.array_equal(a, b) for a, b in zip(requery, solo2))
    out["crc"] = [zlib.crc32(v.tobytes()) for v in served + requery]
    out["lane_bytes"] = svc.scheduler.lane_bytes
    out["serve_s"] = time.monotonic() - t
    torch.cuda.synchronize()
    out["peak_bytes"] = torch.cuda.max_memory_allocated()
    out["peak_above_start"] = out["peak_bytes"] - start_bytes
    return out


def phase_stream_sharded(torch, cfg, hs, rt, source: int, stream: dict, smi: str) -> dict:
    """Phase 15: the sharded stream and serving paths through the kernels
    at full size, on the graph and configuration of phase 14.  Legs (e)
    and (f) run NCCL at world size 1 in this process (``mesh_stream_leg``,
    ``mesh_serve_leg``), leg (g) two gloo ranks on this one card, the owner
    layout only (``stream_shard_rank``): the warm SSSP bit-equal to rank 0's
    single-device sync run at 63 partitions (a padding partition, so the
    CUDA ``segment_reduce`` of an empty segment runs in the warm
    Δ-PageRank's plan), the owner service's answers bit-equal to solo runs,
    both ranks equal.  Returns the phase's numbers with ``launches`` (solo
    legs) and ``serve_launches`` (the serving legs)."""
    import tempfile

    from repro_torch.launch.mesh import RankPool, make_graph_mesh

    launches, serve_launches = {}, {}
    out = {"card": smi, "allocated_before": torch.cuda.memory_allocated()}
    t = time.monotonic()
    with RankPool(1, backend="nccl", timeout_s=300.0):
        mesh = make_graph_mesh(device=rt.device)
        align_ranks(torch, mesh)
        out["stream"] = mesh_stream_leg(torch, cfg, hs, rt, source, stream, mesh, launches)
        out["stream"]["seconds"] = time.monotonic() - t
        log(f"phase 15 leg (e) took {out['stream']['seconds']:.1f} s")
        t = time.monotonic()
        out["serve"] = mesh_serve_leg(torch, cfg, hs, rt, mesh, smi, serve_launches)
        out["serve"]["seconds"] = time.monotonic() - t
        log(f"phase 15 leg (f) took {out['serve']['seconds']:.1f} s")
    torch.cuda.empty_cache()

    t = time.monotonic()
    rng = np.random.default_rng(SEED + 16)
    live = np.flatnonzero(np.diff(hs.graph.indptr) > 0)
    sources = [int(v) for v in rng.choice(live, G_QUERIES, replace=False)]
    with tempfile.TemporaryDirectory(prefix="phase15_") as tmp:
        g = hs.graph
        for key, arr in (("indptr", g.indptr), ("indices", g.indices),
                         ("weights", g.weights if g.weights is not None
                          else np.ones(g.n_edges, np.float32))):
            np.save(Path(tmp) / f"{key}.npy", arr)
        level = os.environ.get("TORCH_CPP_LOG_LEVEL")
        os.environ["TORCH_CPP_LOG_LEVEL"] = "ERROR"
        try:
            pool = RankPool(2, backend="gloo", timeout_s=300.0)
        finally:
            if level is None:
                del os.environ["TORCH_CPP_LOG_LEVEL"]
            else:
                os.environ["TORCH_CPP_LOG_LEVEL"] = level
        with pool:
            ranks = pool.run(stream_shard_rank, tmp, cfg, source, sources)
    # rank 0's service (this process) and its scheduler hold each other
    gc.collect()
    torch.cuda.empty_cache()
    r0, r1 = ranks
    pr = main_path_legs(cfg, source)["pagerank"][0]
    check(r0["view"]["P_pad"] == 64 and r0["view"]["P"] == G_PARTITIONS
          and r0["view"]["is_slice"] and r1["view"]["is_slice"]
          and r0["view"]["halo"] == r1["view"]["halo"],
          f"leg (g): views {r0['view']} and {r1['view']}")
    check(r0["single_cold_equal"], "leg (g): the cold owner SSSP != the single-device sync one")
    for r in ranks:
        check(same_min_run(r["warm"], r0["single_warm"]),
              f"leg (g) rank {r['rank']}: warm SSSP != rank 0's single-device sync warm run")
        ok, err, _ = pr_close(r["warm_pr"], r0["single_warm_pr"], pr)
        check(ok, f"leg (g) rank {r['rank']}: warm Δ-PageRank out of bound ({err:.3e})")
        check(r["requery_modes"] == ["incremental"],
              f"leg (g) rank {r['rank']}: re-query modes {r['requery_modes']}")
        half = 32
        own = slice(r["rank"] * half, (r["rank"] + 1) * half)
        check(engine_launches_match(r["warm"], r["launches"]["warm_sssp"], own),
              f"leg (g) rank {r['rank']}: launches {r['launches']['warm_sssp']} do not match "
              "its engines")
        for key in ("serve", "requery", "warm_pagerank"):
            counts = r["launches"][key]
            check(sum(counts[k] for k in SERVE_KERNELS) > 0,
                  f"leg (g) rank {r['rank']} {key}: no graph kernel launched")
            tag = {"serve": "mesh_gloo_serve", "requery": "mesh_gloo_requery",
                   "warm_pagerank": "mesh_gloo_pagerank"}[key]
            (serve_launches if key == "serve" else launches)[f"{tag}_rank{r['rank']}"] = {
                k: counts[k] for k in SERVE_KERNELS}
        launches[f"mesh_gloo_sssp_rank{r['rank']}"] = {k: r["launches"]["warm_sssp"][k]
                                                       for k in SERVE_KERNELS}
    check(r0["served_ok"] and r0["requery_ok"],
          "leg (g): the owner service's answers != solo sync runs")
    check(np.array_equal(r0["warm"].values, r1["warm"].values)
          and np.array_equal(r0["warm_pr"].values, r1["warm_pr"].values)
          and r0["crc"] == r1["crc"], "leg (g): the two ranks' results differ")
    n_loc = -(-hs.graph.n_nodes // 2)
    check(r0["lane_bytes"] == 9 * n_loc, f"leg (g): lane_bytes {r0['lane_bytes']}")
    out["gloo_d2"] = {
        "seconds": time.monotonic() - t, "view": r0["view"], "halo_after": r0["halo_after"],
        "warm_iterations": r0["warm"].iterations, "warm_wall_s": r0["warm"].wall_seconds,
        "single_warm_wall_s": r0["single_warm"].wall_seconds,
        "pagerank_iterations": r0["warm_pr"].iterations,
        "pagerank_wall_s": r0["warm_pr"].wall_seconds,
        "serve_query_s": r0["serve_query_s"], "serve_iterations": r0["serve_iterations"],
        "serve_ms_per_iteration": 1e3 * r0["serve_query_s"] / max(r0["serve_iterations"], 1),
        **{f"rank{r['rank']}": {k: r[k] for k in ("apply_s", "view_s", "stream_s", "serve_s",
                                                  "peak_bytes", "peak_above_start")}
           for r in ranks}}
    log(f"phase 15 leg (g), gloo at D=2 on one card, owner layout, {G_PARTITIONS} partitions "
        f"(P_pad 64): halo {r0['view']['halo']} -> {r0['halo_after']} after the batch; warm "
        f"SSSP bit-equal to rank 0's single-device sync run ({r0['warm'].iterations} "
        f"iterations, {r0['warm'].wall_seconds:.3f} s vs {r0['single_warm'].wall_seconds:.3f} "
        f"s), warm Δ-PageRank within bound ({r0['warm_pr'].iterations} iterations, "
        f"{r0['warm_pr'].wall_seconds:.3f} s); {G_QUERIES} owner-service SSSP queries on "
        f"{G_LANES} lanes ({r0['serve_iterations']} engine iterations in "
        f"{r0['serve_query_s']:.3f} s, {out['gloo_d2']['serve_ms_per_iteration']:.1f} ms an "
        f"iteration) and the re-query after one update bit-equal to solo runs, both ranks "
        f"equal; apply {r0['apply_s']:.3f} s (halo {r0['view_s']['halo']:.3f} s); peak "
        f"allocated {r0['peak_bytes'] / 2**20:.1f} MiB, {r0['peak_above_start'] / 2**20:.1f} "
        f"above the leg's start (rank 0, the smoke's process, with its single-device runs), "
        f"{r1['peak_bytes'] / 2**20:.1f} MiB, {r1['peak_above_start'] / 2**20:.1f} above "
        f"(rank 1); took {out['gloo_d2']['seconds']:.1f} s")
    lane_legs = [k for k in serve_launches
                 if k in ("mesh_serve_single", "mesh_serve_replicated", "mesh_serve_owner")
                 or k.startswith("mesh_gloo_serve")]
    for name in ("segment_spmm_lanes", "frontier_compact_lanes", "hyb_gather"):
        check(sum(serve_launches[k][name] for k in lane_legs) > 0,
              f"phase 15: the mesh lanes never launched {name}")
    out["launches"], out["serve_launches"], out["lane_legs"] = launches, serve_launches, lane_legs
    out["allocated_after"] = torch.cuda.memory_allocated()
    log(f"phase 15: {out['allocated_before'] / 2**20:.1f} MiB allocated before it, "
        f"{out['allocated_after'] / 2**20:.1f} MiB after")
    return out


# ---------------------------------------------------------------------------
# Phase 6: LM serving, gemma3-12b at full width
# ---------------------------------------------------------------------------

LM_ARCH, LM_REQUESTS, LM_PROMPT, LM_GEN = "gemma3-12b", 4, 2048, 16
# bf16 tolerance between the two legs' last-token logits.  They differ in
# where they round: the plain attention rounds its scores and probabilities
# to bf16 (about 2^-9 relative each), the kernel keeps them in float32.  With
# random weights the logits have a spread of about 1.2; a relative error of
# order 1% through 48 layers moves each by a few hundredths.
LM_ATOL = 0.25
LM_REL_L2 = 3e-2


def lm_bounds(cfg, n_params: int, cache_bytes: int) -> dict:
    """The least time the card could take: prefill's flops at the bf16 peak,
    a decode step's reads of every weight and the filled cache at 3.35 TB/s."""
    tokens = LM_REQUESTS * LM_PROMPT
    layer_params = (n_params - cfg.vocab * cfg.d_model) // cfg.n_layers
    linear = 2.0 * layer_params * cfg.n_layers * tokens
    attn = sum(4.0 * cfg.d_head * attention_pairs(LM_PROMPT, LM_PROMPT, w, True)
               * LM_REQUESTS * cfg.n_heads for w in cfg.windows())
    unembed = 2.0 * cfg.vocab * cfg.d_model * LM_REQUESTS
    return {"prefill_linear_tflop": linear / 1e12, "prefill_attention_tflop": attn / 1e12,
            "prefill_s": (linear + attn + unembed) / PEAK_FLOPS["bfloat16"],
            "decode_ms": bound_ms(2 * n_params + cache_bytes)}


def lm_host_syncs(torch, model, prompts) -> dict:
    """Host syncs that a prefill (through the kernel) and one decode step
    issue, by the port's source line that issued them (``host_syncs``)."""
    from repro_torch.models.transformer import decode_step, init_cache, prefill

    caches = init_cache(model.cfg, prompts.shape[0], prompts.shape[1] + 1, prompts.device)
    return {name: host_syncs(torch, call) for name, call in (
        ("prefill", lambda: prefill(model, prompts, caches)),
        ("decode", lambda: decode_step(model, prompts[:, :1], caches, prompts.shape[1])))}


def phase_lm_small(torch, dev, seed: int) -> None:
    """The reduced gemma3-12b config (float32) on the card against the same
    weights on the CPU, whose path the CPU tests hold against the
    reference: logits within 1e-4, greedy tokens identical."""
    from repro_torch.launch.serve import generate, serve_config
    from repro_torch.models.transformer import init_transformer

    cfg = serve_config(LM_ARCH, reduced=True)
    model = init_transformer(cfg, torch.Generator().manual_seed(seed), "cpu")
    prompts = torch.randint(0, cfg.vocab, (LM_REQUESTS, 40),
                            generator=torch.Generator().manual_seed(seed + 1))
    cpu = generate(model, prompts, 8)
    card = generate(model.to(dev), prompts.to(dev), 8)
    err = float((card["prefill_logits"].cpu() - cpu["prefill_logits"]).abs().max())
    check(card["launches"] == {"prefill": {"flash_attention": cfg.n_layers, "grouped_matmul": 0},
                               "decode": {"flash_attention": 0, "grouped_matmul": 0}},
          f"reduced serving launched {card['launches']}")
    check(err <= 1e-4 and torch.equal(card["tokens"].cpu(), cpu["tokens"]),
          f"reduced {LM_ARCH} on the card != on the CPU (max |err| {err:.3g})")
    log(f"LM (reduced {LM_ARCH}, float32): card == CPU within {err:.2e}, 8 greedy tokens equal")


def phase_lm(torch, dev, seed: int) -> dict:
    """gemma3-12b at full width, random weights from ``seed``: 4 requests of
    2048 prompt tokens, 16 generated, through ``launch.serve.generate``
    with the kernel (``use_kernels="auto"``) and then with the plain
    attention, both on the card."""
    from repro_torch.launch.serve import generate, serve_config
    from repro_torch.models.transformer import init_transformer

    cfg = serve_config(LM_ARCH, reduced=False)
    t = time.monotonic()
    gen = torch.Generator(device=dev)
    gen.manual_seed(seed)
    model = init_transformer(cfg, gen, dev)
    gen.manual_seed(seed + 1)
    prompts = torch.randint(0, cfg.vocab, (LM_REQUESTS, LM_PROMPT), generator=gen, device=dev)
    torch.cuda.synchronize()
    n_params = sum(p.numel() for p in model.parameters())
    check(n_params == 11_765_395_200, f"{LM_ARCH} has {n_params:,} parameters")
    log(f"LM: {LM_ARCH} full width, {n_params:,} parameters in {cfg.param_dtype} "
        f"({2 * n_params / 1e9:.1f} GB), {cfg.n_layers} layers (windows {cfg.windows()[:6]}...), "
        f"initialised in {time.monotonic() - t:.1f} s")
    generate(model, prompts[:, :64], 2)           # warm-up: cuBLAS, the kernel's library

    legs = {}
    for leg, use in (("kernel", "auto"), ("plain", False)):
        reset_launch_counts()
        torch.cuda.reset_peak_memory_stats()
        out = generate(model, prompts, LM_GEN, use_kernels=use)
        counts = read_launch_counts()
        out["total_launches"] = counts.pop("flash_attention")
        check(not any(counts.values()), f"LM {leg} leg launched other kernels: {counts}")
        out["launches"] = {phase: c["flash_attention"] for phase, c in out["launches"].items()}
        out["peak_gb"] = torch.cuda.max_memory_allocated() / 1e9
        legs[leg] = out
        log(f"LM {leg}: prefill {out['prefill_s']:.3f} s "
            f"({LM_REQUESTS * LM_PROMPT / out['prefill_s']:.0f} tok/s), decode "
            f"{out['decode_s_per_step'] * 1e3:.2f} ms/step, peak memory "
            f"{out['peak_gb']:.1f} GB, flash_attention launches {out['launches']}")
    k, p = legs["kernel"], legs["plain"]
    check(k["launches"] == {"prefill": cfg.n_layers, "decode": 0}
          and k["total_launches"] == cfg.n_layers,
          f"kernel leg launched flash_attention {k['launches']}, expected one per layer")
    check(p["total_launches"] == 0, "the plain leg launched flash_attention")

    kl, pl = k["prefill_logits"].float(), p["prefill_logits"].float()
    check(kl.shape == (LM_REQUESTS, cfg.vocab) and bool(torch.isfinite(kl).all())
          and bool(torch.isfinite(pl).all()), "prefill logits not finite or misshapen")
    for out in (k, p):
        toks = out["tokens"]
        check(toks.shape == (LM_REQUESTS, LM_GEN) and int(toks.min()) >= 0
              and int(toks.max()) < cfg.vocab, "generated tokens out of range")
    err = float((kl - pl).abs().max())
    rel = float((kl - pl).norm() / pl.norm())
    top2 = pl.topk(2, dim=-1).values
    decided = (top2[:, 0] - top2[:, 1]) > LM_ATOL
    first_equal = k["tokens"][:, 0] == p["tokens"][:, 0]
    log(f"LM kernel vs plain: last-token logits max |err| {err:.4f} (tolerance {LM_ATOL}), "
        f"relative L2 {rel:.2e} (tolerance {LM_REL_L2}), logit spread "
        f"{float(pl.std()):.3f}; first token equal {first_equal.tolist()}, top-2 margin "
        f"above tolerance {decided.tolist()}; generated tokens equal "
        f"{int((k['tokens'] == p['tokens']).sum())}/{LM_REQUESTS * LM_GEN}")
    check(err <= LM_ATOL and rel <= LM_REL_L2, "LM kernel leg vs plain leg out of tolerance")
    check(bool(first_equal[decided].all()), "first generated token differs where decided")

    syncs = lm_host_syncs(torch, model, prompts[:, :64])
    log(f"LM host syncs (PyTorch's sync debug mode), by source line: prefill "
        f"{syncs['prefill']}, one decode step {syncs['decode']}")
    cache_bytes = 2 * cfg.n_layers * LM_REQUESTS * (LM_PROMPT + LM_GEN) * cfg.n_kv_heads \
        * cfg.d_head * 2
    bounds = lm_bounds(cfg, n_params, cache_bytes)
    log(f"LM bounds: prefill >= {bounds['prefill_s']:.3f} s ({bounds['prefill_linear_tflop']:.1f} "
        f"TFLOP linear + {bounds['prefill_attention_tflop']:.2f} TFLOP attention at 989 TF/s); "
        f"decode >= {bounds['decode_ms']:.2f} ms/step (weights + cache at 3.35 TB/s)")
    summary = {leg: {"prefill_s": o["prefill_s"],
                     "prefill_tok_s": LM_REQUESTS * LM_PROMPT / o["prefill_s"],
                     "decode_ms_per_step": o["decode_s_per_step"] * 1e3, "peak_gb": o["peak_gb"],
                     "launches": o["launches"]} for leg, o in legs.items()}
    summary.update(bounds=bounds, max_abs_err=err, rel_l2=rel, host_syncs=syncs)
    del model, legs
    torch.cuda.empty_cache()
    return summary


# ---------------------------------------------------------------------------
# Phase 8: MoE serving, deepseek-v2-lite-16b at full width
# ---------------------------------------------------------------------------

MOE_ARCH, MOE_PARAMS = "deepseek-v2-lite-16b", 15_706_484_224
# One MoE layer fed the same hidden states through both routes: they route
# alike and compute the same expert products as float32 sums rounded once to
# bf16 (the kernel's WMMA sums and cuBLAS's, 16 products a step), so they
# agree to a few bf16 steps (2^-8 relative) at most.
MOE_LAYER_TOL = 2e-2     # of the largest output magnitude
MOE_LAYER_REL_L2 = 1e-2
# The two legs' last-token logits.  The legs round the attention in other
# places (the plain route's bf16 probabilities, as gemma3-12b's), and a
# token whose hidden state sits near a routing tie then picks another
# expert: a discrete change that grows through 26 MoE layers (the first
# chip run of this phase saw 2.3% of the picks differ in the first MoE layer
# and 19% in the last, logits max |err| 0.70 and relative L2 0.10 at a
# spread of 0.91).  The bound below still tells a right path from a wrong
# one (a wrong expert layout gives logits unrelated to the plain leg's,
# relative L2 about 1.4); the kernel's own check is the layer above.
MOE_ATOL = 1.5
MOE_REL_L2 = 0.2


class RouteRecorder:
    """While entered, records the top-k expert ids (T, K) of every MoE
    router call of the port, in call order."""

    def __enter__(self):
        from repro_torch.models import moe

        self.module, self.real, self.ids = moe, moe._route, []

        def route(*args):
            out = self.real(*args)
            self.ids.append(out[0])
            return out

        moe._route = route
        return self

    def __exit__(self, *exc):
        self.module._route = self.real


MOE_F32_LAYERS = 6   # the float32 run's depth: the dense layer and 5 MoE layers


def record_routes(model, prompts, use, dev, decode: bool = True) -> list:
    """The sorted top-k expert ids (T, K) of every MoE router call of one
    prefill of ``prompts`` and, with ``decode``, one decode step after it."""
    from repro_torch.models.transformer import decode_step, init_cache, prefill

    B, S = prompts.shape
    caches = init_cache(model.cfg, B, S + 1, dev)
    with RouteRecorder() as rec:
        logits, caches = prefill(model, prompts, caches, use_kernels=use)
        if decode:
            decode_step(model, logits.argmax(-1)[:, None], caches, S, use_kernels=use)
    return [ids.sort(dim=-1).values for ids in rec.ids]


def moe_route_flips(torch, model, prompts, routes: dict, dev) -> dict:
    """Where the (token, k) picks that differ between the kernel and plain
    legs come from.  (1) A third leg: the MoE layers through their kernel
    route, the attention through its plain route (``transformer``'s
    ``mla_attention`` swapped, for this leg only, for one that takes
    ``use_kernels=False``).  The two MoE routes agree bit for bit on one
    layer, so this leg must pick exactly as the plain leg.  (2) Each leg's
    prefill picks against a float32 copy of the first ``MOE_F32_LAYERS``
    layers (the same bf16 weights, upcast), layer by layer."""
    from repro_torch.models import transformer as tf_mod

    cfg, n_moe = model.cfg, model.cfg.n_scan_layers
    real = tf_mod.mla_attention

    def plain_attention(*args, **kw):
        return real(*args, **{**kw, "use_kernels": False})

    reset_launch_counts()
    tf_mod.mla_attention = plain_attention
    try:
        routes["moe_kernels_plain_attention"] = record_routes(model, prompts, "auto", dev)
    finally:
        tf_mod.mla_attention = real
    counts = read_launch_counts()
    check(counts == {**counts_zero(), "grouped_matmul": 2 * 3 * n_moe},
          f"the third MoE leg launched {counts}")
    third = [int((a != b).sum()) for a, b in zip(routes["moe_kernels_plain_attention"],
                                                 routes["plain"])]
    log(f"MoE third leg (MoE kernels, plain attention) vs the plain leg: (token, k) picks that "
        f"differ, by router call (prefill then one decode step): {third}")
    check(not any(third), "MoE kernel route picks differ from the plain route's with the "
          "attention held equal")

    # float32 at reduced depth: the bf16 weights upcast, the plain routes
    cfg32 = cfg.replace(n_layers=MOE_F32_LAYERS, dtype="float32", param_dtype="float32")
    model32 = tf_mod.Transformer(cfg32, torch.device("meta"))
    keep = set(model32.state_dict())
    model32.load_state_dict({k: v.float() for k, v in model.state_dict().items() if k in keep},
                            assign=True)
    f32 = record_routes(model32, prompts, False, dev, decode=False)
    n32 = cfg32.n_scan_layers
    vs_f32 = {leg: [float((routes[leg][i] != f32[i]).float().mean()) for i in range(n32)]
              for leg in ("kernel", "plain", "moe_kernels_plain_attention")}
    log(f"MoE picks that differ from a float32 run of the first {MOE_F32_LAYERS} layers, by MoE "
        f"layer 1-{n32} of the prefill: " + "; ".join(
            f"{leg} {[f'{x:.4%}' for x in v]}" for leg, v in vs_f32.items()))
    del model32, f32
    torch.cuda.empty_cache()
    return {"third_leg_vs_plain": third, "vs_float32": vs_f32, "float32_layers": MOE_F32_LAYERS}


def moe_bounds(cfg, n_params: int, distinct: list[int], cache_bytes: int) -> dict:
    """The least time the card could take: the prefill's flops at the bf16
    peak (every token's dense weights and its K experts, the attention's
    kept pairs at q.k 192 and p.v 128 wide, the last token's unembedding),
    and a decode step's reads at 3.35 TB/s (every weight but the embedding
    and the experts no token picked, ``distinct[l]`` experts in MoE layer l,
    and the filled cache)."""
    m, d = cfg.moe, cfg.d_model
    expert = 3 * d * m.d_ff
    n_moe = cfg.n_scan_layers
    unembed = cfg.vocab * d
    dense = n_params - 2 * unembed - n_moe * m.n_experts * expert
    tokens = LM_REQUESTS * LM_PROMPT
    linear = 2.0 * (dense + n_moe * m.top_k * expert) * tokens
    dh, dv = cfg.mla.d_nope + cfg.mla.d_rope, cfg.mla.d_v
    attn = cfg.n_layers * 2.0 * (dh + dv) * attention_pairs(LM_PROMPT, LM_PROMPT, 0, True) \
        * LM_REQUESTS * cfg.n_heads
    flops = linear + attn + 2.0 * unembed * LM_REQUESTS
    decode_bytes = 2 * (dense + unembed + sum(distinct) * expert) + cache_bytes
    return {"prefill_tflop": flops / 1e12, "prefill_linear_tflop": linear / 1e12,
            "prefill_attention_tflop": attn / 1e12,
            "prefill_s": flops / PEAK_FLOPS["bfloat16"], "decode_gb": decode_bytes / 1e9,
            "decode_ms": bound_ms(decode_bytes),
            "decode_all_experts_gb": 2 * n_moe * m.n_experts * expert / 1e9}


def phase_moe_small(torch, dev, seed: int) -> None:
    """The reduced deepseek-v2-lite-16b config (float32) on the card against
    the same weights on the CPU, whose path the CPU tests hold against the
    reference: logits within 1e-4, greedy tokens identical; the card's
    prefill and decode launch both kernels."""
    from repro_torch.launch.serve import generate, serve_config
    from repro_torch.models.transformer import init_transformer

    cfg = serve_config(MOE_ARCH, reduced=True)
    model = init_transformer(cfg, torch.Generator().manual_seed(seed), "cpu")
    prompts = torch.randint(0, cfg.vocab, (LM_REQUESTS, 40),
                            generator=torch.Generator().manual_seed(seed + 1))
    cpu = generate(model, prompts, 8)
    card = generate(model.to(dev), prompts.to(dev), 8)
    err = float((card["prefill_logits"].cpu() - cpu["prefill_logits"]).abs().max())
    gmm = 3 * cfg.n_scan_layers
    check(card["launches"] == {"prefill": {"flash_attention": cfg.n_layers, "grouped_matmul": gmm},
                               "decode": {"flash_attention": 0, "grouped_matmul": 7 * gmm}},
          f"reduced MoE serving launched {card['launches']}")
    check(err <= 1e-4 and torch.equal(card["tokens"].cpu(), cpu["tokens"]),
          f"reduced {MOE_ARCH} on the card != on the CPU (max |err| {err:.3g})")
    log(f"MoE (reduced {MOE_ARCH}, float32): card == CPU within {err:.2e}, 8 greedy tokens "
        f"equal; launches {card['launches']}")


def phase_moe(torch, dev, seed: int, smi: str) -> dict:
    """deepseek-v2-lite-16b at full width, random weights from ``seed``: one
    MoE layer through both routes on the same hidden states, then 4
    requests of 2048 prompt tokens, 16 generated, through
    ``launch.serve.generate`` with the kernels (``use_kernels="auto"``) and
    with the plain routes, both on the card.  Returns the phase's numbers,
    and the model, prompts and kernel leg that phase 16 reuses."""
    from repro_torch.launch.serve import generate, serve_config
    from repro_torch.models.moe import moe_ffn
    from repro_torch.models.transformer import init_transformer

    phase_moe_small(torch, dev, seed)
    cfg = serve_config(MOE_ARCH, reduced=False)
    t = time.monotonic()
    gen = torch.Generator(device=dev)
    gen.manual_seed(seed)
    model = init_transformer(cfg, gen, dev)
    gen.manual_seed(seed + 1)
    prompts = torch.randint(0, cfg.vocab, (LM_REQUESTS, LM_PROMPT), generator=gen, device=dev)
    torch.cuda.synchronize()
    n_params = sum(p.numel() for p in model.parameters())
    check(n_params == MOE_PARAMS, f"{MOE_ARCH} has {n_params:,} parameters")
    n_moe = cfg.n_scan_layers
    log(f"MoE: {MOE_ARCH} full width, {n_params:,} parameters in {cfg.param_dtype} "
        f"({2 * n_params / 1e9:.1f} GB; routers float32), {cfg.n_layers} layers (1 dense, "
        f"d_ff {cfg.d_ff_dense}; {n_moe} MoE, {cfg.moe.n_experts} experts top-{cfg.moe.top_k} "
        f"+ {cfg.moe.n_shared} shared; MLA kv_lora {cfg.mla.kv_lora}), initialised in "
        f"{time.monotonic() - t:.1f} s")

    # -- one MoE layer at full width, the same hidden states through both
    # routes (unit-RMS rows, as the layer's norm gives them), at the
    # prefill's 8192 tokens and a decode step's 4
    moe_params = model.layers[1].moe
    h = torch.randn((LM_REQUESTS * LM_PROMPT, cfg.d_model), generator=gen, device=dev)
    layer = {}
    for name, x in (("prefill", h.bfloat16()), ("decode", h[:LM_REQUESTS].bfloat16())):
        reset_launch_counts()
        y_k, _ = moe_ffn(moe_params, x, cfg.moe, use_kernels=True)
        counts = read_launch_counts()
        y_p, _ = moe_ffn(moe_params, x, cfg.moe, use_kernels=False)
        torch.cuda.synchronize()
        check(counts == {**counts_zero(), "grouped_matmul": 3},
              f"the kernel route of one MoE layer launched {counts}")
        yk, yp = y_k.float(), y_p.float()
        r = layer[name] = {
            "max_abs_err": float((yk - yp).abs().max()),
            "rel_l2": float((yk - yp).norm() / yp.norm()),
            "bit_equal": torch.equal(y_k, y_p), "max_abs": float(yp.abs().max()),
            "kernel_ms": call_ms(torch, lambda: moe_ffn(moe_params, x, cfg.moe,
                                                        use_kernels=True), 5),
            "plain_ms": call_ms(torch, lambda: moe_ffn(moe_params, x, cfg.moe,
                                                       use_kernels=False), 5)}
        log(f"MoE layer ({name}, T={x.shape[0]}, full width) kernel route vs plain route: "
            f"max |err| {r['max_abs_err']:.4g} of max |y| {r['max_abs']:.3f} (tolerance "
            f"{MOE_LAYER_TOL:.0%}), relative L2 {r['rel_l2']:.2e} (tolerance "
            f"{MOE_LAYER_REL_L2}), bit for bit: {r['bit_equal']}; one layer "
            f"{r['kernel_ms']:.3f} ms (kernel route) vs {r['plain_ms']:.3f} ms (plain) [{smi}]")
        check(bool(torch.isfinite(yk).all()) and r["max_abs_err"] <= MOE_LAYER_TOL * r["max_abs"]
              and r["rel_l2"] <= MOE_LAYER_REL_L2,
              f"MoE layer ({name}): kernel route vs plain out of tolerance")
        del x, y_k, y_p, yk, yp
    del h

    for use in ("auto", False):      # warm-up: cuBLAS, the kernels' libraries
        generate(model, prompts[:, :64], 2, use_kernels=use)
    legs = {}
    for leg, use in (("kernel", "auto"), ("plain", False)):
        reset_launch_counts()
        torch.cuda.reset_peak_memory_stats()
        out = generate(model, prompts, LM_GEN, use_kernels=use)
        out["total_launches"] = read_launch_counts()
        out["peak_gb"] = torch.cuda.max_memory_allocated() / 1e9
        legs[leg] = out
        log(f"MoE {leg}: prefill {out['prefill_s']:.3f} s "
            f"({LM_REQUESTS * LM_PROMPT / out['prefill_s']:.0f} tok/s), decode "
            f"{out['decode_s_per_step'] * 1e3:.2f} ms/step, peak memory "
            f"{out['peak_gb']:.1f} GB, launches {out['launches']} [{smi}]")
    k, p = legs["kernel"], legs["plain"]
    want = {"prefill": {"flash_attention": cfg.n_layers, "grouped_matmul": 3 * n_moe},
            "decode": {"flash_attention": 0, "grouped_matmul": 3 * n_moe * (LM_GEN - 1)}}
    check(k["launches"] == want and k["total_launches"] == {
        **counts_zero(), "flash_attention": cfg.n_layers,
        "grouped_matmul": 3 * n_moe * LM_GEN}, f"MoE kernel leg launched {k['launches']}, "
          f"{k['total_launches']} in all; expected {want}")
    check(p["total_launches"] == counts_zero(), f"MoE plain leg launched {p['total_launches']}")

    kl, pl = k["prefill_logits"].float(), p["prefill_logits"].float()
    check(kl.shape == (LM_REQUESTS, cfg.vocab) and bool(torch.isfinite(kl).all())
          and bool(torch.isfinite(pl).all()), "MoE prefill logits not finite or misshapen")
    for out in (k, p):
        toks = out["tokens"]
        check(toks.shape == (LM_REQUESTS, LM_GEN) and int(toks.min()) >= 0
              and int(toks.max()) < cfg.vocab, "MoE generated tokens out of range")

    # -- each leg's routes in a prefill and one decode step: the share of
    # (token, k) picks that differ between the legs in the first and last MoE
    # layers, and the experts one decode step reads
    routes = {}
    for leg, use in (("kernel", "auto"), ("plain", False)):
        routes[leg] = record_routes(model, prompts, use, dev)
        check(len(routes[leg]) == 2 * n_moe, f"MoE {leg}: {len(routes[leg])} router calls")
    flips = {name: float((routes["kernel"][i] != routes["plain"][i]).float().mean())
             for name, i in (("first_moe_layer", 0), ("last_moe_layer", n_moe - 1))}
    distinct = [int(ids.unique().numel()) for ids in routes["kernel"][n_moe:]]
    settle = moe_route_flips(torch, model, prompts, routes, dev)

    err = float((kl - pl).abs().max())
    rel = float((kl - pl).norm() / pl.norm())
    top2 = pl.topk(2, dim=-1).values
    decided = (top2[:, 0] - top2[:, 1]) > MOE_ATOL
    first_equal = k["tokens"][:, 0] == p["tokens"][:, 0]
    log(f"MoE kernel vs plain: last-token logits max |err| {err:.4f} (tolerance {MOE_ATOL}), "
        f"relative L2 {rel:.2e} (tolerance {MOE_REL_L2}), logit spread {float(pl.std()):.3f}; "
        f"(token, k) picks that differ in the prefill: {flips}; first token equal "
        f"{first_equal.tolist()}, top-2 margin above tolerance {decided.tolist()}; generated "
        f"tokens equal {int((k['tokens'] == p['tokens']).sum())}/{LM_REQUESTS * LM_GEN}")
    check(err <= MOE_ATOL and rel <= MOE_REL_L2, "MoE kernel leg vs plain leg out of tolerance")
    check(bool(first_equal[decided].all()), "MoE first generated token differs where decided")
    syncs = lm_host_syncs(torch, model, prompts[:, :64])
    log(f"MoE host syncs (PyTorch's sync debug mode), by source line: prefill "
        f"{syncs['prefill']}, one decode step {syncs['decode']}")

    cache_bytes = cfg.n_layers * LM_REQUESTS * (LM_PROMPT + LM_GEN) \
        * (cfg.mla.kv_lora + cfg.mla.d_rope) * 2
    bounds = moe_bounds(cfg, n_params, distinct, cache_bytes)
    log(f"MoE bounds: prefill >= {bounds['prefill_s'] * 1e3:.1f} ms ({bounds['prefill_tflop']:.1f} "
        f"TFLOP: {bounds['prefill_linear_tflop']:.1f} linear + "
        f"{bounds['prefill_attention_tflop']:.2f} attention, at 989 TF/s); decode >= "
        f"{bounds['decode_ms']:.2f} ms/step ({bounds['decode_gb']:.2f} GB: weights, the "
        f"{sum(distinct)} experts picked over {n_moe} layers ({min(distinct)}-{max(distinct)} a "
        f"layer) and the cache, at 3.35 TB/s; all experts would be "
        f"{bounds['decode_all_experts_gb']:.1f} GB)")
    summary = {leg: {"prefill_s": o["prefill_s"],
                     "prefill_tok_s": LM_REQUESTS * LM_PROMPT / o["prefill_s"],
                     "decode_ms_per_step": o["decode_s_per_step"] * 1e3, "peak_gb": o["peak_gb"],
                     "launches": o["launches"]} for leg, o in legs.items()}
    summary.update(bounds=bounds, max_abs_err=err, rel_l2=rel, route_flips=flips,
                   route_flips_settled=settle, decode_experts_per_layer=distinct, layer=layer,
                   host_syncs=syncs, card=smi)
    # phase 16's leg (h) serves this model again over a mesh, against the kernel leg
    kept = {"model": model, "prompts": prompts, "kernel": legs["kernel"]}
    del legs, routes
    torch.cuda.empty_cache()
    return summary, kept


# ---------------------------------------------------------------------------
# Phase 16: models over a mesh (moe_ffn(mesh=), generate(mesh=))
# ---------------------------------------------------------------------------

KIMI_ARCH, KIMI_LAYERS = "kimi-k2-1t-a32b", 2   # the dense first layer and one MoE layer
KIMI_PARAMS = 19_923_635_200                     # at KIMI_LAYERS, full width
MESH_POOL_TIMEOUT_S = 600.0


def exchange_line(ex: dict) -> str:
    """``ExchangeTimer.summary()`` by kind: calls, MB a call, ms a call."""
    return ", ".join(f"{k} {r['calls']} x {r['bytes'] / r['calls'] / 1e6:.1f} MB "
                     f"{r['ms'] / r['calls']:.3f} ms" for k, r in ex.items())


def mesh_generate(torch, model, prompts, mesh) -> dict:
    """``generate(mesh=)`` through the kernels after a short warm-up (the
    communicator's first exchange, cuBLAS), launch counts set to 0 just
    before and read just after, peak allocated memory over the run."""
    from repro_torch.launch.serve import generate

    generate(model, prompts[:, :64], 2, mesh=mesh)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    reset_launch_counts()
    out = generate(model, prompts, LM_GEN, mesh=mesh)
    out["total_launches"] = read_launch_counts()
    out["peak_gb"] = torch.cuda.max_memory_allocated() / 1e9
    return out


def forced_logits(torch, model, prompts, tokens, mesh):
    """The logits that pick each of ``tokens`` (B, G) when the model is fed
    them (teacher forcing): the prefill's last-token logits, then G - 1
    decode steps on ``tokens[:, s]``; (B, G, vocab) float32 on the host."""
    from repro_torch.models.transformer import decode_step, init_cache, prefill

    B, P = prompts.shape
    G = tokens.shape[1]
    caches = init_cache(model.cfg, B, P + G, prompts.device)
    logits, caches = prefill(model, prompts, caches, mesh=mesh)
    out = [logits.float().cpu()]
    for s in range(G - 1):
        logits, caches = decode_step(model, tokens[:, s:s + 1], caches, P + s, mesh=mesh)
        out.append(logits.float().cpu())
    return torch.stack(out, dim=1)


def kimi_config():
    from repro_torch.configs import get_arch

    cfg = get_arch(KIMI_ARCH).model_config
    return cfg.replace(n_layers=KIMI_LAYERS, remat=False, param_dtype=cfg.dtype)


def kimi_rank(group, state: dict, prompts, d1_tokens, seed: int) -> dict:
    """Leg (i) at D = 2 on one rank of a two-rank gloo group on one card:
    the whole kimi model's tensors arrive as CUDA IPC shares of rank 0's
    (no copy), the rank keeps its 192 experts (views) and its 2 requests,
    and runs ``generate(mesh=)`` through the kernels, then its requests fed
    D = 1's tokens (``forced_logits``).  Returns its numbers on the host."""
    import torch

    from repro_torch.launch.mesh import make_debug_mesh
    from repro_torch.models.transformer import Transformer, batch_shard, shard_transformer

    torch.cuda.set_device(0)
    cfg = kimi_config()
    mesh = make_debug_mesh(2, 1, device="cuda:0")
    full = Transformer(cfg, torch.device("meta"))
    full.load_state_dict(state, assign=True)
    model = shard_transformer(full, mesh)
    del full, state
    allocated = torch.cuda.memory_allocated()
    out = mesh_generate(torch, model, batch_shard(prompts, mesh), mesh)
    res = {"rank": mesh.rank, "experts": model.layers[1].moe["w_gate"].shape[0],
           "allocated_before_gb": allocated / 1e9, "peak_gb": out["peak_gb"],
           "launches": out["launches"], "total_launches": out["total_launches"],
           "exchange": out["exchange"], "prefill_s": out["prefill_s"],
           "decode_s_per_step": out["decode_s_per_step"],
           "prefill_logits": out["prefill_logits"].float().cpu(),
           "tokens": out["tokens"].cpu(), "all_tokens": out["all_tokens"].cpu(),
           "forced": forced_logits(torch, model, batch_shard(prompts, mesh),
                                   batch_shard(d1_tokens, mesh), mesh)}
    del model, out
    gc.collect()
    torch.cuda.empty_cache()
    torch.cuda.ipc_collect()
    return res


MESH_LAYER_TOKENS = {"prefill": LM_REQUESTS * LM_PROMPT, "decode": LM_REQUESTS}


def layer_rank(group, seed: int) -> dict:
    """Leg (j) on one rank of the two-rank gloo group: one deepseek MoE
    layer at full width, drawn on each rank from ``seed`` (the same
    weights), fed hidden states from ``seed + 1``, through the kernel
    route as mesh (1, 2) (TP = 2: every token, half the width) against the
    single-device layer, and as mesh (2, 1) (EP = 2: half the tokens, half
    the experts) against the single-device ``_moe_core`` on this rank's
    tokens, at a prefill's and a decode step's token counts."""
    import torch

    from repro_torch.launch.mesh import make_debug_mesh
    from repro_torch.launch.serve import serve_config
    from repro_torch.models import moe

    torch.cuda.set_device(0)
    dev = torch.device("cuda:0")
    cfg = serve_config(MOE_ARCH, reduced=False).moe
    d = 2048
    gen = torch.Generator(device=dev)
    gen.manual_seed(seed)
    full = moe.init_moe(gen, d, cfg, torch.bfloat16)
    gen.manual_seed(seed + 1)
    h = torch.randn((MESH_LAYER_TOKENS["prefill"], d), generator=gen, device=dev).bfloat16()
    out = {"rank": None}
    for name, shape in (("tp2", (1, 2)), ("ep2", (2, 1))):
        mesh = make_debug_mesh(*shape, device="cuda:0")
        out["rank"] = mesh.rank
        ep, ei, tp, ti = moe.mesh_shards(mesh, ("data",))
        p = {k: v.contiguous() for k, v in moe.shard_moe_params(full, cfg, ep, ei, tp, ti).items()}
        for phase, n in MESH_LAYER_TOKENS.items():
            n_local = n // ep
            x = h[:n][ei * n_local:(ei + 1) * n_local]
            torch.cuda.synchronize()
            reset_launch_counts()
            with moe.ExchangeTimer() as timer:
                t = time.monotonic()
                y, _ = moe.moe_ffn(p, x, cfg, mesh=mesh, batch_axes=("data",), use_kernels=True)
                torch.cuda.synchronize()
                wall = time.monotonic() - t
            counts = read_launch_counts()
            if name == "tp2":
                want, _ = moe.moe_ffn(full, x, cfg, use_kernels=True)
            else:
                want, _ = moe._moe_core(x, full, cfg, moe.select_dispatch_engine(cfg, n_local),
                                        True)
            yf, wf = y.float(), want.float()
            out[f"{name}_{phase}"] = {
                "tokens": n_local, "launches": counts, "wall_ms": wall * 1e3,
                "exchange": timer.summary(), "bit_equal": torch.equal(y, want),
                "max_abs_err": float((yf - wf).abs().max()), "max_abs": float(wf.abs().max()),
                "rel_l2": float((yf - wf).norm() / wf.norm()),
                "finite": bool(torch.isfinite(yf).all())}
            del x, y, want, yf, wf
    out["peak_gb"] = torch.cuda.max_memory_allocated() / 1e9
    del full, h
    torch.cuda.empty_cache()
    return out


def phase_models_mesh(torch, dev, seed: int, smi: str, kept: dict) -> dict:
    """Phase 16: models over a mesh.  (h) deepseek-v2-lite-16b (phase 8's
    model) through ``generate(mesh=)`` on a one-rank NCCL mesh, bit-equal
    to phase 8's kernel leg with its launches; (i) kimi-k2-1t-a32b at full
    width cut to ``KIMI_LAYERS`` layers, NCCL at D = 1, then two gloo ranks
    on the one card (EP = 2, 192 experts a rank, the model shared by CUDA
    IPC) equal to D = 1; (j) one deepseek MoE layer at full width on the
    same two ranks as TP = 2 and EP = 2.  Returns the phase's numbers with
    ``launches[leg] = {kernel: n}``."""
    from repro_torch.launch.mesh import RankPool, make_debug_mesh
    from repro_torch.launch.serve import lm_param_count
    from repro_torch.models.transformer import init_transformer

    t_phase = time.monotonic()
    out, launches = {"card": smi}, {}

    # -- (h) deepseek-v2-lite-16b, one-rank NCCL mesh, against phase 8
    model, prompts, k8 = kept["model"], kept["prompts"], kept["kernel"]
    t = time.monotonic()
    with RankPool(1, backend="nccl", timeout_s=MESH_POOL_TIMEOUT_S):
        mesh = make_debug_mesh(1, 1, device=dev)
        h = mesh_generate(torch, model, prompts, mesh)
    for phase in ("prefill", "decode"):
        launches[f"h_deepseek_{phase}"] = h["launches"][phase]
    same_logits = torch.equal(h["prefill_logits"], k8["prefill_logits"])
    same_tokens = torch.equal(h["tokens"], k8["tokens"])
    log(f"phase 16 leg (h), {MOE_ARCH} generate(mesh=) on a one-rank NCCL mesh: prefill logits "
        f"bit-equal to phase 8's kernel leg {same_logits}, tokens equal {same_tokens}; launches "
        f"{h['launches']} (phase 8: {k8['launches']}); prefill {h['prefill_s']:.3f} s (phase 8 "
        f"{k8['prefill_s']:.3f} s), decode {h['decode_s_per_step'] * 1e3:.2f} ms/step (phase 8 "
        f"{k8['decode_s_per_step'] * 1e3:.2f}); peak {h['peak_gb']:.1f} GB; exchanges: prefill "
        f"{exchange_line(h['exchange']['prefill'])}; decode "
        f"{exchange_line(h['exchange']['decode'])} [{smi}]")
    check(same_logits and same_tokens, "leg (h): generate(mesh=) at D = 1 != phase 8's kernel leg")
    check(h["launches"] == k8["launches"] and h["total_launches"] == {
        **counts_zero(), **{k: h["launches"]["prefill"][k] + h["launches"]["decode"][k]
                            for k in ("flash_attention", "grouped_matmul")}},
          f"leg (h) launched {h['launches']} ({h['total_launches']} in all), phase 8 "
          f"{k8['launches']}")
    out["h"] = {k: h[k] for k in ("launches", "exchange", "prefill_s", "decode_s_per_step",
                                  "peak_gb")}
    out["h"].update(bit_equal=same_logits and same_tokens, seconds=time.monotonic() - t)
    del model, prompts, k8, h
    kept.clear()
    gc.collect()
    torch.cuda.empty_cache()

    # -- (i) kimi-k2-1t-a32b at full width, KIMI_LAYERS layers
    t = time.monotonic()
    cfg = kimi_config()
    n_params = lm_param_count(cfg)
    check(n_params == KIMI_PARAMS, f"{KIMI_ARCH} at {KIMI_LAYERS} layers has {n_params:,} "
          "parameters")
    gen = torch.Generator(device=dev)
    gen.manual_seed(seed)
    model = init_transformer(cfg, gen, dev)
    gen.manual_seed(seed + 1)
    prompts = torch.randint(0, cfg.vocab, (LM_REQUESTS, LM_PROMPT), generator=gen, device=dev)
    torch.cuda.synchronize()
    m = cfg.moe
    expert_gb = 3 * m.n_experts * cfg.d_model * m.d_ff * 2 / 1e9
    log(f"phase 16 leg (i): {KIMI_ARCH} at full width, depth cut from 61 to {KIMI_LAYERS} "
        f"layers (the dense first layer, d_ff {cfg.d_ff_dense}, and one MoE layer of "
        f"{m.n_experts} experts top-{m.top_k}, d_ff {m.d_ff}, chunk_tokens {m.chunk_tokens}): "
        f"{n_params:,} parameters, {2 * n_params / 1e9:.1f} GB in bf16 ({expert_gb:.1f} GB of "
        f"experts), drawn in {time.monotonic() - t:.1f} s; "
        f"{LM_REQUESTS} x {LM_PROMPT} prompts, {LM_GEN} generated")
    with RankPool(1, backend="nccl", timeout_s=MESH_POOL_TIMEOUT_S):
        mesh = make_debug_mesh(1, 1, device=dev)
        d1 = mesh_generate(torch, model, prompts, mesh)
        forced1 = forced_logits(torch, model, prompts, d1["tokens"], mesh)
    n_chunks = -(-LM_REQUESTS * LM_PROMPT // m.chunk_tokens)
    want = {"prefill": {"flash_attention": cfg.n_layers, "grouped_matmul": 3 * n_chunks},
            "decode": {"flash_attention": 0, "grouped_matmul": 3 * (LM_GEN - 1)}}
    check(d1["launches"] == want, f"leg (i) D = 1 launched {d1['launches']}, expected {want}")
    for phase in ("prefill", "decode"):
        launches[f"i_kimi_d1_{phase}"] = d1["launches"][phase]
    logits1 = d1["prefill_logits"].float()
    check(logits1.shape == (LM_REQUESTS, cfg.vocab) and bool(torch.isfinite(logits1).all())
          and d1["tokens"].shape == (LM_REQUESTS, LM_GEN) and int(d1["tokens"].min()) >= 0
          and int(d1["tokens"].max()) < cfg.vocab, "leg (i) D = 1: logits or tokens misshapen")
    log(f"phase 16 leg (i) NCCL D = 1: prefill {d1['prefill_s']:.3f} s "
        f"({LM_REQUESTS * LM_PROMPT / d1['prefill_s']:.0f} tok/s), decode "
        f"{d1['decode_s_per_step'] * 1e3:.2f} ms/step, peak {d1['peak_gb']:.1f} GB, launches "
        f"{d1['launches']}; exchanges: prefill {exchange_line(d1['exchange']['prefill'])}; "
        f"decode {exchange_line(d1['exchange']['decode'])} [{smi}]")

    state = dict(model.state_dict())
    level = os.environ.get("TORCH_CPP_LOG_LEVEL")
    os.environ["TORCH_CPP_LOG_LEVEL"] = "ERROR"
    try:
        pool = RankPool(2, backend="gloo", timeout_s=MESH_POOL_TIMEOUT_S)
    finally:
        if level is None:
            del os.environ["TORCH_CPP_LOG_LEVEL"]
        else:
            os.environ["TORCH_CPP_LOG_LEVEL"] = level
    with pool:
        ranks = pool.run(kimi_rank, state, prompts, d1["tokens"], seed)
        del state
        t_j = time.monotonic()
        layer = pool.run(layer_rank, seed)
    layer_s = time.monotonic() - t_j
    half = LM_REQUESTS // 2
    rows = {}
    for r in ranks:
        check(r["experts"] == m.n_experts // 2,
              f"leg (i) rank {r['rank']} holds {r['experts']} experts")
        for phase in ("prefill", "decode"):
            launches[f"i_kimi_d2_rank{r['rank']}_{phase}"] = r["launches"][phase]
        want_r = {"prefill": {"flash_attention": cfg.n_layers, "grouped_matmul": 3},
                  "decode": {"flash_attention": 0, "grouped_matmul": 3 * (LM_GEN - 1)}}
        check(r["launches"] == want_r, f"leg (i) D = 2 rank {r['rank']} launched "
              f"{r['launches']}, expected {want_r}")
        lo = r["rank"] * half
        ref = logits1[lo:lo + half].cpu()
        err = float((r["prefill_logits"] - ref).abs().max())
        f1 = forced1[lo:lo + half]
        step_err = (r["forced"] - f1).abs().amax(dim=2)          # (rows, G)
        mine, want_tok = r["tokens"], d1["tokens"][lo:lo + half].cpu()
        # where a request's tokens first part, D = 1's logits there must be a
        # near-tie: its top-2 margin within twice the step's logit error
        ties = []
        for i in range(half):
            diff = (mine[i] != want_tok[i]).nonzero()
            if len(diff):
                s0 = int(diff[0])
                top2 = f1[i, s0].topk(2).values
                ties.append({"request": lo + i, "step": s0,
                             "margin": float(top2[0] - top2[1]),
                             "step_err": float(step_err[i, s0])})
        rows[r["rank"]] = {
            "bit_equal": torch.equal(r["prefill_logits"], ref), "max_abs_err": err,
            "max_abs": float(ref.abs().max()),
            "forced_bit_equal": torch.equal(r["forced"], f1),
            "forced_max_abs_err": float(step_err.max()),
            "forced_max_abs": float(f1.abs().max()), "first_differences": ties,
            "tokens_equal": torch.equal(mine, want_tok),
            "all_tokens_equal": torch.equal(r["all_tokens"], d1["tokens"].cpu())}
        log(f"phase 16 leg (i) gloo D = 2 rank {r['rank']}: {r['experts']} experts, prefill "
            f"logits vs D = 1 rows bit-equal {rows[r['rank']]['bit_equal']} (max |err| {err:.4g} "
            f"of max |logit| {rows[r['rank']]['max_abs']:.3f}), tokens equal "
            f"{rows[r['rank']]['tokens_equal']}, gathered tokens equal "
            f"{rows[r['rank']]['all_tokens_equal']}; fed D = 1's tokens, its logits of all "
            f"{LM_GEN} steps bit-equal {rows[r['rank']]['forced_bit_equal']} (max |err| "
            f"{rows[r['rank']]['forced_max_abs_err']:.4g}), first differing tokens "
            f"{rows[r['rank']]['first_differences']}; prefill {r['prefill_s']:.3f} s, decode "
            f"{r['decode_s_per_step'] * 1e3:.2f} ms/step; allocated before the run "
            f"{r['allocated_before_gb']:.1f} GB, peak {r['peak_gb']:.1f} GB (this process's "
            f"allocations only: rank 1 maps rank 0's weights by CUDA IPC); launches "
            f"{r['launches']}; exchanges: prefill {exchange_line(r['exchange']['prefill'])}; "
            f"decode {exchange_line(r['exchange']['decode'])} [{smi}]")
    log(f"phase 16 leg (i): D = 1 tokens {d1['tokens'].tolist()}; D = 2 gathered "
        f"{[r['all_tokens'].tolist() for r in ranks]}")
    # the prefill runs the same rows through the same shapes: bit-equal.  A
    # decode step runs the dense layers and attention on 2 rows where D = 1
    # runs 4, and cuBLAS may round those otherwise: each step's logits, fed
    # the same tokens, within MOE_LAYER_TOL, and a token may differ only
    # from a near-tie on
    for rank, row in rows.items():
        check(row["bit_equal"], f"leg (i) rank {rank}: D = 2 prefill logits != D = 1's "
              f"(max |err| {row['max_abs_err']:.4g})")
        check(row["forced_max_abs_err"] <= MOE_LAYER_TOL * row["forced_max_abs"],
              f"leg (i) rank {rank}: D = 2 decode logits vs D = 1 out of tolerance "
              f"({row['forced_max_abs_err']:.4g})")
        check(all(t["margin"] <= 2 * t["step_err"] for t in row["first_differences"]),
              f"leg (i) rank {rank}: a token differs from D = 1's where D = 1 was decided: "
              f"{row['first_differences']}")
    check(torch.equal(ranks[0]["all_tokens"], ranks[1]["all_tokens"]),
          "leg (i): the ranks' gathered tokens differ")
    out["i"] = {"params": n_params, "layers": KIMI_LAYERS, "d1": {
        k: d1[k] for k in ("launches", "exchange", "prefill_s", "decode_s_per_step", "peak_gb")},
        "d2": {r["rank"]: {**{k: r[k] for k in ("launches", "exchange", "prefill_s",
                                                 "decode_s_per_step", "peak_gb",
                                                 "allocated_before_gb", "experts")},
                           **rows[r["rank"]]} for r in ranks},
        "tokens_d1": d1["tokens"].tolist(), "tokens_d2": ranks[0]["all_tokens"].tolist(),
        "seconds": time.monotonic() - t - layer_s}
    del model, prompts, d1, ranks, logits1, forced1
    gc.collect()
    torch.cuda.empty_cache()

    # -- (j) one deepseek MoE layer, TP = 2 and EP = 2, on the same ranks
    for r in layer:
        for name in ("tp2", "ep2"):
            for phase in MESH_LAYER_TOKENS:
                row = r[f"{name}_{phase}"]
                check(row["launches"] == {**counts_zero(), "grouped_matmul": 3},
                      f"leg (j) {name} {phase} rank {r['rank']} launched {row['launches']}")
                launches[f"j_{name}_{phase}_rank{r['rank']}"] = {
                    k: row["launches"][k] for k in ("flash_attention", "grouped_matmul")}
                check(row["finite"], f"leg (j) {name} {phase}: not finite")
                if name == "tp2":
                    check(row["max_abs_err"] <= MOE_LAYER_TOL * row["max_abs"]
                          and row["rel_l2"] <= MOE_LAYER_REL_L2,
                          f"leg (j) TP = 2 {phase} rank {r['rank']} vs one device out of "
                          f"tolerance ({row['max_abs_err']:.4g})")
                else:
                    check(row["bit_equal"], f"leg (j) EP = 2 {phase} rank {r['rank']} != the "
                          f"per-shard _moe_core (max |err| {row['max_abs_err']:.4g})")
                against = "one device" if name == "tp2" else "its per-shard _moe_core"
                log(f"phase 16 leg (j) {MOE_ARCH} MoE layer {name} {phase} rank {r['rank']} "
                    f"({row['tokens']} tokens): vs {against} "
                    f"bit-equal {row['bit_equal']}, max |err| {row['max_abs_err']:.4g} of "
                    f"{row['max_abs']:.3f}, relative L2 {row['rel_l2']:.2e}; one call "
                    f"{row['wall_ms']:.2f} ms; exchanges {exchange_line(row['exchange'])} [{smi}]")
    out["j"] = {r["rank"]: r for r in layer}
    out["j"]["seconds"] = layer_s
    out["launches"] = launches
    out["phase_s"] = time.monotonic() - t_phase
    return out


# ---------------------------------------------------------------------------
# Phase 17: the GNN side (GraphSAGE, PNA, GatedGCN, MeshGraphNet)
# ---------------------------------------------------------------------------

GNN_ARCHS = ("graphsage-reddit", "pna", "gatedgcn", "meshgraphnet")
GNN_REPS = 5             # warm forwards timed a leg (after call_ms's 3 warm-ups)
GNN_PRODUCTS_REPS = 3
# The card's float32 against a float64 copy of the same module on the CPU,
# max |difference| over max(max |float64 output|, 1): float32 products and
# scatters (atomics on the card) through up to 16 layers, TF32 off.
GNN_TOL = 1e-3
GNN_LOSS_TOL = 1e-4      # |loss difference| over max(|float64 loss|, 1)
# two card runs of ogb_products, relative to max |output|: index_add_'s
# float32 atomics add the 61.9M messages in another order each run
GNN_ATOMICS_TOL = 1e-4


def gnn_edge_bytes(cfg, m: int) -> float:
    """Bytes of one forward's per-edge gathers and scatters, each row moved
    once in float32.  Per layer of input width w: GraphSAGE (mean) gathers
    h[src] and scatters it with its count (2w + 1 an edge); PNA gathers
    h[src] and h[dst], scatters the message five times (mean, max, min and
    std's two means) with three counts (7w + 3), and counts the degree once;
    GatedGCN gathers h[src] and h[dst] and scatters the gated message and
    the gate (4w); MeshGraphNet gathers h[src] and h[dst] and scatters the
    edge state (3w)."""
    if cfg.arch in ("gatedgcn", "meshgraphnet"):
        widths = [cfg.d_hidden] * cfg.n_layers
    else:
        widths = [cfg.d_in] + [cfg.d_hidden] * (cfg.n_layers - 1)
    per = {"graphsage": lambda w: 2 * w + 1, "pna": lambda w: 7 * w + 3,
           "gatedgcn": lambda w: 4 * w, "meshgraphnet": lambda w: 3 * w}[cfg.arch]
    return 4.0 * m * (sum(per(w) for w in widths) + (cfg.arch == "pna"))


def mlp_flops(dims: list[int], rows: int) -> float:
    return float(sum(2 * rows * dims[i] * dims[i + 1] for i in range(len(dims) - 1)))


def gnn_forward_flops(cell: dict) -> float:
    """The operations of one forward on the cell's shapes: every product
    (2 x its multiply-adds) and one add a scattered or averaged element.
    The reference's count (a third of ``model_flops``) misses layer 0's
    width in GraphSAGE and PNA, counts GatedGCN's and MeshGraphNet's
    per-edge products at 6d^2 and 12d^2 (the forwards do 8d^2 and 10d^2)
    and, for the sampled cell, 4 * d_hidden * d_feat for each of the
    169,984 gathered rows, the 153,600 leaves included (they are only
    averaged): about 10x GraphSAGE's forward there."""
    cfg = cell["cfg"]
    d = cfg.d_hidden
    if cell["kind"] == "minibatch":
        sizes = [cell["batch_nodes"] * math.prod(cell["fanouts"][:k])
                 for k in range(len(cell["fanouts"]) + 1)]
        w, flops = cfg.d_in, 0.0
        for li in range(cfg.n_layers):
            for k in range(len(cell["fanouts"]) - li):
                flops += 2 * 2 * sizes[k] * w * d + sizes[k + 1] * w
            w = d
        return flops + 2 * sizes[0] * d * cfg.d_out
    n, m = cell["n_nodes"], cell["n_edges"]
    widths = [cfg.d_in] + [d] * cfg.n_layers
    if cfg.arch == "graphsage":
        flops = sum(2 * 2 * n * widths[i] * d + m * widths[i] for i in range(cfg.n_layers))
        return flops + 2 * n * d * cfg.d_out
    if cfg.arch == "pna":
        flops = sum(2 * m * 2 * widths[i] * widths[i] + 5 * m * widths[i]
                    + 2 * n * 13 * widths[i] * widths[i + 1] for i in range(cfg.n_layers))
        return flops + 2 * n * d * cfg.d_out
    if cfg.arch == "gatedgcn":
        flops = 2 * n * cfg.d_in * d + 2 * m * cfg.d_edge_in * d
        return flops + cfg.n_layers * (8 * m * d * d + 2 * n * d * d + 2 * m * d) \
            + 2 * n * d * cfg.d_out
    hidden = [d] * cfg.mlp_layers
    flops = (mlp_flops([cfg.d_in] + hidden + [d], n) + mlp_flops([cfg.d_edge_in] + hidden + [d], m)
             + mlp_flops([d] + hidden + [cfg.d_out], n))
    return flops + cfg.n_layers * (mlp_flops([3 * d] + hidden + [d], m)
                                   + mlp_flops([2 * d] + hidden + [d], n) + m * d)


def gnn_bound(cell: dict) -> dict:
    """The least time of one forward: its operations
    (``gnn_forward_flops``) at 67 TF/s float32 against the per-edge gathers
    and scatters (``gnn_edge_bytes``; the sampled cell's feature gather,
    each row once) at 3.35 TB/s.  ``ref_gflop`` is the reference's count,
    a third of the cell's ``model_flops``."""
    flops = gnn_forward_flops(cell)
    if cell["kind"] == "minibatch":
        rows = sum(cell["batch_nodes"] * math.prod(cell["fanouts"][:k])
                   for k in range(len(cell["fanouts"]) + 1))
        n_bytes = 4.0 * rows * cell["d_feat"]
    else:
        n_bytes = gnn_edge_bytes(cell["cfg"], cell["n_edges"])
    t_ops, t_bytes = flops / PEAK_FLOPS["float32"] * 1e3, bound_ms(n_bytes)
    return {"gflop": flops / 1e9, "ref_gflop": cell["model_flops"] / 3e9, "gb": n_bytes / 1e9,
            "ops_ms": t_ops, "bytes_ms": t_bytes, "ms": max(t_ops, t_bytes),
            "by": "operations" if t_ops >= t_bytes else "bytes"}


class HostHeap:
    """Within the block, glibc serves large host blocks from its heap and
    keeps up to 2 GB freed at its top: by default every block above 32 MB
    is a fresh ``mmap`` returned at ``free``, so each float64 CPU tensor of
    the checks paid its page faults anew (a GatedGCN block forward 24 s
    against 6.7 s on an 8-core host).  Leaves the defaults and trims the
    heap on exit.  Only this process's allocator changes."""

    M_TRIM_THRESHOLD, M_TOP_PAD, M_MMAP_MAX = -1, -2, -4

    def __enter__(self):
        import ctypes

        self.libc = ctypes.CDLL("libc.so.6")
        self.libc.mallopt(self.M_MMAP_MAX, 0)
        self.libc.mallopt(self.M_TRIM_THRESHOLD, 2**31 - 1)
        self.libc.mallopt(self.M_TOP_PAD, 2**30)
        return self

    def __exit__(self, *exc):
        self.libc.mallopt(self.M_MMAP_MAX, 65536)
        self.libc.mallopt(self.M_TRIM_THRESHOLD, 128 * 1024)
        self.libc.mallopt(self.M_TOP_PAD, 128 * 1024)
        self.libc.malloc_trim(0)
        return False


def rel_err(got, want) -> float:
    """max |got - want| over max(max |want|, 1), in float64 on want's device."""
    want = want.double()
    got = got.to(device=want.device, dtype=want.dtype)
    return float((got - want).abs().max() / max(float(want.abs().max()), 1.0))


def gnn_inputs(torch, cfg, n: int, m: int, gen, extra: dict | None = None) -> dict:
    """A leg's features, labels and edge features on the generator's
    device, drawn for the cell's config (its task, d_in and d_out)."""
    dev = gen.device
    inp = {"feats": torch.randn((n, cfg.d_in), generator=gen, device=dev),
           "edge_feats": torch.randn((m, cfg.d_edge_in), generator=gen, device=dev),
           **(extra or {})}
    if cfg.task == "regression":
        inp["labels"] = torch.randn((n, cfg.d_out), generator=gen, device=dev)
    elif cfg.task == "graph":
        inp["labels"] = torch.randint(0, cfg.d_out, (inp["n_graphs"],), generator=gen,
                                      device=dev)
    else:
        inp["labels"] = torch.randint(0, cfg.d_out, (n,), generator=gen, device=dev)
    return inp


def to_host64(t):
    """A tensor on the CPU, floating ones in float64."""
    if t is None:
        return None
    return t.cpu().double() if t.is_floating_point() else t.cpu()


def gnn_leg(torch, name: str, cell_name: str, cell: dict, model, inp: dict, src, dst,
            smi: str) -> dict:
    """One architecture on one edge-list cell: forward ms (CUDA events,
    median of ``GNN_REPS`` warm runs), the loss through ``gnn_loss``, peak
    allocated memory, launches (none), and the card against a float64 copy
    of the module on the CPU on the same inputs (outputs and loss)."""
    from repro_torch.models.gnn import gnn_forward, gnn_loss, output_loss

    cfg = model.cfg
    n = inp["feats"].shape[0]
    kw = {k: inp.get(k) for k in ("label_mask", "edge_feats", "graph_ids")}
    kw["n_graphs"] = inp.get("n_graphs", 0)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    before = torch.cuda.memory_allocated()
    reset_launch_counts()

    def forward():
        return gnn_forward(model, None, inp["feats"], src, dst, kw["edge_feats"])

    ms = call_ms(torch, forward, GNN_REPS)
    out = forward()
    loss = gnn_loss(model, None, inp["feats"], src, dst, inp["labels"], **kw)
    torch.cuda.synchronize()
    peak = torch.cuda.max_memory_allocated()
    check(read_launch_counts() == counts_zero(),
          f"GNN {name} {cell_name}: launched {read_launch_counts()}")
    check(out.shape == (n, cfg.d_out) and bool(torch.isfinite(out).all())
          and bool(torch.isfinite(loss)), f"GNN {name} {cell_name}: output misshapen or not finite")

    t = time.monotonic()
    with HostHeap():
        model64 = copy.deepcopy(model).to(device="cpu", dtype=torch.float64)
        out64 = gnn_forward(model64, None, to_host64(inp["feats"]), src.cpu(), dst.cpu(),
                            to_host64(kw["edge_feats"]))
        loss64 = output_loss(out64, cfg, to_host64(inp["labels"]),
                             to_host64(kw["label_mask"]), to_host64(kw["graph_ids"]),
                             kw["n_graphs"])
        del model64
    cpu_s = time.monotonic() - t
    err = rel_err(out, out64)
    loss_err = abs(float(loss) - float(loss64)) / max(abs(float(loss64)), 1.0)
    check(err <= GNN_TOL and loss_err <= GNN_LOSS_TOL,
          f"GNN {name} {cell_name}: card vs float64 CPU, outputs {err:.3e} (tolerance "
          f"{GNN_TOL:g}), loss {loss_err:.3e} (tolerance {GNN_LOSS_TOL:g})")
    b = gnn_bound(cell)
    log(f"GNN {name} {cell_name} ({n:,} vertices, {src.shape[0]:,} arcs, d_in {cfg.d_in}, "
        f"d_out {cfg.d_out}, {cfg.task}): forward {ms:.4f} ms (median of {GNN_REPS} warm, "
        f"CUDA events), loss {float(loss):.6f}, peak allocated {peak / 1e9:.3f} GB "
        f"({before / 1e9:.3f} GB before); bound {b['ms']:.4f} ms by {b['by']} "
        f"({b['gflop']:.3f} GFLOP at 67 TF/s: {b['ops_ms']:.4f} ms, the reference counts "
        f"{b['ref_gflop']:.3f}; {b['gb']:.4f} GB of per-edge gathers and scatters at 3.35 "
        f"TB/s: {b['bytes_ms']:.4f} ms), "
        f"{b['ms'] / ms:.1%} of it; card vs float64 CPU: outputs {err:.2e} (tolerance "
        f"{GNN_TOL:g}), loss {loss_err:.2e} (tolerance {GNN_LOSS_TOL:g}), CPU {cpu_s:.1f} s; "
        f"no kernel launched [{smi}]")
    return {"ms": ms, "loss": float(loss), "loss64": float(loss64), "peak_gb": peak / 1e9,
            "before_gb": before / 1e9, "max_rel_err": err, "loss_rel_err": loss_err,
            "bound": b, "cpu_s": cpu_s}


def reddit_csr(torch, n: int, m: int, gen) -> dict:
    """A reddit-shaped CSR drawn on the card: ``m`` arcs with uniform
    sources and destinations, except that every vertex v with v % 100 == 99
    has no out-arc (its arcs go from v - 1), so that the sampler's
    self-loop fallback runs.  Each row sorted; ``keys`` (src * n + dst,
    sorted) lets a membership check search them."""
    src = torch.randint(0, n, (m,), generator=gen, device=gen.device)
    src = torch.where(src % 100 == 99, src - 1, src)
    keys = torch.sort(src * n + torch.randint(0, n, (m,), generator=gen,
                                              device=gen.device)).values
    del src
    indptr = torch.zeros(n + 1, dtype=torch.int64, device=gen.device)
    indptr[1:] = torch.bincount(keys // n, minlength=n).cumsum(0)
    return {"keys": keys, "indptr": indptr, "indices": (keys % n).to(torch.int32)}


def check_hops(torch, csr: dict, hops: list, fanouts, n: int) -> list[int]:
    """The sampler's invariants: hop sizes, and every id a neighbour of its
    parent, or the parent itself when the parent has no out-arc.  Returns
    the number of isolated parents of each hop."""
    keys, deg = csr["keys"], csr["indptr"].diff()
    check([h.shape[0] for h in hops] == [hops[0].shape[0] * math.prod(fanouts[:k])
                                          for k in range(len(fanouts) + 1)],
          f"sampler: hop sizes {[h.shape[0] for h in hops]}")
    isolated = []
    for k, f in enumerate(fanouts):
        parent = hops[k].long().repeat_interleave(f)
        child = hops[k + 1].long()
        iso = deg[parent] == 0
        q = parent * n + child
        pos = torch.searchsorted(keys, q).clamp_max(keys.shape[0] - 1)
        ok = torch.where(iso, child == parent, keys[pos] == q)
        check(bool(ok.all()), f"sampler: hop {k + 1} has {int((~ok).sum())} ids that are "
                              f"not a neighbour of their parent")
        isolated.append(int(iso.sum()) // f)
    return isolated


def phase_gnn(torch, dev, seed: int, smi: str) -> dict:
    """The four GNN configurations at full width and depth, float32,
    through ``get_arch``, ``init_gnn``, ``gnn_forward`` and ``gnn_loss`` on
    the reference's shape cells: ``full_graph_sm`` (an R-MAT graph of 2,708
    vertices and 10,556 arcs, 1,433 features), ``molecule``
    (``batched_molecule_graphs(128, 30, 128)``), ``minibatch_lg`` (a
    reddit-shaped CSR drawn on the card, 1,024 seeds sampled 15-10 by
    ``sample_neighbors_device``: GraphSAGE through
    ``graphsage_minibatch_forward``, the others on the sampled block as an
    edge list) and, for GraphSAGE only, ``ogb_products`` (2,449,029
    vertices, 61,859,140 arcs, drawn on the card).  Every leg but
    ``ogb_products`` is held against a float64 copy of the module on the
    CPU; ``ogb_products`` must be finite and agree between two runs."""
    from repro_torch.configs import get_arch
    from repro_torch.configs.common import gnn_cells
    from repro_torch.graph.generators import batched_molecule_graphs, rmat_graph
    from repro_torch.graph.sampler import sample_neighbors_device
    from repro_torch.models.gnn import (gnn_forward, gnn_loss, graphsage_minibatch_forward,
                                        init_gnn, output_loss)

    t_phase = time.monotonic()
    cells = {name: gnn_cells(get_arch(name).model_config) for name in GNN_ARCHS}
    gen = torch.Generator(device=dev)
    rows = {name: {} for name in GNN_ARCHS}

    def model_for(name, cell_name, k):
        gen.manual_seed(seed + 100 * k)
        return init_gnn(cells[name][cell_name]["cfg"], gen, dev)

    # -- full_graph_sm and molecule: host generators, every architecture
    sm, mo = cells["pna"]["full_graph_sm"], cells["pna"]["molecule"]
    graphs = {"full_graph_sm": (rmat_graph(sm["n_nodes"], sm["n_edges"], seed=seed), {}),
              "molecule": (batched_molecule_graphs(mo["n_graphs"], 30, 128, seed=seed),
                           {"graph_ids": torch.arange(mo["n_graphs"], device=dev)
                            .repeat_interleave(30), "n_graphs": mo["n_graphs"]})}
    for cell_name, (graph, extra) in graphs.items():
        src = torch.from_numpy(graph.edge_sources()).to(dev)
        dst = torch.from_numpy(graph.indices).to(dev)
        check((graph.n_nodes, graph.n_edges) == (cells["pna"][cell_name]["n_nodes"],
                                                 cells["pna"][cell_name]["n_edges"]),
              f"GNN {cell_name}: {graph.n_nodes} vertices, {graph.n_edges} arcs")
        for k, name in enumerate(GNN_ARCHS):
            cell = cells[name][cell_name]
            model = model_for(name, cell_name, k)
            inp = gnn_inputs(torch, cell["cfg"], graph.n_nodes, graph.n_edges, gen, extra)
            rows[name][cell_name] = gnn_leg(torch, name, cell_name, cell, model, inp, src, dst,
                                            smi)
            del model, inp

    # -- minibatch_lg: the reddit-shaped CSR, sampled on the card
    mb = cells["graphsage-reddit"]["minibatch_lg"]
    n, m, fanouts = mb["n_nodes"], mb["n_edges"], mb["fanouts"]
    t = time.monotonic()
    gen.manual_seed(seed)
    csr = reddit_csr(torch, n, m, gen)
    table = torch.randn((n, mb["d_feat"]), generator=gen, device=dev)
    seeds = torch.randint(0, n, (mb["batch_nodes"],), generator=gen, device=dev)
    torch.cuda.synchronize()
    setup_s = time.monotonic() - t
    sampler_gen = torch.Generator(device=dev)

    def draw():
        sampler_gen.manual_seed(seed + 1)
        return sample_neighbors_device(sampler_gen, csr["indptr"], csr["indices"], seeds,
                                       fanouts, device=dev)

    reset_launch_counts()
    hops = draw()
    check(all(torch.equal(a, b) for a, b in zip(hops, draw())),
          "sampler: the same generator seed drew other ids")
    isolated = check_hops(torch, csr, hops, fanouts, n)
    sample_ms = call_ms(torch, draw, GNN_REPS)
    layer_feats = [table[h] for h in hops]
    gather_ms = call_ms(torch, lambda: [table[h] for h in hops], GNN_REPS)
    log(f"GNN minibatch_lg: reddit-shaped CSR on the card, {n:,} vertices, {m:,} arcs "
        f"({int((csr['indptr'].diff() == 0).sum()):,} without an out-arc), a ({n:,}, "
        f"{mb['d_feat']}) feature table, set-up {setup_s:.2f} s; sample_neighbors_device "
        f"{mb['batch_nodes']} seeds, fanout {fanouts}: hops {[h.shape[0] for h in hops]}, "
        f"isolated parents by hop {isolated} (their children are themselves), every id a "
        f"neighbour of its parent; sampling {sample_ms:.4f} ms, the feature gather "
        f"{gather_ms:.4f} ms (medians of {GNN_REPS}, CUDA events) [{smi}]")

    cfg = mb["cfg"]
    model = model_for("graphsage-reddit", "minibatch_lg", 0)
    labels = torch.randint(0, mb["n_classes"], (mb["batch_nodes"],), generator=gen, device=dev)
    torch.cuda.reset_peak_memory_stats()
    before = torch.cuda.memory_allocated()
    ms = call_ms(torch, lambda: graphsage_minibatch_forward(model, layer_feats), GNN_REPS)
    out = graphsage_minibatch_forward(model, layer_feats)
    loss = output_loss(out, cfg, labels)     # the loss of the reference's minibatch cell
    torch.cuda.synchronize()
    peak = torch.cuda.max_memory_allocated()
    check(read_launch_counts() == counts_zero(),
          f"GNN graphsage-reddit minibatch_lg: launched {read_launch_counts()}")
    check(out.shape == (mb["batch_nodes"], mb["n_classes"]) and bool(torch.isfinite(out).all()),
          "GNN graphsage-reddit minibatch_lg: output misshapen or not finite")
    t = time.monotonic()
    with HostHeap():
        model64 = copy.deepcopy(model).to(device="cpu", dtype=torch.float64)
        out64 = graphsage_minibatch_forward(model64, [to_host64(x) for x in layer_feats])
        loss64 = output_loss(out64, cfg, labels.cpu())
    cpu_s = time.monotonic() - t
    err = rel_err(out, out64)
    loss_err = abs(float(loss) - float(loss64)) / max(abs(float(loss64)), 1.0)
    check(err <= GNN_TOL and loss_err <= GNN_LOSS_TOL,
          f"GNN graphsage-reddit minibatch_lg: card vs float64 CPU, outputs {err:.3e}, loss "
          f"{loss_err:.3e}")
    b = gnn_bound(mb)
    log(f"GNN graphsage-reddit minibatch_lg (graphsage_minibatch_forward, hops "
        f"{[h.shape[0] for h in hops]}, d_in {cfg.d_in}, {mb['n_classes']} classes): forward "
        f"{ms:.4f} ms (median of {GNN_REPS} warm, CUDA events), loss {float(loss):.6f}, peak "
        f"allocated {peak / 1e9:.3f} GB ({before / 1e9:.3f} GB before); bound {b['ms']:.4f} ms "
        f"by {b['by']} ({b['gflop']:.3f} GFLOP at 67 TF/s: {b['ops_ms']:.4f} ms, the reference "
        f"counts {b['ref_gflop']:.3f}; {b['gb']:.4f} GB of gathered rows at 3.35 TB/s: "
        f"{b['bytes_ms']:.4f} ms), {b['ms'] / ms:.1%} of it; "
        f"card vs float64 CPU on the same hop ids: outputs {err:.2e} (tolerance {GNN_TOL:g}), "
        f"loss {loss_err:.2e} (tolerance {GNN_LOSS_TOL:g}), CPU {cpu_s:.1f} s [{smi}]")
    rows["graphsage-reddit"]["minibatch_lg"] = {
        "ms": ms, "sample_ms": sample_ms, "gather_ms": gather_ms, "loss": float(loss),
        "loss64": float(loss64), "peak_gb": peak / 1e9, "before_gb": before / 1e9,
        "max_rel_err": err, "loss_rel_err": loss_err, "bound": b, "cpu_s": cpu_s,
        "isolated_parents": isolated, "setup_s": setup_s}
    del model, model64, layer_feats, out, out64

    # the sampled block as an edge list: hop k+1's position j -> its parent
    ids = torch.cat(hops)
    b0 = hops[0].shape[0]
    blk_src = torch.arange(b0, ids.shape[0], device=dev, dtype=torch.int32)
    blk_dst = torch.cat([torch.arange(hops[1].shape[0], device=dev) // fanouts[0],
                         b0 + torch.arange(hops[2].shape[0], device=dev) // fanouts[1]]
                        ).to(torch.int32)
    blk_feats = table[ids]
    seeds_mask = torch.zeros(ids.shape[0], device=dev)
    seeds_mask[:b0] = 1.0
    del csr, table, hops, ids
    torch.cuda.empty_cache()
    for k, name in enumerate(GNN_ARCHS[1:], start=1):
        cell = cells[name]["minibatch_lg"]
        check((blk_feats.shape[0], blk_src.shape[0]) == (cell["n_nodes"], cell["n_edges"]),
              f"GNN {name} minibatch_lg: the block has {blk_feats.shape[0]} vertices and "
              f"{blk_src.shape[0]} arcs")
        model = model_for(name, "minibatch_lg", k)
        inp = gnn_inputs(torch, cell["cfg"], cell["n_nodes"], cell["n_edges"], gen,
                         {"label_mask": seeds_mask})
        inp["feats"] = blk_feats
        rows[name]["minibatch_lg"] = gnn_leg(torch, name, "minibatch_lg (sampled block)", cell,
                                             model, inp, blk_src, blk_dst, smi)
        del model, inp
    del blk_src, blk_dst, blk_feats, seeds_mask
    torch.cuda.empty_cache()

    # -- ogb_products, GraphSAGE only: two runs agree within the atomics
    cell = cells["graphsage-reddit"]["ogb_products"]
    n, m = cell["n_nodes"], cell["n_edges"]
    t = time.monotonic()
    gen.manual_seed(seed + 7)
    src = torch.randint(0, n, (m,), generator=gen, device=dev, dtype=torch.int32)
    dst = torch.randint(0, n, (m,), generator=gen, device=dev, dtype=torch.int32)
    inp = gnn_inputs(torch, cell["cfg"], n, 0, gen)
    model = model_for("graphsage-reddit", "ogb_products", 0)
    torch.cuda.synchronize()
    setup_s = time.monotonic() - t
    torch.cuda.reset_peak_memory_stats()
    before = torch.cuda.memory_allocated()

    def forward():
        return gnn_forward(model, None, inp["feats"], src, dst)

    ms = call_ms(torch, forward, GNN_PRODUCTS_REPS)
    # run a's output goes to the host and the cache is emptied: a 0.46 GB
    # output left in a freed 30 GB block splits it, and run b's 29.5 GiB
    # gather then finds no block whole
    out_a = forward().cpu()
    torch.cuda.empty_cache()
    loss = gnn_loss(model, None, inp["feats"], src, dst, inp["labels"])
    torch.cuda.empty_cache()
    out_b = forward()
    torch.cuda.synchronize()
    peak = torch.cuda.max_memory_allocated()
    check(read_launch_counts() == counts_zero(),
          f"GNN graphsage-reddit ogb_products: launched {read_launch_counts()}")
    err = rel_err(out_b, out_a)
    check(out_b.shape == (n, cell["cfg"].d_out) and bool(torch.isfinite(out_b).all())
          and bool(torch.isfinite(loss)) and err <= GNN_ATOMICS_TOL,
          f"GNN graphsage-reddit ogb_products: not finite, or two runs differ by {err:.3e} "
          f"(tolerance {GNN_ATOMICS_TOL:g})")
    b = gnn_bound(cell)
    log(f"GNN graphsage-reddit ogb_products ({n:,} vertices, {m:,} arcs drawn on the card, "
        f"set-up {setup_s:.2f} s, d_in {cell['cfg'].d_in}, d_out {cell['cfg'].d_out}): forward "
        f"{ms:.4f} ms (median of {GNN_PRODUCTS_REPS} warm, CUDA events), loss "
        f"{float(loss):.6f}, peak allocated {peak / 1e9:.3f} GB ({before / 1e9:.3f} GB "
        f"before); bound {b['ms']:.4f} ms by {b['by']} ({b['gflop']:.3f} GFLOP at 67 TF/s: "
        f"{b['ops_ms']:.4f} ms, the reference counts {b['ref_gflop']:.3f}; {b['gb']:.4f} GB "
        f"of per-edge gathers and scatters at 3.35 "
        f"TB/s: {b['bytes_ms']:.4f} ms), {b['ms'] / ms:.1%} of it; two runs agree within "
        f"{err:.2e} (tolerance {GNN_ATOMICS_TOL:g}, float32 atomics) [{smi}]")
    rows["graphsage-reddit"]["ogb_products"] = {
        "ms": ms, "loss": float(loss), "peak_gb": peak / 1e9, "before_gb": before / 1e9,
        "runs_rel_err": err, "bound": b, "setup_s": setup_s}
    del src, dst, inp, model, out_a, out_b, loss
    gc.collect()
    torch.cuda.empty_cache()
    summary = {f"{name} {cell_name}": {"ms": r["ms"], "bound_ms": r["bound"]["ms"],
                                       "loss": r["loss"], "peak_gb": r["peak_gb"]}
               for name, by_cell in rows.items() for cell_name, r in by_cell.items()}
    log("phase 17 rows: " + json.dumps(summary) + f" [{smi}]")
    return {"rows": rows, "phase_s": time.monotonic() - t_phase, "card": smi}


# ---------------------------------------------------------------------------
# Phase 18: training on one device
# ---------------------------------------------------------------------------

TRAIN_LM_STEPS = 8           # leg (a): internlm2-1.8b steps
TRAIN_LM_BATCH = 4
TRAIN_LM_SEQ = 1025          # 1024 next-token positions a sequence
TRAIN_LM_MICROBATCHES = 2    # internlm2-1.8b's reference ARCH accumulates 2
TRAIN_LM_WARMUP = 2          # its OPT warms up over 2000 steps: cut to fit 8
TRAIN_MB_TOL = 2e-2          # microbatched vs full-batch gradients, of each leaf's largest (bf16)
TRAIN_F64_LAYERS = 2         # leg (b): internlm2-1.8b's depth cut to 2 layers, float32
TRAIN_F64_BATCH, TRAIN_F64_SEQ = 2, 129
TRAIN_F64_LOSS_TOL = 1e-5    # relative, card float32 vs CPU float64
TRAIN_F64_GRAD_TOL = 1e-3    # of each leaf's largest |grad| (phase 17's convention)
# Leg (d)'s gradient tolerances against float64, of each leaf's largest:
# phase 17's 1e-3 where float32 holds it.  PNA's max and min send each
# destination's gradient to its largest or smallest message; where two
# messages lie within float32 rounding of each other the float32 run and
# the float64 copy may pick different ones, and that message's whole share
# moves.  MeshGraphNet's first encoder weight takes its gradient through 15
# residual layers with layer norms and a sum over every vertex of 1,433
# features; the reference's own float32 gradients miss float64 by more
# than 1e-3 there too.
TRAIN_GNN_GRAD_TOL = {"graphsage-reddit": 1e-3, "pna": 5e-2, "gatedgcn": 1e-3,
                      "meshgraphnet": 2e-2}
TRAIN_UPDATE_TOL = 1e-6      # one optimizer update, card vs CPU in float32, of each leaf's largest
TRAIN_UPDATE_STEP = 5        # the step the update is applied at (the schedule is 0 at step 0)
TRAIN_MOE_LAYERS = 2         # leg (c): deepseek-v2-lite's dense layer and one MoE layer
TRAIN_MOE_STEPS = 3
TRAIN_MOE_BATCH, TRAIN_MOE_SEQ = 2, 513
# leg (c)'s losses, grad norms and final parameters (on the host), which
# phase 19 leg (d) holds its (1, 1) mesh run to
MOE_REFERENCE: dict = {}
TRAIN_GNN_STEPS = 40         # leg (d): the torch_train_gnn twin, a fault at step 20
TRAIN_GNN_GRAPH = (50_000, 1_000_000)   # the twin's default RMAT graph
TRAIN_DLRM_BATCH = 2048      # leg (e): reduced dlrm-mlperf on RecSysBatches
TRAIN_DLRM_STEPS = 20
TRAIN_FAULT_STEPS = 40       # leg (f): the torch_train_lm twin, checkpoints every 10
TRAIN_FAULT_AT = 20
TRAIN_CKPT_EVERY = 10
# leg (g): Δ-PageRank's max error against the numpy PageRank; the reference
# quickstart's own on this graph is 8.17e-3 (``examples/quickstart.py``,
# tolerance 1e-5 on the Δ mass, 55 iterations)
QUICKSTART_PR_TOL = 1e-2
QUICKSTART_GRAPH = (50_000, 800_000)    # the quickstart's RMAT graph
TRAIN_LEGS = ("a", "b", "c", "d", "e", "f")   # the legs that train: no kernel may launch


def example_module(name: str):
    """``examples/<name>.py`` imported as a module (its ``main`` not run)."""
    import importlib.util

    path = ROOT / "examples" / f"{name}.py"
    spec = importlib.util.spec_from_file_location(f"example_{name}", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def leaf_errs(torch, leaves, got: dict, want: dict) -> tuple[float, str]:
    """The worst leaf's max |got - want| over its largest |want| (in float64
    on ``want``'s device), and its name; a leaf is the reference's
    (``param_leaves``)."""
    worst, where = 0.0, ""
    for lf in leaves:
        err = big = 0.0
        for m in lf.members:
            w = want[m].detach().double()
            g = got[m].detach().to(device=w.device, dtype=torch.float64)
            err = max(err, float((g - w).abs().max()))
            big = max(big, float(w.abs().max()))
        e = err / max(big, 1e-30)
        if e > worst:
            worst, where = e, lf.name
    return worst, where


def state_tensors(tree) -> list:
    """The tensors of an optimizer state, in order."""
    if isinstance(tree, dict):
        return [t for k in tree for t in state_tensors(tree[k])]
    return [tree]


def rel_state_err(a, b) -> float:
    """max |a - b| over max |b| (float64 on the CPU)."""
    a, b = a.detach().cpu().double(), b.detach().cpu().double()
    return float((a - b).abs().max()) / max(float(b.abs().max()), 1e-30)


@contextlib.contextmanager
def deterministic_algorithms(torch):
    """``torch.use_deterministic_algorithms(True)`` (warning where an op has
    no deterministic form, the warnings recorded) with cuBLAS's workspace
    set for it; everything restored on exit."""
    prior = (torch.are_deterministic_algorithms_enabled(),
             torch.is_deterministic_algorithms_warn_only_enabled())
    env = os.environ.get("CUBLAS_WORKSPACE_CONFIG")
    os.environ["CUBLAS_WORKSPACE_CONFIG"] = ":4096:8"
    torch.use_deterministic_algorithms(True, warn_only=True)
    try:
        with warnings.catch_warnings(record=True) as caught:
            warnings.simplefilter("always")
            yield caught
    finally:
        torch.use_deterministic_algorithms(prior[0], warn_only=prior[1])
        if env is None:
            os.environ.pop("CUBLAS_WORKSPACE_CONFIG", None)
        else:
            os.environ["CUBLAS_WORKSPACE_CONFIG"] = env


def train_leg_lm(torch, dev, seed: int, smi: str) -> dict:
    """Leg (a): internlm2-1.8b at full width and depth, float32 parameters,
    bf16 activations, remat, AdamW: the microbatched gradients of the first
    batch against the unsplit batch's, then ``TRAIN_LM_STEPS`` steps
    through ``make_train_step`` with ``apply_updates`` timed apart."""
    from repro_torch.configs.internlm2_1p8b import CONFIG, OPT
    from repro_torch.data.pipeline import LMBatches
    from repro_torch.models.transformer import init_transformer, lm_loss
    from repro_torch.train import train_step as ts

    cfg = CONFIG.replace(param_dtype="float32", dtype="bfloat16", remat=True)
    opt = OPT.replace(warmup_steps=TRAIN_LM_WARMUP, total_steps=TRAIN_LM_STEPS)
    log(f"train (a): {cfg.name} at full width and depth ({cfg.n_layers} layers, d_model "
        f"{cfg.d_model}, vocab {cfg.vocab}), float32 parameters, bf16 activations, remat; its "
        f"OPT ({OPT.name}, lr {OPT.learning_rate:g}) with warmup_steps {OPT.warmup_steps} -> "
        f"{opt.warmup_steps} and total_steps {OPT.total_steps} -> {opt.total_steps}; "
        f"microbatches {TRAIN_LM_MICROBATCHES}; LMBatches(vocab={cfg.vocab}, "
        f"batch={TRAIN_LM_BATCH}, seq_len={TRAIN_LM_SEQ}, seed={seed})")
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    t = time.monotonic()
    model = init_transformer(cfg, torch.Generator(device=dev).manual_seed(seed), dev)
    state = ts.init_train_state(model, opt, device=dev)
    torch.cuda.synchronize()
    init_s = time.monotonic() - t
    n_params = sum(p.numel() for p in model.parameters())
    pipe = LMBatches(vocab=cfg.vocab, batch=TRAIN_LM_BATCH, seq_len=TRAIN_LM_SEQ, seed=seed)
    batches = [torch.from_numpy(pipe.make(s)["tokens"]).to(dev) for s in range(TRAIN_LM_STEPS)]
    tokens = TRAIN_LM_BATCH * (TRAIN_LM_SEQ - 1)

    def loss_fn(m, b):
        return lm_loss(m, b)

    reset_launch_counts()
    loss_mb, g_mb = ts.value_and_grads(loss_fn, model, batches[0], TRAIN_LM_MICROBATCHES)
    loss_full, g_full = ts.value_and_grads(loss_fn, model, batches[0], 1)
    mb_err, mb_leaf = leaf_errs(torch, state.leaves, g_mb, g_full)
    del g_mb, g_full
    check(mb_err <= TRAIN_MB_TOL,
          f"train (a): microbatched vs full-batch gradients differ by {mb_err:.3e} of leaf "
          f"{mb_leaf}'s largest (tolerance {TRAIN_MB_TOL:g})")

    step_fn = ts.make_train_step(loss_fn, opt, microbatches=TRAIN_LM_MICROBATCHES)
    events = []
    real = ts.apply_updates

    def timed_updates(*args, **kw):
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        start.record()
        out = real(*args, **kw)
        end.record()
        events.append((start, end))
        return out

    secs, losses, norms = [], [], []
    ts.apply_updates = timed_updates
    try:
        for b in batches:
            torch.cuda.synchronize()
            t = time.monotonic()
            state, m = step_fn(state, b)
            losses.append(float(m["loss"]))
            norms.append(float(m["grad_norm"]))
            torch.cuda.synchronize()
            secs.append(time.monotonic() - t)
    finally:
        ts.apply_updates = real
    with torch.no_grad():
        # each step's loss is on its own batch, and LMBatches' batches differ
        # by more than a few steps move the loss (half of a row's tokens are
        # one drawn token): the first batch again, after the last step
        after = float(lm_loss(model, batches[0]))
    launches = read_launch_counts()
    peak = torch.cuda.max_memory_allocated()
    upd_ms = [s.elapsed_time(e) for s, e in events]
    check(launches == counts_zero(), f"train (a): launched {launches}")
    check(all(math.isfinite(v) for v in losses + norms + [after]),
          f"train (a): a loss or grad norm is not finite: {losses} {norms} {after}")
    check(after < losses[0], f"train (a): the first batch's loss did not fall: {losses[0]} -> "
          f"{after} (the steps' losses {losses})")
    step_s = float(np.median(secs[1:]))
    upd = float(np.median(upd_ms[1:]))
    flops = 6.0 * n_params * tokens
    mfu = flops / step_s / PEAK_FLOPS["bfloat16"]
    log(f"train (a): {n_params:,} parameters ({n_params * 4 / 1e9:.2f} GB float32; with "
        f"gradients and AdamW's two moments {n_params * 16 / 1e9:.2f} GB), built in "
        f"{init_s:.2f} s; microbatched vs full-batch gradients (loss {float(loss_mb):.6f} vs "
        f"{float(loss_full):.6f}) within {mb_err:.3e} of leaf {mb_leaf}'s largest (tolerance "
        f"{TRAIN_MB_TOL:g}); {TRAIN_LM_STEPS} steps: {step_s:.4f} s a step (median of steps "
        f"2-{TRAIN_LM_STEPS}; each {[round(s, 4) for s in secs]}), {tokens / step_s:,.0f} "
        f"tokens/s, 6*N*tokens with N = {n_params:,} (every parameter, the tied embedding "
        f"included) = {flops / 1e12:.2f} TFLOP a step: {mfu:.2%} of 989 TF/s; apply_updates "
        f"{upd:.2f} ms (median, CUDA events; each {[round(x, 2) for x in upd_ms]}); the "
        f"steps' losses {[round(x, 4) for x in losses]}, the first batch's {losses[0]:.4f} -> "
        f"{after:.4f} after the last step, grad_norm "
        f"{norms[0]:.4f} -> {norms[-1]:.4f}; peak allocated {peak / 1e9:.2f} GB; no kernel "
        f"launched [{smi}]")
    del state, model, batches, step_fn
    return {"n_params": n_params, "step_s": step_s, "step_secs": secs,
            "tokens_per_s": tokens / step_s, "mfu_989": mfu, "apply_updates_ms": upd,
            "apply_updates_all_ms": upd_ms, "losses": losses, "first_after": after,
            "grad_norms": norms,
            "microbatch_err": mb_err, "peak_gb": peak / 1e9, "init_s": init_s,
            "launches": launches}


def train_leg_f64(torch, dev, seed: int, smi: str) -> dict:
    """Leg (b): internlm2-1.8b at full width, depth cut to 2 layers, float32:
    the loss and every gradient on the card against a float64 copy on the
    CPU; one AdamW and one Adafactor update of the card's gradients on the
    card against the same update on the CPU in float32."""
    from repro_torch.configs.internlm2_1p8b import CONFIG, OPT
    from repro_torch.data.pipeline import LMBatches
    from repro_torch.models.transformer import init_transformer, lm_loss
    from repro_torch.train import optimizer as topt
    from repro_torch.train import train_step as ts

    cfg = CONFIG.replace(n_layers=TRAIN_F64_LAYERS, dtype="float32", param_dtype="float32")
    model = init_transformer(cfg, torch.Generator(device=dev).manual_seed(seed + 1), dev)
    for p in model.parameters():
        p.requires_grad_(True)
    leaves = ts.param_leaves(model)
    tokens = torch.from_numpy(LMBatches(vocab=cfg.vocab, batch=TRAIN_F64_BATCH,
                                        seq_len=TRAIN_F64_SEQ, seed=seed).make(0)["tokens"])
    reset_launch_counts()
    loss, grads = ts.value_and_grads(lambda m, b: lm_loss(m, b), model, tokens.to(dev))
    launches = read_launch_counts()
    check(launches == counts_zero(), f"train (b): launched {launches}")
    t = time.monotonic()
    with HostHeap():
        m64 = copy.deepcopy(model).to(device="cpu", dtype=torch.float64)
        m64.cfg = cfg.replace(dtype="float64", param_dtype="float64")
        loss64, g64 = ts.value_and_grads(lambda m, b: lm_loss(m, b), m64, tokens)
        del m64
    cpu_s = time.monotonic() - t
    loss_err = abs(float(loss) - float(loss64)) / abs(float(loss64))
    grad_err, grad_leaf = leaf_errs(torch, leaves, grads, g64)
    del g64
    check(loss_err <= TRAIN_F64_LOSS_TOL and grad_err <= TRAIN_F64_GRAD_TOL,
          f"train (b): card vs float64 CPU: loss {loss_err:.3e} (tolerance "
          f"{TRAIN_F64_LOSS_TOL:g}), gradients {grad_err:.3e} of leaf {grad_leaf}'s largest "
          f"(tolerance {TRAIN_F64_GRAD_TOL:g})")
    updates = {}
    for name in ("adamw", "adafactor"):
        # warmup cut to 1 step, so that the update at TRAIN_UPDATE_STEP is at
        # about the full learning rate and moves each weight well past 1e-6 of
        # its leaf's largest
        oc = OPT.replace(name=name, warmup_steps=1)
        p_card = {n: p.detach().clone() for n, p in model.named_parameters()}
        p_cpu = {n: p.cpu() for n, p in p_card.items()}
        g_cpu = {n: g.cpu() for n, g in grads.items()}
        s_card = topt.init_opt_state(oc, p_card, leaves)
        s_cpu = topt.init_opt_state(oc, p_cpu, leaves)
        torch.cuda.synchronize()
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        start.record()
        topt.apply_updates(oc, p_card, grads, s_card, TRAIN_UPDATE_STEP, leaves)
        end.record()
        end.synchronize()
        t = time.monotonic()
        topt.apply_updates(oc, p_cpu, g_cpu, s_cpu, TRAIN_UPDATE_STEP, leaves)
        err, leaf = leaf_errs(torch, leaves, p_card, p_cpu)
        state_err = max(rel_state_err(a, b) for a, b in zip(state_tensors(s_card),
                                                            state_tensors(s_cpu)))
        # the least any leaf moved, over that leaf's largest weight after the update
        old = {n: p.detach() for n, p in model.named_parameters()}
        moved = min(leaf_errs(torch, [lf], p_card, old)[0] for lf in leaves)
        check(err <= TRAIN_UPDATE_TOL and state_err <= TRAIN_UPDATE_TOL
              and moved >= 10 * TRAIN_UPDATE_TOL,
              f"train (b): {name} update, card vs CPU float32: parameters {err:.3e} of leaf "
              f"{leaf}'s largest, state {state_err:.3e} (tolerance {TRAIN_UPDATE_TOL:g}); the "
              f"least-moved leaf moved {moved:.3e} of its largest")
        updates[name] = {"err": err, "state_err": state_err, "card_ms": start.elapsed_time(end),
                         "cpu_s": time.monotonic() - t, "least_move": moved}
        del p_card, p_cpu, g_cpu, s_card, s_cpu
    n_params = sum(p.numel() for p in model.parameters())
    log(f"train (b): {cfg.name} at full width, {cfg.n_layers} layers, float32 ({n_params:,} "
        f"parameters), B = {TRAIN_F64_BATCH}, S = {TRAIN_F64_SEQ - 1}: loss {float(loss):.6f} vs "
        f"float64 {float(loss64):.6f} ({loss_err:.2e} relative, tolerance "
        f"{TRAIN_F64_LOSS_TOL:g}); every gradient leaf within {grad_err:.2e} of its largest "
        f"(worst {grad_leaf}; tolerance {TRAIN_F64_GRAD_TOL:g}); CPU float64 {cpu_s:.1f} s; "
        + "; ".join(f"{k} update at step {TRAIN_UPDATE_STEP}: card {v['card_ms']:.2f} ms, CPU "
                    f"{v['cpu_s']:.2f} s, card vs CPU float32: parameters {v['err']:.2e} of "
                    f"each leaf's largest, state {v['state_err']:.2e} (tolerance "
                    f"{TRAIN_UPDATE_TOL:g}), every leaf moved by at least "
                    f"{v['least_move']:.2e} of its largest"
                    for k, v in updates.items())
        + f"; no kernel launched [{smi}]")
    del model, grads
    return {"loss": float(loss), "loss64": float(loss64), "loss_err": loss_err,
            "grad_err": grad_err, "grad_leaf": grad_leaf, "updates": updates, "cpu_s": cpu_s,
            "launches": launches}


def train_leg_moe(torch, dev, seed: int, smi: str) -> dict:
    """Leg (c): deepseek-v2-lite-16b at full width, depth cut to its dense
    layer and one MoE layer, float32: ``TRAIN_MOE_STEPS`` AdamW steps
    through the plain MoE route (no ``grouped_matmul``), the aux loss."""
    from repro_torch.configs.deepseek_v2_lite_16b import CONFIG, OPT
    from repro_torch.data.pipeline import LMBatches
    from repro_torch.models.transformer import _train_hidden, init_transformer, lm_loss
    from repro_torch.train import train_step as ts

    cfg = CONFIG.replace(n_layers=TRAIN_MOE_LAYERS, dtype="float32", param_dtype="float32")
    opt = OPT.replace(warmup_steps=1, total_steps=TRAIN_MOE_STEPS)
    model = init_transformer(cfg, torch.Generator(device=dev).manual_seed(seed + 2), dev)
    state = ts.init_train_state(model, opt, device=dev)
    n_params = sum(p.numel() for p in model.parameters())
    pipe = LMBatches(vocab=cfg.vocab, batch=TRAIN_MOE_BATCH, seq_len=TRAIN_MOE_SEQ, seed=seed)
    step_fn = ts.make_train_step(lambda m, b: lm_loss(m, b), opt)
    torch.cuda.reset_peak_memory_stats()
    reset_launch_counts()
    losses, norms, secs = [], [], []
    first = torch.from_numpy(pipe.make(0)["tokens"]).to(dev)
    for s in range(TRAIN_MOE_STEPS):
        b = torch.from_numpy(pipe.make(s)["tokens"]).to(dev)
        torch.cuda.synchronize()
        t = time.monotonic()
        state, m = step_fn(state, b)
        losses.append(float(m["loss"]))
        norms.append(float(m["grad_norm"]))
        secs.append(time.monotonic() - t)
    # phase 19 leg (d) runs these steps on a (1, 1) mesh and holds them to these
    MOE_REFERENCE.update(losses=list(losses), norms=list(norms), secs=list(secs),
                         params={n: p.detach().to("cpu", copy=True)
                                 for n, p in model.named_parameters()})
    with torch.no_grad():
        # the first batch again after the steps: its loss must have fallen
        after = float(lm_loss(model, first))
        _, aux = _train_hidden(model, b[:, :-1])
    launches = read_launch_counts()
    peak = torch.cuda.max_memory_allocated()
    check(launches == counts_zero(), f"train (c): launched {launches}")
    check(all(math.isfinite(v) for v in losses + [after, float(aux)]) and after < losses[0],
          f"train (c): losses {losses}, the first batch's after the steps {after}: not finite "
          "or not falling")
    log(f"train (c): {cfg.name} at full width, {cfg.n_layers} layers (a dense layer and one "
        f"MoE layer of {cfg.moe.n_experts} experts, top {cfg.moe.top_k}), float32, "
        f"{n_params:,} parameters; OPT warmup_steps {OPT.warmup_steps} -> {opt.warmup_steps}, "
        f"total_steps -> {opt.total_steps}; {TRAIN_MOE_STEPS} steps of {TRAIN_MOE_BATCH} x "
        f"{TRAIN_MOE_SEQ - 1} tokens: loss {[round(x, 4) for x in losses]}, the first batch's "
        f"loss after them {after:.4f}, aux "
        f"{float(aux):.6f} after the last step, seconds a step {[round(x, 3) for x in secs]}, "
        f"peak allocated {peak / 1e9:.2f} GB; grouped_matmul launched "
        f"{launches['grouped_matmul']} times, no kernel launched [{smi}]")
    del state, model, step_fn
    return {"losses": losses, "norms": norms, "first_after": after, "aux": float(aux),
            "step_secs": secs, "peak_gb": peak / 1e9,
            "n_params": n_params, "launches": launches}


def train_leg_gnn(torch, dev, seed: int, smi: str) -> dict:
    """Leg (d): the four GNN configs at full width and depth on
    ``full_graph_sm`` and ``molecule``: the loss and every gradient on the
    card against a float64 copy on the CPU; then the ``torch_train_gnn``
    twin on the card, a fault at step ``TRAIN_FAULT_AT``."""
    from repro_torch.configs import get_arch
    from repro_torch.configs.common import gnn_cells
    from repro_torch.graph.generators import batched_molecule_graphs, rmat_graph
    from repro_torch.models.gnn import gnn_loss, init_gnn
    from repro_torch.train import train_step as ts

    gen = torch.Generator(device=dev)
    cells = {name: gnn_cells(get_arch(name).model_config) for name in GNN_ARCHS}
    sm, mo = cells["pna"]["full_graph_sm"], cells["pna"]["molecule"]
    graphs = {"full_graph_sm": (rmat_graph(sm["n_nodes"], sm["n_edges"], seed=seed), {}),
              "molecule": (batched_molecule_graphs(mo["n_graphs"], 30, 128, seed=seed),
                           {"graph_ids": torch.arange(mo["n_graphs"], device=dev)
                            .repeat_interleave(30), "n_graphs": mo["n_graphs"]})}
    rows = {}
    reset_launch_counts()
    for cell_name, (graph, extra) in graphs.items():
        src = torch.from_numpy(graph.edge_sources()).to(dev)
        dst = torch.from_numpy(graph.indices).to(dev)
        for k, name in enumerate(GNN_ARCHS):
            cell = cells[name][cell_name]
            gen.manual_seed(seed + 200 + k)
            model = init_gnn(cell["cfg"], gen, dev)
            for p in model.parameters():
                p.requires_grad_(True)
            inp = gnn_inputs(torch, cell["cfg"], graph.n_nodes, graph.n_edges, gen, extra)
            kw = {k2: inp.get(k2) for k2 in ("edge_feats", "graph_ids")}
            kw["n_graphs"] = inp.get("n_graphs", 0)

            def loss_fn(m, b, kw=kw):
                return gnn_loss(m, None, b["feats"], b["src"], b["dst"], b["labels"], **kw)

            batch = {"feats": inp["feats"], "src": src, "dst": dst, "labels": inp["labels"]}
            loss, grads = ts.value_and_grads(loss_fn, model, batch)
            with HostHeap():
                m64 = copy.deepcopy(model).to(device="cpu", dtype=torch.float64)
                kw64 = {k2: (to_host64(v) if isinstance(v, torch.Tensor) else v)
                        for k2, v in kw.items()}
                loss64, g64 = ts.value_and_grads(
                    lambda m, b: gnn_loss(m, None, b["feats"], b["src"], b["dst"], b["labels"],
                                          **kw64),
                    m64, {k2: to_host64(v) for k2, v in batch.items()})
                del m64
            loss_err = abs(float(loss) - float(loss64)) / max(abs(float(loss64)), 1.0)
            err, leaf = leaf_errs(torch, ts.param_leaves(model), grads, g64)
            tol = TRAIN_GNN_GRAD_TOL[name]
            check(loss_err <= GNN_LOSS_TOL and err <= tol,
                  f"train (d): {name} {cell_name}: card vs float64 CPU, loss {loss_err:.3e} "
                  f"(tolerance {GNN_LOSS_TOL:g}), gradients {err:.3e} of leaf {leaf}'s largest "
                  f"(tolerance {tol:g})")
            rows[f"{name} {cell_name}"] = {"loss": float(loss), "loss_err": loss_err,
                                           "grad_err": err, "grad_leaf": leaf, "tol": tol}
            del model, inp, grads, g64
    launches_f64 = read_launch_counts()
    t = time.monotonic()
    twin = example_module("torch_train_gnn")
    state, metrics, restarts = twin.train(*TRAIN_GNN_GRAPH, TRAIN_GNN_STEPS, dev,
                                          ckpt_every=TRAIN_CKPT_EVERY,
                                          fail_at=(TRAIN_FAULT_AT,))
    twin_s = time.monotonic() - t
    launches = read_launch_counts()
    first = float(np.mean([m["loss"] for m in metrics[:10]]))
    last = float(np.mean([m["loss"] for m in metrics[-10:]]))
    check(launches == counts_zero(), f"train (d): launched {launches}")
    check(restarts == 1 and state.step == TRAIN_GNN_STEPS and last < first,
          f"train (d): the GraphSAGE twin: restarts {restarts}, step {state.step}, loss "
          f"{first:.4f} -> {last:.4f}")
    log("train (d): " + "; ".join(
        f"{k}: loss {r['loss']:.6f}, vs float64 CPU loss {r['loss_err']:.2e}, gradients "
        f"{r['grad_err']:.2e} (worst {r['grad_leaf']}; tolerance {r['tol']:g})"
        for k, r in rows.items())
        + f" (the loss's tolerance {GNN_LOSS_TOL:g}); the torch_train_gnn "
        f"twin (GraphSAGE on its RMAT graph of {TRAIN_GNN_GRAPH[0]:,} vertices and "
        f"{TRAIN_GNN_GRAPH[1]:,} arcs, {TRAIN_GNN_STEPS} steps, a fault at "
        f"step {TRAIN_FAULT_AT}, checkpoints every {TRAIN_CKPT_EVERY}): restarts {restarts}, "
        f"loss (mean of 10) {first:.4f} -> {last:.4f}, {twin_s:.1f} s; no kernel launched "
        f"[{smi}]")
    del state
    return {"rows": rows, "twin": {"first": first, "last": last, "restarts": restarts,
                                   "seconds": twin_s},
            "launches": {k: launches[k] + launches_f64[k] for k in launches}}


def train_leg_dlrm(torch, dev, seed: int, smi: str) -> dict:
    """Leg (e): the reduced dlrm-mlperf: one step's loss and gradients on the
    card against a float64 copy on the CPU (the plain bag), then
    ``TRAIN_DLRM_STEPS`` AdamW steps on ``RecSysBatches`` with Zipf ids."""
    from repro_torch.configs import get_arch
    from repro_torch.configs.common import reduce_dlrm_config
    from repro_torch.configs.dlrm_mlperf import OPT
    from repro_torch.data.pipeline import RecSysBatches
    from repro_torch.models.dlrm import dlrm_loss, init_dlrm
    from repro_torch.train import train_step as ts

    cfg = reduce_dlrm_config(get_arch("dlrm-mlperf").model_config)
    opt = OPT.replace(warmup_steps=2, total_steps=TRAIN_DLRM_STEPS)
    model = init_dlrm(cfg, torch.Generator(device=dev).manual_seed(seed + 3), dev)
    state = ts.init_train_state(model, opt, device=dev)
    pipe = RecSysBatches(vocab_sizes=cfg.vocab_sizes, batch=TRAIN_DLRM_BATCH,
                         n_dense=cfg.n_dense, seed=seed)

    def batch_of(s):
        return {k: torch.from_numpy(v).to(dev) for k, v in pipe.make(s).items()}

    def loss_fn(m, b):
        return dlrm_loss(m, b["dense"], b["sparse"], b["labels"], use_kernels=False)

    reset_launch_counts()
    b0 = batch_of(0)
    loss, grads = ts.value_and_grads(loss_fn, model, b0)
    with HostHeap():
        m64 = copy.deepcopy(model).to(device="cpu", dtype=torch.float64)
        loss64, g64 = ts.value_and_grads(loss_fn, m64, {k: to_host64(v) for k, v in b0.items()})
    loss_err = abs(float(loss) - float(loss64)) / max(abs(float(loss64)), 1.0)
    err, leaf = leaf_errs(torch, state.leaves, grads, g64)
    check(loss_err <= TRAIN_F64_LOSS_TOL and err <= TRAIN_F64_GRAD_TOL,
          f"train (e): card vs float64 CPU, loss {loss_err:.3e}, gradients {err:.3e} of leaf "
          f"{leaf}'s largest")
    step_fn = ts.make_train_step(loss_fn, opt)
    losses = []
    for s in range(TRAIN_DLRM_STEPS):
        state, m = step_fn(state, batch_of(s))
        losses.append(float(m["loss"]))
    with torch.no_grad():
        after = float(loss_fn(model, b0))
    launches = read_launch_counts()
    check(launches == counts_zero(), f"train (e): launched {launches}")
    check(all(math.isfinite(v) for v in losses + [after]) and after < losses[0],
          f"train (e): losses {losses}, the first batch's after the steps {after}: not finite "
          "or not falling")
    log(f"train (e): reduced dlrm-mlperf (tables {cfg.vocab_sizes}, D {cfg.embed_dim}), "
        f"B = {TRAIN_DLRM_BATCH}, Zipf ids: loss {float(loss):.6f} vs float64 "
        f"{float(loss64):.6f} ({loss_err:.2e}), gradients within {err:.2e} of each leaf's "
        f"largest (worst {leaf}); {TRAIN_DLRM_STEPS} steps: loss {losses[0]:.4f} -> "
        f"{losses[-1]:.4f}, the first batch's {losses[0]:.4f} -> {after:.4f}; embedding_bag "
        f"launched {launches['embedding_bag']} times, no kernel launched [{smi}]")
    del state, model
    return {"loss_err": loss_err, "grad_err": err, "losses": losses, "first_after": after,
            "launches": launches}


def train_leg_fault(torch, dev, seed: int, smi: str) -> dict:
    """Leg (f): the ``torch_train_lm`` twin's MoE with int8 compression and
    error feedback, ``TRAIN_FAULT_STEPS`` steps with checkpoints every
    ``TRAIN_CKPT_EVERY`` and a fault at ``TRAIN_FAULT_AT``, against the
    same run with no fault, both under deterministic algorithms: the final
    parameters and error state bit-equal; then one async save and one
    restore of the final state, timed."""
    import tempfile

    from repro_torch.train.checkpoint import restore_checkpoint, save_checkpoint
    from repro_torch.train.train_step import named_params

    twin = example_module("torch_train_lm")
    cfg = twin.lm_config()
    runs = {}
    reset_launch_counts()
    with deterministic_algorithms(torch) as caught:
        for name, fail_at in (("fault", (TRAIN_FAULT_AT,)), ("clean", ())):
            t = time.monotonic()
            state, metrics, restarts = twin.train(cfg, TRAIN_FAULT_STEPS, dev,
                                                  ckpt_every=TRAIN_CKPT_EVERY, fail_at=fail_at)
            torch.cuda.synchronize()
            runs[name] = {"state": state, "restarts": restarts, "seconds": time.monotonic() - t,
                          "first": metrics[0]["loss"], "last": metrics[-1]["loss"]}
    launches = read_launch_counts()
    nondet = sorted({str(w.message)[:120] for w in caught if "determinis" in str(w.message)})
    a, b = runs["fault"]["state"], runs["clean"]["state"]
    pa, pb = named_params(a.params), named_params(b.params)
    same = (all(torch.equal(pa[n], pb[n]) for n in pa)
            and all(torch.equal(a.error_state[k], b.error_state[k]) for k in a.error_state))
    n_params = sum(p.numel() for p in pa.values())
    check(launches == counts_zero(), f"train (f): launched {launches}")
    check(runs["fault"]["restarts"] == 1 and runs["clean"]["restarts"] == 0,
          f"train (f): restarts {runs['fault']['restarts']} and {runs['clean']['restarts']}")
    check(same, "train (f): the resumed run's parameters or error state differ from the "
          "uninterrupted run's")
    with tempfile.TemporaryDirectory() as d:
        torch.cuda.synchronize()
        t = time.monotonic()
        writer = save_checkpoint(d, TRAIN_FAULT_STEPS, a, async_write=True)
        snap_s = time.monotonic() - t
        writer.join()
        write_s = time.monotonic() - t
        t = time.monotonic()
        restore_checkpoint(d, b)
        torch.cuda.synchronize()
        restore_s = time.monotonic() - t
        ckpt_bytes = sum(f.stat().st_size for f in Path(d).rglob("*") if f.is_file())
    log(f"train (f): the torch_train_lm twin ({cfg.name}, {n_params:,} parameters, int8 "
        f"compression with error feedback), {TRAIN_FAULT_STEPS} steps, checkpoints every "
        f"{TRAIN_CKPT_EVERY}, under torch.use_deterministic_algorithms(True): a fault at step "
        f"{TRAIN_FAULT_AT} ({runs['fault']['restarts']} restart, {runs['fault']['seconds']:.1f} "
        f"s) against none ({runs['clean']['seconds']:.1f} s): final parameters and error state "
        f"bit-equal; loss {runs['clean']['first']:.4f} -> {runs['clean']['last']:.4f}; one "
        f"checkpoint of the final state ({ckpt_bytes / 1e6:.1f} MB): async save returned in "
        f"{snap_s:.3f} s (the host snapshot), written in {write_s:.3f} s, restored in "
        f"{restore_s:.3f} s; ops without a deterministic form: {nondet or 'none'}; no kernel "
        f"launched [{smi}]")
    del runs, a, b, pa, pb
    return {"restarts": 1, "bit_equal": same, "save_return_s": snap_s, "save_written_s": write_s,
            "restore_s": restore_s, "ckpt_mb": ckpt_bytes / 1e6, "nondeterministic": nondet,
            "launches": launches}


def train_leg_serving_twins(torch, dev, smi: str) -> dict:
    """Leg (g): the ``torch_quickstart`` twin's SSSP (correct against the
    numpy reference) and Δ-PageRank (within ``QUICKSTART_PR_TOL``) on the
    card, then ``torch_serve_lm`` at its defaults."""
    from repro_torch.graph.generators import rmat_graph
    from repro_torch.graph.hub_sort import hub_sort

    qs = example_module("torch_quickstart")
    t = time.monotonic()
    g = rmat_graph(*QUICKSTART_GRAPH, seed=0)
    hs = hub_sort(g)
    cfg = qs.quickstart_config()
    reset_launch_counts()
    res, ok, _ = qs.run_sssp(g, hs, cfg, dev)
    pr, err = qs.run_pagerank(g, hs, cfg, dev)
    launches = read_launch_counts()
    check(ok and err <= QUICKSTART_PR_TOL,
          f"train (g): quickstart SSSP correct={ok}, Δ-PageRank max error {err:.3e} "
          f"(tolerance {QUICKSTART_PR_TOL:g})")
    qs_s = time.monotonic() - t
    serve = example_module("torch_serve_lm")
    t = time.monotonic()
    out = serve.main([])
    serve_s = time.monotonic() - t
    log(f"train (g): torch_quickstart on the card: SSSP {res.iterations} iterations, "
        f"correct, Δ-PageRank {pr.iterations} iterations, max error {err:.2e} (tolerance "
        f"{QUICKSTART_PR_TOL:g}), {qs_s:.1f} s, launches {launches}; torch_serve_lm at its "
        f"defaults: prefill {out['prefill_s'] * 1e3:.1f} ms, decode {out['decode_s'] * 1e3:.1f} "
        f"ms, {serve_s:.1f} s [{smi}]")
    return {"sssp_iterations": res.iterations, "pagerank_err": err, "quickstart_s": qs_s,
            "serve_prefill_s": out["prefill_s"], "serve_decode_s": out["decode_s"],
            "launches": launches}


def phase_train(torch, dev, seed: int, smi: str) -> dict:
    """Phase 18: training on one device, legs (a)-(g); everything the phase
    allocates is freed before it returns."""
    t_phase = time.monotonic()
    legs = {}
    for key, fn in (("a", train_leg_lm), ("b", train_leg_f64), ("c", train_leg_moe),
                    ("d", train_leg_gnn), ("e", train_leg_dlrm), ("f", train_leg_fault)):
        t = time.monotonic()
        legs[key] = fn(torch, dev, seed, smi)
        legs[key]["seconds"] = time.monotonic() - t
        gc.collect()
        torch.cuda.empty_cache()
        log(f"phase 18 leg ({key}) took {legs[key]['seconds']:.1f} s")
    t = time.monotonic()
    legs["g"] = train_leg_serving_twins(torch, dev, smi)
    legs["g"]["seconds"] = time.monotonic() - t
    gc.collect()
    torch.cuda.empty_cache()
    launches = {f"train_{k}": legs[k].pop("launches") for k in TRAIN_LEGS}
    return {"legs": legs, "launches": launches, "phase_s": time.monotonic() - t_phase,
            "card": smi}


# ---------------------------------------------------------------------------
# Phase 19: training past 2048² attention scores and over a model mesh
# ---------------------------------------------------------------------------

BLOCKED_SEQ = 4096            # train_4k's sequence: S = L = 4096 positions
BLOCKED_REPS = 3              # timed fwd+bwd calls a leg (a) row, after 3 warm-ups
# leg (a): the blocked core against a float64 plain copy on the card, of each
# tensor's largest: float32 sums in another order; bf16 adds one rounding of
# each output and gradient (2^-8 of a value at most)
BLOCKED_TOL = {"float32": 1e-4, "bfloat16": 1e-2}
TRAIN4K_ROWS = 2              # leg (b): train_4k's 256 rows cut to 2
TRAIN4K_STEPS = 3             # a warm-up, then 2 timed
MESH_TRAIN_LAYERS = 2         # leg (c): internlm2-1.8b's 24 layers cut to 2
MESH_TRAIN_ROWS = 4
MESH_TRAIN_SEQ = 1025         # 1024 next-token positions a row
MESH_LOSS_TOL = 1e-5          # relative, against the single-device step
MESH_PARAM_TOL = 1e-5         # of each leaf's largest
MESH_TRAIN_TIMEOUT_S = 300.0
MESH_REFERENCE: dict = {}     # leg (c): the single-device step


def blocked_shapes() -> dict:
    """Leg (a)'s rows: name -> (KV heads, query heads a KV head, dh, dv,
    window), from the configs."""
    from repro_torch.configs import deepseek_v2_lite_16b, gemma3_12b, internlm2_1p8b

    i, g, d = internlm2_1p8b.CONFIG, gemma3_12b.CONFIG, deepseek_v2_lite_16b.CONFIG
    local = next(w for w in g.window_pattern if w > 0)
    return {
        "internlm2": (i.n_kv_heads, i.n_heads // i.n_kv_heads, i.d_head, i.d_head, 0),
        "gemma3_local": (g.n_kv_heads, g.n_heads // g.n_kv_heads, g.d_head, g.d_head, local),
        "gemma3_global": (g.n_kv_heads, g.n_heads // g.n_kv_heads, g.d_head, g.d_head, 0),
        "deepseek_mla": (d.n_heads, 1, d.mla.d_nope + d.mla.d_rope, d.mla.d_v, 0),
    }


def blocked_flops(heads: int, dh: int, dv: int, S: int, window: int, forwards: int) -> float:
    """The blocked route's product flops over (S x S) at ``window``, as it
    computes them (the planned block pairs whole): ``forwards`` forward
    passes (QK, PV) and one backward (QK again, dO.V, dQ, dK, dV)."""
    from repro_torch.models import attention as attn

    pairs = sum(len(r) for r in attn.block_plan(0, S, 0, S, S - 1, window))
    per_pair = 2.0 * attn._Q_BLOCK * attn._KV_BLOCK * heads
    return pairs * per_pair * (forwards * (dh + dv) + 3 * dh + 2 * dv)


def blocked_core_leg(torch, dev, seed: int, smi: str) -> dict:
    """Leg (a): ``attention._flash_sdpa`` forward and backward at S = L =
    ``BLOCKED_SEQ``, batch 1, on internlm2-1.8b's heads, gemma3-12b's local
    and global layers and deepseek-v2-lite's MLA, in float32 and bf16,
    against the plain ``S x S`` core (``_sdpa``) in float64 on the same
    inputs; its time and the plain core's in the same dtype."""
    from repro_torch.models import attention as attn

    S = BLOCKED_SEQ
    pos = torch.arange(S, dtype=torch.int32, device=dev)
    gen = torch.Generator(device=dev)
    rows = {}
    reset_launch_counts()
    for name, (KV, G, dh, dv, w) in blocked_shapes().items():
        scale = attn.attention_scale(dh)
        plan = attn.block_plan(0, S, 0, S, S - 1, w)
        mask = attn.attention_mask(pos, pos, None, w)
        gen.manual_seed(seed)
        base = [torch.randn(shape, generator=gen, device=dev) for shape in
                ((1, S, KV, G, dh), (1, S, KV, dh), (1, S, KV, dv), (1, S, KV, G, dv))]
        for dtype in ("float32", "bfloat16"):
            td = getattr(torch, dtype)
            ops = [t.to(td) for t in base]

            def run(fn, *extra, dt=td):
                ts = [t.detach().to(dt).requires_grad_(True) for t in ops[:3]]
                out = fn(*ts, *extra)
                out.backward(ops[3].to(dt))
                return [out.detach()] + [t.grad for t in ts]

            def blocked():
                return run(attn._flash_sdpa, pos, pos, S - 1, w, scale, plan)

            got = blocked()
            want = run(attn._sdpa, mask, scale, dt=torch.float64)
            errs = {what: float((a.double() - b).abs().max()) / float(b.abs().max())
                    for what, a, b in zip(("out", "dq", "dk", "dv"), got, want)}
            del got, want
            ms = call_ms(torch, blocked, reps=BLOCKED_REPS)
            plain_ms = call_ms(torch, lambda: run(attn._sdpa, mask, scale), reps=BLOCKED_REPS)
            flops = blocked_flops(KV * G, dh, dv, S, w, forwards=1)
            row = {"window": w, "heads": KV * G, "kv_heads": KV, "dh": dh, "dv": dv,
                   "pairs": sum(len(r) for r in plan),
                   "of_pairs": -(-S // attn._Q_BLOCK) * -(-S // attn._KV_BLOCK),
                   "errs": errs, "ms": ms, "plain_ms": plain_ms, "tflops": flops / ms / 1e9}
            rows[f"{name}_{dtype}"] = row
            worst = max(errs.values())
            log(f"train 4k (a) {name} {dtype}: q (1, {S}, {KV}, {G}, {dh}), v {dv} wide, window "
                f"{w}: {row['pairs']} of {row['of_pairs']} block pairs; out/dq/dk/dv vs float64 "
                + ", ".join(f"{k} {v:.2e}" for k, v in errs.items())
                + f" of each largest (tolerance {BLOCKED_TOL[dtype]:g}); forward+backward "
                f"{ms:.2f} ms ({row['tflops']:.1f} TFLOP/s of its products) against the plain "
                f"S x S core's {plain_ms:.2f} ms [{smi}]")
            check(worst <= BLOCKED_TOL[dtype], f"train 4k (a) {name} {dtype}: the blocked core "
                  f"is {worst:.3e} of a largest from float64 (tolerance {BLOCKED_TOL[dtype]:g})")
            del ops
        del base, mask
        torch.cuda.empty_cache()
    launches = read_launch_counts()
    check(launches == counts_zero(), f"train 4k (a): launched {launches}")
    return {"rows": rows, "launches": launches}


def train4k_leg(torch, dev, seed: int, smi: str) -> dict:
    """Leg (b): internlm2-1.8b at full width and depth, float32 parameters,
    bf16 activations, remat, ``lm_loss`` at ``BLOCKED_SEQ`` positions
    (train_4k's sequence; above 2048² scores, so attention is blocked)
    through ``make_train_step`` with its AdamW ``OPT`` (warmup cut as in
    phase 18) and 2 microbatches: ``TRAIN4K_STEPS`` steps, the first a
    warm-up; the blocked core's calls counted."""
    from repro_torch.configs.internlm2_1p8b import CONFIG, OPT
    from repro_torch.data.pipeline import LMBatches
    from repro_torch.models import attention as attn
    from repro_torch.models.transformer import init_transformer, lm_loss
    from repro_torch.train import train_step as ts

    cfg = CONFIG.replace(param_dtype="float32", dtype="bfloat16", remat=True)
    opt = OPT.replace(warmup_steps=TRAIN_LM_WARMUP, total_steps=TRAIN4K_STEPS)
    S = BLOCKED_SEQ
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    model = init_transformer(cfg, torch.Generator(device=dev).manual_seed(seed), dev)
    state = ts.init_train_state(model, opt, device=dev)
    n_params = sum(p.numel() for p in model.parameters())
    pipe = LMBatches(vocab=cfg.vocab, batch=TRAIN4K_ROWS, seq_len=S + 1, seed=seed)
    batches = [torch.from_numpy(pipe.make(s)["tokens"]).to(dev) for s in range(TRAIN4K_STEPS)]
    step_fn = ts.make_train_step(lambda m, b: lm_loss(m, b), opt,
                                 microbatches=TRAIN_LM_MICROBATCHES)
    calls = [0]
    real = attn._flash_sdpa

    def counted(*args):
        calls[0] += 1
        return real(*args)

    reset_launch_counts()
    secs, losses = [], []
    attn._flash_sdpa = counted
    try:
        for b in batches:
            torch.cuda.synchronize()
            t = time.monotonic()
            state, m = step_fn(state, b)
            losses.append(float(m["loss"]))
            torch.cuda.synchronize()
            secs.append(time.monotonic() - t)
        step_calls = calls[0]
        with torch.no_grad():
            after = float(lm_loss(model, batches[0]))
    finally:
        attn._flash_sdpa = real
    launches = read_launch_counts()
    peak = torch.cuda.max_memory_allocated()
    want_calls = TRAIN4K_STEPS * TRAIN_LM_MICROBATCHES * cfg.n_layers * (2 if cfg.remat else 1)
    check(step_calls == want_calls, f"train 4k (b): the blocked core ran {step_calls} times in "
          f"{TRAIN4K_STEPS} steps, expected {want_calls}")
    check(launches == counts_zero(), f"train 4k (b): launched {launches}")
    check(all(math.isfinite(v) for v in losses + [after]),
          f"train 4k (b): a loss is not finite: {losses} {after}")
    check(after < losses[0], f"train 4k (b): the first batch's loss did not fall: {losses[0]} -> "
          f"{after} (the steps' losses {losses})")
    step_s = float(np.median(secs[1:]))
    tokens = TRAIN4K_ROWS * S
    model_flops = 6.0 * n_params * tokens
    attn_flops = TRAIN4K_ROWS * cfg.n_layers * blocked_flops(
        cfg.n_heads, cfg.d_head, cfg.d_head, S, 0, forwards=2 if cfg.remat else 1)
    mfu = (model_flops + attn_flops) / step_s / PEAK_FLOPS["bfloat16"]
    log(f"train 4k (b): {cfg.name} at full width and depth ({n_params:,} parameters), "
        f"{TRAIN4K_ROWS} x {S} positions a step (train_4k's 256 rows cut to {TRAIN4K_ROWS}), "
        f"{TRAIN_LM_MICROBATCHES} microbatches, remat, {OPT.name} with warmup "
        f"{opt.warmup_steps}: {step_s:.4f} s a step (median of steps 2-{TRAIN4K_STEPS}; each "
        f"{[round(s, 4) for s in secs]}), {tokens / step_s:,.0f} tokens/s; 6*N*tokens "
        f"{model_flops / 1e12:.2f} TFLOP + the blocked attention's products "
        f"{attn_flops / 1e12:.2f} TFLOP (forward, remat's forward, backward; float32) = "
        f"{mfu:.2%} of 989 TF/s; the blocked core ran {step_calls} times; losses "
        f"{[round(x, 4) for x in losses]}, the first batch's {losses[0]:.4f} -> {after:.4f} "
        f"after the last step; peak allocated {peak / 1e9:.2f} GB; no kernel launched [{smi}]")
    del state, model, batches, step_fn
    return {"n_params": n_params, "step_s": step_s, "step_secs": secs,
            "tokens_per_s": tokens / step_s, "model_tflop": model_flops / 1e12,
            "attention_tflop": attn_flops / 1e12, "mfu_989": mfu, "losses": losses,
            "first_after": after, "blocked_calls": step_calls, "peak_gb": peak / 1e9,
            "launches": launches}


def mesh_train_run(torch, dev, seed: int, mesh=None) -> dict:
    """Leg (c)'s run: internlm2-1.8b at full width cut to
    ``MESH_TRAIN_LAYERS`` layers, float32, AdamW (its ``OPT`` without
    warmup, so the first step moves every parameter), 2 microbatches; on
    ``mesh`` (a ``ModelMesh``) placed by ``lm_rule`` and ``lm_batch_spec``.
    Two steps on two batches: each step's loss, grad norm and seconds, the
    parameters after the first step."""
    from torch.distributed.tensor import distribute_tensor

    from repro_torch.configs.internlm2_1p8b import CONFIG, OPT
    from repro_torch.data.pipeline import LMBatches
    from repro_torch.dist.sharding import (distribute, lm_batch_spec, lm_rule, placements,
                                           tree_shardings)
    from repro_torch.launch.mesh import device_mesh
    from repro_torch.models.transformer import init_transformer, lm_loss
    from repro_torch.train import train_step as ts

    cfg = CONFIG.replace(n_layers=MESH_TRAIN_LAYERS, dtype="float32", param_dtype="float32")
    opt = OPT.replace(warmup_steps=0)
    model = init_transformer(cfg, torch.Generator(device=dev).manual_seed(seed), dev)
    state = ts.init_train_state(model, opt, device=dev)
    pipe = LMBatches(vocab=cfg.vocab, batch=MESH_TRAIN_ROWS, seq_len=MESH_TRAIN_SEQ, seed=seed)
    batches = [torch.from_numpy(pipe.make(s)["tokens"]).to(dev) for s in range(2)]
    if mesh is not None:
        dm = device_mesh(mesh)
        state = distribute(state, dm, tree_shardings(state, mesh, lm_rule(mesh)))
        batches = [distribute_tensor(b, dm, placements(lm_batch_spec(mesh), 2, dm),
                                     src_data_rank=None) for b in batches]
    step = ts.make_train_step(lambda m, b: lm_loss(m, b, mesh=mesh), opt,
                              microbatches=TRAIN_LM_MICROBATCHES)
    sync = torch.cuda.synchronize if dev.type == "cuda" else (lambda: None)
    out = {"secs": [], "losses": [], "norms": [], "leaves": state.leaves}
    for b in batches:
        sync()
        t = time.monotonic()
        state, m = step(state, b)
        sync()
        out["secs"].append(time.monotonic() - t)
        out["losses"].append(float(m["loss"]))
        out["norms"].append(float(m["grad_norm"]))
        if "params" not in out:
            out["params"] = {n: (p.full_tensor() if hasattr(p, "full_tensor") else p)
                             .detach().clone() for n, p in state.params.named_parameters()}
    out["placements"] = {n: str(getattr(p, "placements", "plain"))
                         for n, p in state.params.named_parameters()}
    del state, model, batches
    return out


def mesh_train_compare(torch, run: dict) -> dict:
    """A mesh run against the single-device run in ``MESH_REFERENCE``."""
    ref = MESH_REFERENCE
    err, leaf = leaf_errs(torch, run["leaves"], run["params"], ref["params"])
    loss_err = max(abs(a - b) / abs(b) for a, b in zip(run["losses"] + run["norms"],
                                                        ref["losses"] + ref["norms"]))
    return {"losses": run["losses"], "norms": run["norms"], "loss_err": loss_err,
            "param_err": err, "param_leaf": leaf or "none", "secs": run["secs"]}


def mesh_train_leg(torch, dev, seed: int, smi: str) -> dict:
    """Leg (c): the train step on a (1, 1) NCCL mesh in this process, held
    to the single-device step: the losses and grad norms within
    ``MESH_LOSS_TOL`` relative and every parameter after the first step
    within ``MESH_PARAM_TOL`` of its leaf's largest.  Two gloo ranks
    sharing the card cannot run it: DTensor's collectives on CUDA tensors
    crash gloo (torch 2.11, a segmentation fault in ``wait_tensor`` of the
    first ``all_gather``), so the (2, 1) and (1, 2) meshes run on NCCL
    across cards (``profile_port.py --train-mesh``)."""
    from repro_torch.launch.mesh import RankPool, make_debug_mesh

    reset_launch_counts()
    single = mesh_train_run(torch, dev, seed)
    MESH_REFERENCE.update(losses=single["losses"], norms=single["norms"],
                          params=single["params"])
    out = {"single": {"losses": single["losses"], "norms": single["norms"],
                      "secs": single["secs"]}}
    del single
    card = dev.type == "cuda"
    with RankPool(1, backend="nccl" if card else "gloo", timeout_s=MESH_TRAIN_TIMEOUT_S):
        run = mesh_train_run(torch, dev, seed, make_debug_mesh(1, 1, device=dev))
        r = out["nccl_1x1" if card else "gloo_1x1"] = mesh_train_compare(torch, run)
        r["wq"] = run["placements"]["layers.0.attn.wq"]
        del run
    launches = read_launch_counts()
    MESH_REFERENCE.clear()
    check(launches == counts_zero(), f"train 4k (c): launched {launches}")
    log(f"train 4k (c) (1, 1) mesh: losses {r['losses']} and grad norms {r['norms']} (within "
        f"{r['loss_err']:.2e} relative of the single device's {out['single']['losses']} and "
        f"{out['single']['norms']}; tolerance {MESH_LOSS_TOL:g}), the parameters after the "
        f"first step within {r['param_err']:.2e} of leaf {r['param_leaf']}'s largest "
        f"(tolerance {MESH_PARAM_TOL:g}); wq placed {r['wq']}; steps "
        f"{[round(x, 4) for x in r['secs']]} s (single device "
        f"{[round(x, 4) for x in out['single']['secs']]}) [{smi}]")
    check(r["loss_err"] <= MESH_LOSS_TOL and r["param_err"] <= MESH_PARAM_TOL,
          f"train 4k (c): the mesh step is off the single-device step: {r}")
    out["launches"] = launches
    return out


# leg (d): the dry run of leg (c)'s step on a fake (1, 1) mesh, in a CPU
# subprocess (the fake process group cannot share a process with NCCL)
MOE_DRYRUN = """
import json, sys
from torch._subclasses.fake_tensor import FakeTensorMode
from repro_torch.configs.common import lm_train_cell
from repro_torch.configs.deepseek_v2_lite_16b import CONFIG, OPT
from repro_torch.launch import dryrun
from repro_torch.launch.mesh import device_mesh, make_debug_mesh

spec = json.loads(sys.argv[1])
cfg = CONFIG.replace(n_layers=spec["layers"], dtype="float32", param_dtype="float32")
opt = OPT.replace(warmup_steps=1, total_steps=spec["steps"])
dryrun.fake_process_group(1)
mesh = make_debug_mesh(1, 1, device="cpu")
dm = device_mesh(mesh)
build = lm_train_cell(cfg, opt, spec["batch"], spec["seq"])(mesh)
with FakeTensorMode(allow_non_fake_inputs=True):
    rec = dryrun.measure(build, dm)
print(json.dumps(rec))
"""
MOE_MESH_TOL = 1e-6           # relative, if leg (d) is not bit-equal to leg (c)
MOE_DRYRUN_TIMEOUT_S = 240.0


def start_moe_dryrun() -> tuple:
    """Leg (d)'s dry run, started in a CPU subprocess (at the start of phase
    19, so that it runs beside legs (a)-(c)): (the process, its start)."""
    spec = {"layers": TRAIN_MOE_LAYERS, "steps": TRAIN_MOE_STEPS, "batch": TRAIN_MOE_BATCH,
            "seq": TRAIN_MOE_SEQ}
    env = {**os.environ, "CUDA_VISIBLE_DEVICES": "",
           "PYTHONPATH": os.pathsep.join([str(ROOT / "src"), os.environ.get("PYTHONPATH", "")])}
    return (subprocess.Popen([sys.executable, "-c", MOE_DRYRUN, json.dumps(spec)],
                             stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True, env=env),
            time.monotonic())


def mesh_moe_leg(torch, dev, seed: int, smi: str, dryrun: tuple | None = None) -> dict:
    """Leg (d): phase 18 leg (c)'s deepseek-v2-lite run on a (1, 1) NCCL
    mesh in this process through ``lm_loss(mesh=)``, held bit-equal to leg
    (c)'s losses, grad norms and final parameters (``MOE_REFERENCE``), or
    within ``MOE_MESH_TOL`` relative with the first differing value named;
    the exchanges timed; the dry run's prediction (``dryrun``, from
    ``start_moe_dryrun``; started here if not given) read beside it."""
    from torch.distributed.tensor import distribute_tensor

    from repro_torch.configs.deepseek_v2_lite_16b import CONFIG, OPT
    from repro_torch.data.pipeline import LMBatches
    from repro_torch.dist.sharding import (distribute, lm_batch_spec, lm_rule, placements,
                                           tree_shardings)
    from repro_torch.launch.dryrun import local_leaves, storage_bytes
    from repro_torch.launch.mesh import RankPool, device_mesh, make_debug_mesh
    from repro_torch.models.moe import ExchangeTimer
    from repro_torch.models.transformer import init_transformer, lm_loss
    from repro_torch.train import train_step as ts

    ref = dict(MOE_REFERENCE)
    MOE_REFERENCE.clear()
    check(bool(ref), "train 4k (d): phase 18 leg (c) left no reference")
    dry, t_dry = dryrun or start_moe_dryrun()
    try:
        cfg = CONFIG.replace(n_layers=TRAIN_MOE_LAYERS, dtype="float32", param_dtype="float32")
        opt = OPT.replace(warmup_steps=1, total_steps=TRAIN_MOE_STEPS)
        reset_launch_counts()
        with RankPool(1, backend="nccl", timeout_s=MESH_TRAIN_TIMEOUT_S):
            mesh = make_debug_mesh(1, 1, device=dev)
            dm = device_mesh(mesh)
            model = init_transformer(cfg, torch.Generator(device=dev).manual_seed(seed + 2), dev)
            state = ts.init_train_state(model, opt, device=dev)
            state = distribute(state, dm, tree_shardings(state, mesh, lm_rule(mesh)))
            del model
            pipe = LMBatches(vocab=cfg.vocab, batch=TRAIN_MOE_BATCH, seq_len=TRAIN_MOE_SEQ,
                             seed=seed)
            batches = [distribute_tensor(torch.from_numpy(pipe.make(s)["tokens"]).to(dev), dm,
                                         placements(lm_batch_spec(mesh), 2, dm),
                                         src_data_rank=None) for s in range(TRAIN_MOE_STEPS)]
            state_bytes = storage_bytes(local_leaves(state))[0]
            batch_bytes = storage_bytes(local_leaves(batches[0]))[0]
            step_fn = ts.make_train_step(lambda m, b: lm_loss(m, b, mesh=mesh), opt)
            torch.cuda.reset_peak_memory_stats()
            losses, norms, secs = [], [], []
            timer = ExchangeTimer()
            for i, b in enumerate(batches):
                # the first step (NCCL's set-up) untimed by the exchange timer
                with timer if i else contextlib.nullcontext():
                    torch.cuda.synchronize()
                    t = time.monotonic()
                    state, m = step_fn(state, b)
                    losses.append(float(m["loss"]))
                    norms.append(float(m["grad_norm"]))
                    secs.append(time.monotonic() - t)
            exchanges = timer.summary()
            peak = torch.cuda.max_memory_allocated()
            params = {n: p.full_tensor().detach().to("cpu")
                      for n, p in state.params.named_parameters()}
            del state, batches, step_fn
        launches = read_launch_counts()
        out, err = dry.communicate(timeout=max(1.0, MOE_DRYRUN_TIMEOUT_S
                                               - (time.monotonic() - t_dry)))
    finally:
        if dry.poll() is None:
            dry.kill()
            dry.communicate()
    check(dry.returncode == 0, f"train 4k (d): the dry run failed:\n{err[-3000:]}")
    pred = json.loads(out.strip().splitlines()[-1])
    dry_s = time.monotonic() - t_dry
    equal = (losses == ref["losses"] and norms == ref["norms"]
             and all(torch.equal(params[n], ref["params"][n]) for n in ref["params"]))
    worst, where = 0.0, "none"
    for n, want in ref["params"].items():
        e = float((params[n].double() - want.double()).abs().max()) / max(
            float(want.abs().max()), 1e-30)
        if e > worst:
            worst, where = e, n
    metric_err = max(abs(a - b) / abs(b) for a, b in zip(losses + norms,
                                                        ref["losses"] + ref["norms"]))
    del ref["params"], params
    check(launches == counts_zero(), f"train 4k (d): launched {launches}")
    check(equal or (metric_err <= MOE_MESH_TOL and worst <= MOE_MESH_TOL),
          f"train 4k (d): the (1, 1) mesh run is off leg (c)'s: losses {losses} vs "
          f"{ref['losses']}, norms {norms} vs {ref['norms']}, parameters {worst:.2e} ({where})")
    arg_bytes = state_bytes + batch_bytes
    mem = pred["memory"]
    check(mem["argument_bytes"] == arg_bytes,
          f"train 4k (d): the dry run's argument bytes {mem['argument_bytes']:,} != the card's "
          f"state and batch {arg_bytes:,}")
    step_s = float(np.median(secs[1:]))
    ms = {k: round(v["ms"], 3) for k, v in exchanges.items()}
    log(f"train 4k (d) (1, 1) mesh, MoE: {cfg.name} at full width, {cfg.n_layers} layers, "
        f"float32, phase 18 leg (c)'s {TRAIN_MOE_STEPS} steps through moe_ffn_placed: "
        f"{'bit-equal to' if equal else f'within {max(metric_err, worst):.2e} of'} leg (c)'s "
        f"losses {losses}, grad norms {[round(x, 6) for x in norms]} and parameters; "
        f"{step_s:.4f} s a step (median of steps 2-{TRAIN_MOE_STEPS}; each "
        f"{[round(x, 4) for x in secs]}; leg (c)'s one device "
        f"{[round(x, 4) for x in ref.get('secs', [])]}), peak allocated {peak / 1e9:.2f} GB; "
        f"exchanges' device ms by kind over steps 2-{TRAIN_MOE_STEPS} {ms} (calls "
        f"{ {k: v['calls'] for k, v in exchanges.items()} }); the dry run (fake (1, 1) mesh, a "
        f"CPU subprocess started {dry_s:.1f} s before its reading): argument bytes {mem['argument_bytes']:,} = the "
        f"card's state {state_bytes:,} + batch {batch_bytes:,}, peak "
        f"{mem['peak_device_bytes'] / 1e9:.2f} GB against the card's {peak / 1e9:.2f} GB, "
        f"{pred['cost']['flops'] / 1e12:.2f} TFLOP, collectives "
        f"{ {k: v['count'] for k, v in pred['collectives'].items()} }; no kernel launched [{smi}]")
    return {"losses": losses, "norms": norms, "bit_equal": equal, "metric_err": metric_err,
            "param_err": worst, "param_leaf": where, "step_secs": secs, "step_s": step_s,
            "peak_gb": peak / 1e9, "exchanges": exchanges, "state_bytes": state_bytes,
            "batch_bytes": batch_bytes, "dryrun": {"memory": mem, "cost": pred["cost"],
                                                   "collectives": pred["collectives"],
                                                   "run_s": pred["run_s"], "wall_s": dry_s},
            "launches": launches}


def phase_train_blocked(torch, dev, seed: int, smi: str) -> dict:
    """Phase 19: training past 2048² attention scores and over a model mesh,
    legs (a)-(d); everything the phase allocates is freed before it
    returns."""
    t_phase = time.monotonic()
    legs = {}
    moe_dryrun = start_moe_dryrun()
    for key, fn in (("a", blocked_core_leg), ("b", train4k_leg), ("c", mesh_train_leg),
                    ("d", functools.partial(mesh_moe_leg, dryrun=moe_dryrun))):
        t = time.monotonic()
        legs[key] = fn(torch, dev, seed, smi)
        legs[key]["seconds"] = time.monotonic() - t
        gc.collect()
        torch.cuda.empty_cache()
        log(f"phase 19 leg ({key}) took {legs[key]['seconds']:.1f} s")
    launches = {f"train4k_{k}": legs[k].pop("launches") for k in legs}
    return {"legs": legs, "launches": launches, "phase_s": time.monotonic() - t_phase,
            "card": smi}


# ---------------------------------------------------------------------------
# Phase 9: DLRM serving, dlrm-mlperf at full width with the one-card row cap
# ---------------------------------------------------------------------------

DLRM_BATCHES = 10
# working memory of a serve_bulk forward beside the tables: the 26 bags and
# the stacked (B, 27, 128) features (7.2 GB together), the interaction, the
# 1024-wide top activations and the traffic of 11 batches
DLRM_WORK_BYTES = 10e9
# the legs: name -> (use_kernels, table engine, embedding_bag launches a
# forward by cell); the engine picks of the reference's cost model give 18
# gather tables at B = 512 and 8 gather + 10 dedup at B = 262,144
DLRM_LEGS = {
    "kernel": ("auto", "auto", {"serve_p99": 18, "serve_bulk": 18}),
    "plain": (False, "auto", {"serve_p99": 0, "serve_bulk": 0}),
    "all_gather": ("auto", "gather", {"serve_p99": 26, "serve_bulk": 26}),
    "plain_all_gather": (False, "gather", {"serve_p99": 0, "serve_bulk": 0}),
}


def dlrm_flops(cfg) -> float:
    """Flops of one sample's forward, as the reference's cell counts them:
    the two towers, the bag reduce and the interaction."""
    dims = [cfg.n_dense, *cfg.bot_mlp]
    f = sum(2 * dims[i] * dims[i + 1] for i in range(len(dims) - 1))
    f += cfg.n_sparse * cfg.multi_hot * cfg.embed_dim
    nf = cfg.n_sparse + 1
    f += 2 * nf * nf * cfg.embed_dim
    dims = [cfg.embed_dim + cfg.n_interact_features, *cfg.top_mlp]
    return f + sum(2 * dims[i] * dims[i + 1] for i in range(len(dims) - 1))


def dlrm_bound(cfg, batch: int) -> dict:
    """The least time the card could take for one forward: its flops at the
    float32 peak (the MLPs run in float32, TF32 off) against one read of
    the looked-up rows, the ids and the dense features at 3.35 TB/s."""
    flops = dlrm_flops(cfg) * batch
    n_bytes = batch * (cfg.n_sparse * cfg.embed_dim * 4 + cfg.n_sparse * 4 + cfg.n_dense * 4)
    t_ops, t_bytes = flops / PEAK_FLOPS["float32"] * 1e3, bound_ms(n_bytes)
    return {"tflop": flops / 1e12, "gb": n_bytes / 1e9, "ops_ms": t_ops, "bytes_ms": t_bytes,
            "ms": max(t_ops, t_bytes), "by": "operations" if t_ops >= t_bytes else "bytes"}


def phase_dlrm_small(torch, dev, seed: int) -> None:
    """The reduced dlrm-mlperf config (float32) on the card against the same
    weights and traffic on the CPU, whose path the CPU tests hold against
    the reference, for the reference's engine picks (all one-hot here) and
    forced gather and dedup: logits within 1e-4 (float32 products summed in
    another order)."""
    from repro_torch.launch.serve import dlrm_serve_config, dlrm_traffic
    from repro_torch.models.dlrm import dlrm_forward, init_dlrm

    cfg = dlrm_serve_config(reduced=True)
    model = init_dlrm(cfg, torch.Generator().manual_seed(seed), "cpu")
    dense, sparse = dlrm_traffic(cfg, 512, torch.Generator().manual_seed(seed + 1))
    engines = {"auto": 0, "gather": cfg.n_sparse, "dedup": cfg.n_sparse}
    cpu = {e: dlrm_forward(model, dense, sparse, cfg.replace(table_engine=e)) for e in engines}
    model.to(dev)
    errs = {}
    for engine, want_launches in engines.items():
        reset_launch_counts()
        card = dlrm_forward(model, dense.to(dev), sparse.to(dev), cfg.replace(table_engine=engine))
        counts = read_launch_counts()
        check(counts == {**counts_zero(), "embedding_bag": want_launches},
              f"reduced DLRM ({engine}) launched {counts}")
        errs[engine] = err = float((card.cpu() - cpu[engine]).abs().max())
        check(card.shape == (512,) and err <= 1e-4,
              f"reduced DLRM ({engine}) on the card != on the CPU (max |err| {err:.3g})")
    log(f"DLRM (reduced dlrm-mlperf, float32): card == CPU within {errs} for 512 samples")


def phase_dlrm(torch, dev, seed: int, smi: str) -> dict:
    """dlrm-mlperf at full width, every table capped at 25M rows, random
    weights from ``seed``: the serving cells through
    ``launch.serve.serve_dlrm`` in the four legs of ``DLRM_LEGS``, then
    retrieval_cand."""
    from repro_torch.configs.dlrm_mlperf import CELLS, ONE_CARD_MAX_ROWS
    from repro_torch.kernels.embedding_bag.ops import embedding_bag
    from repro_torch.kernels.embedding_bag.ref import embedding_bag_ref
    from repro_torch.launch.serve import dlrm_serve_config, serve_dlrm
    from repro_torch.models.common import mlp_apply
    from repro_torch.models.dlrm import init_dlrm

    phase_dlrm_small(torch, dev, seed)
    cfg = dlrm_serve_config(reduced=False)
    n_rows = sum(cfg.vocab_sizes)
    table_bytes = n_rows * cfg.embed_dim * 4
    free, total = torch.cuda.mem_get_info()
    log(f"DLRM: card memory free {free / 1e9:.2f} of {total / 1e9:.2f} GB; the tables need "
        f"{table_bytes / 1e9:.2f} GB and a serve_bulk forward about {DLRM_WORK_BYTES / 1e9:.0f} "
        f"GB more")
    check(free >= table_bytes + DLRM_WORK_BYTES, "not enough free card memory for dlrm-mlperf")
    t = time.monotonic()
    gen = torch.Generator(device=dev)
    gen.manual_seed(seed)
    model = init_dlrm(cfg, gen, dev)
    torch.cuda.synchronize()
    table_params = sum(t_.numel() for t_ in model.tables)
    mlp_params = sum(p.numel() for p in model.parameters()) - table_params
    check(n_rows == 129_066_304 and table_params == 16_520_486_912,
          f"dlrm-mlperf capped: {n_rows:,} rows, {table_params:,} table parameters")
    check(max(cfg.vocab_sizes) == ONE_CARD_MAX_ROWS, "the row cap is not applied")
    log(f"DLRM: dlrm-mlperf full width, {n_rows:,} table rows (capped at {ONE_CARD_MAX_ROWS:,} "
        f"a table), {table_params:,} table + {mlp_params:,} MLP parameters in float32 "
        f"({4 * (table_params + mlp_params) / 1e9:.2f} GB), initialised in "
        f"{time.monotonic() - t:.1f} s")

    # 64-bit row offsets: a capped table's last rows (id * 128 > 2^31 from
    # row 16,777,216), one-hot and in a bag of three with a wrapped id
    big = model.tables[0]
    V = big.shape[0]
    check(V == ONE_CARD_MAX_ROWS, f"table 0 has {V:,} rows")
    for ids in ([[V - 1], [V - 2], [2**24], [2**24 - 1], [-1], [0]],
                [[V - 1, V - 3, -2], [2**24, V - 1, 5]]):
        ids = torch.tensor(ids, dtype=torch.int32, device=dev)
        got = embedding_bag(big, ids, "sum")
        bag_err(torch, "rows_past_2^31", got, embedding_bag_ref(big, ids, "sum"), 1e-6, 3e-6)
    last = embedding_bag(big, torch.tensor([[V - 1]], dtype=torch.int64, device=dev), "sum")
    check(torch.equal(last[0], big[V - 1]), "embedding_bag: table 0's last row not read exactly")
    log(f"DLRM: embedding_bag reads rows past 2^31 elements of a {V:,}-row table exactly")

    cells = {}
    for cell in ("serve_p99", "serve_bulk"):
        batch = CELLS[cell]["batch"]
        bound = dlrm_bound(cfg, batch)
        legs = {}
        for leg, (use, engine, per_forward) in DLRM_LEGS.items():
            reset_launch_counts()
            torch.cuda.reset_peak_memory_stats()
            out = serve_dlrm(model, cell, DLRM_BATCHES, use_kernels=use,
                             cfg=cfg.replace(table_engine=engine), seed=seed + 1)
            counts = read_launch_counts()
            n = per_forward[cell]
            check(out["launches_first"] == n and out["launches"] == n * (DLRM_BATCHES + 1)
                  and counts == {**counts_zero(), "embedding_bag": out["launches"]},
                  f"DLRM {cell} {leg}: launches {counts}, {out['launches_first']} in the first "
                  f"forward (expected {n} a forward)")
            logits = out["output"]
            check(logits.shape == (batch,) and bool(torch.isfinite(logits).all()),
                  f"DLRM {cell} {leg}: logits not finite or misshapen")
            legs[leg] = r = {"ms_per_batch": out["ms_per_batch"],
                             "samples_per_s": out["samples_per_s"],
                             "batch_ms": out["batch_ms"],
                             "peak_gb": torch.cuda.max_memory_allocated() / 1e9,
                             "launches_per_forward": n, "launches": out["launches"],
                             "logits": logits}
            log(f"DLRM {cell} (B={batch}) {leg}: {r['ms_per_batch']:.3f} ms/batch (median of "
                f"{DLRM_BATCHES}), {r['samples_per_s']:.0f} samples/s, peak memory "
                f"{r['peak_gb']:.2f} GB, embedding_bag launches {n} a forward "
                f"({out['launches']} in the leg) [{smi}]")
        for a, b in (("kernel", "plain"), ("all_gather", "plain_all_gather")):
            check(torch.equal(legs[a]["logits"], legs[b]["logits"]),
                  f"DLRM {cell}: {a} logits != {b} logits")
        same = torch.equal(legs["kernel"]["logits"], legs["all_gather"]["logits"])
        log(f"DLRM {cell}: kernel == plain and all_gather == plain_all_gather bit for bit; "
            f"engine picks == all gather bit for bit: {same}; logit spread "
            f"{float(legs['kernel']['logits'].std()):.4f}; bound {bound['ms']:.4f} ms "
            f"({bound['tflop']:.4f} TFLOP at 67 TF/s: {bound['ops_ms']:.4f} ms; "
            f"{bound['gb']:.3f} GB of rows, ids and features at 3.35 TB/s: "
            f"{bound['bytes_ms']:.4f} ms)")
        for r in legs.values():
            del r["logits"]
        cells[cell] = {"batch": batch, "legs": legs, "bound": bound,
                       "picks_equal_all_gather": same}

    spec = CELLS["retrieval_cand"]
    reset_launch_counts()
    out = serve_dlrm(model, "retrieval_cand", DLRM_BATCHES, seed=seed + 2)
    check(read_launch_counts() == counts_zero(), "retrieval_cand launched a kernel")
    scores, ids = out["output"]
    query, cands = out["first_input"], out["candidates"]
    with torch.inference_mode():
        full = mlp_apply(model.bot, query, act=torch.relu, final_act=torch.relu) @ cands.T
    plain = torch.sort(full, dim=-1, descending=True, stable=True)
    k = spec["top_k"]
    check(scores.shape == (1, k) and bool((scores[:, :-1] >= scores[:, 1:]).all()),
          "retrieval_cand: scores not sorted or misshapen")
    check(torch.equal(ids, plain.indices[:, :k]) and torch.equal(scores, plain.values[:, :k]),
          "retrieval_cand: top ids differ from a plain recomputation")
    r_bound = bound_ms(spec["n_candidates"] * cfg.embed_dim * 4)
    log(f"DLRM retrieval_cand: 1 query x {spec['n_candidates']:,} candidates, top {k}: "
        f"{out['ms_per_batch']:.3f} ms/query (median of {DLRM_BATCHES}); ids and scores == a "
        f"full sort; bound {r_bound:.4f} ms (candidates read once at 3.35 TB/s) [{smi}]")
    cells["retrieval_cand"] = {"ms_per_query": out["ms_per_batch"], "bound_ms": r_bound,
                               "batch_ms": out["batch_ms"]}
    del model, big, out, cands, full, plain
    torch.cuda.empty_cache()
    return {"rows": n_rows, "table_params": table_params, "mlp_params": mlp_params,
            "table_gb": table_bytes / 1e9, "cells": cells, "card": smi}


def card_line() -> str:
    """The card's name and power limit, as nvidia-smi gives them."""
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True).stdout.strip().splitlines()[0]


def setup(torch, scale: int, src: Path = ROOT / "src", graph_file: Path | None = None):
    """Build the kernels and the main path's graph and runtime on the card:
    (config, hub-sorted graph, source vertex, runtime).  ``src`` holds the
    ``repro_torch`` that runs; with ``graph_file``, the hub-sorted graph is
    read from it if it exists and written to it otherwise."""
    sys.path.insert(0, str(src))
    from repro_torch.core.constants import PCIE3
    from repro_torch.core.hytm import HyTMConfig, build_runtime
    from repro_torch.graph.generators import rmat_graph
    from repro_torch.graph.hub_sort import hub_sort
    from repro_torch.kernels.runtime import build_dir, build_kernels

    # float32 products in full float32 (TF32 off), stated for both routes
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    t = time.monotonic()
    build_kernels()
    log(f"kernels built in {time.monotonic() - t:.1f} s into {os.path.relpath(build_dir(), ROOT)}")
    t = time.monotonic()
    on_card = {"device": "cuda"} if "device" in inspect.signature(rmat_graph).parameters else {}
    if graph_file is not None and graph_file.exists():
        with open(graph_file, "rb") as f:
            hs = pickle.load(f)
    else:
        # drawn on the host, its levels and sorts on the card (the same graph;
        # a tree older than the ``device`` argument builds it on the host)
        hs = hub_sort(rmat_graph(2**scale, 16 * 2**scale, seed=SEED, **on_card), **on_card)
        if graph_file is not None:
            graph_file.parent.mkdir(parents=True, exist_ok=True)
            with open(graph_file, "wb") as f:
                pickle.dump(hs, f, protocol=pickle.HIGHEST_PROTOCOL)
    cfg = HyTMConfig(link=PCIE3.with_(mr=4.0), n_partitions=64)
    rt = build_runtime(hs.graph, cfg, n_hubs=hs.n_hubs)
    torch.cuda.synchronize()
    setup_s = time.monotonic() - t
    where = "on the host"
    if on_card:
        # the card's build of a scale-16 graph against the CPU's, array for array
        small = rmat_graph(2**16, 2**20, seed=SEED)
        pairs = ((small, rmat_graph(2**16, 2**20, seed=SEED, **on_card)),
                 (hub_sort(small).graph, hub_sort(small, **on_card).graph))
        check(all(np.array_equal(getattr(a, k), getattr(b, k)) for a, b in pairs
                  for k in ("indptr", "indices", "weights")),
              "the card's RMAT graph or hub sort differs from the CPU's at scale 16")
        where = "levels and sorts on the card; its scale-16 graph and hub sort == the CPU's"
    log(f"graph: RMAT scale {scale}: {hs.graph.n_nodes:,} vertices, {hs.graph.n_edges:,} edges, "
        f"hub-sorted, 64 partitions, block {rt.parts.block_size:,} edges; set-up "
        f"{setup_s:.1f} s ({where})")
    return cfg, hs, int(hs.perm[0]), rt


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--scale", type=int, default=22,
                    help="RMAT scale: 2**scale vertices, 16 * 2**scale edges")
    args = ap.parse_args()

    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 1

    # -- phase 1: environment, build, set-up
    smi = card_line()
    log(f"card: {smi}; torch {torch.__version__}, CUDA {torch.version.cuda}, "
        f"{torch.cuda.device_count()} device(s)")
    cfg, hs, source, rt = setup(torch, args.scale)
    from repro_torch.core.hytm import build_runtime

    rt_cpu = build_runtime(hs.graph, cfg, n_hubs=hs.n_hubs, device="cpu")
    rows = phase_kernels(torch, rt, SEED)
    ptxas = ptxas_report()
    resources = kernel_resources()
    flash_rows = phase_flash(torch, rt.device, SEED)
    gmm_rows = phase_grouped_matmul(torch, rt.device, SEED)
    bag_rows = phase_embedding_bag(torch, rt.device, SEED)
    phase_cost_model(torch, cfg, rt, rt_cpu, source, SEED)
    del rt_cpu
    launches, main_runs = phase_main(torch, cfg, rt, source)
    turns = phase_turns(rt, main_path_legs(cfg, source), launches)
    phase_graph_profiles(torch, rt, main_path_legs(cfg, source), rows, turns)
    phase_oracle(torch, rt.device)
    stream = phase_stream(torch, cfg, hs, rt, source, main_runs, turns, smi)
    launches.update(stream.pop("launches"))
    t = time.monotonic()
    serve, lane_rows = phase_serve(torch, cfg, hs, rt, smi)
    serve["phase_s"] = time.monotonic() - t
    serve_launches = serve.pop("launches")
    log(f"phase 11 (graph serving) took {serve['phase_s']:.1f} s")
    t = time.monotonic()
    calib, calib_launches, calib_serve = phase_calibrate(torch, cfg, hs, rt, source, smi)
    calib["phase_s"] = time.monotonic() - t
    launches.update(calib_launches)
    serve_launches.update(calib_serve)
    log(f"phase 12 (calibration and observability) took {calib['phase_s']:.1f} s")
    t = time.monotonic()
    resil = phase_resilience(torch, cfg, hs, rt, source, main_runs, smi)
    resil["phase_s"] = time.monotonic() - t
    serve_launches.update(resil.pop("launches"))
    log(f"phase 13 (resilience) took {resil['phase_s']:.1f} s")
    t = time.monotonic()
    sharded = phase_sharded(torch, cfg, hs, rt, source, smi)
    sharded["phase_s"] = time.monotonic() - t
    launches.update(sharded.pop("launches"))
    log(f"phase 14 (sharded sweep) took {sharded['phase_s']:.1f} s")
    t = time.monotonic()
    mesh_stream = phase_stream_sharded(torch, cfg, hs, rt, source, stream, smi)
    mesh_stream["phase_s"] = time.monotonic() - t
    launches.update(mesh_stream.pop("launches"))
    serve_launches.update(mesh_stream.pop("serve_launches"))
    log(f"phase 15 (sharded stream and serving) took {mesh_stream['phase_s']:.1f} s")
    del main_runs
    dev = rt.device
    del rt, hs
    torch.cuda.empty_cache()
    phase_lm_small(torch, dev, SEED)
    lm = phase_lm(torch, dev, SEED)
    moe, kept = phase_moe(torch, dev, SEED, smi)
    models_mesh = phase_models_mesh(torch, dev, SEED, smi, kept)
    mesh_launches = models_mesh.pop("launches")
    log(f"phase 16 (models over a mesh) took {models_mesh['phase_s']:.1f} s: leg (h) "
        f"{models_mesh['h']['seconds']:.1f} s, (i) {models_mesh['i']['seconds']:.1f} s, (j) "
        f"{models_mesh['j']['seconds']:.1f} s; launches by leg and rank {mesh_launches}")
    del kept
    gc.collect()
    torch.cuda.empty_cache()
    gnn = phase_gnn(torch, dev, SEED, smi)
    log(f"phase 17 (the GNN side) took {gnn['phase_s']:.1f} s [{smi}]")
    del gnn
    gc.collect()
    torch.cuda.empty_cache()
    train = phase_train(torch, dev, SEED, smi)
    train_launches = train.pop("launches")
    launches.update(train_launches)
    log(f"phase 18 (training on one device) took {train['phase_s']:.1f} s; launches by leg "
        f"{train_launches} [{smi}]")
    gc.collect()
    torch.cuda.empty_cache()
    blocked = phase_train_blocked(torch, dev, SEED, smi)
    blocked_launches = blocked.pop("launches")
    launches.update(blocked_launches)
    train_launches.update(blocked_launches)
    log(f"phase 19 (training past 2048² scores and over a model mesh) took "
        f"{blocked['phase_s']:.1f} s; launches by leg {blocked_launches} [{smi}]")
    gc.collect()
    torch.cuda.empty_cache()
    dlrm = phase_dlrm(torch, dev, SEED, smi)

    kernels = []
    for name in ALL_KERNELS:
        r = rows[name]
        # each leg's count, read after that leg alone; a serving leg counts
        # the kernel's solo wrapper and its lane entry
        by_leg = {leg: counts[name] for leg, counts in launches.items()}
        entry = LANE_ENTRIES[name]
        by_leg.update({leg: c[name] + (c[entry] if entry != name else 0)
                       for leg, c in serve_launches.items()})
        lane_legs = {leg: serve_launches[leg][entry]
                     for leg in serve["lane_legs"] + resil["lane_legs"]
                     + mesh_stream["lane_legs"]}
        kernels.append({
            "name": name, "route": "cuda", "source": r["source"],
            "replaces": r["replaces"],
            "launches": sum(by_leg.values()),
            "launches_by_leg": by_leg,
            **{key: r[key] for key in ("max_abs_err", "ms", "cold_ms", "plain_ms", "bound_ms",
                                       "bound_by", "library_ms", "shape", "call_ms", "host_us",
                                       "host_us_after_profiler", "split_us")},
            "lanes": {"entry": entry, "launches": sum(lane_legs.values()),
                      "launches_by_leg": lane_legs, **lane_rows[name]},
        })
    kernels[0]["graph_legs"] = turns
    kernels[0]["dynamic_graph"] = stream
    kernels[0]["graph_serving"] = serve
    kernels[0]["calibration_observability"] = calib
    kernels[0]["resilience"] = resil
    kernels[0]["sharded"] = sharded
    kernels[0]["stream_sharded"] = mesh_stream
    kernels[0]["training"] = train
    kernels[0]["training_blocked_mesh"] = blocked
    for key, row in (("sum_d2", "segment_spmm_sum"), ("last_partition", "segment_spmm_last"),
                     ("sum_d2_last_partition", "segment_spmm_sum_last")):
        kernels[0][key] = {k: rows[row][k] for k in ("shape", "ms", "cold_ms", "call_ms",
                                                     "host_us", "host_us_after_profiler",
                                                     "split_us", "plain_ms",
                                                     "library_ms", "bound_ms", "max_abs_err")}
    kernels[0]["ptxas"] = ptxas["segment_spmm"]
    kernels[1]["ptxas"] = ptxas["frontier_compact"]
    # the main row is gemma3-12b's local layer (40 of its 48); every row follows
    f = flash_rows["gemma3_local"]
    flash_legs = {"lm_prefill": lm["kernel"]["launches"]["prefill"],
                  "lm_decode": lm["kernel"]["launches"]["decode"],
                  "lm_plain": sum(lm["plain"]["launches"].values()),
                  **{f"moe_{phase}": moe["kernel"]["launches"][phase]["flash_attention"]
                     for phase in ("prefill", "decode")},
                  "moe_plain": sum(c["flash_attention"] for c in moe["plain"]["launches"].values()),
                  **{f"mesh_{leg}": c["flash_attention"] for leg, c in mesh_launches.items()},
                  **{leg: c["flash_attention"] for leg, c in train_launches.items()}}
    kernels.append({
        "name": "flash_attention", "route": "cuda",
        "source": "src/repro_torch/kernels/flash_attention/csrc/flash_attention.cu",
        "replaces": "src/repro/kernels/flash_attention/flash_attention.py:76",
        "launches": sum(flash_legs.values()), "launches_by_leg": flash_legs,
        **{key: f[key] for key in ("max_abs_err", "ms", "plain_ms", "bound_ms", "bound_by",
                                   "library_ms", "shape", "call_ms")},
        "rows": flash_rows, "lm_serving": lm,
        "resources": {k: r for k, r in resources.items() if k.startswith("flash")},
    })
    # the main row is the prefill's gate/up launch (52 of a prefill's 78)
    g = gmm_rows["prefill_gate_up"]
    gmm_legs = {**{f"moe_{phase}": moe["kernel"]["launches"][phase]["grouped_matmul"]
                   for phase in ("prefill", "decode")},
                "moe_plain": sum(c["grouped_matmul"] for c in moe["plain"]["launches"].values()),
                **{f"mesh_{leg}": c["grouped_matmul"] for leg, c in mesh_launches.items()},
                **{leg: c["grouped_matmul"] for leg, c in train_launches.items()}}
    kernels.append({
        "name": "grouped_matmul", "route": "cuda",
        "source": "src/repro_torch/kernels/grouped_matmul/csrc/grouped_matmul.cu",
        "replaces": "src/repro/kernels/grouped_matmul/grouped_matmul.py:52",
        "launches": sum(gmm_legs.values()), "launches_by_leg": gmm_legs,
        **{key: g[key] for key in ("max_abs_err", "ms", "plain_ms", "bound_ms", "bound_by",
                                   "library_ms", "library", "shape", "call_ms")},
        "rows": gmm_rows, "moe_serving": moe, "models_mesh": models_mesh,
        "resources": {k: r for k, r in resources.items() if k.startswith("grouped")},
    })
    # the main row is the bulk cell's field shape; the launches are the
    # kernel legs' (the engine picks' and the forced-gather legs')
    b = bag_rows["bulk"]
    kernel_legs = {f"{cell}_{leg}": r["launches"] for cell, c in dlrm["cells"].items()
                   for leg, r in c.get("legs", {}).items()}
    kernel_legs.update({leg: c["embedding_bag"] for leg, c in train_launches.items()})
    kernels.append({
        "name": "embedding_bag", "route": "cuda",
        "source": "src/repro_torch/kernels/embedding_bag/csrc/embedding_bag.cu",
        "replaces": "src/repro/kernels/embedding_bag/embedding_bag.py:48",
        "launches": sum(kernel_legs.values()), "launches_by_leg": kernel_legs,
        **{key: b[key] for key in ("max_abs_err", "ms", "plain_ms", "bound_ms", "bound_by",
                                   "library_ms", "shape", "call_ms")},
        "rows": bag_rows, "dlrm_serving": dlrm,
    })
    print(json.dumps({"kernels": kernels}))
    print(smi)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
