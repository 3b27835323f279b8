"""One run of one cell: set-up, the measured window, the traced segment,
and the check against the plain reference.

Everything that differs between cells is found by name:
``BENCHMARK.json`` names the cell's configuration (its file under
``configs/``) and traffic mix (``traffic/<mix>.json``); the configuration
names its generator (``gen/<family>.py``); every metric is read by
``metrics/<metric>.py``.  This module is the one general driver of them.

The system under test is ``repro_torch``'s HyTM engine: the program's own
preprocessing (``hub_sort``, ``build_runtime``) runs once in set-up, and
the window calls ``run_hytm`` back to back (one client, closed loop) until
``seconds`` have passed; the call in flight then finishes and counts.
"""

from __future__ import annotations

import dataclasses
import gc
import importlib
import importlib.util
import json
import sys
import time
import traceback
from dataclasses import dataclass
from pathlib import Path

import numpy as np
import torch

from hytbench import trace as tracing
from hytbench.gen.common import Graph
from hytbench.reference import Arcs
from hytbench.reference.components import component_edges
from hytbench.reference.pagerank import pagerank
from hytbench.reference.sssp import sssp

HERE = Path(__file__).resolve().parent
ROOT = HERE.parent
# top-level module names that the process under test must not hold
FORBIDDEN = ("jax", "jaxlib", "flax", "repro")
KERNEL_WRAPPERS = ("segment_spmm", "frontier_compact", "hyb_gather")


def log(msg: str) -> None:
    print(f"[hytbench] {msg}", file=sys.stderr, flush=True)


# ---------------------------------------------------------------------------
# Finding things by name
# ---------------------------------------------------------------------------

def load_spec(root: Path | None = None) -> dict:
    return json.loads(((root or ROOT) / "BENCHMARK.json").read_text())


def find(entries: list, name: str, what: str) -> dict:
    for e in entries:
        if e["name"] == name:
            return e
    raise KeyError(f"BENCHMARK.json has no {what} named {name!r}")


def config_of(spec: dict, cell: dict) -> dict:
    entry = find(spec["configs"], cell["config"], "configuration")
    return json.loads((ROOT / entry["file"]).read_text())


def traffic_of(name: str) -> dict:
    return json.loads((HERE / "traffic" / f"{name}.json").read_text())


def generator(family: str):
    return importlib.import_module(f"hytbench.gen.{family}")


def metric_reader(name: str):
    path = HERE / "metrics" / f"{name}.py"
    spec = importlib.util.spec_from_file_location(f"hytbench.metrics.{name}", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def metrics_of(spec: dict, cell_name: str, traced: bool) -> list[dict]:
    """The cell's end-to-end metrics, or with ``traced`` its per-layer ones."""
    section = spec["per_layer" if traced else "end_to_end"]
    return [m for m in section if cell_name in m.get("workloads", [cell_name])]


def forbidden_modules() -> list[str]:
    """Modules of ``sys.modules`` whose top-level name is forbidden, the
    name compared whole (``repro_torch`` is not ``repro``)."""
    return sorted({m.split(".")[0] for m in list(sys.modules)} & set(FORBIDDEN))


# ---------------------------------------------------------------------------
# What the metric readers read
# ---------------------------------------------------------------------------

@dataclass
class RunRecord:
    """One ``run_hytm`` call: its host wall time and the program's counters."""

    wall_s: float
    iterations: int
    active_edges: float     # sum over iterations of the frontier's out-arcs
    transfer_bytes: float   # the cost model's modeled link bytes
    edges: int              # Graph500's traversed edges (SSSP), else 0


@dataclass
class Observed:
    """Everything one run measured, as the metric readers take it."""

    algorithm: str
    arcs: int
    setup_s: float
    prep_s: float
    runs: list          # the window's RunRecords
    launches: dict      # kernel wrapper -> launches in the window
    trace: tracing.Trace | None


# ---------------------------------------------------------------------------
# The system under test
# ---------------------------------------------------------------------------

def hytm_config(cfg: dict, traffic: dict):
    from repro_torch.core import constants
    from repro_torch.core.hytm import HyTMConfig

    h = dict(cfg["hytm"])
    link = getattr(constants, h.pop("link")).with_(**h.pop("link_overrides", {}))
    if "cds_mode" in traffic:
        h["cds_mode"] = traffic["cds_mode"]
    return HyTMConfig(link=link, **h)


def program_of(traffic: dict):
    from repro_torch.graph.algorithms import PAGERANK, SSSP

    if traffic["algorithm"] == "sssp":
        return SSSP
    if traffic["algorithm"] == "pagerank":
        return dataclasses.replace(PAGERANK, damping=traffic["damping"],
                                   tolerance=traffic["tolerance"])
    raise ValueError(f"no program for algorithm {traffic['algorithm']!r}")


class Port:
    """``repro_torch`` on one graph: its preprocessing once, then one
    ``run_hytm`` a request.  Answers are read back in the benchmark's ids."""

    def __init__(self, g: Graph, cfg, program, device: torch.device):
        from repro_torch.core.hytm import build_runtime
        from repro_torch.graph.csr import CSRGraph
        from repro_torch.graph.hub_sort import hub_sort

        self.cfg, self.program = cfg, program
        t = time.monotonic()
        self.hs = hub_sort(CSRGraph(g.indptr, g.indices, g.weights), device=device)
        self.rt = build_runtime(self.hs.graph, cfg, n_hubs=self.hs.n_hubs, device=device)
        sync(device)
        self.prep_s = time.monotonic() - t

    def run(self, source: int | None, obs=None):
        from repro_torch.core import hytm

        src = None if source is None else int(self.hs.perm[source])
        return hytm.run_hytm(None, self.program, src, self.cfg, runtime=self.rt, obs=obs)

    def answer(self, res) -> np.ndarray:
        """A result's per-vertex answer in the benchmark's vertex ids:
        distances, or ranks (consumed plus pending Δ)."""
        v = res.values if not self.program.use_delta else res.values + res.delta
        return np.asarray(v)[self.hs.perm]


def sync(device: torch.device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def launch_counts() -> dict:
    mods = {name: importlib.import_module(f"repro_torch.kernels.{name}.ops")
            for name in KERNEL_WRAPPERS}
    return {name: getattr(mods[name], name).launches for name in KERNEL_WRAPPERS}


def record_of(res, edges: int, wall: float) -> RunRecord:
    from repro_torch.core.cost_model import KEY_ACTIVE_EDGES

    return RunRecord(wall_s=wall, iterations=int(res.iterations),
                     active_edges=float(np.sum(res.history[KEY_ACTIVE_EDGES], dtype=np.float64)),
                     transfer_bytes=float(res.total_transfer_bytes), edges=int(edges))


# ---------------------------------------------------------------------------
# Traffic: one general generator of requests
# ---------------------------------------------------------------------------

class Requests:
    """The request stream of a traffic mix, drawn from the seed: SSSP
    sources uniform over the vertices of degree > 0 (GAP's rule), or one
    source-less run a request."""

    def __init__(self, traffic: dict, g: Graph, seed: int):
        self.rng = np.random.default_rng(seed)
        self.sourced = traffic["algorithm"] == "sssp"
        self.pool = np.flatnonzero(g.degrees > 0) if self.sourced else None

    def next(self) -> int | None:
        if not self.sourced:
            return None
        return int(self.pool[self.rng.integers(len(self.pool))])


class Sample:
    """A uniform sample of ``k`` of the window's runs (all with
    ``k="all"``), by reservoir, drawn from the seed."""

    def __init__(self, k, seed: int):
        self.k = k
        self.rng = np.random.default_rng([seed, 1])
        self.kept: list = []
        self.seen = 0

    def offer(self, item) -> None:
        if self.k == "all" or len(self.kept) < self.k:
            self.kept.append(item)
        else:
            j = int(self.rng.integers(self.seen + 1))
            if j < self.k:
                self.kept[j] = item
        self.seen += 1


# ---------------------------------------------------------------------------
# The run
# ---------------------------------------------------------------------------

def draw_graph(cfg: dict, traffic: dict, seed: int, device: torch.device) -> Graph:
    """The configuration's graph for a run seed: drawn from the seed, or,
    for a mix with a ``graph_seed``, one draw for every seed."""
    gen = torch.Generator(device=device)
    gen.manual_seed(int(traffic.get("graph_seed", seed)) % 2**63)
    return generator(cfg["generator"]).generate(cfg, gen, device)


def run_cell(spec: dict, cell: dict, seed: int, seconds: float, traced: bool,
             device: torch.device, t_start: float, cfg: dict | None = None) -> dict:
    """One run of ``cell``; its result line as a dict.  ``cfg`` replaces
    the configuration's file (the CPU tests shrink the scale)."""
    cfg = cfg if cfg is not None else config_of(spec, cell)
    traffic = traffic_of(cell["traffic"])
    seed = int(seed) % 2**63
    if device.type == "cuda":
        from repro_torch.kernels.runtime import build_kernels

        build_kernels()

    t = time.monotonic()
    g = draw_graph(cfg, traffic, seed, device)
    log(f"graph: {g.n} vertices, {g.arcs} arcs, {time.monotonic() - t:.2f} s")
    edges_of = None
    if traffic["algorithm"] == "sssp":
        arcs = Arcs.of(g.indptr, g.indices, g.weights, device)
        label, comp = component_edges(arcs)
        edges_of = comp[label].cpu().numpy()   # each vertex's component's edges
        del arcs, label, comp
    release(device)
    if device.type == "cuda":
        # the peak is the program's: the generator's sort and the
        # components above are the benchmark's own work
        torch.cuda.reset_peak_memory_stats(device)

    program = program_of(traffic)
    port = Port(g, hytm_config(cfg, traffic), program, device)
    log(f"prep (hub_sort, build_runtime): {port.prep_s:.2f} s")
    requests = Requests(traffic, g, seed)
    for _ in range(traffic["warmup_runs"]):
        port.run(requests.next())
    sync(device)
    setup_s = time.monotonic() - t_start
    log(f"set-up: {setup_s:.2f} s")

    def edges(source):
        return int(edges_of[source]) if edges_of is not None else 0

    sample = Sample(traffic["checked_runs"], seed)
    runs, failed, attempted = [], 0, 0
    base = launch_counts()
    t0 = time.monotonic()
    while attempted == 0 or time.monotonic() - t0 < seconds:
        source = requests.next()
        attempted += 1
        t = time.monotonic()
        try:
            res = port.run(source)
        except Exception:  # a failed request counts, and the loop goes on
            failed += 1
            log(f"request {attempted} (source {source}) failed:\n{traceback.format_exc()}")
            continue
        runs.append(record_of(res, edges(source), time.monotonic() - t))
        sample.offer((source, res))
    after = launch_counts()
    log(f"window: {len(runs)} runs in {time.monotonic() - t0:.2f} s")

    trace = None
    if traced:
        trace = tracing.traced(torch, device, lambda: traced_segment(
            port, requests, traffic["traced_runs"], edges))
        log(f"traced: busy {trace.busy_s:.4f} s of {trace.window_s:.4f} s")
    peak = torch.cuda.max_memory_allocated(device) if device.type == "cuda" else 0

    answers = [(source, port.answer(res)) for source, res in sample.kept]
    obs = Observed(algorithm=traffic["algorithm"], arcs=g.arcs, setup_s=setup_s,
                   prep_s=port.prep_s, runs=runs,
                   launches={k: after[k] - base[k] for k in after}, trace=trace)
    del port, sample
    release(device)
    checks = check(traffic, g, answers, device, failed)
    metrics = {}
    for m in metrics_of(spec, cell["name"], traced):
        value = metric_reader(m["name"]).read(obs)
        if value is not None:
            metrics[m["name"]] = {"value": value, "unit": m["unit"]}
    dev = {"platform": "gpu" if device.type == "cuda" else device.type,
           "kind": torch.cuda.get_device_name(device) if device.type == "cuda" else "cpu",
           "count": 1, "memory_peak_bytes": int(peak)}
    out = {"correct": all(c["value"] <= c["limit"] for c in checks.values()),
           "attempted": attempted, "failed": failed, "metrics": metrics, "device": dev}
    if trace is not None:
        dev["busy_s"], dev["window_s"] = trace.busy_s, trace.window_s
        out["breakdown"] = {"device_ops": trace.device_ops, "idle_gaps": trace.idle_gaps}
    out["checks"] = checks
    return out


def traced_segment(port: Port, requests: Requests, n_runs: int, edges) -> tuple[list, list]:
    """``n_runs`` more requests, each in a host span, with the chunk spans
    that ``run_hytm(obs=...)`` records; (spans, records)."""
    from repro_torch.obs import TraceRecorder

    spans, records = [], []
    for _ in range(n_runs):
        source = requests.next()
        rec = TraceRecorder()
        t = time.monotonic()
        res = port.run(source, obs=rec)
        end = time.monotonic()
        spans.append(tracing.Span("run_hytm: outside its chunks", t, end))
        origin = t - rec.wall_at(t)
        for ev in rec.events:
            if ev.name == "chunk":
                first = int(ev.vt)
                spans.append(tracing.Span(
                    f"run_hytm: chunk of iterations {first}-{first + int(ev.vt_dur) - 1}",
                    origin + ev.wall, origin + ev.wall + ev.wall_dur))
        records.append(record_of(res, edges(source), end - t))
    return spans, records


def release(device: torch.device) -> None:
    gc.collect()
    if device.type == "cuda":
        torch.cuda.empty_cache()


# ---------------------------------------------------------------------------
# Correctness: the program's answers against the plain reference
# ---------------------------------------------------------------------------

def sssp_gap(got: np.ndarray, want: np.ndarray) -> float:
    """The largest |got - want| over vertices; inf where one side reaches
    a vertex and the other does not."""
    fin_g, fin_w = np.isfinite(got), np.isfinite(want)
    if not np.array_equal(fin_g, fin_w):
        return float("inf")
    if not fin_w.any():
        return 0.0
    return float(np.max(np.abs(got[fin_w].astype(np.float64) - want[fin_w])))


def pagerank_gap(got: np.ndarray, want: np.ndarray) -> float:
    """The largest relative gap |got - want| / want over vertices (every
    rank is at least 1 - damping > 0); inf where ``got`` is not finite."""
    if not np.all(np.isfinite(got)):
        return float("inf")
    return float(np.max(np.abs(got.astype(np.float64) - want) / want))


def check(traffic: dict, g: Graph, answers: list, device: torch.device, failed: int) -> dict:
    """Each number compared, with its limit (``traffic[check]``)."""
    spec = traffic["check"]
    arcs = Arcs.of(g.indptr, g.indices, g.weights, device)
    worst = float("inf") if not answers else 0.0
    if traffic["algorithm"] == "sssp":
        for source, got in answers:
            want = sssp(arcs, source).cpu().numpy()
            worst = max(worst, sssp_gap(got, want))
    else:
        want = pagerank(arcs, traffic["damping"]).cpu().numpy()
        for _, got in answers:
            worst = max(worst, pagerank_gap(got, want))
    del arcs
    release(device)
    log(f"checked {len(answers)} runs against the reference")
    return {spec["name"]: {"value": worst, "limit": spec["limit"]},
            "failed_requests": {"value": failed, "limit": 0}}
