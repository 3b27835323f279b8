"""The metric readers' arithmetic, and the trace's union and gaps."""

import math

import numpy as np
import pytest

from hytbench import trace as tracing
from hytbench.harness import Observed, RunRecord, load_spec, metric_reader

RUNS = [RunRecord(wall_s=w, iterations=i, active_edges=e, transfer_bytes=b, edges=x)
        for w, i, e, b, x in ((0.2, 10, 1000.0, 2**20, 500),
                              (0.6, 30, 3000.0, 3 * 2**20, 900),
                              (0.1, 5, 400.0, 0.0, 0))]


def observed(algorithm="sssp", runs=RUNS, trace=None, launches=None):
    return Observed(algorithm=algorithm, arcs=2000, setup_s=12.5, prep_s=4.25, runs=list(runs),
                    launches=launches or {"segment_spmm": 30, "frontier_compact": 10,
                                          "hyb_gather": 5}, trace=trace)


def read(name, obs):
    return metric_reader(name).read(obs)


def test_gteps_is_one_rate_over_all_work_and_time():
    # (500 + 900 + 0) edges over (0.2 + 0.6 + 0.1) s, not the mean of rates
    assert read("sssp_gteps", observed()) == pytest.approx(1400 / 0.9 / 1e9)


def test_p90_is_over_all_searches():
    walls = [0.001 * k for k in range(1, 101)]
    obs = observed(runs=[RunRecord(w, 1, 1.0, 0.0, 1) for w in walls])
    assert read("sssp_ms_p90", obs) == pytest.approx(np.percentile(walls, 90) * 1e3)


def test_pagerank_s_is_the_mean_run():
    assert read("pagerank_s", observed("pagerank")) == pytest.approx(0.9 / 3)
    assert read("pagerank_s", observed("sssp")) is None


def test_program_counters():
    obs = observed()
    assert read("iterations.sssp", obs) == pytest.approx(15)
    assert read("relaxed_per_arc.sssp", obs) == pytest.approx(4400 / 3 / 2000)
    assert read("modeled_mib.sssp", obs) == pytest.approx(4 / 3)
    assert read("launches_per_iter.sssp", obs) == pytest.approx(45 / 45)
    assert read("setup_s", obs) == 12.5 and read("prep_s", obs) == 4.25


def test_trace_metrics():
    t = tracing.Trace(busy_s=0.5, window_s=2.0, device_ops=[], idle_gaps=[], runs=RUNS[:2])
    obs = observed(trace=t)
    assert read("idle_share.sssp", obs) == pytest.approx(75.0)
    # 8 bytes an active arc (destination and weight) at 3.35 TB/s over busy
    assert read("relax_roofline.sssp", obs) == pytest.approx(100 * 8 * 4000 / 3.35e12 / 0.5)
    assert read("relax_roofline.pagerank", observed("pagerank", trace=t)) == \
        pytest.approx(100 * 4 * 4000 / 3.35e12 / 0.5)


def test_every_per_layer_reader_is_silent_without_its_data():
    spec = load_spec()
    for m in spec["per_layer"]:
        algorithm = "pagerank" if m["name"].endswith(".sssp") else "sssp"
        if m["name"] == "prep_s":
            continue
        assert read(m["name"], observed(algorithm)) is None, m["name"]
        assert read(m["name"], observed(m["name"].rsplit(".", 1)[-1], runs=[])) is None or \
            m["source"] == "device_trace", m["name"]


def test_union_and_gaps():
    busy = tracing.merged([(5, 7), (0, 2), (1, 3), (6, 9)])
    assert busy == [(0, 3), (5, 9)]
    assert tracing.gaps(busy, 0, 12) == [(3, 5), (9, 12)]
    assert tracing.gaps(busy, -1, 8) == [(-1, 0), (3, 5)]


def test_summarize_sums_idle_time_by_the_innermost_span():
    # device clock in µs from the anchor at 100; host anchor at t = 50 s
    events = [(100.0, 101.0, "anchor"), (1100.0, 2100.0, "void (anonymous namespace)::k<1>(int*)"),
              (3100.0, 3200.0, "void (anonymous namespace)::k<1>(int*)"),
              (5100.0, 5600.0, "at::native::elementwise_kernel<4>(int)")]
    spans = [tracing.Span("run_hytm: outside its chunks", 50.0005, 50.0060),
             tracing.Span("run_hytm: chunk of iterations 0-7", 50.0020, 50.0055)]
    t = tracing.summarize(events, 50.0, 0.0080, spans)
    assert t.busy_s == pytest.approx((1 + 1000 + 100 + 500) / 1e6)
    assert t.device_ops[0] == ["k<1>", pytest.approx(0.0011)]
    idle = {lab: round(s * 1e6) for lab, s in t.idle_gaps}
    assert idle == {"run_hytm: chunk of iterations 0-7": 1000 + 1900,  # 2100..3100, 3200..5100
                    "run_hytm: outside its chunks": 999,               # 101..1100
                    "harness: between runs": 2500}                     # 5600..8100
    assert [lab for lab, _ in t.idle_gaps][0] == "run_hytm: chunk of iterations 0-7"
    assert all(not math.isnan(s) for _, s in t.idle_gaps)
