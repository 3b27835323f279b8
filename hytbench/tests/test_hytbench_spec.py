"""BENCHMARK.json keeps the contract's shapes, and everything a cell needs
is a file found by its name: adding a configuration, a traffic mix or a
metric edits no file that exists."""

import json
import re
import shutil

import pytest
import torch

from hytbench import harness

NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.\-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.\-]{1,16}$")
TEXT = re.compile(r"^[^\t\n]{1,200}$")


@pytest.fixture(scope="module")
def spec():
    return harness.load_spec()


def test_keys_names_and_units(spec):
    assert set(spec) == {"command", "paths", "run_seconds", "configs", "workloads",
                         "end_to_end", "per_layer"}
    assert spec["paths"] == ["hytbench"] and spec["command"][1].startswith("hytbench/")
    assert 1 <= spec["run_seconds"] <= 51 and isinstance(spec["run_seconds"], int)
    names = []
    for c in spec["configs"]:
        assert set(c) == {"name", "source", "file", "reduced", "why"}
        assert TEXT.match(c["source"]) and TEXT.match(c["why"])
        assert all(NAME.match(k) for k in c["reduced"]) and len(c["reduced"]) <= 16
        names.append(c["name"])
    for w in spec["workloads"]:
        assert set(w) == {"name", "config", "traffic", "chips", "why"}
        assert w["chips"] == 1 and TEXT.match(w["why"])
        assert NAME.match(w["config"]) and NAME.match(w["traffic"])
        names.append(w["name"])
    for m in spec["end_to_end"] + spec["per_layer"]:
        assert UNIT.match(m["unit"]) and m["better"] in ("lower", "higher")
        names.append(m["name"])
    for m in spec["end_to_end"]:
        assert set(m) - {"workloads"} == {"name", "unit", "better", "bound", "source"}
        assert m["source"] in ("host_clock", "device_trace") and 0.01 <= m["bound"] <= 0.25
    for m in spec["per_layer"]:
        assert set(m) - {"workloads"} == {"name", "unit", "better", "source", "layer", "moves"}
        assert TEXT.match(m["layer"])
        assert m["source"] in ("device_trace", "program_span", "program_counter", "host_clock")
        moved = harness.find(spec["end_to_end"], m["moves"], "metric")
        for cell in m["workloads"]:
            assert cell in moved.get("workloads", [cell])
    # each layer is named as PERF.md's table of layers names it
    perf = (harness.ROOT / "PERF.md").read_text()
    assert all(f"| {m['layer']} |" in perf for m in spec["per_layer"])
    assert all(NAME.match(n) for n in names) and len(names) == len(set(names))
    assert len(json.dumps(spec)) < 64 * 1024


def test_every_name_has_its_file(spec):
    for c in spec["configs"]:
        cfg = json.loads((harness.ROOT / c["file"]).read_text())
        assert cfg["name"] == c["name"] and set(c["reduced"]) <= set(cfg["reduced"])
        harness.generator(cfg["generator"])
    for w in spec["workloads"]:
        harness.traffic_of(w["traffic"])
    for m in spec["end_to_end"] + spec["per_layer"]:
        assert callable(harness.metric_reader(m["name"]).read)
    for w in spec["workloads"]:
        e2e = harness.metrics_of(spec, w["name"], False)
        assert "setup_s" in [m["name"] for m in e2e] and len(e2e) >= 2
        assert harness.metrics_of(spec, w["name"], True)


def test_a_new_config_traffic_and_metric_are_files(tmp_path, monkeypatch, spec):
    """A copy of the harness gains a configuration, a traffic mix and a
    per-layer metric as new files and new entries; the general driver runs
    the new cell without an edit to any file it had."""
    root = tmp_path / "repo"
    shutil.copytree(harness.HERE, root / "hytbench",
                    ignore=shutil.ignore_patterns("__pycache__", "tests"))
    before = {p: p.read_bytes() for p in (root / "hytbench").rglob("*") if p.is_file()}
    cfg = json.loads((root / "hytbench/configs/gap-urand-s23.json").read_text())
    cfg.update(name="gap-urand-s9", scale=9)
    (root / "hytbench/configs/gap-urand-s9.json").write_text(json.dumps(cfg))
    traffic = json.loads((root / "hytbench/traffic/sssp_sources.json").read_text())
    traffic.update(warmup_runs=0, checked_runs=1)
    (root / "hytbench/traffic/sssp_one_check.json").write_text(json.dumps(traffic))
    (root / "hytbench/metrics/searches.sssp.py").write_text(
        "def read(obs):\n    return float(len(obs.runs)) if obs.algorithm == 'sssp' else None\n")
    new = dict(spec)
    new["configs"] = spec["configs"] + [dict(spec["configs"][1], name="gap-urand-s9",
                                             file="hytbench/configs/gap-urand-s9.json")]
    new["workloads"] = spec["workloads"] + [dict(name="urand9-sssp", config="gap-urand-s9",
                                                 traffic="sssp_one_check", chips=1, why="x")]
    new["end_to_end"] = [dict(m, workloads=m["workloads"] + ["urand9-sssp"])
                         if m["name"].startswith("sssp_") else m for m in spec["end_to_end"]]
    new["per_layer"] = spec["per_layer"] + [dict(name="searches.sssp", unit="runs",
                                                 better="higher", source="program_counter",
                                                 layer=spec["per_layer"][1]["layer"],
                                                 moves="sssp_gteps", workloads=["urand9-sssp"])]
    (root / "BENCHMARK.json").write_text(json.dumps(new))
    monkeypatch.setattr(harness, "HERE", root / "hytbench")
    monkeypatch.setattr(harness, "ROOT", root)
    monkeypatch.setattr(harness.tracing, "traced", fake_traced)
    loaded = harness.load_spec(root)
    cell = harness.find(loaded["workloads"], "urand9-sssp", "workload")
    out = harness.run_cell(loaded, cell, 17, 0.3, False, torch.device("cpu"), t_start=0.0)
    assert out["correct"] and {"sssp_gteps", "sssp_ms_p90", "setup_s"} == set(out["metrics"])
    out = harness.run_cell(loaded, cell, 17, 0.3, True, torch.device("cpu"), t_start=0.0)
    assert out["metrics"]["searches.sssp"]["value"] >= 1
    assert all(before[p] == p.read_bytes() for p in before), "an existing file changed"


def fake_traced(torch, device, run_segment):
    """The traced segment without a card: its host spans, no device time
    but the anchor's."""
    import time

    t0 = time.monotonic()
    spans, runs = run_segment()
    out = harness.tracing.summarize([(0.0, 1.0, "anchor")], t0, time.monotonic() - t0, spans)
    out.runs = runs
    return out
