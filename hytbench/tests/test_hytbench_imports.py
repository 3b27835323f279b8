"""Nothing the harness runs imports JAX or the JAX package ``repro``
(top-level names compared whole: ``repro_torch`` is the program), nothing
reads the JAX package's ``benchmarks/``, and the reference and the
generators import nothing of the program."""

import ast
import json
import subprocess
import sys

from hytbench import harness

FORBIDDEN = {"jax", "jaxlib", "flax", "repro"}


def imported_tops(path):
    tree = ast.parse(path.read_text())
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            yield from (a.name.split(".")[0] for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.module and not node.level:
            yield node.module.split(".")[0]


def test_sources_import_no_jax_and_read_no_benchmarks():
    files = [p for p in harness.HERE.rglob("*.py") if "tests" not in p.parts]
    for p in files:
        assert not set(imported_tops(p)) & FORBIDDEN, p
        assert "benchmarks/" not in p.read_text() and "benchmarks." not in p.read_text(), p
    for sub in ("reference", "gen"):
        for p in (harness.HERE / sub).rglob("*.py"):
            assert "repro_torch" not in set(imported_tops(p)), p


def probe(code: str) -> dict:
    root = harness.ROOT
    out = subprocess.run(
        [sys.executable, "-c", f"import sys; sys.path[:0] = [{str(root)!r}, "
         f"{str(root / 'src')!r}]\n" + code +
         "\nimport json; print(json.dumps(sorted({m.split('.')[0] for m in sys.modules})))"],
        capture_output=True, text=True, timeout=300, check=True)
    return set(json.loads(out.stdout.splitlines()[-1]))


def test_reference_loads_nothing_of_the_program():
    tops = probe("import hytbench.reference.sssp, hytbench.reference.pagerank, "
                 "hytbench.reference.components, hytbench.gen.kron, hytbench.gen.urand")
    assert not tops & (FORBIDDEN | {"repro_torch"})


def test_a_cpu_run_loads_no_jax():
    tops = probe(
        "import torch\nfrom hytbench import harness\n"
        "harness.tracing.traced = None\n"
        "spec = harness.load_spec(); cell = harness.find(spec['workloads'], 'kron-sssp', 'w')\n"
        "cfg = dict(harness.config_of(spec, cell), scale=9)\n"
        "out = harness.run_cell(spec, cell, 3, 0.2, False, torch.device('cpu'), 0.0, cfg=cfg)\n"
        "assert out['correct']")
    assert "repro_torch" in tops and not tops & FORBIDDEN


def test_run_refuses_without_a_card():
    import torch

    if torch.cuda.is_available():
        return
    out = subprocess.run([sys.executable, str(harness.HERE / "run.py"), "--workload",
                          "kron-sssp", "--seed", "1", "--seconds", "1", "--trace", "0"],
                         capture_output=True, text=True, timeout=300)
    assert out.returncode != 0 and out.stdout == ""
