"""The port stands alone: ``repro_torch``, ``chip_smoke.py`` and the
examples' twins (``examples/torch_*.py``) import neither jax nor the
reference package ``repro``, and the entry points never fall back to the
CPU on their own."""

import ast
import importlib.util
import os
import subprocess
import sys
from pathlib import Path

import pytest
import torch

ROOT = Path(__file__).resolve().parents[1]
PKG = ROOT / "src" / "repro_torch"
FORBIDDEN = ("jax", "jaxlib", "repro")
EXAMPLES = sorted((ROOT / "examples").glob("torch_*.py"))


def _example(path: Path):
    spec = importlib.util.spec_from_file_location(f"_example_{path.stem}", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def _modules():
    for path in sorted(PKG.rglob("*.py")):
        rel = path.relative_to(ROOT / "src").with_suffix("")
        parts = rel.parts[:-1] if rel.name == "__init__" else rel.parts
        yield path, ".".join(parts)


def _imported_roots(path: Path):
    tree = ast.parse(path.read_text(), filename=str(path))
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            for alias in node.names:
                yield alias.name.split(".")[0]
        elif isinstance(node, ast.ImportFrom) and node.level == 0 and node.module:
            yield node.module.split(".")[0]


@pytest.mark.parametrize("path",
                         [p for p, _ in _modules()] + [ROOT / "chip_smoke.py"] + EXAMPLES,
                         ids=lambda p: str(p.relative_to(ROOT)))
def test_no_jax_or_reference_imports(path):
    roots = set(_imported_roots(path))
    assert not roots & set(FORBIDDEN), f"{path} imports {roots & set(FORBIDDEN)}"


def test_every_module_imports_without_jax_or_reference():
    names = [name for _, name in _modules()]
    code = (
        "import sys\n"
        "for blocked in ('jax', 'jaxlib', 'repro'):\n"
        "    sys.modules[blocked] = None\n"
        "import importlib\n"
        f"for name in {names!r}:\n"
        "    importlib.import_module(name)\n"
        "assert not any(m == 'jax' or m.startswith('jax.') for m in sys.modules\n"
        "               if sys.modules[m] is not None)\n"
        "print('ok', len(sys.modules))\n"
    )
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"))
    out = subprocess.run([sys.executable, "-c", code], env=env, capture_output=True,
                         text=True, timeout=120)
    assert out.returncode == 0, out.stderr
    assert out.stdout.startswith("ok")


def test_entry_points_raise_without_a_card():
    from repro_torch.core.hytm import HyTMConfig, build_runtime, run_hytm
    from repro_torch.graph.algorithms import SSSP, init_state
    from repro_torch.graph.csr import to_device_csr
    from repro_torch.graph.generators import uniform_graph
    from repro_torch.configs import get_arch
    from repro_torch.configs.common import reduce_lm_config
    from repro_torch.autotune import default_device_kind, default_grid, wall_probe
    from repro_torch.launch import calibrate, serve
    from repro_torch.models.transformer import init_cache, init_transformer
    from repro_torch.models.gnn import init_gnn
    from repro_torch.graph.sampler import sample_neighbors_device
    from repro_torch.launch import train
    from repro_torch.train.optimizer import OptimizerConfig
    from repro_torch.train.train_step import init_train_state

    twins = [_example(path) for path in EXAMPLES]
    assert [t.__name__ for t in twins] == [f"_example_torch_{n}" for n in
                                          ("quickstart", "serve_lm", "train_gnn", "train_lm")]
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present: the entry points run on it")
    g = uniform_graph(40, 200, seed=0)
    lm = reduce_lm_config(get_arch("gemma3-12b"))
    sage = get_arch("graphsage-reddit").replace(d_in=8, d_hidden=16)
    csr = (torch.from_numpy(g.indptr), torch.from_numpy(g.indices))
    seeds = torch.arange(4)
    for call in (lambda: run_hytm(g, SSSP),
                 lambda: build_runtime(g, HyTMConfig()),
                 lambda: to_device_csr(g),
                 lambda: init_state(SSSP, 40, 0),
                 lambda: init_transformer(lm, torch.Generator()),
                 lambda: init_cache(lm, 1, 8),
                 lambda: init_gnn(sage, torch.Generator()),
                 lambda: sample_neighbors_device(torch.Generator(), *csr, seeds, (3, 2)),
                 lambda: serve.main(["--arch", "gemma3-12b", "--reduced"]),
                 lambda: wall_probe(default_grid()[:1]),
                 lambda: default_device_kind(),
                 lambda: calibrate.main(["--dry-run"]),
                 lambda: init_train_state({"w": torch.ones(3)}, OptimizerConfig()),
                 lambda: train.main(["--arch", "internlm2-1.8b", "--steps", "1"]),
                 *[lambda twin=twin: twin.main([]) for twin in twins]):
        with pytest.raises(RuntimeError, match="no CUDA device"):
            call()
    # an explicit CPU request runs
    assert run_hytm(g, SSSP, device="cpu").iterations >= 1
    assert init_transformer(lm, torch.Generator(), device="cpu").embed.device.type == "cpu"
    assert init_gnn(sage, torch.Generator(), device="cpu").out.device.type == "cpu"
    hops = sample_neighbors_device(torch.Generator(), *csr, seeds, (3, 2), device="cpu")
    assert [h.shape[0] for h in hops] == [4, 12, 24]


def test_chip_smoke_fails_without_the_program_or_a_card(tmp_path):
    lone = tmp_path / "chip_smoke.py"
    lone.write_text((ROOT / "chip_smoke.py").read_text())
    cases = [(tmp_path, lone)]
    if not torch.cuda.is_available():
        cases.append((ROOT, ROOT / "chip_smoke.py"))
    for cwd, script in cases:
        out = subprocess.run([sys.executable, str(script), "--scale", "8"], cwd=cwd,
                             capture_output=True, text=True, timeout=120,
                             env=dict(os.environ, PYTHONPATH=""))
        assert out.returncode != 0
        assert '"ok": true' not in out.stdout
