"""Models over a mesh: the port's ``moe_ffn(mesh=)`` and ``prefill`` /
``decode_step`` / ``generate`` over a ``launch.mesh.ModelMesh`` against the
reference's ``shard_map`` runs, on gloo ranks on the CPU.

One pool of 8 ranks serves the module (a ``launch.mesh.RankPool``, started anew
by ``PoolKeeper`` after a case whose run broke it: this
process is rank 0, seven spawned ranks with one thread each).  A 2-D mesh
runs on ranks 0-3; every rank still calls ``make_debug_mesh`` (ranks 4-7
get ``None``), as ``dist.new_group`` wants.  The reference's sharded runs
need forced-host JAX devices, so one subprocess
(``repro.launch.mesh.forced_host_device_env(8)``) runs every reference
case this file needs on inputs this process writes first, while the ranks
work; the cases that wait for it come last.

Contract and tolerances:
* the sharded MoE equals the reference's sharded ``moe_ffn`` on the same
  mesh shape: outputs within ``MOE_TOL`` (float32; the reference's own
  sharded and per-shard runs agree to 1.2e-6), aux within ``AUX_TOL``;
* **capacity is per shard**: C comes from a rank's own tokens, so the
  comparison is with the reference's *sharded* run (or per-shard
  ``_moe_core`` calls), never with its single-device run where drops occur
  (``capacity_factor`` 1.25 cases drop; ``test_drops_happen`` shows it);
* a one-rank mesh is bit-equal to the call without a mesh, on both routes;
* at TP = 1 the sharded output equals per-shard ``_moe_core`` calls within
  ``MOE_TOL`` (bit-equal on the plain route; the kernel route's plain
  version runs one CPU matmul a group, whose blocking changes with the
  group's rows);
* reduced deepseek-v2-lite (MLA + MoE, float32, ``capacity_factor`` 1.25)
  at (2, 2): the prefill logits and caches and two ``decode_step``s within
  ``LM_TOL`` of the reference's mesh runs, rows split by rank, and
  ``generate(mesh=)``'s gathered tokens equal to the reference's greedy
  tokens;
* ranks map to mesh coordinates as ``jax.make_mesh`` lays out devices.

Hazards named here: exchange order (``tiled=True`` puts sources on the
capacity axis in mesh order; a pod mesh linearises ``("pod", "data")``
row-major), ties of a chunk's padding tokens, and rank agreement (every
rank runs the same chunks and collectives).
"""

import dataclasses
import os
import subprocess
import sys
import textwrap
from pathlib import Path

import jax
import numpy as np
import pytest
import torch

from repro.launch.mesh import forced_host_device_env
from repro.models import attention as jax_attention
from repro.models import moe as jax_moe
from repro.models import transformer as jax_tf
from repro_torch import convert
from repro_torch.configs import get_arch
from repro_torch.configs.common import reduce_lm_config
from repro_torch.launch import serve
from repro_torch.launch.mesh import PoolKeeper, make_debug_mesh
from repro_torch.models import moe, transformer

MOE_TOL = 1e-5
AUX_TOL = 1e-6
LM_TOL = 1e-4
D_MODEL = 64
T = 256
BASE = dict(n_experts=8, top_k=2, d_ff=32, n_shared=1, capacity_factor=1.25,
            dispatch="sorted", chunk_tokens=0)
PD = ("pod", "data")
# name -> (pods, n_data, n_model), batch_axes, expert_axis, MoEConfig fields
MOE_CASES = {
    "p222_sorted_s1_cf16": ((2, 2, 2), PD, None, dict(capacity_factor=16.0)),
    "p222_gather_s0": ((2, 2, 2), PD, None, dict(dispatch="gather", n_shared=0)),
    "p222_ep_data": ((2, 2, 2), PD, "data", dict()),
    "d22_sorted_s1": ((0, 2, 2), ("data",), None, dict()),
    "d22_gather_chunked": ((0, 2, 2), ("data",), None, dict(dispatch="gather", chunk_tokens=48)),
    "d41_sorted_s0": ((0, 4, 1), ("data",), None, dict(n_shared=0)),
    "d41_gather_s1_cf16": ((0, 4, 1), ("data",), None, dict(dispatch="gather",
                                                             capacity_factor=16.0)),
    "d41_sorted_chunked": ((0, 4, 1), ("data",), None, dict(chunk_tokens=24)),
    "d14_sorted_s1": ((0, 1, 4), ("data",), None, dict()),
    "d14_gather_chunked_cf16": ((0, 1, 4), ("data",), None, dict(
        dispatch="gather", chunk_tokens=100, capacity_factor=16.0)),
}
MESHES = {"p222": (2, 2, 2), "d22": (0, 2, 2), "d41": (0, 4, 1), "d14": (0, 1, 4)}
LM_MESH = (0, 2, 2)
LM_B, LM_S, LM_GEN = 4, 16, 3


def _cfg(fields: dict) -> moe.MoEConfig:
    return moe.MoEConfig(**{**BASE, **fields})


def _moe_inputs(i: int, cfg: moe.MoEConfig) -> dict:
    """Full parameters and tokens as numpy, from ``default_rng(i)``: weights
    normal with std 1/sqrt(d_in), tokens normal with a shared direction
    added, so that the router prefers some experts and capacity 1.25
    drops."""
    rng = np.random.default_rng(i)
    E, F, d = cfg.n_experts, cfg.d_ff, D_MODEL

    def w(*shape):
        return (rng.standard_normal(shape) / np.sqrt(shape[-2])).astype(np.float32)

    p = {"router": w(d, E), "w_gate": w(E, d, F), "w_up": w(E, d, F), "w_down": w(E, F, d)}
    if cfg.n_shared:
        Fs = cfg.shared_hidden
        p.update(shared_gate=w(d, Fs), shared_up=w(d, Fs), shared_down=w(Fs, d))
    x = rng.standard_normal((T, d)) + 1.5 * rng.standard_normal(d)
    return {"params": p, "x": x.astype(np.float32)}


def jax_config(cfg):
    """The reference's ``TransformerConfig`` of a port config."""
    kw = {f.name: getattr(cfg, f.name) for f in dataclasses.fields(cfg)}
    if cfg.mla is not None:
        kw["mla"] = jax_attention.MLAConfig(**dataclasses.asdict(cfg.mla))
    if cfg.moe is not None:
        kw["moe"] = jax_moe.MoEConfig(**dataclasses.asdict(cfg.moe))
    return jax_tf.TransformerConfig(**kw)


LM_CFG = reduce_lm_config(get_arch("deepseek-v2-lite-16b")).replace(
    moe=reduce_lm_config(get_arch("deepseek-v2-lite-16b")).moe.replace(capacity_factor=1.25))


def _lm_tree() -> dict:
    """The reference's parameter tree of ``LM_CFG`` as numpy, norm scales
    random."""
    tree = jax.tree.map(np.asarray, jax_tf.init_transformer(jax.random.PRNGKey(0),
                                                            jax_config(LM_CFG)))
    rng = np.random.default_rng(0)
    for layer in [tree["layers"], *tree["prefix"]]:
        for name in ("ln1", "ln2"):
            layer[name] = (rng.standard_normal(layer[name].shape) * 0.1).astype(np.float32)
        layer["attn"]["kv_norm"] = (rng.standard_normal(layer["attn"]["kv_norm"].shape)
                                    * 0.1).astype(np.float32)
    tree["final_norm"] = (rng.standard_normal(LM_CFG.d_model) * 0.1).astype(np.float32)
    return tree


# --------------------------------------------------------------------------
# the reference's sharded runs: one forced-device subprocess
# --------------------------------------------------------------------------

_REFERENCE_SCRIPT = """
    import json, sys
    from functools import partial
    import jax, jax.numpy as jnp
    import numpy as np
    assert len(jax.devices()) == 8, jax.devices()
    from repro.launch.mesh import make_debug_mesh
    from repro.models import transformer as tf
    from repro.models.attention import MLAConfig
    from repro.models.moe import MoEConfig, moe_ffn

    spec = json.loads(sys.argv[1])
    inp = dict(np.load(sys.argv[2]))
    out = {}

    def mesh_of(shape):
        pods, n_data, n_model = shape
        return make_debug_mesh(n_data, n_model, pods=pods)

    for name, shape in spec["meshes"].items():
        out[name + "/devices"] = np.array([[d.id for d in mesh_of(shape).devices.flat]])
    for name, (shape, batch_axes, expert_axis, cfg) in spec["moe"].items():
        mesh = mesh_of(shape)
        p = {k.split("/")[2]: jnp.asarray(v) for k, v in inp.items()
             if k.startswith(f"moe/{name}/")}
        fn = jax.jit(partial(moe_ffn, cfg=MoEConfig(**cfg), mesh=mesh,
                             batch_axes=tuple(batch_axes), expert_axis=expert_axis))
        with mesh:
            y, aux = fn(p, jnp.asarray(inp[f"x/{name}"]))
        out[name + "/y"], out[name + "/aux"] = np.asarray(y), np.asarray(aux)

    lm = spec["lm"]
    kw = dict(lm["cfg"])
    kw["mla"], kw["moe"] = MLAConfig(**kw["mla"]), MoEConfig(**kw["moe"])
    kw["window_pattern"] = tuple(kw["window_pattern"])
    cfg = tf.TransformerConfig(**kw)
    _, treedef = jax.tree.flatten(tf.init_transformer(jax.random.PRNGKey(0), cfg))
    n = len([k for k in inp if k.startswith("lm/")])
    params = jax.tree.unflatten(treedef, [jnp.asarray(inp[f"lm/{i}"]) for i in range(n)])
    mesh = mesh_of(lm["mesh"])
    prompts = jnp.asarray(inp["prompts"])
    B, S = prompts.shape
    caches = tf.init_cache(cfg, B, S + lm["gen"])
    with mesh:
        prefill = jax.jit(lambda p, t, c: tf.prefill(p, t, cfg, c, mesh=mesh))
        decode = jax.jit(lambda p, t, c, i: tf.decode_step(p, t, cfg, c, i, mesh=mesh))
        logits, caches = prefill(params, prompts, caches)
        out["lm/prefill"] = np.asarray(logits)
        tok = jnp.argmax(logits, -1)[:, None].astype(jnp.int32)
        toks = [tok]
        for s in range(lm["gen"] - 1):
            logits, caches = decode(params, tok, caches, jnp.int32(S + s))
            out[f"lm/decode{s}"] = np.asarray(logits)
            tok = jnp.argmax(logits, -1)[:, None].astype(jnp.int32)
            toks.append(tok)
    out["lm/tokens"] = np.asarray(jnp.concatenate(toks, 1))
    for i, c in enumerate(caches["prefix"]):
        for k, v in c.items():
            out[f"lm/cache/{i}/{k}"] = np.asarray(v)
    for k, v in caches["layers"].items():
        for j in range(v.shape[0]):
            out[f"lm/cache/{len(caches['prefix']) + j}/{k}"] = np.asarray(v[j])
    np.savez(sys.argv[3], **out)
"""


class _ReferenceSharded:
    """The subprocess running ``_REFERENCE_SCRIPT``; ``get(key)`` waits for
    it (at most ``timeout`` s) and returns the array."""

    def __init__(self, tmp: Path, inputs: dict, timeout: float = 400.0):
        self.timeout = timeout
        self.path = tmp / "reference.npz"
        flat = {}
        for name, case in inputs["moe"].items():
            flat[f"x/{name}"] = case["x"]
            for k, v in case["params"].items():
                flat[f"moe/{name}/{k}"] = v
        for i, leaf in enumerate(jax.tree.leaves(inputs["lm_tree"])):
            flat[f"lm/{i}"] = leaf
        flat["prompts"] = inputs["prompts"]
        np.savez(tmp / "inputs.npz", **flat)
        lm_cfg = dataclasses.asdict(LM_CFG)
        spec = {"meshes": MESHES,
                "moe": {name: (shape, ba, ea, dataclasses.asdict(_cfg(f)))
                        for name, (shape, ba, ea, f) in MOE_CASES.items()},
                "lm": {"cfg": lm_cfg, "mesh": LM_MESH, "gen": LM_GEN}}
        import json
        self.proc = subprocess.Popen(
            [sys.executable, "-c", textwrap.dedent(_REFERENCE_SCRIPT), json.dumps(spec),
             str(tmp / "inputs.npz"), str(self.path)],
            stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True,
            env=forced_host_device_env(8))
        self.data = None

    def get(self, key: str) -> np.ndarray:
        if self.data is None:
            out, err = self.proc.communicate(timeout=self.timeout)
            assert self.proc.returncode == 0, f"stdout:\n{out}\nstderr:\n{err[-4000:]}"
            with np.load(self.path) as z:
                self.data = dict(z)
        return self.data[key]

    def close(self):
        if self.proc.poll() is None:
            self.proc.kill()
        self.proc.communicate()


@pytest.fixture(scope="module")
def inputs():
    moe_inputs = {name: _moe_inputs(i, _cfg(f))
                  for i, (name, (_, _, _, f)) in enumerate(MOE_CASES.items())}
    prompts = np.random.default_rng(6).integers(0, LM_CFG.vocab, (LM_B, LM_S)).astype(np.int32)
    return {"moe": moe_inputs, "lm_tree": _lm_tree(), "prompts": prompts}


@pytest.fixture(scope="module", autouse=True)
def ref_sharded(tmp_path_factory, inputs):
    """Started by the module's first test, so that it runs beside the cases
    that need no reference run (those that do come last)."""
    ref = _ReferenceSharded(tmp_path_factory.mktemp("moe_mesh"), inputs)
    yield ref
    ref.close()


@pytest.fixture(scope="module")
def pools(ref_sharded):
    with PoolKeeper(8, threads=1, timeout_s=60.0) as keeper:
        yield keeper


@pytest.fixture
def pool(pools):
    """The module's pool, or a fresh one after a case whose run broke it."""
    return pools.get()


# --------------------------------------------------------------------------
# the ranks' parts (pickled to the spawned ranks by import path)
# --------------------------------------------------------------------------

def _mesh(shape):
    pods, n_data, n_model = shape
    n = max(pods, 1) * n_data * n_model
    return make_debug_mesh(n_data, n_model, pods=pods, ranks=tuple(range(n)), device="cpu")


def _moe_rank(group, shape, batch_axes, expert_axis, fields, case, use_kernels):
    """One rank's sharded MoE: its rows of y, aux, and (at TP = 1) the
    per-shard ``_moe_core`` of its tokens with the whole parameters."""
    mesh = _mesh(shape)
    if mesh is None:
        return None
    cfg = _cfg(fields)
    ep, ei, tp, ti = moe.mesh_shards(mesh, batch_axes, expert_axis)
    full = {k: torch.from_numpy(v) for k, v in case["params"].items()}
    p = {k: v.contiguous() for k, v in moe.shard_moe_params(full, cfg, ep, ei, tp, ti).items()}
    nb, bi = mesh.axis_size(batch_axes), mesh.axis_index(batch_axes)
    n = T // nb
    x = torch.from_numpy(case["x"][bi * n:(bi + 1) * n])
    y, aux = moe.moe_ffn(p, x, cfg, mesh=mesh, batch_axes=batch_axes, expert_axis=expert_axis,
                         use_kernels=use_kernels)
    out = {"coords": mesh.coords, "rows": (bi * n, (bi + 1) * n), "y": y.numpy(),
           "aux": float(aux), "tp": tp}
    if tp == 1:
        engine = moe.select_dispatch_engine(cfg, n)
        out["core"] = moe._moe_core(x, full, cfg, engine, use_kernels)[0].numpy()
    return out


def _one_rank(group, fields, case, use_kernels):
    """A one-rank mesh against the call without one, on rank 0."""
    mesh = make_debug_mesh(1, 1, ranks=(0,), device="cpu")
    if mesh is None:
        return None
    cfg = _cfg(fields)
    p = {k: torch.from_numpy(v) for k, v in case["params"].items()}
    x = torch.from_numpy(case["x"])
    y1, aux1 = moe.moe_ffn(p, x, cfg, mesh=mesh, batch_axes=("data",), use_kernels=use_kernels)
    y0, aux0 = moe.moe_ffn(p, x, cfg, use_kernels=use_kernels)
    return torch.equal(y1, y0) and torch.equal(aux1, aux0)


def _lm_rank(group, tree, prompts, use_kernels, ref_tokens):
    """One rank of reduced deepseek on the (2, 2) mesh: prefill, two decode
    steps fed the reference's greedy tokens, and ``generate``."""
    mesh = _mesh(LM_MESH)
    if mesh is None:
        return None
    model = convert.transformer_params(tree, LM_CFG, device="cpu", mesh=mesh)
    rows = transformer.batch_shard(torch.from_numpy(prompts), mesh)
    B, S = rows.shape
    caches = transformer.init_cache(LM_CFG, B, S + LM_GEN, "cpu")
    logits, caches = transformer.prefill(model, rows, caches, use_kernels=use_kernels,
                                         mesh=mesh)
    toks = transformer.batch_shard(torch.from_numpy(ref_tokens), mesh)
    steps = []
    for s in range(LM_GEN - 1):
        step, caches = transformer.decode_step(model, toks[:, s:s + 1], caches, S + s,
                                               use_kernels=use_kernels, mesh=mesh)
        steps.append(step.numpy())
    gen = serve.generate(model, rows, LM_GEN, use_kernels=use_kernels, mesh=mesh)
    n = LM_B // mesh.axis_size(("data",))
    i = mesh.axis_index(("data",))
    return {"rows": (i * n, (i + 1) * n), "prefill": logits.numpy(), "steps": steps,
            "caches": [{k: v.numpy() for k, v in c.items()} for c in caches["layers"]],
            "tokens": gen["tokens"].numpy(), "all_tokens": gen["all_tokens"].numpy(),
            "launches": gen["launches"], "exchange": gen["exchange"],
            "experts": tuple(model.layers[1].moe["w_gate"].shape)}


def _uneven_rank(group):
    """Ranks 0-3 of a (4, 1) mesh, rank 3 with one token fewer: every rank
    raises ``ValueError`` before any exchange."""
    mesh = _mesh((0, 4, 1))
    if mesh is None:
        return None
    cfg = _cfg(dict(n_shared=0))
    p = moe.init_moe(torch.Generator().manual_seed(0), D_MODEL, cfg)
    p = moe.shard_moe_params(p, cfg, 4, mesh.axis_index("data"), 1, 0)
    x = torch.randn((8 - (mesh.rank == 3), D_MODEL))
    try:
        moe.moe_ffn(p, x, cfg, mesh=mesh, batch_axes=("data",))
    except ValueError as e:
        return str(e)
    return "no error"


# --------------------------------------------------------------------------
# 1. without the reference run
# --------------------------------------------------------------------------

@pytest.mark.parametrize("use_kernels", [False, True], ids=["plain", "kernels"])
@pytest.mark.parametrize("name", ["d22_sorted_s1", "d41_gather_s1_cf16", "d41_sorted_chunked"])
def test_one_rank_mesh_is_bit_equal(pool, inputs, name, use_kernels):
    """A one-rank mesh runs the exchange as a copy: bit-equal to the call
    without a mesh (the kernel route's layout at EP = 1 is
    ``_grouped_ffn``'s)."""
    out = pool.run(_one_rank, MOE_CASES[name][3], inputs["moe"][name], use_kernels)
    assert out[0] is True and all(o is None for o in out[1:])


def test_drops_happen(inputs):
    """The ``capacity_factor`` 1.25 cases drop assignments on some shard, so
    per-shard capacity matters (the single-device call on all tokens drops
    others)."""
    dropped = {}
    for name, (shape, batch_axes, _, fields) in MOE_CASES.items():
        if fields.get("capacity_factor", 1.25) != 1.25 or fields.get("chunk_tokens"):
            continue
        cfg = _cfg(fields)
        nb = int(np.prod([dict(zip(("pod", "data"), shape[:2]))[a] for a in batch_axes]))
        case = inputs["moe"][name]
        n = T // nb
        total = 0
        for b in range(nb):
            x = torch.from_numpy(case["x"][b * n:(b + 1) * n])
            ids = moe._route(x, torch.from_numpy(case["params"]["router"]), cfg)[0].reshape(-1)
            C = moe._capacity(n * cfg.top_k, cfg.n_experts, cfg.capacity_factor)
            total += int((~moe._slots_sorted(ids, cfg.n_experts, C)[1]).sum())
        dropped[name] = total
    assert all(v > 0 for v in dropped.values()), dropped


def test_sharded_equals_per_shard_core_at_tp1(pool, inputs):
    """At TP = 1 the sharded function is ``_moe_core`` on each shard's
    tokens with the whole parameters (the reference's identity, measured
    to 1.2e-6): bit-equal on the plain route, within ``MOE_TOL`` on the
    kernel route's plain version."""
    for name in ("d41_sorted_s0", "d41_sorted_chunked", "p222_ep_data"):
        shape, ba, ea, fields = MOE_CASES[name]
        if name == "p222_ep_data":
            shape = (2, 2, 1)
        for use_kernels in (False, True):
            outs = [o for o in pool.run(_moe_rank, shape, ba, ea, fields, inputs["moe"][name],
                                        use_kernels) if o is not None]
            for o in outs:
                assert o["tp"] == 1
                if use_kernels:
                    np.testing.assert_allclose(o["y"], o["core"], rtol=MOE_TOL, atol=MOE_TOL)
                else:
                    np.testing.assert_array_equal(o["y"], o["core"])


def test_uneven_token_counts_raise_on_every_rank(pool):
    out = pool.run(_uneven_rank)
    assert all("same count" in o for o in out[:4]), out
    assert all(o is None for o in out[4:])


def test_guards_fire_with_assertions_disabled(tmp_path):
    """The guards are raised exceptions: under ``python -O`` the dense
    engine on a mesh, an axis the mesh lacks, experts or widths that do not
    split, shards of the wrong shape, a batch that does not split, a model
    on another layout and ranks with different token counts all raise
    ``ValueError``."""
    helper = tmp_path / "moe_mesh_guard_helper.py"
    helper.write_text(textwrap.dedent('''
        import torch
        from repro_torch.launch.mesh import make_debug_mesh
        from repro_torch.models import moe

        def uneven(group):
            mesh = make_debug_mesh(2, 1, device="cpu")
            cfg = moe.MoEConfig(n_experts=4, top_k=2, d_ff=8, dispatch="sorted")
            p = moe.shard_moe_params(moe.init_moe(torch.Generator(), 16, cfg), cfg, 2,
                                     mesh.rank, 1, 0)
            try:
                moe.moe_ffn(p, torch.randn(4 + mesh.rank, 16), cfg, mesh=mesh,
                            batch_axes=("data",))
            except ValueError:
                return True
            return False
    '''))
    script = f"""
        import sys
        sys.path.insert(0, {str(tmp_path)!r})
        import tempfile, torch
        import torch.distributed as dist
        from repro_torch.configs import get_arch
        from repro_torch.configs.common import reduce_lm_config
        from repro_torch.launch.mesh import ModelMesh, RankPool, make_debug_mesh
        from repro_torch.models import moe, transformer
        import moe_mesh_guard_helper

        def expect(fn):
            try:
                fn()
            except ValueError:
                return
            raise SystemExit(f"guard did not fire: {{fn}}")

        if __name__ == "__main__":
            with RankPool(2, threads=1) as pool:
                assert pool.run(moe_mesh_guard_helper.uneven) == [True, True]
            dist.init_process_group("gloo", init_method="file://" + tempfile.mktemp(),
                                    rank=0, world_size=1)
            mesh = make_debug_mesh(1, 1, device="cpu")
            cfg = moe.MoEConfig(n_experts=6, top_k=2, d_ff=12, n_shared=1, dispatch="sorted")
            p = moe.init_moe(torch.Generator(), 16, cfg)
            x = torch.randn(10, 16)
            expect(lambda: moe.moe_ffn(p, x, cfg.replace(dispatch="dense"), mesh=mesh,
                                       batch_axes=("data",)))
            expect(lambda: moe.moe_ffn(p, x, cfg, mesh=mesh))        # no "pod" axis
            expect(lambda: moe.moe_ffn(p, x, cfg, mesh=mesh, batch_axes=("data",),
                                       tp_axis="data"))
            expect(lambda: moe.moe_ffn({{**p, "w_up": p["w_up"][:3]}}, x, cfg, mesh=mesh,
                                       batch_axes=("data",)))
            expect(lambda: moe.shard_shapes(16, cfg, ep=4))          # E % EP
            expect(lambda: moe.shard_shapes(16, cfg, tp=5))          # F % TP
            expect(lambda: moe.shard_shapes(16, cfg.replace(d_ff_shared=7), tp=2))
            wide = ModelMesh(axis_names=("data", "model"), shape=(4, 1), coords=(1, 0), rank=1,
                             group=None, host_group=None, groups={{}},
                             device=torch.device("cpu"))
            expect(lambda: transformer.batch_shard(torch.zeros(6, 3), wide))   # B % EP
            lm = reduce_lm_config(get_arch("deepseek-v2-lite-16b"))
            model = transformer.init_transformer(lm, torch.Generator(), "cpu")
            expect(lambda: transformer.Transformer(lm, torch.device("meta"), wide,
                                                   batch_axes=("pod",)))
            shard = transformer.shard_transformer(model, wide)
            expect(lambda: transformer.forward(shard, torch.zeros((1, 3), dtype=torch.long)))
            expect(lambda: make_debug_mesh(1, 1, ranks=(0, 0), device="cpu"))
            dist.destroy_process_group()
            print("GUARDS-OK", __debug__)
    """
    src = Path(__file__).resolve().parents[1] / "src"
    out = subprocess.run([sys.executable, "-O", "-c", textwrap.dedent(script)],
                         capture_output=True, text=True, timeout=120, cwd=tmp_path,
                         env={**os.environ, "PYTHONPATH": str(src)})
    assert out.returncode == 0 and "GUARDS-OK False" in out.stdout, out.stderr[-3000:]


def test_shard_transformer_shares_and_slices():
    """``shard_transformer`` keeps the replicated tensors (the same storage)
    and slices each MoE layer's experts and shared width; ``serve_config``
    counts a rank's share and still refuses kimi-k2 at full depth on any
    mesh one host can form."""
    from repro_torch.launch.mesh import ModelMesh

    lm = LM_CFG
    model = transformer.init_transformer(lm, torch.Generator().manual_seed(0), "cpu")
    mesh = ModelMesh(axis_names=("data", "model"), shape=(2, 2), coords=(1, 0), rank=2,
                     group=None, host_group=None, groups={}, device=torch.device("cpu"))
    shard = transformer.shard_transformer(model, mesh)
    assert shard.shards == (2, 1, 2, 0)
    assert shard.embed.data_ptr() == model.embed.data_ptr()
    E, F = lm.moe.n_experts // 2, lm.moe.d_ff // 2
    w = shard.layers[1].moe["w_gate"]
    assert w.shape == (E, lm.d_model, F)
    assert torch.equal(w, model.layers[1].moe["w_gate"][E:, :, :F])
    assert shard.layers[1].moe["shared_down"].shape == (lm.moe.shared_hidden // 2, lm.d_model)
    full = serve.lm_param_count(lm)
    part = serve.lm_param_count(lm, mesh)
    experts = sum(3 * lm.moe.n_experts * lm.d_model * lm.moe.d_ff for _ in
                  range(lm.n_scan_layers))
    shared = sum(3 * lm.moe.shared_hidden * lm.d_model for _ in range(lm.n_scan_layers))
    assert full - part == experts * 3 // 4 + shared // 2   # EP = TP = 2
    eight = ModelMesh(axis_names=("data", "model"), shape=(8, 1), coords=(0, 0), rank=0,
                      group=None, host_group=None, groups={}, device=torch.device("cpu"))
    with pytest.raises(NotImplementedError, match="one rank of a 8x1 mesh"):
        serve.serve_config("kimi-k2-1t-a32b", reduced=False, mesh=eight)
    assert serve.serve_config("deepseek-v2-lite-16b", reduced=False, mesh=eight).n_layers == 27


def test_init_transformer_draws_unchanged():
    """``init_transformer`` casts each expert draw into its parameter before
    the next: the same weights as ``init_moe``'s dict."""
    lm = LM_CFG
    model = transformer.init_transformer(lm, torch.Generator().manual_seed(3), "cpu")
    g = torch.Generator().manual_seed(3)
    from repro_torch.models.attention import init_mla
    init_mla(g, lm.d_model, lm.n_heads, lm.mla, torch.float32)
    for name in ("w_gate", "w_up", "w_down"):   # the dense layer's FFN
        torch.randn(model.layers[0].ffn[name].shape, generator=g)
    init_mla(g, lm.d_model, lm.n_heads, lm.mla, torch.float32)
    want = moe.init_moe(g, lm.d_model, lm.moe, torch.float32)
    for name, w in want.items():
        assert torch.equal(model.layers[1].moe[name], w), name


# --------------------------------------------------------------------------
# 2. against the reference's sharded runs (these wait for the subprocess)
# --------------------------------------------------------------------------

def test_rank_coordinates_match_jax_make_mesh(pool, ref_sharded):
    """Rank r of the port's mesh sits where ``make_debug_mesh`` puts device r
    (row-major)."""
    for name, shape in MESHES.items():
        got = [c for c in pool.run(_coords_rank, shape) if c is not None]
        devices = ref_sharded.get(name + "/devices")[0]
        dims = shape if shape[0] else shape[1:]
        want = [tuple(int(i) for i in np.argwhere(devices.reshape(dims) == r)[0])
                for r in range(len(got))]
        assert got == want, name


def _coords_rank(group, shape):
    m = _mesh(shape)
    return None if m is None else m.coords


@pytest.mark.parametrize("use_kernels", [False, True], ids=["plain", "kernels"])
@pytest.mark.parametrize("name", list(MOE_CASES))
def test_moe_mesh_matches_reference(pool, inputs, ref_sharded, name, use_kernels):
    shape, ba, ea, fields = MOE_CASES[name]
    outs = [o for o in pool.run(_moe_rank, shape, ba, ea, fields, inputs["moe"][name],
                                use_kernels) if o is not None]
    assert len(outs) == max(shape[0], 1) * shape[1] * shape[2]
    want_y = ref_sharded.get(name + "/y")
    want_aux = float(ref_sharded.get(name + "/aux"))
    for o in outs:
        lo, hi = o["rows"]
        np.testing.assert_allclose(o["y"], want_y[lo:hi], rtol=MOE_TOL, atol=MOE_TOL)
        assert abs(o["aux"] - want_aux) <= AUX_TOL, (o["aux"], want_aux)


@pytest.fixture(scope="module")
def lm_runs(pools, inputs, ref_sharded):
    ref_tokens = ref_sharded.get("lm/tokens")
    return {use: [o for o in pools.get().run(_lm_rank, inputs["lm_tree"], inputs["prompts"], use,
                                      ref_tokens) if o is not None]
            for use in (False, True)}


@pytest.mark.parametrize("use_kernels", [False, True], ids=["plain", "kernels"])
def test_lm_prefill_and_decode_match_reference(lm_runs, ref_sharded, use_kernels):
    """Reduced deepseek at (2, 2): each rank's prefill logits, caches and two
    decode steps against the reference's mesh runs, rows split by rank;
    each rank holds E/2 experts at half width."""
    outs = lm_runs[use_kernels]
    assert len(outs) == 4
    E, F = LM_CFG.moe.n_experts // 2, LM_CFG.moe.d_ff // 2
    for o in outs:
        lo, hi = o["rows"]
        assert o["experts"] == (E, LM_CFG.d_model, F)
        np.testing.assert_allclose(o["prefill"], ref_sharded.get("lm/prefill")[lo:hi],
                                   rtol=LM_TOL, atol=LM_TOL)
        for s, step in enumerate(o["steps"]):
            np.testing.assert_allclose(step, ref_sharded.get(f"lm/decode{s}")[lo:hi],
                                       rtol=LM_TOL, atol=LM_TOL)
        for i, cache in enumerate(o["caches"]):
            for k, v in cache.items():
                np.testing.assert_allclose(v, ref_sharded.get(f"lm/cache/{i}/{k}")[lo:hi],
                                           rtol=LM_TOL, atol=LM_TOL, err_msg=f"{i}/{k}")


@pytest.mark.parametrize("use_kernels", [False, True], ids=["plain", "kernels"])
def test_lm_generate_over_mesh(lm_runs, ref_sharded, use_kernels):
    """``generate(mesh=)``: the gathered tokens equal the reference's greedy
    tokens on every rank, each rank's own rows are its slice, the CPU
    launches nothing, and each prefill and decode step ran its exchanges
    (dispatch and return on both routes, the counts on the kernel route,
    the TP reduce)."""
    want = ref_sharded.get("lm/tokens")
    n_moe = LM_CFG.n_scan_layers
    for o in lm_runs[use_kernels]:
        lo, hi = o["rows"]
        np.testing.assert_array_equal(o["all_tokens"], want)
        np.testing.assert_array_equal(o["tokens"], want[lo:hi])
        zero = {"flash_attention": 0, "grouped_matmul": 0}
        assert o["launches"] == {"prefill": zero, "decode": zero}
        kinds = {"dispatch", "return", "tp_reduce"} | ({"counts"} if use_kernels else set())
        for phase, steps in (("prefill", 1), ("decode", LM_GEN - 1)):
            ex = o["exchange"][phase]
            assert set(ex) == kinds and all(ex[k]["calls"] == n_moe * steps for k in kinds)
            assert all(ex[k]["ms"] is None for k in kinds)   # CPU tensors: no device events
