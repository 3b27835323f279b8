"""The port's training substrate against the reference on the same inputs:
the data pipelines, the schedule, the three optimizers, clipping,
compression and the train step (``repro_torch.data`` and
``repro_torch.train`` against ``repro.data`` and ``repro.train``), and the
kernels' refusal of a gradient.

Inputs are numpy draws from fixed seeds; both packages get the same arrays.
The reference's trees stack scan layers on axis 0; the port holds one
tensor a layer, grouped by ``train.optimizer.Leaf`` (hazard (a)).

Tolerances.  Pipelines and compression: bit for bit (the same NumPy draws;
elementwise float32 around a max or a selection).  The schedule, the
optimizers' states and parameters, and the global norm: within 1e-6 of the
largest value of each leaf (``pow``, ``cos`` and ``mean`` may round the
last bit differently in XLA and in PyTorch; the port adds per parameter,
the reference per stacked leaf, hazard (d)).  Train steps: parameters
within 1e-6 of each leaf's largest after three steps.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import repro.train.optimizer as jopt
import repro_torch.train.optimizer as topt
from repro.data import pipeline as jpipe
from repro.train import compression as jcomp
from repro.train import train_step as jstep
from repro_torch.data import pipeline as tpipe
from repro_torch.kernels.embedding_bag.ops import embedding_bag
from repro_torch.kernels.flash_attention.ops import flash_attention
from repro_torch.kernels.frontier_compact.ops import frontier_compact, frontier_compact_lanes
from repro_torch.kernels.grouped_matmul.ops import grouped_matmul
from repro_torch.kernels.hyb_gather.ops import hyb_gather
from repro_torch.kernels.segment_spmm.ops import segment_spmm, segment_spmm_lanes
from repro_torch.train import compression as tcomp
from repro_torch.train import train_step as tstep
from repro_torch.train.optimizer import Leaf

# the reference's tree: a factored leaf, an unfactored one, an unstacked
# 3-D leaf (chunkable over its own axis 0), a stacked 3-D leaf of 4 layers
# (chunkable over the layers) and a stacked 1-D leaf of 32 layers (factored
# across the layers: its column statistic spans every member)
SHAPES = {"w": (64, 48), "b": (48,), "experts": (4, 12, 40),
          "layers": {"wq": (4, 40, 36)}, "stack": {"ln": (32, 40)}}
STACKED = {"layers.wq": 4, "stack.ln": 32}


def _paths(tree=SHAPES, prefix=""):
    for k, v in tree.items():
        name = f"{prefix}.{k}" if prefix else k
        if isinstance(v, dict):
            yield from _paths(v, name)
        else:
            yield name, v


def _get(tree, name):
    for k in name.split("."):
        tree = tree[k]
    return tree


def _ref_tree(rng, scale=1.0):
    out = {}
    for name, shape in _paths():
        node = out
        *head, last = name.split(".")
        for k in head:
            node = node.setdefault(k, {})
        node[last] = (rng.standard_normal(shape) * scale).astype(np.float32)
    return out


def _members(name):
    if name in STACKED:
        head, last = name.split(".")
        return tuple(f"{head}.{i}.{last}" for i in range(STACKED[name]))
    return (name,)


LEAVES = tuple(Leaf(name, _members(name), stacked=name in STACKED) for name, _ in _paths())


def _to_port(tree) -> dict:
    """The reference's tree as the port's name -> tensor dict."""
    out = {}
    for lf in LEAVES:
        a = np.asarray(_get(tree, lf.name))
        parts = list(a) if lf.stacked else [a]
        for m, part in zip(lf.members, parts):
            out[m] = torch.from_numpy(np.array(part))
    return out


def _leaf_of(port: dict, lf: Leaf) -> np.ndarray:
    parts = [port[m].detach().numpy() for m in lf.members]
    return np.stack(parts) if lf.stacked else parts[0]


def _close(got, want, tol=1e-6, what=""):
    want = np.asarray(want)
    got = np.asarray(got)
    assert got.shape == want.shape, (what, got.shape, want.shape)
    bound = tol * max(float(np.abs(want).max()), 1e-30)
    err = float(np.abs(got - want).max()) if want.size else 0.0
    assert err <= bound, (what, err, bound)


# ------------------------------------------------------------------ data

@pytest.mark.parametrize("kind", ["lm", "graph", "recsys"])
def test_pipelines_are_bit_equal(kind):
    """Every pipeline's batches equal the reference's for several (seed,
    step, shard)."""
    make = {
        "lm": lambda m: m.LMBatches(vocab=1000, batch=16, seq_len=33, seed=5, n_shards=4),
        "graph": lambda m: m.GraphBatches(n_nodes=5000, batch_nodes=64, n_classes=7, seed=3,
                                          n_shards=2),
        "recsys": lambda m: m.RecSysBatches(vocab_sizes=(100, 3, 5000), batch=32, multi_hot=2,
                                            seed=9),
    }[kind]
    ref, port = make(jpipe), make(tpipe)
    for step, shard in ((0, 0), (3, 1), (17, 0), (1000, 1)):
        a, b = ref.make(step, shard), port.make(step, shard)
        assert a.keys() == b.keys()
        for k in a:
            assert a[k].dtype == b[k].dtype
            np.testing.assert_array_equal(a[k], b[k])


@pytest.mark.parametrize("arch", ["internlm2-1.8b", "granite-20b", "gemma3-12b",
                                  "deepseek-v2-lite-16b", "kimi-k2-1t-a32b", "graphsage-reddit",
                                  "pna", "gatedgcn", "meshgraphnet", "dlrm-mlperf"])
def test_each_arch_has_the_reference_optimizer(arch):
    import importlib

    from repro.configs import ARCHS as JARCHS
    from repro_torch.configs import ARCHS

    want = importlib.import_module(JARCHS[arch]).OPT
    got = importlib.import_module(ARCHS[arch]).OPT
    assert dataclasses.asdict(got) == dataclasses.asdict(want)


# ------------------------------------------------------------- schedule

@pytest.mark.parametrize("schedule", ["cosine", "linear", "constant"])
def test_learning_rate_schedules_hazard_b(schedule):
    """Hazard (b): the schedule in float32 on 0-dim tensors, at step 0, the
    end of warmup, the middle and the end (and past it)."""
    cfg = dict(learning_rate=3e-4, warmup_steps=20, total_steps=100, schedule=schedule)
    jc, tc = jopt.OptimizerConfig(**cfg), topt.OptimizerConfig(**cfg)
    for step in (0, 7, 20, 60, 99, 100, 150):
        want = float(jopt.learning_rate(jc, jnp.int32(step)))
        got = topt.learning_rate(tc, step)
        assert got.dtype == torch.float32 and got.dim() == 0
        assert abs(float(got) - want) <= 1e-6 * abs(want) + 1e-12, (step, float(got), want)


# ------------------------------------------------------------ optimizers

def _check_state(cfg_name, jstate, tstate):
    for lf in LEAVES:
        if cfg_name == "adafactor":
            want, got = _get(jstate["f"], lf.name), tstate["f"][lf.name]
            assert set(want) == set(got), lf.name
            for k in want:
                _close(got[k].numpy(), want[k], what=f"{lf.name}.{k}")
        else:
            for key in ("momentum",) if cfg_name == "sgd" else ("m", "v"):
                _close(tstate[key][lf.name].numpy(), _get(jstate[key], lf.name),
                       what=f"{key}.{lf.name}")


@pytest.mark.parametrize("chunked", [False, True], ids=["whole", "chunked"])
@pytest.mark.parametrize("name", ["adamw", "adafactor", "sgd"])
def test_optimizer_updates_match_hazard_a(name, chunked, monkeypatch):
    """Hazard (a): three updates of a tree with a factored, an unfactored,
    an unstacked 3-D and two stacked leaves; states and parameters after
    each.  ``chunked`` sets ``_CHUNKED_LEAF_ELEMS`` low in both packages,
    so the 3-D leaves are updated (and Adafactor's update clipped) slice by
    slice; otherwise over the whole stacked leaf."""
    if chunked:
        monkeypatch.setattr(jopt, "_CHUNKED_LEAF_ELEMS", 16)
        monkeypatch.setattr(topt, "_CHUNKED_LEAF_ELEMS", 16)
    rng = np.random.default_rng(0)
    params = _ref_tree(rng)
    cfg = dict(name=name, learning_rate=1e-2, warmup_steps=2, total_steps=10)
    jc, tc = jopt.OptimizerConfig(**cfg), topt.OptimizerConfig(**cfg)
    jp = jax.tree.map(jnp.asarray, params)
    js = jopt.init_opt_state(jc, jp)
    tp = _to_port(params)
    ts = topt.init_opt_state(tc, tp, LEAVES)
    _check_state(name, js, ts)
    for step in range(3):
        grads = _ref_tree(rng, scale=0.1 * (step + 1))
        jp, js = jopt.apply_updates(jc, jp, jax.tree.map(jnp.asarray, grads), js,
                                    jnp.int32(step))
        topt.apply_updates(tc, tp, _to_port(grads), ts, step, LEAVES)
        _check_state(name, js, ts)
        for lf in LEAVES:
            _close(_leaf_of(tp, lf), _get(jp, lf.name), what=f"step {step} {lf.name}")


def test_clip_by_global_norm_hazard_d():
    """Hazard (d): the global norm and the clipped gradients agree to
    rounding (the order of the per-leaf sums differs)."""
    rng = np.random.default_rng(1)
    grads = _ref_tree(rng)
    jg, jn = jopt.clip_by_global_norm(jax.tree.map(jnp.asarray, grads), 1.0)
    tg, tn = topt.clip_by_global_norm(_to_port(grads), 1.0)
    assert abs(float(tn) - float(jn)) <= 1e-6 * float(jn)
    for lf in LEAVES:
        _close(_leaf_of(tg, lf), _get(jg, lf.name), what=lf.name)
    # no clipping below the bound: the gradients are untouched
    small = _ref_tree(np.random.default_rng(2), scale=1e-4)
    out, _ = topt.clip_by_global_norm(_to_port(small), 1e9)
    for lf in LEAVES:
        np.testing.assert_array_equal(_leaf_of(out, lf), _get(small, lf.name))


# ------------------------------------------------------------ compression

@pytest.mark.parametrize("ef", [True, False], ids=["ef", "no_ef"])
@pytest.mark.parametrize("kind", ["int8", "topk"])
def test_compression_bit_equal_hazard_a(kind, ef):
    """Hazard (a): int8's scale and top-k's threshold over a whole stacked
    leaf; wire gradients and residuals bit-equal over three rounds, and
    ``wire_bytes`` equal."""
    rng = np.random.default_rng(3)
    cfg = dict(kind=kind, topk_fraction=0.05, error_feedback=ef)
    jc, tc = jcomp.CompressionConfig(**cfg), tcomp.CompressionConfig(**cfg)
    params = _ref_tree(rng)
    je = jcomp.init_error_state(jax.tree.map(jnp.asarray, params))
    te = tcomp.init_error_state(_to_port(params), LEAVES)
    for _ in range(3):
        grads = _ref_tree(rng)
        jw, je = jcomp.compress_grads(jc, jax.tree.map(jnp.asarray, grads), je)
        tw, te = tcomp.compress_grads(tc, _to_port(grads), te, LEAVES)
        for lf in LEAVES:
            np.testing.assert_array_equal(_leaf_of(tw, lf), np.asarray(_get(jw, lf.name)))
            np.testing.assert_array_equal(te[lf.name].numpy(), np.asarray(_get(je, lf.name)))
    assert tcomp.wire_bytes(tc, _to_port(params), LEAVES) == jcomp.wire_bytes(
        jc, jax.tree.map(jnp.asarray, params))


# ------------------------------------------------------------- train step

N_LAYERS = 4


def _step_tree(rng):
    return {"w": (rng.standard_normal((16, 16)) * 0.3).astype(np.float32),
            "b": np.zeros(16, np.float32),
            "layers": {"u": (rng.standard_normal((N_LAYERS, 16, 16)) * 0.3).astype(np.float32)}}


STEP_LEAVES = (Leaf("w", ("w",)), Leaf("b", ("b",)),
               Leaf("layers.u", tuple(f"layers.{i}.u" for i in range(N_LAYERS)), stacked=True))


def _ref_loss(p, batch):
    h = batch["x"] @ p["w"] + p["b"]
    for i in range(N_LAYERS):
        h = jnp.tanh(h @ p["layers"]["u"][i])
    return jnp.mean(jnp.square(h - batch["y"]))


def _port_loss(p, batch):
    h = batch["x"] @ p["w"] + p["b"]
    for i in range(N_LAYERS):
        h = torch.tanh(h @ p[f"layers.{i}.u"])
    return (h - batch["y"]).square().mean()


def _step_batch(rng):
    x = rng.standard_normal((8, 16)).astype(np.float32)
    return {"x": x, "y": np.tanh(x[:, ::-1] * 0.5).astype(np.float32)}


def _port_params(tree):
    return {"w": torch.from_numpy(tree["w"].copy()), "b": torch.from_numpy(tree["b"].copy()),
            **{f"layers.{i}.u": torch.from_numpy(tree["layers"]["u"][i].copy())
               for i in range(N_LAYERS)}}


@pytest.mark.parametrize("name,mb,comp", [
    ("adamw", 1, "none"), ("adamw", 4, "none"), ("adamw", 4, "int8"),
    ("adafactor", 1, "topk"), ("sgd", 2, "int8"),
], ids=lambda v: str(v))
def test_train_step_matches_hazard_e(name, mb, comp):
    """Hazard (e): microbatches split the batch, their gradients accumulate
    and are divided by their count; clip, compress, update.  Parameters,
    the loss and the grad norm after three steps agree with the
    reference's."""
    rng = np.random.default_rng(4)
    tree = _step_tree(rng)
    oc = dict(name=name, learning_rate=5e-2, warmup_steps=1, total_steps=6, grad_clip=0.5)
    cc = dict(kind=comp, topk_fraction=0.2)
    jcc = None if comp == "none" else jcomp.CompressionConfig(**cc)
    tcc = None if comp == "none" else tcomp.CompressionConfig(**cc)
    jst = jstep.init_train_state(jax.tree.map(jnp.asarray, tree), jopt.OptimizerConfig(**oc),
                                 jcc)
    # init_train_state's state, with the stacked leaf of the reference's tree
    # (its default makes each parameter of a dict a leaf of its own)
    params = {k: v.requires_grad_(True) for k, v in _port_params(tree).items()}
    tst = tstep.TrainState(
        params=params, opt_state=topt.init_opt_state(topt.OptimizerConfig(**oc), params,
                                                     STEP_LEAVES),
        error_state=None if tcc is None else tcomp.init_error_state(params, STEP_LEAVES),
        step=0, leaves=STEP_LEAVES)
    jfn = jstep.make_train_step(_ref_loss, jopt.OptimizerConfig(**oc), jcc, microbatches=mb)
    tfn = tstep.make_train_step(_port_loss, topt.OptimizerConfig(**oc), tcc, microbatches=mb)
    for _ in range(3):
        batch = _step_batch(rng)
        jst, jm = jfn(jst, jax.tree.map(jnp.asarray, batch))
        tst, tm = tfn(tst, {k: torch.from_numpy(v) for k, v in batch.items()})
        assert abs(float(tm["loss"]) - float(jm["loss"])) <= 1e-6 * float(jm["loss"])
        assert abs(float(tm["grad_norm"]) - float(jm["grad_norm"])) <= 1e-6 * float(
            jm["grad_norm"])
    assert tst.step == int(jst.step) == 3
    for lf in STEP_LEAVES:
        _close(_leaf_of(tst.params, lf), _get(jst.params, lf.name), what=lf.name)


# ----------------------------------------- the reference's own properties

@pytest.fixture
def quad():
    rng = np.random.default_rng(0)
    x = torch.from_numpy(rng.standard_normal((8, 64)).astype(np.float32))
    y = x @ (0.5 * torch.eye(64))
    params = {"w": torch.ones((64, 64)), "b": torch.zeros(64)}

    def loss_fn(p, batch):
        return (batch["x"] @ p["w"] + p["b"] - batch["y"]).square().mean()

    return params, loss_fn, {"x": x, "y": y}


@pytest.mark.parametrize("name,lr,factor", [
    ("adamw", 1e-2, 0.1), ("adafactor", 1e-2, 0.1), ("sgd", 1e-2, 0.75),
])
def test_optimizers_reduce_loss(name, lr, factor, quad):
    params, loss_fn, batch = quad
    oc = topt.OptimizerConfig(name=name, learning_rate=lr, warmup_steps=0, schedule="constant")
    st = tstep.init_train_state(params, oc, device="cpu")
    step = tstep.make_train_step(loss_fn, oc)
    with torch.no_grad():
        l0 = float(loss_fn(st.params, batch))
    for _ in range(120):
        st, m = step(st, batch)
    assert float(m["loss"]) < factor * l0


def test_microbatch_equals_full_batch(quad):
    params, loss_fn, batch = quad
    oc = topt.OptimizerConfig(learning_rate=1e-2, warmup_steps=0, schedule="constant",
                              grad_clip=1e9)
    s1 = tstep.init_train_state({k: v.clone() for k, v in params.items()}, oc, device="cpu")
    s2 = tstep.init_train_state({k: v.clone() for k, v in params.items()}, oc, device="cpu")
    s1, _ = tstep.make_train_step(loss_fn, oc)(s1, batch)
    s2, _ = tstep.make_train_step(loss_fn, oc, microbatches=4)(s2, batch)
    d = max(float((s1.params[k] - s2.params[k]).detach().abs().max()) for k in s1.params)
    assert d < 1e-5


def test_accumulation_in_another_dtype_hazard_e():
    """Hazard (e): with bfloat16 accumulation over float32 parameters the
    port casts each microbatch's gradients and adds them into bf16
    buffers, as the reference does."""
    rng = np.random.default_rng(5)
    tree = _step_tree(rng)
    batch = _step_batch(rng)
    oc = dict(learning_rate=1e-2, warmup_steps=0, schedule="constant", grad_clip=1e9)
    jfn = jstep.make_train_step(_ref_loss, jopt.OptimizerConfig(**oc), microbatches=4,
                                accum_dtype=jnp.bfloat16)
    jst = jstep.init_train_state(jax.tree.map(jnp.asarray, tree), jopt.OptimizerConfig(**oc))
    jst, jm = jfn(jst, jax.tree.map(jnp.asarray, batch))
    loss, grads = tstep.value_and_grads(
        _port_loss, {k: v.requires_grad_(True) for k, v in _port_params(tree).items()},
        {k: torch.from_numpy(v) for k, v in batch.items()}, 4, torch.bfloat16)
    assert all(g.dtype == torch.bfloat16 for g in grads.values())
    want = jax.grad(lambda p: _ref_loss(p, jax.tree.map(jnp.asarray, batch)))(
        jax.tree.map(jnp.asarray, tree))
    for lf in STEP_LEAVES:
        got = np.stack([grads[m].float().numpy() for m in lf.members]) if lf.stacked else \
            grads[lf.members[0]].float().numpy()
        _close(got, np.asarray(_get(want, lf.name)), tol=2e-2, what=lf.name)
    assert abs(float(loss) - float(jm["loss"])) <= 1e-6 * float(jm["loss"])


def test_chunked_leaf_update_matches_unchunked(monkeypatch):
    params = {"w": torch.ones((8, 16, 16))}
    grads = {"w": torch.full((8, 16, 16), 0.1)}
    for name in ("adamw", "adafactor"):
        oc = topt.OptimizerConfig(name=name, learning_rate=1e-2, warmup_steps=0,
                                  schedule="constant")
        p1 = {"w": params["w"].clone()}
        topt.apply_updates(oc, p1, grads, topt.init_opt_state(oc, p1), 0)
        monkeypatch.setattr(topt, "_CHUNKED_LEAF_ELEMS", 16)   # the slice-by-slice path
        p2 = {"w": params["w"].clone()}
        topt.apply_updates(oc, p2, grads, topt.init_opt_state(oc, p2), 0)
        monkeypatch.undo()
        assert torch.allclose(p1["w"], p2["w"], atol=1e-6)


@pytest.mark.parametrize("kind", ["int8", "topk"])
def test_compression_error_feedback_unbiased(kind, quad):
    params, loss_fn, batch = quad
    cc = tcomp.CompressionConfig(kind=kind, topk_fraction=0.25)
    err = tcomp.init_error_state(params)
    p = {k: v.clone().requires_grad_(True) for k, v in params.items()}
    loss_fn(p, batch).backward()
    g = {k: v.grad for k, v in p.items()}
    total_wire = {k: torch.zeros_like(v) for k, v in g.items()}
    for _ in range(10):
        wire, err = tcomp.compress_grads(cc, g, err)
        for k in g:
            total_wire[k] += wire[k]
    resid = max(float((total_wire[k] + err[k] - 10.0 * g[k]).abs().max()) for k in g)
    assert resid < 1e-3
    assert tcomp.wire_bytes(cc, g) < tcomp.wire_bytes(tcomp.CompressionConfig(kind="none"), g)


def test_compressed_training_converges(quad):
    params, loss_fn, batch = quad
    oc = topt.OptimizerConfig(learning_rate=1e-2, warmup_steps=0, schedule="constant")
    cc = tcomp.CompressionConfig(kind="int8")
    st = tstep.init_train_state(params, oc, cc, device="cpu")
    step = tstep.make_train_step(loss_fn, oc, cc)
    for _ in range(60):
        st, m = step(st, batch)
    assert float(m["loss"]) < 5.0


def test_init_train_state_checks_the_device():
    """Every parameter must live on the device; the default device is the
    card, which this machine may lack."""
    oc = topt.OptimizerConfig()
    with pytest.raises(ValueError, match="lives on cpu"):
        tstep.init_train_state({"w": torch.ones(3)}, oc, device="meta")
    st = tstep.init_train_state({"w": torch.ones(3)}, oc, device="cpu")
    assert st.params["w"].requires_grad and st.step == 0


# --------------------------------------------------- kernels refuse grad

def _wrapper_calls():
    f = torch.zeros(6, requires_grad=True)
    ids = torch.zeros(6, dtype=torch.int32)
    mask = torch.ones(6, dtype=torch.bool)
    offsets = torch.tensor([0, 3, 6], dtype=torch.int64)
    q = torch.zeros((2, 4, 8), requires_grad=True)
    return {
        "segment_spmm": lambda: segment_spmm(f, ids, 2),
        "segment_spmm_lanes": lambda: segment_spmm_lanes(f, ids, offsets, 2),
        "frontier_compact": lambda: frontier_compact([f], mask),
        "frontier_compact_lanes": lambda: frontier_compact_lanes([f], mask, offsets),
        "hyb_gather": lambda: hyb_gather([f], torch.zeros(1, dtype=torch.int32),
                                         torch.ones(1, dtype=torch.int32)),
        "flash_attention": lambda: flash_attention(q, q.detach(), q.detach()),
        "embedding_bag": lambda: embedding_bag(torch.zeros((5, 4), requires_grad=True),
                                               torch.zeros((2, 1), dtype=torch.int32)),
        "grouped_matmul": lambda: grouped_matmul(
            torch.zeros((4, 8)), torch.zeros((2, 8, 3), requires_grad=True),
            torch.tensor([0, 2], dtype=torch.int32), torch.tensor([2, 2], dtype=torch.int32)),
    }


@pytest.mark.parametrize("name", list(_wrapper_calls()))
def test_kernel_wrappers_refuse_a_gradient(name):
    """No kernel has a backward: under grad mode with an input that requires
    grad, every public wrapper raises before its device dispatch (so on the
    CPU too); under ``no_grad`` it runs its plain version."""
    call = _wrapper_calls()[name]
    with pytest.raises(RuntimeError, match="no backward"):
        call()
    with torch.no_grad():
        call()


def test_async_writers_serialise_on_the_write_lock(tmp_path):
    """Two async writers of one directory serialise on the write lock: both
    steps commit and no ``.tmp`` stays behind."""
    from repro_torch.train.checkpoint import latest_steps, save_checkpoint

    tree = {"w": torch.arange(1000.0)}
    threads = [save_checkpoint(str(tmp_path), s, tree, async_write=True, keep=5)
               for s in (1, 2, 3)]
    for t in threads:
        t.join(timeout=60)
        assert not t.is_alive()
    assert latest_steps(str(tmp_path)) == [1, 2, 3]
    assert not [p for p in tmp_path.iterdir() if p.name.endswith(".tmp")]
