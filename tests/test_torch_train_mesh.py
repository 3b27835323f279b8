"""Training over a model mesh: the port's train step on DTensor
placements (``dist.sharding``, ``launch.mesh.device_mesh``) against the
reference's single-device step, the sharded cross entropy, the elastic
restore across mesh shapes, and the pod-major layout, on four gloo ranks
on the CPU (the counterparts of ``tests/test_distributed.py``'s
``test_lm_train_step_on_debug_mesh``, ``test_sharded_ce_matches_unsharded``
and ``test_checkpoint_elastic_reshard``).

One pool of 4 ranks serves the module (a ``launch.mesh.RankPool`` through
``PoolKeeper``: this process is rank 0, three spawned ranks with one
thread each).  The reference runs its single-device step in this process
on the same weights (its ``init_transformer`` through ``convert``) and
the same seeded tokens.

Tolerances: the loss within 1e-5 relative (the reference's test holds
1e-4 absolute) and every updated parameter within 1e-5 of its leaf's
largest |value| (float32 sums in another order: the sharded products,
the all-reduced gradients and the global norm, hazard (d)); the sharded
cross entropy within 1e-5 of the unsharded; the elastic restore and the
layouts exact.
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from repro.models import attention as jax_attention
from repro.models import transformer as jax_tf
from repro.train.optimizer import OptimizerConfig as JaxOptimizerConfig
from repro.train.train_step import init_train_state as jax_init_train_state
from repro.train.train_step import make_train_step as jax_make_train_step
from repro_torch import convert
from repro_torch.launch.mesh import PoolKeeper, device_mesh, make_debug_mesh
from repro_torch.models import attention
from test_torch_train_models import _get, _jax_cfg

from repro_torch.configs import get_arch
from repro_torch.configs.common import reduce_lm_config
from repro_torch.models.transformer import TransformerConfig

LOSS_TOL = 1e-5
PARAM_TOL = 1e-5
CE_TOL = 1e-5
MICROBATCHES = 2
# the reference test's tiny LM: 4 KV heads and a 128-token vocabulary, so
# heads and the embedding shard over a model axis of 2 or 4
CFG = TransformerConfig(name="t", n_layers=2, d_model=64, n_heads=4, n_kv_heads=4, d_head=16,
                        d_ff=128, vocab=128, dtype="float32", param_dtype="float32")
OPT = dict(name="adamw", learning_rate=1e-3, warmup_steps=0, schedule="constant")
MESH_SHAPES = {"2x2": (2, 2), "1x4": (1, 4), "4x1": (4, 1)}


# reduced deepseek-v2-lite (MLA, a dense first layer, then MoE layers of 8
# experts, top 2, at the reduction's capacity 4): its train step on a mesh
# against the reference's jitted step on the same forced mesh
MOE_CFG = reduce_lm_config(get_arch("deepseek-v2-lite-16b").model_config)
MOE_MESHES = {"2x2": (2, 2), "4x1": (4, 1)}

_MOE_REFERENCE = """
    import dataclasses, json, sys
    import jax, jax.numpy as jnp
    import numpy as np
    assert len(jax.devices()) == 4
    from jax.sharding import NamedSharding, PartitionSpec as P
    from repro.launch.mesh import make_debug_mesh
    from repro.models import transformer as tf
    from repro.models.attention import MLAConfig
    from repro.models.moe import MoEConfig
    from repro.dist.sharding import lm_rule, tree_shardings, batch_axes
    from repro.train.optimizer import OptimizerConfig
    from repro.train.train_step import init_train_state, make_train_step

    spec = json.loads(sys.argv[1])
    kw = dict(spec["cfg"])
    kw["mla"], kw["moe"] = MLAConfig(**kw["mla"]), MoEConfig(**kw["moe"])
    kw["window_pattern"] = tuple(kw["window_pattern"])
    cfg = tf.TransformerConfig(**kw)
    oc = OptimizerConfig(**spec["opt"])
    params = tf.init_transformer(jax.random.PRNGKey(0), cfg)
    toks = jnp.asarray(np.load(sys.argv[2]))
    out = {}
    for name, shape in spec["meshes"].items():
        mesh = make_debug_mesh(*shape)
        ba = batch_axes(mesh)
        step = make_train_step(
            lambda p, b: tf.lm_loss(p, b["tokens"], cfg, mesh=mesh, batch_axes=ba), oc)
        state = init_train_state(params, oc)
        st_sh = tree_shardings(state, mesh, lm_rule(mesh))
        b_sh = {"tokens": NamedSharding(mesh, P(ba, None))}
        with mesh:
            new_state, metrics = jax.jit(step, in_shardings=(st_sh, b_sh))(
                state, {"tokens": toks})
        out[name + "/loss"] = np.asarray(metrics["loss"])
        out[name + "/grad_norm"] = np.asarray(metrics["grad_norm"])
        for i, leaf in enumerate(jax.tree.leaves(new_state.params)):
            out[f"{name}/{i}"] = np.asarray(leaf)
    np.savez(sys.argv[3], **out)
"""


def _moe_tree_and_tokens():
    tree = jax.tree.map(np.asarray, jax_tf.init_transformer(jax.random.PRNGKey(0),
                                                            _jax_cfg(MOE_CFG)))
    tokens = np.random.default_rng(2).integers(0, MOE_CFG.vocab, (8, 17)).astype(np.int32)
    return tree, tokens


@pytest.fixture(scope="module")
def moe_reference(tmp_path_factory):
    """The reference's mesh steps, one forced-4-device subprocess started
    with the module's pool; ``get()`` waits for it."""
    import dataclasses
    import json
    import subprocess
    import sys
    import textwrap

    from repro.launch.mesh import forced_host_device_env

    tmp = tmp_path_factory.mktemp("moe_train_mesh")
    _, tokens = _moe_tree_and_tokens()
    np.save(tmp / "tokens.npy", tokens)
    spec = {"cfg": dataclasses.asdict(MOE_CFG), "opt": OPT, "meshes": MOE_MESHES}
    proc = subprocess.Popen(
        [sys.executable, "-c", textwrap.dedent(_MOE_REFERENCE), json.dumps(spec),
         str(tmp / "tokens.npy"), str(tmp / "out.npz")],
        stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True,
        env=forced_host_device_env(4))
    data = {}

    def get():
        if not data:
            out, err = proc.communicate(timeout=500)
            assert proc.returncode == 0, f"stdout:\n{out}\nstderr:\n{err[-4000:]}"
            with np.load(tmp / "out.npz") as z:
                data.update(z)
        return data

    yield get
    if proc.poll() is None:
        proc.kill()
    proc.communicate()


@pytest.fixture(scope="module")
def pools(moe_reference):
    with PoolKeeper(4, threads=1, timeout_s=60.0) as keeper:
        yield keeper


@pytest.fixture
def pool(pools):
    return pools.get()


def _quiet():
    import logging
    import warnings

    logging.getLogger("torch.distributed").setLevel(logging.ERROR)
    logging.getLogger("torch.distributed.tensor").setLevel(logging.ERROR)
    warnings.filterwarnings("ignore")


BLOCKS = {"plain": (attention._FLASH_THRESHOLD, attention._Q_BLOCK, attention._KV_BLOCK),
          "blocked": (1, 8, 16)}   # the blocked route at any size, in blocks of 8 and 16


def _set_blocks(route: str) -> None:
    """The route in a rank (a spawned rank keeps module state between
    runs, so every run sets it)."""
    attention._FLASH_THRESHOLD, attention._Q_BLOCK, attention._KV_BLOCK = BLOCKS[route]


def _tree_and_tokens():
    tree = jax.tree.map(np.asarray, jax_tf.init_transformer(jax.random.PRNGKey(0),
                                                            _jax_cfg(CFG)))
    tokens = np.random.default_rng(1).integers(0, CFG.vocab, (8, 17)).astype(np.int32)
    return tree, tokens


def _step_rank(group, shape, tree, tokens, route):
    """One step of ``make_train_step`` on a (data, model) mesh: (loss,
    grad_norm, each reference leaf's updated value, every rank agreeing)."""
    _quiet()
    from torch.distributed.tensor import distribute_tensor

    from repro_torch.dist.sharding import (distribute, lm_batch_spec, lm_rule, placements,
                                           tree_shardings)
    from repro_torch.models.transformer import lm_loss
    from repro_torch.train.optimizer import OptimizerConfig
    from repro_torch.train import train_step as ts

    _set_blocks(route)
    mesh = make_debug_mesh(*shape, device="cpu")
    dm = device_mesh(mesh)
    opt = OptimizerConfig(**OPT)
    model = convert.transformer_params(tree, CFG, device="cpu")
    state = ts.init_train_state(model, opt, device="cpu")
    state = distribute(state, dm, tree_shardings(state, mesh, lm_rule(mesh)))
    batch = distribute_tensor(torch.from_numpy(tokens).long(), dm,
                              placements(lm_batch_spec(mesh), 2, dm), src_data_rank=None)
    step = ts.make_train_step(lambda m, b: lm_loss(m, b, mesh=mesh), opt,
                              microbatches=MICROBATCHES)
    state, metrics = step(state, batch)
    named = dict(state.params.named_parameters())
    out = {}
    for lf in state.leaves:
        parts = [named[m].full_tensor().detach().numpy() for m in lf.members]
        out[lf.name] = np.stack(parts) if lf.stacked else parts[0]
    placed = {n: str(p.placements) for n, p in named.items()}
    return float(metrics["loss"]), float(metrics["grad_norm"]), out, placed


def _reference_step(tree, tokens):
    jcfg = _jax_cfg(CFG)
    oc = JaxOptimizerConfig(**OPT)
    params = jax.tree.map(jnp.asarray, tree)
    step = jax.jit(jax_make_train_step(lambda p, b: jax_tf.lm_loss(p, b["tokens"], jcfg), oc,
                                       microbatches=MICROBATCHES))
    new_state, metrics = step(jax_init_train_state(params, oc), {"tokens": jnp.asarray(tokens)})
    return float(metrics["loss"]), float(metrics["grad_norm"]), new_state.params


@pytest.mark.parametrize("route", ["plain", "blocked"])
@pytest.mark.parametrize("mesh_name", sorted(MESH_SHAPES))
def test_train_step_on_a_mesh_matches_the_reference(pool, mesh_name, route, monkeypatch):
    """The train step (AdamW, 2 microbatches, remat) on a (2, 2), (1, 4) or
    (4, 1) mesh: the loss, the grad norm and every updated parameter
    against the reference's jitted single-device step; every rank returns
    the same values.  ``blocked`` lowers both packages' threshold and
    blocks so that attention runs the blocked core under ``local_map``."""
    tree, tokens = _tree_and_tokens()
    for mod in (attention, jax_attention):
        for key, value in zip(("_FLASH_THRESHOLD", "_Q_BLOCK", "_KV_BLOCK"), BLOCKS[route]):
            monkeypatch.setattr(mod, key, value)
    want_loss, want_norm, want = _reference_step(tree, tokens)
    results = pool.run(_step_rank, MESH_SHAPES[mesh_name], tree, tokens, route)
    loss, norm, got, placed = results[0]
    for other in results[1:]:
        assert other[0] == loss and other[1] == norm
        for name, a in other[2].items():
            np.testing.assert_array_equal(a, got[name], err_msg=name)
    assert abs(loss - want_loss) <= LOSS_TOL * abs(want_loss), (loss, want_loss)
    assert abs(norm - want_norm) <= LOSS_TOL * abs(want_norm), (norm, want_norm)
    for name, a in got.items():
        ref = np.asarray(_get(want, name))
        bound = PARAM_TOL * float(np.abs(ref).max())
        err = float(np.abs(a - ref).max())
        assert err <= bound, (mesh_name, name, err, bound)
    n_model = MESH_SHAPES[mesh_name][1]
    if n_model > 1:
        assert "Shard(dim=1)" in placed["layers.0.attn.wq"]
        assert "Shard(dim=0)" in placed["embed"]


def _moe_step_rank(group, shape, tree, tokens):
    """One step of ``make_train_step`` of reduced deepseek on a (data,
    model) mesh: (loss, grad_norm, each reference leaf's updated value)."""
    _quiet()
    from torch.distributed.tensor import distribute_tensor

    from repro_torch.dist.sharding import (distribute, lm_batch_spec, lm_rule, placements,
                                           tree_shardings)
    from repro_torch.models.transformer import lm_loss
    from repro_torch.train.optimizer import OptimizerConfig
    from repro_torch.train import train_step as ts

    _set_blocks("plain")   # a spawned rank keeps an earlier case's blocked route
    mesh = make_debug_mesh(*shape, device="cpu")
    dm = device_mesh(mesh)
    opt = OptimizerConfig(**OPT)
    model = convert.transformer_params(tree, MOE_CFG, device="cpu")
    state = ts.init_train_state(model, opt, device="cpu")
    state = distribute(state, dm, tree_shardings(state, mesh, lm_rule(mesh)))
    batch = distribute_tensor(torch.from_numpy(tokens).long(), dm,
                              placements(lm_batch_spec(mesh), 2, dm), src_data_rank=None)
    step = ts.make_train_step(lambda m, b: lm_loss(m, b, mesh=mesh), opt)
    state, metrics = step(state, batch)
    named = dict(state.params.named_parameters())
    out = {}
    for lf in state.leaves:
        parts = [named[m].full_tensor().detach().numpy() for m in lf.members]
        out[lf.name] = np.stack(parts) if lf.stacked else parts[0]
    return float(metrics["loss"]), float(metrics["grad_norm"]), out


@pytest.mark.parametrize("mesh_name", sorted(MOE_MESHES))
def test_moe_train_step_on_a_mesh_matches_the_reference(pool, moe_reference, mesh_name):
    """Reduced deepseek-v2-lite's train step (AdamW, remat) on a (2, 2) mesh
    (EP 2, TP 2) and a (4, 1) mesh (EP 4): the loss, the grad norm and every
    updated parameter against the reference's jitted step on the same
    forced mesh (each shard sizing its own capacity, aux the shards'
    mean); every rank returns the same values."""
    tree, tokens = _moe_tree_and_tokens()
    results = pool.run(_moe_step_rank, MOE_MESHES[mesh_name], tree, tokens)
    loss, norm, got = results[0]
    for other in results[1:]:
        assert other[0] == loss and other[1] == norm
    ref = moe_reference()
    want_loss = float(ref[mesh_name + "/loss"])
    want_norm = float(ref[mesh_name + "/grad_norm"])
    assert abs(loss - want_loss) <= LOSS_TOL * abs(want_loss), (loss, want_loss)
    assert abs(norm - want_norm) <= LOSS_TOL * abs(want_norm), (norm, want_norm)
    leaves, treedef = jax.tree.flatten(tree)
    want = jax.tree.unflatten(treedef, [ref[f"{mesh_name}/{i}"] for i in range(len(leaves))])
    for name, a in got.items():
        ref_leaf = np.asarray(_get(want, name))
        bound = PARAM_TOL * float(np.abs(ref_leaf).max())
        err = float(np.abs(a - ref_leaf).max())
        assert err <= bound, (mesh_name, name, err, bound)


def _ce_rank(group, logits, labels):
    _quiet()
    from torch.distributed.tensor import distribute_tensor

    from repro_torch.dist.sharding import P, implicit_replication, placements
    from repro_torch.models.common import cross_entropy_loss

    mesh = make_debug_mesh(2, 2, device="cpu")
    dm = device_mesh(mesh)
    lg = distribute_tensor(torch.from_numpy(logits), dm, placements(P("data", "model"), 2, dm),
                           src_data_rank=None)
    lb = distribute_tensor(torch.from_numpy(labels), dm, placements(P("data"), 1, dm),
                           src_data_rank=None)
    from torch.distributed.tensor.debug import CommDebugMode

    with implicit_replication():
        plain_labels = cross_entropy_loss(lg, torch.from_numpy(labels))
        with CommDebugMode() as comm:
            sharded_labels = cross_entropy_loss(lg, lb)
    kinds = sorted(str(k) for k in comm.get_comm_counts())
    return float(plain_labels.full_tensor()), float(sharded_labels.full_tensor()), kinds


def test_sharded_cross_entropy_matches_unsharded(pool):
    """Logits (16, 64) sharded over data and model (the vocabulary split:
    the masked sum and the max reduce over the model axis), labels plain or
    sharded over data, against the unsharded loss; with sharded labels the
    loss runs reductions only (DTensor's ``CommDebugMode``), no gather."""
    from repro_torch.models.common import cross_entropy_loss

    rng = np.random.default_rng(0)
    logits = rng.standard_normal((16, 64)).astype(np.float32)
    labels = rng.integers(0, 64, 16).astype(np.int64)
    base = float(cross_entropy_loss(torch.from_numpy(logits), torch.from_numpy(labels)))
    for plain, sharded, kinds in pool.run(_ce_rank, logits, labels):
        assert abs(base - plain) < CE_TOL and abs(base - sharded) < CE_TOL, (base, plain, sharded)
        # the max and the sums reduce; nothing gathers the (16, 64) logits
        assert kinds and not any("gather" in k for k in kinds), kinds


def _ce_grad_rank(group, logits, labels, mask):
    _quiet()
    from torch.distributed.tensor import distribute_tensor

    from repro_torch.dist.sharding import P, implicit_replication, placements
    from repro_torch.models.common import cross_entropy_loss

    mesh = make_debug_mesh(2, 2, device="cpu")
    dm = device_mesh(mesh)
    lg = distribute_tensor(torch.from_numpy(logits), dm, placements(P("data", "model"), 2, dm),
                           src_data_rank=None).requires_grad_(True)
    lb = distribute_tensor(torch.from_numpy(labels), dm, placements(P("data"), 1, dm),
                           src_data_rank=None)
    mk = None if mask is None else distribute_tensor(
        torch.from_numpy(mask), dm, placements(P("data"), 1, dm), src_data_rank=None)
    with implicit_replication():
        loss = cross_entropy_loss(lg, lb, mk)
        loss.backward()
    return float(loss.full_tensor()), lg.grad.full_tensor().numpy()


@pytest.mark.parametrize("masked", [False, True], ids=["mean", "masked"])
def test_sharded_cross_entropy_gradients_match_unsharded(pool, masked):
    """The gradient of the loss of logits split over the vocabulary (the
    local ``onehot - softmax`` of ``models.common._VocabParallelLL``)
    against the unsharded loss's, within 1e-5 of its largest; a label
    outside the vocabulary contributes no logit."""
    from repro_torch.models.common import cross_entropy_loss

    rng = np.random.default_rng(2)
    logits = rng.standard_normal((16, 64)).astype(np.float32)
    labels = rng.integers(0, 64, 16).astype(np.int64)
    labels[3] = 70
    mask = (rng.random(16) < 0.7).astype(np.float32) if masked else None
    x = torch.from_numpy(logits).requires_grad_(True)
    want = cross_entropy_loss(x, torch.from_numpy(labels),
                              None if mask is None else torch.from_numpy(mask))
    want.backward()
    for loss, grad in pool.run(_ce_grad_rank, logits, labels, mask):
        assert abs(loss - float(want)) <= CE_TOL, (loss, float(want))
        bound = CE_TOL * float(x.grad.abs().max())
        assert float(np.abs(grad - x.grad.numpy()).max()) <= bound


def _elastic_rank(group, tree, directory):
    """Save a placed train state and an (8, 8) leaf on (2, 2), restore both
    onto (1, 4) and onto (4, 1): whole values and the new placements."""
    _quiet()
    from torch.distributed.tensor import distribute_tensor

    from repro_torch.dist.sharding import P, distribute, lm_rule, placements, tree_shardings
    from repro_torch.train import train_step as ts
    from repro_torch.train.checkpoint import restore_checkpoint, save_checkpoint
    from repro_torch.train.optimizer import OptimizerConfig

    m1 = make_debug_mesh(2, 2, device="cpu")
    dm1 = device_mesh(m1)
    x = torch.arange(64.0).reshape(8, 8)
    spec = {"w": P("data", "model")}
    small = distribute({"w": x}, dm1, spec)
    state = ts.init_train_state(convert.transformer_params(tree, CFG, device="cpu"),
                                OptimizerConfig(**OPT), device="cpu")
    state.opt_state["m"]["embed"].normal_(generator=torch.Generator().manual_seed(3))
    state = distribute(state, dm1, tree_shardings(state, m1, lm_rule(m1)))
    saved = {n: p.full_tensor().clone() for n, p in state.params.named_parameters()}
    saved_m = {n: t.full_tensor().clone() for n, t in state.opt_state["m"].items()}
    save_checkpoint(f"{directory}/small", 1, small, mesh=m1)
    save_checkpoint(f"{directory}/state", 7, state, mesh=m1)
    out = {}
    for shape in ((1, 4), (4, 1)):
        m2 = make_debug_mesh(*shape, device="cpu")
        dm2 = device_mesh(m2)
        step, restored = restore_checkpoint(f"{directory}/small", small, shardings=spec,
                                            device_mesh=dm2)
        w = restored["w"]
        ok = (step == 1 and w.device_mesh is dm2 and w.placements == tuple(placements(
            spec["w"], 2, dm2)) and torch.equal(w.full_tensor(), x))
        step, st = restore_checkpoint(f"{directory}/state", state,
                                      shardings=tree_shardings(state, m2, lm_rule(m2)),
                                      device_mesh=dm2)
        named = dict(st.params.named_parameters())
        ok = ok and step == 7 and st.step == 0 and all(
            named[n].device_mesh is dm2 and torch.equal(named[n].full_tensor(), v)
            for n, v in saved.items())
        ok = ok and all(torch.equal(st.opt_state["m"][n].full_tensor(), v)
                        for n, v in saved_m.items())
        out[shape] = (ok, str(named["layers.0.attn.wq"].placements))
        state = st
    return out


def test_elastic_restore_across_mesh_shapes(pool, tmp_path):
    tree, _ = _tree_and_tokens()
    results = pool.run(_elastic_rank, tree, str(tmp_path))
    for out in results:
        assert all(ok for ok, _ in out.values()), out
        # wq's columns over ``model``, a split in four on (1, 4) and in one on (4, 1)
        assert out[(1, 4)][1] == out[(4, 1)][1] == "(Replicate(), Shard(dim=1))"


def _pod_rank(group):
    _quiet()
    from repro_torch.dist.sharding import P, distribute
    from repro_torch.models.transformer import batch_shard

    mesh = make_debug_mesh(2, 1, pods=2, device="cpu")
    dm = device_mesh(mesh)
    x = torch.arange(8 * 3).reshape(8, 3)
    placed = distribute({"x": x}, dm, {"x": P(("pod", "data"), None)})["x"]
    return (mesh.coords, mesh.axis_index(("pod", "data")), placed.to_local().clone(),
            batch_shard(x, mesh, ("pod", "data")))


def test_pod_major_layout(pool):
    """``P(("pod", "data"), None)`` on a (2, 2, 1) pod mesh: the rank at
    (pod p, data d) holds row block ``2 p + d`` (the reference's pod-major
    split), the same rows ``batch_shard`` gives a serving rank."""
    x = torch.arange(8 * 3).reshape(8, 3)
    for rank, (coords, index, local, served) in enumerate(pool.run(_pod_rank)):
        p, d, _ = coords
        assert index == 2 * p + d == rank
        assert torch.equal(local, x[2 * index:2 * index + 2])
        assert torch.equal(local, served)
