"""The port's training losses and their gradients against the reference's
``jax.value_and_grad`` on the same weights and inputs: ``lm_loss`` (dense
and MoE, with the aux loss), ``gnn_loss`` for the four architectures and
``graphsage_minibatch_forward``, ``dlrm_loss``, and the cross entropy;
then the reference's stacked-leaf optimizer and compression on an LM's
real leaves (hazard (a)).

Weights come from the reference's own initialisers (``init_transformer``,
``init_gnn``, ``init_dlrm`` with a ``PRNGKey``) through ``convert``;
tokens, features, labels and ids from seeded numpy generators.

Tolerances.  float32: the loss within 1e-5 relative, each gradient leaf
within 1e-5 of that leaf's largest |grad| for the LM (float32 sums in
another order through two to three layers), 1e-4 for the GNNs (float32
scatters and products through up to three layers, as
``tests/test_torch_gnn.py`` holds their outputs).  bf16 activations: the
loss within 2e-2 relative and each leaf within 4e-2 of its largest, about
ten bf16 units in the last place (2^-8): at these sizes the reference's own
bf16 gradients lie up to 3.0e-2 of a leaf's largest from the float64
gradients (the port's float64 run on the same weights), and the port's
and the reference's bf16 gradients up to 2.05e-2 from each other
(``tests/bf16_gradient_spread.py`` prints them).  A
parameter that does not reach the loss (GatedGCN's last edge branch) has
no ``.grad`` in the port and a zero gradient in the reference.  Hazards (c), (f) and (h) are exact
or bit-equal where the arithmetic is the same (a masked sum, an equal
split of a tie, a recomputation of the same ops).
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import repro.train.optimizer as jopt
import repro_torch.train.optimizer as topt
from repro.models import attention as jax_attention
from repro.models import common as jax_common
from repro.models import dlrm as jax_dlrm
from repro.models import gnn as jax_gnn
from repro.models import moe as jax_moe
from repro.models import transformer as jax_tf
from repro.train import compression as jcomp
from repro_torch import convert
from repro_torch.configs import get_arch
from repro_torch.configs.common import reduce_dlrm_config, reduce_lm_config
from repro_torch.models import common, dlrm, gnn, transformer
from repro_torch.train import compression as tcomp
from repro_torch.train.train_step import named_params, param_leaves

F32 = 1e-5
BF16_LOSS = 2e-2
BF16 = 4e-2
GNN = 1e-4


def _np(x):
    return np.asarray(x)


def _jax_cfg(cfg):
    kw = {f.name: getattr(cfg, f.name) for f in dataclasses.fields(cfg)}
    if cfg.mla is not None:
        kw["mla"] = jax_attention.MLAConfig(**dataclasses.asdict(cfg.mla))
    if cfg.moe is not None:
        kw["moe"] = jax_moe.MoEConfig(**dataclasses.asdict(cfg.moe))
    return jax_tf.TransformerConfig(**kw)


def _get(tree, name):
    for k in name.split("."):
        tree = tree[int(k)] if isinstance(tree, (list, tuple)) else tree[k]
    return tree


def _leaf_close(got, want, tol, what):
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    assert got.shape == want.shape, (what, got.shape, want.shape)
    bound = tol * max(float(np.abs(want).max()), 1e-30)
    err = float(np.abs(got - want).max())
    assert err <= bound, (what, err, bound)


def _lm_case(kind: str, dtype: str):
    """(port config, reference tree as numpy) of a small LM."""
    if kind == "dense":
        cfg = reduce_lm_config(get_arch("internlm2-1.8b")).replace(n_layers=2)
    else:
        # kimi's family reduced: GQA, one dense prefix layer, sorted dispatch;
        # capacity 1.0 so that assignments are dropped
        cfg = reduce_lm_config(get_arch("kimi-k2-1t-a32b"))
        cfg = cfg.replace(moe=cfg.moe.replace(capacity_factor=1.0))
    cfg = cfg.replace(dtype=dtype)
    tree = jax.tree.map(np.asarray, jax_tf.init_transformer(jax.random.PRNGKey(7), _jax_cfg(cfg)))
    return cfg, tree


def _port_model(cfg, tree):
    model = convert.transformer_params(tree, cfg, device="cpu")
    for p in model.parameters():
        p.requires_grad_(True)
    return model


def _port_grads_by_leaf(model):
    named = named_params(model)
    out = {}
    for lf in param_leaves(model):
        parts = [named[m].grad.float().numpy() for m in lf.members]
        out[lf.name] = np.stack(parts) if lf.stacked else parts[0]
    return out


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("kind", ["dense", "moe"])
def test_lm_loss_and_every_gradient_match(kind, dtype):
    cfg, tree = _lm_case(kind, dtype)
    tokens = np.random.default_rng(3).integers(0, cfg.vocab, (2, 17)).astype(np.int32)
    jcfg = _jax_cfg(cfg)
    want, jg = jax.jit(jax.value_and_grad(
        lambda p: jax_tf.lm_loss(p, jnp.asarray(tokens), jcfg)))(jax.tree.map(jnp.asarray, tree))
    model = _port_model(cfg, tree)
    loss = transformer.lm_loss(model, torch.from_numpy(tokens))
    loss.backward()
    tol = F32 if dtype == "float32" else BF16
    assert abs(float(loss) - float(want)) <= min(tol, BF16_LOSS) * abs(float(want))
    got = _port_grads_by_leaf(model)
    assert len(got) == len(jax.tree.leaves(jg))
    for name, g in got.items():
        _leaf_close(g, _get(jg, name), tol, name)


def test_lm_loss_moe_aux_is_in_the_loss():
    """The MoE aux enters the loss as ``w * aux / n_scan_layers``: with the
    weight raised the port's loss moves exactly as the reference's."""
    cfg, tree = _lm_case("moe", "float32")
    cfg = cfg.replace(moe=cfg.moe.replace(aux_loss_weight=0.5))
    tokens = np.random.default_rng(4).integers(0, cfg.vocab, (2, 9)).astype(np.int32)
    want = float(jax_tf.lm_loss(jax.tree.map(jnp.asarray, tree), jnp.asarray(tokens),
                                _jax_cfg(cfg)))
    got = float(transformer.lm_loss(_port_model(cfg, tree), torch.from_numpy(tokens)))
    assert abs(got - want) <= F32 * abs(want)


def test_lm_loss_above_the_plain_threshold_raises():
    """Above 2048 x 2048 scores the reference attends blocked with its own
    FlashAttention-2 backward; the port refuses, naming item 17c."""
    cfg, tree = _lm_case("dense", "float32")
    model = _port_model(cfg, tree)
    with pytest.raises(NotImplementedError, match="17c"):
        transformer.lm_loss(model, torch.zeros((1, 2050), dtype=torch.int32))


def test_remat_recomputes_the_same_routes_hazard_h():
    """Hazard (h): a MoE layer recomputed under activation checkpointing
    routes and drops as its first pass did, so the loss and every gradient
    with ``remat`` equal those without, bit for bit."""
    cfg, tree = _lm_case("moe", "float32")
    tokens = torch.from_numpy(
        np.random.default_rng(5).integers(0, cfg.vocab, (2, 17)).astype(np.int32))
    grads = {}
    for remat in (True, False):
        c = cfg.replace(remat=remat)
        model = _port_model(c, tree)
        loss = transformer.lm_loss(model, tokens)
        loss.backward()
        grads[remat] = (float(loss), _port_grads_by_leaf(model))
    assert grads[True][0] == grads[False][0]
    for name, g in grads[True][1].items():
        np.testing.assert_array_equal(g, grads[False][1][name], err_msg=name)


@pytest.mark.parametrize("chunked", [False, True], ids=["whole", "chunked"])
def test_lm_adafactor_and_int8_on_stacked_leaves_hazard_a(chunked, monkeypatch):
    """Hazard (a) on a real LM: the reference's gradients of a 4-layer
    dense LM, int8-compressed and applied by Adafactor, in the reference
    over its stacked leaves and in the port over ``param_leaves`` of the
    per-layer modules: wire gradients bit-equal, parameters within 1e-6 of
    each leaf's largest; ``chunked`` forces the slice-by-slice path of the
    stacked 3-D leaves in both."""
    if chunked:
        monkeypatch.setattr(jopt, "_CHUNKED_LEAF_ELEMS", 64)
        monkeypatch.setattr(topt, "_CHUNKED_LEAF_ELEMS", 64)
    cfg = reduce_lm_config(get_arch("internlm2-1.8b"))
    assert cfg.n_layers == 4
    tree = jax.tree.map(np.asarray, jax_tf.init_transformer(jax.random.PRNGKey(2), _jax_cfg(cfg)))
    tokens = np.random.default_rng(6).integers(0, cfg.vocab, (2, 9)).astype(np.int32)
    jp = jax.tree.map(jnp.asarray, tree)
    jg = jax.jit(jax.grad(lambda p: jax_tf.lm_loss(p, jnp.asarray(tokens), _jax_cfg(cfg))))(jp)
    model = _port_model(cfg, tree)
    leaves = param_leaves(model)
    named = {n: p.detach() for n, p in named_params(model).items()}
    grads = {}
    for lf in leaves:
        a = _np(_get(jg, lf.name))
        for m, part in zip(lf.members, list(a) if lf.stacked else [a]):
            grads[m] = torch.from_numpy(np.array(part))
    cc = dict(kind="int8")
    jw, _ = jcomp.compress_grads(jcomp.CompressionConfig(**cc), jg,
                                 jcomp.init_error_state(jp))
    tw, _ = tcomp.compress_grads(tcomp.CompressionConfig(**cc), grads,
                                 tcomp.init_error_state(named, leaves), leaves)
    for lf in leaves:
        parts = [tw[m].numpy() for m in lf.members]
        np.testing.assert_array_equal(np.stack(parts) if lf.stacked else parts[0],
                                      _np(_get(jw, lf.name)), err_msg=lf.name)
    oc = dict(name="adafactor", learning_rate=1e-2, warmup_steps=0, schedule="constant")
    jnew, _ = jopt.apply_updates(jopt.OptimizerConfig(**oc), jp, jw,
                                 jopt.init_opt_state(jopt.OptimizerConfig(**oc), jp),
                                 jnp.int32(0))
    tc = topt.OptimizerConfig(**oc)
    topt.apply_updates(tc, named, tw, topt.init_opt_state(tc, named, leaves), 0, leaves)
    for lf in leaves:
        parts = [named[m].numpy() for m in lf.members]
        _leaf_close(np.stack(parts) if lf.stacked else parts[0], _get(jnew, lf.name), 1e-6,
                    lf.name)


def test_cross_entropy_out_of_range_label_hazard_c():
    """Hazard (c): a label outside [0, V) gets a logit of 0 from the masked
    sum and does not fail; value and gradient equal the reference's."""
    rng = np.random.default_rng(8)
    logits = rng.standard_normal((3, 5, 11)).astype(np.float32)
    labels = rng.integers(0, 11, (3, 5)).astype(np.int32)
    labels[0, 0], labels[1, 2], labels[2, 4] = 11, -1, 40
    mask = (rng.random((3, 5)) < 0.7).astype(np.float32)
    for m in (None, mask):
        want, jgrad = jax.value_and_grad(lambda x: jax_common.cross_entropy_loss(
            x, jnp.asarray(labels), None if m is None else jnp.asarray(m)))(jnp.asarray(logits))
        x = torch.from_numpy(logits).requires_grad_(True)
        got = common.cross_entropy_loss(x, torch.from_numpy(labels),
                                        None if m is None else torch.from_numpy(m))
        got.backward()
        assert abs(float(got) - float(want)) <= 1e-6 * abs(float(want))
        np.testing.assert_allclose(x.grad.numpy(), _np(jgrad), rtol=1e-6, atol=1e-7)


# ------------------------------------------------------------------ GNNs

def _gnn_cfg(name: str):
    base = get_arch(name)
    return base.replace(n_layers=min(base.n_layers, 3), d_hidden=24, d_in=12,
                        d_out=5 if base.task != "regression" else 3)


def _gnn_graph():
    """An R-MAT graph plus 60 of its arcs again: a repeated arc sends an
    equal message to its destination, a tie under max and min."""
    from repro.graph import generators as jax_gen

    g = jax_gen.rmat_graph(200, 1200, seed=31)
    src, dst = g.edge_sources().astype(np.int32), g.indices.astype(np.int32)
    return np.concatenate([src, src[:60]]), np.concatenate([dst, dst[:60]]), g.n_nodes


def _gnn_inputs(cfg, n, m, seed=0, n_graphs=5):
    rng = np.random.default_rng(seed)
    out = {"feats": rng.standard_normal((n, cfg.d_in)).astype(np.float32),
           "edge_feats": rng.standard_normal((m, cfg.d_edge_in)).astype(np.float32),
           "mask": (rng.random(n) < 0.6).astype(np.float32)}
    if cfg.task == "regression":
        out["labels"] = rng.standard_normal((n, cfg.d_out)).astype(np.float32)
    else:
        out["labels"] = rng.integers(0, cfg.d_out, size=n).astype(np.int32)
    return out


def _flat_tree(tree, prefix=""):
    if isinstance(tree, dict):
        for k, v in tree.items():
            yield from _flat_tree(v, f"{prefix}.{k}" if prefix else k)
    elif isinstance(tree, (list, tuple)):
        for i, v in enumerate(tree):
            yield from _flat_tree(v, f"{prefix}.{i}")
    else:
        yield prefix, tree


@pytest.mark.parametrize("name", ["graphsage-reddit", "pna", "gatedgcn", "meshgraphnet"])
def test_gnn_loss_gradients_with_ties_hazard_f(name):
    """Hazard (f): every parameter's gradient of ``gnn_loss`` against
    ``jax.grad``, on a graph whose repeated arcs tie under PNA's max and
    min (and ReLU zeros tie too); the loss is masked (the regression task's
    too)."""
    cfg = _gnn_cfg(name)
    src, dst, n = _gnn_graph()
    inp = _gnn_inputs(cfg, n, src.shape[0])
    jcfg = jax_gnn.GNNConfig(**dataclasses.asdict(cfg))
    tree = jax.tree.map(np.asarray, jax_gnn.init_gnn(jax.random.PRNGKey(1), jcfg))
    args = (inp["feats"], src, dst, inp["labels"], inp["mask"], inp["edge_feats"])
    want, jg = jax.value_and_grad(lambda p: jax_gnn.gnn_loss(
        p, jcfg, *map(jnp.asarray, args)))(jax.tree.map(jnp.asarray, tree))
    model = convert.gnn_params(tree, cfg, device="cpu")
    for p in model.parameters():
        p.requires_grad_(True)
    t = [torch.from_numpy(a) for a in args]
    loss = gnn.gnn_loss(model, cfg, t[0], t[1], t[2], t[3], label_mask=t[4], edge_feats=t[5])
    loss.backward()
    assert abs(float(loss) - float(want)) <= GNN * abs(float(want))
    named = dict(model.named_parameters())
    flat = dict(_flat_tree(jg))
    assert set(flat) == set(named)
    for key, g in flat.items():
        got = named[key].grad
        _leaf_close(np.zeros(g.shape) if got is None else got.numpy(), _np(g), GNN, key)


@pytest.mark.parametrize("how", ["max", "min"])
def test_aggregate_splits_a_tie_of_zeros_hazard_f(how):
    """Hazard (f): ``jax.ops.segment_max``/``min`` split a tie equally among
    the tied messages; the port's ``scatter_reduce_`` over the ∓inf fill
    with ``include_self=True`` does the same (over a zero fill without the
    fill, the fill would count as one more tie).  Destination 0 gets three
    ReLU zeros in column 0 (a three-way tie) and a two-way tie in column 1."""
    msgs = np.maximum(np.array([[0.0, 1.0], [-1.0, 1.0], [3.0, 2.0], [-0.5, 0.5]],
                               np.float32), 0.0)
    if how == "min":
        msgs[0, 1], msgs[1, 1] = 0.25, 0.25
    dst = np.array([0, 0, 1, 0], np.int32)
    w = np.array([[1.0, 2.0], [3.0, 4.0]], np.float32)
    want = jax.grad(lambda m: jnp.sum(jax_gnn.aggregate(m, jnp.asarray(dst), 2, how) * w))(
        jnp.asarray(msgs))
    x = torch.from_numpy(msgs).requires_grad_(True)
    (gnn.aggregate(x, torch.from_numpy(dst), 2, how) * torch.from_numpy(w)).sum().backward()
    np.testing.assert_array_equal(x.grad.numpy(), _np(want))
    assert x.grad[0, 0] == x.grad[1, 0] == x.grad[3, 0] == np.float32(1.0) / 3


def test_graphsage_minibatch_forward_under_grad():
    cfg = _gnn_cfg("graphsage-reddit").replace(sample_sizes=(3, 2))
    rng = np.random.default_rng(9)
    b = 4
    feats = [rng.standard_normal((b * k, cfg.d_in)).astype(np.float32) for k in (1, 3, 6)]
    labels = rng.integers(0, cfg.d_out, b)
    jcfg = jax_gnn.GNNConfig(**dataclasses.asdict(cfg))
    tree = jax.tree.map(np.asarray, jax_gnn.init_gnn(jax.random.PRNGKey(3), jcfg))

    def jloss(p):
        out = jax_gnn.graphsage_minibatch_forward(p, [jnp.asarray(f) for f in feats], jcfg)
        logp = jax.nn.log_softmax(out, -1)
        return -jnp.mean(jnp.take_along_axis(logp, jnp.asarray(labels)[:, None], -1))

    want, jg = jax.value_and_grad(jloss)(jax.tree.map(jnp.asarray, tree))
    model = convert.gnn_params(tree, cfg, device="cpu")
    for p in model.parameters():
        p.requires_grad_(True)
    out = gnn.graphsage_minibatch_forward(model, [torch.from_numpy(f) for f in feats], cfg)
    assert out.requires_grad
    loss = -torch.log_softmax(out, -1).gather(-1, torch.from_numpy(labels)[:, None]).mean()
    loss.backward()
    assert abs(float(loss) - float(want)) <= GNN * abs(float(want))
    named = dict(model.named_parameters())
    for key, g in _flat_tree(jg):
        _leaf_close(named[key].grad.numpy(), _np(g), GNN, key)


# ------------------------------------------------------------------ DLRM

def test_dlrm_loss_gradients_with_a_wrapped_id():
    """``dlrm_loss`` through the plain bag (``use_kernels=False``): a
    negative id wraps to ``V + id`` in the forward and its gradient row,
    as ``jnp.take``'s does; every gradient against ``jax.grad``."""
    cfg = reduce_dlrm_config(get_arch("dlrm-mlperf"))
    jcfg = jax_dlrm.DLRMConfig(**dataclasses.asdict(cfg))
    rng = np.random.default_rng(10)
    B = 16
    dense = rng.standard_normal((B, cfg.n_dense)).astype(np.float32)
    sparse = np.stack([rng.integers(0, v, B) for v in cfg.vocab_sizes], 1).astype(np.int32)
    sparse[0, 0], sparse[3, 2] = -1, -5          # wrap to V - 1 and V - 5
    labels = (rng.random(B) < 0.3).astype(np.float32)
    tree = jax.tree.map(np.asarray, jax_dlrm.init_dlrm(jax.random.PRNGKey(4), jcfg))
    want, jg = jax.jit(jax.value_and_grad(lambda p: jax_dlrm.dlrm_loss(
        p, jnp.asarray(dense), jnp.asarray(sparse), jnp.asarray(labels), jcfg)))(
        jax.tree.map(jnp.asarray, tree))
    model = convert.dlrm_params(tree, cfg, device="cpu")
    for p in model.parameters():
        p.requires_grad_(True)
    loss = dlrm.dlrm_loss(model, torch.from_numpy(dense), torch.from_numpy(sparse),
                          torch.from_numpy(labels), use_kernels=False)
    loss.backward()
    assert abs(float(loss) - float(want)) <= F32 * abs(float(want))
    assert float(model.tables[0].grad[cfg.vocab_sizes[0] - 1].abs().sum()) > 0
    named = dict(model.named_parameters())
    for key, g in _flat_tree(jg):
        _leaf_close(named[key].grad.numpy(), _np(g), F32, key)
