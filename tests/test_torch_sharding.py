"""``repro_torch.dist.sharding`` against the reference's
``repro.dist.sharding``: the spec of every leaf of every LM, GNN and DLRM
architecture's parameters and train state (full size, abstract: the
reference's ``jax.eval_shape``, the port's modules on the ``meta``
device) on (1, 1), (2, 4), (4, 2) and (2, 2, 2) meshes given as shape
stubs, as ``tests/test_dist_sharding.py`` does; then the counterparts of
that file's rule-DSL tests, and the DTensor placements of a spec.

The port's parameters are one tensor a layer where the reference stacks
the scan layers on axis 0, and specs are right-aligned, so a parameter's
spec is compared with the trailing entries of its reference leaf's; the
optimizer state keeps the reference's leaf shapes and is compared whole.
Specs are normalised to tuples of axis names (jax 0.9.0 stores
``("data",)`` as ``"data"``).
"""

import importlib

import jax
import pytest
from jax.sharding import PartitionSpec as JP
from jax.tree_util import tree_flatten_with_path

import repro.dist.sharding as jsh
from repro.configs import get_arch as jax_get_arch
from repro.models import dlrm as jax_dlrm
from repro.models import gnn as jax_gnn
from repro.models import transformer as jax_tf
from repro.train.optimizer import OptimizerConfig as JaxOptimizerConfig
from repro.train.train_step import init_train_state as jax_init_train_state
from repro_torch.configs import ARCHS
from repro_torch.dist import sharding as sh
from repro_torch.dist.sharding import P
from repro_torch.models.dlrm import DLRM, DLRMConfig
from repro_torch.models.gnn import ARCHITECTURES, GNNConfig
from repro_torch.models.transformer import Transformer, TransformerConfig
from repro_torch.train.train_step import init_train_state, param_leaves

import torch


def _stub(shape: dict):
    class Mesh:
        axis_names = tuple(shape)

    Mesh.shape = dict(shape)
    return Mesh()


MESHES = {
    "1x1": _stub({"data": 1, "model": 1}),
    "2x4": _stub({"data": 2, "model": 4}),
    "4x2": _stub({"data": 4, "model": 2}),
    "2x2x2": _stub({"pod": 2, "data": 2, "model": 2}),
}
ARCH_NAMES = [n for n in ARCHS if n != "hytgraph"]


def _norm(spec, ndim: int) -> list:
    """A spec as ``ndim`` entries, each None or a tuple of axis names."""
    entries = [None if e is None or e == () else (e,) if isinstance(e, str) else tuple(e)
               for e in spec]
    return [None] * (ndim - len(entries)) + entries


def _family(cfg):
    if isinstance(cfg, TransformerConfig):
        return "lm"
    return "gnn" if isinstance(cfg, GNNConfig) else "dlrm"


def _rules(family: str, mesh):
    return {"lm": (sh.lm_rule(mesh), jsh.lm_rule(mesh)),
            "gnn": (sh.gnn_rule(mesh), jsh.gnn_rule(mesh)),
            "dlrm": (sh.dlrm_rule(mesh), jsh.dlrm_rule(mesh))}[family]


def _reference_state(name: str, opt_name: str):
    jcfg = jax_get_arch(name).model_config
    if isinstance(jcfg, jax_tf.TransformerConfig):
        params = jax_tf.abstract_params(jcfg)
    elif isinstance(jcfg, jax_gnn.GNNConfig):
        params = jax.eval_shape(lambda: jax_gnn.init_gnn(jax.random.PRNGKey(0), jcfg))
    else:
        params = jax.eval_shape(lambda: jax_dlrm.init_dlrm(jax.random.PRNGKey(0), jcfg))
    return jax.eval_shape(lambda: jax_init_train_state(params, JaxOptimizerConfig(name=opt_name)))


def _port_state(name: str, opt_name: str):
    mod = importlib.import_module(ARCHS[name])
    cfg, meta = mod.CONFIG, torch.device("meta")
    if isinstance(cfg, TransformerConfig):
        model = Transformer(cfg, meta)
    elif isinstance(cfg, GNNConfig):
        model = ARCHITECTURES[cfg.arch](cfg, meta)
    else:
        assert isinstance(cfg, DLRMConfig)
        model = DLRM(cfg, meta)
    return init_train_state(model, mod.OPT.replace(name=opt_name), device="meta"), cfg


def _reference_specs(state, mesh, rule) -> dict:
    """path -> (spec, ndim) of the reference's state, its paths written as
    the port's (params/..., opt_state/..., step)."""
    top = {"0": "params", "1": "opt_state", "2": "error_state", "3": "step"}
    out = {}
    for path, leaf in tree_flatten_with_path(state)[0]:
        p = jsh.path_str(path)
        head, _, rest = p.partition("/")
        out[top[head] + ("/" + rest if rest else "")] = (
            jsh.spec_for(p, tuple(leaf.shape), mesh, rule), len(leaf.shape))
    return out


@pytest.mark.parametrize("opt_name", ["adamw", "adafactor"])
@pytest.mark.parametrize("mesh_name", sorted(MESHES))
@pytest.mark.parametrize("name", ARCH_NAMES)
def test_every_leaf_gets_the_reference_spec(name, mesh_name, opt_name):
    mesh = MESHES[mesh_name]
    state, cfg = _port_state(name, opt_name)
    rule, jrule = _rules(_family(cfg), mesh)
    want = _reference_specs(_reference_state(name, opt_name), mesh, jrule)
    specs = sh.tree_shardings(state, mesh, rule)
    named = dict(state.params.named_parameters())
    seen = set()
    # parameters: each member of a reference leaf, right-aligned
    for lf in state.leaves:
        ref, ref_ndim = want[f"params/{lf.name.replace('.', '/')}"]
        for member in lf.members:
            ndim = named[member].ndim
            got = _norm(specs["params"][member], ndim)
            assert got == _norm(ref, ref_ndim)[ref_ndim - ndim:], (name, member, got, ref)
        seen.add(f"params/{lf.name.replace('.', '/')}")
    # optimizer state and step: the reference's leaf shapes, compared whole
    flat = {}

    def walk(node, spec, path):
        if isinstance(node, dict):
            for k, v in node.items():
                walk(v, spec[k], f"{path}/{k.replace('.', '/')}")
        else:
            flat[path] = (spec, node.ndim if isinstance(node, torch.Tensor) else 0)

    walk(state.opt_state, specs["opt_state"], "opt_state")
    flat["step"] = (specs["step"], 0)
    for path, (spec, ndim) in flat.items():
        ref, ref_ndim = want[path]
        assert ndim == ref_ndim, (name, path)
        assert _norm(spec, ndim) == _norm(ref, ref_ndim), (name, path, spec, ref)
        seen.add(path)
    assert seen == set(want), (name, set(want) ^ seen)


# --------------------------------------------- the rule DSL's own tests

def test_batch_axes_subsets():
    assert sh.batch_axes(MESHES["1x1"]) == ("data",)
    assert sh.batch_axes(MESHES["2x2x2"]) == ("pod", "data")
    assert sh.batch_axes(_stub({"graph": 4})) == ()
    assert sh.lm_batch_spec(MESHES["1x1"]) == P(("data",), None)
    assert sh.gnn_data_spec(MESHES["2x2x2"], "vector") == P(("pod", "data"))
    with pytest.raises(ValueError):
        sh.gnn_data_spec(MESHES["1x1"], "cube")


def test_fit_spec_right_aligns_and_pads():
    m = MESHES["1x1"]
    # stacked scan-layer weight: rank-2 rule onto a rank-3 leaf
    assert sh.fit_spec(P(None, "model"), (4, 64, 128), m) == P(None, None, "model")
    # rule longer than the leaf keeps the trailing entries
    assert sh.fit_spec(P("data", None, "model"), (64, 128), m) == P(None, "model")
    # scalars always replicate
    assert sh.fit_spec(P("model"), (), m) == P()


def test_fit_spec_divisibility_fallback():
    m = _stub({"data": 4, "model": 8})
    # 30 % 8 != 0 -> that dim replicates; 32 % 8 == 0 -> sharded
    assert sh.fit_spec(P(None, "model"), (16, 30), m) == P()
    assert sh.fit_spec(P(None, "model"), (16, 32), m) == P(None, "model")
    for spec, shape in ((P(None, "model"), (16, 30)), (P(("data", "model"), None), (64, 3)),
                        (P(("data", "model"), None), (48, 3))):
        assert _norm(sh.fit_spec(spec, shape, m), 2) == _norm(
            jsh.fit_spec(JP(*spec), shape, m), 2)


def test_first_matching_rule_wins():
    m = MESHES["1x1"]
    rule = sh.lm_rule(m)
    # moe w_gate (expert-banked) and ffn w_gate (dense) hit different rules
    moe = sh.spec_for("layers/moe/w_gate", (2, 8, 64, 32), m, rule)
    ffn = sh.spec_for("layers/ffn/w_gate", (2, 64, 128), m, rule)
    assert moe[-1] == "model" and moe != ffn
    # optimizer moment trees mirror the param paths
    assert sh.spec_for("opt_state/m/layers/ffn/w_gate", (2, 64, 128), m, rule) == ffn
    # the port's dotted names become paths that the same rules match
    assert sh.spec_for(sh.path_str(("params", "layers.3.ffn.w_gate")), (64, 128), m,
                       rule) == P(None, "model")
    # unmatched -> replicated
    assert sh.spec_for("final_norm", (64,), m, rule) == P()


def test_tree_shardings_covers_every_leaf():
    cfg = TransformerConfig(name="t", n_layers=2, d_model=64, n_heads=4, n_kv_heads=4,
                            d_head=16, d_ff=128, vocab=128, dtype="float32")
    state = init_train_state(Transformer(cfg, torch.device("meta")),
                             importlib.import_module(ARCHS["internlm2-1.8b"]).OPT,
                             device="meta")
    m = MESHES["2x4"]
    specs = sh.tree_shardings(state, m, sh.lm_rule(m))
    assert set(specs) == {"params", "opt_state", "error_state", "step"}
    assert specs["error_state"] is None and specs["step"] == P()
    named = dict(state.params.named_parameters())
    assert set(specs["params"]) == set(named)
    for n, p in named.items():
        assert len(specs["params"][n]) <= p.ndim, n
    assert len(param_leaves(state.params)) == len(specs["opt_state"]["m"])
    assert specs["params"]["layers.1.attn.wq"] == P(None, "model")
    assert specs["opt_state"]["m"]["layers.attn.wq"] == P(None, None, "model")
    assert specs["params"]["embed"] == P("model")


def test_cache_rule_kv_heads_vs_sequence():
    m = _stub({"data": 2, "model": 4})
    # kv=8 divides model=4 -> heads shard; kv=1 (MQA) -> sequence shards
    heads = dict(sh.lm_cache_rule(m, 8))
    seq = dict(sh.lm_cache_rule(m, 1))
    assert list(heads[r"(^|/)[kv]$"]) == [("data",), None, "model", None]
    assert list(seq[r"(^|/)[kv]$"]) == [("data",), "model", None, None]
    assert list(dict(sh.lm_cache_rule(m, 8))[r"(^|/)(ckv|kr)$"]) == [("data",), "model", None]
    for kv in (8, 1):
        for (pat, spec), (jpat, jspec) in zip(sh.lm_cache_rule(m, kv), jsh.lm_cache_rule(m, kv)):
            assert pat == jpat and _norm(spec, 4) == _norm(jspec, 4)


def test_placements_of_a_spec():
    from torch.distributed.tensor import Replicate, Shard

    class DM:
        mesh_dim_names = ("pod", "data", "model")

    dm = DM()
    assert sh.placements(P(("pod", "data"), None), 2, dm) == [Shard(0), Shard(0), Replicate()]
    assert sh.placements(P(None, None, "model"), 3, dm) == [Replicate(), Replicate(), Shard(2)]
    assert sh.placements(P(), 0, dm) == [Replicate()] * 3
    with pytest.raises(ValueError, match="order"):
        sh.placements(P(("data", "pod")), 1, dm)
    with pytest.raises(ValueError, match="two dims"):
        sh.placements(P("model", "model"), 2, dm)
