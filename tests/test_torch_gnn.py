"""The GNN side of the port against the reference, on the same weights and
inputs: ``layer_norm``, ``aggregate``, each architecture's ``gnn_forward``
and ``gnn_loss`` (every task, with and without ``label_mask`` and
``edge_feats``) through ``convert.gnn_params``,
``graphsage_minibatch_forward``, both samplers, ``batched_molecule_graphs``,
the four configs and the GNN shape cells.

Inputs: ``rmat_graph(300, 2000, seed=31)`` (as ``tests/test_models.py``)
and the smoke reduction of ``tests/test_smoke_archs.py`` (at most 3
layers, d_hidden 24, d_in 12, d_out 5, or 3 for a regression); features
and labels from a seeded numpy generator, weights from the reference's own
``init_gnn(PRNGKey)`` tree (the port's ``init_gnn`` draws from a
``torch.Generator`` and cannot equal ``jax.random``).

Tolerances.  The samplers, the molecule generator and the configs are
equal bit for bit (the same numpy calls; the device sampler's helper fed
the reference's own uniforms, float32 ``floor(u * d)`` in both).  One
aggregation (sum, mean, max, min) and the layer norm: ``rtol = atol =
1e-5`` (float32 sums in another order; max and min exact).  ``std``:
``rtol = 1e-5``, ``atol = 1e-4``: ``sqrt(E[x^2] - E[x]^2 + 1e-6)``
cancels in float32, so a rounding of the two means in the last place moves
a small deviation by up to ``2 * 2^-24 * E[x^2] / 1e-3`` (``sqrt`` of the
1e-6 floor), about 1e-4 at the test's |x| <= 3.  Whole models of up to
three layers, their outputs and losses: ``rtol = atol = 1e-4`` (float32
products and scatters summed in another order through up to three layers
and the heads).
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import common as jax_cfg_common
from repro.configs import get_arch as jax_get_arch
from repro.graph import generators as jax_gen
from repro.graph import sampler as jax_sampler
from repro.models import common as jax_common
from repro.models import gnn as jax_gnn
from repro_torch import convert
from repro_torch.configs import get_arch
from repro_torch.configs import common as cfg_common
from repro_torch.graph import generators, sampler
from repro_torch.models import common, gnn

GNN_ARCHS = ["graphsage-reddit", "pna", "gatedgcn", "meshgraphnet"]
AGG_TOL = dict(rtol=1e-5, atol=1e-5)
STD_TOL = dict(rtol=1e-5, atol=1e-4)
MODEL_TOL = dict(rtol=1e-4, atol=1e-4)
N_GRAPHS = 6


def _np(x):
    return np.asarray(x)


def _t(a, dtype=None):
    t = torch.from_numpy(np.array(a))
    return t if dtype is None else t.to(dtype)


def _tree(params):
    return jax.tree.map(np.asarray, params)


@pytest.fixture(scope="module")
def graph():
    g = jax_gen.rmat_graph(300, 2000, seed=31)
    return g.edge_sources().astype(np.int32), g.indices.astype(np.int32), g.n_nodes


def _smoke(name: str, **kw) -> gnn.GNNConfig:
    base = get_arch(name)
    cfg = base.replace(n_layers=min(base.n_layers, 3), d_hidden=24, d_in=12,
                       d_out=5 if base.task != "regression" else 3)
    return cfg.replace(**kw)


def _jax_cfg(cfg: gnn.GNNConfig) -> jax_gnn.GNNConfig:
    return jax_gnn.GNNConfig(**dataclasses.asdict(cfg))


def _inputs(cfg, n, m, seed=0):
    rng = np.random.default_rng(seed)
    feats = rng.standard_normal((n, cfg.d_in)).astype(np.float32)
    edge_feats = rng.standard_normal((m, cfg.d_edge_in)).astype(np.float32)
    mask = (rng.random(n) < 0.6).astype(np.float32)
    graph_ids = np.sort(rng.integers(0, N_GRAPHS, size=n)).astype(np.int32)
    if cfg.task == "regression":
        labels = rng.standard_normal((n, cfg.d_out)).astype(np.float32)
    elif cfg.task == "graph":
        labels = rng.integers(0, cfg.d_out, size=N_GRAPHS).astype(np.int32)
    else:
        labels = rng.integers(0, cfg.d_out, size=n).astype(np.int32)
    return feats, edge_feats, labels, mask, graph_ids


def _both(cfg, seed=1, **init_kw):
    """The reference's weights as a jax tree and as the port's module."""
    jcfg = _jax_cfg(cfg)
    key = jax.random.PRNGKey(seed)
    if init_kw:
        tree = jax_gnn.init_pna(key, jcfg, **init_kw)
    else:
        tree = jax_gnn.init_gnn(key, jcfg)
    return jcfg, tree, convert.gnn_params(_tree(tree), cfg, device="cpu")


# ------------------------------------------------------------ primitives

def test_layer_norm_matches():
    rng = np.random.default_rng(0)
    x = rng.standard_normal((7, 40)).astype(np.float32) * 3 + 1
    scale = rng.standard_normal(40).astype(np.float32)
    bias = rng.standard_normal(40).astype(np.float32)
    got = common.layer_norm(_t(x), _t(scale), _t(bias))
    want = jax_common.layer_norm(jnp.asarray(x), jnp.asarray(scale), jnp.asarray(bias))
    np.testing.assert_allclose(got.numpy(), _np(want), **AGG_TOL)
    got16 = common.layer_norm(_t(x, torch.bfloat16), _t(scale), _t(bias))
    assert got16.dtype == torch.bfloat16


def _agg_inputs(d):
    """14 vertices; repeated destinations; vertex 13 gets no edge; one
    message of +inf (into vertex 2) and one of -inf (into vertex 5)."""
    rng = np.random.default_rng(3)
    dst = np.concatenate([rng.integers(0, 13, size=60), [2, 2, 2, 5]]).astype(np.int32)
    msgs = (rng.standard_normal((len(dst),) + d) * 3).astype(np.float32)
    msgs[-4, ...] = np.inf
    msgs[-1, ...] = -np.inf
    return msgs, dst


@pytest.mark.parametrize("how", ["sum", "mean", "max", "min", "std"])
def test_aggregate_matches(how):
    msgs, dst = _agg_inputs((4,))
    got = gnn.aggregate(_t(msgs), _t(dst), 14, how).numpy()
    want = _np(jax_gnn.aggregate(jnp.asarray(msgs), jnp.asarray(dst), 14, how))
    assert got.shape == want.shape == (14, 4)
    np.testing.assert_allclose(got, want, **(STD_TOL if how == "std" else AGG_TOL))
    assert np.all(got[13] == np.float32(1e-3 if how == "std" else 0.0))  # std: sqrt(1e-6)


def test_aggregate_sum_of_scalars_matches():
    """PNA's degree count: a sum of (m,) messages."""
    msgs, dst = _agg_inputs(())
    got = gnn.aggregate(_t(msgs), _t(dst), 14, "sum").numpy()
    want = _np(jax_gnn.aggregate(jnp.asarray(msgs), jnp.asarray(dst), 14, "sum"))
    assert got.shape == (14,)
    np.testing.assert_allclose(got, want, **AGG_TOL)


@pytest.mark.parametrize("how", ["sum", "mean", "max", "min", "std"])
def test_aggregate_finite_messages(how):
    """Finite messages only (the +inf cases above make most of vertex 2's
    and 5's entries non-finite or zero)."""
    rng = np.random.default_rng(4)
    dst = rng.integers(0, 50, size=400).astype(np.int32)
    msgs = rng.standard_normal((400, 6)).astype(np.float32)
    got = gnn.aggregate(_t(msgs), _t(dst), 53, how).numpy()
    want = _np(jax_gnn.aggregate(jnp.asarray(msgs), jnp.asarray(dst), 53, how))
    np.testing.assert_allclose(got, want, **(STD_TOL if how == "std" else AGG_TOL))


# ------------------------------------------------------------ whole models

@pytest.mark.parametrize("edge_feats", [False, True], ids=["ones", "given"])
@pytest.mark.parametrize("name", GNN_ARCHS)
def test_gnn_forward_matches(graph, name, edge_feats):
    src, dst, n = graph
    cfg = _smoke(name)
    jcfg, tree, model = _both(cfg)
    feats, ef, *_ = _inputs(cfg, n, len(src))
    ef_t = _t(ef) if edge_feats else None
    ef_j = jnp.asarray(ef) if edge_feats else None
    got = gnn.gnn_forward(model, None, _t(feats), _t(src), _t(dst), ef_t)
    want = jax_gnn.gnn_forward(tree, jcfg, jnp.asarray(feats), jnp.asarray(src),
                               jnp.asarray(dst), ef_j)
    assert got.shape == (n, cfg.d_out)
    np.testing.assert_allclose(got.numpy(), _np(want), **MODEL_TOL)


@pytest.mark.parametrize("masked", [False, True], ids=["all", "masked"])
@pytest.mark.parametrize("task", ["node", "graph", "regression"])
@pytest.mark.parametrize("name", GNN_ARCHS)
def test_gnn_loss_matches(graph, name, task, masked):
    src, dst, n = graph
    cfg = _smoke(name, task=task)
    if task == "regression":
        cfg = cfg.replace(d_out=3)
    jcfg, tree, model = _both(cfg)
    feats, ef, labels, mask, gids = _inputs(cfg, n, len(src), seed=2)
    kw_t = dict(label_mask=_t(mask) if masked else None, edge_feats=_t(ef),
                graph_ids=_t(gids), n_graphs=N_GRAPHS)
    kw_j = dict(label_mask=jnp.asarray(mask) if masked else None, edge_feats=jnp.asarray(ef),
                graph_ids=jnp.asarray(gids), n_graphs=N_GRAPHS)
    got = gnn.gnn_loss(model, cfg, _t(feats), _t(src), _t(dst), _t(labels), **kw_t)
    want = jax_gnn.gnn_loss(tree, jcfg, jnp.asarray(feats), jnp.asarray(src),
                            jnp.asarray(dst), jnp.asarray(labels), **kw_j)
    assert got.shape == () and got.dtype == torch.float32
    np.testing.assert_allclose(float(got), float(want), **MODEL_TOL)


@pytest.mark.parametrize("avg_log_deg,n_layers", [(0.0005, 1), (2.7, 3)])
def test_pna_avg_log_deg_matches(graph, avg_log_deg, n_layers):
    """delta = max(avg_log_deg, 1e-3): 0.0005 takes the floor, where the
    amplification scaler is ~2000, so one layer (three would grow the
    outputs to ~1e9, beyond what a float32 relative tolerance compares)."""
    src, dst, n = graph
    cfg = _smoke("pna", n_layers=n_layers)
    jcfg, tree, model = _both(cfg, avg_log_deg=avg_log_deg)
    assert float(model.avg_log_deg) == np.float32(avg_log_deg)
    feats, *_ = _inputs(cfg, n, len(src))
    got = gnn.gnn_forward(model, cfg, _t(feats), _t(src), _t(dst))
    want = jax_gnn.gnn_forward(tree, jcfg, jnp.asarray(feats), jnp.asarray(src),
                               jnp.asarray(dst))
    np.testing.assert_allclose(got.numpy(), _np(want), **MODEL_TOL)


@pytest.mark.parametrize("aggregator", ["sum", "max", "min", "std"])
def test_graphsage_aggregators_match(graph, aggregator):
    src, dst, n = graph
    cfg = _smoke("graphsage-reddit", aggregator=aggregator)
    jcfg, tree, model = _both(cfg)
    feats, *_ = _inputs(cfg, n, len(src))
    got = gnn.gnn_forward(model, cfg, _t(feats), _t(src), _t(dst))
    want = jax_gnn.gnn_forward(tree, jcfg, jnp.asarray(feats), jnp.asarray(src),
                               jnp.asarray(dst))
    np.testing.assert_allclose(got.numpy(), _np(want), **MODEL_TOL)


@pytest.mark.parametrize("aggregator", ["mean", "max"])
def test_graphsage_minibatch_matches(aggregator):
    """Hop features gathered at the host sampler's ids, fanout 5-3."""
    g = generators.rmat_graph(300, 2000, seed=31)
    cfg = _smoke("graphsage-reddit", aggregator=aggregator, n_layers=2, sample_sizes=(5, 3))
    jcfg, tree, model = _both(cfg)
    table = np.random.default_rng(5).standard_normal((300, cfg.d_in)).astype(np.float32)
    hops = sampler.sample_neighbors(g, np.arange(8) * 37, cfg.sample_sizes, seed=3)
    assert [len(h) for h in hops] == [8, 40, 120]
    got = gnn.graphsage_minibatch_forward(model, [_t(table[h]) for h in hops])
    want = jax_gnn.graphsage_minibatch_forward(tree, [jnp.asarray(table[h]) for h in hops], jcfg)
    assert got.shape == (8, cfg.d_out)
    np.testing.assert_allclose(got.numpy(), _np(want), **MODEL_TOL)


# ------------------------------------------------------------ parameters

@pytest.mark.parametrize("name", GNN_ARCHS)
def test_init_gnn_layout_matches_the_reference_tree(name):
    cfg = _smoke(name)
    shapes = jax.eval_shape(lambda: jax_gnn.init_gnn(jax.random.PRNGKey(0), _jax_cfg(cfg)))
    model = gnn.init_gnn(cfg, torch.Generator().manual_seed(0), device="cpu")
    leaves = dict(model.named_parameters())
    flat = {"/".join(str(getattr(k, "key", getattr(k, "idx", k))) for k in path): v.shape
            for path, v in jax.tree_util.tree_flatten_with_path(shapes)[0]}
    got = {k.replace(".", "/"): tuple(v.shape) for k, v in leaves.items()}
    assert got == {k: tuple(v) for k, v in flat.items()}
    assert not any(p.requires_grad for p in model.parameters())
    # a dense weight is normal with std 1/sqrt(d_in); norm scales 1
    first = next(p for k, p in leaves.items() if p.dim() == 2)
    assert abs(float(first.std()) * first.shape[0] ** 0.5 - 1.0) < 0.2
    g = jax_gen.rmat_graph(300, 2000, seed=31)
    feats = torch.from_numpy(np.random.default_rng(0).standard_normal((300, 12)).astype(np.float32))
    out = gnn.gnn_forward(model, None, feats, _t(g.edge_sources()), _t(g.indices))
    assert out.shape == (300, cfg.d_out) and bool(torch.isfinite(out).all())


def test_gnn_params_checks_the_tree():
    cfg = _smoke("meshgraphnet")
    tree = _tree(jax_gnn.init_gnn(jax.random.PRNGKey(0), _jax_cfg(cfg)))
    convert.gnn_params(tree, cfg, device="cpu")
    short = {**tree, "processor": tree["processor"][:-1]}
    with pytest.raises(ValueError, match="entries in processor"):
        convert.gnn_params(short, cfg, device="cpu")
    missing = {k: v for k, v in tree.items() if k != "dec"}
    with pytest.raises(ValueError, match="expected"):
        convert.gnn_params(missing, cfg, device="cpu")
    wide = jax.tree.map(lambda a: a, tree)
    wide["processor"][1]["edge_mlp"]["w"][0] = np.zeros((3, 3), np.float32)
    with pytest.raises(ValueError, match=r"processor\[1\].edge_mlp.w\[0\]: shape"):
        convert.gnn_params(wide, cfg, device="cpu")


# ------------------------------------------------------------ samplers

def _iso_graph():
    """rmat_graph(200, 600, seed=8), which has isolated vertices
    (``tests/test_graph.py``)."""
    g = generators.rmat_graph(200, 600, seed=8)
    iso = np.nonzero(g.out_degrees == 0)[0]
    assert len(iso) > 0
    return g, iso


@pytest.mark.parametrize("seed", [0, 7])
def test_sample_neighbors_bit_equal(seed):
    g, iso = _iso_graph()
    jg = jax_gen.rmat_graph(200, 600, seed=8)
    seeds = np.concatenate([np.arange(16), iso[:3]])
    for fanouts in ((5, 3), (4,), (2, 2, 2)):
        got = sampler.sample_neighbors(g, seeds, fanouts, seed=seed)
        want = jax_sampler.sample_neighbors(jg, seeds, fanouts, seed=seed)
        assert len(got) == len(want) == len(fanouts) + 1
        for a, b in zip(got, want):
            assert a.dtype == b.dtype and np.array_equal(a, b)
    # isolated vertices sample themselves
    ls = sampler.sample_neighbors(g, iso[:1], (4,), seed=0)
    assert np.all(ls[1] == iso[0])


def test_sample_hop_on_the_reference_uniforms():
    """The device sampler's helper, fed ``uniform(fold_in(key, i))`` of the
    reference's device sampler, gives its ids bit for bit (isolated seeds
    included)."""
    g, iso = _iso_graph()
    indptr = g.indptr.astype(np.int32)
    seeds = np.concatenate([np.arange(20) * 9 % 200, iso[:4]]).astype(np.int32)
    fanouts = (6, 4)
    key = jax.random.PRNGKey(11)
    # jitted: one compile instead of one an op (2 s less)
    want = jax.jit(jax_sampler.sample_neighbors_device, static_argnums=(4,))(
        key, jnp.asarray(indptr), jnp.asarray(g.indices), jnp.asarray(seeds), fanouts)
    frontier = _t(seeds)
    got = [frontier]
    for i, f in enumerate(fanouts):
        u = jax.random.uniform(jax.random.fold_in(key, i), (frontier.shape[0], f))
        frontier = sampler.sample_hop(_t(u), frontier, _t(indptr), _t(g.indices)).reshape(-1)
        got.append(frontier)
    for a, b in zip(got, want):
        assert a.dtype == torch.int32 and np.array_equal(a.numpy(), _np(b))
    # the isolated seeds' hops are the seeds themselves
    assert np.all(got[1].numpy().reshape(-1, 6)[-4:] == iso[:4, None])


def test_sample_neighbors_device_invariants_on_cpu():
    g, iso = _iso_graph()
    seeds = torch.from_numpy(np.concatenate([np.arange(30), iso[:2]]))
    gen = torch.Generator().manual_seed(0)
    hops = sampler.sample_neighbors_device(gen, _t(g.indptr), _t(g.indices), seeds, (5, 3),
                                           device="cpu")
    assert [h.shape[0] for h in hops] == [32, 160, 480]
    for parents, children, f in ((hops[0], hops[1], 5), (hops[1], hops[2], 3)):
        for p, c in zip(parents.repeat_interleave(f).tolist(), children.tolist()):
            row = g.indices[g.indptr[p]:g.indptr[p + 1]]
            assert c in row if len(row) else c == p
    with pytest.raises(ValueError, match="generator"):
        sampler.sample_neighbors_device(torch.Generator(), _t(g.indptr), _t(g.indices), seeds,
                                        (2,), device="meta")


@pytest.mark.parametrize("args", [(128, 30, 128), (4, 30, 64), (3, 5, 20)])
def test_batched_molecule_graphs_bit_equal(args):
    for seed in (0, 3):
        got = generators.batched_molecule_graphs(*args, seed=seed)
        want = jax_gen.batched_molecule_graphs(*args, seed=seed)
        assert np.array_equal(got.indptr, want.indptr)
        assert np.array_equal(got.indices, want.indices)
        assert np.array_equal(got.weights, want.weights)
    mol = generators.batched_molecule_graphs(128, 30, 128)
    assert (mol.n_nodes, mol.n_edges) == (3840, 16384)


# ------------------------------------------------------------ configs

@pytest.mark.parametrize("name", GNN_ARCHS)
def test_gnn_configs_match_the_reference(name):
    ref = jax_get_arch(name).model_config
    assert dataclasses.asdict(get_arch(name)) == dataclasses.asdict(ref)
    assert isinstance(get_arch(name), gnn.GNNConfig)


def test_gnn_shapes_and_helpers_match():
    assert cfg_common.GNN_SHAPES == jax_cfg_common.GNN_SHAPES
    for n in (0, 1, 511, 512, 513, 169_984, 2_449_029, 61_859_140):
        for m in (1, 7, 512):
            assert cfg_common._pad_to(n, m) == jax_cfg_common._pad_to(n, m)
    for name in GNN_ARCHS:
        for cell in cfg_common.gnn_cells(get_arch(name)).values():
            cfg = cell["cfg"]
            jcfg = _jax_cfg(cfg)
            assert cfg_common.gnn_flops_per_edge(cfg) == jax_cfg_common.gnn_flops_per_edge(jcfg)
            assert cfg_common.gnn_node_flops(cfg) == jax_cfg_common.gnn_node_flops(jcfg)


@pytest.mark.parametrize("name", GNN_ARCHS)
def test_gnn_cells_match_the_reference(name):
    """Each cell's config and sizes equal the closure of the reference's
    cell function; its model flops what that function's ``CellBuild``
    says."""
    spec = jax_get_arch(name)
    mesh = jax.make_mesh((1, 1), ("data", "model"))
    cells = cfg_common.gnn_cells(get_arch(name))
    assert set(cells) == set(spec.cells)
    for cell, build in spec.cells.items():
        ref = dict(zip(build.__code__.co_freevars, (c.cell_contents for c in build.__closure__)))
        got = cells[cell]
        assert dataclasses.asdict(got["cfg"]) == dataclasses.asdict(ref["cell_cfg"]), cell
        assert got["d_feat"] == ref["d_feat"] and got["n_nodes_padded"] == ref["n_nodes"]
        if got["kind"] == "minibatch":
            assert (got["batch_nodes"], got["fanouts"]) == (ref["batch_nodes"], ref["fanouts"])
        else:
            assert (got["n_nodes"], got["n_edges"]) == (ref["n_nodes_orig"], ref["n_edges_orig"])
            assert got["n_edges_padded"] == ref["n_edges"]
            assert got["n_graphs"] == ref["n_graphs"]
        assert got["model_flops"] == build(mesh).model_flops, cell
