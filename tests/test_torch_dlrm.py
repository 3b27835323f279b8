"""The DLRM serving slice of the port against the reference, on the same
weights and inputs: ``select_row_engine``, ``embedding_bag`` for each row
engine (with and without the kernel wrapper), ``_dot_interaction``, the
MLP, ``dlrm_forward``, ``dlrm_loss`` and ``retrieval_score`` through
``convert.dlrm_params``, the configs and the serving launcher.

Tolerances.  Engine picks are identical (the same Python float
arithmetic).  One-hot bags (L = 1, sum) equal the reference's bit for bit
on every engine: each is one table row, copied.  Multi-hot float32 sums
and means: ``rtol = 1e-6``, ``atol = 1e-6 * L`` (the same sum in another
order).  The interaction and the MLPs: ``1e-5``; the logits and the loss
of whole models: ``1e-4`` (float32 products summed in another order
through up to six layers).  ``retrieval_score`` on random floats (no ties,
so ``torch.topk``'s order on ties does not arise): the same ids, scores
within ``1e-5``.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_arch as jax_get_arch
from repro.models import common as jax_common
from repro.models import dlrm as jax_dlrm
from repro.models import embedding as jax_emb
from repro_torch import convert
from repro_torch.configs import get_arch
from repro_torch.configs.common import reduce_dlrm_config
from repro_torch.configs.dlrm_mlperf import CELLS, ONE_CARD_MAX_ROWS, one_card_config
from repro_torch.kernels.embedding_bag.ops import embedding_bag as bag_kernel
from repro_torch.launch import serve
from repro_torch.models import common, dlrm, embedding
from repro_torch.models.dlrm import DLRMConfig

ENGINES = ["gather", "dedup", "onehot", "auto"]


def _np(x):
    return np.asarray(jnp.asarray(x).astype(jnp.float32))


# ------------------------------------------------------------ row engines

VOCABS = sorted({1, 2, 3, 100, 511, 512, 513, 976, 4096, 100_000, ONE_CARD_MAX_ROWS,
                 *jax_dlrm.MLPERF_VOCAB_SIZES, *jax_get_arch("dlrm-mlperf").model_config
                 .vocab_sizes})
LOOKUPS = [1, 8, 511, 512, 513, 4096, 26 * 512, 262_144, 1_000_000]


def test_select_row_engine_identical_on_a_grid():
    for v in VOCABS:
        for n in LOOKUPS:
            assert embedding.select_row_engine(v, n) == jax_emb.select_row_engine(v, n), (v, n)
    for v, n, u in ((1000, 512, 100.0), (1000, 512, 300.0), (10, 512, None)):
        assert embedding.select_row_engine(v, n, u) == jax_emb.select_row_engine(v, n, u)


@pytest.mark.parametrize("batch,want", [(512, {"gather": 18, "onehot": 8}),
                                        (262_144, {"gather": 8, "dedup": 10, "onehot": 8})])
def test_engine_picks_of_the_capped_serving_cells(batch, want):
    """The picks behind the kernel legs' launch counts on the card: at
    batch 512 18 gather tables, at 262,144 8 gather and 10 dedup."""
    picks = {}
    for v in one_card_config().vocab_sizes:
        e = embedding.select_row_engine(v, batch)
        picks[e] = picks.get(e, 0) + 1
    assert picks == want


def _table_ids(V, D, B, L, seed, lo=0):
    rng = np.random.default_rng(seed)
    table = rng.standard_normal((V, D)).astype(np.float32)
    # few distinct ids, so that dedup has duplicates to merge
    ids = rng.integers(lo, V, (B, L)).astype(np.int32)
    return table, ids


@pytest.mark.parametrize("engine", ENGINES)
@pytest.mark.parametrize("V,B,L", [(7, 64, 1), (300, 40, 1), (5000, 64, 1), (300, 24, 6)])
@pytest.mark.parametrize("mode", ["sum", "mean", "max"])
def test_embedding_bag_engines_match_reference(engine, V, B, L, mode):
    table, ids = _table_ids(V, 24, B, L, seed=V + L)
    want = _np(jax_emb.embedding_bag(jnp.asarray(table), jnp.asarray(ids), mode=mode,
                                     engine=engine))
    t, i = torch.from_numpy(table), torch.from_numpy(ids)
    got = embedding.embedding_bag(t, i, mode=mode, engine=engine, use_kernels=False)
    with_wrapper = embedding.embedding_bag(t, i, mode=mode, engine=engine, use_kernels=True)
    assert torch.equal(got, with_wrapper)
    if L == 1 or mode == "max":
        np.testing.assert_array_equal(got.numpy(), want)
    else:
        np.testing.assert_allclose(got.numpy(), want, rtol=1e-6, atol=1e-6 * L)


@pytest.mark.parametrize("engine", ["gather", "dedup", "onehot"])
def test_embedding_bag_engines_on_wrapped_ids(engine):
    """Negative ids: gather and dedup wrap them (jnp.take), onehot gives a
    zero row (jax.nn.one_hot), in both packages."""
    table, ids = _table_ids(40, 8, 30, 1, seed=3, lo=-40)
    want = _np(jax_emb.embedding_bag(jnp.asarray(table), jnp.asarray(ids), engine=engine))
    for use in (False, True):
        got = embedding.embedding_bag(torch.from_numpy(table), torch.from_numpy(ids),
                                      engine=engine, use_kernels=use)
        np.testing.assert_array_equal(got.numpy(), want)


def test_embedding_bag_use_kernels_on_cpu_launches_nothing():
    table, ids = _table_ids(100, 16, 32, 1, seed=4)
    before = bag_kernel.launches
    for engine in ("gather", "dedup"):
        embedding.embedding_bag(torch.from_numpy(table), torch.from_numpy(ids), engine=engine,
                                use_kernels=True)
    assert bag_kernel.launches == before
    with pytest.raises(ValueError, match="engine"):
        embedding.embedding_bag(torch.from_numpy(table), torch.from_numpy(ids), engine="bogus")


def test_embedding_bag_grad_rows_matches():
    rng = np.random.default_rng(5)
    for V, lo, hi in ((50, 0, 50), (50, -60, 70), (1000, 0, 10)):
        ids = rng.integers(lo, hi, (40, 3)).astype(np.int32)
        want = int(jax_emb.embedding_bag_grad_rows(V, jnp.asarray(ids)))
        got = embedding.embedding_bag_grad_rows(V, torch.from_numpy(ids))
        assert got.dtype == torch.int32 and int(got) == want


# ------------------------------------------------------------ towers

def test_dot_interaction_matches():
    z = np.random.default_rng(6).standard_normal((9, 27, 32)).astype(np.float32)
    want = _np(jax_dlrm._dot_interaction(jnp.asarray(z)))
    got = dlrm._dot_interaction(torch.from_numpy(z))
    assert got.shape == (9, 351)
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-5, atol=1e-5)


def test_mlp_apply_matches():
    params = jax_common.mlp_init(jax.random.PRNGKey(0), [13, 64, 32, 1])
    x = np.random.default_rng(7).standard_normal((11, 13)).astype(np.float32)
    tree = jax.tree.map(np.asarray, params)
    tp = {k: [torch.from_numpy(np.array(a)) for a in v] for k, v in tree.items()}
    for act, final in ((jax.nn.relu, None), (jax.nn.relu, jax.nn.relu)):
        want = _np(jax_common.mlp_apply(params, jnp.asarray(x), act=act, final_act=final))
        got = common.mlp_apply(tp, torch.from_numpy(x), act=torch.relu,
                               final_act=None if final is None else torch.relu)
        np.testing.assert_allclose(got.numpy(), want, rtol=1e-5, atol=1e-5)


def test_mlp_init_is_seeded_and_scaled():
    p = common.mlp_init(torch.Generator().manual_seed(0), [400, 300, 1])
    assert [tuple(w.shape) for w in p["w"]] == [(400, 300), (300, 1)]
    assert [tuple(b.shape) for b in p["b"]] == [(300,), (1,)]
    assert abs(float(p["w"][0].std()) * 20.0 - 1.0) < 0.02
    assert not any(float(b.abs().max()) for b in p["b"])


# ------------------------------------------------------------ whole models

REDUCED = reduce_dlrm_config(get_arch("dlrm-mlperf"))
# the published towers and 26 fields, vocabularies cut to at most 1,000 rows
PUBLISHED_WIDTHS = get_arch("dlrm-mlperf").replace(
    vocab_sizes=tuple(min(v, 1000) for v in jax_dlrm.MLPERF_VOCAB_SIZES))
CONFIGS = {"reduced": REDUCED, "published_widths": PUBLISHED_WIDTHS}


def _jax_cfg(cfg: DLRMConfig):
    return jax_dlrm.DLRMConfig(**dataclasses.asdict(cfg))


def _case(cfg: DLRMConfig, B: int, seed: int, L: int = 1):
    params = jax_dlrm.init_dlrm(jax.random.PRNGKey(seed), _jax_cfg(cfg))
    tree = jax.tree.map(np.asarray, params)
    rng = np.random.default_rng(seed)
    # nonzero biases, so that a bias mix-up shows
    for tower in ("bot", "top"):
        tree[tower]["b"] = [rng.standard_normal(b.shape).astype(np.float32) * 0.1
                            for b in tree[tower]["b"]]
    dense = rng.standard_normal((B, cfg.n_dense)).astype(np.float32)
    sparse = np.stack([rng.integers(0, v, (B, L)) for v in cfg.vocab_sizes], axis=1)
    sparse = sparse.astype(np.int32)[..., 0] if L == 1 else sparse.astype(np.int32)
    labels = (rng.random(B) < 0.3).astype(np.float32)
    return tree, dense, sparse, labels


@pytest.mark.parametrize("name", list(CONFIGS))
@pytest.mark.parametrize("engine", ENGINES)
def test_dlrm_forward_and_loss_match_reference(name, engine):
    cfg = CONFIGS[name].replace(table_engine=engine)
    tree, dense, sparse, labels = _case(cfg, 48, seed=8)
    jparams = jax.tree.map(jnp.asarray, tree)
    want = _np(jax_dlrm.dlrm_forward(jparams, jnp.asarray(dense), jnp.asarray(sparse),
                                     _jax_cfg(cfg)))
    want_loss = float(jax_dlrm.dlrm_loss(jparams, jnp.asarray(dense), jnp.asarray(sparse),
                                         jnp.asarray(labels), _jax_cfg(cfg)))
    model = convert.dlrm_params(tree, cfg, device="cpu")
    d, s = torch.from_numpy(dense), torch.from_numpy(sparse)
    for use in ("auto", True, False):
        got = dlrm.dlrm_forward(model, d, s, use_kernels=use)
        assert got.shape == (48,) and got.dtype == torch.float32
        np.testing.assert_allclose(got.numpy(), want, rtol=1e-4, atol=1e-4)
    loss = dlrm.dlrm_loss(model, d, s, torch.from_numpy(labels))
    assert abs(float(loss) - want_loss) <= 1e-4


def test_dlrm_forward_multi_hot_matches_reference():
    cfg = REDUCED.replace(multi_hot=3)
    tree, dense, sparse, _ = _case(cfg, 20, seed=9, L=3)
    want = _np(jax_dlrm.dlrm_forward(jax.tree.map(jnp.asarray, tree), jnp.asarray(dense),
                                     jnp.asarray(sparse), _jax_cfg(cfg)))
    model = convert.dlrm_params(tree, cfg, device="cpu")
    got = dlrm.dlrm_forward(model, torch.from_numpy(dense), torch.from_numpy(sparse),
                            cfg.replace(table_engine="gather"), use_kernels=True)
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-4, atol=1e-4)


def test_retrieval_score_matches_reference():
    cfg = PUBLISHED_WIDTHS
    tree, _, _, _ = _case(cfg, 1, seed=10)
    rng = np.random.default_rng(10)
    query = rng.standard_normal((2, 13)).astype(np.float32)
    cands = rng.standard_normal((5000, 128)).astype(np.float32)
    want_s, want_i = jax_dlrm.retrieval_score(jax.tree.map(jnp.asarray, tree),
                                              jnp.asarray(query), jnp.asarray(cands), top_k=100)
    model = convert.dlrm_params(tree, cfg, device="cpu")
    got_s, got_i = dlrm.retrieval_score(model, torch.from_numpy(query), torch.from_numpy(cands),
                                        top_k=100)
    assert got_i.shape == (2, 100)
    np.testing.assert_array_equal(got_i.numpy(), np.asarray(want_i))
    np.testing.assert_allclose(got_s.numpy(), _np(want_s), rtol=1e-5, atol=1e-5)
    assert bool((got_s[:, :-1] >= got_s[:, 1:]).all())


def test_dlrm_params_checks_the_tree():
    tree, _, _, _ = _case(REDUCED, 1, seed=11)
    bad = jax.tree.map(lambda a: a, tree)
    bad["tables"][2] = bad["tables"][2][:, :8]
    with pytest.raises(ValueError, match="shape"):
        convert.dlrm_params(bad, REDUCED, device="cpu")
    bad = jax.tree.map(lambda a: a, tree)
    bad["top"]["w"] = bad["top"]["w"][:1]
    with pytest.raises(ValueError, match="top.w"):
        convert.dlrm_params(bad, REDUCED, device="cpu")
    with pytest.raises(ValueError, match="tables"):
        convert.dlrm_params(tree, REDUCED.replace(vocab_sizes=(64, 3)), device="cpu")


def test_init_dlrm_is_seeded_and_scaled():
    cfg = PUBLISHED_WIDTHS
    models = [dlrm.init_dlrm(cfg, torch.Generator().manual_seed(0), "cpu") for _ in range(2)]
    for (n, a), (_, b) in zip(models[0].named_parameters(), models[1].named_parameters()):
        assert torch.equal(a, b), n
    m = models[0]
    assert [tuple(t.shape) for t in m.tables] == [(v, 128) for v in cfg.vocab_sizes]
    assert abs(float(m.tables[0].std()) * np.sqrt(128) - 1.0) < 0.02
    assert [tuple(w.shape) for w in m.top["w"]] == [(479, 1024), (1024, 1024), (1024, 512),
                                                   (512, 256), (256, 1)]
    assert abs(float(m.top["w"][1].std()) * 32.0 - 1.0) < 0.02
    assert not any(float(b.abs().max()) for b in m.bot["b"])


# ------------------------------------------------------------ configs and launcher

def test_get_arch_matches_the_reference_and_the_cap():
    ref = jax_get_arch("dlrm-mlperf")
    cfg = get_arch("dlrm-mlperf")
    assert dataclasses.asdict(cfg) == dataclasses.asdict(ref.model_config)
    assert sum(cfg.vocab_sizes) == 187_770_880
    capped = one_card_config()
    assert sum(capped.vocab_sizes) == 129_066_304
    assert sum(v * capped.embed_dim for v in capped.vocab_sizes) == 16_520_486_912
    assert sum(a != b for a, b in zip(capped.vocab_sizes, cfg.vocab_sizes)) == 5
    assert dataclasses.replace(capped, vocab_sizes=cfg.vocab_sizes) == cfg
    # the serving cells of the reference's ArchSpec
    assert set(CELLS) | {"train_batch"} == set(ref.cells)
    # the reduction of tests/test_smoke_archs.py
    assert dataclasses.asdict(reduce_dlrm_config(cfg)) == dataclasses.asdict(
        ref.model_config.replace(vocab_sizes=(64, 3, 50, 7, 100), embed_dim=16,
                                 bot_mlp=(32, 16), top_mlp=(32, 1)))


def test_dlrm_traffic_is_seeded_and_in_range():
    cfg = REDUCED
    a = serve.dlrm_traffic(cfg, 300, torch.Generator().manual_seed(3))
    b = serve.dlrm_traffic(cfg, 300, torch.Generator().manual_seed(3))
    assert all(torch.equal(x, y) for x, y in zip(a, b))
    dense, sparse = a
    assert dense.shape == (300, 13) and dense.dtype == torch.float32
    assert sparse.shape == (300, 5) and sparse.dtype == torch.int32
    assert bool((sparse >= 0).all()) and bool((sparse < torch.tensor(cfg.vocab_sizes)).all())


@pytest.mark.parametrize("cell", ["serve_p99", "retrieval_cand"])
def test_serve_launcher_dlrm_reduced_on_cpu(cell, capsys):
    out = serve.main(["--arch", "dlrm-mlperf", "--reduced", "--device", "cpu", "--cell", cell])
    line = capsys.readouterr().out
    assert f"dlrm-mlperf (reduced, cpu): {cell}" in line
    assert "ms/batch" in line and "samples/s" in line
    assert out["launches"] == 0    # CPU calls launch nothing
    if cell == "serve_p99":
        assert out["output"].shape == (512,) and bool(torch.isfinite(out["output"]).all())
    else:
        scores, ids = out["output"]
        assert scores.shape == ids.shape == (1, 100)
        assert bool((scores[:, :-1] >= scores[:, 1:]).all())


def test_dlrm_entry_points_raise_without_a_card():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present: the entry points run on it")
    for call in (lambda: dlrm.init_dlrm(REDUCED, torch.Generator()),
                 lambda: convert.dlrm_params({}, REDUCED),
                 lambda: serve.main(["--arch", "dlrm-mlperf", "--reduced"])):
        with pytest.raises(RuntimeError, match="no CUDA device"):
            call()
