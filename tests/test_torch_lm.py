"""The LM serving slice of the port against the reference, on the same
weights and inputs: ``rms_norm``, ``apply_rope``, ``gqa_attention`` (with
and without a cache, on both of the port's routes, and across the
reference's ``_FLASH_THRESHOLD``), then ``forward``, ``prefill`` and
``decode_step`` of whole models through ``convert.transformer_params``, and
the serving launcher.

Tolerances.  float32: ``1e-5`` for single modules and ``1e-4`` for the
logits of whole models (the same arithmetic summed in another order,
through up to four layers); greedy tokens identical.  bfloat16: stated at
each test.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_arch as jax_get_arch
from repro.configs.common import reduce_lm_config as jax_reduce
from repro.models import attention as jax_attention
from repro.models import common as jax_common
from repro.models import transformer as jax_tf
from repro_torch import convert
from repro_torch.configs import get_arch
from repro_torch.configs.common import reduce_lm_config
from repro_torch.launch import serve
from repro_torch.models import attention, common, transformer
from repro_torch.models.attention import MLAConfig
from repro_torch.models.moe import MoEConfig
from repro_torch.models.transformer import TransformerConfig

ARCHS = ["gemma3-12b", "internlm2-1.8b", "granite-20b"]
MOE_ARCHS = ["deepseek-v2-lite-16b", "kimi-k2-1t-a32b"]   # tests/test_torch_mla.py
NO_LAUNCHES = {"flash_attention": 0, "grouped_matmul": 0}


def _t(a, dtype=torch.float32):
    return torch.from_numpy(np.array(a, dtype=np.float32)).to(dtype)


def _np(x):
    return np.asarray(jnp.asarray(x).astype(jnp.float32))


def _port_config(jax_cfg) -> TransformerConfig:
    kw = {f.name: getattr(jax_cfg, f.name) for f in dataclasses.fields(TransformerConfig)}
    if kw["mla"] is not None:
        kw["mla"] = MLAConfig(**dataclasses.asdict(kw["mla"]))
    if kw["moe"] is not None:
        kw["moe"] = MoEConfig(**dataclasses.asdict(kw["moe"]))
    return TransformerConfig(**kw)


# ------------------------------------------------------------ configs

@pytest.mark.parametrize("arch", ARCHS + MOE_ARCHS)
def test_configs_match_the_reference(arch):
    ref = jax_get_arch(arch).model_config
    assert get_arch(arch).model_config == _port_config(ref)
    assert reduce_lm_config(get_arch(arch).model_config) == _port_config(jax_reduce(ref))
    assert get_arch(arch).model_config.windows() == [int(w) for w in ref.windows()]


def test_gemma_windows_are_five_local_to_one_global():
    w = get_arch("gemma3-12b").model_config.windows()
    assert [i for i, x in enumerate(w) if x == 0] == list(range(5, 48, 6))
    assert w.count(1024) == 40


@pytest.mark.parametrize("arch", ["pna", "hytgraph"])
def test_unported_archs_raise(arch):
    """The two archs that were once unported now give the reference's
    configs: pna's GNNConfig, and hytgraph's workload field by field, its
    HyTMConfig field by field too (the link model as its fields); an
    unknown arch still raises."""
    ref = jax_get_arch(arch).model_config
    got = get_arch(arch).model_config
    if arch == "pna":
        assert dataclasses.asdict(got) == dataclasses.asdict(ref)
    else:
        names = [f.name for f in dataclasses.fields(ref)]
        assert [f.name for f in dataclasses.fields(got)] == names
        for name in names:
            if name != "hytm":
                assert getattr(got, name) == getattr(ref, name), name
        hytm_names = [f.name for f in dataclasses.fields(ref.hytm)]
        assert [f.name for f in dataclasses.fields(got.hytm)] == hytm_names
        for name in hytm_names:
            want, have = getattr(ref.hytm, name), getattr(got.hytm, name)
            if dataclasses.is_dataclass(want):
                assert dataclasses.asdict(have) == dataclasses.asdict(want), name
            else:
                assert have == want, name
    with pytest.raises(KeyError):
        get_arch("no-such-arch").model_config


# ------------------------------------------------------------ modules

@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_rms_norm_matches(dtype):
    rng = np.random.default_rng(0)
    x = rng.standard_normal((3, 5, 48)).astype(np.float32) * 3
    scale = rng.standard_normal(48).astype(np.float32) * 0.5
    got = common.rms_norm(_t(x, getattr(torch, dtype)), _t(scale), 1e-6)
    want = jax_common.rms_norm(jnp.asarray(x, dtype), jnp.asarray(scale), 1e-6)
    # float32 computation in both; bfloat16 rounds the output once
    tol = 1e-5 if dtype == "float32" else 8e-3
    np.testing.assert_allclose(got.float().numpy(), _np(want), rtol=tol, atol=tol)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("theta", [10_000.0, 1_000_000.0])
def test_apply_rope_matches(dtype, theta):
    """Interleaved (even, odd) pairs, float32 angles from integer positions."""
    rng = np.random.default_rng(1)
    x = rng.standard_normal((2, 7, 3, 16)).astype(np.float32)
    pos = np.arange(7, dtype=np.int32) + 1000
    got = common.apply_rope(_t(x, getattr(torch, dtype)), torch.from_numpy(pos), theta)
    want = jax_common.apply_rope(jnp.asarray(x, dtype), jnp.asarray(pos), theta)
    tol = 2e-5 if dtype == "float32" else 8e-3
    np.testing.assert_allclose(got.float().numpy(), _np(want), rtol=tol, atol=tol)
    # half-split pairs would differ: the layout is what is checked
    assert not np.allclose(got.float().numpy()[..., :8], _np(want)[..., 0::2], atol=1e-2)


def _gqa_weights(rng, d, h, kv, dh):
    return {name: rng.standard_normal(shape).astype(np.float32) / np.sqrt(shape[0])
            for name, shape in (("wq", (d, h * dh)), ("wk", (d, kv * dh)),
                                ("wv", (d, kv * dh)), ("wo", (h * dh, d)))}


@pytest.mark.parametrize("use_kernels", [True, False])
@pytest.mark.parametrize("window", [0, 5])
def test_gqa_attention_without_cache_matches(use_kernels, window):
    rng = np.random.default_rng(2)
    d, h, kv, dh, S = 32, 4, 2, 8, 19
    p = _gqa_weights(rng, d, h, kv, dh)
    x = rng.standard_normal((2, S, d)).astype(np.float32)
    pos = np.arange(S, dtype=np.int32)
    want, _ = jax_attention.gqa_attention({k: jnp.asarray(a) for k, a in p.items()},
                                          jnp.asarray(x), jnp.asarray(pos), h, kv, dh,
                                          10_000.0, window=window)
    got, _ = attention.gqa_attention({k: _t(a) for k, a in p.items()}, _t(x),
                                     torch.from_numpy(pos), h, kv, dh, 10_000.0,
                                     window=window, use_kernels=use_kernels)
    np.testing.assert_allclose(got.numpy(), _np(want), rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("start,S", [(0, 6), (6, 3), (9, 1)])
def test_gqa_attention_with_cache_matches(start, S):
    """Prefill into an empty cache (the kernel route), a chunk after earlier
    tokens and a one-token decode (the plain route) write the same keys and
    values into the cache and return the same output as the reference."""
    rng = np.random.default_rng(3)
    d, h, kv, dh, L, window = 32, 4, 2, 8, 12, 4
    p = _gqa_weights(rng, d, h, kv, dh)
    x = rng.standard_normal((2, S, d)).astype(np.float32)
    ck = rng.standard_normal((2, L, kv, dh)).astype(np.float32)
    cv = rng.standard_normal((2, L, kv, dh)).astype(np.float32)
    ck[:, start:] = cv[:, start:] = 0.0      # positions not yet written
    pos = start + np.arange(S, dtype=np.int32)
    want, wcache = jax_attention.gqa_attention(
        {k: jnp.asarray(a) for k, a in p.items()}, jnp.asarray(x), jnp.asarray(pos), h, kv,
        dh, 10_000.0, window=window, cache={"k": jnp.asarray(ck), "v": jnp.asarray(cv)},
        cache_index=jnp.int32(start))
    cache = {"k": _t(ck), "v": _t(cv)}
    got, gcache = attention.gqa_attention(
        {k: _t(a) for k, a in p.items()}, _t(x), torch.from_numpy(pos), h, kv, dh, 10_000.0,
        window=window, cache=cache, cache_index=start, use_kernels=True)
    assert gcache is cache  # updated in place
    np.testing.assert_allclose(got.numpy(), _np(want), rtol=1e-5, atol=1e-5)
    for name in ("k", "v"):
        np.testing.assert_allclose(cache[name].numpy(), _np(wcache[name]), rtol=1e-6,
                                   atol=1e-6)


@pytest.mark.parametrize("use_kernels", [True, False])
def test_gqa_attention_above_flash_threshold_matches(use_kernels):
    """S * L above ``_FLASH_THRESHOLD``: the reference runs its blocked
    online softmax, the port the kernel route or the plain route."""
    rng = np.random.default_rng(4)
    d, h, kv, dh, S = 16, 2, 1, 8, 2050
    assert S * S > jax_attention._FLASH_THRESHOLD
    p = _gqa_weights(rng, d, h, kv, dh)
    x = rng.standard_normal((1, S, d)).astype(np.float32)
    pos = np.arange(S, dtype=np.int32)
    want, _ = jax_attention.gqa_attention({k: jnp.asarray(a) for k, a in p.items()},
                                          jnp.asarray(x), jnp.asarray(pos), h, kv, dh,
                                          10_000.0, window=300)
    got, _ = attention.gqa_attention({k: _t(a) for k, a in p.items()}, _t(x),
                                     torch.from_numpy(pos), h, kv, dh, 10_000.0, window=300,
                                     use_kernels=use_kernels)
    np.testing.assert_allclose(got.numpy(), _np(want), rtol=1e-5, atol=1e-5)


def bf16_p_rounding_bound(v_max, wo, y):
    """Per-element bound on |port - reference| for a bf16 attention layer
    when one side rounds its probabilities P to bf16 before P.V and the
    other keeps them float32 (the reference's blocked route above
    ``_FLASH_THRESHOLD``).  With u = 2^-9, bf16's unit roundoff: rounding P
    moves o = sum_t P_t v_t by at most u * sum_t P_t |v_t| <= u * max|v|;
    each side rounds o (|o| <= max|v|) to bf16 once more, u * max|v| each;
    then y = o @ wo in bf16 moves y_k by at most that times the column sum
    sum_j |wo_jk|, plus one bf16 rounding of y on each side, 2u|y_k|."""
    u = 2.0**-9
    col = np.abs(wo).sum(axis=0)
    return 3 * u * v_max * col + 2 * u * np.abs(y)


@pytest.mark.parametrize("use_kernels", [True, False])
def test_gqa_attention_bf16_prefill_into_served_cache_matches(use_kernels):
    """The served LM cell's shape at reduced width, in bfloat16: a 2048-token
    prompt fills a 2064-slot cache (2048 prompt + 16 generated tokens, as
    ``launch.serve`` sizes it).  S x L = 2048 x 2064 lies above
    ``_FLASH_THRESHOLD``, so the reference runs its blocked online softmax
    with float32 P; the port's kernel route (its plain version on the CPU)
    keeps P float32 as well, its plain route rounds P to bf16 (and its
    scores, as the reference's ``_sdpa`` does below the threshold).  Both
    stay within ``bf16_p_rounding_bound``; the cache holds the reference's
    keys and values."""
    rng = np.random.default_rng(5)
    d, h, kv, dh, S, L = 64, 4, 2, 16, 2048, 2064
    assert S * L > jax_attention._FLASH_THRESHOLD
    p = _gqa_weights(rng, d, h, kv, dh)
    x = rng.standard_normal((2, S, d)).astype(np.float32)
    pos = np.arange(S, dtype=np.int32)
    empty = jnp.zeros((2, L, kv, dh), jnp.bfloat16)
    want, wcache = jax_attention.gqa_attention(
        {k: jnp.asarray(a, jnp.bfloat16) for k, a in p.items()}, jnp.asarray(x, jnp.bfloat16),
        jnp.asarray(pos), h, kv, dh, 10_000.0, cache={"k": empty, "v": empty},
        cache_index=jnp.int32(0))
    cache = {name: torch.zeros((2, L, kv, dh), dtype=torch.bfloat16) for name in ("k", "v")}
    got, _ = attention.gqa_attention(
        {k: _t(a, torch.bfloat16) for k, a in p.items()}, _t(x, torch.bfloat16),
        torch.from_numpy(pos), h, kv, dh, 10_000.0, cache=cache, cache_index=0,
        use_kernels=use_kernels)
    assert got.dtype == torch.bfloat16
    for name in ("k", "v"):
        # the projections round to bf16 in another summation order (and,
        # for the keys, once more through RoPE): a bf16 step or two of the
        # largest element
        want_c = _np(wcache[name])
        np.testing.assert_allclose(cache[name].float().numpy(), want_c, rtol=0,
                                   atol=2**-7 * np.abs(want_c).max())
    want = _np(want)
    bound = bf16_p_rounding_bound(float(cache["v"].float().abs().max()),
                                  _t(p["wo"], torch.bfloat16).float().numpy(), want)
    assert (np.abs(got.float().numpy() - want) <= bound).all()


# ------------------------------------------------------------ whole models

TINY = TransformerConfig(
    name="tiny", n_layers=4, d_model=64, n_heads=4, n_kv_heads=2, d_head=16,
    d_ff=128, vocab=101, window_pattern=(8, 8, 0), dtype="float32",
    param_dtype="float32",
)
CONFIGS = {"tiny": TINY, **{a: reduce_lm_config(get_arch(a).model_config) for a in ARCHS}}


def _weights(cfg: TransformerConfig, seed: int):
    """The reference's parameter tree as numpy, with random norm scales."""
    params = jax_tf.init_transformer(jax.random.PRNGKey(seed), jax_tf.TransformerConfig(
        **dataclasses.asdict(cfg)))
    tree = jax.tree.map(np.asarray, params)
    rng = np.random.default_rng(seed)
    for name in ("ln1", "ln2"):
        tree["layers"][name] = rng.standard_normal(tree["layers"][name].shape).astype(
            np.float32) * 0.1
    tree["final_norm"] = rng.standard_normal(cfg.d_model).astype(np.float32) * 0.1
    return tree


def _jax_cfg(cfg):
    return jax_tf.TransformerConfig(**dataclasses.asdict(cfg))


def _jax_generate(tree, cfg, prompts, gen):
    jcfg = _jax_cfg(cfg)
    params = jax.tree.map(jnp.asarray, tree)
    B, P = prompts.shape
    caches = jax_tf.init_cache(jcfg, B, P + gen)
    logits, caches = jax_tf.prefill(params, jnp.asarray(prompts), jcfg, caches)
    first = logits
    tok = jnp.argmax(logits, -1)[:, None].astype(jnp.int32)
    toks, steps = [tok], []
    for s in range(gen - 1):
        logits, caches = jax_tf.decode_step(params, tok, jcfg, caches, jnp.int32(P + s))
        steps.append(logits)
        tok = jnp.argmax(logits, -1)[:, None].astype(jnp.int32)
        toks.append(tok)
    return _np(first), [_np(s) for s in steps], np.concatenate([np.asarray(t) for t in toks], 1)


@pytest.mark.parametrize("name", list(CONFIGS))
@pytest.mark.parametrize("use_kernels", [True, False])
def test_forward_matches_reference(name, use_kernels):
    cfg = CONFIGS[name]
    tree = _weights(cfg, seed=0)
    toks = np.random.default_rng(5).integers(0, cfg.vocab, (2, 24))
    want, _, _ = jax_tf.forward(jax.tree.map(jnp.asarray, tree), jnp.asarray(toks),
                                _jax_cfg(cfg))
    model = convert.transformer_params(tree, cfg, device="cpu")
    got, caches = transformer.forward(model, torch.from_numpy(toks), use_kernels=use_kernels)
    assert caches is None and got.shape == (2, 24, cfg.vocab)
    np.testing.assert_allclose(got.numpy(), _np(want), rtol=1e-4, atol=1e-4)


@pytest.mark.parametrize("name", list(CONFIGS))
@pytest.mark.parametrize("use_kernels", ["auto", True])
def test_prefill_and_decode_match_reference(name, use_kernels):
    """prefill + 7 decode steps: every step's logits within 1e-4 of the
    reference's, and the 8 greedy tokens identical."""
    cfg = CONFIGS[name]
    tree = _weights(cfg, seed=1)
    prompts = np.random.default_rng(6).integers(0, cfg.vocab, (3, 13))
    first, steps, want_toks = _jax_generate(tree, cfg, prompts, 8)

    model = convert.transformer_params(tree, cfg, device="cpu")
    out = serve.generate(model, torch.from_numpy(prompts), 8, use_kernels=use_kernels)
    np.testing.assert_allclose(out["prefill_logits"].numpy(), first, rtol=1e-4, atol=1e-4)
    np.testing.assert_array_equal(out["tokens"].numpy(), want_toks)
    # CPU calls launch nothing
    assert out["launches"] == {"prefill": NO_LAUNCHES, "decode": NO_LAUNCHES}

    # decode_step by hand, step by step, against the reference's logits
    caches = transformer.init_cache(cfg, 3, 21, "cpu")
    logits, caches = transformer.prefill(model, torch.from_numpy(prompts), caches,
                                         use_kernels=use_kernels)
    for s, want in enumerate(steps):
        tok = torch.from_numpy(want_toks[:, s:s + 1])
        logits, caches = transformer.decode_step(model, tok, caches, 13 + s)
        np.testing.assert_allclose(logits.numpy(), want, rtol=1e-4, atol=1e-4)


def test_bfloat16_forward_within_stated_tolerance():
    """bfloat16 activations, float32 weights cast at use in both packages.
    The two round at other places (matmul outputs, and the port's kernel
    route keeps float32 probabilities where the reference rounds them to
    bfloat16), each rounding about 2^-8 relative; through four layers the
    logits stay within 3% of their largest magnitude."""
    cfg = CONFIGS["gemma3-12b"].replace(dtype="bfloat16")
    tree = _weights(cfg, seed=2)
    toks = np.random.default_rng(7).integers(0, cfg.vocab, (2, 20))
    want = _np(jax_tf.forward(jax.tree.map(jnp.asarray, tree), jnp.asarray(toks),
                              _jax_cfg(cfg))[0])
    model = convert.transformer_params(tree, cfg, device="cpu")
    held = convert.transformer_params(tree, cfg, device="cpu", dtype=torch.bfloat16)
    for m, use in ((model, True), (model, False), (held, True)):
        got, _ = transformer.forward(m, torch.from_numpy(toks), use_kernels=use)
        assert got.dtype == torch.bfloat16
        err = np.abs(got.float().numpy() - want).max()
        assert err <= 0.03 * np.abs(want).max(), (use, err, np.abs(want).max())


def test_transformer_params_checks_the_tree():
    cfg = CONFIGS["tiny"]
    tree = _weights(cfg, seed=0)
    bad = jax.tree.map(lambda a: a, tree)
    bad["layers"]["attn"]["wq"] = bad["layers"]["attn"]["wq"][:, :, :8]
    with pytest.raises(ValueError, match="shape"):
        convert.transformer_params(bad, cfg, device="cpu")
    with pytest.raises(ValueError, match="stacked layers"):
        convert.transformer_params(tree, cfg.replace(n_layers=3), device="cpu")


def test_init_transformer_is_seeded_and_scaled():
    cfg = CONFIGS["granite-20b"]
    models = []
    for _ in range(2):
        g = torch.Generator().manual_seed(0)
        models.append(transformer.init_transformer(cfg, g, "cpu"))
    for (n, a), (_, b) in zip(models[0].named_parameters(), models[1].named_parameters()):
        assert torch.equal(a, b), n
    w = models[0].layers[0].ffn["w_in"]
    assert abs(float(w.std()) * np.sqrt(cfg.d_model) - 1.0) < 0.05
    assert abs(float(models[0].embed.std()) - 0.02) < 0.002
    assert float(models[0].layers[1].ln1.abs().max()) == 0.0


# ------------------------------------------------------------ launcher

@pytest.mark.parametrize("arch", ARCHS)
def test_serve_launcher_reduced_on_cpu(arch, capsys):
    out = serve.main(["--arch", arch, "--reduced", "--device", "cpu", "--requests", "2",
                      "--prompt-len", "9", "--gen", "4"])
    line = capsys.readouterr().out
    assert f"{arch} (reduced, cpu): 2 requests x 9 prompt tokens" in line
    assert "tok/s" in line and "ms/step" in line
    toks = out["tokens"]
    assert toks.shape == (2, 4) and int(toks.min()) >= 0 and int(toks.max()) < 211
    assert out["launches"] == {"prefill": NO_LAUNCHES, "decode": NO_LAUNCHES}
