"""MLA attention and the MoE LMs of the port against the reference, on the
same weights and inputs: ``mla_attention`` (with and without a cache, on
both of the port's routes, across the reference's ``_FLASH_THRESHOLD``),
then ``forward``, ``prefill`` and ``decode_step`` of reduced
deepseek-v2-lite-16b (MLA + MoE) and reduced kimi-k2-1t-a32b (GQA + MoE)
through ``convert.transformer_params``, their experts' top-k ids layer by
layer, and the serving launcher.

Tolerances.  float32: ``1e-5`` for attention, ``1e-4`` for the logits of
whole models (the same arithmetic summed in another order, through three
layers); greedy tokens and top-k expert ids identical.  bfloat16: stated
at its test.  The reference's models run once a module: its forward layer
by layer (so that its routes can be recorded), its prefill and decode
under ``jax.jit``.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.models import attention as jax_attention
from repro.models import common as jax_common
from repro.models import moe as jax_moe
from repro.models import transformer as jax_tf
from repro_torch import convert
from repro_torch.configs import get_arch
from repro_torch.configs.common import reduce_lm_config
from repro_torch.launch import serve
from repro_torch.models import attention, moe, transformer
from repro_torch.models.attention import MLAConfig

MOE_ARCHS = ["deepseek-v2-lite-16b", "kimi-k2-1t-a32b"]


def _t(a, dtype=torch.float32):
    return torch.from_numpy(np.array(a, dtype=np.float32)).to(dtype)


def _np(x):
    return np.asarray(jnp.asarray(x).astype(jnp.float32))


def jax_config(cfg):
    """The reference's ``TransformerConfig`` of a port config, with its
    nested ``MLAConfig`` and ``MoEConfig``."""
    kw = {f.name: getattr(cfg, f.name) for f in dataclasses.fields(cfg)}
    if cfg.mla is not None:
        kw["mla"] = jax_attention.MLAConfig(**dataclasses.asdict(cfg.mla))
    if cfg.moe is not None:
        kw["moe"] = jax_moe.MoEConfig(**dataclasses.asdict(cfg.moe))
    return jax_tf.TransformerConfig(**kw)


# ------------------------------------------------------------ attention

MLA = MLAConfig(kv_lora=24, d_nope=16, d_rope=8, d_v=12)


def _mla_weights(rng, d, h, mla):
    shapes = {"w_dkv": (d, mla.kv_lora), "kv_norm": (mla.kv_lora,),
              "w_uk": (mla.kv_lora, h * mla.d_nope), "w_uv": (mla.kv_lora, h * mla.d_v),
              "w_kr": (d, mla.d_rope), "wo": (h * mla.d_v, d)}
    if mla.q_lora:
        shapes.update(w_dq=(d, mla.q_lora), q_norm=(mla.q_lora,),
                      w_uq=(mla.q_lora, h * (mla.d_nope + mla.d_rope)))
    else:
        shapes["wq"] = (d, h * (mla.d_nope + mla.d_rope))
    return {name: (rng.standard_normal(shape) / (np.sqrt(shape[0]) if len(shape) == 2 else 4))
            .astype(np.float32) for name, shape in shapes.items()}


def _mla_pair(p, x, pos, h, mla, window, use_kernels, cache=None, start=None):
    jcache = None if cache is None else {k: jnp.asarray(v) for k, v in cache.items()}
    want, wcache = jax_attention.mla_attention(
        {k: jnp.asarray(a) for k, a in p.items()}, jnp.asarray(x), jnp.asarray(pos), h,
        jax_attention.MLAConfig(**dataclasses.asdict(mla)), 10_000.0, window=window,
        cache=jcache, cache_index=None if start is None else jnp.int32(start))
    tcache = None if cache is None else {k: _t(v) for k, v in cache.items()}
    got, gcache = attention.mla_attention(
        {k: _t(a) for k, a in p.items()}, _t(x), torch.from_numpy(pos), h, mla, 10_000.0,
        window=window, cache=tcache, cache_index=start, use_kernels=use_kernels)
    assert gcache is tcache  # updated in place
    return got, _np(want), gcache, wcache


@pytest.mark.parametrize("use_kernels", [True, False])
@pytest.mark.parametrize("window,q_lora", [(0, 0), (5, 20)])
def test_mla_attention_without_cache_matches(use_kernels, window, q_lora):
    rng = np.random.default_rng(2)
    d, h, S = 32, 4, 19
    mla = MLA.replace(q_lora=q_lora)
    p = _mla_weights(rng, d, h, mla)
    x = rng.standard_normal((2, S, d)).astype(np.float32)
    got, want, _, _ = _mla_pair(p, x, np.arange(S, dtype=np.int32), h, mla, window, use_kernels)
    assert got.shape == (2, S, d)
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("start,S", [(0, 6), (6, 3), (9, 1)])
def test_mla_attention_with_cache_matches(start, S):
    """A prefill into an empty cache (the kernel route), a chunk after
    earlier tokens and a one-token decode (the plain route) write the same
    latent and rotary key into the cache and return the reference's
    output."""
    rng = np.random.default_rng(3)
    d, h, L, window = 32, 4, 12, 4
    p = _mla_weights(rng, d, h, MLA)
    x = rng.standard_normal((2, S, d)).astype(np.float32)
    cache = {"ckv": rng.standard_normal((2, L, MLA.kv_lora)).astype(np.float32),
             "kr": rng.standard_normal((2, L, MLA.d_rope)).astype(np.float32)}
    for a in cache.values():
        a[:, start:] = 0.0                  # positions not yet written
    pos = start + np.arange(S, dtype=np.int32)
    got, want, gcache, wcache = _mla_pair(p, x, pos, h, MLA, window, True, cache, start)
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-5, atol=1e-5)
    for name in ("ckv", "kr"):
        np.testing.assert_allclose(gcache[name].numpy(), _np(wcache[name]), rtol=1e-6,
                                   atol=1e-6)


@pytest.mark.parametrize("use_kernels", [True, False])
def test_mla_attention_above_flash_threshold_matches(use_kernels):
    """S * L above ``_FLASH_THRESHOLD``: the reference runs its blocked
    online softmax (float32 probabilities), the port the kernel route (the
    flash kernel's plain version on the CPU, values padded to the q/k
    width) or the plain route."""
    rng = np.random.default_rng(4)
    d, h, S = 16, 2, 2050
    assert S * S > jax_attention._FLASH_THRESHOLD
    mla = MLAConfig(kv_lora=8, d_nope=8, d_rope=4, d_v=6)
    p = _mla_weights(rng, d, h, mla)
    x = rng.standard_normal((1, S, d)).astype(np.float32)
    got, want, _, _ = _mla_pair(p, x, np.arange(S, dtype=np.int32), h, mla, 300, use_kernels)
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("use_kernels", [True, False])
def test_mla_attention_bf16_prefill_into_served_cache_matches(use_kernels):
    """deepseek-v2-lite's served cell at reduced width, in bfloat16: a
    2048-token prompt fills a 2064-slot latent cache.  S x L = 2048 x 2064
    lies above ``_FLASH_THRESHOLD``: the reference folds the rotary key into
    per-head keys and runs its blocked route with float32 P; the port's
    kernel route (its plain version on the CPU) keeps P float32, its plain
    route rounds P to bf16.  Both stay within ``bf16_p_rounding_bound``
    (tests/test_torch_lm.py) over the values w_uv expands from the latent
    cache; the cache holds the reference's latent and rotary key."""
    from test_torch_lm import bf16_p_rounding_bound

    rng = np.random.default_rng(6)
    d, h, S, L = 32, 2, 2048, 2064
    assert S * L > jax_attention._FLASH_THRESHOLD
    mla = MLAConfig(kv_lora=16, d_nope=8, d_rope=8, d_v=8)
    p = _mla_weights(rng, d, h, mla)
    x = rng.standard_normal((2, S, d)).astype(np.float32)
    pos = np.arange(S, dtype=np.int32)
    jcache = {"ckv": jnp.zeros((2, L, mla.kv_lora), jnp.bfloat16),
              "kr": jnp.zeros((2, L, mla.d_rope), jnp.bfloat16)}
    want, wcache = jax_attention.mla_attention(
        {k: jnp.asarray(a, jnp.bfloat16) for k, a in p.items()}, jnp.asarray(x, jnp.bfloat16),
        jnp.asarray(pos), h, jax_attention.MLAConfig(**dataclasses.asdict(mla)), 10_000.0,
        cache=jcache, cache_index=jnp.int32(0))
    cache = {"ckv": torch.zeros((2, L, mla.kv_lora), dtype=torch.bfloat16),
             "kr": torch.zeros((2, L, mla.d_rope), dtype=torch.bfloat16)}
    wb = {k: _t(a, torch.bfloat16) for k, a in p.items()}
    got, _ = attention.mla_attention(wb, _t(x, torch.bfloat16), torch.from_numpy(pos), h, mla,
                                     10_000.0, cache=cache, cache_index=0,
                                     use_kernels=use_kernels)
    assert got.dtype == torch.bfloat16
    for name in ("ckv", "kr"):
        # the projections round to bf16 in another summation order (and,
        # for the keys, once more through RoPE): a bf16 step or two of the
        # largest element
        want_c = _np(wcache[name])
        np.testing.assert_allclose(cache[name].float().numpy(), want_c, rtol=0,
                                   atol=2**-7 * np.abs(want_c).max())
    v = cache["ckv"][:, :S] @ wb["w_uv"]
    want = _np(want)
    bound = bf16_p_rounding_bound(float(v.float().abs().max()), wb["wo"].float().numpy(), want)
    assert (np.abs(got.float().numpy() - want) <= bound).all()


# ------------------------------------------------------------ configs

def test_deepseek_first_dense_layer_is_10944_wide():
    """The full config, built on the meta device: the dense first layer's
    FFN is d_ff_dense = 10,944 wide, the 26 MoE layers hold 64 experts of
    1408 and two shared ones, and the whole is 15,706,484,224 parameters."""
    cfg = get_arch("deepseek-v2-lite-16b").model_config
    model = transformer.Transformer(cfg, torch.device("meta"))
    first = model.layers[0]
    assert first.moe is None and first.ffn["w_gate"].shape == (2048, 10944)
    for layer in model.layers[1:]:
        assert layer.ffn is None
        assert layer.moe["w_gate"].shape == (64, 2048, 1408)
        assert layer.moe["shared_up"].shape == (2048, 2 * 1408)
        assert layer.moe["router"].dtype == torch.float32
        assert layer.attn["wq"].shape == (2048, 16 * 192) and layer.attn["w_uv"].shape == (512, 2048)
    assert sum(p.numel() for p in model.parameters()) == 15_706_484_224
    assert serve.lm_param_count(cfg) == 15_706_484_224


def test_serve_config_refuses_what_one_card_cannot_hold():
    with pytest.raises(NotImplementedError, match="item 11"):
        serve.serve_config("kimi-k2-1t-a32b", reduced=False)
    cfg = serve.serve_config("deepseek-v2-lite-16b", reduced=False)
    assert cfg.param_dtype == "bfloat16" and cfg.n_layers == 27


# ------------------------------------------------------------ whole models

CONFIGS = {a: reduce_lm_config(get_arch(a).model_config) for a in MOE_ARCHS}


def _weights(cfg, seed: int):
    """The reference's parameter tree as numpy, with random norm scales."""
    tree = jax.tree.map(np.asarray, jax_tf.init_transformer(jax.random.PRNGKey(seed),
                                                            jax_config(cfg)))
    rng = np.random.default_rng(seed)
    layers = [tree["layers"], *tree["prefix"]]
    for layer in layers:
        for name in ("ln1", "ln2"):
            layer[name] = rng.standard_normal(layer[name].shape).astype(np.float32) * 0.1
        if "kv_norm" in layer["attn"]:
            layer["attn"]["kv_norm"] = rng.standard_normal(
                layer["attn"]["kv_norm"].shape).astype(np.float32) * 0.1
    tree["final_norm"] = rng.standard_normal(cfg.d_model).astype(np.float32) * 0.1
    return tree


PROMPTS = (3, 13)
GEN = 6


def _capture_routes(monkeypatch) -> dict:
    """Record the top-k ids of every ``_route`` call of either package."""
    seen = {"port": [], "ref": []}
    real, jreal = moe._route, jax_moe._route

    def port(*a):
        out = real(*a)
        seen["port"].append(out[0].numpy())
        return out

    def ref(*a):
        out = jreal(*a)
        seen["ref"].append(np.asarray(out[0]))
        return out

    monkeypatch.setattr(moe, "_route", port)
    monkeypatch.setattr(jax_moe, "_route", ref)
    return seen


def _reference_by_layer(tree, cfg, tokens):
    """The reference's forward run eagerly layer by layer (its scan body on
    each layer's slice of the stack), so that its routes can be recorded:
    the logits in float32."""
    jcfg = jax_config(cfg)
    params = jax.tree.map(jnp.asarray, tree)
    dt = jcfg.act_dtype
    x = params["embed"].astype(dt)[jnp.asarray(tokens)]
    pos = jnp.arange(tokens.shape[1], dtype=jnp.int32)
    windows = jcfg.windows()
    layers = [(p, False) for p in params["prefix"]] + [
        (jax.tree.map(lambda a, i=i: a[i], params["layers"]), True)
        for i in range(cfg.n_scan_layers)]
    for i, (p, is_moe) in enumerate(layers):
        x, _, _ = jax_tf._layer_apply(p, x, pos, windows[i], jcfg, moe_layer=is_moe)
    x = jax_common.rms_norm(x, params["final_norm"], cfg.norm_eps)
    return _np(x @ params.get("unembed", params["embed"]).astype(dt).T)


@pytest.fixture(scope="module", params=MOE_ARCHS)
def reference_run(request):
    """One reference run a module and arch: the tree, the full-sequence
    logits of its forward run layer by layer with each MoE layer's top-k ids
    recorded, and prefill + greedy decode (jitted)."""
    cfg = CONFIGS[request.param]
    jcfg = jax_config(cfg)
    tree = _weights(cfg, seed=0)
    params = jax.tree.map(jnp.asarray, tree)
    prompts = np.random.default_rng(6).integers(0, cfg.vocab, PROMPTS)
    with pytest.MonkeyPatch.context() as mp:
        seen = _capture_routes(mp)
        logits = _reference_by_layer(tree, cfg, prompts)
    prefill = jax.jit(lambda p, t, c: jax_tf.prefill(p, t, jcfg, c))
    decode = jax.jit(lambda p, t, c, i: jax_tf.decode_step(p, t, jcfg, c, i))
    B, P = PROMPTS
    caches = jax_tf.init_cache(jcfg, B, P + GEN)
    first, caches = prefill(params, jnp.asarray(prompts), caches)
    tok = jnp.argmax(first, -1)[:, None].astype(jnp.int32)
    toks, steps = [tok], []
    for s in range(GEN - 1):
        step, caches = decode(params, tok, caches, jnp.int32(P + s))
        steps.append(_np(step))
        tok = jnp.argmax(step, -1)[:, None].astype(jnp.int32)
        toks.append(tok)
    return {"name": request.param, "cfg": cfg, "tree": tree, "prompts": prompts,
            "logits": logits, "expert_ids": seen["ref"], "first": _np(first), "steps": steps,
            "tokens": np.concatenate([np.asarray(t) for t in toks], 1)}


@pytest.mark.parametrize("use_kernels", [True, False])
def test_moe_forward_matches_reference(reference_run, use_kernels):
    r = reference_run
    model = convert.transformer_params(r["tree"], r["cfg"], device="cpu")
    got, caches = transformer.forward(model, torch.from_numpy(r["prompts"]),
                                      use_kernels=use_kernels)
    assert caches is None and got.shape == (*PROMPTS, r["cfg"].vocab)
    np.testing.assert_allclose(got.numpy(), r["logits"], rtol=1e-4, atol=1e-4)


@pytest.mark.parametrize("use_kernels", [True, False])
def test_moe_prefill_and_decode_match_reference(reference_run, use_kernels):
    """prefill + 5 greedy decode steps through ``serve.generate``: the
    prefill logits within 1e-4 and the 6 tokens identical; then each
    ``decode_step``'s logits against the reference's."""
    r = reference_run
    cfg = r["cfg"]
    model = convert.transformer_params(r["tree"], cfg, device="cpu")
    prompts = torch.from_numpy(r["prompts"])
    out = serve.generate(model, prompts, GEN, use_kernels=use_kernels)
    np.testing.assert_allclose(out["prefill_logits"].numpy(), r["first"], rtol=1e-4, atol=1e-4)
    np.testing.assert_array_equal(out["tokens"].numpy(), r["tokens"])
    zero = {"flash_attention": 0, "grouped_matmul": 0}
    assert out["launches"] == {"prefill": zero, "decode": zero}  # CPU calls launch nothing

    B, P = PROMPTS
    caches = transformer.init_cache(cfg, B, P + GEN, "cpu")
    if cfg.attention == "mla":
        assert caches["layers"][0]["ckv"].shape == (B, P + GEN, cfg.mla.kv_lora)
    transformer.prefill(model, prompts, caches, use_kernels=use_kernels)
    for s, want in enumerate(r["steps"]):
        tok = torch.from_numpy(r["tokens"][:, s:s + 1])
        logits, caches = transformer.decode_step(model, tok, caches, P + s,
                                                 use_kernels=use_kernels)
        np.testing.assert_allclose(logits.numpy(), want, rtol=1e-4, atol=1e-4)


def test_moe_expert_ids_match_reference(reference_run, monkeypatch):
    """Every MoE layer's top-k expert ids in float32, equal to the
    reference's, on both of the port's routes."""
    r = reference_run
    model = convert.transformer_params(r["tree"], r["cfg"], device="cpu")
    for use in (True, False):
        seen = _capture_routes(monkeypatch)
        transformer.forward(model, torch.from_numpy(r["prompts"]), use_kernels=use)
        assert len(seen["port"]) == len(r["expert_ids"]) == r["cfg"].n_scan_layers
        for got_ids, want_ids in zip(seen["port"], r["expert_ids"]):
            np.testing.assert_array_equal(got_ids, want_ids)


@pytest.mark.parametrize("arch", MOE_ARCHS)
def test_moe_bfloat16_forward_within_stated_tolerance(arch, monkeypatch):
    """bf16 activations, float32 weights cast at use (the router float32) in
    both packages, and the port's weights held in bf16.  They round at other
    places (matmul outputs, the flash route's float32 probabilities, the MoE
    combine's single rounding; held weights round the norm scales too), each
    about 2^-8 relative.  A token whose hidden state sits near a routing tie
    may then pick another expert, a discrete change: at least 90% of the
    (token, k) picks agree in every MoE layer, and every position whose
    picks all agree has logits within 3% of the largest magnitude."""
    cfg = CONFIGS[arch].replace(dtype="bfloat16")
    tree = _weights(cfg, seed=2)
    toks = np.random.default_rng(7).integers(0, cfg.vocab, (2, 20))
    seen = _capture_routes(monkeypatch)
    want = _reference_by_layer(tree, cfg, toks)
    ref_ids = list(seen["ref"])
    model = convert.transformer_params(tree, cfg, device="cpu")
    held = convert.transformer_params(tree, cfg, device="cpu", dtype=torch.bfloat16)
    assert held.layers[1].moe["router"].dtype == torch.float32
    for m, use in ((model, True), (model, False), (held, True)):
        seen["port"].clear()
        got, _ = transformer.forward(m, torch.from_numpy(toks), use_kernels=use)
        assert got.dtype == torch.bfloat16
        same = np.stack([a == b for a, b in zip(seen["port"], ref_ids)])   # (layers, T, K)
        assert same.mean() >= 0.9, (use, same.mean())
        agree = same.all(axis=(0, 2)).reshape(toks.shape)
        err = np.abs(got.float().numpy() - want).max(axis=-1)
        assert agree.mean() >= 0.5 and (err[agree] <= 0.03 * np.abs(want).max()).all(), (
            use, agree.mean(), err.max())


def test_moe_init_transformer_is_seeded():
    cfg = CONFIGS["deepseek-v2-lite-16b"]
    models = [transformer.init_transformer(cfg, torch.Generator().manual_seed(0), "cpu")
              for _ in range(2)]
    for (n, a), (_, b) in zip(models[0].named_parameters(), models[1].named_parameters()):
        assert torch.equal(a, b), n
    w = models[0].layers[1].moe["w_gate"]
    assert abs(float(w.std()) * np.sqrt(cfg.d_model) - 1.0) < 0.05
    assert float(models[0].layers[1].attn["kv_norm"].abs().max()) == 0.0


@pytest.mark.parametrize("arch", MOE_ARCHS)
def test_serve_launcher_moe_reduced_on_cpu(arch, capsys):
    out = serve.main(["--arch", arch, "--reduced", "--device", "cpu", "--requests", "2",
                      "--prompt-len", "9", "--gen", "4"])
    line = capsys.readouterr().out
    assert f"{arch} (reduced, cpu): 2 requests x 9 prompt tokens" in line
    toks = out["tokens"]
    assert toks.shape == (2, 4) and int(toks.min()) >= 0 and int(toks.max()) < 211
