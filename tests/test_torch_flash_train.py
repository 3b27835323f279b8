"""The blocked attention with its FlashAttention-2 backward
(``repro_torch.models.attention._flash_sdpa``) against the reference's
``_flash_sdpa`` under ``jax.vjp``, and ``lm_loss`` through it against the
reference's ``lm_loss`` + ``jax.value_and_grad``.

Inputs come from seeded numpy generators, the LMs' weights from the
reference's ``init_transformer`` through ``convert``.  The reference takes
its blocked route above ``_FLASH_THRESHOLD`` score elements; the LM tests
lower both packages' threshold from the test (as the reference's own
``tests/test_models.py`` does) and, to cut the sequence into several
blocks at a small size, both packages' ``_Q_BLOCK`` and ``_KV_BLOCK``.

Tolerances.  float32: the output and each gradient within 1e-5 of that
tensor's largest |value| (float32 sums in another order), the loss within
1e-5 relative.  bf16 operands: 4e-2 of the largest, the loss 2e-2
relative, the bound of ``tests/test_torch_train_models.py`` that
``tests/bf16_gradient_spread.py`` measures.  Skipping a block pair that
the mask excludes whole changes no value: the port's planned route equals
computing every pair exactly.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.models import attention as jax_attention
from repro.models import transformer as jax_tf
from repro_torch import convert
from repro_torch.configs import get_arch
from repro_torch.configs.common import reduce_lm_config
from repro_torch.models import attention, transformer
from test_torch_train_models import _get, _jax_cfg, _port_grads_by_leaf

F32 = 1e-5
BF16_LOSS = 2e-2
BF16 = 4e-2

# (B, S, L, KV, G, dh, dv, window, q_offset, kv_last): q positions are
# q_offset + arange(S), key positions arange(L)
CASES = {
    "gqa": (1, 700, 1300, 2, 2, 16, 16, 0, 0, 2**30),
    "gqa_window": (2, 1100, 1100, 2, 3, 16, 16, 300, 0, 2**30),
    "mqa": (1, 520, 1030, 1, 4, 16, 16, 0, 510, 2**30),
    "mla": (1, 530, 530, 3, 1, 24, 16, 0, 0, 2**30),
    "kv_last": (1, 300, 1500, 2, 2, 16, 16, 0, 1200, 1000),
    "kv_last_window": (1, 520, 1100, 1, 2, 16, 8, 700, 580, 900),
}


def _case(name, dtype):
    B, S, L, KV, G, dh, dv, w, q0, kv_last = CASES[name]
    rng = np.random.default_rng(sorted(CASES).index(name))
    q = rng.standard_normal((B, S, KV, G, dh)).astype(np.float32)
    k = rng.standard_normal((B, L, KV, dh)).astype(np.float32)
    v = rng.standard_normal((B, L, KV, dv)).astype(np.float32)
    do = rng.standard_normal((B, S, KV, G, dv)).astype(np.float32)
    qpos = (q0 + np.arange(S)).astype(np.int32)
    kpos = np.arange(L).astype(np.int32)
    scale = float(np.float32(1.0) / np.sqrt(np.float32(dh)))
    if dtype == "bfloat16":
        q, k, v, do = (np.asarray(jnp.asarray(a, jnp.bfloat16).astype(jnp.float32))
                       for a in (q, k, v, do))
    return (q, k, v, do, qpos, kpos, kv_last, w, scale), (q0, S, L)


def _reference(q, k, v, do, qpos, kpos, kv_last, w, scale, dtype):
    jd = getattr(jnp, dtype)

    def f(q, k, v):
        return jax_attention._flash_sdpa(q, k, v, jnp.asarray(qpos), jnp.asarray(kpos),
                                         jnp.int32(kv_last), w, scale)

    out, vjp = jax.vjp(f, *(jnp.asarray(a, jd) for a in (q, k, v)))
    grads = vjp(jnp.asarray(do, out.dtype))
    return [np.asarray(jnp.asarray(a, jnp.float32)) for a in (out, *grads)]


def _port(q, k, v, do, qpos, kpos, kv_last, w, scale, dtype, plan=None):
    td = getattr(torch, dtype)
    ts = [torch.tensor(a).to(td).requires_grad_(True) for a in (q, k, v)]
    out = attention._flash_sdpa(*ts, torch.from_numpy(qpos), torch.from_numpy(kpos), kv_last,
                                w, scale, plan)
    out.backward(torch.tensor(do).to(td))
    return [t.detach().float().numpy() for t in (out, *(x.grad for x in ts))]


def _close(got, want, tol, what):
    bound = tol * max(float(np.abs(want).max()), 1e-30)
    err = float(np.abs(got.astype(np.float64) - want.astype(np.float64)).max())
    assert err <= bound, (what, err, bound)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("name", sorted(CASES))
def test_flash_sdpa_and_its_gradients_match_the_reference(name, dtype):
    args, (q0, S, L) = _case(name, dtype)
    want = _reference(*args, dtype)
    kv_last, w = args[6], args[7]
    plan = attention.block_plan(q0, S, 0, L, kv_last, w)
    got = _port(*args, dtype, plan)
    tol = F32 if dtype == "float32" else BF16
    for what, g, r in zip(("out", "dq", "dk", "dv"), got, want):
        _close(g, r, tol, f"{name} {dtype} {what}")


@pytest.mark.parametrize("name", sorted(CASES))
def test_skipping_masked_block_pairs_is_exact(name):
    """The planned route (masked-whole block pairs skipped) against every
    pair computed: the output and the three gradients equal."""
    args, (q0, S, L) = _case(name, "float32")
    kv_last, w = args[6], args[7]
    plan = attention.block_plan(q0, S, 0, L, kv_last, w)
    every = _port(*args, "float32", None)
    planned = _port(*args, "float32", plan)
    for what, a, b in zip(("out", "dq", "dk", "dv"), planned, every):
        np.testing.assert_array_equal(a, b, err_msg=f"{name} {what}")


@pytest.mark.parametrize("name", sorted(CASES))
def test_block_plan_keeps_exactly_the_pairs_with_a_valid_entry(name):
    """``block_plan`` from position ranges against the block masks of the
    padded positions themselves: a pair is kept iff its mask has a True,
    and the plan skips some pair in every case but one."""
    _, (q0, S, L) = _case(name, "float32")
    kv_last, w = CASES[name][9], CASES[name][7]
    qp, _ = attention._pad_dim(q0 + torch.arange(S, dtype=torch.int32), 0, attention._Q_BLOCK)
    kp, _ = attention._pad_dim(torch.arange(L, dtype=torch.int32), 0, attention._KV_BLOCK,
                               attention._PAD_POS)
    qb, kb = qp.reshape(-1, attention._Q_BLOCK), kp.reshape(-1, attention._KV_BLOCK)
    want = tuple(tuple(j for j in range(kb.shape[0])
                       if attention._block_mask(qb[i], kb[j], kv_last, w).any())
                 for i in range(qb.shape[0]))
    assert attention.block_plan(q0, S, 0, L, kv_last, w) == want
    skipped = sum(kb.shape[0] - len(row) for row in want)
    assert skipped > 0 or name == "mla", (name, want)


LM_ARCHS = ("internlm2-1.8b", "gemma3-12b", "deepseek-v2-lite-16b")


@pytest.fixture
def small_blocks(monkeypatch):
    """Both packages take the blocked route at any size, in blocks of 8
    queries and 16 keys."""
    for mod in (attention, jax_attention):
        monkeypatch.setattr(mod, "_FLASH_THRESHOLD", 1)
        monkeypatch.setattr(mod, "_Q_BLOCK", 8)
        monkeypatch.setattr(mod, "_KV_BLOCK", 16)


def _lm(arch: str, dtype: str):
    cfg = reduce_lm_config(get_arch(arch).model_config).replace(n_layers=2, dtype=dtype)
    tree = jax.tree.map(np.asarray, jax_tf.init_transformer(jax.random.PRNGKey(11),
                                                            _jax_cfg(cfg)))
    return cfg, tree


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("arch", LM_ARCHS)
def test_lm_loss_blocked_matches_the_reference(arch, dtype, small_blocks):
    """``lm_loss`` and every gradient through the blocked route: GQA with
    windows (gemma3's 4, 4, 0), GQA (internlm2) and MLA (deepseek, whose
    values are narrower than its keys), 40 positions in 5 query blocks and
    3 key blocks."""
    cfg, tree = _lm(arch, dtype)
    tokens = np.random.default_rng(8).integers(0, cfg.vocab, (2, 41)).astype(np.int32)
    jcfg = _jax_cfg(cfg)
    want, jg = jax.jit(jax.value_and_grad(
        lambda p: jax_tf.lm_loss(p, jnp.asarray(tokens), jcfg)))(jax.tree.map(jnp.asarray, tree))
    model = convert.transformer_params(tree, cfg, device="cpu")
    for p in model.parameters():
        p.requires_grad_(True)
    loss = transformer.lm_loss(model, torch.from_numpy(tokens))
    loss.backward()
    tol = F32 if dtype == "float32" else BF16
    assert abs(float(loss) - float(want)) <= min(tol, BF16_LOSS) * abs(float(want))
    got = _port_grads_by_leaf(model)
    assert len(got) == len(jax.tree.leaves(jg))
    for name, g in got.items():
        _close(np.asarray(g), np.asarray(_get(jg, name), np.float32), tol, f"{arch} {name}")


def test_blocked_and_plain_routes_agree_with_remat(small_blocks, monkeypatch):
    """The port's blocked route against its own plain ``S x S`` route on
    gemma3's windows, with remat recomputing the blocked forward in the
    backward: loss and every gradient within 1e-5."""
    cfg, tree = _lm("gemma3-12b", "float32")
    tokens = torch.from_numpy(
        np.random.default_rng(9).integers(0, cfg.vocab, (2, 41)).astype(np.int32))
    runs = {}
    for route, threshold in (("blocked", 1), ("plain", 10**18)):
        monkeypatch.setattr(attention, "_FLASH_THRESHOLD", threshold)
        model = convert.transformer_params(tree, cfg.replace(remat=True), device="cpu")
        for p in model.parameters():
            p.requires_grad_(True)
        loss = transformer.lm_loss(model, tokens)
        loss.backward()
        runs[route] = (float(loss), _port_grads_by_leaf(model))
    assert abs(runs["blocked"][0] - runs["plain"][0]) <= F32 * abs(runs["plain"][0])
    for name, g in runs["blocked"][1].items():
        _close(g, runs["plain"][1][name], F32, name)


def test_serving_keeps_its_routes(monkeypatch):
    """Inference mode (``forward``, ``prefill``, ``decode_step``) never takes
    the blocked route, whatever the threshold."""
    monkeypatch.setattr(attention, "_FLASH_THRESHOLD", 1)
    called = []
    real = attention._flash_sdpa
    monkeypatch.setattr(attention, "_flash_sdpa", lambda *a, **k: called.append(1) or real(*a))
    cfg, tree = _lm("internlm2-1.8b", "float32")
    model = convert.transformer_params(tree, cfg, device="cpu")
    tokens = torch.zeros((1, 9), dtype=torch.int32)
    transformer.forward(model, tokens, use_kernels=False)
    assert not called
    transformer.lm_loss(model, tokens)
    assert called


def test_mla_config_widths_reach_the_blocked_route(small_blocks, monkeypatch):
    """deepseek's reduced MLA has keys d_nope + d_rope = 24 wide and values
    16: the blocked core sees (B, S, H, 1, 24) queries and (B, L, H, 16)
    values."""
    cfg, _ = _lm("deepseek-v2-lite-16b", "float32")
    seen = []
    real = attention._flash_sdpa

    def spy(q, k, v, *rest):
        seen.append((tuple(q.shape), tuple(k.shape), tuple(v.shape)))
        return real(q, k, v, *rest)

    monkeypatch.setattr(attention, "_flash_sdpa", spy)
    model = transformer.init_transformer(cfg, torch.Generator().manual_seed(0), "cpu")
    transformer.lm_loss(model, torch.zeros((1, 17), dtype=torch.int32))
    H, m = cfg.n_heads, cfg.mla
    dk = m.d_nope + m.d_rope
    assert seen and all(s == ((1, 16, H, 1, dk), (1, 16, H, dk), (1, 16, H, m.d_v))
                        for s in seen), seen
