"""The port's MoE FFN against the reference's ``repro.models.moe`` on the
same weights and tokens: the router, the capacity and both slot functions,
``_moe_core`` with each engine on both of the port's routes (on the CPU
the kernel route runs ``grouped_matmul``'s plain version), capacity drops,
chunking with the padding tokens' top-k ties, and ``convert`` of an MoE
tree.

Equivalence hazards, one test each: the router stays float32 under a bf16
model; ``jax.lax.top_k`` breaks ties by the lower index (a stable
descending sort in the port); a capacity below the load drops the same
(token, expert) pairs; the port combines a token's K rows as one float32
sum where the reference adds them one by one.

Tolerances: float32 ``1e-6`` for the router and ``1e-5`` for an MoE
layer's output (the same products summed in another order); bfloat16 at
its test.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.models import attention as jax_attention
from repro.models import moe as jax_moe
from repro.models import transformer as jax_tf
from repro_torch import convert
from repro_torch.configs import get_arch
from repro_torch.configs.common import reduce_lm_config
from repro_torch.kernels.grouped_matmul.ops import grouped_matmul
from repro_torch.models import moe
from repro_torch.models.moe import MoEConfig

D = 48
CFG = MoEConfig(n_experts=8, top_k=3, d_ff=40, n_shared=2, capacity_factor=1.25,
                dispatch="sorted")


def _jcfg(cfg: MoEConfig):
    return jax_moe.MoEConfig(**dataclasses.asdict(cfg))


def _params(cfg: MoEConfig, seed: int = 0, dtype=jnp.float32):
    """The reference's ``init_moe`` tree as numpy (float32 values)."""
    p = jax_moe.init_moe(jax.random.PRNGKey(seed), D, _jcfg(cfg), dtype)
    return {k: np.asarray(v.astype(jnp.float32)) for k, v in p.items()}


def _tokens(T: int, seed: int = 1):
    return np.random.default_rng(seed).standard_normal((T, D)).astype(np.float32)


def _np(x):
    return np.asarray(jnp.asarray(x).astype(jnp.float32))


def _torch_params(p, dtype=torch.float32):
    return {k: torch.from_numpy(v).to(torch.float32 if k == "router" else dtype)
            for k, v in p.items()}


def test_select_dispatch_engine_matches():
    for E, K, dispatch in [(8, 3, "auto"), (6, 3, "auto"), (32, 2, "auto"), (64, 6, "auto"),
                           (64, 6, "gather"), (4, 1, "dense")]:
        cfg = CFG.replace(n_experts=E, top_k=K, dispatch=dispatch)
        assert moe.select_dispatch_engine(cfg, 100) == jax_moe.select_dispatch_engine(
            _jcfg(cfg), 100)


@pytest.mark.parametrize("n,E,cf", [(24, 64, 1.25), (49152, 64, 1.25), (30, 8, 0.5),
                                    (1000, 8, 4.0), (7, 3, 1.0), (98304, 384, 1.25)])
def test_capacity_matches(n, E, cf):
    assert moe._capacity(n, E, cf) == jax_moe._capacity(n, E, cf)


def test_route_matches():
    p = _params(CFG)
    x = _tokens(57)
    ids, w, aux = moe._route(torch.from_numpy(x), torch.from_numpy(p["router"]), CFG)
    jids, jw, jaux = jax_moe._route(jnp.asarray(x), jnp.asarray(p["router"]), _jcfg(CFG))
    assert ids.dtype == torch.int32
    np.testing.assert_array_equal(ids.numpy(), np.asarray(jids))
    np.testing.assert_allclose(w.numpy(), _np(jw), rtol=1e-6, atol=1e-6)
    np.testing.assert_allclose(float(aux), float(jaux), rtol=1e-6, atol=1e-6)


def test_route_top_k_ties_take_the_lower_index():
    """Zero tokens (the chunk padding) have uniform probabilities: every
    expert ties, and ``jax.lax.top_k`` takes experts 0..K-1 in order."""
    p = _params(CFG)
    x = np.zeros((5, D), np.float32)
    ids, w, _ = moe._route(torch.from_numpy(x), torch.from_numpy(p["router"]), CFG)
    jids, _, _ = jax_moe._route(jnp.asarray(x), jnp.asarray(p["router"]), _jcfg(CFG))
    np.testing.assert_array_equal(ids.numpy(), np.asarray(jids))
    assert ids.tolist() == [[0, 1, 2]] * 5
    assert torch.allclose(w, torch.full((5, 3), 1 / 3))


@pytest.mark.parametrize("C", [2, 5, 64])
def test_slots_match(C):
    """Both slot functions equal the reference's, and each other: the rank
    in a stable sort is the cumulative one-hot rank.  C = 2 and 5 drop."""
    flat_e = np.random.default_rng(C).integers(0, 8, 120).astype(np.int32)
    got = {name: fn(torch.from_numpy(flat_e), 8, C)
           for name, fn in (("sorted", moe._slots_sorted), ("gather", moe._slots_gather))}
    for name, jfn in (("sorted", jax_moe._slots_sorted), ("gather", jax_moe._slots_gather)):
        slot, keep = got[name]
        jslot, jkeep = jfn(jnp.asarray(flat_e), 8, C)
        np.testing.assert_array_equal(slot.numpy(), np.asarray(jslot))
        np.testing.assert_array_equal(keep.numpy(), np.asarray(jkeep))
    assert torch.equal(got["sorted"][0], got["gather"][0])
    assert (C == 64) == bool(got["sorted"][1].all())


def _core(cfg, engine, use_kernels, T=61, seed=0):
    """float32 outputs of the port's and the reference's ``_moe_core``."""
    p = _params(cfg, seed)
    x = _tokens(T, seed + 1)
    want, jaux = jax_moe._moe_core(jnp.asarray(x), {k: jnp.asarray(v) for k, v in p.items()},
                                   _jcfg(cfg), engine)
    got, aux = moe._moe_core(torch.from_numpy(x), _torch_params(p), cfg, engine, use_kernels)
    assert got.shape == (T, D) and got.dtype == torch.float32
    np.testing.assert_allclose(float(aux), float(jaux), rtol=1e-6, atol=1e-6)
    return got.numpy(), _np(want)


@pytest.mark.parametrize("engine", ["dense", "sorted", "gather"])
@pytest.mark.parametrize("use_kernels", [True, False])
def test_moe_core_matches(engine, use_kernels):
    got, want = _core(CFG, engine, use_kernels)
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("engine", ["sorted", "gather"])
@pytest.mark.parametrize("use_kernels", [True, False])
def test_moe_core_with_capacity_drops_matches(engine, use_kernels):
    """capacity_factor 0.5: about half the assignments are dropped; the kept
    (token, expert) pairs are the reference's."""
    cfg = CFG.replace(capacity_factor=0.5, n_shared=0)
    flat_e = moe._route(torch.from_numpy(_tokens(61, 1)),
                        torch.from_numpy(_params(cfg)["router"]), cfg)[0].reshape(-1)
    C = moe._capacity(61 * 3, 8, 0.5)
    assert not bool(moe._slots_sorted(flat_e, 8, C)[1].all())  # some are dropped
    got, want = _core(cfg, engine, use_kernels)
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("engine", ["sorted", "gather"])
@pytest.mark.parametrize("use_kernels", [True, False])
def test_moe_core_chunked_with_padding_ties_matches(engine, use_kernels):
    """chunk_tokens = 16 over 37 tokens: the last chunk holds 11 zero
    padding tokens whose probabilities all tie; they take capacity in
    experts 0..K-1 (capacity per chunk, factor 0.75 drops)."""
    cfg = CFG.replace(chunk_tokens=16, capacity_factor=0.75)
    got, want = _core(cfg, engine, use_kernels, T=37, seed=3)
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-5)


def test_kernel_route_groups_start_at_the_kept_counts_cumsum(monkeypatch):
    """The kernel route's three launches see groups that start at the
    exclusive cumsum of the kept counts, bounded by the capacity."""
    cfg = CFG.replace(capacity_factor=0.5)
    p = _torch_params(_params(cfg))
    x = torch.from_numpy(_tokens(40))
    seen = []
    real = moe.grouped_matmul

    def spy(a, w, starts, counts, max_rows=None):
        seen.append((starts.clone(), counts.clone(), max_rows, a.shape[0]))
        return real(a, w, starts, counts, max_rows)

    monkeypatch.setattr(moe, "grouped_matmul", spy)
    moe._moe_core(x, p, cfg, "sorted", use_kernels=True)
    moe._moe_core(x, p, cfg, "gather", use_kernels=True)
    C = moe._capacity(40 * 3, 8, 0.5)
    assert len(seen) == 6 and all(s[2] == C for s in seen)
    starts, counts = seen[0][0], seen[0][1]
    assert int(counts.max()) <= C and torch.equal(starts[1:], torch.cumsum(counts, 0)[:-1])
    assert all(torch.equal(s[0], starts) and torch.equal(s[1], counts) for s in seen)
    assert seen[0][3] == 40 * 3 and seen[3][3] == 40 * 3 + 1  # gather adds a drop row


def test_moe_bfloat16_within_stated_tolerance():
    """bf16 tokens and weights, the float32 router.  The reference adds a
    token's K rows one by one into a bf16 zeros_like(x), rounding at each
    add; the port sums them in float32 and rounds once.  With the expert
    products rounded alike, the outputs differ by a few bf16 steps of the
    output (2^-8 relative each): within 3% of the largest magnitude."""
    p = _params(CFG)
    x = _tokens(61)
    want, _ = jax_moe._moe_core(jnp.asarray(x, jnp.bfloat16),
                                {k: jnp.asarray(v, jnp.float32 if k == "router" else jnp.bfloat16)
                                 for k, v in p.items()}, _jcfg(CFG), "sorted")
    want = _np(want)
    for use in (True, False):
        got, _ = moe._moe_core(torch.from_numpy(x).bfloat16(),
                               _torch_params(p, torch.bfloat16), CFG, "sorted", use)
        assert got.dtype == torch.bfloat16
        err = np.abs(got.float().numpy() - want).max()
        assert err <= 0.03 * np.abs(want).max(), (use, err)


def test_router_stays_float32_under_bfloat16():
    """init_moe, the model and convert keep the router float32 when the rest
    is bf16, as the reference's init_moe draws it."""
    p = moe.init_moe(torch.Generator().manual_seed(0), D, CFG, torch.bfloat16)
    assert p["router"].dtype == torch.float32 and p["w_gate"].dtype == torch.bfloat16
    assert p["w_gate"].shape == (8, D, 40) and p["shared_down"].shape == (80, D)
    jp = jax_moe.init_moe(jax.random.PRNGKey(0), D, _jcfg(CFG), jnp.bfloat16)
    assert jp["router"].dtype == jnp.float32 and set(jp) == set(p)

    # convert of an MoE model's tree, asked for bf16
    cfg = reduce_lm_config(get_arch("deepseek-v2-lite-16b"))
    jcfg = jax_tf.TransformerConfig(**{
        **{f.name: getattr(cfg, f.name) for f in dataclasses.fields(cfg)},
        "mla": jax_attention.MLAConfig(**dataclasses.asdict(cfg.mla)), "moe": _jcfg(cfg.moe)})
    tree = jax.tree.map(np.asarray, jax_tf.init_transformer(jax.random.PRNGKey(0), jcfg))
    model = convert.transformer_params(tree, cfg, device="cpu", dtype=torch.bfloat16)
    assert model.layers[0].moe is None and model.layers[0].ffn["w_up"].shape == (64, 128)
    for i, layer in enumerate(model.layers[1:]):
        assert layer.ffn is None and layer.moe["router"].dtype == torch.float32
        assert torch.equal(layer.moe["router"], torch.from_numpy(tree["layers"]["moe"]["router"][i]))
        assert layer.moe["w_down"].dtype == torch.bfloat16


def test_moe_ffn_on_a_mesh_raises():
    """``moe_ffn(mesh=)`` runs over a mesh now (``tests/test_torch_moe_mesh.py``);
    it still raises before any collective for a mesh that lacks a batch axis
    (the default ``("pod", "data")`` on a 2-D mesh) and for the dense engine."""
    from repro_torch.launch.mesh import ModelMesh

    mesh = ModelMesh(axis_names=("data", "model"), shape=(1, 1), coords=(0, 0), rank=0,
                     group=None, host_group=None, groups={}, device=torch.device("cpu"))
    with pytest.raises(ValueError, match="lack"):
        moe.moe_ffn({}, torch.zeros(2, D), CFG, mesh=mesh)
    with pytest.raises(ValueError, match="dense"):
        moe.moe_ffn({}, torch.zeros(2, D), CFG.replace(dispatch="dense"), mesh=mesh,
                    batch_axes=("data",))


def test_moe_ffn_picks_the_reference_engine():
    cfg = CFG.replace(dispatch="auto", n_experts=8, top_k=2)   # E <= 32: gather
    p = _params(cfg)
    x = _tokens(20)
    want, _ = jax_moe.moe_ffn({k: jnp.asarray(v) for k, v in p.items()}, jnp.asarray(x),
                              _jcfg(cfg))
    before = grouped_matmul.launches
    got, _ = moe.moe_ffn(_torch_params(p), torch.from_numpy(x), cfg, use_kernels=True)
    assert grouped_matmul.launches == before   # the CPU runs the plain version
    np.testing.assert_allclose(got.numpy(), _np(want), rtol=1e-5, atol=1e-5)
