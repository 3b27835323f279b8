"""The port's ``flash_attention`` against the reference's: the Pallas kernel
(interpret mode on the CPU) and its dense oracle ``flash_attention_ref``,
on the same inputs.  On the CPU the port's wrapper runs its plain version;
the CUDA kernel against that plain version is in
``test_torch_kernels_cuda.py``.

Tolerances: float32 ``atol = rtol = 2e-5`` (the same function, summed in
another order); bfloat16 ``2e-2`` (one bfloat16 rounding of the output,
about 2^-8 relative), as ``tests/test_kernels.py`` holds the Pallas kernel
to its oracle.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels.flash_attention.ops import flash_attention as jax_flash
from repro.kernels.flash_attention.ref import flash_attention_ref as jax_flash_ref
from repro_torch.kernels.flash_attention.ops import flash_attention
from repro_torch.kernels.flash_attention.ref import flash_attention_ref

TORCH = {"float32": torch.float32, "bfloat16": torch.bfloat16}
JAX = {"float32": jnp.float32, "bfloat16": jnp.bfloat16}


def _tol(dtype):
    return dict(atol=2e-2, rtol=2e-2) if dtype == "bfloat16" else dict(atol=2e-5, rtol=2e-5)


def _inputs(bh, S, L, dh, kv_groups, dtype, seed):
    rng = np.random.default_rng(seed)
    q = rng.standard_normal((bh, S, dh)).astype(np.float32)
    k = rng.standard_normal((bh // kv_groups, L, dh)).astype(np.float32)
    v = rng.standard_normal((bh // kv_groups, L, dh)).astype(np.float32)
    to_t = [torch.from_numpy(a).to(TORCH[dtype]) for a in (q, k, v)]
    # the same (rounded) values for the reference; it has no kv_groups, so
    # it gets each key/value head repeated for its group
    to_j = [jnp.asarray(a.float().numpy(), JAX[dtype]) for a in to_t]
    to_j[1] = jnp.repeat(to_j[1], kv_groups, axis=0)
    to_j[2] = jnp.repeat(to_j[2], kv_groups, axis=0)
    return to_t, to_j


def _close(got: torch.Tensor, want, dtype):
    np.testing.assert_allclose(got.float().numpy(), np.asarray(want.astype(jnp.float32)),
                               **_tol(dtype))


# tests/test_kernels.py's sweep, plus gemma3-12b's head dim and GQA groups
CASES = [
    (128, 128, 64, 0, 1), (300, 300, 64, 64, 1), (257, 257, 128, 0, 1), (64, 512, 32, 16, 1),
    (200, 200, 256, 64, 2), (130, 130, 256, 0, 2),
]


@pytest.mark.parametrize("S,L,dh,window,kv_groups", CASES)
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_flash_attention_matches_pallas_kernel_and_oracle(S, L, dh, window, kv_groups, dtype):
    L = S  # causal masking over the shared position space needs S == L here
    (q, k, v), (jq, jk, jv) = _inputs(2 * kv_groups, S, L, dh, kv_groups, dtype, seed=S + dh)
    before = flash_attention.launches
    got = flash_attention(q, k, v, window=window, kv_groups=kv_groups)
    assert flash_attention.launches == before  # a CPU call launches no kernel
    assert got.dtype == q.dtype and got.shape == q.shape
    _close(got, jax_flash(jq, jk, jv, window=window), dtype)
    _close(got, jax_flash_ref(jq, jk, jv, 1.0 / dh**0.5, window=window), dtype)


@pytest.mark.parametrize("causal,window", [(True, 1), (False, 0), (False, 40)])
def test_flash_attention_masks_match_oracle(causal, window):
    # S < L: the decode-style layout; window=1 keeps the diagonal only
    (q, k, v), (jq, jk, jv) = _inputs(4, 90, 150, 32, 2, "float32", seed=7)
    got = flash_attention(q, k, v, scale=0.3, window=window, causal=causal, kv_groups=2)
    _close(got, jax_flash_ref(jq, jk, jv, 0.3, window=window, causal=causal), "float32")
    if causal and window == 1:
        # each query attends to its own key alone: the output is v's row
        np.testing.assert_allclose(got.numpy(), v.repeat_interleave(2, 0)[:, :90].numpy(),
                                   atol=1e-6)


def test_flash_attention_plain_version_is_the_wrapper_on_cpu():
    (q, k, v), _ = _inputs(4, 33, 33, 16, 2, "float32", seed=3)
    assert torch.equal(flash_attention(q, k, v, window=5, kv_groups=2),
                       flash_attention_ref(q, k, v, 0.25, window=5, kv_groups=2))


@pytest.mark.parametrize("bad", ["dtype", "mixed", "rank", "groups", "dh", "window", "dv"])
def test_flash_attention_rejects_bad_inputs(bad):
    q = torch.zeros(4, 8, 16)
    k = v = torch.zeros(2, 8, 16)
    kw = dict(kv_groups=2)
    if bad == "dtype":
        q, k, v = (t.half() for t in (q, k, v))
    elif bad == "mixed":
        k = k.bfloat16()
    elif bad == "rank":
        q = q[None]
    elif bad == "groups":
        kw["kv_groups"] = 3
    elif bad == "dh":
        k = v = torch.zeros(2, 8, 32)
    elif bad == "dv":
        v = torch.zeros(2, 8, 32)    # values wider than the keys
    else:
        kw["window"] = -1
    with pytest.raises(ValueError):
        flash_attention(q, k, v, **kw)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_flash_attention_takes_mla_shapes_with_padded_values(dtype):
    """MLA's queries and keys are d_nope + d_rope = 192 wide and its values
    d_v = 128: ``mla_attention`` pads the values with zeros to 192 (as the
    TPU wrapper pads to its ``d_pad``).  The padded columns come out zero,
    the rest equal the Pallas kernel's and the oracle's on the same
    inputs."""
    (q, k, v), (jq, jk, jv) = _inputs(2, 70, 70, 192, 1, dtype, seed=11)
    v[..., 128:] = 0
    jv = jv.at[..., 128:].set(0)
    scale = 1.0 / 192**0.5
    got = flash_attention(q, k, v, scale=scale)
    assert got.shape == (2, 70, 192) and not got[..., 128:].any()
    _close(got, jax_flash(jq, jk, jv), dtype)
    _close(got, jax_flash_ref(jq, jk, jv, scale), dtype)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("causal,window,kv_groups", [(True, 0, 1), (True, 9, 2), (False, 0, 1)])
def test_flash_attention_takes_values_narrower_than_keys(dtype, causal, window, kv_groups):
    """MLA's widths as ``mla_attention`` now passes them: q and k 192 wide,
    values 128 wide, unpadded.  The output is 128 wide and equals the
    reference oracle's, which reads v's own width, on the same inputs."""
    (q, k, _), (jq, jk, _) = _inputs(2 * kv_groups, 70, 70, 192, kv_groups, dtype, seed=13)
    (_, _, v), (_, _, jv) = _inputs(2 * kv_groups, 70, 70, 128, kv_groups, dtype, seed=14)
    scale = 1.0 / 192**0.5
    got = flash_attention(q, k, v, scale=scale, window=window, causal=causal,
                          kv_groups=kv_groups)
    assert got.shape == (2 * kv_groups, 70, 128) and got.dtype == q.dtype
    _close(got, jax_flash_ref(jq, jk, jv, scale, window=window, causal=causal), dtype)
