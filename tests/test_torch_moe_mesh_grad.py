"""MoE gradients over a mesh: ``moe.moe_ffn_placed`` (``moe_ffn(mesh=)``
on DTensor placements, the route ``lm_loss(mesh=)`` takes) against the
reference's ``jax.grad`` of its ``shard_map`` MoE on the same forced mesh,
against the single-device ``_moe_core``, and, where capacity drops, against
``_moe_core`` run on each batch shard, on gloo ranks on the CPU.

One pool of 8 ranks serves the module (``launch.mesh.PoolKeeper``); the
reference runs in one forced-8-device subprocess started by the first case.

* The twin of ``tests/test_distributed.py``'s
  ``test_moe_shard_map_matches_single_device``: (pod, data, model) = (2, 2,
  2), EP = 4 over ("pod", "data"), TP = 2, ``capacity_factor`` 16 (nothing
  drops), sorted dispatch, the loss ``mean(y * y) + 0 * aux`` (the
  reference's sum, scaled).  The loss
  within ``LOSS_TOL`` relative of the reference's sharded run; every
  gradient leaf within ``GRAD_TOL`` of that leaf's largest |g|, against
  that run and against the port's single-device ``_moe_core``.
* TP = 2 with drops: a (2, 2) mesh, EP = 2 over data, ``capacity_factor``
  1.25, sorted and gather, the loss ``mean(y * y) + AUX_W * aux`` against
  ``_moe_core`` on each data shard (C from the shard's own tokens, aux the
  shards' mean), so the adjoints of the exchanges, the model reduce
  (identity), the tokens' entry into the model-split experts (a sum over
  ``model``) and aux's mean (a share of the batch ranks') are all held.
  A factor of TP in any of them moves a leaf past the tolerance: the test
  checks that the aux term alone moves the router's gradient by more than
  ``GRAD_TOL`` times 100.
"""

import subprocess
import sys
import textwrap

import numpy as np
import pytest
import torch

from repro.launch.mesh import forced_host_device_env
from repro_torch.launch.mesh import PoolKeeper, device_mesh, make_debug_mesh
from repro_torch.models import moe

LOSS_TOL = 1e-5
GRAD_TOL = 1e-4
AUX_W = 10.0
D = 64
TWIN = dict(n_experts=8, top_k=2, d_ff=32, n_shared=1, capacity_factor=16.0, dispatch="sorted")
DROPS = dict(n_experts=8, top_k=2, d_ff=32, n_shared=1, capacity_factor=1.25)
T_DROPS = 64

_REFERENCE = """
    import sys
    import jax, jax.numpy as jnp
    import numpy as np
    assert len(jax.devices()) == 8
    from repro.launch.mesh import make_debug_mesh
    from repro.models.moe import MoEConfig, init_moe, moe_ffn, _moe_core

    mesh = make_debug_mesh(2, 2, pods=2)
    cfg = MoEConfig(n_experts=8, top_k=2, d_ff=32, n_shared=1,
                    capacity_factor=16.0, dispatch="sorted")
    p = init_moe(jax.random.PRNGKey(0), 64, cfg)
    x = jax.random.normal(jax.random.PRNGKey(1), (32, 64))

    def dist(p, x):
        y, aux = moe_ffn(p, x, cfg, mesh=mesh, batch_axes=("pod", "data"))
        return jnp.sum(y * y) / y.size + 0.0 * aux

    with mesh:
        loss, g = jax.jit(jax.value_and_grad(dist))(p, x)
    out = {"x": np.asarray(x), "loss": np.asarray(loss)}
    for k, v in p.items():
        out["p/" + k] = np.asarray(v)
        out["g/" + k] = np.asarray(g[k])
    np.savez(sys.argv[1], **out)
"""


class _Reference:
    def __init__(self, path):
        self.path = path
        self.proc = subprocess.Popen(
            [sys.executable, "-c", textwrap.dedent(_REFERENCE), str(path)],
            stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True,
            env=forced_host_device_env(8))
        self.data = None

    def get(self) -> dict:
        if self.data is None:
            out, err = self.proc.communicate(timeout=400)
            assert self.proc.returncode == 0, f"stdout:\n{out}\nstderr:\n{err[-4000:]}"
            with np.load(self.path) as z:
                self.data = dict(z)
        return self.data

    def close(self):
        if self.proc.poll() is None:
            self.proc.kill()
        self.proc.communicate()


@pytest.fixture(scope="module")
def reference(tmp_path_factory):
    ref = _Reference(tmp_path_factory.mktemp("moe_grad") / "reference.npz")
    yield ref
    ref.close()


@pytest.fixture(scope="module")
def pools(reference):
    with PoolKeeper(8, threads=1, timeout_s=60.0) as keeper:
        yield keeper


@pytest.fixture
def pool(pools):
    return pools.get()


def _quiet():
    import logging
    import warnings

    logging.getLogger("torch.distributed").setLevel(logging.ERROR)
    warnings.filterwarnings("ignore")


def _placed_grads(group, shape, fields, params, x, aux_w):
    """One rank's run of ``moe_ffn_placed`` on the whole ``params`` and
    tokens ``x``, placed as ``lm_rule`` places a MoE layer's (E over the
    batch axes, the width over ``model``) and as ``lm_batch_spec`` places
    tokens: (loss, {name: whole gradient}, the tokens' whole gradient)."""
    _quiet()
    from torch.distributed.tensor import Replicate, Shard, distribute_tensor

    from repro_torch.dist.sharding import batch_axes, lm_rule, placements, spec_for

    pods, n_data, n_model = shape
    n = max(pods, 1) * n_data * n_model
    mesh = make_debug_mesh(n_data, n_model, pods=pods, ranks=tuple(range(n)), device="cpu")
    if mesh is None:
        return None
    dm = device_mesh(mesh)
    rule = lm_rule(mesh)
    placed = {}
    for k, v in params.items():
        t = torch.from_numpy(v)
        pl = placements(spec_for(f"layers/1/moe/{k}", tuple(t.shape), mesh, rule), t.ndim, dm)
        placed[k] = distribute_tensor(t, dm, pl, src_data_rank=None).requires_grad_(True)
    ba = batch_axes(mesh)
    tok = [Shard(0) if a in ba else Replicate() for a in mesh.axis_names]
    xs = distribute_tensor(torch.from_numpy(x), dm, tok, src_data_rank=None).requires_grad_(True)
    y, aux = moe.moe_ffn_placed(placed, xs, moe.MoEConfig(**fields), mesh)
    loss = (y * y).sum() / y.numel() + aux_w * aux
    loss.backward()
    grads = {k: v.grad.full_tensor().numpy() for k, v in placed.items()}
    return float(loss.full_tensor()), grads, xs.grad.full_tensor().numpy()


def _leaf_close(got, want, tol, what):
    bound = tol * max(float(np.abs(want).max()), 1e-30)
    err = float(np.abs(np.asarray(got, np.float64) - np.asarray(want, np.float64)).max())
    assert err <= bound, (what, err, bound)


def _core_grads(params, x, fields, shards, aux_w):
    """The port's ``_moe_core`` on each of ``shards`` equal row blocks of
    ``x`` with the whole ``params``: (loss, grads, the tokens' gradient,
    whether any assignment dropped), the loss the mean of ``y * y`` over
    the blocks plus ``aux_w`` times their aux's mean."""
    cfg = moe.MoEConfig(**fields)
    p = {k: torch.from_numpy(v).requires_grad_(True) for k, v in params.items()}
    xt = torch.from_numpy(x).requires_grad_(True)
    n = x.shape[0] // shards
    loss, auxs, dropped = 0.0, [], False
    for i in range(shards):
        xi = xt[i * n:(i + 1) * n]
        y, aux = moe._moe_core(xi, p, cfg, cfg.dispatch)
        loss = loss + (y * y).sum() / x.size
        auxs.append(aux)
        ids = moe._route(xi, p["router"], cfg)[0].reshape(-1)
        C = moe._capacity(ids.numel(), cfg.n_experts, cfg.capacity_factor)
        dropped |= bool((~moe._slots_sorted(ids, cfg.n_experts, C)[1]).any())
    loss = loss + aux_w * torch.stack(auxs).mean()
    loss.backward()
    return (float(loss.detach()), {k: v.grad.numpy() for k, v in p.items()}, xt.grad.numpy(), dropped)


def _drop_inputs(seed: int):
    """Whole MoE parameters and T_DROPS tokens with a shared direction, so
    the router prefers some experts and capacity 1.25 drops."""
    rng = np.random.default_rng(seed)
    E, F = DROPS["n_experts"], DROPS["d_ff"]

    def w(*shape):
        return (rng.standard_normal(shape) / np.sqrt(shape[-2])).astype(np.float32)

    p = {"router": w(D, E), "w_gate": w(E, D, F), "w_up": w(E, D, F), "w_down": w(E, F, D),
         "shared_gate": w(D, F), "shared_up": w(D, F), "shared_down": w(F, D)}
    x = rng.standard_normal((T_DROPS, D)) + 1.5 * rng.standard_normal(D)
    return p, x.astype(np.float32)


@pytest.mark.parametrize("dispatch", ["sorted", "gather"])
def test_tp2_gradients_with_drops_match_per_shard_core(pool, dispatch):
    """(data, model) = (2, 2), capacity 1.25: the loss and every gradient
    (parameters and tokens) against ``_moe_core`` on each data shard;
    every rank agrees; the aux term moves the router's gradient by
    far more than the tolerance, so a wrong factor in its adjoint shows."""
    fields = {**DROPS, "dispatch": dispatch}
    params, x = _drop_inputs(3)
    want_loss, want, want_x, dropped = _core_grads(params, x, fields, 2, AUX_W)
    assert dropped, "capacity 1.25 must drop on these tokens"
    _, no_aux, _, _ = _core_grads(params, x, fields, 2, 0.0)
    aux_share = float(np.abs(want["router"] - no_aux["router"]).max())
    assert aux_share > 100 * GRAD_TOL * float(np.abs(want["router"]).max()), aux_share
    results = [r for r in pool.run(_placed_grads, (0, 2, 2), fields, params, x, AUX_W)
               if r is not None]
    assert len(results) == 4
    loss, got, got_x = results[0]
    for other in results[1:]:
        assert other[0] == loss
        for k, v in other[1].items():
            np.testing.assert_array_equal(v, got[k], err_msg=k)
    assert abs(loss - want_loss) <= LOSS_TOL * abs(want_loss), (loss, want_loss)
    for k in params:
        _leaf_close(got[k], want[k], GRAD_TOL, k)
    _leaf_close(got_x, want_x, GRAD_TOL, "x")


def test_ep_tp_gradients_match_reference_and_single_device(pool, reference):
    """The twin of the reference's EP+TP test on (pod, data, model) = (2, 2,
    2): the loss against the reference's sharded run, and every gradient
    against that run's ``jax.grad`` and against the port's single-device
    ``_moe_core`` (nothing drops at capacity 16, so the two agree)."""
    ref = reference.get()
    params = {k[2:]: v for k, v in ref.items() if k.startswith("p/")}
    x = ref["x"]
    want_loss, single, _, dropped = _core_grads(params, x, TWIN, 1, 0.0)
    assert not dropped
    results = [r for r in pool.run(_placed_grads, (2, 2, 2), TWIN, params, x, 0.0)
               if r is not None]
    assert len(results) == 8
    loss, got, _ = results[0]
    ref_loss = float(ref["loss"])
    assert abs(loss - ref_loss) <= LOSS_TOL * abs(ref_loss), (loss, ref_loss)
    assert abs(loss - want_loss) <= LOSS_TOL * abs(want_loss), (loss, want_loss)
    for k in params:
        _leaf_close(got[k], ref["g/" + k], GRAD_TOL, "reference " + k)
        _leaf_close(got[k], single[k], GRAD_TOL, "single " + k)
