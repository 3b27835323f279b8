"""How far bf16-activation gradients of ``lm_loss`` lie from float64, for
the port and for the reference, on the cases of
``tests/test_torch_train_models.py::test_lm_loss_and_every_gradient_match``
(the measurement behind its bf16 tolerance).

    PYTHONPATH=src python tests/bf16_gradient_spread.py

For each case (a 2-layer dense LM and the reduced MoE) and each reference
leaf it prints three numbers, each max |a - b| over the float64 leaf's
largest |grad|: the port's bf16 gradients against the reference's bf16
ones, and each of them against the float64 gradients (the port's float64
run on the same weights and tokens).  Runs on the CPU in about 30 s.
"""

import sys
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parent))

import jax
import jax.numpy as jnp
import numpy as np
import torch

from repro.models import transformer as jax_tf
from repro_torch.models import transformer
from test_torch_train_models import _get, _jax_cfg, _lm_case, _port_grads_by_leaf, _port_model


def main() -> None:
    for kind in ("dense", "moe"):
        cfg, tree = _lm_case(kind, "bfloat16")
        tokens = np.random.default_rng(3).integers(0, cfg.vocab, (2, 17)).astype(np.int32)
        jcfg = _jax_cfg(cfg)
        _, jg = jax.value_and_grad(lambda p: jax_tf.lm_loss(p, jnp.asarray(tokens), jcfg))(
            jax.tree.map(jnp.asarray, tree))
        model = _port_model(cfg, tree)
        transformer.lm_loss(model, torch.from_numpy(tokens)).backward()
        port = _port_grads_by_leaf(model)
        m64 = _port_model(cfg.replace(dtype="float64", param_dtype="float64"), tree)
        transformer.lm_loss(m64, torch.from_numpy(tokens)).backward()
        truth = _port_grads_by_leaf(m64)
        print(f"{kind}: leaf, port-ref, port-f64, ref-f64 (of the float64 leaf's largest)")
        worst = np.zeros(3)
        for name, g in port.items():
            t = np.asarray(truth[name], np.float64)
            ref = np.asarray(_get(jg, name), np.float64)
            big = np.abs(t).max()
            row = np.array([np.abs(g - ref).max(), np.abs(g - t).max(), np.abs(ref - t).max()])
            worst = np.maximum(worst, row / big)
            print(f"  {name:28s} " + "  ".join(f"{x / big:.4f}" for x in row))
        print(f"  {'worst':28s} " + "  ".join(f"{x:.4f}" for x in worst))


if __name__ == "__main__":
    main()
