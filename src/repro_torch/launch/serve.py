"""Serving launcher: batched prefill and greedy decode for an LM arch
(port of ``repro.launch.serve``).

    PYTHONPATH=src python -m repro_torch.launch.serve --arch gemma3-12b
    PYTHONPATH=src python -m repro_torch.launch.serve --arch gemma3-12b --reduced --device cpu

On the card (the default device) it serves the arch's full configuration,
weights in its compute dtype from a seeded generator; ``--reduced`` serves
the reference launcher's reduced float32 configuration.  It prints the
prefill's tokens/s and the decode's ms per step.
"""

from __future__ import annotations

import argparse
import time

import torch

from repro_torch.configs import get_arch
from repro_torch.configs.common import reduce_lm_config
from repro_torch.kernels.flash_attention.ops import flash_attention
from repro_torch.kernels.runtime import build_kernels, resolve_device, resolve_use_kernels
from repro_torch.models.transformer import (Transformer, TransformerConfig, decode_step,
                                            init_cache, init_transformer, prefill)


def serve_config(arch: str, reduced: bool) -> TransformerConfig:
    """The served configuration: the reduced smoke config, or the full one
    with its weights held in the compute dtype."""
    cfg = get_arch(arch)
    if reduced:
        return reduce_lm_config(cfg).replace(remat=False)
    return cfg.replace(remat=False, param_dtype=cfg.dtype)


def _sync(device: torch.device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def generate(model: Transformer, prompts: torch.Tensor, gen: int,
             use_kernels: bool | str = "auto") -> dict:
    """Prefill the (B, P) prompts, then ``gen - 1`` greedy decode steps.

    Returns the (B, gen) generated tokens, the prefill's last-token
    logits, the prefill's seconds and the decode's seconds per step (host
    clock around work that ends in a device synchronise), and the
    ``flash_attention`` launches of each phase."""
    if gen < 1:
        raise ValueError(f"gen must be >= 1, got {gen}")
    dev = prompts.device
    B, P = prompts.shape
    caches = init_cache(model.cfg, B, P + gen, dev)
    n0 = flash_attention.launches
    _sync(dev)
    t0 = time.monotonic()
    logits, caches = prefill(model, prompts, caches, use_kernels=use_kernels)
    tok = logits.argmax(-1)[:, None]
    _sync(dev)
    prefill_s = time.monotonic() - t0
    n1 = flash_attention.launches
    tokens = [tok]
    t0 = time.monotonic()
    for s in range(gen - 1):
        step_logits, caches = decode_step(model, tok, caches, P + s)
        tok = step_logits.argmax(-1)[:, None]
        tokens.append(tok)
    _sync(dev)
    decode_s = time.monotonic() - t0
    return {
        "tokens": torch.cat(tokens, dim=1), "prefill_logits": logits,
        "prefill_s": prefill_s, "decode_s_per_step": decode_s / max(gen - 1, 1),
        "launches": {"prefill": n1 - n0, "decode": flash_attention.launches - n1},
    }


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--arch", required=True)
    ap.add_argument("--requests", type=int, default=4)
    ap.add_argument("--prompt-len", type=int, default=32)
    ap.add_argument("--gen", type=int, default=16)
    ap.add_argument("--device", default=None, help="cuda (default) or cpu")
    ap.add_argument("--reduced", action="store_true",
                    help="the reduced float32 config of the reference launcher")
    args = ap.parse_args(argv)

    dev = resolve_device(args.device)
    cfg = serve_config(args.arch, args.reduced)
    if resolve_use_kernels("auto", dev):
        build_kernels()
    rng = torch.Generator(device=dev)
    rng.manual_seed(0)
    model = init_transformer(cfg, rng, dev)
    rng.manual_seed(1)
    B, P = args.requests, args.prompt_len
    prompts = torch.randint(0, cfg.vocab, (B, P), generator=rng, device=dev)
    out = generate(model, prompts, args.gen)
    label = "reduced" if args.reduced else "full"
    print(f"{args.arch} ({label}, {dev.type}): {B} requests x {P} prompt tokens: prefill "
          f"{out['prefill_s']:.3f} s, {B * P / out['prefill_s']:.0f} tok/s; "
          f"{args.gen - 1} decode steps, {out['decode_s_per_step'] * 1e3:.2f} ms/step; "
          f"flash_attention launches {out['launches']}")
    return out


if __name__ == "__main__":
    main()
