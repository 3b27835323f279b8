"""Serve a small LM with batched requests on the PyTorch/CUDA port: prefill
+ decode loop with a KV cache, batched greedy generation (twin of
``examples/serve_lm.py``).  Runs on the card unless given ``--device cpu``;
weights and prompts come from seeded ``torch.Generator``s on the device.

    PYTHONPATH=src python examples/torch_serve_lm.py [--requests 16 --gen 32] [--device cpu]
"""

import argparse
import sys
import time
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parents[1] / "src"))

import torch

from repro_torch.kernels.runtime import resolve_device
from repro_torch.models.transformer import (TransformerConfig, decode_step, init_cache,
                                            init_transformer, prefill)

CFG = TransformerConfig(
    name="serve-demo", n_layers=6, d_model=256, n_heads=8, n_kv_heads=4,
    d_head=32, d_ff=1024, vocab=32_000, window_pattern=(256, 256, 0),
    dtype="float32", param_dtype="float32", remat=False,
)


def _sync(dev: torch.device) -> None:
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)


def serve(cfg: TransformerConfig, requests: int, prompt_len: int, gen: int, device) -> dict:
    """Prefill ``requests`` random prompts, then ``gen - 1`` greedy decode
    steps; the (B, gen) tokens and the prefill and decode seconds."""
    dev = resolve_device(device)
    model = init_transformer(cfg, torch.Generator(device=dev).manual_seed(0), dev)
    n_params = sum(p.numel() for p in model.parameters())
    print(f"model: {n_params/1e6:.1f}M params, batch={requests}")

    B, P, G = requests, prompt_len, gen
    prompts = torch.randint(0, cfg.vocab, (B, P), device=dev,
                            generator=torch.Generator(device=dev).manual_seed(1))
    caches = init_cache(cfg, B, P + G, dev)

    t0 = time.monotonic()
    logits, caches = prefill(model, prompts, caches)
    _sync(dev)
    t_prefill = time.monotonic() - t0
    print(f"prefill: {B}x{P} tokens in {t_prefill*1e3:.1f} ms "
          f"({B*P/t_prefill:.0f} tok/s)")

    tokens = logits.argmax(-1)[:, None].to(torch.int32)
    generated = [tokens]
    t0 = time.monotonic()
    for step in range(G - 1):
        logits, caches = decode_step(model, tokens, caches, P + step)
        tokens = logits.argmax(-1)[:, None].to(torch.int32)
        generated.append(tokens)
    _sync(dev)
    t_dec = time.monotonic() - t0
    out = torch.cat(generated, dim=1)
    if G > 1:
        print(f"decode: {B}x{G-1} tokens in {t_dec*1e3:.1f} ms "
              f"({B*(G-1)/t_dec:.0f} tok/s, {t_dec/(G-1)*1e3:.1f} ms/step)")
    if not bool(((out >= 0) & (out < cfg.vocab)).all()):
        raise RuntimeError("a generated token lies outside the vocabulary")
    print("sample continuation ids:", out[0, :12].tolist())
    return {"tokens": out, "prefill_s": t_prefill, "decode_s": t_dec}


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser()
    ap.add_argument("--requests", type=int, default=16)
    ap.add_argument("--prompt-len", type=int, default=64)
    ap.add_argument("--gen", type=int, default=32)
    ap.add_argument("--device", default=None, help="cuda (default) or cpu")
    args = ap.parse_args(argv)
    return serve(CFG, args.requests, args.prompt_len, args.gen, args.device)


if __name__ == "__main__":
    main()
