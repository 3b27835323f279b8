"""Serving launcher: batched prefill and greedy decode for an LM arch
(port of ``repro.launch.serve``), and DLRM's serving cells.

    PYTHONPATH=src python -m repro_torch.launch.serve --arch gemma3-12b
    PYTHONPATH=src python -m repro_torch.launch.serve --arch gemma3-12b --reduced --device cpu
    PYTHONPATH=src python -m repro_torch.launch.serve --arch deepseek-v2-lite-16b
    PYTHONPATH=src python -m repro_torch.launch.serve --arch deepseek-v2-lite-16b --reduced --device cpu
    PYTHONPATH=src python -m repro_torch.launch.serve --arch dlrm-mlperf --cell serve_bulk
    PYTHONPATH=src python -m repro_torch.launch.serve --arch dlrm-mlperf --reduced --device cpu

On the card (the default device) it serves the arch's full configuration,
weights from a seeded generator: an LM's in its compute dtype (a MoE
router in float32), DLRM's at full width with the one-card row cap
(``configs.dlrm_mlperf``, 66 GB of float32 tables).  An LM whose weights
exceed one card (kimi-k2-1t-a32b, about 2 TB in bf16) raises before
allocating; ``serve_config(mesh=)`` counts one rank's share of a model
over a mesh instead (the replicated part and its expert shards), and
``generate(mesh=)`` serves it SPMD, each rank its own requests.
``--reduced`` serves the reduced float32 configuration.  For
an LM it prints the prefill's tokens/s and the decode's ms per step.
The reference launcher takes LM archs only; for dlrm-mlperf the port runs
the serving cells the reference defines (``--cell``: ``serve_p99``,
``serve_bulk`` or ``retrieval_cand``) and prints ms per batch and
samples/s.
"""

from __future__ import annotations

import argparse
import statistics
import time

import torch
import torch.distributed as dist

from repro_torch.configs import get_arch
from repro_torch.configs.common import reduce_dlrm_config, reduce_lm_config
from repro_torch.configs.dlrm_mlperf import CELLS as DLRM_CELLS
from repro_torch.configs.dlrm_mlperf import one_card_config
from repro_torch.kernels.embedding_bag.ops import embedding_bag
from repro_torch.kernels.flash_attention.ops import flash_attention
from repro_torch.kernels.grouped_matmul.ops import grouped_matmul
from repro_torch.kernels.runtime import build_kernels, resolve_device, resolve_use_kernels
from repro_torch.models.dlrm import DLRM, DLRMConfig, dlrm_forward, init_dlrm, retrieval_score
from repro_torch.models.moe import ExchangeTimer
from repro_torch.models.transformer import (Transformer, TransformerConfig, decode_step,
                                            init_cache, init_transformer, prefill)


# the most weight bytes served on one card: an 80 GB H100 less room for the
# caches and a prefill's activations
ONE_CARD_WEIGHT_BYTES = 60e9


def lm_param_count(cfg: TransformerConfig, mesh=None, batch_axes=("data",)) -> int:
    """The parameters of ``cfg``'s model (of one rank's shard of it on
    ``mesh``), counted from its shapes without allocating it."""
    return sum(p.numel() for p in
               Transformer(cfg, torch.device("meta"), mesh, batch_axes).parameters())


def serve_config(arch: str, reduced: bool, mesh=None, batch_axes=("data",)) -> TransformerConfig:
    """The served configuration: the reduced smoke config, or the full one
    with its weights held in the compute dtype.  Raises for a full config
    whose weights on one rank exceed one card: all of them without
    ``mesh``, else the replicated part plus the rank's 1/EP of the experts
    (1/TP of their width)."""
    cfg = get_arch(arch).model_config
    if reduced:
        return reduce_lm_config(cfg).replace(remat=False)
    cfg = cfg.replace(remat=False, param_dtype=cfg.dtype)
    n_bytes = lm_param_count(cfg, mesh, batch_axes) * torch.finfo(cfg.act_dtype).bits // 8
    if n_bytes > ONE_CARD_WEIGHT_BYTES:
        where = "" if mesh is None else f" on one rank of a {'x'.join(map(str, mesh.shape))} mesh"
        raise NotImplementedError(
            f"{arch}: {n_bytes / 1e9:.0f} GB of {cfg.dtype} weights{where} exceed one card "
            f"({ONE_CARD_WEIGHT_BYTES / 1e9:.0f} GB); shard the experts over more ranks "
            "(ROADMAP item 11, models over a mesh)")
    return cfg


def _sync(device: torch.device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def generate(model: Transformer, prompts: torch.Tensor, gen: int,
             use_kernels: bool | str = "auto", mesh=None, batch_axes=("data",)) -> dict:
    """Prefill the (B, P) prompts, then ``gen - 1`` greedy decode steps.

    Returns the (B, gen) generated tokens, the prefill's last-token
    logits, the prefill's seconds and the decode's seconds per step (host
    clock around work that ends in a device synchronise), and the launches
    of each LM kernel in each phase: ``launches[phase][kernel]``.

    With ``mesh`` (SPMD: every rank calls it with the same ``gen``),
    ``prompts`` are this rank's requests (``transformer.batch_shard``) and
    ``model`` its shard; the launches are this rank's.  It also returns
    ``all_tokens``, every request's (B * EP, gen) tokens gathered over
    ``batch_axes``, and ``exchange[phase]``, the MoE collectives by kind
    (``moe.ExchangeTimer``: calls, bytes, device ms by CUDA events)."""
    if gen < 1:
        raise ValueError(f"gen must be >= 1, got {gen}")
    dev = prompts.device
    B, P = prompts.shape
    mesh_kw = {} if mesh is None else {"mesh": mesh, "batch_axes": batch_axes}
    caches = init_cache(model.cfg, B, P + gen, dev)
    n0 = _lm_launches()
    _sync(dev)
    t0 = time.monotonic()
    with ExchangeTimer() as ex_prefill:
        logits, caches = prefill(model, prompts, caches, use_kernels=use_kernels, **mesh_kw)
        tok = logits.argmax(-1)[:, None]
    _sync(dev)
    prefill_s = time.monotonic() - t0
    n1 = _lm_launches()
    tokens = [tok]
    t0 = time.monotonic()
    with ExchangeTimer() as ex_decode:
        for s in range(gen - 1):
            step_logits, caches = decode_step(model, tok, caches, P + s,
                                              use_kernels=use_kernels, **mesh_kw)
            tok = step_logits.argmax(-1)[:, None]
            tokens.append(tok)
    _sync(dev)
    decode_s = time.monotonic() - t0
    out = {
        "tokens": torch.cat(tokens, dim=1), "prefill_logits": logits,
        "prefill_s": prefill_s, "decode_s_per_step": decode_s / max(gen - 1, 1),
        "launches": {"prefill": {k: n1[k] - n0[k] for k in n0},
                     "decode": {k: n2 - n1[k] for k, n2 in _lm_launches().items()}},
    }
    if mesh is not None:
        group = mesh.group_of(batch_axes)
        parts = [torch.empty_like(out["tokens"]) for _ in range(mesh.axis_size(batch_axes))]
        dist.all_gather(parts, out["tokens"], group=group)
        out["all_tokens"] = torch.cat(parts)
        out["exchange"] = {"prefill": ex_prefill.summary(), "decode": ex_decode.summary()}
    return out


def _lm_launches() -> dict:
    return {"flash_attention": flash_attention.launches,
            "grouped_matmul": grouped_matmul.launches}


def dlrm_serve_config(reduced: bool) -> DLRMConfig:
    """dlrm-mlperf's served configuration: the reduced smoke config, or the
    full one with the one-card row cap."""
    cfg = get_arch("dlrm-mlperf").model_config
    return reduce_dlrm_config(cfg) if reduced else one_card_config(cfg)


def dlrm_traffic(cfg: DLRMConfig, batch: int, generator: torch.Generator):
    """One batch of serving traffic on the generator's device: dense
    features standard normal (B, n_dense) float32, and per field an id
    uniform in [0, rows) as (B, n_sparse) int32."""
    dev = generator.device
    dense = torch.randn((batch, cfg.n_dense), generator=generator, device=dev)
    sparse = torch.stack([torch.randint(0, v, (batch,), generator=generator, device=dev,
                                        dtype=torch.int32) for v in cfg.vocab_sizes], dim=1)
    return dense, sparse


def serve_dlrm(model: DLRM, cell: str, batches: int = 10, use_kernels: bool | str = "auto",
               cfg: DLRMConfig | None = None, seed: int = 1) -> dict:
    """Run a serving cell of ``DLRM_CELLS``: a first call (a warm-up, whose
    ``embedding_bag`` launches are counted), then ``batches`` timed calls,
    each on its own traffic from ``seed``.  A serving cell calls
    ``dlrm_forward`` (``cfg`` gives its table engine, default
    ``model.cfg``); ``retrieval_cand`` calls ``retrieval_score`` on one
    set of candidate embeddings (standard normal).  Times are the host
    clock around work that ends in a device synchronise; returns the
    first call's input and output (and the candidates), the median ms per
    batch, samples/s and the launches of the first call and of all
    calls."""
    if batches < 1:
        raise ValueError(f"batches must be >= 1, got {batches}")
    spec = DLRM_CELLS[cell]
    dev = model.tables[0].device
    gen = torch.Generator(device=dev)
    gen.manual_seed(seed)
    cands = None
    if "n_candidates" in spec:
        cands = torch.randn((spec["n_candidates"], model.cfg.embed_dim), generator=gen,
                            device=dev)
        inputs = [torch.randn((spec["batch"], model.cfg.n_dense), generator=gen, device=dev)
                  for _ in range(batches + 1)]

        def call(query):
            return retrieval_score(model, query, cands, spec["top_k"])
    else:
        inputs = [dlrm_traffic(model.cfg, spec["batch"], gen) for _ in range(batches + 1)]

        def call(traffic):
            return dlrm_forward(model, *traffic, cfg, use_kernels)
    n0 = embedding_bag.launches
    first = call(inputs[0])
    _sync(dev)
    n1 = embedding_bag.launches
    times = []
    for x in inputs[1:]:
        t0 = time.monotonic()
        call(x)
        _sync(dev)
        times.append(time.monotonic() - t0)
    ms = statistics.median(times) * 1e3
    return {"output": first, "first_input": inputs[0], "candidates": cands,
            "ms_per_batch": ms, "batch_ms": [t * 1e3 for t in times],
            "samples_per_s": spec["batch"] / (ms * 1e-3), "batch": spec["batch"],
            "launches_first": n1 - n0, "launches": embedding_bag.launches - n0}


def _main_dlrm(args, dev: torch.device) -> dict:
    cfg = dlrm_serve_config(args.reduced)
    if resolve_use_kernels("auto", dev):
        build_kernels()
    rng = torch.Generator(device=dev)
    rng.manual_seed(0)
    model = init_dlrm(cfg, rng, dev)
    out = serve_dlrm(model, args.cell)
    label = "reduced" if args.reduced else "full width, rows capped at 25M a table"
    print(f"{args.arch} ({label}, {dev.type}): {args.cell}, batch {out['batch']}: "
          f"{out['ms_per_batch']:.3f} ms/batch (median of {len(out['batch_ms'])}), "
          f"{out['samples_per_s']:.0f} samples/s; embedding_bag launches in the first call "
          f"{out['launches_first']}")
    return out


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--arch", required=True)
    ap.add_argument("--requests", type=int, default=4)
    ap.add_argument("--prompt-len", type=int, default=32)
    ap.add_argument("--gen", type=int, default=16)
    ap.add_argument("--device", default=None, help="cuda (default) or cpu")
    ap.add_argument("--reduced", action="store_true",
                    help="the reduced float32 config of the reference launcher")
    ap.add_argument("--cell", default="serve_p99", choices=sorted(DLRM_CELLS),
                    help="dlrm-mlperf: the serving cell")
    args = ap.parse_args(argv)

    dev = resolve_device(args.device)
    if args.arch == "dlrm-mlperf":
        return _main_dlrm(args, dev)
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
          f"kernel launches {out['launches']}")
    return out


if __name__ == "__main__":
    main()
