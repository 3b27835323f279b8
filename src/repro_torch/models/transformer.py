"""Decoder-only LM stack for inference (port of ``repro.models.transformer``).

The reference's five LM families: gemma3-12b (5:1 local:global sliding
windows), internlm2-1.8b (SwiGLU), granite-20b (MQA with a non-gated GELU
FFN), deepseek-v2-lite (MLA attention, MoE FFNs after a dense first layer)
and kimi-k2 (GQA, MoE after a dense first layer).

The reference runs its ``first_dense_layers`` prefix (when ``moe`` is set)
and then scans one stacked parameter tree over the other layers; the port
holds one ``DecoderLayer`` module per layer, each with its own window
(``pat[i % len(pat)]``).  A dense FFN is ``d_ff_dense or d_ff`` wide, as
the reference's ``_init_layer``.  Every matmul casts its weight to the
activation dtype first, as the reference does; ``init_transformer`` builds
the weights in ``cfg.param_dtype`` (a MoE router in float32 whatever it
is), so serving with ``param_dtype == dtype`` casts once at build time (the
same values, since the cast is deterministic).

Serving: ``forward``, ``prefill`` and ``decode_step`` run under
``torch.inference_mode()`` and take ``use_kernels`` ("auto", True or
False), resolved by ``kernels.runtime.resolve_use_kernels``: on, attention
over a prompt's own keys goes through the ``flash_attention`` kernel
(decode attends over the cache with the plain attention) and the MoE
experts through ``grouped_matmul``.  The MoE aux loss is computed and
dropped.  Caches are updated in place (the reference's are functional).
``prefill`` computes the logits of the last position only, where the
reference computes all and keeps the last.

Training: ``lm_loss`` runs under grad mode through the plain routes (the
kernels have no backward and refuse a gradient; above 2048 x 2048 scores
attention is blocked, with its own FlashAttention-2 backward, as in the
reference), adds the MoE aux loss,
and with ``cfg.remat`` recomputes each layer past the dense prefix in the
backward (``torch.utils.checkpoint``, the reference's ``jax.checkpoint`` of
its scan body).  Nothing on a layer's path draws random numbers, so a
recomputed MoE layer routes, and drops, as its first pass did.
``lm_loss(mesh=)`` trains an LM whose parameters are DTensors
(``dist.sharding``), a MoE through ``moe.moe_ffn_placed``.

Over a mesh (``mesh=``, a ``launch.mesh.ModelMesh``; the reference's
``forward(mesh=, batch_axes=)``), SPMD: each rank holds B/EP requests
(``batch_shard``; EP the size of ``batch_axes``) with their caches and
runs their attention and dense layers itself, and a ``Transformer(cfg,
device, mesh)`` holds this rank's expert shards (``moe.shard_shapes``).
The reference splits the flattened (B*S, D) tokens ``P(batch_axes,
None)``, which is that split of the requests when B % EP == 0.  The MoE
layers exchange over ``batch_axes`` and sum over ``model``
(``moe.moe_ffn(mesh=)``); with a ``pod`` axis and the default
``("data",)`` the experts are replicated over ``pod``, as in the
reference.
"""

from __future__ import annotations

import dataclasses
import math
from dataclasses import dataclass

import torch
import torch.nn.functional as F
from torch import nn
from torch.utils.checkpoint import checkpoint

from repro_torch.kernels.runtime import resolve_device, resolve_use_kernels
from repro_torch.models.attention import (MLAConfig, gqa_attention, init_gqa, init_mla,
                                          mla_attention)
from repro_torch.models.common import (cross_entropy_loss, dense_init, embed_init, frozen,
                                       rms_norm, swiglu)
from repro_torch.models.moe import (MoEConfig, mesh_shards, moe_draws, moe_ffn, moe_ffn_placed,
                                   shard_moe_params, shard_shapes)


@dataclass(frozen=True)
class TransformerConfig:
    name: str
    n_layers: int
    d_model: int
    n_heads: int
    n_kv_heads: int
    d_head: int
    d_ff: int
    vocab: int
    rope_theta: float = 10_000.0
    norm_eps: float = 1e-6
    ffn_act: str = "swiglu"            # 'swiglu' | 'gelu' (non-gated)
    window_pattern: tuple = (0,)       # cycled over layers; 0 = global attn
    attention: str = "gqa"             # 'gqa' | 'mla'
    mla: MLAConfig | None = None
    moe: MoEConfig | None = None
    first_dense_layers: int = 0        # dense-FFN prefix when moe is set
    d_ff_dense: int = 0                # hidden dim of that prefix (0 -> d_ff)
    tie_embeddings: bool = True
    dtype: str = "bfloat16"
    param_dtype: str = "float32"
    remat: bool = True
    sub_quadratic: bool = False        # True iff long-context decode is runnable

    @property
    def act_dtype(self) -> torch.dtype:
        return getattr(torch, self.dtype)

    @property
    def n_prefix_layers(self) -> int:
        return self.first_dense_layers if self.moe else 0

    @property
    def n_scan_layers(self) -> int:
        return self.n_layers - self.n_prefix_layers

    def windows(self) -> list[int]:
        pat = self.window_pattern or (0,)
        return [int(pat[i % len(pat)]) for i in range(self.n_layers)]

    def replace(self, **kw) -> "TransformerConfig":
        return dataclasses.replace(self, **kw)


def _check_config(cfg: TransformerConfig) -> None:
    if cfg.attention not in ("gqa", "mla"):
        raise ValueError(f"unknown attention {cfg.attention!r}")
    if cfg.attention == "mla" and cfg.mla is None:
        raise ValueError("attention='mla' needs an MLAConfig")
    if cfg.ffn_act not in ("swiglu", "gelu"):
        raise ValueError(f"unknown ffn_act {cfg.ffn_act!r}")


def _attention_shapes(cfg: TransformerConfig) -> dict:
    d, H = cfg.d_model, cfg.n_heads
    if cfg.attention == "mla":
        m = cfg.mla
        shapes = {"w_dkv": (d, m.kv_lora), "kv_norm": (m.kv_lora,),
                  "w_uk": (m.kv_lora, H * m.d_nope), "w_uv": (m.kv_lora, H * m.d_v),
                  "w_kr": (d, m.d_rope), "wo": (H * m.d_v, d)}
        if m.q_lora:
            shapes.update(w_dq=(d, m.q_lora), q_norm=(m.q_lora,),
                          w_uq=(m.q_lora, H * (m.d_nope + m.d_rope)))
        else:
            shapes["wq"] = (d, H * (m.d_nope + m.d_rope))
        return shapes
    dh = cfg.d_head
    return {"wq": (d, H * dh), "wk": (d, cfg.n_kv_heads * dh), "wv": (d, cfg.n_kv_heads * dh),
            "wo": (H * dh, d)}


class DecoderLayer(nn.Module):
    """Pre-norm block: RMS norm, GQA or MLA attention, residual; RMS norm,
    dense or MoE FFN, residual.  Weights are (d_in, d_out), applied as
    ``x @ w``; a MoE layer holds its FFN as ``moe`` (router float32), a
    dense one as ``ffn``."""

    def __init__(self, cfg: TransformerConfig, window: int, moe_layer: bool,
                 device: torch.device, dtype: torch.dtype, shards: tuple = (1, 1)):
        super().__init__()
        d = cfg.d_model

        def empty(shape, dt=dtype):
            return frozen(torch.empty(shape, device=device, dtype=dt))

        self.cfg = cfg
        self.window = window
        self.ln1 = frozen(torch.zeros(d, device=device, dtype=dtype))
        self.ln2 = frozen(torch.zeros(d, device=device, dtype=dtype))
        self.attn = nn.ParameterDict({name: empty(shape)
                                      for name, shape in _attention_shapes(cfg).items()})
        if moe_layer:
            self.moe = nn.ParameterDict({
                name: empty(shape, torch.float32 if name == "router" else dtype)
                for name, shape in shard_shapes(cfg.d_model, cfg.moe, *shards).items()})
            self.ffn = None
        else:
            self.moe = None
            d_ff = cfg.d_ff_dense or cfg.d_ff
            if cfg.ffn_act == "swiglu":
                self.ffn = nn.ParameterDict({"w_gate": empty((d, d_ff)),
                                             "w_up": empty((d, d_ff)),
                                             "w_down": empty((d_ff, d))})
            else:
                self.ffn = nn.ParameterDict({"w_in": empty((d, d_ff)),
                                             "w_down": empty((d_ff, d))})

    def forward(self, x, positions, cache=None, cache_index=None, use_kernels=False,
                mesh=None, batch_axes=("data",)):
        """-> (x, cache, the MoE aux loss or None for a dense layer)."""
        cfg = self.cfg
        h = rms_norm(x, self.ln1, cfg.norm_eps)
        if cfg.attention == "mla":
            attn_out, cache = mla_attention(
                self.attn, h, positions, cfg.n_heads, cfg.mla, cfg.rope_theta,
                window=self.window, cache=cache, cache_index=cache_index,
                use_kernels=use_kernels)
        else:
            attn_out, cache = gqa_attention(
                self.attn, h, positions, cfg.n_heads, cfg.n_kv_heads, cfg.d_head,
                cfg.rope_theta, window=self.window, cache=cache, cache_index=cache_index,
                use_kernels=use_kernels)
        x = _summed(x + attn_out)
        h = rms_norm(x, self.ln2, cfg.norm_eps)
        if self.moe is not None:
            if hasattr(self.moe["router"], "device_mesh"):   # DTensors: lm_loss(mesh=)
                y, aux = moe_ffn_placed(dict(self.moe), h, cfg.moe, mesh)
                return _summed(x + y), cache, aux
            B, S, D = h.shape
            y, aux = moe_ffn(self.moe, h.reshape(B * S, D), cfg.moe, mesh=mesh,
                             batch_axes=batch_axes, use_kernels=use_kernels)
            return x + y.reshape(B, S, D), cache, aux
        return _summed(x + _ffn_apply(self.ffn, h)), cache, None


def _summed(x: torch.Tensor) -> torch.Tensor:
    """The residual stream whole on every model rank (Megatron's ``g``): a
    DTensor's ``Partial`` placements (the row-parallel ``wo`` and
    ``w_down`` products' partial sums) are reduced to ``Replicate``, so
    DTensor does not reduce-scatter them onto the sequence, a layout its
    next products cannot take.  A plain tensor as it is."""
    if not hasattr(x, "placements"):
        return x
    from torch.distributed.tensor import Partial, Replicate

    pl = [Replicate() if isinstance(p, Partial) else p for p in x.placements]
    return x.redistribute(x.device_mesh, pl) if pl != list(x.placements) else x


def _ffn_apply(p, x: torch.Tensor) -> torch.Tensor:
    dt = x.dtype
    if "w_gate" in p:
        h = swiglu(x @ p["w_gate"].to(dt), x @ p["w_up"].to(dt))
    else:
        # jax.nn.gelu's default is the tanh approximation
        h = F.gelu(x @ p["w_in"].to(dt), approximate="tanh")
    return h @ p["w_down"].to(dt)


def model_shards(cfg: TransformerConfig, mesh=None, batch_axes=("data",)) -> tuple:
    """(EP, expert-axis index, TP, model-axis index) of this rank's MoE
    shards: (1, 0, 1, 0) without a mesh or a MoE."""
    if mesh is None or cfg.moe is None:
        return 1, 0, 1, 0
    return mesh_shards(mesh, batch_axes)


class Transformer(nn.Module):
    """The LM: embedding (tied unembedding unless ``tie_embeddings`` is
    off), ``n_layers`` decoder layers, final RMS norm.  Parameters are
    allocated uninitialised in ``cfg.param_dtype``; ``init_transformer``
    fills them from a generator, ``convert.transformer_params`` from the
    reference's parameter tree.  With ``mesh``, the MoE layers hold this
    rank's expert shards over ``batch_axes`` and ``model``
    (``shard_transformer`` slices them from a whole model)."""

    def __init__(self, cfg: TransformerConfig, device: torch.device, mesh=None,
                 batch_axes=("data",)):
        super().__init__()
        _check_config(cfg)
        dtype = getattr(torch, cfg.param_dtype)
        self.cfg = cfg
        self.shards = model_shards(cfg, mesh, batch_axes)
        ep, _, tp, _ = self.shards
        self.embed = frozen(torch.empty((cfg.vocab, cfg.d_model), device=device, dtype=dtype))
        self.final_norm = frozen(torch.zeros(cfg.d_model, device=device, dtype=dtype))
        n_prefix = cfg.n_prefix_layers
        self.layers = nn.ModuleList(
            DecoderLayer(cfg, w, cfg.moe is not None and i >= n_prefix, device, dtype, (ep, tp))
            for i, w in enumerate(cfg.windows()))
        if not cfg.tie_embeddings:
            self.unembed = frozen(torch.empty_like(self.embed))

    def unembedding(self) -> torch.Tensor:
        return self.embed if self.cfg.tie_embeddings else self.unembed


@torch.no_grad()
def init_transformer(cfg: TransformerConfig, generator: torch.Generator,
                     device: str | torch.device | None = None) -> Transformer:
    """A ``Transformer`` with random weights from ``generator`` (which must
    live on ``device``): dense and expert weights normal with std
    1/sqrt(d_in), embeddings normal with std 0.02, norm scales 0.  Each
    matrix is drawn in float32 on the device and cast into its parameter
    before the next is drawn, so no float32 copy of the whole model (or of
    a whole expert bank beside its cast) is ever held."""
    dev = resolve_device(device)
    if generator.device.type != dev.type:
        raise ValueError(f"init_transformer: generator on {generator.device}, model on {dev}")
    model = Transformer(cfg, dev)
    dtype = getattr(torch, cfg.param_dtype)
    for layer in model.layers:
        if cfg.attention == "mla":
            attn = init_mla(generator, cfg.d_model, cfg.n_heads, cfg.mla, dtype)
        else:
            attn = init_gqa(generator, cfg.d_model, cfg.n_heads, cfg.n_kv_heads, cfg.d_head,
                            dtype)
        for name, w in attn.items():
            layer.attn[name].copy_(w)
        if layer.moe is not None:
            for name, w in moe_draws(generator, cfg.d_model, cfg.moe, dtype):
                layer.moe[name].copy_(w)
                del w
        else:
            for name, w in layer.ffn.items():
                w.copy_(dense_init(generator, w.shape[0], w.shape[1], dtype))
    model.embed.copy_(embed_init(generator, cfg.vocab, cfg.d_model, dtype))
    if not cfg.tie_embeddings:
        model.unembed.copy_(embed_init(generator, cfg.vocab, cfg.d_model, dtype))
    return model


@torch.no_grad()
def shard_transformer(model: Transformer, mesh, batch_axes=("data",)) -> Transformer:
    """This rank's model on ``mesh`` from a whole ``model``: the same
    tensors (no copy) for everything but the experts, and the rank's
    expert slices (views along E; a copy, contiguous, where TP cuts the
    hidden width).  The result lives where ``model`` does."""
    if model.shards != (1, 0, 1, 0):
        raise ValueError("shard_transformer: the model is a shard already")
    cfg = model.cfg
    ep, ep_i, tp, tp_i = model_shards(cfg, mesh, batch_axes)
    state = dict(model.state_dict())
    for i, layer in enumerate(model.layers):
        if layer.moe is not None:
            part = shard_moe_params(dict(layer.moe), cfg.moe, ep, ep_i, tp, tp_i)
            state.update({f"layers.{i}.moe.{k}": v.contiguous() for k, v in part.items()})
    out = Transformer(cfg, torch.device("meta"), mesh, batch_axes)
    out.load_state_dict(state, assign=True)
    return out


def batch_shard(x: torch.Tensor, mesh, batch_axes=("data",)) -> torch.Tensor:
    """This rank's rows of a whole (B, ...) batch: block ``i`` of EP equal
    blocks, ``i`` its index along ``batch_axes`` (the reference's
    ``P(batch_axes, None)`` split of the flattened tokens when B % EP ==
    0).  ``ValueError`` when B % EP != 0."""
    ep, i = mesh.axis_size(batch_axes), mesh.axis_index(batch_axes)
    if x.shape[0] % ep:
        raise ValueError(f"a batch of {x.shape[0]} does not split over {ep} ranks of "
                         f"{tuple(batch_axes)}")
    n = x.shape[0] // ep
    return x[i * n:(i + 1) * n]


def _hidden(model: Transformer, tokens: torch.Tensor, caches, cache_index, use_kernels,
            mesh=None, batch_axes=("data",)):
    """The final-normed hidden states (B, S, D)."""
    cfg = model.cfg
    dt = cfg.act_dtype
    S = tokens.shape[1]
    start = 0 if cache_index is None else int(cache_index)
    positions = start + torch.arange(S, dtype=torch.int32, device=tokens.device)
    x = model.embed.to(dt)[tokens]
    for i, layer in enumerate(model.layers):
        cache = caches["layers"][i] if caches is not None else None
        x, _, _ = layer(x, positions, cache=cache, cache_index=cache_index,
                        use_kernels=use_kernels, mesh=mesh, batch_axes=batch_axes)
    return rms_norm(x, model.final_norm, cfg.norm_eps)


def _logits(model: Transformer, x: torch.Tensor) -> torch.Tensor:
    return x @ model.unembedding().to(x.dtype).T


def _check_mesh(model: Transformer, mesh, batch_axes) -> None:
    if model.shards != model_shards(model.cfg, mesh, batch_axes):
        raise ValueError(f"the model holds shards {model.shards} (EP, index, TP, index), the "
                         f"mesh and batch_axes {tuple(batch_axes)} give "
                         f"{model_shards(model.cfg, mesh, batch_axes)}")


@torch.inference_mode()
def forward(model: Transformer, tokens: torch.Tensor, caches: dict | None = None,
            cache_index: int | None = None, use_kernels: bool | str = "auto", mesh=None,
            batch_axes=("data",)):
    """tokens (B, S) int -> (logits (B, S, vocab), caches).  With
    ``caches``, the new keys and values go in at ``cache_index``.  With
    ``mesh``, ``tokens`` are this rank's requests (``batch_shard``)."""
    _check_mesh(model, mesh, batch_axes)
    use = resolve_use_kernels(use_kernels, tokens.device)
    x = _hidden(model, tokens, caches, cache_index, use, mesh, batch_axes)
    return _logits(model, x), caches


def _embed_rows(embed: torch.Tensor, tokens: torch.Tensor) -> torch.Tensor:
    """``embed[tokens]``.  A DTensor table (a model on a mesh) is gathered
    under ``local_map``: each rank takes the rows of its own slice of the
    vocabulary (zeros for tokens outside it) and the rows are summed over
    the vocabulary split, then placed as the tokens are; the table's
    gradient is each rank's slice, summed over the batch axes.  DTensor's
    own sharding of ``index_put`` (the gradient of ``embed[tokens]``) and
    of ``embedding`` over a vocabulary split fail on torch 2.11."""
    if not hasattr(embed, "device_mesh"):
        return embed[tokens]
    from torch.distributed.tensor import DTensor, Partial, Replicate, Shard
    from torch.distributed.tensor.experimental import local_map

    dm = embed.device_mesh
    if not isinstance(tokens, DTensor):
        tokens = DTensor.from_local(tokens, dm, [Replicate()] * dm.ndim, run_check=False)
    tok_pl, split = tuple(tokens.placements), []
    lo = 0
    for i, p in enumerate(embed.placements):
        if p == Shard(0):
            split.append(i)
            lo = lo * dm.size(i) + dm.get_local_rank(i)
        elif not isinstance(p, Replicate):
            raise ValueError(f"an embedding table placed {embed.placements}: rows split or "
                             "replicated only")
    lo *= embed.shape[0] // max(1, math.prod(dm.size(i) for i in split))
    out_pl = tuple(Partial() if i in split else p for i, p in enumerate(tok_pl))
    grad_pl = tuple(Shard(0) if i in split else Partial() if isinstance(p, Shard) else Replicate()
                    for i, p in enumerate(tok_pl))

    def gather(tok, table):
        idx = tok - lo
        ok = (idx >= 0) & (idx < table.shape[0])
        return F.embedding(torch.where(ok, idx, 0), table) * ok[..., None].to(table.dtype)

    x = local_map(gather, out_placements=(out_pl,), in_placements=(tok_pl, tuple(embed.placements)),
                  in_grad_placements=(tok_pl, grad_pl), device_mesh=dm)(tokens, embed)
    return x.redistribute(dm, tok_pl)


def _train_hidden(model: Transformer, tokens: torch.Tensor, mesh=None):
    """(final-normed hidden states (B, S, D), summed MoE aux) through the
    plain routes; with ``cfg.remat`` under grad mode, each layer past the
    dense prefix is recomputed in the backward (a MoE layer on a mesh
    repeats its exchanges then)."""
    cfg = model.cfg
    positions = torch.arange(tokens.shape[1], dtype=torch.int32, device=tokens.device)
    x = _embed_rows(model.embed.to(cfg.act_dtype), tokens)
    aux = torch.zeros((), dtype=torch.float32, device=tokens.device)
    remat = cfg.remat and torch.is_grad_enabled()
    for i, layer in enumerate(model.layers):
        if remat and i >= cfg.n_prefix_layers:
            x, _, a = checkpoint(layer, x, positions, mesh=mesh, use_reentrant=False)
        else:
            x, _, a = layer(x, positions, mesh=mesh)
        if a is not None:
            aux = aux + a
    return rms_norm(x, model.final_norm, cfg.norm_eps), aux


def lm_loss(model: Transformer, tokens: torch.Tensor, mesh=None) -> torch.Tensor:
    """Next-token cross entropy of ``tokens`` (B, S + 1) int (the float32
    ``cross_entropy_loss`` of the logits of ``tokens[:, :-1]`` against
    ``tokens[:, 1:]``), plus ``aux_loss_weight * aux / max(n_scan_layers,
    1)`` for a MoE, through the plain routes; runs under grad mode.  Above
    2048 x 2048 attention scores attention runs blocked, with its
    FlashAttention-2 backward (``attention._flash_sdpa``), as the
    reference's does.

    Over a mesh (``mesh``, a ``launch.mesh.ModelMesh``), SPMD: the model's
    parameters are DTensors placed by ``dist.sharding.distribute`` and
    ``tokens`` a DTensor placed by ``lm_batch_spec``; the loss runs under
    ``implicit_replication`` (positions, masks and the vocabulary iota are
    plain tensors, the same on every rank) and is a DTensor.  A MoE layer
    runs ``moe.moe_ffn_placed``: its experts exchanged over the batch axes
    and summed over ``model`` by ``moe_ffn(mesh=)`` on each rank's shards,
    with its collectives' adjoints."""
    cfg = model.cfg
    if mesh is not None:
        from repro_torch.dist.sharding import implicit_replication

        with implicit_replication():
            return _loss(model, tokens, mesh)
    return _loss(model, tokens, None)


def _loss(model: Transformer, tokens: torch.Tensor, mesh) -> torch.Tensor:
    cfg = model.cfg
    _check_mesh(model, None, ("data",))
    x, aux = _train_hidden(model, tokens[:, :-1], mesh)
    loss = cross_entropy_loss(_logits(model, x), tokens[:, 1:])
    if cfg.moe is not None:
        n = torch.full((), float(max(cfg.n_scan_layers, 1)), device=aux.device)
        loss = loss + cfg.moe.aux_loss_weight * aux / n
    return loss


def init_cache(cfg: TransformerConfig, batch: int, max_len: int,
               device: str | torch.device | None = None) -> dict:
    """Decode caches in ``cfg.dtype``, zero: per layer {'k', 'v'} of (batch,
    max_len, KV, dh), or for MLA the latent {'ckv': (batch, max_len,
    kv_lora), 'kr': (batch, max_len, d_rope)}."""
    _check_config(cfg)
    dev = resolve_device(device)

    def zeros(*shape):
        return torch.zeros((batch, max_len, *shape), dtype=cfg.act_dtype, device=dev)

    if cfg.attention == "mla":
        return {"layers": [{"ckv": zeros(cfg.mla.kv_lora), "kr": zeros(cfg.mla.d_rope)}
                           for _ in range(cfg.n_layers)]}
    return {"layers": [{"k": zeros(cfg.n_kv_heads, cfg.d_head),
                        "v": zeros(cfg.n_kv_heads, cfg.d_head)}
                       for _ in range(cfg.n_layers)]}


@torch.inference_mode()
def prefill(model: Transformer, tokens: torch.Tensor, caches: dict,
            use_kernels: bool | str = "auto", mesh=None, batch_axes=("data",)):
    """Run the prompt (B, S) through the stack, filling ``caches`` from
    position 0; returns (last-token logits (B, vocab), caches).  With
    ``mesh``, B is this rank's requests."""
    _check_mesh(model, mesh, batch_axes)
    use = resolve_use_kernels(use_kernels, tokens.device)
    x = _hidden(model, tokens, caches, 0, use, mesh, batch_axes)
    return _logits(model, x[:, -1]), caches


@torch.inference_mode()
def decode_step(model: Transformer, token: torch.Tensor, caches: dict, cache_index: int,
                use_kernels: bool | str = "auto", mesh=None, batch_axes=("data",)):
    """One new token (B, 1) at ``cache_index`` against the caches; returns
    (logits (B, vocab), caches).  Decode attends over the cache with the
    plain attention (the attention kernel takes a prompt's own keys only);
    ``use_kernels`` routes the MoE experts.  With ``mesh``, B is this rank's
    requests."""
    _check_mesh(model, mesh, batch_axes)
    use = resolve_use_kernels(use_kernels, token.device)
    x = _hidden(model, token, caches, cache_index, use, mesh, batch_axes)
    return _logits(model, x[:, -1]), caches
