"""Mixture-of-Experts FFN with the reference's three dispatch engines, on
one device, for inference (port of ``repro.models.moe``).

* ``dense``: every expert runs every token and the top-k weights mask the
  combine (plain PyTorch on both routes, as in the reference).
* ``sorted``: the assignments sorted by expert id (the compaction pass).
* ``gather``: each assignment placed at its cumulative-rank slot, no sort.

Routes.  With ``use_kernels`` off, ``sorted`` and ``gather`` run the
reference's capacity-padded (E, C, D) buffer and its ``einsum`` expert FFN.
With it on, they build the expert-sorted layout the reference's
``grouped_matmul`` kernel takes (``moe.py:12-15``): group e holds expert
e's kept assignments in token-major order at rows ``[starts[e], starts[e] +
counts[e])``, ``counts = min(count_e, C)`` and ``starts`` their exclusive
cumsum, all on the device (no host sync).  ``sorted`` gets there with a
stable sort on the key ``expert`` (``E`` for a dropped assignment, so those
follow every group); ``gather`` writes row (t, k) straight to ``starts[e] +
slot``.  The two give the same layout, since the rank in a stable sort is
the cumulative one-hot rank.  The expert FFN is then three ``grouped_matmul``
launches (gate, up, and down after SwiGLU) bounded by the capacity C.

Both routes combine each token's K weighted rows as a float32 (T, K, D) sum
cast once, where the reference adds them one by one into a ``zeros_like(x)``
scatter: equal to rounding in float32, within bf16 rounding of the sum in
bf16.  The router runs in float32 on float32 weights whatever the model's
dtype.  ``jax.lax.top_k`` breaks ties by the lower index; the port takes a
stable descending sort, which does the same (``torch.topk`` promises no
order).  The aux loss is computed as the reference's; inference drops it.
"""

from __future__ import annotations

import dataclasses
from dataclasses import dataclass

import torch

from repro_torch.kernels.grouped_matmul.ops import grouped_matmul
from repro_torch.models.common import dense_init, swiglu


@dataclass(frozen=True)
class MoEConfig:
    n_experts: int
    top_k: int
    d_ff: int                  # per-expert hidden dim
    n_shared: int = 0
    d_ff_shared: int = 0       # defaults to n_shared * d_ff
    capacity_factor: float = 1.25
    dispatch: str = "auto"     # 'dense' | 'sorted' | 'gather' | 'auto'
    chunk_tokens: int = 0      # >0: process tokens in chunks (memory bound)
    aux_loss_weight: float = 0.001

    @property
    def shared_hidden(self) -> int:
        return self.d_ff_shared or self.n_shared * self.d_ff

    def replace(self, **kw) -> "MoEConfig":
        return dataclasses.replace(self, **kw)


def select_dispatch_engine(cfg: MoEConfig, n_tokens: int) -> str:
    """The reference's engine choice from the config's shape: ``dense`` when
    E is within 2x of top_k, ``gather`` for E <= 32, else ``sorted``."""
    if cfg.dispatch != "auto":
        return cfg.dispatch
    if cfg.n_experts <= 2 * cfg.top_k:
        return "dense"
    if cfg.n_experts <= 32:
        return "gather"
    return "sorted"


def expert_init(generator: torch.Generator, n_experts: int, d_in: int, d_out: int,
                dtype: torch.dtype = torch.float32) -> torch.Tensor:
    """(E, d_in, d_out) normal weights with std 1/sqrt(d_in), drawn in float32
    on the generator's device, then cast."""
    w = torch.randn((n_experts, d_in, d_out), generator=generator, device=generator.device,
                    dtype=torch.float32)
    return w.mul_(1.0 / d_in ** 0.5).to(dtype)


def init_moe(generator: torch.Generator, d_model: int, cfg: MoEConfig,
             dtype: torch.dtype = torch.float32) -> dict:
    """The reference's ``init_moe`` parameters from ``generator``: the router
    in float32 whatever ``dtype`` is, the experts and shared experts in
    ``dtype``."""
    E, F = cfg.n_experts, cfg.d_ff
    p = {
        "router": dense_init(generator, d_model, E, torch.float32),
        "w_gate": expert_init(generator, E, d_model, F, dtype),
        "w_up": expert_init(generator, E, d_model, F, dtype),
        "w_down": expert_init(generator, E, F, d_model, dtype),
    }
    if cfg.n_shared > 0:
        Fs = cfg.shared_hidden
        p["shared_gate"] = dense_init(generator, d_model, Fs, dtype)
        p["shared_up"] = dense_init(generator, d_model, Fs, dtype)
        p["shared_down"] = dense_init(generator, Fs, d_model, dtype)
    return p


def _route(x: torch.Tensor, router: torch.Tensor, cfg: MoEConfig):
    """float32 router -> (top-k ids (T, K) int32, normalised weights in x's
    dtype, aux load-balance loss)."""
    probs = torch.softmax(x.float() @ router, dim=-1)
    K, E = cfg.top_k, cfg.n_experts
    # jax.lax.top_k: ties to the lower index, which a stable descending sort keeps
    top = torch.sort(probs, dim=-1, descending=True, stable=True)
    topk_w, topk_ids = top.values[:, :K], top.indices[:, :K]
    topk_w = topk_w / topk_w.sum(dim=-1, keepdim=True).clamp_min(1e-9)
    counts = torch.zeros(E, device=x.device).index_add_(
        0, topk_ids.reshape(-1), torch.ones(topk_ids.numel(), device=x.device))
    frac_tokens = counts / counts.sum().clamp_min(1.0)
    aux = E * (frac_tokens * probs.mean(dim=0)).sum()
    return topk_ids.to(torch.int32), topk_w.to(x.dtype), aux


def _expert_ffn(params: dict, xb: torch.Tensor) -> torch.Tensor:
    """The reference's capacity-buffer FFN: (E, C, D) -> (E, C, D)."""
    dt = xb.dtype
    h = swiglu(torch.einsum("ecd,edf->ecf", xb, params["w_gate"].to(dt)),
               torch.einsum("ecd,edf->ecf", xb, params["w_up"].to(dt)))
    return torch.einsum("ecf,efd->ecd", h, params["w_down"].to(dt))


def _capacity(n_assign: int, n_experts: int, cf: float) -> int:
    c = max(int(n_assign / max(n_experts, 1) * cf), 8)
    return -(-c // 8) * 8


def _slots_gather(flat_e: torch.Tensor, E: int, C: int):
    """Slot of each assignment by its cumulative one-hot rank (no sort)."""
    onehot = torch.nn.functional.one_hot(flat_e.long(), E)
    ranks = torch.cumsum(onehot, dim=0) - onehot
    slot = ranks.gather(1, flat_e.long()[:, None])[:, 0]
    return slot, slot < C


def _slots_sorted(flat_e: torch.Tensor, E: int, C: int):
    """Slot of each assignment by its rank in a stable sort by expert id."""
    e = flat_e.long()
    order = torch.argsort(e, stable=True)
    counts = torch.zeros(E, dtype=torch.long, device=e.device).index_add_(
        0, e, torch.ones_like(e))
    starts = torch.cumsum(counts, 0) - counts
    pos = torch.arange(e.numel(), device=e.device) - starts[e[order]]
    slot = torch.empty_like(e)
    slot[order] = pos
    return slot, slot < C


def _grouped_ffn(params: dict, x: torch.Tensor, flat_e: torch.Tensor, tok: torch.Tensor,
                 slot: torch.Tensor, keep: torch.Tensor, C: int, engine: str) -> torch.Tensor:
    """The expert FFN of every assignment through three ``grouped_matmul``
    launches over the expert-sorted layout; (T*K, D), zero where dropped."""
    E = params["w_gate"].shape[0]
    n, dt = flat_e.numel(), x.dtype
    e = flat_e.long()
    totals = torch.zeros(E, dtype=torch.int32, device=x.device).index_add_(
        0, e, torch.ones(n, dtype=torch.int32, device=x.device))
    counts = totals.clamp(max=C)
    starts = torch.cumsum(counts, 0, dtype=torch.int32) - counts
    if engine == "sorted":
        # dropped assignments get the key E: they sort after every group
        order = torch.argsort(torch.where(keep, e, E), stable=True)
        xs = x[tok[order]]
        dest = torch.empty_like(order)
        dest[order] = torch.arange(n, device=x.device)
    else:
        # a kept row goes straight to starts[e] + slot; dropped rows to row n,
        # which lies outside every group
        dest = torch.where(keep, starts.long()[e] + slot, n)
        xs = torch.zeros((n + 1, x.shape[1]), dtype=dt, device=x.device)
        xs[dest] = x[tok]

    def gmm(a, name):
        return grouped_matmul(a, params[name].to(dt), starts, counts, C)

    h = swiglu(gmm(xs, "w_gate"), gmm(xs, "w_up"))
    return gmm(h, "w_down")[dest]


def _shared_ffn(params: dict, x: torch.Tensor) -> torch.Tensor:
    dt = x.dtype
    h = swiglu(x @ params["shared_gate"].to(dt), x @ params["shared_up"].to(dt))
    return h @ params["shared_down"].to(dt)


def _moe_core(x: torch.Tensor, params: dict, cfg: MoEConfig, engine: str,
              use_kernels: bool = False):
    """One MoE FFN application on (T, D) tokens -> ((T, D), aux).  With
    ``chunk_tokens``, the tokens are zero-padded to a multiple of it and run
    chunk by chunk, each with its own capacity, as the reference's
    ``lax.map``; aux is the chunks' mean."""
    if cfg.chunk_tokens and x.shape[0] > cfg.chunk_tokens:
        T0, D = x.shape
        c = cfg.chunk_tokens
        n_chunks = -(-T0 // c)
        xp = torch.cat([x, x.new_zeros((n_chunks * c - T0, D))])
        inner = cfg.replace(chunk_tokens=0)
        outs = [_moe_core(xc, params, inner, engine, use_kernels) for xc in xp.split(c)]
        y = torch.cat([o[0] for o in outs])[:T0]
        return y, torch.stack([o[1] for o in outs]).mean()

    T, D = x.shape
    E, K = cfg.n_experts, cfg.top_k
    topk_ids, topk_w, aux = _route(x, params["router"], cfg)
    if engine == "dense":
        y = torch.zeros_like(x)
        for e in range(E):
            h = swiglu(x @ params["w_gate"][e].to(x.dtype), x @ params["w_up"][e].to(x.dtype))
            y_e = h @ params["w_down"][e].to(x.dtype)
            gate = torch.where(topk_ids == e, topk_w, 0.0).sum(dim=-1, keepdim=True)
            y = y + y_e * gate
    elif engine in ("sorted", "gather"):
        flat_e = topk_ids.reshape(-1)
        tok = torch.arange(T, device=x.device).repeat_interleave(K)
        C = _capacity(T * K, E, cfg.capacity_factor)
        slot, keep = (_slots_sorted if engine == "sorted" else _slots_gather)(flat_e, E, C)
        if use_kernels:
            rows = _grouped_ffn(params, x, flat_e, tok, slot, keep, C, engine)
        else:
            e, s = flat_e.long(), torch.where(keep, slot, C - 1)
            buf = torch.zeros((E, C, D), dtype=x.dtype, device=x.device)
            buf.index_put_((e, s), torch.where(keep[:, None], x[tok], 0.0), accumulate=True)
            rows = _expert_ffn(params, buf)[e, s]
        contrib = torch.where(keep[:, None], rows, 0.0) * topk_w.reshape(-1)[:, None]
        y = contrib.reshape(T, K, D).float().sum(dim=1).to(x.dtype)
    else:
        raise ValueError(f"unknown dispatch engine {engine!r}")
    if cfg.n_shared > 0:
        y = y + _shared_ffn(params, x)
    return y, aux


def moe_ffn(params: dict, x: torch.Tensor, cfg: MoEConfig, mesh=None,
            use_kernels: bool = False):
    """The MoE FFN on (T, D) flattened tokens -> ((T, D), aux) on one device;
    the engine comes from ``select_dispatch_engine``."""
    if mesh is not None:
        raise NotImplementedError("expert-parallel MoE over a mesh is not ported yet "
                                  "(ROADMAP queue 1, item 11: multi-GPU)")
    return _moe_core(x, params, cfg, select_dispatch_engine(cfg, x.shape[0]), use_kernels)
