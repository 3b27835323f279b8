"""Mixture-of-Experts FFN with the reference's three dispatch engines, on
one device or over a mesh (port of ``repro.models.moe``).

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
order).  The aux loss is computed as the reference's; serving drops it and
``transformer.lm_loss`` adds it, training through the plain routes (the
kernel has no backward).

Over a mesh (``moe_ffn(mesh=)``, the reference's ``shard_map`` at
``moe.py:254-305``), SPMD on ``torch.distributed``: every rank calls with
its slice of the tokens and its shards (``w_gate``/``w_up`` ``(E/EP, D,
F/TP)``, ``w_down`` ``(E/EP, F/TP, D)``, the shared experts split over
``model``, the router replicated; ``shard_moe_params``).  Each rank builds
the capacity-padded (E, C, D) buffer with C from its *local* token count,
so a shard drops other assignments than the whole batch would: the
sharded function equals ``_moe_core`` run on each shard, not the
single-device call on all tokens.  One ``all_to_all_single`` over the
expert axes sends expert block ``ep`` to expert-axis index ``ep`` and
gives (EP, E/EP, C, D) in source order (the reference's ``tiled=True``
exchange puts the sources on the capacity axis, in mesh order).  The plain
route runs the reference's einsum over (E/EP, EP*C, D); the kernel route
compacts the live rows (a second exchange carries each source's
``min(count_e, C)``) into the expert-sorted layout, group e holding source
r's prefix in r order, and makes three ``grouped_matmul`` launches bounded
by ``EP*C``.  At EP = 1 that is ``_grouped_ffn``'s layout: the same rows
in the same order.  One ``all_reduce`` over ``model`` sums the routed rows
and the shared experts' partial output together (the reference's fused
``psum``), one ``all_to_all_single`` brings the rows back, and the combine
is the single-device one.  aux is the mean over every rank of the mesh.
Shapes are fixed, so nothing is read back to the host; the ranks' token
counts are compared on the host (a gloo group) before any exchange.

Gradients over a mesh (the plain route): each exchange's adjoint is the
reverse exchange, the sum over ``model`` passes its gradient through
(Megatron's ``g``), the tokens entering the model-split experts sum their
partial gradients over ``model`` (Megatron's ``f``), and aux's mean hands
each rank its share of the batch ranks' mean.  ``moe_ffn_placed`` runs the
layer on DTensor parameters, as ``transformer.lm_loss(mesh=)`` trains it.
"""

from __future__ import annotations

import dataclasses
from dataclasses import dataclass

import torch
import torch.distributed as dist

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


def _expert_draw(generator: torch.Generator, n_experts: int, d_in: int,
                 d_out: int) -> torch.Tensor:
    """(E, d_in, d_out) normal float32 weights with std 1/sqrt(d_in), drawn
    on the generator's device."""
    w = torch.randn((n_experts, d_in, d_out), generator=generator, device=generator.device,
                    dtype=torch.float32)
    return w.mul_(1.0 / d_in ** 0.5)


def moe_draws(generator: torch.Generator, d_model: int, cfg: MoEConfig,
              dtype: torch.dtype = torch.float32):
    """``init_moe``'s draws in order, one (name, float32 tensor) at a time, so
    that a caller can cast each into its parameter (``copy_``) before the
    next is drawn: the expert banks then never sit beside the model in
    float32 and ``dtype`` at once.  The router's and the shared experts'
    come cast already (the router to float32)."""
    E, F = cfg.n_experts, cfg.d_ff
    yield "router", dense_init(generator, d_model, E, torch.float32)
    yield "w_gate", _expert_draw(generator, E, d_model, F)
    yield "w_up", _expert_draw(generator, E, d_model, F)
    yield "w_down", _expert_draw(generator, E, F, d_model)
    if cfg.n_shared > 0:
        Fs = cfg.shared_hidden
        yield "shared_gate", dense_init(generator, d_model, Fs, dtype)
        yield "shared_up", dense_init(generator, d_model, Fs, dtype)
        yield "shared_down", dense_init(generator, Fs, d_model, dtype)


def init_moe(generator: torch.Generator, d_model: int, cfg: MoEConfig,
             dtype: torch.dtype = torch.float32) -> dict:
    """The reference's ``init_moe`` parameters from ``generator``: the router
    in float32 whatever ``dtype`` is, the experts and shared experts in
    ``dtype``."""
    return {name: w if name == "router" else w.to(dtype)
            for name, w in moe_draws(generator, d_model, cfg, dtype)}


def expert_axes(batch_axes=("pod", "data"), expert_axis=None) -> tuple:
    """The axes the experts shard over: ``expert_axis``, or by default every
    batch axis (the reference's ``moe_ffn``)."""
    if expert_axis is None:
        return tuple(batch_axes)
    return (expert_axis,) if isinstance(expert_axis, str) else tuple(expert_axis)


def mesh_shards(mesh, batch_axes=("pod", "data"), expert_axis=None,
                tp_axis: str = "model") -> tuple:
    """(EP, this rank's expert-axis index, TP, its ``tp_axis`` index) on
    ``mesh``; ``ValueError`` for an axis the mesh lacks or one axis used
    for both."""
    ep_axes = mesh.axes(expert_axes(batch_axes, expert_axis))
    mesh.axes(batch_axes)
    tp_axes = mesh.axes(tp_axis)
    if set(ep_axes) & set(tp_axes):
        raise ValueError(f"the expert axes {ep_axes} and tp_axis {tp_axis!r} overlap")
    return (mesh.axis_size(ep_axes), mesh.axis_index(ep_axes), mesh.axis_size(tp_axes),
            mesh.axis_index(tp_axes))


def check_shards(cfg: MoEConfig, ep: int, tp: int) -> None:
    """``ValueError`` unless E splits over ``ep`` and the expert and shared
    widths over ``tp``."""
    if cfg.n_experts % ep:
        raise ValueError(f"{cfg.n_experts} experts do not split over {ep} expert shards")
    if cfg.d_ff % tp:
        raise ValueError(f"expert width {cfg.d_ff} does not split over {tp} model shards")
    if cfg.n_shared > 0 and cfg.shared_hidden % tp:
        raise ValueError(f"shared width {cfg.shared_hidden} does not split over {tp} "
                         "model shards")


def shard_shapes(d_model: int, cfg: MoEConfig, ep: int = 1, tp: int = 1) -> dict:
    """The shapes of one rank's MoE parameters at EP = ``ep``, TP = ``tp``."""
    check_shards(cfg, ep, tp)
    E, F = cfg.n_experts // ep, cfg.d_ff // tp
    d = d_model
    shapes = {"router": (d, cfg.n_experts), "w_gate": (E, d, F), "w_up": (E, d, F),
              "w_down": (E, F, d)}
    if cfg.n_shared > 0:
        Fs = cfg.shared_hidden // tp
        shapes.update(shared_gate=(d, Fs), shared_up=(d, Fs), shared_down=(Fs, d))
    return shapes


def shard_moe_params(params: dict, cfg: MoEConfig, ep: int, ep_index: int, tp: int,
                     tp_index: int) -> dict:
    """One rank's slices of full MoE parameters (torch tensors or numpy
    arrays): experts ``[ep_index * E/EP, ...)`` and the hidden columns
    ``[tp_index * F/TP, ...)``, the shared experts' hidden split the same
    way, the router whole.  Views where slicing allows (the E axis)."""
    check_shards(cfg, ep, tp)
    E, F = cfg.n_experts // ep, cfg.d_ff // tp
    e, f = slice(ep_index * E, (ep_index + 1) * E), slice(tp_index * F, (tp_index + 1) * F)
    out = {"router": params["router"], "w_gate": params["w_gate"][e, :, f],
           "w_up": params["w_up"][e, :, f], "w_down": params["w_down"][e, f, :]}
    if cfg.n_shared > 0:
        Fs = cfg.shared_hidden // tp
        s = slice(tp_index * Fs, (tp_index + 1) * Fs)
        out.update(shared_gate=params["shared_gate"][:, s], shared_up=params["shared_up"][:, s],
                   shared_down=params["shared_down"][s, :])
    return out


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


class ExchangeTimer:
    """While entered, records every collective of ``moe_ffn(mesh=)`` in this
    process: its kind (``dispatch``, ``counts``, ``tp_reduce``,
    ``return``, and in a backward ``dispatch_bwd``, ``return_bwd`` and
    ``tp_enter_bwd``), bytes sent, and on a CUDA device a pair of events
    around it on the current stream.  It may be entered more than once; the
    records add up.  :meth:`summary` waits for the device and sums them by
    kind."""

    active = None

    def __init__(self):
        self.records = []

    def __enter__(self) -> "ExchangeTimer":
        self.prior = ExchangeTimer.active
        ExchangeTimer.active = self
        return self

    def __exit__(self, *exc) -> None:
        ExchangeTimer.active = self.prior

    def summary(self) -> dict:
        out = {}
        for kind, n_bytes, start, end in self.records:
            row = out.setdefault(kind, {"calls": 0, "bytes": 0,
                                       "ms": None if start is None else 0.0})
            row["calls"] += 1
            row["bytes"] += n_bytes
            if start is not None:
                end.synchronize()
                row["ms"] += start.elapsed_time(end)
        return out


def _collective(kind: str, fn, t: torch.Tensor) -> None:
    rec = ExchangeTimer.active
    if rec is None:
        fn()
        return
    start = end = None
    if t.is_cuda:
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        start.record()
    fn()
    if end is not None:
        end.record()
    rec.records.append((kind, t.numel() * t.element_size(), start, end))


def _all_to_all(kind: str, out: torch.Tensor, inp: torch.Tensor, group) -> torch.Tensor:
    """Equal-split ``all_to_all_single`` on dim 0 (block r to rank r)."""
    _collective(kind, lambda: dist.all_to_all_single(out, inp, group=group), inp)
    return out


class _Exchange(torch.autograd.Function):
    """The expert exchange: block r of dim 0 to rank r of ``group``.  Its
    adjoint is the reverse exchange, the same all-to-all of the gradient
    (kind ``<kind>_bwd``)."""

    @staticmethod
    def forward(ctx, inp, kind, group):
        ctx.kind, ctx.group = kind, group
        return _all_to_all(kind, torch.empty_like(inp), inp.contiguous(), group)

    @staticmethod
    def backward(ctx, grad):
        grad = grad.contiguous()
        return _all_to_all(ctx.kind + "_bwd", torch.empty_like(grad), grad, ctx.group), None, None


class _TPReduce(torch.autograd.Function):
    """Megatron's ``g``: the model ranks' partial outputs summed into one
    value that each of them holds; the adjoint is the identity (each rank's
    partial gets the whole gradient)."""

    @staticmethod
    def forward(ctx, t, group):
        ctx.mark_dirty(t)   # summed in place: ``t`` is the caller's fresh concatenation
        _collective("tp_reduce", lambda: dist.all_reduce(t, group=group), t)
        return t

    @staticmethod
    def backward(ctx, grad):
        return grad, None


class _TPEnter(torch.autograd.Function):
    """Megatron's ``f``: the tokens entering the model-split experts.  The
    identity forward; the adjoint sums the model ranks' partial gradients
    (kind ``tp_enter_bwd``), so the tokens' gradient is whole on every
    model rank, as the router's path already makes it."""

    @staticmethod
    def forward(ctx, t, group):
        ctx.group = group
        return t.view_as(t)

    @staticmethod
    def backward(ctx, grad):
        out = grad.clone()
        _collective("tp_enter_bwd", lambda: dist.all_reduce(out, group=ctx.group), out)
        return out, None


class _BatchMean(torch.autograd.Function):
    """aux averaged over every rank of the mesh.  Its value is the same on
    the ranks that share batch coordinates (they route the same tokens), so
    the mean is the mean over the ``n_batch`` batch ranks' values and its
    adjoint hands each rank ``grad / n_batch``: the router's gradient is a
    sum over the batch ranks, one copy per model rank."""

    @staticmethod
    def forward(ctx, aux, group, size, n_batch):
        ctx.n_batch = n_batch
        out = aux.reshape(1).clone()
        dist.all_reduce(out, group=group)
        return out[0] / size

    @staticmethod
    def backward(ctx, grad):
        return grad / ctx.n_batch, None, None, None


@dataclass(frozen=True)
class _MeshAxes:
    """The groups of one ``moe_ffn(mesh=)`` call."""

    ep_group: object
    ep: int
    tp_group: object
    tp: int


def _grouped_rows(params: dict, recv: torch.Tensor, rcnt: torch.Tensor) -> torch.Tensor:
    """The kernel route's expert FFN on the received (EP, E/EP, C, D)
    buffer: source r's live prefix ``rcnt[r, e]`` of expert e goes to rows
    ``starts[e] + sum(rcnt[:r, e]) + c`` of the expert-sorted layout (dead
    slots to a row past every group), three ``grouped_matmul`` launches
    bounded by EP*C run it, and the rows come back to (EP, E/EP, C, D),
    zero where dead."""
    EP, El, C, D = recv.shape
    n = EP * El * C
    counts = rcnt.sum(0, dtype=torch.int32)
    starts = torch.cumsum(counts, 0, dtype=torch.int32) - counts
    off = torch.cumsum(rcnt, 0) - rcnt
    c = torch.arange(C, device=recv.device)
    live = c < rcnt[:, :, None]
    dest = torch.where(live, (starts[None, :] + off)[:, :, None].long() + c, n).reshape(-1)
    xs = recv.new_zeros((n + 1, D))
    xs[dest] = recv.reshape(n, D)
    dt = recv.dtype

    def gmm(a, name):
        return grouped_matmul(a, params[name].to(dt), starts, counts, EP * C)

    h = swiglu(gmm(xs, "w_gate"), gmm(xs, "w_up"))
    return gmm(h, "w_down")[dest].view(EP, El, C, D)


def _exchange_ffn(params: dict, x: torch.Tensor, flat_e: torch.Tensor, tok: torch.Tensor,
                  slot: torch.Tensor, keep: torch.Tensor, C: int, cfg: MoEConfig,
                  axes: _MeshAxes, use_kernels: bool):
    """The expert FFN of every assignment over the mesh: (T*K, D) rows,
    meaningful where kept, and the shared experts' output (None without
    them), both summed over ``model``."""
    E, D, dt = cfg.n_experts, x.shape[1], x.dtype
    EP, El = axes.ep, cfg.n_experts // axes.ep
    if axes.tp > 1:
        x = _TPEnter.apply(x, axes.tp_group)
    e, s = flat_e.long(), torch.where(keep, slot, C - 1)
    buf = torch.zeros((E, C, D), dtype=dt, device=x.device)
    buf.index_put_((e, s), torch.where(keep[:, None], x[tok], 0.0), accumulate=True)
    recv = _Exchange.apply(buf.view(EP, El, C, D), "dispatch", axes.ep_group)
    if use_kernels:
        cnt = torch.zeros(E, dtype=torch.int32, device=x.device).index_add_(
            0, e, torch.ones(e.numel(), dtype=torch.int32, device=x.device)).clamp_(max=C)
        rcnt = _all_to_all("counts", torch.empty_like(cnt).view(EP, El), cnt.view(EP, El),
                           axes.ep_group)
        y = _grouped_rows(params, recv, rcnt)
    else:
        xb = recv.transpose(0, 1).reshape(El, EP * C, D)
        y = _expert_ffn(params, xb).view(El, EP, C, D).transpose(0, 1).contiguous()
    shared = _shared_ffn(params, x) if cfg.n_shared > 0 else None
    if axes.tp > 1:
        parts = [y.reshape(-1)] + ([] if shared is None else [shared.reshape(-1)])
        flat = _TPReduce.apply(torch.cat(parts), axes.tp_group)
        y = flat[:y.numel()].view(y.shape)
        if shared is not None:
            shared = flat[y.numel():].view(shared.shape)
    back = _Exchange.apply(y, "return", axes.ep_group)
    return back.view(E, C, D)[e, s], shared


def _moe_core(x: torch.Tensor, params: dict, cfg: MoEConfig, engine: str,
              use_kernels: bool = False, axes: _MeshAxes | None = None):
    """One MoE FFN application on (T, D) tokens -> ((T, D), aux).  With
    ``chunk_tokens``, the tokens are zero-padded to a multiple of it and run
    chunk by chunk, each with its own capacity (and over a mesh its own
    exchange), as the reference's ``lax.map``; aux is the chunks' mean."""
    if cfg.chunk_tokens and x.shape[0] > cfg.chunk_tokens:
        T0, D = x.shape
        c = cfg.chunk_tokens
        n_chunks = -(-T0 // c)
        xp = torch.cat([x, x.new_zeros((n_chunks * c - T0, D))])
        inner = cfg.replace(chunk_tokens=0)
        outs = [_moe_core(xc, params, inner, engine, use_kernels, axes) for xc in xp.split(c)]
        y = torch.cat([o[0] for o in outs])[:T0]
        return y, torch.stack([o[1] for o in outs]).mean()

    T, D = x.shape
    E, K = cfg.n_experts, cfg.top_k
    topk_ids, topk_w, aux = _route(x, params["router"], cfg)
    shared = None
    if engine == "dense":
        if axes is not None:
            raise ValueError("the dense engine runs on one device only (no expert exchange)")
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
        if axes is not None:
            rows, shared = _exchange_ffn(params, x, flat_e, tok, slot, keep, C, cfg, axes,
                                         use_kernels)
        elif use_kernels:
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
    if shared is not None:
        y = y + shared
    elif cfg.n_shared > 0:
        y = y + _shared_ffn(params, x)
    return y, aux


def _same_token_count(mesh, T: int) -> None:
    """``ValueError`` on every rank unless every rank of ``mesh`` holds T
    tokens (one host all-reduce on the mesh's gloo group)."""
    if mesh.host_group is None:
        return
    from torch._subclasses.fake_tensor import unset_fake_temporarily

    with unset_fake_temporarily():   # a host value, real under the dry run's fake tensors too
        t = torch.tensor([T, -T], dtype=torch.int64)
        dist.all_reduce(t, op=dist.ReduceOp.MAX, group=mesh.host_group)
        hi, lo = int(t[0]), int(-t[1])
    if hi != T or lo != T:
        raise ValueError(f"moe_ffn: the ranks hold from {lo} to {hi} tokens; "
                         "every rank must hold the same count")


def moe_ffn(params: dict, x: torch.Tensor, cfg: MoEConfig, mesh=None,
            batch_axes=("pod", "data"), expert_axis=None, tp_axis: str = "model",
            use_kernels: bool = False):
    """The MoE FFN on (T, D) flattened tokens -> ((T, D), aux); the engine
    comes from ``select_dispatch_engine``.

    With ``mesh`` (a ``launch.mesh.ModelMesh``), every rank of the mesh
    calls it with the same arguments but its own tokens (its slice along
    ``batch_axes``) and its own shards (``shard_moe_params``): the experts
    shard over ``expert_axis`` (default every batch axis) and their width
    over ``tp_axis``.  Returns this rank's (T, D) rows and aux averaged over
    the mesh.  Raises ``ValueError`` for the dense engine, an axis the mesh
    lacks, shards that do not split or do not match, and ranks whose token
    counts differ."""
    engine = select_dispatch_engine(cfg, x.shape[0])
    if mesh is None:
        return _moe_core(x, params, cfg, engine, use_kernels)
    if engine == "dense":
        raise ValueError("moe_ffn: the dense engine runs on one device only; pick 'sorted' or "
                         "'gather' to run over a mesh")
    ep, _, tp, _ = mesh_shards(mesh, batch_axes, expert_axis, tp_axis)
    want = shard_shapes(x.shape[1], cfg, ep, tp)
    got = {k: tuple(params[k].shape) for k in want if k in params}
    if got != want:
        raise ValueError(f"moe_ffn: this rank's shards are {got}, expected {want} at EP={ep}, "
                         f"TP={tp}")
    _same_token_count(mesh, x.shape[0])
    axes = _MeshAxes(ep_group=mesh.group_of(expert_axes(batch_axes, expert_axis)), ep=ep,
                     tp_group=mesh.group_of(tp_axis), tp=tp)
    y, aux = _moe_core(x, params, cfg, engine, use_kernels, axes)
    if mesh.size > 1:
        aux = _BatchMean.apply(aux, mesh.group, mesh.size, mesh.axis_size(batch_axes))
    return y, aux


def moe_ffn_placed(params: dict, x: torch.Tensor, cfg: MoEConfig, mesh):
    """``moe_ffn(mesh=)`` on DTensors: ``params`` placed by
    ``dist.sharding.lm_rule`` (E over the batch axes, the width over
    ``model``, the router replicated) and tokens ``x`` (..., D) split over
    the batch axes on dim 0, on ``launch.mesh.device_mesh(mesh)``.  Each
    rank runs ``moe_ffn(mesh=)`` on its local tokens and shards under
    ``local_map``, so C comes from its local token count, as in the
    reference.  Returns (y placed as the tokens, aux replicated).

    Gradients: an expert shard's is whole on its rank; a parameter
    replicated over a batch axis (the router, the shared experts) gets a
    sum over the batch ranks (``Partial``), one copy per model rank, since
    the tokens' path into the model-split experts sums its partial
    gradients (``_TPEnter``) and aux's mean hands each rank its share of
    the batch ranks' mean (``_BatchMean``); the tokens' gradient is placed
    as the tokens."""
    from torch.distributed.tensor import Partial, Replicate, Shard
    from torch.distributed.tensor.experimental import local_map

    from repro_torch.dist.sharding import batch_axes as mesh_batch_axes

    keys = list(params)
    dm = params[keys[0]].device_mesh
    names = dm.mesh_dim_names
    ba = mesh_batch_axes(mesh)
    tok_pl = tuple(Shard(0) if a in ba else Replicate() for a in names)
    x = x.redistribute(dm, tok_pl)
    par_pl = tuple(tuple(params[k].placements) for k in keys)
    grad_pl = tuple(tuple(p if isinstance(p, Shard) else Partial() if names[i] in ba
                          else Replicate() for i, p in enumerate(pl)) for pl in par_pl)

    def local(xl, *shards):
        y, aux = moe_ffn(dict(zip(keys, shards)), xl.reshape(-1, xl.shape[-1]), cfg, mesh=mesh,
                         batch_axes=ba)
        return y.reshape(xl.shape), aux

    return local_map(local, out_placements=(tok_pl, (Replicate(),) * len(names)),
                     in_placements=(tok_pl, *par_pl), in_grad_placements=(tok_pl, *grad_pl),
                     device_mesh=dm)(x, *(params[k] for k in keys))
