"""DLRM (MLPerf config, Criteo 1TB) for inference (port of
``repro.models.dlrm``).

bottom MLP (13 dense) -> 26 embedding-bag lookups (the HyTM row engines of
``models/embedding.py``) -> pairwise-dot feature interaction -> top MLP.
``retrieval_score`` covers the ``retrieval_cand`` cell: one query tower
against (N, D) candidates as one product, then the top k.

The reference's parameter tree becomes a ``DLRM`` module: ``tables`` (one
(V_i, D) parameter per field), ``bot`` and ``top`` (``{"w": [...], "b":
[...]}``).  ``dlrm_forward`` and ``dlrm_loss`` take ``use_kernels``
("auto", True or False), which routes the ``gather`` and ``dedup`` lookups
through the ``embedding_bag`` kernel.  The MLPs and the interaction run in
float32 as the reference's do; TF32 stays off (PyTorch's default).
``dlrm_loss`` runs under grad mode (training passes ``use_kernels=False``:
the plain bag, ``take_rows``' wrap of a negative id included, since the
kernel has no backward); ``dlrm_forward`` and ``retrieval_score`` serve
under ``torch.inference_mode``.  The reference's ``abstract_dlrm_params``
serves the dry run, which comes with the arch specs.  ``torch.triu_indices(F, F, 1)`` gives
the row-major order of ``jnp.triu_indices(F, k=1)``.  ``torch.topk`` does
not promise ``jax.lax.top_k``'s lower-index-first order on ties.
"""

from __future__ import annotations

import dataclasses
from dataclasses import dataclass

import torch
import torch.nn.functional as F
from torch import nn

from repro_torch.kernels.runtime import resolve_device, resolve_use_kernels
from repro_torch.models.common import at_least_f32, frozen, mlp_apply, mlp_init
from repro_torch.models.embedding import embedding_bag

# MLPerf DLRM vocab sizes (Criteo Terabyte, day-sampled), 26 sparse fields.
MLPERF_VOCAB_SIZES = (
    39884406, 39043, 17289, 7420, 20263, 3, 7120, 1543, 63, 38532951,
    2953546, 403346, 10, 2208, 11938, 155, 4, 976, 14, 39979771,
    25641295, 39664984, 585935, 12972, 108, 36,
)


@dataclass(frozen=True)
class DLRMConfig:
    name: str = "dlrm-mlperf"
    n_dense: int = 13
    vocab_sizes: tuple = MLPERF_VOCAB_SIZES
    embed_dim: int = 128
    bot_mlp: tuple = (512, 256, 128)
    top_mlp: tuple = (1024, 1024, 512, 256, 1)
    multi_hot: int = 1            # lookups per field
    interaction: str = "dot"
    table_engine: str = "auto"
    dtype: str = "float32"

    @property
    def n_sparse(self) -> int:
        return len(self.vocab_sizes)

    @property
    def n_interact_features(self) -> int:
        f = self.n_sparse + 1
        return f * (f - 1) // 2

    def bot_dims(self) -> list[int]:
        return [self.n_dense, *self.bot_mlp]

    def top_dims(self) -> list[int]:
        return [self.embed_dim + self.n_interact_features, *self.top_mlp]

    def replace(self, **kw) -> "DLRMConfig":
        return dataclasses.replace(self, **kw)


def _mlp(dims: list[int], device: torch.device) -> nn.ModuleDict:
    return nn.ModuleDict({
        "w": nn.ParameterList(frozen(torch.empty((dims[i], dims[i + 1]), device=device))
                              for i in range(len(dims) - 1)),
        "b": nn.ParameterList(frozen(torch.zeros(dims[i + 1], device=device))
                              for i in range(len(dims) - 1))})


class DLRM(nn.Module):
    """The model's parameters in float32 (as the reference's, whatever
    ``cfg.dtype`` says; its forward is the dot interaction whatever
    ``cfg.interaction`` says), allocated uninitialised:
    ``init_dlrm`` fills them from a generator, ``convert.dlrm_params`` from
    the reference's parameter tree."""

    def __init__(self, cfg: DLRMConfig, device: torch.device):
        super().__init__()
        self.cfg = cfg
        self.tables = nn.ParameterList(
            frozen(torch.empty((v, cfg.embed_dim), device=device)) for v in cfg.vocab_sizes)
        self.bot = _mlp(cfg.bot_dims(), device)
        self.top = _mlp(cfg.top_dims(), device)


@torch.no_grad()
def init_dlrm(cfg: DLRMConfig, generator: torch.Generator,
              device: str | torch.device | None = None) -> DLRM:
    """A ``DLRM`` with random weights from ``generator`` (which must live on
    ``device``): tables normal / sqrt(D), each drawn in place so that no
    temporary of a table's size is made; MLP weights normal with std
    1/sqrt(d_in), biases 0."""
    dev = resolve_device(device)
    if generator.device.type != dev.type:
        raise ValueError(f"init_dlrm: generator on {generator.device}, model on {dev}")
    model = DLRM(cfg, dev)
    for table in model.tables:
        table.normal_(generator=generator).div_(cfg.embed_dim ** 0.5)
    for mlp, dims in ((model.bot, cfg.bot_dims()), (model.top, cfg.top_dims())):
        for part, values in mlp_init(generator, dims).items():
            for param, value in zip(mlp[part], values):
                param.copy_(value)
    return model


def abstract_dlrm_params(cfg: DLRMConfig) -> DLRM:
    """The model's parameters on the meta device: shapes and dtypes, no
    storage (the reference's ``jax.eval_shape`` of ``init_dlrm``)."""
    return DLRM(cfg, torch.device("meta"))


def _dot_interaction(z: torch.Tensor) -> torch.Tensor:
    """z: (B, F, D) -> upper-triangle pairwise dots (B, F*(F-1)/2)."""
    F_ = z.shape[1]
    zz = torch.bmm(z, z.transpose(1, 2))
    iu, ju = torch.triu_indices(F_, F_, 1, device=z.device)
    return zz[:, iu, ju]


def dlrm_forward(model: DLRM, dense: torch.Tensor, sparse: torch.Tensor,
                 cfg: DLRMConfig | None = None,
                 use_kernels: bool | str = "auto") -> torch.Tensor:
    """dense: (B, 13) float32; sparse: (B, 26) or (B, 26, L) int ->
    (B,) logits.  ``cfg`` (default ``model.cfg``) gives the table engine.
    Runs under ``torch.inference_mode``, or on DTensors under ``no_grad``
    (made outside inference mode, their views cannot enter it) and
    ``implicit_replication`` (the interaction's triangle indices are plain
    tensors, the same on every rank)."""
    if not hasattr(dense, "placements"):
        with torch.inference_mode():
            return _forward(model, dense, sparse, cfg, use_kernels)
    from repro_torch.dist.sharding import implicit_replication

    with torch.no_grad(), implicit_replication():
        return _forward(model, dense, sparse, cfg, use_kernels)


def _forward(model: DLRM, dense, sparse, cfg, use_kernels) -> torch.Tensor:
    cfg = model.cfg if cfg is None else cfg
    use = resolve_use_kernels(use_kernels, dense.device)
    if sparse.dim() == 2:
        sparse = sparse[..., None]
    fields = sparse.permute(1, 0, 2).contiguous()   # (26, B, L): one contiguous bag per field
    x0 = mlp_apply(model.bot, dense, act=F.relu, final_act=F.relu)
    embs = [embedding_bag(model.tables[i], fields[i], mode="sum", engine=cfg.table_engine,
                          use_kernels=use)
            for i in range(cfg.n_sparse)]
    z = torch.stack([x0] + embs, dim=1)   # (B, 27, D)
    del embs
    tri = _dot_interaction(z)
    top_in = torch.cat([x0, tri], dim=-1)
    return mlp_apply(model.top, top_in)[:, 0]


def dlrm_loss(model: DLRM, dense: torch.Tensor, sparse: torch.Tensor, labels: torch.Tensor,
              cfg: DLRMConfig | None = None, use_kernels: bool | str = "auto") -> torch.Tensor:
    """Mean binary cross-entropy of the logits, under grad mode."""
    logits = at_least_f32(_forward(model, dense, sparse, cfg, use_kernels))
    labels = labels.to(logits.dtype)
    return torch.mean(logits.clamp_min(0.0) - logits * labels
                      + torch.log1p(torch.exp(-logits.abs())))


@torch.inference_mode()
def retrieval_score(model: DLRM, dense_query: torch.Tensor, cand_embs: torch.Tensor,
                    top_k: int = 100):
    """``retrieval_cand`` cell: query tower -> one product against the (N, D)
    candidate embeddings -> (top-k scores, their candidate ids), each
    (B, top_k), scores descending."""
    q = mlp_apply(model.bot, dense_query, act=F.relu, final_act=F.relu)   # (B, D)
    scores = q @ cand_embs.T                                              # (B, N)
    if hasattr(scores, "placements"):
        # DTensor has no top-k over a split dim: the scores are gathered
        from torch.distributed.tensor import Replicate

        scores = scores.redistribute(scores.device_mesh, [Replicate()] * scores.device_mesh.ndim)
    return torch.topk(scores, top_k, dim=-1)
