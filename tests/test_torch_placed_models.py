"""The GNN and DLRM steps on DTensor placements (the dry run's cells run
them): ``gnn_loss`` with the graph's rows and edges split over the batch
axes (``gnn_data_spec``) and the weights placed by ``gnn_rule``, and
``dlrm_loss``, ``dlrm_forward`` and ``retrieval_score`` with row-split
tables (``dlrm_rule``), on a (2, 2) mesh of four gloo ranks, against the
same functions on plain tensors in one process (which
``tests/test_torch_gnn.py`` and ``tests/test_torch_dlrm.py`` hold against
the reference).

The DTensor routes: ``gnn.gather_rows`` (the node rows gathered whole
before an index by split edges), ``gnn._placed_aggregate`` (each rank's
edges summed into every row as a ``Partial``; max and min over the
gathered messages), ``embedding.placed_bag`` (a row-split table under
``local_map``).  Tolerances: the loss within 1e-5 relative and every
gradient within 1e-5 of its leaf's largest |g| (float32 sums in another
order; PNA's 1e-4, its max and min's near-ties); the forwards within 1e-5
of their largest; retrieval's ids equal.
"""

import numpy as np
import pytest
import torch

from repro_torch.configs import get_arch
from repro_torch.configs.common import reduce_dlrm_config
from repro_torch.launch.mesh import PoolKeeper

LOSS_TOL = 1e-5
GRAD_TOL = 1e-5
# PNA's max and min send a destination's gradient to its largest or smallest
# message; messages within float32 rounding of each other (ReLU's zeros and
# near-ties) can change hands when the sums come in another order
# (``tests/gnn_gradient_spread.py``): 1e-4 of a leaf's largest, as
# ``tests/test_torch_gnn.py`` holds the models to the reference
PNA_GRAD_TOL = 1e-4
N_NODES, N_EDGES, N_GRAPHS = 300, 2000, 6
# name -> (arch, task): every aggregator, and the pooled graph task
GNN_CASES = {"graphsage": ("graphsage-reddit", None), "pna": ("pna", None),
             "gatedgcn_graph": ("gatedgcn", "graph"), "meshgraphnet": ("meshgraphnet", None)}


@pytest.fixture(scope="module")
def pools():
    with PoolKeeper(4, threads=1, timeout_s=60.0) as keeper:
        yield keeper


def _gnn_case(name):
    from repro_torch.graph.generators import rmat_graph

    arch, task = GNN_CASES[name]
    base = get_arch(arch).model_config
    cfg = base.replace(n_layers=min(base.n_layers, 2), d_hidden=24, d_in=12,
                       d_out=5 if base.task != "regression" else 3)
    if task is not None:
        cfg = cfg.replace(task=task)
    g = rmat_graph(N_NODES, N_EDGES, seed=7)
    src = torch.from_numpy(g.edge_sources().astype(np.int32))
    dst = torch.from_numpy(g.indices.astype(np.int32))
    m = src.shape[0] - src.shape[0] % 4    # an edge count the batch split divides
    rng = np.random.default_rng(3)
    batch = {"feats": torch.from_numpy(rng.standard_normal((N_NODES, cfg.d_in)).astype(np.float32)),
             "src": src[:m], "dst": dst[:m],
             "edge_feats": torch.from_numpy(rng.standard_normal((m, cfg.d_edge_in))
                                            .astype(np.float32))}
    if cfg.task == "graph":
        batch["graph_ids"] = torch.from_numpy(np.sort(rng.integers(0, N_GRAPHS, N_NODES))
                                              .astype(np.int32))
        batch["labels"] = torch.from_numpy(rng.integers(0, cfg.d_out, N_GRAPHS).astype(np.int32))
    elif cfg.task == "regression":
        batch["labels"] = torch.from_numpy(rng.standard_normal((N_NODES, cfg.d_out))
                                           .astype(np.float32))
    else:
        batch["labels"] = torch.from_numpy(rng.integers(0, cfg.d_out, N_NODES).astype(np.int32))
    return cfg, batch


def _gnn_loss(model, cfg, b):
    from repro_torch.models.gnn import gnn_loss

    kw = {"graph_ids": b["graph_ids"], "n_graphs": N_GRAPHS} if cfg.task == "graph" else {}
    return gnn_loss(model, cfg, b["feats"], b["src"], b["dst"], b["labels"],
                    edge_feats=b["edge_feats"], **kw)


def _grads(model) -> dict:
    """Whole gradients of the parameters that got one (GatedGCN's last
    edge norm feeds nothing)."""
    return {n: (p.grad.full_tensor() if hasattr(p.grad, "full_tensor") else p.grad)
            .detach().clone() for n, p in model.named_parameters() if p.grad is not None}


def _placed_gnn_rank(group, name):
    """One rank's loss and whole gradients of case ``name`` on (2, 2)."""
    import warnings

    warnings.filterwarnings("ignore")
    from repro_torch.dist.sharding import (distribute, gnn_data_spec, gnn_rule,
                                           implicit_replication, tree_shardings)
    from repro_torch.launch.mesh import device_mesh, make_debug_mesh
    from repro_torch.models.gnn import init_gnn

    mesh = make_debug_mesh(2, 2, device="cpu")
    dm = device_mesh(mesh)
    cfg, batch = _gnn_case(name)
    model = init_gnn(cfg, torch.Generator().manual_seed(1), "cpu")
    for p in model.parameters():
        p.requires_grad_(True)
    model = distribute(model, dm, tree_shardings(model, mesh, gnn_rule(mesh)))
    vec, mat = gnn_data_spec(mesh, "vector"), gnn_data_spec(mesh, "matrix")
    specs = {k: (mat if v.ndim == 2 else vec) for k, v in batch.items()}
    if cfg.task == "graph":
        specs["labels"] = vec
    placed = distribute(batch, dm, specs)
    with implicit_replication():
        loss = _gnn_loss(model, cfg, placed)
        loss.backward()
    return float(loss.full_tensor()), _grads(model)


def _close(got: dict, want: dict, tol: float):
    assert set(got) == set(want), set(got) ^ set(want)
    for n, w in want.items():
        bound = tol * max(float(w.abs().max()), 1e-30)
        err = float((got[n] - w).abs().max())
        assert err <= bound, (n, err, bound)


@pytest.mark.parametrize("name", sorted(GNN_CASES))
def test_gnn_loss_on_placements_matches_plain(pools, name):
    from repro_torch.models.gnn import init_gnn

    cfg, batch = _gnn_case(name)
    model = init_gnn(cfg, torch.Generator().manual_seed(1), "cpu")
    for p in model.parameters():
        p.requires_grad_(True)
    loss = _gnn_loss(model, cfg, batch)
    loss.backward()
    want = _grads(model)
    results = pools.get().run(_placed_gnn_rank, name)
    got_loss, got = results[0]
    for other in results[1:]:
        assert other[0] == got_loss
    assert abs(got_loss - float(loss)) <= LOSS_TOL * abs(float(loss)), (got_loss, float(loss))
    _close(got, want, PNA_GRAD_TOL if name == "pna" else GRAD_TOL)


def _dlrm_case():
    cfg = reduce_dlrm_config(get_arch("dlrm-mlperf").model_config)
    rng = np.random.default_rng(5)
    dense = torch.from_numpy(rng.standard_normal((16, cfg.n_dense)).astype(np.float32))
    sparse = torch.from_numpy(np.stack([rng.integers(0, v, 16) for v in cfg.vocab_sizes], 1)
                              .astype(np.int32))
    labels = torch.from_numpy((rng.random(16) < 0.3).astype(np.float32))
    cands = torch.from_numpy(rng.standard_normal((64, cfg.embed_dim)).astype(np.float32))
    return cfg, dense, sparse, labels, cands


def _dlrm_plain():
    from repro_torch.models.dlrm import dlrm_forward, dlrm_loss, init_dlrm, retrieval_score

    cfg, dense, sparse, labels, cands = _dlrm_case()
    model = init_dlrm(cfg, torch.Generator().manual_seed(2), "cpu")
    logits = dlrm_forward(model, dense, sparse, cfg, use_kernels=False)
    scores, ids = retrieval_score(model, dense[:1], cands, top_k=5)
    for p in model.parameters():
        p.requires_grad_(True)
    loss = dlrm_loss(model, dense, sparse, labels, cfg, use_kernels=False)
    loss.backward()
    return float(loss), _grads(model), logits, scores, ids


def _placed_dlrm_rank(group):
    import warnings

    warnings.filterwarnings("ignore")
    from repro_torch.dist.sharding import (P, batch_axes, distribute, dlrm_rule,
                                           implicit_replication, tree_shardings)
    from repro_torch.launch.mesh import device_mesh, make_debug_mesh
    from repro_torch.models.dlrm import dlrm_forward, dlrm_loss, init_dlrm, retrieval_score

    mesh = make_debug_mesh(2, 2, device="cpu")
    dm = device_mesh(mesh)
    ba = batch_axes(mesh)
    cfg, dense, sparse, labels, cands = _dlrm_case()
    model = init_dlrm(cfg, torch.Generator().manual_seed(2), "cpu")
    model = distribute(model, dm, tree_shardings(model, mesh, dlrm_rule(mesh)))
    d, s, y, c, q = distribute((dense, sparse, labels, cands, dense[:1]), dm,
                               (P(ba, None), P(ba, None), P(ba), P(ba, None), P()))
    logits = dlrm_forward(model, d, s, cfg, use_kernels=False).full_tensor()
    scores, ids = retrieval_score(model, q, c, top_k=5)
    for p in model.parameters():
        p.requires_grad_(True)
    with implicit_replication():
        loss = dlrm_loss(model, d, s, y, cfg, use_kernels=False)
        loss.backward()
    split = [str(p.placements) for p in model.tables.parameters()]
    return (float(loss.full_tensor()), _grads(model), logits, scores.full_tensor(),
            ids.full_tensor(), split)


def test_dlrm_on_placements_matches_plain(pools):
    """A row-split table and replicated ones (the rule's divisibility
    guard): the loss and every gradient, the logits, and retrieval's top
    scores and ids."""
    loss, want, logits, scores, ids = _dlrm_plain()
    results = pools.get().run(_placed_dlrm_rank)
    got_loss, got, got_logits, got_scores, got_ids, split = results[0]
    assert any("Shard(dim=0)" in p for p in split) and any("Shard" not in p for p in split)
    assert abs(got_loss - loss) <= LOSS_TOL * abs(loss), (got_loss, loss)
    _close(got, want, GRAD_TOL)
    _close({"logits": got_logits, "scores": got_scores}, {"logits": logits, "scores": scores},
           1e-5)
    assert torch.equal(got_ids, ids)
