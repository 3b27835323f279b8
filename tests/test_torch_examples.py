"""The examples' twins on the port (``examples/torch_*.py``) at a small
size on the CPU: the quickstart's SSSP bit-equal to the reference's
``run_hytm`` on the same graph and configuration and its Δ-PageRank within
the reference's own tolerance of the numpy PageRank; the LM and GNN
trainers reduce the loss through a fault; the serving demo generates
in-vocabulary tokens."""

import dataclasses
import importlib
import importlib.util
from pathlib import Path

import numpy as np

from repro.core import hytm as jh
from repro.core.constants import PCIE3 as JPCIE3
from repro.graph import algorithms as jalg
from repro.graph import generators as jgen
from repro_torch.graph.generators import rmat_graph
from repro_torch.graph.hub_sort import hub_sort

ROOT = Path(__file__).resolve().parents[1]


def _twin(name: str):
    path = ROOT / "examples" / f"torch_{name}.py"
    spec = importlib.util.spec_from_file_location(f"_twin_{name}", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def test_quickstart_twin_matches_the_reference():
    qs = _twin("quickstart")
    g = rmat_graph(3000, 48_000, seed=0)
    jg = jgen.rmat_graph(3000, 48_000, seed=0)
    np.testing.assert_array_equal(g.indptr, jg.indptr)
    np.testing.assert_array_equal(g.indices, jg.indices)
    hs = hub_sort(g)
    cfg = qs.quickstart_config()
    res, ok, _ = qs.run_sssp(g, hs, cfg, "cpu")
    assert ok
    jhs = importlib.import_module("repro.graph.hub_sort").hub_sort(jg)
    jcfg = jh.HyTMConfig(link=JPCIE3.with_(mr=4.0), n_partitions=64, cds_mode="hub")
    want = jh.run_hytm(jhs.graph, jalg.SSSP, source=int(jhs.perm[0]), config=jcfg,
                       n_hubs=jhs.n_hubs)
    np.testing.assert_array_equal(res.values, np.asarray(want.values))
    assert res.iterations == want.iterations
    assert res.total_transfer_bytes == want.total_transfer_bytes
    np.testing.assert_array_equal(res.history["engines"], np.asarray(want.history["engines"]))
    pr, err = qs.run_pagerank(g, hs, cfg, "cpu")
    # the reference quickstart's Δ-PageRank at tolerance 1e-5 against the
    # numpy PageRank: its own error on this graph bounds the port's
    prog = dataclasses.replace(jalg.PAGERANK, tolerance=1e-5)
    jpr = jh.run_hytm(jhs.graph, prog, source=None,
                      config=dataclasses.replace(jcfg, cds_mode="delta"), n_hubs=jhs.n_hubs)
    jerr = float(np.max(np.abs(jhs.values_to_old(np.asarray(jpr.values) + np.asarray(jpr.delta))
                               - jalg.reference_pagerank(jg))))
    assert err <= max(2 * jerr, 1e-4), (err, jerr)


def test_train_lm_twin_reduces_the_loss():
    tl = _twin("train_lm")
    cfg = tl.lm_config().replace(n_layers=2, d_model=64, n_heads=4, n_kv_heads=2, d_head=16,
                                 d_ff=128, vocab=512)
    cfg = cfg.replace(moe=cfg.moe.replace(d_ff=64))
    state, log, restarts = tl.train(cfg, 24, "cpu", ckpt_every=5, batch=4, seq_len=32)
    assert restarts == 1 and state.step == 24
    first = np.mean([m["loss"] for m in log[:4]])
    last = np.mean([m["loss"] for m in log[-4:]])
    assert last < first


def test_train_gnn_twin_reduces_the_loss():
    tg = _twin("train_gnn")
    state, log, restarts = tg.train(2000, 20_000, 24, "cpu", ckpt_every=5, batch_nodes=64)
    assert restarts == 1 and state.step == 24
    first = np.mean([m["loss"] for m in log[:4]])
    last = np.mean([m["loss"] for m in log[-4:]])
    assert last < first


def test_serve_lm_twin_generates(capsys):
    sl = _twin("serve_lm")
    cfg = sl.CFG.replace(n_layers=2, vocab=1000)
    out = sl.serve(cfg, 3, 16, 5, "cpu")
    assert out["tokens"].shape == (3, 5)
    assert bool(((out["tokens"] >= 0) & (out["tokens"] < cfg.vocab)).all())
    assert "sample continuation ids" in capsys.readouterr().out
