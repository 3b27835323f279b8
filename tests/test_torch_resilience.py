"""The port's resilience plane (``repro_torch.resilience`` and its fault
sites in ``core.hytm``, ``stream`` and ``serve``) against the reference's
``repro.resilience`` on the same inputs.

Contract: one ``FaultPlan`` gives one fault schedule, one set of events and
one corrupted byte in both packages; ``guarded_dispatch`` gives the same
results, counters, exceptions and ``faults`` track events; checkpoints and
report logs written by either package restore in the other; a run killed
at a chunk boundary resumes to the uninterrupted run bit for bit (MIN
programs: values, iterations, transfer bytes and engine picks), in either
package, from either package's checkpoint; an empty plan is bit-identical
to ``faults=None``; serving replays under the chaos plans complete the
reference's requests with the reference's answers, sheds and stats.  The
reference runs ``use_kernels="auto"`` (off on the CPU); the port's
wrappers take their plain versions on CPU tensors.  Real exceptions out of
a dispatch are never retried or degraded.
"""

import dataclasses
import json
import zlib

import numpy as np
import pytest

from repro import obs as jobs
from repro import resilience as jr
from repro import serve as jserve
from repro import stream as jstream
from repro.autotune.feedback import OnlineCalibrator as JCalibrator
from repro.core import hytm as jh
from repro.graph import algorithms as jalg
from repro.graph import generators as jgen
from repro_torch import convert
from repro_torch import obs as tobs
from repro_torch import resilience as tr
from repro_torch import serve as tserve
from repro_torch import stream as tstream
from repro_torch.autotune.feedback import OnlineCalibrator as TCalibrator
from repro_torch.core.cost_model import KEY_PER_ENGINE_TIME, KEY_TRANSFER_TIME
from repro_torch.core import hytm as th
from repro_torch.graph import algorithms as talg

JCFG = jh.HyTMConfig(n_partitions=6, sync_every=2)
TIERS = {"gold": 2, "silver": 1, "bronze": 0}


def _tconfig(cfg: jh.HyTMConfig, **kw) -> th.HyTMConfig:
    fields = {f.name for f in dataclasses.fields(th.HyTMConfig)} - {"link", "ici_link"}
    vals = {k: getattr(cfg, k) for k in fields}
    vals.update(kw)
    return th.HyTMConfig(link=convert.link_model(dataclasses.asdict(cfg.link)), **vals)


TCFG = _tconfig(JCFG)


@pytest.fixture(scope="module")
def graphs():
    """The reference's ``rmat_graph(300, 2400, seed=7)``, the port's copy,
    and each package's uninterrupted K=2 SSSP run from vertex 0."""
    g = jgen.rmat_graph(300, 2400, seed=7)
    tg = convert.csr_graph(g.indptr, g.indices, g.weights)
    jbase = jh.run_hytm(g, jalg.SSSP, source=0, config=JCFG)
    tbase = th.run_hytm(tg, talg.SSSP, source=0, config=TCFG, device="cpu")
    return g, tg, jbase, tbase


def _same_min_run(a, b, cross=None):
    """Bit for bit: values, iterations, transfer bytes and every history
    row, but for the modeled seconds of two packages, whose float32 sums
    may round apart by an ulp (``rtol=1e-5``, as tests/test_torch_hytm.py);
    ``cross`` defaults to whether the results come from two packages."""
    np.testing.assert_array_equal(np.asarray(a.values), np.asarray(b.values))
    assert a.iterations == b.iterations
    assert a.total_transfer_bytes == b.total_transfer_bytes
    assert set(a.history) == set(b.history)
    if cross is None:
        cross = isinstance(a, jh.HyTMResult) != isinstance(b, jh.HyTMResult)
    for k in a.history:
        x, y = np.asarray(a.history[k]), np.asarray(b.history[k])
        if cross and k in (KEY_TRANSFER_TIME, KEY_PER_ENGINE_TIME):
            np.testing.assert_allclose(x, y, rtol=1e-5)
        else:
            np.testing.assert_array_equal(x, y)


def _pkgs():
    return ((jr, jh, jalg, JCFG, {}), (tr, th, talg, TCFG, {"device": "cpu"}))


# --------------------------------------------------------------------------
# fault plane
# --------------------------------------------------------------------------

PLANS = {
    "p": ([("chunk_dispatch", "fail", 0.5, (), None, None)], ["chunk_dispatch"] * 50, 3),
    "at_and_p": ([("s", "fail", 0.0, (1, 3), None, None),
                  ("s", "timeout", 0.3, (), 2, None)], ["s"] * 30, 0),
    "two_sites": ([("chunk_dispatch", "fail", 0.5, (), None, None),
                   ("lane_alloc", "oom", 0.5, (), None, None)],
                  ["lane_alloc", "chunk_dispatch"] * 25, 3),
    "gated": ([("chunk_dispatch", "fail", 1.0, (), 5, {"kernels": True})],
              ["chunk_dispatch"] * 12, 11),
    "serving": ([("lane_dispatch", "fail", 0.3, (), 6, None),
                 ("lane_dispatch", "timeout", 0.2, (), 4, None),
                 ("cache_promote", "oom", 0.5, (), 10, None)],
                ["lane_dispatch", "cache_promote", "lane_dispatch"] * 20, 7),
}


def _plan(pkg, specs, seed):
    return pkg.plan_of(*[pkg.FaultSpec(site, kind, p=p, at=at, max_fires=mf, when=when)
                         for site, kind, p, at, mf, when in specs], seed=seed)


@pytest.mark.parametrize("name", sorted(PLANS))
def test_fault_plan_schedule_matches_reference(name):
    specs, calls, seed = PLANS[name]
    jp, tp = _plan(jr, specs, seed), _plan(tr, specs, seed)
    for i, site in enumerate(calls):
        ctx = {"kernels": i % 3 != 0}
        assert jp.fire(site, **ctx) == tp.fire(site, **ctx)
    assert [dataclasses.astuple(e) for e in jp.events] == \
        [dataclasses.astuple(e) for e in tp.events]
    assert jp.counts() == tp.counts() and jp.injected == tp.injected > 0
    # check() raises the same error, with the same message, at the same call
    jp, tp = _plan(jr, specs, seed), _plan(tr, specs, seed)
    for site in calls:
        outcome = []
        for p in (jp, tp):
            try:
                p.check(site, kernels=True)
                outcome.append(None)
            except RuntimeError as e:
                outcome.append((type(e).__name__, str(e), e.site, e.occurrence))
        assert outcome[0] == outcome[1]
    assert tp.replace(seed=seed).injected == 0


@pytest.mark.parametrize("dtype", [np.float32, np.int64, np.bool_])
def test_corrupt_flips_the_reference_byte(dtype):
    arr = (np.random.default_rng(0).random(37) * 100).astype(dtype)
    jp, tp = jr.FaultPlan(seed=5), tr.FaultPlan(seed=5)
    for _ in range(4):
        a, b = jp.corrupt(arr), tp.corrupt(arr)
        assert a.dtype == b.dtype == arr.dtype
        assert a.tobytes() == b.tobytes() != arr.tobytes()


# --------------------------------------------------------------------------
# guarded_dispatch: retry / backoff / deadline (fake clock)
# --------------------------------------------------------------------------

DISPATCH_CASES = {
    "retry_then_succeed": ([("site", "fail", 0.0, (0, 1), None, None)],
                           dict(max_attempts=4, backoff_s=0.5, factor=2.0)),
    "exhaust": ([("site", "fail", 1.0, (), None, None)], dict(max_attempts=3)),
    "deadline": ([("site", "timeout", 1.0, (), None, None)],
                 dict(max_attempts=10, deadline_s=1.0, timeout_charge_s=0.4)),
    "backoff_capped": ([("site", "fail", 0.0, (0, 1, 2, 3), None, None)],
                       dict(max_attempts=6, backoff_s=0.75, factor=3.0, max_backoff_s=2.0)),
    "no_policy": ([("site", "fail", 0.0, (0,), None, None)], None),
    "oom_at_dispatch": ([("site", "oom", 0.0, (0,), None, None)], dict(max_attempts=4)),
    "empty": ([], dict(max_attempts=2)),
}


def _dispatch(pkg, obs_pkg, specs, policy_kw):
    plan = _plan(pkg, specs, 2)
    policy = pkg.RetryPolicy(**policy_kw) if policy_kw is not None else None
    rec = obs_pkg.TraceRecorder()
    slept, calls, stats = [], [], {}
    try:
        out = pkg.guarded_dispatch(lambda: calls.append(1) or 42, site="site", faults=plan,
                                   policy=policy, obs=rec, stats=stats, sleep=slept.append,
                                   clock=lambda: 0.0)
    except RuntimeError as e:
        out = (type(e).__name__, str(e), getattr(e, "attempts", None),
               getattr(e, "reason", None), type(getattr(e, "last", None)).__name__)
    events = [(e.name, e.cat, e.track, e.args) for e in rec.events]
    counters = {k: v for k, v in rec.metrics.snapshot().items() if k.startswith("faults.")}
    return out, len(calls), slept, stats, events, counters


@pytest.mark.parametrize("case", sorted(DISPATCH_CASES))
def test_guarded_dispatch_matches_reference(case):
    specs, policy_kw = DISPATCH_CASES[case]
    want = _dispatch(jr, jobs, specs, policy_kw)
    got = _dispatch(tr, tobs, specs, policy_kw)
    assert got == want
    if case == "retry_then_succeed":
        assert got[0] == 42 and got[1] == 1 and got[2] == [0.5, 1.0]
    if case == "deadline":
        assert got[0][3] == "deadline" and got[0][2] == 3
    if case == "exhaust":
        assert got[0][0] == "RetriesExhausted" and got[0][4] == "DispatchFault"


def test_guarded_dispatch_without_faults_is_the_call():
    calls = []
    assert tr.guarded_dispatch(lambda: calls.append(1) or 7, site="x", faults=None,
                               policy=tr.RetryPolicy(max_attempts=1)) == 7
    assert calls == [1]


def test_real_dispatch_error_propagates(graphs, monkeypatch, tmp_path):
    """A real exception out of the dispatch is neither retried nor degraded:
    it leaves guarded_dispatch after one call, and run_supervised with a
    kernels rung and a checkpoint, untouched."""
    _, tg, _, _ = graphs
    plan = tr.plan_of(tr.FaultSpec("site", "fail", at=(0,)), seed=0)
    calls, stats = [], {}

    def boom():
        calls.append(1)
        raise RuntimeError("kernel launch failed")

    with pytest.raises(RuntimeError, match="kernel launch failed"):
        tr.guarded_dispatch(boom, site="site", faults=plan,
                            policy=tr.RetryPolicy(max_attempts=5), stats=stats)
    assert calls == [1] and stats == {"faults": 1, "retries": 1}

    real_chunk = th.hytm_chunk
    n_calls = [0]

    def failing_chunk(*a, **kw):
        n_calls[0] += 1
        if n_calls[0] == 2:
            raise RuntimeError("CUDA error: an illegal memory access was encountered")
        return real_chunk(*a, **kw)

    monkeypatch.setattr(th, "hytm_chunk", failing_chunk)
    sup = tr.Supervisor(policy=tr.RetryPolicy(max_attempts=3), faults=tr.FaultPlan(seed=0))
    with pytest.raises(RuntimeError, match="illegal memory access"):
        tr.run_supervised(tg, talg.SSSP, 0, dataclasses.replace(TCFG, use_kernels=True),
                          supervisor=sup, ckpt_path=tmp_path / "run.npz", device="cpu")
    assert sup.degradations == [] and sup.counters == {
        "faults": 0, "retries": 0, "degradations": 0, "shed": 0}
    assert n_calls[0] == 2


# --------------------------------------------------------------------------
# checkpoints: round trip, cross-load, integrity
# --------------------------------------------------------------------------

def _calibrators():
    rng = np.random.default_rng(4)
    j, t = JCalibrator(decay=0.3), TCalibrator(decay=0.3)
    for _ in range(5):
        modeled, measured = rng.random(3), float(rng.random())
        j.update(modeled, measured)
        t.update(modeled, measured)
    return j, t


def _checkpoint(pkg, base, calib_state):
    return pkg.RunCheckpoint(
        program="sssp", iterations=int(base.iterations), graph_version=3, layout_version=1,
        values=np.asarray(base.values), delta=np.asarray(base.delta),
        frontier=np.arange(base.values.shape[0]) % 3 == 0,
        history={k: np.asarray(v) for k, v in base.history.items()},
        calibrator=calib_state)


def _same_checkpoint(a, b, cross=False):
    """Equal fields; ``cross``: two packages' runs, whose modeled seconds
    may round apart by an ulp."""
    for name in ("program", "iterations", "anchor", "calibrator", "state_layout", "n_nodes"):
        assert getattr(a, name) == getattr(b, name), name
    for name in ("values", "delta", "frontier"):
        x, y = getattr(a, name), getattr(b, name)
        assert (x is None) == (y is None)
        if x is not None:
            assert x.dtype == y.dtype
            np.testing.assert_array_equal(x, y)
    assert set(a.history) == set(b.history)
    for k in a.history:
        if cross and k in (KEY_TRANSFER_TIME, KEY_PER_ENGINE_TIME):
            np.testing.assert_allclose(a.history[k], b.history[k], rtol=1e-5)
        else:
            np.testing.assert_array_equal(a.history[k], b.history[k])


@pytest.mark.parametrize("writer", ["reference", "port"])
def test_checkpoint_cross_loads(graphs, tmp_path, writer):
    """A checkpoint written by either package restores in both to the same
    fields; the calibrator state is the reference's and rebuilds a
    calibrator of the same correction; the files hold the same entries."""
    _, _, jbase, _ = graphs
    jcal, tcal = _calibrators()
    assert tr.calibrator_state(tcal) == jr.calibrator_state(jcal)
    wpkg = jr if writer == "reference" else tr
    ckpt = _checkpoint(wpkg, jbase, wpkg.calibrator_state(jcal if wpkg is jr else tcal))
    path = tmp_path / "run.ckpt.npz"
    assert wpkg.save(ckpt, path) == path and not (tmp_path / "run.ckpt.npz.tmp").exists()
    a = jr.restore(path, expect_anchor=(3, 1), program="sssp")
    b = tr.restore(path, expect_anchor=(3, 1), program="sssp")
    _same_checkpoint(a, b)
    _same_checkpoint(b, ckpt)
    np.testing.assert_array_equal(jr.restore_calibrator(a.calibrator).correction(),
                                  tr.restore_calibrator(b.calibrator).correction())
    np.testing.assert_array_equal(tr.restore_calibrator(b.calibrator).correction(),
                                  tcal.correction())
    other = tmp_path / "other.npz"
    (jr if wpkg is tr else tr).save(_checkpoint(jr if wpkg is tr else tr, jbase,
                                                ckpt.calibrator), other)
    with np.load(path) as x, np.load(other) as y:
        assert sorted(x.files) == sorted(y.files)
        for k in x.files:
            np.testing.assert_array_equal(x[k], y[k])


def _outcome(pkg, path, **kw):
    try:
        c = pkg.restore(path, **kw)
    except pkg.CheckpointError:
        return "error"
    return ("ok", c.program, c.iterations, c.values.tobytes(),
            None if c.delta is None else c.delta.tobytes())


def test_checkpoint_rejects_corruption_and_mismatch(graphs, tmp_path):
    """Anchor and program mismatches, a bit flip, a missing file, an array
    changed under an intact zip, and an unknown schema raise
    CheckpointError; a flip of any one byte of a file ends as the
    reference's restore ends (typed error, or the same arrays)."""
    _, _, jbase, _ = graphs
    path = tmp_path / "run.ckpt.npz"
    tr.save(tr.RunCheckpoint(program="sssp", iterations=4,
                             values=np.asarray(jbase.values)), path)
    for expect, prog in (((1, 0), None), (None, "bfs")):
        with pytest.raises(tr.CheckpointError):
            tr.restore(path, expect_anchor=expect, program=prog)
    with pytest.raises(tr.CheckpointError, match="missing"):
        tr.restore(tmp_path / "absent.npz")
    blob = path.read_bytes()
    flipped = tmp_path / "flip.npz"
    for pos in range(len(blob)):
        damaged = bytearray(blob)
        damaged[pos] ^= 0xFF
        flipped.write_bytes(bytes(damaged))
        assert _outcome(tr, flipped) == _outcome(jr, flipped), pos
    damaged = bytearray(blob)
    damaged[len(blob) // 2] ^= 0xFF
    flipped.write_bytes(bytes(damaged))
    with pytest.raises(tr.CheckpointError):
        tr.restore(flipped)
    # a valid zip whose array no longer matches the crc table
    with np.load(path) as z:
        arrays = {k: z[k] for k in z.files}
    arrays["values"] = arrays["values"].copy()
    arrays["values"][0] += 1.0
    np.savez(tmp_path / "crc.npz", **arrays)
    with pytest.raises(tr.CheckpointError, match="checksum"):
        tr.restore(tmp_path / "crc.npz")
    meta = json.loads(arrays["__meta__"].tobytes().decode())
    for bad in ({**meta, "schema": 99}, None):
        arrays2 = dict(arrays, values=np.asarray(jbase.values))
        if bad is None:
            del arrays2["__meta__"]
        else:
            arrays2["__meta__"] = np.frombuffer(json.dumps(bad).encode(), np.uint8)
        np.savez(tmp_path / "meta.npz", **arrays2)
        with pytest.raises(tr.CheckpointError):
            tr.restore(tmp_path / "meta.npz")


def test_checkpoint_schema_v1_still_restores(tmp_path):
    vals = np.arange(5, dtype=np.float32)
    meta = {"schema": 1, "program": "sssp", "iterations": 2, "graph_version": 0,
            "layout_version": 0, "calibrator": None,
            "crc": {"values": zlib.crc32(vals.tobytes())}}
    path = tmp_path / "v1.ckpt.npz"
    np.savez(path, values=vals, __meta__=np.frombuffer(json.dumps(meta).encode(), np.uint8))
    back = tr.restore(path, expect_anchor=(0, 0), program="sssp")
    assert back.state_layout == "replicated" and back.n_nodes == 0
    np.testing.assert_array_equal(back.values, vals)
    _same_checkpoint(back, jr.restore(path, expect_anchor=(0, 0), program="sssp"))


def test_report_logs_cross_load(graphs, tmp_path):
    """A DeltaCSR report log saved by either package loads in both to equal
    reports; a bit flip and an anchor mismatch raise CheckpointError."""
    g, tg, _, _ = graphs
    jd, td = jstream.DeltaCSR(g, JCFG), tstream.DeltaCSR(tg, TCFG, device="cpu")
    jreps, treps = [], []
    for seed in (1, 2):
        b = jstream.random_batch(jd, np.random.default_rng(seed), n_insert=6, n_delete=4,
                                 n_reweight=2)
        jreps.append(jd.apply(b))
        treps.append(td.apply(tstream.EdgeBatch(b.op, b.src, b.dst, b.weight)))
    for name, (pkg, reps) in {"ref": (jr, jreps), "port": (tr, treps)}.items():
        path = tmp_path / f"{name}.reports.npz"
        pkg.save_reports(reps, path, graph_version=2, layout_version=0)
        (ja, janchor), (ta, tanchor) = jr.load_reports(path), tr.load_reports(path, (2, 0))
        assert janchor == tanchor == (2, 0) and len(ja) == len(ta) == 2
        for a, b in zip(ja, ta):
            assert isinstance(b, tstream.UpdateReport)
            for f in ("version", "merged"):
                assert getattr(a, f) == getattr(b, f)
            for f in ("dirty_partitions", "ins_src", "ins_dst", "ins_w", "del_src",
                      "del_dst", "del_w"):
                np.testing.assert_array_equal(getattr(a, f), getattr(b, f))
            for side in ("pre_adj", "post_adj"):
                x, y = getattr(a, side), getattr(b, side)
                assert list(x) == list(y)
                for u in x:
                    for p, q in zip(x[u], y[u]):
                        np.testing.assert_array_equal(p, q)
        with pytest.raises(tr.CheckpointError, match="anchored"):
            tr.load_reports(path, expect_anchor=(3, 0))
        blob = bytearray(path.read_bytes())
        blob[len(blob) // 2] ^= 0xFF
        path.write_bytes(bytes(blob))
        with pytest.raises(tr.CheckpointError):
            tr.load_reports(path)
    with pytest.raises(tr.CheckpointError, match="missing"):
        tr.load_reports(tmp_path / "absent.npz")


@pytest.mark.parametrize("prog", ["sssp", "pagerank", "kcore"])
def test_migrate_state_layout_matches_reference(prog):
    n = 10
    rng = np.random.default_rng(0)
    arrays = dict(values=rng.random(n).astype(np.float32),
                  delta=rng.random(n).astype(np.float32), frontier=rng.random(n) > 0.5)
    jck = jr.RunCheckpoint(program=prog, iterations=3, n_nodes=n, **arrays)
    tck = tr.RunCheckpoint(program=prog, iterations=3, n_nodes=n, **arrays)
    for devices in (1, 3, 4):
        a = jr.migrate_state_layout(jck, "owner", n_devices=devices)
        b = tr.migrate_state_layout(tck, "owner", n_devices=devices)
        _same_checkpoint(a, b)
        assert b.state_layout == "owner" and b.values.shape == (-(-n // devices) * devices,)
        back = tr.migrate_state_layout(b, "replicated")
        _same_checkpoint(back, tck)
    explicit = tr.migrate_state_layout(tck, "owner", n_devices=4,
                                       program=talg.ALGORITHMS[prog])
    _same_checkpoint(explicit, jr.migrate_state_layout(jck, "owner", n_devices=4))
    assert tr.migrate_state_layout(tck, "replicated") is tck
    with pytest.raises(ValueError):
        tr.migrate_state_layout(tck, "sharded")
    with pytest.raises(tr.CheckpointError):
        tr.migrate_state_layout(dataclasses.replace(b, n_nodes=0), "replicated")
    with pytest.raises(tr.CheckpointError):
        tr.migrate_state_layout(dataclasses.replace(tck, program="nope"), "owner",
                                n_devices=2)
    with pytest.raises(tr.CheckpointError):
        tr.migrate_state_layout(tr.RunCheckpoint(program=prog, iterations=0), "owner")


# --------------------------------------------------------------------------
# kill at a chunk boundary and resume
# --------------------------------------------------------------------------

def _kill(pkg, hy, alg, cfg, dev, g, path, k):
    hook = pkg.CheckpointHook(path, program="sssp", anchor=(0, 0))
    plan = pkg.plan_of(pkg.FaultSpec("chunk_dispatch", "fail", at=(k,)), seed=k)
    with pytest.raises(pkg.RetriesExhausted):
        hy.run_hytm(g, alg.SSSP, source=0, config=cfg, faults=plan, on_chunk=hook, **dev)
    assert hook.saved == hook.n_chunks == k
    return hook


@pytest.mark.parametrize("k", [1, 2, 3])
def test_kill_resume_matches_reference(graphs, tmp_path, k):
    """Killed at chunk k and resumed: bit-identical to the uninterrupted run
    in the port and in the reference, and each package's checkpoint
    resumes in the other to the reference's final answer."""
    g, tg, jbase, tbase = graphs
    _same_min_run(jbase, tbase)
    tpath, jpath = tmp_path / "port.npz", tmp_path / "ref.npz"
    _kill(tr, th, talg, TCFG, {"device": "cpu"}, tg, tpath, k)
    _kill(jr, jh, jalg, JCFG, {}, g, jpath, k)
    _same_checkpoint(tr.restore(tpath), jr.restore(jpath), cross=True)
    got = tr.resume_run(tpath, tg, talg.SSSP, config=TCFG, source=0, expect_anchor=(0, 0),
                        device="cpu")
    _same_min_run(got, tbase)
    _same_min_run(tr.resume_run(jpath, tg, talg.SSSP, config=TCFG, source=0, device="cpu"),
                  jbase)
    _same_min_run(jr.resume_run(tpath, g, jalg.SSSP, config=JCFG, source=0), jbase,
                  cross=True)
    # a hooked resume continues the iteration count of the checkpoint
    hook = tr.CheckpointHook(tmp_path / "again.npz", program="sssp")
    tr.resume_run(tpath, tg, talg.SSSP, config=TCFG, checkpoint=hook, device="cpu")
    assert tr.restore(tmp_path / "again.npz").iterations == tbase.iterations


def test_resume_rejects_bad_requests(graphs, tmp_path):
    _, tg, _, tbase = graphs
    path = tmp_path / "run.npz"
    _kill(tr, th, talg, TCFG, {"device": "cpu"}, tg, path, 2)
    with pytest.raises(ValueError, match="sync_every"):
        tr.resume_run(path, tg, talg.SSSP, config=dataclasses.replace(TCFG, sync_every=1),
                      device="cpu")
    with pytest.raises(tr.CheckpointError, match="max_iters"):
        tr.resume_run(path, tg, talg.SSSP, config=dataclasses.replace(TCFG, max_iters=4),
                      device="cpu")
    with pytest.raises(tr.CheckpointError, match="migrate_state_layout"):
        tr.resume_run(path, tg, talg.SSSP,
                      config=dataclasses.replace(TCFG, vertex_sharding="owner"), device="cpu")
    with pytest.raises(tr.CheckpointError, match="program"):
        tr.resume_run(path, tg, talg.BFS, config=TCFG, device="cpu")
    with pytest.raises(tr.CheckpointError, match="anchored"):
        tr.resume_run(path, tg, talg.SSSP, config=TCFG, expect_anchor=(1, 0), device="cpu")


def test_on_chunk_requires_chunked_driver(graphs):
    _, tg, _, _ = graphs
    with pytest.raises(ValueError, match="sync_every"):
        th.run_hytm(tg, talg.SSSP, config=dataclasses.replace(TCFG, sync_every=1),
                    on_chunk=lambda **kw: None, device="cpu")


def test_on_chunk_sees_each_boundary(graphs):
    """``on_chunk`` runs once a chunk, after the drain, with the live state
    and the rows so far, as the reference's."""
    g, tg, _, tbase = graphs
    seen = {"ref": [], "port": []}

    def hook(name):
        def call(*, state, iterations, rows, calibrator, last_active):
            seen[name].append((iterations, last_active, sum(len(v) for v in rows["engines"]),
                               np.asarray(state.values).copy()))
        return call

    jh.run_hytm(g, jalg.SSSP, config=JCFG, on_chunk=hook("ref"))
    th.run_hytm(tg, talg.SSSP, config=TCFG, on_chunk=hook("port"), device="cpu")
    assert len(seen["port"]) == -(-tbase.iterations // 2)
    for a, b in zip(seen["ref"], seen["port"], strict=True):
        assert a[:3] == b[:3]
        np.testing.assert_array_equal(a[3], b[3])


@pytest.mark.parametrize("K", [2, 1])
def test_empty_plan_bit_identical(graphs, K):
    """An empty plan takes every guarded branch and changes nothing; the K=1
    driver's faults fire at its iterations."""
    _, tg, _, _ = graphs
    cfg = dataclasses.replace(TCFG, sync_every=K)
    plain = th.run_hytm(tg, talg.SSSP, source=0, config=cfg, device="cpu")
    empty = th.run_hytm(tg, talg.SSSP, source=0, config=cfg, faults=tr.FaultPlan(seed=1),
                        retry=tr.RetryPolicy(), device="cpu")
    _same_min_run(plain, empty)
    plan = tr.plan_of(tr.FaultSpec("chunk_dispatch", "fail", at=(1, 2)), seed=0)
    retried = th.run_hytm(tg, talg.SSSP, source=0, config=cfg, faults=plan,
                          retry=tr.RetryPolicy(max_attempts=3), device="cpu")
    _same_min_run(plain, retried)
    assert plan.counts() == {("chunk_dispatch", "fail"): 2}
    pr = dataclasses.replace(talg.PAGERANK, tolerance=1e-6)
    a = th.run_hytm(tg, pr, None, cfg, device="cpu")
    b = th.run_hytm(tg, pr, None, cfg, faults=tr.FaultPlan(), device="cpu")
    np.testing.assert_array_equal(a.values, b.values)


def test_incremental_passes_faults_on(graphs):
    g, tg, _, _ = graphs
    td = tstream.DeltaCSR(tg, TCFG, device="cpu")
    base = th.run_hytm(None, talg.SSSP, 0, TCFG, runtime=td.runtime_for(talg.SSSP))
    b = tstream.random_batch(td, np.random.default_rng(2), n_insert=5, n_delete=5)
    rep = td.apply(b)
    want = tstream.run_incremental(td, talg.SSSP, [rep], base.values, base.delta, 0)
    plan = tr.plan_of(tr.FaultSpec("chunk_dispatch", "fail", at=(0,)), seed=0)
    with pytest.raises(tr.RetriesExhausted):
        tstream.run_incremental(td, talg.SSSP, [rep], base.values, base.delta, 0, faults=plan)
    got = tstream.run_incremental(td, talg.SSSP, [rep], base.values, base.delta, 0,
                                  faults=plan.replace(), retry=tr.RetryPolicy(max_attempts=2))
    _same_min_run(want, got)


# --------------------------------------------------------------------------
# supervision: the degradation ladder
# --------------------------------------------------------------------------

def test_supervisor_kernels_rung_degrades_once(graphs, tmp_path):
    """``use_kernels=True`` on the CPU (the wrappers' plain versions) under
    a plan that fails every kernels dispatch: one ``kernels->oracle``
    degrade, and the answer is the reference's ``use_kernels=False`` run."""
    _, tg, jbase, tbase = graphs
    plan = tr.plan_of(tr.FaultSpec("chunk_dispatch", "fail", p=1.0, max_fires=64,
                                   when={"kernels": True}), seed=11)
    rec = tobs.TraceRecorder()
    sup = tr.Supervisor(policy=tr.RetryPolicy(max_attempts=2), faults=plan, obs=rec)
    res = tr.run_supervised(tg, talg.SSSP, 0, dataclasses.replace(TCFG, use_kernels=True),
                            supervisor=sup, device="cpu")
    _same_min_run(res, tbase)
    _same_min_run(res, jbase)
    assert [r for r, _ in sup.degradations] == ["kernels->oracle"]
    assert 0 < sum(plan.counts().values()) < 64
    assert [e.name for e in rec.events if e.track == "faults"].count("degrade") == 1
    # checkpointed: killed after two chunks, resumed one rung down
    plan = tr.plan_of(tr.FaultSpec("chunk_dispatch", "fail", at=(2, 3),
                                   when={"kernels": True}), seed=0)
    sup = tr.Supervisor(policy=tr.RetryPolicy(max_attempts=2), faults=plan)
    res = tr.run_supervised(tg, talg.SSSP, 0, dataclasses.replace(TCFG, use_kernels=True),
                            supervisor=sup, ckpt_path=tmp_path / "sup.npz", device="cpu")
    _same_min_run(res, jbase)
    assert [r for r, _ in sup.degradations] == ["kernels->oracle"]
    assert tr.restore(tmp_path / "sup.npz").iterations == jbase.iterations


@pytest.mark.parametrize("use_kernels", ["auto", False])
def test_ladder_exhausted_on_cpu_without_kernels(graphs, use_kernels):
    """``"auto"`` on the CPU resolves to no kernels, as the reference's on a
    CPU backend: there is no rung to take, so exhaustion raises in both."""
    g, tg, _, _ = graphs
    raised = []
    for pkg, hy, alg, cfg, dev in _pkgs():
        grp = g if pkg is jr else tg
        sup = pkg.Supervisor(policy=pkg.RetryPolicy(max_attempts=2), faults=pkg.plan_of(
            pkg.FaultSpec("chunk_dispatch", "fail", p=1.0), seed=1))
        with pytest.raises(pkg.RetriesExhausted) as e:
            pkg.run_supervised(grp, alg.SSSP, 0, dataclasses.replace(cfg, use_kernels=use_kernels),
                               supervisor=sup, **dev)
        raised.append((str(e.value), sup.counters, sup.degradations))
    assert raised[0] == raised[1]
    assert tr.next_rung(dataclasses.replace(TCFG, use_kernels="auto"), "cpu") is None
    assert tr.next_rung(dataclasses.replace(TCFG, use_kernels="auto"), "cuda")[0] == \
        "kernels->oracle"
    label, cfg = tr.next_rung(dataclasses.replace(TCFG, mesh_axis="graph", use_kernels=False),
                              "cpu")
    assert label == "mesh->single-device" and cfg.mesh_axis is None and not cfg.async_sweep


# --------------------------------------------------------------------------
# serving: warm cache, delivery, shedding, chaos replays
# --------------------------------------------------------------------------

def _services(graphs, **kw):
    g, tg, _, _ = graphs
    return (jstream.GraphService(g, JCFG, **kw),
            tstream.GraphService(tg, TCFG, device="cpu", **kw))


def test_warm_cache_bit_flip_detected(graphs):
    jsvc, tsvc = _services(graphs, max_lanes=2, device_budget_bytes=2 * 9 * 300)
    for svc in (jsvc, tsvc):
        svc.query(svc is jsvc and jalg.SSSP or talg.SSSP, [0, 3, 77, 210])
    assert tsvc.cache.stats.as_dict() == jsvc.cache.stats.as_dict()
    spilled = [k for k, e in tsvc.cache.items() if e.tier == tserve.warm_cache.HOST]
    assert spilled, "budget did not force a spill"
    src = spilled[0][1]
    for svc, prog in ((jsvc, jalg.SSSP), (tsvc, talg.SSSP)):
        entry = svc.cache.peek((prog, src))
        entry.values = entry.values.copy()
        entry.values.reshape(-1).view(np.uint8)[5] ^= 0x80
    a = jsvc.query(jalg.SSSP, [src])[0]
    b = tsvc.query(talg.SSSP, [src])[0]
    np.testing.assert_array_equal(np.asarray(a.values), b.values)
    assert (a.mode, a.iterations) == (b.mode, b.iterations)
    assert tsvc.cache.stats.as_dict() == jsvc.cache.stats.as_dict()
    assert tsvc.cache.stats.corrupt == 1
    solo = th.run_hytm(graphs[1], talg.SSSP, source=src, config=TCFG, device="cpu")
    np.testing.assert_array_equal(b.values, solo.values)


def test_injected_spill_corruption_and_promote_oom(graphs, trace_batch):
    """``host_spill`` corrupt and ``cache_promote`` oom: the same cache
    stats, fault counts and answers as the reference; nothing corrupt is
    served."""
    specs = [("host_spill", "corrupt", 0.0, (0,), None, None),
             ("cache_promote", "oom", 0.0, (0,), None, None)]
    out = []
    for pkg, prog, batch in ((jr, jalg.SSSP, trace_batch[0]), (tr, talg.SSSP, trace_batch[1])):
        plan = _plan(pkg, specs, 9)
        kw = dict(max_lanes=2, device_budget_bytes=2 * 9 * 300, faults=plan)
        svc = (jstream.GraphService(graphs[0], JCFG, **kw) if pkg is jr
               else tstream.GraphService(graphs[1], TCFG, device="cpu", **kw))
        svc.query(prog, [0, 3, 77, 210])
        svc.update(batch)
        res = svc.query(prog, [0, 3, 77, 210])
        out.append(([(r.mode, r.iterations, np.asarray(r.values).tobytes()) for r in res],
                    svc.cache.stats.as_dict(), plan.counts(),
                    svc.query(prog, [0])[0].values.tobytes()))
    assert out[0] == out[1]
    assert out[1][2] == {("host_spill", "corrupt"): 1, ("cache_promote", "oom"): 1}
    assert out[1][1]["corrupt"] == out[1][1]["promote_failures"] == 1


def test_deliver_update_drop_and_duplicate(graphs):
    jsvc, tsvc = _services(graphs, max_lanes=2)
    b = jstream.random_batch(jsvc.dcsr, np.random.default_rng(1), n_insert=6, n_delete=6)
    tb = tstream.EdgeBatch(b.op, b.src, b.dst, b.weight)
    results = []
    for pkg, svc, batch in ((jr, jsvc, b), (tr, tsvc, tb)):
        plan = pkg.plan_of(pkg.FaultSpec("update_delivery", "drop", at=(0,)),
                           pkg.FaultSpec("update_redeliver", "duplicate", at=(0,)), seed=2)
        rec = (jobs if pkg is jr else tobs).TraceRecorder()
        rep = pkg.deliver_update(svc, batch, batch_id="b0", faults=plan,
                                 policy=pkg.RetryPolicy(max_attempts=3), obs=rec)
        assert svc.dcsr.version == rep.version == 1
        assert svc.update(batch, batch_id="b0").version == 1 and svc.dcsr.version == 1
        plan2 = pkg.plan_of(pkg.FaultSpec("update_delivery", "drop", p=1.0), seed=3)
        with pytest.raises(pkg.RetriesExhausted) as e:
            pkg.deliver_update(svc, batch, batch_id="b1", faults=plan2,
                               policy=pkg.RetryPolicy(max_attempts=2), obs=rec)
        assert e.value.site == "update_delivery" and svc.dcsr.version == 1
        results.append((plan.counts(), [(e.name, e.args) for e in rec.events],
                        rep.version, rep.ins_src.tolist(), rep.del_src.tolist(),
                        sorted(rep.post_adj), svc.stats.n_updates))
    assert results[0] == results[1]
    # DeltaCSR.apply drops before validation: an invalid batch dropped is
    # not rejected, and nothing changes
    td = tsvc.dcsr
    bad = tstream.EdgeBatch(np.array([tstream.OP_INSERT]), np.array([0]),
                            np.array([10**6]), np.array([1.0], np.float32))
    with pytest.raises(tr.UpdateLost):
        td.apply(bad, faults=tr.plan_of(tr.FaultSpec("update_delivery", "drop", at=(0,))))
    assert td.version == 1


def _pump_shed(pkg, svc, prog, req_pkg):
    q = req_pkg.RequestQueue(quota=1)
    for i, s in enumerate([0, 3, 77, 210, 9, 15]):
        q.submit(req_pkg.Request(tenant=["gold", "bronze"][i % 2], program=prog, source=s,
                                 deadline=float(i)))
    served = svc.scheduler.pump(q)
    return served, q


def test_lane_alloc_oom_sheds_lowest_tier_only(graphs):
    rows = []
    for pkg, prog, req_pkg in ((jr, jalg.SSSP, jserve), (tr, talg.SSSP, tserve)):
        plan = pkg.plan_of(pkg.FaultSpec("lane_alloc", "oom", p=1.0, max_fires=100), seed=4)
        sup = pkg.Supervisor(policy=pkg.RetryPolicy(max_attempts=2), faults=plan,
                             tenant_tiers={"gold": 2, "bronze": 0}, shed_after=2)
        kw = dict(max_lanes=4, faults=plan, supervisor=sup)
        svc = (jstream.GraphService(graphs[0], JCFG, **kw) if pkg is jr
               else tstream.GraphService(graphs[1], TCFG, device="cpu", **kw))
        served, q = _pump_shed(pkg, svc, prog, req_pkg)
        assert len(served) == 6 and q.stats.quota_violations == 0
        shed = [r for r in served if r.mode == "shed"]
        assert shed and all(r.request.tenant == "bronze" for r in shed)
        assert sup.counters["shed"] == len(shed) == q.stats.shed
        rows.append(([(r.request.tenant, r.request.source, r.mode, r.iterations,
                       None if r.values is None else np.asarray(r.values).tobytes())
                      for r in served], sup.counters, dataclasses.asdict(q.stats),
                     plan.counts(), dataclasses.asdict(svc.scheduler.stats)))
    assert rows[0] == rows[1]
    for r in served:
        if r.mode != "shed":
            solo = th.run_hytm(graphs[1], talg.SSSP, source=r.request.source, config=TCFG,
                               device="cpu")
            np.testing.assert_array_equal(r.values, solo.values)


# The chaos trace: eight queries from three tenants, one update batch
# delivered exactly once, the same eight sources again (warm lanes).
TRACE_SOURCES = [0, 3, 77, 210, 9, 15, 120, 42]
TRACE = ([(("gold", "silver", "bronze")[i % 3], s) for i, s in enumerate(TRACE_SOURCES)],
         [(("bronze", "gold", "silver")[i % 3], s)
          for i, s in enumerate(reversed(TRACE_SOURCES))])
CHAOS = {
    "clean": (None, None, 6),
    "empty": ([], None, 6),
    "dispatch": ([("lane_dispatch", "fail", 0.3, (), 6, None),
                  ("lane_dispatch", "timeout", 0.2, (), 4, None)], 3, 6),
    "alloc": ([("lane_alloc", "oom", 1.0, (), 100, None),
               ("cache_promote", "oom", 0.5, (), 10, None)], 2, 6),
    "corrupt": ([("host_spill", "corrupt", 0.0, (0, 1), None, None),
                 ("update_delivery", "drop", 0.0, (0,), None, None),
                 ("update_redeliver", "duplicate", 0.0, (0,), None, None)], None, 2),
}


@pytest.fixture(scope="module")
def trace_batch(graphs):
    """The trace's update batch (12 inserts, 12 deletes, seed 7), for the
    reference and the port."""
    b = jstream.random_batch(jstream.DeltaCSR(graphs[0], JCFG), np.random.default_rng(7),
                             n_insert=12, n_delete=12)
    return b, tstream.EdgeBatch(b.op, b.src, b.dst, b.weight)


def _replay(pkg, graph, cfg, prog, plan_name, obs_pkg, batch):
    specs, shed_after, lanes_budget = CHAOS[plan_name]
    plan = None if specs is None else _plan(pkg, specs, 7)
    policy = pkg.RetryPolicy(max_attempts=4)
    rec = obs_pkg.TraceRecorder()
    sup = None if shed_after is None else pkg.Supervisor(
        policy=policy, faults=plan, tenant_tiers=TIERS, shed_after=shed_after, obs=rec)
    budget = lanes_budget * 9 * graph.n_nodes
    kw = dict(max_lanes=4, device_budget_bytes=budget, faults=plan, supervisor=sup, obs=rec)
    if pkg is jr:
        svc, req_pkg = jstream.GraphService(graph, cfg, **kw), jserve
    else:
        svc, req_pkg = tstream.GraphService(graph, cfg, device="cpu", **kw), tserve
    completed, shed, order = {}, [], []
    for phase, specs_ in enumerate(TRACE):
        q = req_pkg.RequestQueue(quota=2, tenant_quotas={"bronze": 1})
        for i, (tenant, source) in enumerate(specs_):
            q.submit(req_pkg.Request(tenant=tenant, program=prog, source=source,
                                     deadline=float(i)))
        for r in svc.scheduler.pump(q):
            key = (phase, r.request.tenant, r.request.source)
            order.append((key, r.mode, r.iterations))
            if r.mode == "shed":
                shed.append(key)
            elif r.mode != "rejected":
                completed[key] = np.asarray(r.values)
        assert q.stats.quota_violations == 0
        if phase == 0:
            pkg.deliver_update(svc, batch, batch_id="trace-7", faults=plan, policy=policy,
                               obs=rec)
    assert svc.scheduler.stats.max_device_bytes <= budget
    faults_track = [(e.name, {k: v for k, v in e.args.items()})
                    for e in rec.events if e.track == "faults"]
    return dict(completed=completed, shed=shed, order=order, version=svc.version,
                cache=svc.cache.stats.as_dict(), sched=dataclasses.asdict(svc.scheduler.stats),
                counts=None if plan is None else plan.counts(),
                sup=None if sup is None else dict(sup.counters), faults=faults_track,
                trace_events=obs_pkg.validate_chrome_trace(obs_pkg.to_chrome_trace(rec)))


@pytest.fixture(scope="module")
def clean_replay(graphs, trace_batch):
    return _replay(tr, graphs[1], TCFG, talg.SSSP, "clean", tobs, trace_batch[1])


@pytest.mark.parametrize("plan_name", sorted(CHAOS))
def test_chaos_replay_matches_reference(graphs, trace_batch, clean_replay, plan_name):
    """The chaos trace under each plan: the port serves, sheds and counts as
    the reference does, completed answers bit-equal to its clean replay;
    the version is the clean one and the top tier is never shed."""
    want = _replay(jr, graphs[0], JCFG, jalg.SSSP, plan_name, jobs, trace_batch[0])
    got = _replay(tr, graphs[1], TCFG, talg.SSSP, plan_name, tobs, trace_batch[1])
    for key in ("shed", "order", "version", "cache", "sched", "counts", "sup", "faults"):
        assert got[key] == want[key], key
    assert set(got["completed"]) == set(want["completed"])
    for key, vals in got["completed"].items():
        np.testing.assert_array_equal(vals, want["completed"][key])
        np.testing.assert_array_equal(vals, clean_replay["completed"][key])
    assert set(got["completed"]) | set(got["shed"]) == set(clean_replay["completed"])
    assert got["version"] == clean_replay["version"] == 1
    for phase, tenant, _ in got["shed"]:
        assert TIERS[tenant] < max(TIERS[t] for t, _ in TRACE[phase])
    if plan_name == "corrupt":
        assert got["cache"]["corrupt"] >= 1
        assert got["counts"][("host_spill", "corrupt")] == 2
    if plan_name == "dispatch":
        names = [n for n, _ in got["faults"]]
        assert names.count("injected") == sum(got["counts"].values()) > 0
        assert names.count("retry") == got["sup"]["retries"] > 0
        assert got["trace_events"] > 0
    if plan_name in ("clean", "empty"):
        assert got["sched"] == clean_replay["sched"] and not got["faults"]


def test_entry_points_raise_without_a_card(graphs, tmp_path):
    """``resume_run`` and ``run_supervised`` run on ``cuda`` unless given
    ``device="cpu"``: with no card they raise instead of falling back."""
    import torch

    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present: the entry points run on it")
    _, tg, _, _ = graphs
    path = tmp_path / "run.npz"
    _kill(tr, th, talg, TCFG, {"device": "cpu"}, tg, path, 1)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        tr.resume_run(path, tg, talg.SSSP, config=TCFG)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        tr.run_supervised(tg, talg.SSSP, 0, TCFG)
