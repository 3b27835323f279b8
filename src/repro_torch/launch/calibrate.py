"""Cost-model calibration launcher: probe -> fit -> persist, on ``cuda``
unless ``--device`` says otherwise.

    # calibrate the card (wall-clock probes through the kernels) and save
    # the profile under the card's device kind
    PYTHONPATH=src python -m repro_torch.launch.calibrate

    # simulate a platform: fit the PCIe profile against a TPU-modeled
    # ground truth (deterministic, on the host)
    PYTHONPATH=src python -m repro_torch.launch.calibrate --mode model \\
        --initial pcie3 --truth tpu_v5e_hbm

    PYTHONPATH=src python -m repro_torch.launch.calibrate --selfcheck --device cpu

``--selfcheck`` runs the reference's calibration acceptance contract and
exits non-zero on any violation:

  1. mis-specified profile (PCIe constants, TPU-modeled hardware): the
     calibrated selection's total regret vs the measured-best oracle is
     *strictly* lower than the static selection's;
  2. correctly-specified profile (TPU on TPU): calibration is a no-op —
     selection decisions unchanged across the probe grid;
  3. registry round-trip: save -> load reproduces identical selection;
  4. regret never worse, with and without measurement noise;
  5. online loop: ``HyTMConfig.autotune`` leaves traversal results
     bit-identical on ``--device`` while recording corrections and
     mispredictions.

Steps 1-4 run on the host (model probes) and print the reference's
numbers; step 5 runs the engines on the device.
"""

from __future__ import annotations

import argparse
import sys

import numpy as np


def _profiles():
    from repro_torch.core.constants import PCIE3, TPU_V5E_HBM, TPU_V5E_ICI

    return {"pcie3": PCIE3, "tpu_v5e_hbm": TPU_V5E_HBM, "tpu_v5e_ici": TPU_V5E_ICI}


def selfcheck(device: str = "cuda") -> None:
    import dataclasses
    import tempfile

    from repro_torch.autotune import (
        calibrate,
        default_grid,
        load_profile,
        model_probe,
        save_profile,
        selection_on_grid,
    )
    from repro_torch.core.constants import PCIE3, TPU_V5E_HBM

    points = default_grid()

    # 1. mis-specified initial profile: strictly lower regret
    obs = model_probe(points, TPU_V5E_HBM)
    rep = calibrate(points, obs, PCIE3)
    assert rep.calibrated_regret < rep.static_regret, (
        f"calibration did not improve a mis-specified profile: "
        f"{rep.calibrated_regret} !< {rep.static_regret}")
    assert rep.improved
    print(f"  mis-specified: regret {rep.static_regret:.3e} -> "
          f"{rep.calibrated_regret:.3e} "
          f"(oracle total {rep.oracle_seconds:.3e} s)")

    # 2. correctly-specified profile: selection is a no-op on the grid
    rep_ok = calibrate(points, model_probe(points, TPU_V5E_HBM), TPU_V5E_HBM)
    before = selection_on_grid(points, TPU_V5E_HBM)
    after = selection_on_grid(points, rep_ok.profile)
    changed = int(np.sum(before != after))
    assert changed == 0, f"correct profile: {changed} selection decisions changed"
    print(f"  correctly-specified: no-op (0/{len(points)} decisions changed)")

    # 3. registry round-trip preserves selection exactly
    with tempfile.TemporaryDirectory() as tmp:
        save_profile(rep.profile, device_kind="selfcheck", base=tmp,
                     meta={"static_regret": rep.static_regret})
        loaded = load_profile(device_kind="selfcheck", base=tmp)
    assert loaded == rep.profile, "round-trip changed the profile"
    np.testing.assert_array_equal(
        selection_on_grid(points, loaded), selection_on_grid(points, rep.profile))
    print("  registry round-trip: identical profile + selection")

    # 4. regret never worse, incl. under measurement noise
    for initial, truth, noise in [
        (PCIE3, TPU_V5E_HBM, 0.05),
        (TPU_V5E_HBM, PCIE3, 0.0),
        (TPU_V5E_HBM, TPU_V5E_HBM, 0.1),
    ]:
        o = model_probe(points, truth, noise=noise, seed=7)
        r = calibrate(points, o, initial)
        assert r.calibrated_regret <= r.static_regret + 1e-12, (
            initial.name, truth.name, noise, r)
    print("  regret-never-worse: held across profile pairs and noise")

    # 5. online feedback on the device: results unchanged, diagnostics recorded
    from repro_torch.core.hytm import HyTMConfig, run_hytm
    from repro_torch.graph.algorithms import SSSP
    from repro_torch.graph.generators import rmat_graph

    g = rmat_graph(1000, 12_000, seed=3)
    cfg = HyTMConfig(n_partitions=8)
    base = run_hytm(g, SSSP, source=0, config=cfg, device=device)
    tuned = run_hytm(g, SSSP, source=0,
                     config=dataclasses.replace(cfg, autotune=True), device=device)
    np.testing.assert_array_equal(base.values, tuned.values)
    assert tuned.engine_corrections is not None
    assert tuned.engine_corrections.shape == (3,)
    assert "mispredictions" in tuned.history
    print(f"  online loop ({device}): SSSP bit-identical, corrections="
          f"{np.round(tuned.engine_corrections, 3)}")

    print("SELFCHECK OK")


def main(argv=None) -> None:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--selfcheck", action="store_true")
    ap.add_argument("--device", default="cuda",
                    help="torch device whose engines are probed (default cuda; the CPU "
                         "only when asked)")
    ap.add_argument("--mode", choices=["wall", "model"], default="wall",
                    help="wall: time the engines on --device; "
                         "model: simulate a ground-truth link")
    ap.add_argument("--initial", default="pcie3",
                    help="initial profile name (default: pcie3)")
    ap.add_argument("--truth", default="tpu_v5e_hbm",
                    help="ground-truth profile for --mode model")
    ap.add_argument("--noise", type=float, default=0.0,
                    help="multiplicative measurement noise for --mode model")
    ap.add_argument("--max-edges", type=int, default=200_000,
                    help="cap on materialized edges per wall probe point")
    ap.add_argument("--use-kernels", choices=["auto", "on", "off"], default="auto",
                    help="wall-probe the kernel-backed engines (mirrors "
                         "HyTMConfig.use_kernels; 'auto' turns them on for a CUDA "
                         "device, so the probes time the path the runtime dispatches)")
    ap.add_argument("--device-kind", default=None,
                    help="registry key (default: the device kind of --device)")
    ap.add_argument("--registry", default=None,
                    help="registry directory (default: "
                         "$REPRO_AUTOTUNE_REGISTRY or ~/.cache/repro/autotune)")
    ap.add_argument("--dry-run", action="store_true",
                    help="calibrate and report, but do not save")
    args = ap.parse_args(argv)

    if args.selfcheck:
        try:
            selfcheck(args.device)
        except AssertionError as e:
            print(f"SELFCHECK FAILED: {e}", file=sys.stderr)
            sys.exit(1)
        return

    from repro_torch.autotune import (
        calibrate,
        default_device_kind,
        default_grid,
        model_probe,
        save_profile,
        wall_probe,
    )

    profiles = _profiles()
    initial = profiles[args.initial]

    if args.mode == "model":
        points = default_grid()
        obs = model_probe(points, profiles[args.truth], noise=args.noise)
    else:
        # wall probes materialize edges: keep E levels machine-sized.
        # calibrate against the materialized grid the probe reports —
        # capped points are measured (and fitted) at their real size
        points = default_grid(edge_levels=(3.1e4, 1.1e5, 4.1e5), n_ratios=7)
        uk = {"auto": "auto", "on": True, "off": False}[args.use_kernels]
        points, obs = wall_probe(points, max_edges=args.max_edges,
                                 use_kernels=uk, device=args.device)

    # wall measurements pay real per-call dispatch -> refit the overhead
    rep = calibrate(points, obs, initial, fit_overhead=args.mode == "wall")
    print(f"calibrated from {initial.name!r} over {rep.n_points} probe points "
          f"({rep.n_observations} observations, mode={args.mode})")
    print(f"  regret: static {rep.static_regret:.3e} s -> "
          f"calibrated {rep.calibrated_regret:.3e} s "
          f"(oracle {rep.oracle_seconds:.3e} s)")
    for k, v in rep.fitted.items():
        print(f"  {k:>22}: {v:.6g}")

    device_kind = args.device_kind
    if device_kind is None:
        if args.mode == "model":
            # a simulated-truth fit must never overwrite a device's real
            # wall-calibrated entry by default — key it by the simulation
            device_kind = f"model-{args.truth}"
            print(f"(model mode: saving under device kind {device_kind!r}; "
                  f"pass --device-kind to override)")
        else:
            device_kind = default_device_kind(args.device)
    if not args.dry_run:
        path = save_profile(
            rep.profile, device_kind=device_kind, base=args.registry,
            meta={
                "initial": initial.name,
                "mode": args.mode,
                "static_regret": rep.static_regret,
                "calibrated_regret": rep.calibrated_regret,
                "n_observations": rep.n_observations,
            },
        )
        print(f"saved -> {path}")


if __name__ == "__main__":
    main()
