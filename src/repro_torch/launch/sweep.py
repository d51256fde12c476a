"""Pareto sweep launcher (port of ``repro.launch.sweep``): the paper's
Figs. 6-7 grid on one card.

    python -m repro_torch.launch.sweep --seeds 3 --epochs 10 \\
        --track results/sweep.jsonl --registry results/registry
    python -m repro_torch.launch.sweep --seeds 1 --epochs 1 \\
        --n-train 512 --n-test 256 --device cpu --registry results/registry

Plans the paper grid (``repro_torch.sweep.paper_sweep_points``: three
LogicNets and three NeuraLUT geometries over 196 pooled synthetic-MNIST
features) into stacked geometry groups, trains every (geometry, seed)
unit of a group together (``run_pareto_sweep``: on the card one K4 and
one K5 launch per NeuraLUT layer per step for the whole group), and
streams frontier points to a tracker as each group finishes.  With
``--registry`` every point's best seed is converted to packed truth
tables (K2 on the card for NeuraLUT), saved as a serving-ready bundle,
loaded back verified, and served on the test rows through
``LUTServeEngine`` (K1 on the card); every served prediction must equal
``lut_infer.predict``.  Runs on CUDA unless ``--device cpu``; a sweep
across several cards (``--devices`` above 1) is not ported.
"""
from __future__ import annotations

import argparse
from typing import Any, Dict, Optional, Sequence


def parse_args(argv: Optional[Sequence[str]] = None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--seeds", type=int, default=3)
    ap.add_argument("--epochs", type=int, default=10)
    ap.add_argument("--n-train", type=int, default=6000)
    ap.add_argument("--n-test", type=int, default=2000)
    ap.add_argument("--batch", type=int, default=256)
    ap.add_argument("--lr", type=float, default=3e-3)
    ap.add_argument("--devices", type=int, default=1,
                    help="cards to spread the unit axis over (only 1 is "
                         "ported)")
    ap.add_argument("--track", default=None,
                    help="stream per-point records to this JSONL file")
    ap.add_argument("--registry", default=None,
                    help="convert each point's best seed and save "
                         "serving-ready bundles here")
    ap.add_argument("--resume", default=None, metavar="DIR",
                    help="journal finished groups here and, on rerun, "
                         "replay them instead of retraining (resume a "
                         "killed/preempted sweep)")
    ap.add_argument("--max-group-retries", type=int, default=2,
                    help="retries (with backoff) before a failing group "
                         "aborts the sweep")
    ap.add_argument("--quiet", action="store_true")
    ap.add_argument("--device", default=None,
                    help="cuda (default) or cpu")
    return ap.parse_args(argv)


def _serve_bundles(result, reg, x_test, dev) -> Dict[str, int]:
    """Load every saved bundle back (checksums verified), serve the test
    rows through ``LUTServeEngine`` and count the predictions that
    differ from ``lut_infer.predict`` of the trained member."""
    from repro_torch.core import lut_infer as LI
    from repro_torch.core import model as M
    from repro_torch.serve import LUTServeEngine

    x_np = x_test.cpu().numpy()
    mismatches = {}
    for res in result.points:
        if res.packed is None:
            continue
        bundle = reg.load(res.name)
        with LUTServeEngine(bundle, device=dev) as eng:
            served = eng.predict(x_np)
        want = LI.predict(res.point.cfg, res.params, res.packed[0],
                          M.model_static(res.point.cfg), x_test)
        mismatches[res.name] = int((served != want.cpu().numpy()).sum())
    return mismatches


def main(argv: Optional[Sequence[str]] = None) -> Dict[str, Any]:
    args = parse_args(argv)
    from repro_torch.core import model as M
    from repro_torch.data import device_dataset, mnist_pooled
    from repro_torch.device import resolve_device
    from repro_torch.runtime.straggler import StepWatchdog
    from repro_torch.runtime.tracker import (CompositeTracker, JsonlTracker,
                                             NoopTracker, PrintTracker)
    from repro_torch.serve import TableRegistry, bundle_from_training
    from repro_torch.sweep import paper_sweep_points, run_pareto_sweep

    trackers = []
    if not args.quiet:
        trackers.append(PrintTracker())
    if args.track:
        trackers.append(JsonlTracker(args.track))
    tracker = (CompositeTracker(trackers) if len(trackers) > 1
               else (trackers[0] if trackers else NoopTracker()))

    dev = resolve_device(args.device)
    xtr, ytr = device_dataset(mnist_pooled, args.n_train, seed=0, device=dev)
    xte, yte = device_dataset(mnist_pooled, args.n_test, seed=1, device=dev)
    print(f"device: {dev}", flush=True)

    with tracker:
        result = run_pareto_sweep(
            paper_sweep_points(), xtr, ytr, xte, yte,
            seeds=tuple(range(args.seeds)), epochs=args.epochs,
            batch=args.batch, lr=args.lr, device=dev, devices=args.devices,
            tracker=tracker, convert=bool(args.registry),
            resume=args.resume, max_group_retries=args.max_group_retries,
            watchdog=StepWatchdog())

    replayed = sum(1 for g in result.groups if g.replayed)
    print(f"{len(result.points)} points / {len(result.groups)} group runs "
          f"on {result.devices} device(s): cold {result.cold_s:.1f}s + "
          f"warm {result.warm_s:.1f}s = {result.total_s:.1f}s"
          + (f" ({replayed} group(s) replayed from journal)"
             if replayed else ""), flush=True)
    for res in result.points:
        if res.status != "ok":
            print(f"  [{res.point.tag:>9}] {res.name:<16} FAILED "
                  f"({res.diverged_seeds} diverged seed(s))", flush=True)
            continue
        print(f"  [{res.point.tag:>9}] {res.name:<16} "
              f"err={res.err:.4f} luts={res.est.luts:.0f} "
              f"latency={res.est.latency_ns:.1f}ns", flush=True)

    out: Dict[str, Any] = {"result": result, "saved": {}, "mismatches": {}}
    if args.registry:
        reg = TableRegistry(args.registry)
        for res in result.points:
            if res.packed is None:          # diverged -> nothing to ship
                continue
            tables, packed = res.packed
            bundle = bundle_from_training(
                res.point.cfg, res.params, tables,
                M.model_static(res.point.cfg), packed_tables=packed,
                meta={"sweep_err": res.err, "tag": res.point.tag})
            out["saved"][res.name] = path = reg.save(res.name, bundle)
            print(f"saved {res.name} -> {path}", flush=True)
        out["mismatches"] = _serve_bundles(result, reg, xte, dev)
        print(f"served {len(xte)} test rows through every saved bundle: "
              f"{out['mismatches']} predictions differ from "
              "lut_infer.predict", flush=True)
        if any(out["mismatches"].values()):
            raise RuntimeError(f"served predictions differ from "
                               f"lut_infer.predict: {out['mismatches']}")
    return out


if __name__ == "__main__":
    main()
