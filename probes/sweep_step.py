"""The Pareto sweep's one-step check alone, in several processes.

    python3 probes/sweep_step.py [--procs 6] [--device cuda]

Each process runs with another ``PYTHONHASHSEED`` (1 to N), so it draws
another connectivity (``core.layers`` seeds it from Python's salted
``hash``), and runs ``chip_smoke.sweep_step_check``: one step of the
paper grid's padded NeuraLUT group (U = 6) on the first 256 rows of
``mnist_pooled`` against ``train_neuralut_ensemble`` per point (S = 3),
split by the ensemble's gradient at init.  Each prints one JSON line of
its readings per point and seed: the elements on each side of the split,
the largest gradient-at-init difference (below the split and over all
elements), the worst shares of the tolerances, and how many elements the
split by the gradient after the step fails.  The parent prints the
largest readings over all processes last.  Exits 1 if a split failed.
"""
from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]


def child(device: str) -> int:
    sys.path.insert(0, str(ROOT))
    sys.path.insert(0, str(ROOT / "src"))
    import torch

    import chip_smoke as C
    from repro_torch.data import device_dataset, mnist_pooled
    from repro_torch.sweep import paper_sweep_points, plan_sweep

    dev = torch.device(device)
    if dev.type == "cpu":
        # the CPU's threaded reductions round differently from call to
        # call; the check needs the step's gradient reproduced exactly
        torch.set_num_threads(1)
    xtr, ytr = device_dataset(mnist_pooled, C.SWEEP_ROWS[0], seed=0,
                              device=dev)
    xte, yte = device_dataset(mnist_pooled, C.SWEEP_ROWS[1], seed=1,
                              device=dev)
    groups = plan_sweep(paper_sweep_points(), seeds=C.SWEEP_SEEDS)
    g = next(g for g in groups if g.padded_cfg.kind == "subnet"
             and len(g.points) > 1)
    report, _ = C.sweep_step_check(g, xtr[:C.TRAIN_B], ytr[:C.TRAIN_B],
                                   xte, yte, dev)
    print("READING " + json.dumps(report), flush=True)
    return 0 if all(s["ok"] for r in report.values()
                    for s in r.values()) else 1


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--procs", type=int, default=6)
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--child", action="store_true")
    args = ap.parse_args()
    if args.child:
        return child(args.device)
    if args.device == "cuda":
        card = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"], capture_output=True, text=True)
        print(card.stdout.strip(), flush=True)
    worst = dict(grad_diff=0.0, grad_diff_all=0.0, cross_tol=0.0,
                 own_tol=0.0, old_split_fails=0)
    failed = 0
    for k in range(1, args.procs + 1):
        env = dict(os.environ, PYTHONHASHSEED=str(k))
        p = subprocess.run([sys.executable, __file__, "--child", "--device",
                            args.device], env=env, capture_output=True,
                           text=True, timeout=600)
        for line in p.stdout.splitlines():
            if line.startswith("sweep step"):
                print(f"[hash seed {k}] {line}", flush=True)
            if line.startswith("READING "):
                for point, seeds in json.loads(line[8:]).items():
                    for s in seeds.values():
                        for key in worst:
                            worst[key] = max(worst[key], s[key])
        if p.returncode:
            failed += 1
            print(f"[hash seed {k}] rc {p.returncode}: {p.stderr[-2000:]}",
                  flush=True)
    print(json.dumps({"procs": args.procs, "failed": failed,
                      "worst": worst}), flush=True)
    return 1 if failed else 0


if __name__ == "__main__":
    sys.exit(main())
