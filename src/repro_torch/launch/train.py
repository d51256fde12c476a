"""Training launcher for the NeuraLUT archs (port of the NeuraLUT branch
of ``repro.launch.train``): train -> convert -> serving bundle -> serve.

    python -m repro_torch.launch.train --arch neuralut-jsc-5l --epochs 20
    python -m repro_torch.launch.train --arch polylut-add-jsc-5l \\
        --epochs 20 --seeds 4
    python -m repro_torch.launch.train --arch neuralut-jsc-5l --reduced \\
        --epochs 1 --device cpu

Takes the JSC chains (``neuralut-jsc-*``) and the PolyLUT-Add LUT graphs
(``polylut-add-jsc-*``).  Trains on the device-resident synthetic JSC
data (20,000 training and 4,000 test rows, batch 256): one seed, or with
``--seeds N`` (N > 1) N restarts together (``train_neuralut_ensemble``),
keeping the member with the best quantized test accuracy.  On the card
every step makes one call of each training kernel per layer, or per
branch of a graph node, for all N seeds.  Then converts the trained
model to bit-packed truth tables (through the grouped sub-network kernel
on the card, once per layer or branch), builds the in-memory
``ServeBundle``, serves the test set through ``LUTServeEngine`` (the
LUT-cascade kernel on the card, a graph on its DAG schedule) and checks
that every served prediction equals ``lut_infer.predict``.  Runs on
CUDA unless ``--device cpu``.
"""
from __future__ import annotations

import argparse
import time
from typing import Any, Dict, Optional, Sequence

NOT_PORTED = "is not ported yet (ROADMAP.md, {})"


def train_neuralut_arch(args, cfg) -> Dict[str, Any]:
    """The NeuraLUT pipeline for one parsed command line; returns the
    history, the bundle, the test accuracies and the counts it checked."""
    from repro_torch.core import lut_infer as LI
    from repro_torch.core import model as M
    from repro_torch.core import truth_table as TT
    from repro_torch.core.train import (ensemble_member, train_neuralut,
                                        train_neuralut_ensemble)
    from repro_torch.data import device_dataset, jsc_synthetic
    from repro_torch.device import resolve_device
    from repro_torch.serve import LUTServeEngine, bundle_from_training

    if "jsc" not in cfg.name:
        raise SystemExit(f"--arch {args.arch}: only the JSC NeuraLUT "
                         "configs have a synthetic dataset wired here")
    if args.seeds < 1:
        raise SystemExit(f"--seeds {args.seeds}: need at least one seed")
    if args.registry:
        raise NotImplementedError(
            "--registry: the on-disk TableRegistry "
            + NOT_PORTED.format("Queue A item 3"))
    dev = resolve_device(args.device)
    xtr, ytr = device_dataset(jsc_synthetic, 20000, seed=0, device=dev)
    xte, yte = device_dataset(jsc_synthetic, 4000, seed=1, device=dev)
    n_steps = args.epochs * (len(xtr) // 256)
    lr = args.lr if args.lr is not None else 2e-3

    t0 = time.perf_counter()
    best = None
    if args.seeds > 1:
        params, state, hist = train_neuralut_ensemble(
            cfg, xtr, ytr, xte, yte, seeds=tuple(range(args.seeds)),
            epochs=args.epochs, batch=256, lr=lr,
            log_every=args.log_every, device=dev)
        final_q = hist["test_acc_q"][-1]
        best = int(final_q.argmax())
        print(f"seeds={args.seeds} acc_q per seed="
              f"{[round(float(a), 4) for a in final_q]} -> best seed "
              f"{best}", flush=True)
        params, state = ensemble_member(params, state, best)
        acc_q = float(final_q[best])
        n_steps *= args.seeds
    else:
        params, state, hist = train_neuralut(
            cfg, xtr, ytr, xte, yte, epochs=args.epochs, batch=256, lr=lr,
            log_every=args.log_every, device=dev)
        acc_q = hist["test_acc_q"][-1]
    dt = time.perf_counter() - t0  # history's fetch synchronized
    print(f"trained {args.epochs} epochs in {dt:.1f}s "
          f"({n_steps / dt:.1f} steps/s) acc_q={acc_q:.4f}", flush=True)

    statics = M.model_static(cfg)
    t0 = time.perf_counter()
    tables, packed = TT.convert_packed(cfg, params, state, statics)
    # a graph's tables come as per-node lists of branch tables
    flat_t = [t for n in tables for t in (n if isinstance(n, list) else [n])]
    flat_p = [p for n in packed for p in (n if isinstance(n, list) else [n])]
    print(f"converted {sum(t.size for t in flat_t)} table entries in "
          f"{time.perf_counter() - t0:.2f}s (packed "
          f"{sum(p.nbytes for p in flat_p) / 1024:.1f} KiB)", flush=True)
    bundle = bundle_from_training(cfg, params, tables, statics,
                                  packed_tables=packed)
    x_np = xte.cpu().numpy()
    with LUTServeEngine(bundle, device=dev) as eng:
        served = eng.predict(x_np)
    want = LI.predict(cfg, params, tables, statics, xte).cpu().numpy()
    mismatches = int((served != want).sum())
    served_acc = float((served == yte.cpu().numpy()).mean())
    print(f"served {len(x_np)} test rows: accuracy {served_acc:.4f}, "
          f"{mismatches} predictions differ from lut_infer.predict",
          flush=True)
    if mismatches:
        raise RuntimeError(f"{mismatches} served predictions differ from "
                           "lut_infer.predict")
    return {"history": hist, "bundle": bundle, "acc_q": acc_q,
            "best_seed": best,
            "served_acc": served_acc, "mismatches": mismatches,
            "steps": n_steps, "train_seconds": dt}


def parse_args(argv: Optional[Sequence[str]] = None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--arch", required=True)
    ap.add_argument("--reduced", action="store_true")
    ap.add_argument("--epochs", type=int, default=20,
                    help="training epochs")
    ap.add_argument("--seeds", type=int, default=1,
                    help="restarts trained together; the best is kept")
    ap.add_argument("--registry", default=None,
                    help="save the bundle here (not ported)")
    ap.add_argument("--lr", type=float, default=None,
                    help="default 2e-3")
    ap.add_argument("--log-every", type=int, default=10,
                    help="print metrics every N epochs (0: never)")
    ap.add_argument("--device", default=None,
                    help="cuda (default) or cpu")
    return ap.parse_args(argv)


def main(argv: Optional[Sequence[str]] = None) -> Dict[str, Any]:
    args = parse_args(argv)
    from repro_torch.config import get_config, list_archs
    if args.arch not in list_archs():
        if args.arch.startswith(("neuralut", "polylut")):
            raise SystemExit(f"--arch {args.arch}: unknown; the NeuraLUT "
                             f"archs are {', '.join(list_archs())}")
        raise NotImplementedError(
            f"--arch {args.arch}: LM archs and their trainer "
            + NOT_PORTED.format("Queue A item 7"))
    return train_neuralut_arch(args, get_config(args.arch,
                                                reduced=args.reduced))


if __name__ == "__main__":
    main()
