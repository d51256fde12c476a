"""The training path's step-1 gradient check alone, in several processes,
with the quantizer flips between its two routes counted.

    python3 probes/train_step_flips.py [--procs 16] [--device cuda]
        [--hash-seed K | --hash-seeds A-B] [--jobs J] [--repeat N]

``chip_smoke.py``'s training path holds one step's gradients of full
``neuralut-jsc-5l`` through the training kernels (``kernel_train``)
against plain autograd (``canonical``) at rtol 2e-4 / atol 3e-5.  The two
routes compute each layer's hidden function in another float32 order, so
a pre-quantization value within rounding of a ``round()`` boundary can
quantize to neighbouring codes in the two routes (as conversion's +-1
flips do), and everything downstream of that row then differs by more
than rounding.  Each process runs with another ``PYTHONHASHSEED`` (1 to
N, or each seed of ``--hash-seeds A-B``, the same seeds that
``chip_smoke.py`` prints and replays), so it draws another connectivity,
and prints one JSON line: the
gradients' largest share of the tolerance and largest absolute error,
and per layer the quantized activations that differ between the routes,
each route fed its own previous layer, the message of the direct
comparison of the two routes' gradients (the check as it was, naming
the worst leaf and element) when it fails, and the readings of
``chip_smoke.train_step_check`` (the check as it is: the plain route
walked on the kernel route's codes).  ``--hash-seed K`` gives every
process the same ``PYTHONHASHSEED`` K instead, and ``--repeat N`` has
each process compute both routes' gradients N times more on the same
inputs, each time after filling the caching allocator's free blocks with
NaN, and report per route the repeats that are not bit-identical to the
first, their largest difference and the first leaf that differs: a
kernel that races, or that reads memory it never wrote, reads as
nonzero there.  ``--jobs J`` runs J processes at once (the kernels are
built once, by the parent, before any starts).  The parent prints the
card, each reading as it comes, and the summary of all processes last:
the seeds beyond the tolerance are listed there by number.
"""
from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]


def poison(dev) -> None:
    """Fill the caching allocator's free blocks, small and large, with
    NaN, so that a later ``torch.empty`` hands out NaN, not the last
    repeat's values."""
    import torch
    if dev.type != "cuda":
        return
    held = [torch.full((kib * 256,), float("nan"), device=dev)
            for kib in (1, 4, 16, 64, 256, 1024, 4096, 16384, 65536)
            for _ in range(8)]
    del held


def child(device: str, repeat: int) -> None:
    sys.path.insert(0, str(ROOT))
    sys.path.insert(0, str(ROOT / "src"))
    import torch

    import chip_smoke as C
    from repro_torch.config import get_config
    from repro_torch.core import layers as L
    from repro_torch.core import model as M
    from repro_torch.core import quant
    from repro_torch.core import train as TR
    from repro_torch.core.exec_plan import plan_subnet_exec
    from repro_torch.data import device_dataset, jsc_synthetic

    dev = torch.device(device)
    if dev.type == "cpu":
        torch.set_num_threads(1)
    cfg = get_config("neuralut-jsc-5l")
    xtr, ytr = device_dataset(jsc_synthetic, 20000, seed=0, device=dev)
    statics = M.model_static(cfg)
    sd = M.device_statics(statics, dev)
    p0, s0 = M.model_init(cfg, torch.Generator().manual_seed(0), device=dev)
    p0 = M.calibrate_in_quant(cfg, p0, xtr)
    ib = TR.epoch_batches(len(xtr), len(xtr) // C.TRAIN_B, C.TRAIN_B, seed=0,
                          epoch=0, device=dev)[0]
    xb, yb = xtr[ib], ytr[ib]
    plans = {r: plan_subnet_exec(cfg, purpose="train", device=dev, route=r)
             for r in ("kernel_train", "canonical")}
    grads = {r: TR.loss_and_grads(cfg, p0, s0, sd, xb, yb, exec_plan=p)[1]
             for r, p in plans.items()}
    reruns = {}
    for r, p in plans.items():
        differ, worst, leaf = 0, 0.0, None
        for _ in range(repeat):
            poison(dev)
            again = TR.loss_and_grads(cfg, p0, s0, sd, xb, yb,
                                      exec_plan=p)[1]
            bad = [(k, float(torch.nan_to_num((a - b).abs(),
                                              nan=float("inf")).max()))
                   for (k, a), (_, b) in zip(C._paths(again),
                                             C._paths(grads[r]))
                   if not torch.equal(a, b)]
            differ += bool(bad)
            worst = max([worst] + [d for _, d in bad])
            leaf = leaf or (bad[0][0] if bad else None)
        reruns[r] = {"repeats": repeat, "differ": differ, "max_abs": worst,
                     "first_leaf": leaf}
    share, abs_err = 0.0, 0.0
    for (_, a), (_, b) in zip(C._paths(grads["kernel_train"]),
                              C._paths(grads["canonical"])):
        d = (a - b).abs()
        abs_err = max(abs_err, float(d.max()))
        share = max(share, float((d / (C.K5_ATOL + C.K5_RTOL * b.abs()))
                                 .max()))
    direct = None  # the check as it was: each route fed its own codes
    try:
        for (k, a), (_, b) in zip(C._paths(grads["kernel_train"]),
                                  C._paths(grads["canonical"])):
            C._close(a, b, C.K5_RTOL, C.K5_ATOL, f"step-1 gradient {k}")
    except RuntimeError as e:
        direct = str(e)
    try:  # the check as chip_smoke.py makes it
        chk = C.train_step_check(cfg, p0, s0, sd, xb, yb,
                                 plans["kernel_train"], plans["canonical"])
        walk = {k: chk[k] for k in ("grad_err", "pre_err", "bn_err",
                                    "flips")}
    except RuntimeError as e:
        walk = {"failed": str(e)}
    flips = []
    with torch.no_grad():
        v = {r: quant.quant_apply(p0["in_quant"], xb, cfg.beta_in or cfg.beta)
             for r in plans}
        for i in range(cfg.num_layers):
            for r, p in plans.items():
                v[r] = L.layer_apply(cfg, i, p0["layers"][i],
                                     s0["layers"][i], sd[i], v[r],
                                     train=True, exec_plan=p)[0]
            flips.append(int((v["kernel_train"] != v["canonical"]).sum()))
    print("READING " + json.dumps({
        "hash_seed": os.environ.get("PYTHONHASHSEED"), "tol_share": share,
        "max_abs_err": abs_err, "flips_by_layer": flips,
        "direct_check": direct, "walk": walk, "reruns": reruns}),
        flush=True)


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--procs", type=int, default=16)
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--hash-seed", type=int, default=None)
    ap.add_argument("--hash-seeds", default=None,
                    help="A-B: one process per PYTHONHASHSEED in A..B "
                         "(replaces --procs and --hash-seed)")
    ap.add_argument("--jobs", type=int, default=1,
                    help="processes run at once")
    ap.add_argument("--repeat", type=int, default=0)
    ap.add_argument("--child", action="store_true")
    args = ap.parse_args()
    if args.child:
        child(args.device, args.repeat)
        return 0
    if args.device == "cuda":
        print(subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"], capture_output=True,
            text=True).stdout.strip(), flush=True)
    if args.hash_seeds:
        lo, hi = (int(x) for x in args.hash_seeds.split("-"))
        seeds = list(range(lo, hi + 1))
    else:
        seeds = [k if args.hash_seed is None else args.hash_seed
                 for k in range(1, args.procs + 1)]
    if args.device == "cuda":
        sys.path.insert(0, str(ROOT / "src"))
        from repro_torch.kernels import build
        build.load_library()

    def run(seed):
        env = dict(os.environ, PYTHONHASHSEED=str(seed))
        return seed, subprocess.run(
            [sys.executable, __file__, "--child", "--device", args.device,
             "--repeat", str(args.repeat)], env=env, capture_output=True,
            text=True, timeout=600)

    readings = []
    with ThreadPoolExecutor(max(1, args.jobs)) as pool:
        for seed, p in pool.map(run, seeds):
            line = [x for x in p.stdout.splitlines()
                    if x.startswith("READING ")]
            if p.returncode or not line:
                print(f"[hash seed {seed}] rc {p.returncode}: "
                      f"{p.stderr[-2000:]}", flush=True)
                continue
            readings.append(json.loads(line[0][8:]))
            print(line[0][8:], flush=True)
    print(json.dumps({"procs": len(seeds), "readings": len(readings),
                      "hash_seeds": (f"{seeds[0]}-{seeds[-1]}" if
                                     args.hash_seeds else None),
                      "beyond_tolerance": sum(r["tol_share"] > 1
                                              for r in readings),
                      "seeds_beyond_tolerance": [
                          r["hash_seed"] for r in readings
                          if r["tol_share"] > 1],
                      "with_flips": sum(sum(r["flips_by_layer"]) > 0
                                        for r in readings),
                      "walk_failed": [r["hash_seed"] for r in readings
                                      if "failed" in r["walk"]],
                      "rerun_differ": sum(v["differ"] for r in readings
                                          for v in r["reruns"].values()),
                      "max_tol_share": max((r["tol_share"] for r in readings),
                                           default=None)}), flush=True)
    return 0 if len(readings) == len(seeds) else 1


if __name__ == "__main__":
    sys.exit(main())
