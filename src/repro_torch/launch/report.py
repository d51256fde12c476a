"""Render the dry run's tables (roofline, dry run, variants) from the
port's records in results/dryrun_torch (port of
``repro.launch.report``; the same tables, from the port's per-rank
counts on the meta device).

    PYTHONPATH=src python -m repro_torch.launch.report [--table dryrun] [--mesh single]
"""
from __future__ import annotations

import argparse
import glob
import json
from pathlib import Path

RESULTS = Path(__file__).resolve().parents[3] / "results" / "dryrun_torch"


def load(mesh: str, variants: bool = False):
    rows = []
    for f in sorted(glob.glob(str(RESULTS / f"*__{mesh}*.json"))):
        r = json.loads(Path(f).read_text())
        if bool(r.get("variant")) != variants:
            continue
        rows.append(r)
    return rows


def gib(x):
    return "-" if x is None else f"{x / 2**30:.2f}"


def roofline_table(mesh: str = "single") -> str:
    out = ["| arch | shape | status | t_comp (s) | t_mem (s) | t_coll (s) |"
           " bound | MODEL_FLOPs | useful | frac | peak GiB/dev |",
           "|---|---|---|---|---|---|---|---|---|---|---|"]
    for r in load(mesh):
        if r["status"] == "skip":
            out.append(f"| {r['arch']} | {r['shape']} | SKIP |  |  |  |  |  "
                       f"|  |  |")
            continue
        if r["status"] != "ok":
            out.append(f"| {r['arch']} | {r['shape']} | ERROR |  |  |  |  |"
                       f"  |  |  |")
            continue
        rf = r["roofline"]
        out.append(
            f"| {r['arch']} | {r['shape']} | ok "
            f"| {rf['t_compute']:.3f} | {rf['t_memory']:.3f} "
            f"| {rf['t_collective']:.3f} | {rf['bottleneck']} "
            f"| {rf['model_flops']:.2e} | {rf['useful_ratio']:.2f} "
            f"| {rf['roofline_fraction']:.4f} "
            f"| {gib(r['memory']['peak_per_device'])} |")
    return "\n".join(out)


def dryrun_table(mesh: str) -> str:
    out = [f"| arch | shape | status | compile (s) | params | "
           f"args GiB/dev | peak GiB/dev | collectives GiB/dev |",
           "|---|---|---|---|---|---|---|---|"]
    for r in load(mesh):
        if r["status"] != "ok":
            reason = r.get("reason", r.get("error", ""))[:60]
            out.append(f"| {r['arch']} | {r['shape']} | {r['status'].upper()}"
                       f" {reason} |  |  |  |  |  |")
            continue
        rf = r["roofline"]
        out.append(
            f"| {r['arch']} | {r['shape']} | ok | {r['compile_s']} "
            f"| {r['param_count']/1e9:.2f}B "
            f"| {gib(r['memory']['arguments_per_device'])} "
            f"| {gib(r['memory']['peak_per_device'])} "
            f"| {rf['collective_bytes']/2**30:.2f} |")
    return "\n".join(out)


def variant_table() -> str:
    out = ["| cell | variant | t_comp | t_mem | t_coll | bound | frac |",
           "|---|---|---|---|---|---|---|"]
    for mesh in ("single", "multi"):
        for r in load(mesh, variants=True):
            if r["status"] != "ok":
                continue
            rf = r["roofline"]
            out.append(
                f"| {r['arch']}×{r['shape']}×{mesh} | {r['variant']} "
                f"| {rf['t_compute']:.2f} | {rf['t_memory']:.2f} "
                f"| {rf['t_collective']:.2f} | {rf['bottleneck']} "
                f"| {rf['roofline_fraction']:.4f} |")
    return "\n".join(out)


def main() -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--table", default="roofline",
                    choices=["roofline", "dryrun", "variants"])
    ap.add_argument("--mesh", default="single", choices=["single", "multi"])
    args = ap.parse_args()
    if args.table == "roofline":
        print(roofline_table(args.mesh))
    elif args.table == "dryrun":
        print(dryrun_table(args.mesh))
    else:
        print(variant_table())


if __name__ == "__main__":
    main()
