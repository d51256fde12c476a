"""The dry run's counts against one card, cell by cell, without the rest
of chip_smoke.py.

    python3 probes/dryrun_cells.py [--reduced] [--device cuda]

For each of chip_smoke.py's dry-run cells (lm-100m's bf16 step at 8 x
128 and its decode at 64 x 128, the qwen2-moe-a2.7b 2-layer cut at 8 x
128, whisper-small at 8 x 448 with its frames) runs
``chip_smoke._dry_cell``: the meta count on a 1 x 1 ``CountingMesh``,
then one real step under ``FlopCounterMode`` with the peak memory reset
before it.  Prints one JSON line per cell: FLOPs meta and card, the meta
peak against ``max_memory_allocated`` above what was allocated before
the cell, the roofline's terms and the step's seconds, then the card's
name and power limit.  Exits non-zero if a cell's FLOPs differ or its
peaks lie more than chip_smoke.DRY_PEAK_REL apart.
"""
from __future__ import annotations

import argparse
import dataclasses
import json
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))
sys.path.insert(0, str(ROOT / "src"))


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--reduced", action="store_true")
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args()
    import torch
    import chip_smoke as C
    from repro_torch.config import ShapeConfig, TrainConfig, get_config
    from repro_torch.roofline.analysis import roofline_report

    dev = torch.device(args.device)
    red = args.reduced
    tcfg = TrainConfig(lr=3e-4, sgdr_t0=50)
    lm = get_config(C.LM_ARCH, reduced=red)
    wh = get_config(C.ENCDEC_ARCH, reduced=red)
    moe = dataclasses.replace(get_config(C.MOE_ARCHS[0], reduced=red),
                              num_layers=C.MOE_CUT_LAYERS)
    cells = [("lm train", lm, ShapeConfig("t", "train", C.LM_S, C.LM_B)),
             ("lm decode", lm, ShapeConfig("d", "decode", C.LM_DECODE_CTX,
                                           C.LM_DECODE_B)),
             ("moe train", moe, ShapeConfig("t", "train", C.LM_S, C.LM_B)),
             ("whisper train", wh, ShapeConfig(
                 "t", "train", wh.max_seq_len, C.ED_TRAIN_B))]
    bad = 0
    for name, cfg, shape in cells:
        r = C._dry_cell(cfg, shape, tcfg, dev)
        ana, mem = r["ana"], r["mem"]
        rep = roofline_report(arch=cfg.name, shape=shape.name, mesh="1x1",
                              num_devices=1, analysis=ana, memstats=mem,
                              bf16_model=cfg.dtype == "bfloat16")
        peak = mem.peak_memory_in_bytes
        gap = (None if r["card_peak"] is None
               else abs(peak - r["card_peak"]) / r["card_peak"])
        ok = r["card_flops"] == ana.dot_flops and (
            gap is None or gap <= C.DRY_PEAK_REL)
        bad += not ok
        print(json.dumps(dict(
            cell=name, ok=ok, meta_flops=ana.dot_flops,
            card_flops=r["card_flops"], meta_peak=peak,
            meta_args=mem.argument_size_in_bytes, card_peak=r["card_peak"],
            base=r["base"], peak_gap=gap, hbm_bytes=ana.hbm_bytes,
            t_compute_ms=rep.t_compute * 1e3,
            t_memory_ms=rep.t_memory * 1e3, step_s=r["step_s"],
            meta_s=r["meta_s"])), flush=True)
    if dev.type == "cuda":
        print(subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"], capture_output=True, text=True
        ).stdout.strip())
    return 1 if bad else 0


if __name__ == "__main__":
    sys.exit(main())
