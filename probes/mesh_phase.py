"""``chip_smoke.py``'s mesh phase alone: its checks and its lines.

    python3 probes/mesh_phase.py          # on the card
    python3 probes/mesh_phase.py --cpu    # a rehearsal on the host,
                                          # reduced configs, gloo ranks
    python3 probes/mesh_phase.py --moe    # its check (f) alone: the MoE
                                          # cuts at 1x1 and 1x2
    python3 probes/mesh_phase.py --g      # its check (g) alone: the jamba
                                          # and whisper cuts at 1x1, 1x2
    python3 probes/mesh_phase.py --h      # its check (h) alone: decode
                                          # split over the model axis

Exits non-zero when a check of the phase fails.
"""
from __future__ import annotations

import json
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))
sys.path.insert(0, str(ROOT / "src"))


def main(argv=None) -> int:
    import torch
    import chip_smoke as cs
    argv = sys.argv[1:] if argv is None else argv
    if "--cpu" in argv:
        cs.LM_REDUCED = True
        dev, card = torch.device("cpu"), "the host's CPU (rehearsal)"
    else:
        card, dev = cs.phase_environment(), torch.device("cuda")
    only = ("f" if "--moe" in argv else "g" if "--g" in argv
            else "h" if "--h" in argv else None)
    res = cs.phase_mesh(dev, card, only=only)
    keys = {"f": ("split", "seconds"), "g": ("split_g", "seconds"),
            "h": ("decode", "seconds"),
            None: ("bf16_1x2", "flops", "split", "split_g", "decode",
                   "seconds")}[only]
    print(json.dumps({k: res[k] for k in keys}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
