"""One process's decode step (``train.step.make_serve_step``) timed on the
card: ms per token and the peak above the params and the state, for a
few LM configs at their published widths (some cut in depth), in
bfloat16, from a zero state at a fixed position.

    python3 probes/decode_step_time.py                  # this checkout
    python3 probes/decode_step_time.py --src OTHER/src  # another tree's
                                                        # repro_torch

To compare two trees, run both in one call, in turns (A B B A).  Prints
one JSON line per config.
"""
from __future__ import annotations

import argparse
import json
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]

# (arch, layers kept or None, rows, context)
CASES = (("lm-100m", None, 64, 128),
         ("whisper-small", None, 64, 448),
         ("llama3-8b", 4, 64, 4096))


def run(arch, layers, rows, ctx, steps, warm):
    import dataclasses
    import torch
    from repro_torch.config import get_config
    from repro_torch.models import api
    from repro_torch.models.layers.common import zeros_from_spec
    from repro_torch.train.step import make_serve_step
    dev = torch.device("cuda")
    cfg = dataclasses.replace(get_config(arch), dtype="bfloat16")
    if layers is not None:
        cfg = dataclasses.replace(cfg, num_layers=layers)
    params = api.init_params(cfg, torch.Generator(device=dev).manual_seed(0),
                             device=dev)
    state = zeros_from_spec(api.decode_state_spec(cfg, rows, ctx),
                            device=dev)
    gen = torch.Generator(device=dev).manual_seed(1)
    if cfg.encoder is not None:
        # random cross K/V in place of encoded frames
        state["cross"] = {k: torch.randn(v.shape, generator=gen, device=dev,
                                         dtype=v.dtype)
                          for k, v in state["cross"].items()}
    state["pos"] = torch.tensor(ctx // 2, dtype=torch.int32, device=dev)
    step = make_serve_step(cfg)
    tok = torch.randint(0, cfg.vocab_size, (rows, 1), generator=gen,
                        device=dev, dtype=torch.int32)
    for _ in range(warm):
        _, state = step(params, state, tok)
    torch.cuda.synchronize()
    base = torch.cuda.memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    for _ in range(steps):
        logits, state = step(params, state, tok)
    torch.cuda.synchronize()
    ms = 1e3 * (time.perf_counter() - t0) / steps
    return {"arch": arch, "layers": cfg.num_layers, "rows": rows,
            "ctx": ctx, "ms_per_token": ms,
            "peak_above_carry": torch.cuda.max_memory_allocated() - base,
            "finite": bool(torch.isfinite(logits).all())}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--src", default=str(ROOT / "src"))
    ap.add_argument("--steps", type=int, default=20)
    ap.add_argument("--warm", type=int, default=3)
    args = ap.parse_args(argv)
    sys.path.insert(0, args.src)
    import torch
    if not torch.cuda.is_available():
        print("decode_step_time: no CUDA device", file=sys.stderr)
        return 2
    for arch, layers, rows, ctx in CASES:
        out = run(arch, layers, rows, ctx, args.steps, args.warm)
        out.update(src=args.src, device=torch.cuda.get_device_name(0))
        print(json.dumps(out), flush=True)
        torch.cuda.empty_cache()
    return 0


if __name__ == "__main__":
    sys.exit(main())
