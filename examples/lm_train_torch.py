"""LM substrate end-to-end on the PyTorch/CUDA port: train a small LM for
a few hundred steps with checkpoint/restart, using the LM train step
(AdamW + SGDR + remat over the stacked layers).

    PYTHONPATH=src python examples/lm_train_torch.py --steps 200 \
        [--device cpu]

Defaults to the reduced lm-100m config; pass ``--full`` for the
~100M-parameter model.  The run goes through ``TrainSupervisor`` with a
checkpoint every 50 steps under ``--ckpt`` and resumes from the latest
one there.  Runs on CUDA unless ``--device cpu``.
"""
import argparse
import pathlib
import sys
import time

sys.path.insert(0, str(pathlib.Path(__file__).resolve().parents[1] / "src"))

import torch

from repro_torch.checkpoint import CheckpointStore
from repro_torch.config import TrainConfig, get_config
from repro_torch.data.pipeline import lm_batch_fn
from repro_torch.device import resolve_device
from repro_torch.models import api
from repro_torch.optim.adamw import adamw_init
from repro_torch.runtime.fault import TrainSupervisor
from repro_torch.train.step import make_train_step


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser()
    ap.add_argument("--steps", type=int, default=200)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--seq", type=int, default=128)
    ap.add_argument("--full", action="store_true")
    ap.add_argument("--ckpt", default=str(pathlib.Path(__file__).parent
                                          / "out" / "lm_ckpt"))
    ap.add_argument("--device", default=None, help="cuda (default) or cpu")
    args = ap.parse_args(argv)
    dev = resolve_device(args.device)

    cfg = get_config("lm-100m", reduced=not args.full)
    tcfg = TrainConfig(lr=3e-3, sgdr_t0=max(50, args.steps // 2))
    params = api.init_params(cfg, torch.Generator().manual_seed(0),
                             device=dev)
    opt = adamw_init(params)
    raw_step = make_train_step(cfg, tcfg, q_chunk=64)

    def make_step():
        def step(carry, batch):
            p, o, m = raw_step(carry[0], carry[1], batch)
            return (p, o), m
        return step

    make_np = lm_batch_fn(cfg.vocab_size, args.batch, args.seq, seed=0)

    def make_batch(step):
        return {k: torch.as_tensor(v).to(dev)
                for k, v in make_np(step).items()}

    store = CheckpointStore(args.ckpt, keep=2)
    sup = TrainSupervisor(store=store, make_step=make_step,
                          make_batch=make_batch, ckpt_every=50)
    start = store.latest_step() or 0
    carry = (params, opt)
    if start:
        start, carry = store.restore(carry, device=dev)
        print(f"resumed from checkpoint at step {start}")

    t0 = time.time()
    out = sup.run(carry, start_step=start, num_steps=args.steps)
    loss = float(out["metrics"]["loss"]) if out["metrics"] else float("nan")
    dt = time.time() - t0
    print(f"trained to step {out['step']} in {dt:.0f}s "
          f"({dt / max(args.steps - start, 1) * 1e3:.0f} ms/step), "
          f"final loss {loss:.4f}, restarts={out['restarts']}")
    return {"step": out["step"], "loss": loss, "restarts": out["restarts"],
            "start": start}


if __name__ == "__main__":
    main()
