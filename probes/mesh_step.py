"""Where a step over a mesh of processes spends its time, part by part.

    python3 probes/mesh_step.py [--shapes 1x1,2x1,1x2] [--steps 5]
                                [--device cuda] [--reduced]

For each mesh shape, spawns one process per device of the shape (ranks
share the card: gloo; one rank: no process group) and runs ``lm-100m``
in float32 at 8 x 128 tokens through the parts of
``sharding.spmd.make_mesh_train_step``, timed one by one with the device
synchronized after each: ``loss+grads`` (the loss and backward on the
rank's rows, with the per-layer gathers over the data axes, the model
axis's split and the gradients' float32 sums over the data ranks in the
backward), ``clip`` (the whole gradient's squared norm from the shards,
summed over the mesh), ``update`` (AdamW on the rank's shards).  The
first step is left out.  Prints one JSON line per shape with each
rank's median ms per part and per step and its peak device memory; the
step's arithmetic is the launcher's (the losses are printed to hold
against ``launch.train``).
"""
from __future__ import annotations

import argparse
import json
import os
import statistics
import sys
import tempfile
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
SRC = ROOT / "src"
B, S = 8, 128


def _worker(rank, world, init, out_dir, shape, steps, device, reduced):
    sys.path.insert(0, str(SRC))
    import dataclasses

    import torch
    import torch.distributed as dist
    from repro_torch.config import MeshConfig, ShapeConfig, TrainConfig
    from repro_torch.config import get_config
    from repro_torch.data import lm_batch_fn
    from repro_torch.device import resolve_device
    from repro_torch.launch.mesh import make_mesh_from_config
    from repro_torch.models import api
    from repro_torch.optim import adamw_init, adamw_update, sgdr_schedule
    from repro_torch.sharding.spmd import (_mean_over, grad_sq,
                                           local_batch, mesh_loss_and_grads,
                                           param_shardings, shard_tree)
    from repro_torch.train.step import make_loss_fn

    dev = resolve_device(device)
    if world > 1:
        dist.init_process_group("gloo", init_method=init, world_size=world,
                                rank=rank)
    sync = torch.cuda.synchronize if dev.type == "cuda" else (lambda: None)
    try:
        cfg = dataclasses.replace(get_config("lm-100m", reduced=reduced),
                                  dtype="float32")
        dims = tuple(int(x) for x in shape.split("x"))
        mesh = make_mesh_from_config(MeshConfig(dims, ("data", "model")),
                                     device=dev)
        tcfg = TrainConfig(lr=3e-4, sgdr_t0=50)
        gshape = ShapeConfig("probe", "train", S, B)
        params = api.init_params(cfg, torch.Generator().manual_seed(0),
                                 device=dev)
        psh = param_shardings(cfg, params, mesh)
        params_s = shard_tree(params, psh)
        del params
        opt_s = adamw_init(params_s)
        loss_fn = make_loss_fn(cfg, tcfg)
        dax = mesh.data_axes
        split = dax if mesh.size(dax) > 1 else None
        make = lm_batch_fn(cfg.vocab_size, B, S, seed=0)
        parts = {k: [] for k in ("loss+grads", "clip", "update", "step")}
        losses = []
        if dev.type == "cuda":
            torch.cuda.reset_peak_memory_stats(dev)
        for s in range(steps):
            batch = local_batch({k: torch.as_tensor(v)
                                 for k, v in make(s).items()}, mesh, cfg,
                                gshape)
            batch = {k: v.to(dev) for k, v in batch.items()}
            sync()
            t = [time.perf_counter()]
            grads, (loss, _) = mesh_loss_and_grads(
                loss_fn, mesh, psh, params_s, batch, 1, split)
            sync()
            t.append(time.perf_counter())
            sq = grad_sq(mesh, grads, psh)
            sync()
            t.append(time.perf_counter())
            lr = sgdr_schedule(opt_s["count"], lr_max=tcfg.lr,
                               lr_min=tcfg.lr_min, t0=tcfg.sgdr_t0,
                               t_mult=tcfg.sgdr_t_mult)
            params_s, opt_s = adamw_update(
                grads, opt_s, params_s, lr=lr, beta1=tcfg.beta1,
                beta2=tcfg.beta2, eps=tcfg.eps,
                weight_decay=tcfg.weight_decay, grad_clip=tcfg.grad_clip,
                grad_sq=sq)
            losses.append(float(_mean_over(mesh, loss, dax)))
            sync()
            t.append(time.perf_counter())
            if s:
                for k, a, b in zip(list(parts)[:3], t, t[1:]):
                    parts[k].append(1e3 * (b - a))
                parts["step"].append(1e3 * (t[-1] - t[0]))
        peak = (torch.cuda.max_memory_allocated(dev)
                if dev.type == "cuda" else None)
        out = {"rank": rank, "coords": list(mesh.coords),
               "backend": mesh.backend, "losses": losses,
               "peak_bytes": peak,
               "ms": {k: statistics.median(v) for k, v in parts.items()}}
    finally:
        if world > 1:
            dist.destroy_process_group()
    with open(os.path.join(out_dir, f"rank{rank}.json"), "w") as f:
        json.dump(out, f)


def run_shape(shape: str, steps: int, device: str, reduced: bool) -> dict:
    import torch.multiprocessing as mp
    world = 1
    for d in shape.split("x"):
        world *= int(d)
    with tempfile.TemporaryDirectory(prefix="mesh_step_") as tmp:
        args = (world, f"file://{tmp}/rdzv", tmp, shape, steps, device,
                reduced)
        if world == 1:
            _worker(0, *args)
        else:
            mp.start_processes(_worker, args=args, nprocs=world,
                               start_method="spawn")
        ranks = [json.loads(Path(tmp, f"rank{r}.json").read_text())
                 for r in range(world)]
    return {"shape": shape, "world": world, "ranks": ranks}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--shapes", default="1x1,2x1,1x2")
    ap.add_argument("--steps", type=int, default=5)
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--reduced", action="store_true")
    args = ap.parse_args(argv)
    for shape in args.shapes.split(","):
        print(json.dumps(run_shape(shape, args.steps, args.device,
                                   args.reduced)), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
