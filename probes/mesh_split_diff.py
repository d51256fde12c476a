"""Where steps split over the model axis first depart from one process.

    python3 probes/mesh_split_diff.py [--arch deepseek-v2-lite-16b]
        [--steps 3] [--init host|device] [--device cuda] [--reduced]

Draws ``--arch`` cut to 2 layers (float32, the dense dispatch) from seed
0 (``--init host``: as ``launch.train`` draws it, on the host; ``device``:
on the device, faster), then runs ``--steps`` training steps at the
launcher's settings (``make_mesh_train_step``, lr 3e-4, remat "full",
``lm_batch_fn`` batches of 8 x 128, seed 0) in one process and in two
gloo processes as a 1 x 2 mesh (ranks share the card), each rank on its
model blocks of the same params.  Both record, per step, every block's
output, each MoE layer's top-k experts per token and its routing
probabilities, and the loss.  Prints one JSON line per step: the two
losses, per block the largest difference of the output relative to its
largest element, per MoE layer the tokens whose chosen experts differ,
the smallest gap between the k-th and the (k+1)-th routing probability
over all tokens and, for each rerouted token, that gap in both runs.
"""
from __future__ import annotations

import argparse
import json
import os
import sys
import tempfile
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
SRC = ROOT / "src"
B, S, LAYERS = 8, 128, 2


def _run(arch, reduced, device, init, steps, mesh_shape, out):
    """``steps`` steps on ``mesh_shape`` (this process's rank of the open
    group, or one process), recorded into ``out`` (a path; written by
    rank 0)."""
    sys.path.insert(0, str(SRC))
    import dataclasses

    import numpy as np
    import torch
    from repro_torch.config import (MeshConfig, ShapeConfig, TrainConfig,
                                    get_config)
    from repro_torch.data import lm_batch_fn
    from repro_torch.device import resolve_device
    from repro_torch.launch.mesh import make_mesh_from_config
    from repro_torch.models import api, lm
    from repro_torch.models.layers import moe
    from repro_torch.optim import adamw_init
    from repro_torch.sharding.spmd import (local_batch, make_mesh_train_step,
                                           param_shardings, shard_tree)

    dev = resolve_device(device)
    cfg = dataclasses.replace(get_config(arch, reduced=reduced),
                              num_layers=LAYERS, dtype="float32",
                              moe_dispatch="dense")
    n_moe = sum(s.ffn == "moe" for s in cfg.layer_specs())
    mesh = make_mesh_from_config(MeshConfig(mesh_shape, ("data", "model")),
                                 device=dev)
    tcfg = TrainConfig(lr=3e-4, sgdr_t0=50)
    gen = torch.Generator(device=dev if init == "device" else "cpu")
    params = api.init_params(cfg, gen.manual_seed(tcfg.seed), device=dev)
    psh = param_shardings(cfg, params, mesh)
    params = shard_tree(params, psh)
    opt = adamw_init(params)
    shape = ShapeConfig("probe", "train", S, B)
    step = make_mesh_train_step(cfg, tcfg, mesh, psh, shape)
    make = lm_batch_fn(cfg.vocab_size, B, S, seed=tcfg.seed)
    rec = {}
    real_block, real_gates = lm.apply_block, moe._topk_gates

    def block(*a, **k):
        x, aux = real_block(*a, **k)
        if len(rec["blocks"]) < LAYERS:      # the forward, not a recompute
            rec["blocks"].append(x.detach().cpu().numpy())
        return x, aux

    def gates(logits, c, e):
        g, aux = real_gates(logits, c, e)
        if len(rec["top"]) < n_moe:
            probs = torch.softmax(logits.detach().float(), dim=-1)
            rec["probs"].append(probs.cpu().numpy())
            rec["top"].append(torch.sort(torch.topk(
                g.detach(), c.top_k).indices, dim=-1).values.cpu().numpy())
        return g, aux

    arrays = {}
    lm.apply_block, moe._topk_gates = block, gates
    try:
        for i in range(steps):
            rec.update(blocks=[], top=[], probs=[])
            batch = local_batch({k: torch.as_tensor(v, device=dev)
                                 for k, v in make(i).items()}, mesh, cfg,
                                shape)
            params, opt, m = step(params, opt, batch)
            arrays[f"loss{i}"] = np.asarray(float(m["loss"]))
            for j, x in enumerate(rec["blocks"]):
                arrays[f"block{i}_{j}"] = x
            for j, (t, p) in enumerate(zip(rec["top"], rec["probs"])):
                arrays[f"top{i}_{j}"], arrays[f"probs{i}_{j}"] = t, p
    finally:
        lm.apply_block, moe._topk_gates = real_block, real_gates
    if mesh.rank == 0:
        arrays["top_k"] = np.asarray(cfg.moe.top_k)
        np.savez(out, **arrays)


def _worker(rank, world, init_method, args, out):
    import torch.distributed as dist
    dist.init_process_group("gloo", init_method=init_method,
                            world_size=world, rank=rank)
    try:
        _run(args.arch, args.reduced, args.device, args.init, args.steps,
             (1, 2), out)
    finally:
        dist.destroy_process_group()


def _gaps(probs, k):
    srt = -np.sort(-probs, axis=-1)
    return srt[:, k - 1] - srt[:, k]


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--arch", default="deepseek-v2-lite-16b")
    ap.add_argument("--steps", type=int, default=3)
    ap.add_argument("--init", choices=("host", "device"), default="host")
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--reduced", action="store_true")
    args = ap.parse_args(argv)
    import torch.multiprocessing as mp
    tmp = tempfile.mkdtemp(prefix="split_diff_")
    one, two = os.path.join(tmp, "one.npz"), os.path.join(tmp, "two.npz")
    _run(args.arch, args.reduced, args.device, args.init, args.steps,
         (1, 1), one)
    import torch
    if torch.cuda.is_available():
        torch.cuda.empty_cache()      # the ranks share the card
    mp.start_processes(_worker, args=(2, f"file://{tmp}/rdzv", args, two),
                       nprocs=2, start_method="spawn")
    a, b = np.load(one), np.load(two)
    k = int(a["top_k"])

    def rel(x, y):
        return float(np.abs(x - y).max() / max(np.abs(x).max(), 1e-30))

    for i in range(args.steps):
        tops = sorted(f for f in a.files if f.startswith(f"top{i}_"))
        moved, gaps = [], []
        for f in tops:
            p = f.replace("top", "probs")
            rows = np.nonzero((a[f] != b[f]).any(-1))[0]
            moved.append({int(r): [float(_gaps(a[p], k)[r]),
                                   float(_gaps(b[p], k)[r])] for r in rows})
            gaps.append(float(_gaps(a[p], k).min()))
        print(json.dumps({
            "arch": args.arch, "step": i, "init": args.init,
            "loss": [float(a[f"loss{i}"]), float(b[f"loss{i}"])],
            "blocks_rel": [rel(a[f"block{i}_{j}"], b[f"block{i}_{j}"])
                           for j in range(LAYERS)],
            "probs_rel": [rel(a[f.replace("top", "probs")],
                              b[f.replace("top", "probs")]) for f in tops],
            "min_gap": gaps, "rerouted_gaps": moved}), flush=True)
    return 0


if __name__ == "__main__":
    import numpy as np
    sys.exit(main())
