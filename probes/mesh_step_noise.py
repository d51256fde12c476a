"""Where a mesh step test misses its STEP limits: the elements beyond
them and the split's rounding that moved them.

    PYTHONPATH=src python probes/mesh_step_noise.py jamba_1x2
    PYTHONPATH=src python probes/mesh_step_noise.py whisper_1x2 --steps 1

A case of ``tests/test_torch_mesh_train.py`` (its CASES, or
``whisper_1x2``) runs over its gloo processes on the CPU as the test
runs it, beside the one-process reference.  Printed: the losses; per
leaf the largest error over the STEP bound (atol 1e-5 + rtol 1e-5)
among the elements the test holds to it; each element beyond it with
its one-process gradient at every step (absolute, over the leaf's
largest, and in units of AdamW's eps); and the first step's averaged
gradient against one process's, per leaf, over the leaf's largest
element (the split's rounding).
"""
from __future__ import annotations

import dataclasses
import os
import sys
import tempfile
from pathlib import Path

import numpy as np
import torch

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT / "tests"))
sys.path.insert(0, str(ROOT / "src"))

import test_torch_mesh_train as t  # noqa: E402

EPS = 1e-8          # AdamW's eps (TrainConfig)


def _case(name):
    if name == "whisper_1x2":
        return 2, t.WHISPER, "1x2", (), "float32"
    return t.CASES[name]


def _first_grads(cfg, mesh, batch, shape):
    """The first step's averaged gradient, gathered whole."""
    from repro_torch.config import TrainConfig
    from repro_torch.models import api
    from repro_torch.sharding.spmd import (gather_tree, local_batch,
                                           mesh_loss_and_grads,
                                           param_shardings, shard_tree)
    from repro_torch.train.step import make_loss_fn
    from repro_torch.tree import tree_leaves
    params = api.init_params(cfg, torch.Generator().manual_seed(0),
                             device=torch.device("cpu"))
    psh = param_shardings(cfg, params, mesh)
    n = mesh.size(mesh.data_axes)
    split = mesh.data_axes if n > 1 else None
    g, _ = mesh_loss_and_grads(
        make_loss_fn(cfg, TrainConfig(lr=t.LR, sgdr_t0=50)), mesh, psh,
        shard_tree(params, psh), local_batch(batch, mesh, cfg, shape), 1,
        split)
    return [x.numpy() for x in tree_leaves(gather_tree(g, psh))]


def _worker(rank, world, init, out_dir, name, steps):
    import torch.distributed as dist
    from repro_torch.config import ShapeConfig, get_config
    from repro_torch.launch.mesh import make_host_mesh
    torch.set_num_threads(1)
    t.STEPS = steps
    dist.init_process_group("gloo", init_method=init, world_size=world,
                            rank=rank)
    try:
        _, arch, shape, extra, dtype = _case(name)
        if name == "whisper_1x2":
            t._whisper_1x2(rank, out_dir, {})
        else:
            t._run_case(out_dir, name, t._argv(arch, shape, *extra), rank,
                        False, dtype)
        cfg = dataclasses.replace(get_config(arch, reduced=True),
                                  dtype="float32")
        sh = ShapeConfig("t", "train", t.S, t.B)
        mesh = make_host_mesh(tuple(int(v) for v in shape.split("x")),
                              device="cpu")
        if cfg.encoder is not None:
            batch = t._ed_batches(cfg, 1)[0]
        else:
            from repro_torch.data import lm_batch_fn
            batch = {k: torch.as_tensor(v) for k, v in
                     lm_batch_fn(cfg.vocab_size, t.B, t.S, seed=0)(0).items()}
        g = _first_grads(cfg, mesh, batch, sh)
        if rank == 0:
            np.savez(os.path.join(out_dir, "g0.npz"), *g)
    finally:
        dist.destroy_process_group()


def main(argv=None) -> int:
    import torch.multiprocessing as mp
    argv = sys.argv[1:] if argv is None else argv
    name = argv[0] if argv else "jamba_1x2"
    steps = int(argv[argv.index("--steps") + 1]) if "--steps" in argv \
        else t.STEPS
    world, arch = _case(name)[:2]
    d = Path(tempfile.mkdtemp(prefix="mesh_step_noise_"))
    mp.start_processes(_worker, args=(world, f"file://{d}/rdzv", str(d),
                                      name, steps),
                       nprocs=world, start_method="spawn")
    torch.set_num_threads(1)
    got = dict(np.load(d / f"{name}.npz"))
    ref = t._plain(arch, steps=steps)
    loose = t._small(ref["seen"])
    losses = [float(v) for v in got["losses"]]
    print(f"{name}, {steps} steps: losses {losses} against one process's "
          f"{ref['losses']}")
    beyond = 0
    for i, (w, mask) in enumerate(zip(ref["params"], loose)):
        a = got[f"p/{i}"]
        err = np.abs(a - w)
        bound = t.STEP["atol"] + t.STEP["rtol"] * np.abs(w)
        if mask.all():
            continue
        worst = float(np.max(err[~mask] / bound[~mask]))
        bad = np.argwhere(~mask & (err > bound))
        beyond += len(bad)
        if worst > 0.5:
            print(f"param {i} {w.shape}: largest error / bound {worst:.3f}, "
                  f"{len(bad)} element(s) beyond")
        for j in bad:
            gs = [s[i].numpy()[tuple(j)] for s in ref["seen"]]
            mx = [float(np.abs(s[i].numpy()).max()) for s in ref["seen"]]
            print(f"  element {tuple(int(v) for v in j)}: error "
                  f"{float(err[tuple(j)]):.3e}; one-process gradient by step "
                  + ", ".join(f"{float(g):.3e} ({abs(g) / m:.2e} of the "
                              f"leaf's largest, {abs(g) / EPS:.0f} eps)"
                              for g, m in zip(gs, mx)))
    g0 = np.load(d / "g0.npz")
    rel = [float(np.abs(g0[f"arr_{i}"] - w.numpy()).max()
                 / np.abs(w.numpy()).max())
           for i, w in enumerate(ref["seen"][0])]
    print(f"first step's gradient against one process, per leaf, over the "
          f"leaf's largest element: median {float(np.median(rel)):.3e}, "
          f"largest {max(rel):.3e}; elements beyond STEP: {beyond}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
