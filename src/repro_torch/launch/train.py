"""Training launcher (port of ``repro.launch.train``): the NeuraLUT
archs train -> convert -> serving bundle -> serve; the dense LMs train
through the LM step under the training supervisor.

    python -m repro_torch.launch.train --arch lm-100m --steps 100 \\
        --ckpt-dir /ckpt/lm100m
    python -m repro_torch.launch.train --arch lm-100m --reduced --steps 3 \\
        --device cpu
    torchrun --nproc-per-node 2 -m repro_torch.launch.train \\
        --arch llama3-8b --reduced --mesh-shape 2x1 --device cpu --steps 3
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
``ServeBundle`` (saved to the ``TableRegistry`` at ``--registry`` when
given, where ``launch.serve`` loads it), serves the test set through
``LUTServeEngine`` (the LUT-cascade kernel on the card, a graph on its
DAG schedule) and checks that every served prediction equals
``lut_infer.predict``.  Runs on CUDA unless ``--device cpu``.

LM archs (``list_lm_archs``: lm-100m, llama3-8b, yi-9b, granite-34b,
gemma3-12b, the MoE qwen2-moe-a2.7b, the MLA + MoE
deepseek-v2-lite-16b, jamba-v0.1-52b and xlstm-350m; ``--reduced`` for
the CPU; whisper-small and qwen2-vl-72b are refused with a
``ValueError``, since their loss needs frames or patch embeddings that
``lm_batch_fn`` does not make, as in the reference): seeded init, AdamW
(a float32 master for bfloat16 parameters) with SGDR, batches of
``lm_batch_fn`` prefetched by a ``ShardedLoader``, ``--grad-accum``
microbatches and ``--compress-grads`` (error-feedback int8).  With
``--ckpt-dir`` the run goes through ``TrainSupervisor`` (an async
checkpoint every ``--ckpt-every`` steps, restart from the latest on
failure) and resumes from the directory's latest checkpoint.

Over several processes (one per device; it joins the process group the
caller opened, else opens one from ``torchrun``'s environment: NCCL
when each rank has a card of its own, gloo when ranks share a card or
run on the CPU; rank r computes on ``cuda:{local_rank % count}``) the
processes form the mesh of ``--mesh-shape`` (``--mesh host`` without
it: (n / 2, 2), the reference's; ``--mesh single`` / ``multi``: the
16x16 / 2x16x16 pods, refused unless the world has 256 / 512
processes) and every step is ``sharding.spmd``'s ZeRO-3 step: each rank
stores its shards of the params and AdamW state by ``param_partition``,
takes its rows of the global batch by ``batch_partition``, and equals
one process at the same global batch.  The model axis splits attention
and MLA heads, the dense FFN, MoE experts and shared experts, Mamba's
channels and the vocabulary; xLSTM layers stay whole over it (ROADMAP.md,
Queue A).  One process is the
mesh of ones.  Rank 0 prints the loss every
``--log-every`` steps, then ms/step, tokens/s and the peak device
memory; over several ranks each rank prints its own ms/step, peak and
the bytes it holds against the whole (``mesh rank summary``).
"""
from __future__ import annotations

import argparse
import json
import time
from typing import Any, Dict, Optional, Sequence


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
    from repro_torch.serve import (LUTServeEngine, TableRegistry,
                                   bundle_from_training)

    if "jsc" not in cfg.name:
        raise SystemExit(f"--arch {args.arch}: only the JSC NeuraLUT "
                         "configs have a synthetic dataset wired here")
    if args.seeds < 1:
        raise SystemExit(f"--seeds {args.seeds}: need at least one seed")
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
                                  packed_tables=packed,
                                  meta={"train_acc_q": float(acc_q)})
    if args.registry:
        path = TableRegistry(args.registry).save(cfg.name, bundle)
        print(f"saved serving-ready bundle -> {path}", flush=True)
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


class _LoaderBatches:
    """``make_batch(step)`` served by a prefetching ``ShardedLoader``,
    restarted at ``step`` whenever the caller jumps (a supervisor's
    restart): the batch of a step is the same either way.  ``rows``
    picks this rank's rows of the global batch on the host."""

    def __init__(self, make, device, rows=None):
        self.make, self.device, self.loader = make, device, None
        self.rows = rows or (lambda batch: batch)

    def __call__(self, step: int):
        import torch
        from repro_torch.data import ShardedLoader
        if self.loader is None or self.loader.step != step:
            self.close()
            self.loader = ShardedLoader(self.make, start_step=step)
        batch = self.rows({k: torch.as_tensor(v)
                           for k, v in next(self.loader).items()})
        return {k: v.to(self.device) for k, v in batch.items()}

    def close(self) -> None:
        if self.loader is not None:
            self.loader.close()
            self.loader = None


def _join_group(args):
    """(this rank's device, whether this call opened the process group).
    Joins the group the caller already opened; else opens one from
    ``torchrun``'s environment when it names more than one process
    (NCCL when every rank of the host has a card of its own, gloo when
    ranks share a card or run on the CPU); else runs alone."""
    import os

    import torch
    import torch.distributed as dist
    from repro_torch.device import resolve_device

    dev = resolve_device(args.device)
    opened = False
    if not dist.is_initialized() and int(os.environ.get("WORLD_SIZE",
                                                        "1")) > 1:
        local_world = int(os.environ.get("LOCAL_WORLD_SIZE",
                                         os.environ["WORLD_SIZE"]))
        nccl = (dev.type == "cuda"
                and local_world <= torch.cuda.device_count())
        dist.init_process_group("nccl" if nccl else "gloo",
                                init_method="env://")
        opened = True
    if dev.type == "cuda":
        local = int(os.environ.get(
            "LOCAL_RANK", dist.get_rank() if dist.is_initialized() else 0))
        dev = torch.device("cuda", local % torch.cuda.device_count())
        torch.cuda.set_device(dev)
    return dev, opened


def _mesh_config(args, world: int):
    """The reference's choice of mesh: ``--mesh single`` / ``multi`` the
    production pods, else ``--mesh-shape`` (AxB: data x model; PxAxB:
    pod x data x model), else the host default over ``world``
    processes, (max(1, n // min(n, 2)), min(n, 2))."""
    from repro_torch.config import MeshConfig
    from repro_torch.launch.mesh import mesh_config
    if args.mesh != "host":
        return mesh_config(multi_pod=args.mesh == "multi")
    if args.mesh_shape:
        shape = tuple(int(x) for x in args.mesh_shape.split("x"))
        axes = {2: ("data", "model"), 3: ("pod", "data", "model")}.get(
            len(shape))
        if axes is None:
            raise ValueError(f"--mesh-shape {args.mesh_shape}: give AxB "
                             "(data x model) or PxAxB (pod x data x model)")
        return MeshConfig(shape, axes)
    n = world
    return MeshConfig((max(1, n // min(n, 2)), min(n, 2)), ("data", "model"))


def _check_lm_inputs(cfg) -> None:
    """The launcher's batches (``lm_batch_fn``) hold tokens and labels
    only: refuse an arch whose loss needs more, before any step."""
    missing = (["frames"] if cfg.encoder is not None else []) + (
        ["patch_embeds", "positions"] if cfg.vision is not None else [])
    if missing:
        raise ValueError(
            f"--arch {cfg.name}: its loss needs {' and '.join(missing)}, "
            "which the launcher's lm_batch_fn does not make (it makes "
            "tokens and labels); the reference's launcher cannot build "
            "them either (its data.pipeline.lm_batch_fn).  Train it "
            "through train.step.make_train_step on models.api.make_batch "
            "data instead")


def train_lm_arch(args, cfg) -> Dict[str, Any]:
    """The LM branch for one parsed command line; returns the losses,
    the timings and the final carry (this rank's shards)."""
    import torch.distributed as dist
    from repro_torch.launch.mesh import make_mesh_from_config
    from repro_torch.sharding import ctx

    _check_lm_inputs(cfg)
    dev, opened = _join_group(args)
    try:
        world = dist.get_world_size() if dist.is_initialized() else 1
        mesh = make_mesh_from_config(_mesh_config(args, world), device=dev)
        with ctx.active_mesh(mesh, data_axes=mesh.data_axes):
            return _train_lm_mesh(args, cfg, mesh)
    finally:
        if opened:
            dist.destroy_process_group()


def _train_lm_mesh(args, cfg, mesh) -> Dict[str, Any]:
    import torch
    from repro_torch.checkpoint import CheckpointStore
    from repro_torch.config import ShapeConfig, TrainConfig
    from repro_torch.data import lm_batch_fn
    from repro_torch.models import api
    from repro_torch.models.layers.common import TensorSpec
    from repro_torch.optim import (adamw_init, adamw_init_spec,
                                   make_ef_int8_compressor)
    from repro_torch.runtime.fault import TrainSupervisor
    from repro_torch.sharding.spmd import (local_batch, make_mesh_train_step,
                                           opt_shardings, param_shardings,
                                           shard_tree, tree_bytes)
    from repro_torch.tree import tree_map

    dev, lead = mesh.device, mesh.rank == 0
    say = print if lead else (lambda *a, **k: None)
    say(f"mesh {mesh.shape} devices={mesh.world} ({dev}) backend="
        f"{mesh.backend or 'none'} axes={mesh.axes}: params and AdamW "
        "state sharded over the data and model axes, gathered per layer; "
        "the model axis splits attention and MLA heads, the dense FFN, "
        "MoE experts, Mamba's channels and the vocabulary", flush=True)
    tcfg = TrainConfig(lr=args.lr if args.lr is not None else 3e-4,
                       grad_accum=args.grad_accum,
                       sgdr_t0=max(50, args.steps // 4))
    shape = ShapeConfig("cli", "train", args.seq_len, args.global_batch)
    # whole on every rank from one seed, then cut: never drawn per shard
    params = api.init_params(cfg, torch.Generator().manual_seed(tcfg.seed),
                             device=dev)
    whole_bytes = (tree_bytes(params), tree_bytes(adamw_init_spec(
        tree_map(lambda p: TensorSpec(tuple(p.shape), p.dtype), params))))
    psh = param_shardings(cfg, params, mesh)
    params = shard_tree(params, psh)
    opt = adamw_init(params)
    carry_sh = (psh, opt_shardings(opt, psh))
    compress = None
    if args.compress_grads:
        ef_init, ef_compress = make_ef_int8_compressor()
        # the error-feedback residual (of the whole averaged gradient)
        # rides in a closure cell
        cell = {"ef": None}

        def compress(grads):
            if cell["ef"] is None:
                cell["ef"] = ef_init(grads)
            g2, cell["ef"] = ef_compress(grads, cell["ef"])
            return g2

    raw_step = make_mesh_train_step(cfg, tcfg, mesh, psh, shape,
                                    compress_grads=compress)
    losses, seconds = [], []
    sync = torch.cuda.synchronize if dev.type == "cuda" else (lambda: None)

    def make_step():
        def step(carry, batch):
            t0 = time.perf_counter()
            p, o, metrics = raw_step(carry[0], carry[1], batch)
            losses.append(float(metrics["loss"]))  # waits for the step
            seconds.append(time.perf_counter() - t0)
            if args.log_every and len(losses) % args.log_every == 0:
                say(f"step {len(losses)} loss={losses[-1]:.4f} "
                    f"lr={float(metrics['lr']):.2e} "
                    f"{seconds[-1] * 1e3:.0f}ms/step", flush=True)
            return (p, o), metrics
        return step

    def rows(batch):
        return local_batch(batch, mesh, cfg, shape,
                           grad_accum=tcfg.grad_accum)

    batches = _LoaderBatches(lm_batch_fn(cfg.vocab_size, args.global_batch,
                                         args.seq_len, seed=tcfg.seed), dev,
                             rows)
    if dev.type == "cuda":
        torch.cuda.reset_peak_memory_stats(dev)
    carry, start, restarts = (params, opt), 0, 0
    # the carry alone holds the first shards: a step's new carry then
    # replaces them rather than standing beside a third copy
    del params, opt
    t0 = time.perf_counter()
    try:
        if args.ckpt_dir:
            store = CheckpointStore(args.ckpt_dir, keep=3)
            sup = TrainSupervisor(store=store, make_step=make_step,
                                  make_batch=batches,
                                  ckpt_every=args.ckpt_every, mesh=mesh,
                                  shardings=carry_sh)
            start = store.latest_step() or 0
            if start:
                start, carry = store.restore(carry, shardings=carry_sh)
                say(f"resumed from step {start}", flush=True)
            out = sup.run(carry, start_step=start, num_steps=args.steps)
            carry, restarts = out["carry"], out["restarts"]
            say(f"done at step {out['step']} restarts={restarts} "
                f"loss={losses[-1] if losses else float('nan'):.4f}",
                flush=True)
        else:
            step = make_step()
            for s in range(args.steps):
                carry, _ = step(carry, batches(s))
    finally:
        batches.close()
    sync()
    wall = time.perf_counter() - t0
    # steady state: the first step (allocation, kernel selection) aside
    steady = seconds[1:] or seconds
    ms = 1e3 * sum(steady) / max(len(steady), 1)
    tokens = args.global_batch * args.seq_len
    peak = (torch.cuda.max_memory_allocated(dev) / 2 ** 30
            if dev.type == "cuda" else None)
    held = (tree_bytes(carry[0]), tree_bytes(carry[1]))
    rank_line = {"rank": mesh.rank, "world": mesh.world,
                 "coords": list(mesh.coords), "ms_per_step": ms,
                 "peak_mem_gib": peak, "param_bytes": held[0],
                 "opt_bytes": held[1], "param_bytes_whole": whole_bytes[0],
                 "opt_bytes_whole": whole_bytes[1]}
    if mesh.world > 1:
        print("mesh rank summary " + json.dumps(rank_line), flush=True)
    summary = {"arch": cfg.name, "steps": len(losses), "wall_s": wall,
               "ms_per_step": ms,
               "tokens_per_s": tokens / ms * 1e3 if ms > 0 else 0.0,
               "peak_mem_gib": peak, "first_loss": losses[0] if losses
               else None, "last_loss": losses[-1] if losses else None,
               "restarts": restarts, "mesh": list(mesh.shape),
               "world": mesh.world, "backend": mesh.backend}
    say(f"trained {len(losses)} steps in {wall:.2f} s: {ms:.2f} ms/step, "
        f"{summary['tokens_per_s']:.0f} tokens/s (batch "
        f"{args.global_batch} x seq {args.seq_len}), peak device memory "
        + (f"{peak:.3f} GiB" if peak is not None else "n/a (cpu)"),
        flush=True)
    say("lm train summary " + json.dumps(summary), flush=True)
    return dict(summary, losses=losses, carry=carry, rank=rank_line,
                shardings=carry_sh)


def parse_args(argv: Optional[Sequence[str]] = None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--arch", required=True)
    ap.add_argument("--reduced", action="store_true")
    ap.add_argument("--steps", type=int, default=100,
                    help="LM archs: training steps")
    ap.add_argument("--epochs", type=int, default=20,
                    help="NeuraLUT archs: training epochs")
    ap.add_argument("--seeds", type=int, default=1,
                    help="NeuraLUT archs: restarts trained together; the "
                         "best is kept")
    ap.add_argument("--registry", default=None,
                    help="NeuraLUT archs: save the bundle to this "
                         "TableRegistry")
    ap.add_argument("--global-batch", type=int, default=8)
    ap.add_argument("--seq-len", type=int, default=128)
    ap.add_argument("--mesh", default="host",
                    choices=["host", "single", "multi"],
                    help="LM archs: host lays the processes out as "
                         "--mesh-shape, else (n/2, 2); single and multi "
                         "are the 16x16 and 2x16x16 pods (256 and 512 "
                         "processes)")
    ap.add_argument("--mesh-shape", default=None,
                    help="e.g. 2x1 (data x model) or 2x2x1 (pod x data "
                         "x model); one process per device")
    ap.add_argument("--ckpt-dir", default=None)
    ap.add_argument("--ckpt-every", type=int, default=50)
    ap.add_argument("--grad-accum", type=int, default=1)
    ap.add_argument("--compress-grads", action="store_true")
    ap.add_argument("--lr", type=float, default=None,
                    help="default: 3e-4 for LM archs, 2e-3 for NeuraLUT")
    ap.add_argument("--log-every", type=int, default=10,
                    help="print metrics every N epochs (NeuraLUT) or "
                         "steps (LM); 0: never")
    ap.add_argument("--tpu-flags", action="store_true",
                    help="accepted for the reference's command lines; "
                         "does nothing here (XLA flags)")
    ap.add_argument("--device", default=None,
                    help="cuda (default; a rank takes card local_rank %% "
                         "count) or cpu")
    return ap.parse_args(argv)


def main(argv: Optional[Sequence[str]] = None) -> Dict[str, Any]:
    args = parse_args(argv)
    from repro_torch.config import get_config, list_archs, list_lm_archs
    if args.arch in list_lm_archs():
        return train_lm_arch(args, get_config(args.arch,
                                              reduced=args.reduced))
    if args.arch not in list_archs():
        raise SystemExit(f"--arch {args.arch}: unknown; the archs are "
                         f"{', '.join(list_archs() + list_lm_archs())}")
    return train_neuralut_arch(args, get_config(args.arch,
                                                reduced=args.reduced))


if __name__ == "__main__":
    main()
