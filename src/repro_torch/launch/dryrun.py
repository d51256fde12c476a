"""Dry run of every (arch x shape x mesh) cell, costed per rank as the
port runs it (port of ``repro.launch.dryrun``).

The reference lowers and compiles each cell's step on 256 or 512
placeholder devices and reads per-device costs from the partitioned
HLO.  The port runs one process per device (``sharding.spmd``), so a
cell is costed as one rank's step: rank 0 of a ``CountingMesh`` of the
cell's mesh, its shards of the params and AdamW state by
``param_partition``, its rows of the batch by ``batch_partition`` (its
shard of the decode state by ``cache_partition``), all on the meta
device, through the unchanged ``make_mesh_train_step`` (train and
prefill cells, as the reference's) or ``make_mesh_serve_step``
(decode).  ``roofline.counter.count_step`` counts the step; nothing is
allocated.

The counts are the port's own, not the reference's: a rank gathers
each layer's params over the data axes and computes its block of what
the model axis splits (attention and MLA heads, whisper's encoder and
cross attention among them, dense FFN units, MoE experts and shared
experts, Mamba's channels, the vocabulary), in decode too, on its block
of the caches; xLSTM layers stay whole over the model axis, so their
cells count about the model axis's size times the reference's
per-device work there (ROADMAP.md, Queue A).

A record has the reference's keys.  ``lower_s`` is the seconds to build
the specs, shardings and meta shards; ``compile_s`` those of the
counted runs.  ``memory``: ``arguments_per_device`` the bytes of the
rank's shards and rows, ``temp_per_device`` the live peak of what the
step made, ``output_per_device`` its results', ``peak_per_device`` the
two first summed.  A cell whose peak exceeds ``Hardware.hbm_bytes`` is
``ok``: the record says it does not fit.  ``hlo_bytes`` is None (no
HLO).  Records go to ``results/dryrun_torch/<cell>.json``.

Usage:
    python -m repro_torch.launch.dryrun --arch llama3-8b --shape train_4k --mesh single
    python -m repro_torch.launch.dryrun --all --mesh both
    python -m repro_torch.launch.dryrun --arch llama3-8b --shape train_4k --mesh-shape 1x2
"""
from __future__ import annotations

import argparse
import dataclasses
import json
import time
import traceback
from pathlib import Path

import torch

from repro_torch.config import SHAPES, MeshConfig, TrainConfig, get_config
from repro_torch.launch.mesh import mesh_config
from repro_torch.models import api
from repro_torch.roofline.analysis import (MemoryStats, _peak_memory,
                                           model_flops_estimate, param_count,
                                           roofline_report)
from repro_torch.roofline.counter import CountingMesh, count_step
from repro_torch.sharding.partition import (cache_partition, named,
                                            param_partition)
from repro_torch.sharding.spmd import (local_batch, make_mesh_serve_step,
                                       make_mesh_train_step, opt_shardings,
                                       shard_tree, tree_bytes)
from repro_torch.tree import tree_map

RESULTS_DIR = Path(__file__).resolve().parents[3] / "results" / "dryrun_torch"

LM_ARCHS = (
    "deepseek-v2-lite-16b", "qwen2-moe-a2.7b", "xlstm-350m",
    "jamba-v0.1-52b", "whisper-small", "qwen2-vl-72b", "granite-34b",
    "gemma3-12b", "llama3-8b", "yi-9b",
)
SHAPE_ORDER = ("train_4k", "prefill_32k", "decode_32k", "long_500k")
# A sequential loop (sLSTM steps, mLSTM, Mamba, attention query and loss
# chunks) of counter.LONG_LOOPS steps or more is counted from runs of
# LOOP_STEPS, + 1 and + 2 steps (roofline.counter.count_step)
LOOP_STEPS = 4
META = torch.device("meta")


def cell_id(arch: str, shape: str, mesh: str, variant: str = "") -> str:
    base = f"{arch}__{shape}__{mesh}"
    return f"{base}__{variant}" if variant else base


def _meta(spec_tree):
    """Meta tensors of a spec tree (``None`` kept)."""
    return tree_map(lambda s: None if s is None else torch.empty(
        s.shape, dtype=s.dtype, device=META), spec_tree)


def cost_cell(cfg, shape, mcfg, tcfg, *, loop_steps=LOOP_STEPS):
    """One rank's step of the cell on the meta device -> (StepAnalysis,
    MemoryStats, lower seconds, count seconds)."""
    t0 = time.time()
    mesh = CountingMesh(mcfg)
    spec = api.param_spec(cfg, model_axis=mcfg.shape[-1])
    psh = named(mesh, param_partition(cfg, spec, mcfg))
    params = shard_tree(_meta(spec), psh)
    ins = api.input_specs(cfg, shape)
    if shape.kind in ("train", "prefill"):
        from repro_torch.optim.adamw import adamw_init_spec
        opt_spec = adamw_init_spec(spec)
        opt = shard_tree(_meta(opt_spec), opt_shardings(opt_spec, psh))
        batch = local_batch(_meta(ins), mesh, cfg, shape,
                            grad_accum=tcfg.grad_accum)
        step = make_mesh_train_step(cfg, tcfg, mesh, psh, shape)
        args = (params, opt, batch)
    else:
        csh = named(mesh, cache_partition(cfg, shape, mcfg, ins["state"]))
        state = shard_tree(_meta(ins["state"]), csh)
        token = local_batch({"token": _meta(ins["token"])}, mesh, cfg,
                            shape)["token"]
        step = make_mesh_serve_step(cfg, mesh, psh, csh, shape)
        args = (params, state, token)
    t1 = time.time()
    ana = count_step(step, *args, loop_steps=loop_steps)
    t2 = time.time()
    mem = MemoryStats(argument_size_in_bytes=float(tree_bytes(list(args))),
                      output_size_in_bytes=ana.output_bytes,
                      temp_size_in_bytes=ana.peak_bytes)
    return ana, mem, t1 - t0, t2 - t1


def _mesh(name: str) -> MeshConfig:
    """"single" / "multi" (the production pods), or a shape "AxB" (data
    x model) / "PxAxB" (pod x data x model)."""
    if name in ("single", "multi"):
        return mesh_config(multi_pod=(name == "multi"))
    shape = tuple(int(n) for n in name.split("x"))
    axes = {2: ("data", "model"), 3: ("pod", "data", "model")}[len(shape)]
    return MeshConfig(shape, axes)


def _config(arch, cfg_overrides):
    cfg = get_config(arch)
    if cfg_overrides:
        cfg_overrides = dict(cfg_overrides)
        moe_sharding = cfg_overrides.pop("moe_sharding", None)
        cfg = dataclasses.replace(cfg, **cfg_overrides)
        if moe_sharding and cfg.moe is not None:
            cfg = dataclasses.replace(
                cfg, moe=dataclasses.replace(cfg.moe, sharding=moe_sharding))
            cfg_overrides["moe_sharding"] = moe_sharding
    return cfg, cfg_overrides


def run_cell(arch: str, shape_name: str, mesh_name: str, *,
             force: bool = False, save_hlo: bool = False,
             overrides=None, cfg_overrides=None, variant: str = "",
             out_dir=None) -> dict:
    """The cell's record, from ``out_dir`` (default ``RESULTS_DIR``) if
    it is there and not ``force``, else costed and written there.
    ``save_hlo`` is accepted for the reference's flags; there is no
    HLO to save."""
    out_dir = Path(out_dir) if out_dir is not None else RESULTS_DIR
    out_dir.mkdir(parents=True, exist_ok=True)
    out_path = out_dir / (cell_id(arch, shape_name, mesh_name, variant)
                          + ".json")
    if out_path.exists() and not force:
        return json.loads(out_path.read_text())

    cfg, cfg_overrides = _config(arch, cfg_overrides)
    shape = SHAPES[shape_name]
    mcfg = _mesh(mesh_name)
    record = {
        "arch": arch, "shape": shape_name, "mesh": mesh_name,
        "mesh_shape": list(mcfg.shape), "status": "running",
        "variant": variant, "cfg_overrides": cfg_overrides or {},
    }

    skip = api.runnable_cells(cfg, [shape])[shape_name]
    if skip:
        record.update(status="skip", reason=skip)
        out_path.write_text(json.dumps(record, indent=2))
        return record

    try:
        tkw = dict(layer_mode="scan", remat="full")
        tkw.update(overrides or {})
        ana, mem, lower_s, count_s = cost_cell(cfg, shape, mcfg,
                                               TrainConfig(**tkw))
        rep = roofline_report(
            arch=arch, shape=shape_name, mesh=mesh_name,
            num_devices=mcfg.num_devices, analysis=ana, memstats=mem,
            model_flops=model_flops_estimate(cfg, shape),
            bf16_model=cfg.dtype == "bfloat16")
        record.update(
            status="ok",
            lower_s=round(lower_s, 1),
            compile_s=round(count_s, 1),
            num_devices=mcfg.num_devices,
            param_count=param_count(cfg),
            roofline=rep.to_dict(),
            memory={
                "peak_per_device": _peak_memory(mem),
                "arguments_per_device": mem.argument_size_in_bytes,
                "temp_per_device": mem.temp_size_in_bytes,
                "output_per_device": mem.output_size_in_bytes,
            },
            hlo_bytes=None,
        )
    except Exception as e:  # noqa: BLE001 — record the failure, keep sweeping
        record.update(status="error", error=f"{type(e).__name__}: {e}",
                      traceback=traceback.format_exc()[-4000:])
    out_path.write_text(json.dumps(record, indent=2))
    return record


def main() -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default=None)
    ap.add_argument("--shape", default=None)
    ap.add_argument("--mesh", default="single", choices=["single", "multi", "both"])
    ap.add_argument("--all", action="store_true")
    ap.add_argument("--force", action="store_true")
    ap.add_argument("--save-hlo", action="store_true")
    ap.add_argument("--variant", default="",
                    help="suffix for §Perf experiment records")
    ap.add_argument("--attn-impl", default=None,
                    choices=[None, "chunked", "flash"])
    ap.add_argument("--moe-dispatch", default=None,
                    choices=[None, "dense", "sparse_capacity"])
    ap.add_argument("--head-dim-sharding", action="store_true")
    ap.add_argument("--seq-shard-residual", action="store_true")
    ap.add_argument("--attn-chunk", type=int, default=0)
    ap.add_argument("--fused-qkv", action="store_true")
    ap.add_argument("--moe-sharding", default=None, choices=[None, "ep", "tp"])
    ap.add_argument("--remat", default=None, choices=[None, "full", "dots",
                                                      "none"])
    ap.add_argument("--mesh-shape", default=None,
                    help="a mesh of this shape instead of --mesh: AxB "
                         "(data x model) or PxAxB (pod x data x model)")
    ap.add_argument("--out-dir", default=None,
                    help=f"where records go (default {RESULTS_DIR})")
    args = ap.parse_args()

    cfg_over = {}
    if args.attn_impl:
        cfg_over["attn_impl"] = args.attn_impl
    if args.moe_dispatch:
        cfg_over["moe_dispatch"] = args.moe_dispatch
    if args.head_dim_sharding:
        cfg_over["head_dim_sharding"] = True
    if args.seq_shard_residual:
        cfg_over["seq_shard_residual"] = True
    if args.attn_chunk:
        cfg_over["attn_chunk"] = args.attn_chunk
    if args.fused_qkv:
        cfg_over["fused_qkv"] = True
    if args.moe_sharding:
        cfg_over["moe_sharding"] = args.moe_sharding
    overrides = {"remat": args.remat} if args.remat else None

    archs = LM_ARCHS if (args.all or not args.arch) else [args.arch]
    shapes = SHAPE_ORDER if (args.all or not args.shape) else [args.shape]
    meshes = ["single", "multi"] if args.mesh == "both" else [args.mesh]
    if args.mesh_shape:
        meshes = [args.mesh_shape]

    n_ok = n_skip = n_err = 0
    t_all = time.time()
    for mesh_name in meshes:
        for arch in archs:
            for shape_name in shapes:
                t0 = time.time()
                rec = run_cell(arch, shape_name, mesh_name, force=args.force,
                               save_hlo=args.save_hlo, variant=args.variant,
                               cfg_overrides=cfg_over or None,
                               overrides=overrides, out_dir=args.out_dir)
                dt = time.time() - t0
                st = rec["status"]
                n_ok += st == "ok"
                n_skip += st == "skip"
                n_err += st == "error"
                extra = ""
                if st == "ok":
                    r = rec["roofline"]
                    peak = rec["memory"]["peak_per_device"]
                    extra = (f"bottleneck={r['bottleneck']} "
                             f"frac={r['roofline_fraction']:.3f} "
                             f"peak={0 if peak is None else peak/2**30:.2f}GiB")
                elif st == "error":
                    extra = rec["error"][:160]
                print(f"[{cell_id(arch, shape_name, mesh_name, args.variant)}]"
                      f" {st} ({dt:.0f}s) {extra}", flush=True)
    print(f"grid seconds: {time.time() - t_all:.1f}", flush=True)
    print(f"done: ok={n_ok} skip={n_skip} err={n_err}", flush=True)


if __name__ == "__main__":
    main()
