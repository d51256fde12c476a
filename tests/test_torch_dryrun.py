"""The port's dry run (``repro_torch.launch.dryrun``): one rank's step of
a cell counted on the meta device.

* ``cost_cell`` runs on reduced configs (dense, MoE, xLSTM, Mamba,
  enc-dec; train and decode) over the meshes (2, 1), (1, 2), (2, 2) and
  (2, 2, 2), and every tensor any op makes in it is on the meta device;
* one production cell at full width (llama3-8b ``decode_32k`` on the
  single pod) runs through ``run_cell`` and its record has the
  reference's keys (the committed
  ``results/dryrun/llama3-8b__train_4k__single.json``), key for key;
* ``long_500k`` of a full-attention arch skips with the reference's
  reason;
* the reference's ``repro.launch.report``, pointed at the port's
  records, renders the same text as the port's report;
* ``CountingMesh``'s collectives (op, bytes, group size, in order) equal
  those that a real two-process gloo ``ProcessMesh`` issues for the same
  training and decode steps at 2x1 and 1x2;
* the loop extension (``count_step(loop_steps=4)``) equals the full run
  field for field on one reduced mLSTM, sLSTM and Mamba layer at
  sequences whose loops are long enough to extend (``LONG_LOOPS``).
"""
import dataclasses
import json
import os
import time
from pathlib import Path

import pytest
import torch
from torch.utils._python_dispatch import TorchDispatchMode

from repro_torch.config import MeshConfig, ShapeConfig, TrainConfig, get_config
from repro_torch.launch import dryrun

torch.set_num_threads(1)

ROOT = Path(__file__).resolve().parents[1]
MESHES = {"2x1": ((2, 1), ("data", "model")),
          "1x2": ((1, 2), ("data", "model")),
          "2x2": ((2, 2), ("data", "model")),
          "2x2x2": ((2, 2, 2), ("pod", "data", "model"))}
CELLS = [("llama3-8b", "train"), ("qwen2-moe-a2.7b", "train"),
         ("xlstm-350m", "decode"), ("jamba-v0.1-52b", "decode"),
         ("whisper-small", "train")]
B, S = 4, 32
TIMEOUT_S = 180


class _Devices(TorchDispatchMode):
    """The devices of every tensor any op returns."""

    def __init__(self):
        super().__init__()
        self.devices = set()

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        out = func(*args, **(kwargs or {}))
        for t in (out if isinstance(out, (list, tuple)) else [out]):
            if isinstance(t, torch.Tensor):
                self.devices.add(t.device.type)
        return out


@pytest.mark.parametrize("mesh", sorted(MESHES))
@pytest.mark.parametrize("arch,kind", CELLS)
def test_cost_cell_runs_on_meta_over_small_meshes(arch, kind, mesh):
    shape, axes = MESHES[mesh]
    spy = _Devices()
    with spy:
        ana, mem, _, _ = dryrun.cost_cell(
            get_config(arch, reduced=True), ShapeConfig("c", kind, S, B),
            MeshConfig(shape, axes), TrainConfig())
    assert spy.devices == {"meta"}
    assert ana.dot_flops > 0 and ana.hbm_bytes > 0 and ana.peak_bytes > 0
    assert mem.argument_size_in_bytes > 0
    if kind == "train":     # the gradient average over the data axes
        assert ("all-reduce" in ana.collective_breakdown) == (shape[-2] > 1)


def _keys(rec):
    return {k: sorted(v) if k in ("roofline", "memory") else None
            for k, v in rec.items()}


def test_a_production_cell_runs_and_has_the_reference_keys(tmp_path):
    spy = _Devices()
    with spy:
        rec = dryrun.run_cell("llama3-8b", "decode_32k", "single",
                              out_dir=tmp_path)
    assert spy.devices == {"meta"}
    assert rec["status"] == "ok", rec.get("error")
    ref = json.loads((ROOT / "results" / "dryrun" /
                      "llama3-8b__train_4k__single.json").read_text())
    assert _keys(rec) == _keys(ref)
    assert sorted(rec) == sorted(ref)
    assert rec["num_devices"] == 256 and rec["mesh_shape"] == [16, 16]
    m = rec["memory"]
    assert m["peak_per_device"] == (m["arguments_per_device"]
                                    + m["temp_per_device"])
    on_disk = json.loads((tmp_path / "llama3-8b__decode_32k__single.json")
                         .read_text())
    assert on_disk == rec


def test_long_500k_skips_with_the_reference_reason(tmp_path):
    from repro.config import SHAPES as J_SHAPES
    from repro.config import get_config as j_get_config
    from repro.models import api as JA
    rec = dryrun.run_cell("llama3-8b", "long_500k", "multi", out_dir=tmp_path)
    want = JA.runnable_cells(j_get_config("llama3-8b"),
                             [J_SHAPES["long_500k"]])["long_500k"]
    assert rec["status"] == "skip" and rec["reason"] == want and want


def test_reference_report_renders_the_port_records(tmp_path, monkeypatch):
    from repro.launch import report as JR
    from repro_torch.launch import report as PR
    rec = dryrun.run_cell("xlstm-350m", "decode_32k", "single",
                          out_dir=tmp_path)
    dryrun.run_cell("llama3-8b", "long_500k", "single", out_dir=tmp_path)
    dryrun.run_cell("gemma3-12b", "decode_32k", "multi", out_dir=tmp_path)
    (tmp_path / "xlstm-350m__decode_32k__single__v.json").write_text(
        json.dumps(dict(rec, variant="v")))
    monkeypatch.setattr(JR, "RESULTS", tmp_path)
    monkeypatch.setattr(PR, "RESULTS", tmp_path)
    for mesh in ("single", "multi"):
        assert PR.roofline_table(mesh) == JR.roofline_table(mesh)
        assert PR.dryrun_table(mesh) == JR.dryrun_table(mesh)
    assert PR.variant_table() == JR.variant_table()
    assert "xlstm-350m" in PR.roofline_table("single")
    assert "| v |" in PR.variant_table()


# --- the collectives a rank issues: CountingMesh against gloo ----------

PLAN_ARCH = "qwen2-moe-a2.7b"   # MoE: the aux loss's statistics too


def _plan_shape(kind):
    return ShapeConfig("p", kind, S, B)


def _real_plans(mesh_shape):
    """The collectives of one training and one decode step of reduced
    PLAN_ARCH over the open gloo group laid out as ``mesh_shape``."""
    from repro_torch.models import api
    from repro_torch.models.layers.common import zeros_from_spec
    from repro_torch.optim import adamw_init
    from repro_torch.sharding.partition import cache_partition, named
    from repro_torch.sharding.spmd import (ProcessMesh, local_batch,
                                           make_mesh_serve_step,
                                           make_mesh_train_step,
                                           param_shardings, shard_tree)

    class Recording(ProcessMesh):
        plan = None

        def all_reduce(self, t, op, axes):
            g = self.group(axes)
            if g is not None:
                self.plan.append(("all-reduce", t.numel() * t.element_size(),
                                  len(g[1])))
            return super().all_reduce(t, op, axes)

        def all_gather(self, t, axes):
            g = self.group(axes)
            if g is not None:
                self.plan.append(("all-gather", len(g[1]) * t.numel()
                                  * t.element_size(), len(g[1])))
            return super().all_gather(t, axes)

    from repro_torch.models.layers.common import init_from_spec
    cfg = get_config(PLAN_ARCH, reduced=True)
    mesh = Recording(MeshConfig(mesh_shape, ("data", "model")))
    # the dry run's tree: experts padded to the model axis's size
    params = init_from_spec(api.param_spec(cfg, model_axis=mesh_shape[-1]),
                            torch.Generator().manual_seed(0))
    psh = param_shardings(cfg, params, mesh)
    plans = {}
    shape = _plan_shape("train")
    batch = api.make_batch(cfg, shape, torch.Generator().manual_seed(1))
    mesh.plan = []
    step = make_mesh_train_step(cfg, TrainConfig(), mesh, psh, shape)
    ps = shard_tree(params, psh)
    step(ps, adamw_init(ps), local_batch(batch, mesh, cfg, shape))
    plans["train"] = mesh.plan
    shape = _plan_shape("decode")
    state = zeros_from_spec(api.decode_state_spec(cfg, B, S))
    csh = named(mesh, cache_partition(cfg, shape, mesh.config, state))
    tok = torch.zeros((B, 1), dtype=torch.int32)
    mesh.plan = []
    make_mesh_serve_step(cfg, mesh, psh, csh, shape)(
        ps, shard_tree(state, csh),
        local_batch({"token": tok}, mesh, cfg, shape)["token"])
    plans["decode"] = mesh.plan
    return plans


def _plan_worker(rank, world, init, out_dir):
    import torch.distributed as dist
    torch.set_num_threads(1)
    dist.init_process_group("gloo", init_method=init, world_size=world,
                            rank=rank)
    out = {}
    try:
        for shape in ((2, 1), (1, 2)):
            out["x".join(map(str, shape))] = _real_plans(shape)
    finally:
        dist.destroy_process_group()
    with open(os.path.join(out_dir, f"rank{rank}.json"), "w") as f:
        json.dump(out, f)


def test_counting_mesh_plan_equals_a_real_gloo_mesh(tmp_path):
    import torch.multiprocessing as mp
    pctx = mp.start_processes(
        _plan_worker, args=(2, f"file://{tmp_path}/rdzv", str(tmp_path)),
        nprocs=2, join=False, start_method="spawn")
    deadline = time.time() + TIMEOUT_S
    while not pctx.join(timeout=max(1.0, deadline - time.time())):
        if time.time() > deadline:
            for p in pctx.processes:
                p.kill()
            pytest.fail(f"2 ranks did not finish in {TIMEOUT_S} s")
    real = json.loads((tmp_path / "rank0.json").read_text())
    cfg = get_config(PLAN_ARCH, reduced=True)
    for name, shape in (("2x1", (2, 1)), ("1x2", (1, 2))):
        for kind in ("train", "decode"):
            ana, _, _, _ = dryrun.cost_cell(
                cfg, _plan_shape(kind), MeshConfig(shape, ("data", "model")),
                TrainConfig())
            got = [[op, int(b), g] for op, b, g, _ in ana.per_collective]
            assert got == real[name][kind], (name, kind)
            assert got, (name, kind)


# --- the loop extension against the full run ---------------------------


def _one_mixer(arch, mixer):
    """The reduced arch with every layer ``mixer``'s (its FFN kept)."""
    cfg = get_config(arch, reduced=True)
    spec = next(p for p in cfg.pattern if p.mixer == mixer)
    return dataclasses.replace(cfg, num_layers=1, pattern=(spec,))


@pytest.mark.parametrize("arch,mixer,seq", [
    ("xlstm-350m", "mlstm", 33 * 128),      # 33 chunks of 128
    ("xlstm-350m", "slstm", 40),            # 40 steps
    ("jamba-v0.1-52b", "mamba", 33 * 256)])  # 33 chunks of 256
def test_loop_extension_equals_the_full_run(arch, mixer, seq):
    args = (_one_mixer(arch, mixer), ShapeConfig("l", "train", seq, 1),
            MeshConfig((1, 1), ("data", "model")), TrainConfig())
    ext, mem_ext, _, _ = dryrun.cost_cell(*args, loop_steps=4)
    full, mem_full, _, _ = dryrun.cost_cell(*args, loop_steps=None)
    assert len(ext.loops) == 1 and not full.loops
    assert dataclasses.replace(ext, loops={}) == full
    assert mem_ext == mem_full
