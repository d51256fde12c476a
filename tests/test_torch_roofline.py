"""Port parity of the roofline's pure parts (``repro_torch.roofline``)
against the reference's ``repro.roofline``:

* ``param_count``, ``active_param_count`` and ``model_flops_estimate``
  over the ten LM archs of the reference's dry run (listed here:
  importing ``repro.launch.dryrun`` sets its 512-device ``XLA_FLAGS``),
  full and reduced, and its four shapes: equal;
* ``RooflineReport.finish``: the same derived fields as the reference's
  dataclass finished on a ``Hardware`` of the port's H100 figures, from
  the same raw fields (exact: the same float arithmetic);
* the ring rules per collective (``counter.collective_cost``) against
  ``analyze_hlo`` on a crafted HLO of each of the five collectives at
  group sizes 2, 4 and 8 (as tests/test_roofline.py crafts one);
* ``CountingMesh``: its collectives record the real mesh's shapes and
  return tensors of the real ones' shapes.
"""
import dataclasses

import numpy as np
import pytest
import torch

from repro.config import SHAPES as J_SHAPES
from repro.config import get_config as j_get_config
from repro.roofline import analysis as JAN
from repro.roofline.hlo import analyze_hlo
from repro_torch.config import SHAPES, MeshConfig, get_config
from repro_torch.roofline import HW, Hardware, RooflineReport, analysis
from repro_torch.roofline.counter import (COLLECTIVES, CountingMesh,
                                          collective_cost, count_step)

LM_ARCHS = (
    "deepseek-v2-lite-16b", "qwen2-moe-a2.7b", "xlstm-350m",
    "jamba-v0.1-52b", "whisper-small", "qwen2-vl-72b", "granite-34b",
    "gemma3-12b", "llama3-8b", "yi-9b",
)
SHAPE_ORDER = ("train_4k", "prefill_32k", "decode_32k", "long_500k")


@pytest.mark.parametrize("reduced", [False, True], ids=["full", "reduced"])
@pytest.mark.parametrize("arch", LM_ARCHS)
def test_param_counts_and_model_flops_equal_the_reference(arch, reduced):
    cfg = get_config(arch, reduced=reduced)
    jcfg = j_get_config(arch, reduced=reduced)
    assert analysis.param_count(cfg) == JAN.param_count(jcfg)
    assert analysis.active_param_count(cfg) == JAN.active_param_count(jcfg)
    for name in SHAPE_ORDER:
        assert analysis.model_flops_estimate(cfg, SHAPES[name]) == \
            JAN.model_flops_estimate(jcfg, J_SHAPES[name])


def _raw(rng):
    return dict(
        arch="a", shape="s", mesh="m", num_devices=int(rng.choice([1, 256,
                                                                   512])),
        cost_flops_raw=float(rng.uniform(1e12, 1e16)),
        cost_bytes_raw=float(rng.uniform(1e9, 1e13)),
        dot_flops=float(rng.uniform(1e12, 1e16)),
        hbm_bytes=float(rng.uniform(1e9, 1e13)),
        collective_bytes=float(rng.uniform(0, 1e12)),
        collective_breakdown={"all-gather": 1.0},
        peak_memory_bytes=float(rng.uniform(1e9, 1e11)),
        argument_bytes=float(rng.uniform(1e8, 1e10)),
        model_flops=float(rng.uniform(1e15, 1e18)))


@pytest.mark.parametrize("seed", range(4))
def test_finish_equals_the_reference_on_the_h100_figures(seed):
    hw = JAN.Hardware(name=HW.name, peak_flops=HW.peak_flops,
                      hbm_bw=HW.hbm_bw, ici_bw=HW.ici_bw,
                      hbm_bytes=HW.hbm_bytes)
    raw = _raw(np.random.default_rng(seed))
    got = RooflineReport(**raw).finish(HW).to_dict()
    want = JAN.RooflineReport(**raw).finish(hw).to_dict()
    assert got == want


def test_hardware_keeps_the_reference_fields():
    ref = {f.name for f in dataclasses.fields(JAN.Hardware)}
    assert ref <= {f.name for f in dataclasses.fields(Hardware)}
    assert {f.name for f in dataclasses.fields(RooflineReport)} == \
        {f.name for f in dataclasses.fields(JAN.RooflineReport)}


_HLO = """\
HloModule c

%add (x: f32[], y: f32[]) -> f32[] {{
  %x = f32[] parameter(0)
  %y = f32[] parameter(1)
  ROOT %a = f32[] add(%x, %y)
}}

ENTRY %main (p: f32[{n},16]) -> f32[{m},16] {{
  %p = f32[{n},16]{{1,0}} parameter(0)
  ROOT %c = f32[{m},16]{{1,0}} {op}(%p), channel_id=1, replica_groups=[{r},{g}]<=[{w}]{extra}
}}
"""


@pytest.mark.parametrize("g", [2, 4, 8])
@pytest.mark.parametrize("op", COLLECTIVES)
def test_ring_rules_equal_analyze_hlo(op, g):
    n = 8
    m = {"all-gather": n * g, "reduce-scatter": n // g}.get(op, n)
    extra = {"all-reduce": ", to_apply=%add",
             "reduce-scatter": ", dimensions={0}, to_apply=%add",
             "all-gather": ", dimensions={0}",
             "all-to-all": ", dimensions={0}",
             "collective-permute": ""}[op]
    if op == "collective-permute":
        text = _HLO.format(n=n, m=m, op=op, r=1, g=g, w=g, extra=extra)
        text = text.replace(f", replica_groups=[1,{g}]<=[{g}]",
                            ", source_target_pairs={{0,1}}")
    else:
        text = _HLO.format(n=n, m=m, op=op, r=8 // g, g=g, w=8, extra=extra)
    ana = analyze_hlo(text, num_partitions=g)
    assert ana.per_collective, text
    assert collective_cost(op, m * 16 * 4, g) == ana.collective_bytes
    assert collective_cost(op, m * 16 * 4, 1) == 0.0


def test_counting_mesh_records_what_a_rank_moves():
    mesh = CountingMesh(MeshConfig((2, 4), ("data", "model")))
    assert mesh.coords == (0, 0) and mesh.world == 8
    t = torch.empty((3, 5), dtype=torch.bfloat16, device="meta")
    parts = mesh.all_gather(t, "model")
    assert len(parts) == 4 and all(p.shape == t.shape for p in parts)
    s = mesh.all_reduce(t.float(), "sum", ("data",))
    assert s.shape == t.shape and s.dtype == torch.float32
    assert mesh.all_gather(t, ()) == [t]
    assert mesh.plan == [("all-gather", 4 * 30, 4), ("all-reduce", 60, 2)]
    assert mesh.any(True) and not mesh.any(False)

    def step(x):
        return torch.cat(mesh.all_gather(x @ x.t(), ("data", "model")))

    ana = count_step(step, torch.empty((4, 6), device="meta"))
    assert ana.dot_flops == 2 * 4 * 4 * 6 and ana.dot_count == 1
    assert ana.collective_breakdown == {
        "all-gather": collective_cost("all-gather", 8 * 64, 8)}
    assert ana.per_collective == [("all-gather", 8 * 64.0, 8, 1.0)]
    # the eight gathered blocks (the mm's result dies with the call) and
    # the cat of them, live together
    assert ana.peak_bytes == 8 * 64 + 8 * 64 and ana.output_bytes == 8 * 64


def _two_loops(x, w):
    """Two kinds of sequential loop in one step, with a backward: a
    recurrence over x's 64 steps, then a running sum over 32 chunks of
    its outputs."""
    from repro_torch.models.layers.common import sequential_loop
    outs, sums = [], []
    with sequential_loop("steps", x.shape[1]) as steps:
        xs = steps.pieces(x, 1)
        h = torch.zeros_like(xs[0])
        for t in steps:
            h = torch.tanh(h @ w + xs[t])
            outs.append(h)
    y = steps.join(outs, 1)
    with sequential_loop("chunks", y.shape[1] // 2) as chunks:
        parts = chunks.pieces(y, 1, 2)
        g = torch.zeros_like(parts[0][:, 0])
        for c in chunks:
            g = g + parts[c].sum(1) @ w
            sums.append(g)
    loss = chunks.join(sums, 1).square().sum()
    return torch.autograd.grad(loss, (x, w))


def test_loop_extension_over_two_kinds_equals_the_full_run():
    x = torch.empty((3, 64, 8), device="meta", requires_grad=True)
    w = torch.empty((8, 8), device="meta", requires_grad=True)
    ext = count_step(_two_loops, x, w, loop_steps=4)
    full = count_step(_two_loops, x, w)
    assert ext.loops == {"steps": 64, "chunks": 32} and not full.loops
    assert dataclasses.replace(ext, loops={}) == full
    # a forward and two gradient matmuls a step, but none for the first
    # step's constant state
    assert full.dot_count == 64 * 3 - 1 + 32 * 3
    with pytest.raises(ValueError, match="at least 4"):
        count_step(_two_loops, x, w, loop_steps=3)
