"""Port parity: sharded serving (``repro_torch.serve.sharded`` against
``repro.serve.sharded``), mirroring tests/test_serve_sharded.py.

* Planning: ``choose_layout`` equals the reference's over sampled
  (bytes, budget, replicas) triples; the o_sharded plan's padded widths
  equal the reference's ``_pad_operands``, and its row blocks cover
  every neuron once within them; the plan is cached on the bundle and a
  new R replans; ``TableRegistry.load(shard_replicas=)`` plans at load.
* Exactness: for every chain config (reduced), both layouts over R in
  {1, 2, 3, 4, 8} logical CPU devices equal ``lut_infer.predict`` at B
  in {0, 1, R - 1, 37}; at R = 1 they equal the JAX
  ``make_sharded_forward_fn`` in process.  A LUT graph serves replicated
  exactly and refuses o_sharded.
* Wiring: ``LUTServeEngine(sharded=True)`` is exact and refuses
  ``replicas=2`` and an explicit plan; ``launch.serve --sharded --device
  cpu`` serves with 0 mismatches.

The reference's ``test_o_sharded_refuses_explicit_kernel_request`` has no
counterpart: the port has no ``use_kernel`` switch.  On CUDA tensors both
layouts always launch their kernel (K1 replicated, K3 ``lut_layer``
o_sharded), so there is no kernel request to refuse.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from hypothesis import given, settings
from hypothesis import strategies as st

from repro.serve import sharded as JS
from repro_torch.core.nl_config import UnsupportedTopology
from repro_torch.launch import serve as launch_serve
from repro_torch.serve import LUTServeEngine, TableRegistry
from repro_torch.serve import sharded as S

from test_torch_registry import bundles, configs, port_predict

torch.set_num_threads(1)

CHAINS = [("neuralut-hdr-5l", "neuralut_hdr_5l"),
          ("neuralut-jsc-2l", "neuralut_jsc_2l"),
          ("neuralut-jsc-5l", "neuralut_jsc_5l")]
GRAPHS = [("polylut-add-jsc-2l", "polylut_add_jsc_2l"),
          ("polylut-add-jsc-5l", "polylut_add_jsc_5l")]
REPLICAS = (1, 2, 3, 4, 8)


def _x(cfg, b, seed=5):
    return np.random.default_rng(seed).normal(
        0, 1, (b, cfg.in_features)).astype(np.float32)


def _pair(arch, mod, seed=0):
    return bundles(*configs(arch, mod), seed)


# ---------------------------------------------------------------------------
# planning


@settings(max_examples=60, deadline=None)
@given(total=st.integers(0, 1 << 28), budget=st.integers(1, 1 << 28),
       r=st.integers(-1, 16),
       mode=st.sampled_from(["auto", "replicated", "o_sharded", "diag"]))
def test_choose_layout_equals_reference(total, budget, r, mode):
    try:
        want = JS.choose_layout(total, budget, r, mode)
    except ValueError as e:
        with pytest.raises(ValueError, match=str(e)):
            S.choose_layout(total, budget, r, mode)
        return
    assert S.choose_layout(total, budget, r, mode) == want


@pytest.mark.parametrize("r", REPLICAS)
@pytest.mark.parametrize("arch,mod", CHAINS)
def test_pad_widths_and_row_blocks(arch, mod, r):
    pb, jb = _pair(arch, mod)
    plan = S.plan_shards(pb, r, mode="o_sharded", device="cpu")
    jb.prepack()
    pads, _, _ = JS._pad_operands(jb.cfg, jb.shift_mats, jb.packed_tables, r)
    assert plan.pad_widths == pads
    for o, o_pad, blocks, table in zip(pb.cfg.layer_widths, plan.pad_widths,
                                       plan.row_blocks, plan.tables):
        assert len(blocks) == r and blocks[0][0] == 0 and blocks[-1][1] == o
        assert all(a[1] == b[0] for a, b in zip(blocks, blocks[1:]))
        assert all(0 <= hi - lo <= o_pad // r for lo, hi in blocks)
        assert table.dtype == np.int32 and table.shape[0] == o


def test_plan_auto_selects_layout_by_budget():
    pb, _ = _pair(*CHAINS[1])
    roomy = S.plan_shards(pb, 2, device="cpu")
    assert roomy.mode == "replicated"
    assert roomy.budget_bytes == S.CPU_BUDGET_BYTES == S.device_budget("cpu")
    assert roomy.operand_bytes_per_device == roomy.operand_bytes_total
    assert roomy.tables is None  # replicated serves the bundle's operands
    tight = S.plan_shards(pb, 2, budget_bytes=1)
    assert tight.mode == "o_sharded"
    assert tight.operand_bytes_per_device < tight.operand_bytes_total
    with pytest.raises(ValueError):
        S.plan_shards(pb, 2, mode="diagonal")
    with pytest.raises(ValueError):
        S.plan_shards(pb, 0)


def test_bundle_plan_cache_and_replan():
    pb, _ = _pair(*CHAINS[1])
    p1 = pb.plan_shards(2, budget_bytes=S.CPU_BUDGET_BYTES)
    assert pb.plan_shards(2) is p1                      # cached
    assert pb.plan_shards(2, budget_bytes=S.CPU_BUDGET_BYTES) is p1
    p2 = pb.plan_shards(4, device="cpu")                # new R: re-plan
    assert p2 is not p1 and p2.num_replicas == 4
    p3 = pb.plan_shards(4, mode="o_sharded", device="cpu")
    assert p3.mode == "o_sharded" and pb.plan_shards(4) is p3
    p4 = pb.plan_shards(4, budget_bytes=123)            # new budget
    assert p4 is not p3 and p4.budget_bytes == 123


def test_registry_load_plans_shards(tmp_path):
    pb, _ = _pair(*CHAINS[1])
    reg = TableRegistry(str(tmp_path))
    reg.save("m", pb)
    loaded = reg.load("m", shard_replicas=2, shard_mode="o_sharded",
                      shard_device="cpu")
    assert loaded.shard_plan is not None
    assert loaded.shard_plan.mode == "o_sharded"
    assert loaded.shard_plan.num_replicas == 2
    assert reg.load("m").shard_plan is None             # opt-in only


def test_shard_devices_and_budget():
    pb, _ = _pair(*CHAINS[1])
    S.make_sharded_forward_fn(pb, devices=["cpu"] * 4)
    assert pb.shard_plan.num_replicas == 4
    assert pb.shard_plan.budget_bytes == S.device_budget("cpu")
    with pytest.raises(ValueError):
        S.make_sharded_forward_fn(pb, devices=[])
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="CUDA"):
            S.make_sharded_forward_fn(pb)       # the default pool is CUDA


# ---------------------------------------------------------------------------
# exactness


@pytest.mark.parametrize("r", REPLICAS)
@pytest.mark.parametrize("mode", ["replicated", "o_sharded"])
@pytest.mark.parametrize("arch,mod", CHAINS)
def test_sharded_forward_equals_predict(arch, mod, mode, r):
    pb, _ = _pair(arch, mod, seed=r)
    fwd = S.make_sharded_forward_fn(pb, devices=["cpu"] * r, mode=mode)
    assert pb.shard_plan.mode == mode and pb.shard_plan.num_replicas == r
    for b in sorted({0, 1, max(r - 1, 0), 37}):
        x = _x(pb.cfg, b, seed=b)
        got = fwd(x)
        assert got.dtype == torch.int32 and tuple(got.shape) == (b,)
        assert np.array_equal(got.numpy(), port_predict(pb, x)), (b, mode)


@pytest.mark.parametrize("mode", ["replicated", "o_sharded"])
@pytest.mark.parametrize("arch,mod", CHAINS)
def test_one_shard_equals_jax_sharded_forward(arch, mod, mode):
    pb, jb = _pair(arch, mod, seed=11)
    x = _x(pb.cfg, 29)
    want = np.asarray(JS.make_sharded_forward_fn(
        jb, mesh=jax.sharding.Mesh(np.array(jax.devices()[:1]),
                                   ("replica",)), mode=mode)(jnp.asarray(x)))
    got = S.make_sharded_forward_fn(pb, devices=["cpu"], mode=mode)(x)
    assert np.array_equal(got.numpy(), want)


@pytest.mark.parametrize("r", (1, 3))
@pytest.mark.parametrize("arch,mod", GRAPHS)
def test_graph_replicated_exact_o_sharded_refused(arch, mod, r):
    pb, _ = _pair(arch, mod, seed=7)
    fwd = S.make_sharded_forward_fn(pb, devices=["cpu"] * r,
                                    mode="replicated")
    for b in (0, 1, 37):
        x = _x(pb.cfg, b, seed=b)
        assert np.array_equal(fwd(x).numpy(), port_predict(pb, x))
    with pytest.raises(UnsupportedTopology, match="o_sharded"):
        S.make_sharded_forward_fn(pb, devices=["cpu"] * r,
                                  mode="o_sharded")
    with pytest.raises(UnsupportedTopology):   # auto over budget: o_sharded
        S.plan_shards(pb, r, budget_bytes=1)


def test_degenerate_chain_graph_o_sharded():
    pb, _ = _pair(*CHAINS[1], seed=4)
    gb = dataclasses.replace(
        pb, cfg=pb.cfg.graph(), tables=[[t] for t in pb.tables],
        statics=[{"conns": [s["conn"]]} for s in pb.statics])
    x = _x(pb.cfg, 37)
    got = S.make_sharded_forward_fn(gb, devices=["cpu"] * 3,
                                    mode="o_sharded")(x)
    assert np.array_equal(got.numpy(), port_predict(pb, x))


# ---------------------------------------------------------------------------
# wiring


@pytest.mark.parametrize("mode", ["auto", "replicated", "o_sharded"])
def test_engine_sharded_mode_bit_exact(mode):
    pb, _ = _pair(*CHAINS[2], seed=3)
    x = _x(pb.cfg, 40, seed=4)
    with LUTServeEngine(pb, sharded=True, shard_mode=mode,
                        devices=["cpu"] * 3) as eng:
        eng.warmup()
        got = eng.predict(x)
        futs = [eng.submit(x[i:i + 3]) for i in range(0, 40, 3)]
        parts = np.concatenate([f.result() for f in futs])
    want = port_predict(pb, x)
    assert np.array_equal(got, want) and np.array_equal(parts, want)
    assert eng.replicas == 1 and eng.sharded
    assert pb.shard_plan.num_replicas == 3
    assert pb.shard_plan.mode == ("replicated" if mode == "auto" else mode)
    with pytest.raises(ValueError, match="replicas=1"):
        LUTServeEngine(pb, sharded=True, replicas=2, device="cpu")
    with pytest.raises(ValueError, match="plan="):
        LUTServeEngine(pb, sharded=True, device="cpu", plan=eng.plan)


@pytest.mark.parametrize("arch", ["neuralut-jsc-2l", "polylut-add-jsc-2l"])
def test_launch_serve_sharded_cpu(arch, tmp_path, capsys):
    argv = ["--arch", arch, "--reduced", "--epochs", "1",
            "--requests", "6", "--batch", "9", "--registry", str(tmp_path),
            "--device", "cpu", "--sharded"]
    res = launch_serve.main(argv)
    out = capsys.readouterr().out
    assert res["mismatches"] == 0 and res["shard_plan"].mode == "replicated"
    assert res["shard_plan"].num_replicas == 1
    assert "sharded: ShardPlan(replicas=1, mode=replicated" in out
    res = launch_serve.main(argv)                      # from the registry
    assert "no retraining" in capsys.readouterr().out
    assert res["mismatches"] == 0
