"""Port parity: the per-layer lookup K3 (``kernels/lut_gather``) and the
per-layer serving route (``CascadeExec`` route ``layer``).

Integer paths, so every comparison is bit for bit: the port's plain
version against the JAX Pallas kernel in interpret mode and the JAX
plain gather, and the port's per-layer serving forward against the JAX
per-layer forward with the Pallas kernel interpreted.
"""
import importlib
import re
import types
from pathlib import Path

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels.ops import lut_lookup_op
from repro.kernels.ref import lut_gather_ref as j_gather_ref
from repro.serve import bundle_from_training as j_bundle_from_training
from repro.serve.engine import make_forward_fn as j_make_forward_fn
from repro_torch import bridge
from repro_torch.config import get_config
from repro_torch.core import lut_infer as LI
from repro_torch.core.exec_plan import (CascadeExec, LayerOperands,
                                        plan_cascade_exec)
from repro_torch.core.nl_config import (INPUT, LUTGraphConfig, LUTNodeSpec,
                                        UnsupportedTopology)
from repro_torch.kernels import build
from repro_torch.kernels.lut_gather import lut_lookup
from repro_torch.kernels.ref import lut_gather_ref
from repro_torch.serve import LUTServeEngine, bundle_from_training
from repro_torch.serve.engine import make_forward_fn
from test_torch_cascade import _random_net
from test_torch_model import numpy_model

# Small shapes: one intra-op thread keeps these tests from loading the
# CPU that the other test workers share.
torch.set_num_threads(1)


@pytest.mark.parametrize("NO,T,B,bb,bo", [
    (32, 64, 16, 8, 32),
    (64, 4096, 32, 8, 32),    # beta=2,F=6 / beta=4,F=3 table size
    (128, 512, 8, 4, 16),
    (10, 1024, 40, 8, 10),    # classes not power of two
])
def test_lut_lookup_matches_pallas_and_reference(NO, T, B, bb, bo):
    """The reference's own cases (tests/test_kernels.py)."""
    rng = np.random.default_rng(1)
    tbl = rng.integers(0, 2 ** 7, (NO, T)).astype(np.int32)
    addr = rng.integers(0, T, (B, NO)).astype(np.int32)
    want = np.asarray(lut_lookup_op(jnp.asarray(tbl), jnp.asarray(addr),
                                    block_b=bb, block_o=bo, interpret=True))
    assert np.array_equal(want, np.asarray(j_gather_ref(jnp.asarray(tbl),
                                                        jnp.asarray(addr))))
    got = lut_lookup(torch.as_tensor(tbl), torch.as_tensor(addr))
    assert got.dtype == torch.int32 and tuple(got.shape) == (B, NO)
    assert np.array_equal(got.numpy(), want)
    assert torch.equal(lut_gather_ref(torch.as_tensor(tbl),
                                      torch.as_tensor(addr)), got)


def test_lut_lookup_edge_addresses_and_empty_batch():
    NO, T = 8, 256
    tbl = np.arange(NO * T).reshape(NO, T).astype(np.int32) % 251
    addr = np.stack([np.zeros(NO), np.full(NO, T - 1)]).astype(np.int32)
    want = np.asarray(lut_lookup_op(jnp.asarray(tbl), jnp.asarray(addr),
                                    block_b=2, block_o=8, interpret=True))
    got = lut_lookup(torch.as_tensor(tbl), torch.as_tensor(addr)).numpy()
    assert np.array_equal(got, want)
    assert np.array_equal(got[0], tbl[:, 0])
    assert np.array_equal(got[1], tbl[:, -1])
    empty = lut_lookup(torch.as_tensor(tbl),
                       torch.zeros((0, NO), dtype=torch.int32))
    assert tuple(empty.shape) == (0, NO) and empty.dtype == torch.int32


def test_lut_lookup_rejects_non_pow2_and_bad_shapes():
    with pytest.raises(ValueError, match="power of two"):
        lut_lookup(torch.zeros((8, 100), dtype=torch.int32),
                   torch.zeros((8, 8), dtype=torch.int32))
    with pytest.raises(ValueError, match="disagree"):
        lut_lookup(torch.zeros((8, 64), dtype=torch.int32),
                   torch.zeros((4, 7), dtype=torch.int32))
    # a CUDA launch needs both operands on one CUDA device: CPU tables
    # with addresses elsewhere raise instead of running on the CPU
    with pytest.raises(ValueError, match="CUDA"):
        lut_lookup(torch.zeros((8, 64), dtype=torch.int32),
                   torch.zeros((4, 8), dtype=torch.int32, device="meta"))


def _bundles(mod, seed):
    """A random-table model in both packages: the JAX serving bundle and
    the port's, with the same tables, connectivity and quantizer
    scales."""
    jcfg = importlib.import_module(f"repro.configs.{mod}").reduced()
    pcfg = get_config(mod.replace("_", "-"), reduced=True)
    tables, statics = _random_net(jcfg, seed)
    params_np, state_np = numpy_model(jcfg, seed)
    jp = {"in_quant": {"log_s": jnp.asarray(params_np["in_quant"]["log_s"])},
          "layers": [{"quant": {"log_s": jnp.asarray(lp["quant"]["log_s"])}}
                     for lp in params_np["layers"]]}
    jbundle = j_bundle_from_training(jcfg, jp, tables, statics)
    p, _ = bridge.params_from_numpy(pcfg, params_np, state_np, device="cpu")
    pbundle = bundle_from_training(pcfg, p, tables,
                                   bridge.statics_from_numpy(pcfg, statics))
    return jbundle, pbundle


@pytest.mark.parametrize("mod", ["neuralut_jsc_5l", "neuralut_jsc_2l"])
def test_per_layer_forward_matches_jax_layer_kernel(mod):
    """The port's per-layer forward on the CPU against the reference's
    per-layer forward with the Pallas K3 interpreted, at a batch that is
    no bucket size; and against the fused route and the oracle."""
    jbundle, pbundle = _bundles(mod, seed=4)
    x = np.random.default_rng(6).normal(
        0, 1.5, (37, pbundle.cfg.in_features)).astype(np.float32)
    want = np.asarray(j_make_forward_fn(jbundle, fused=False,
                                        use_kernel=True)(jnp.asarray(x)))
    got = make_forward_fn(pbundle, fused=False, device="cpu")(x)
    assert got.dtype == torch.int32
    assert np.array_equal(got.numpy(), want)
    fused = make_forward_fn(pbundle, device="cpu")(x)
    assert torch.equal(got, fused)
    params = pbundle.serve_params(torch.device("cpu"))
    oracle = LI.predict(pbundle.cfg, params, pbundle.tables,
                        pbundle.statics, torch.as_tensor(x))
    assert np.array_equal(got.numpy(), oracle.numpy())


def test_per_layer_engine_serves_what_predict_predicts():
    _, pbundle = _bundles("neuralut_jsc_5l", seed=5)
    x = np.random.default_rng(7).normal(
        0, 1.5, (400, pbundle.cfg.in_features)).astype(np.float32)
    sizes = [1, 3, 8, 64, 300, 24]
    offs = np.cumsum([0] + sizes)
    with LUTServeEngine(pbundle, fused=False, device="cpu",
                        max_wait_ms=1.0) as eng:
        futs = [eng.submit(x[a:b]) for a, b in zip(offs[:-1], offs[1:])]
        got = np.concatenate([f.result(timeout=60) for f in futs])
    params = pbundle.serve_params(torch.device("cpu"))
    want = LI.predict(pbundle.cfg, params, pbundle.tables, pbundle.statics,
                      torch.as_tensor(x[:offs[-1]])).numpy()
    assert np.array_equal(got, want)


def test_per_layer_plan_and_operand_checks():
    pcfg = get_config("neuralut-jsc-5l", reduced=True)
    plan = plan_cascade_exec(pcfg, fused=False)
    assert plan.route == "layer" and not plan.fused
    assert plan_cascade_exec(pcfg).route == "fused"
    with pytest.raises(ValueError, match="unknown cascade route"):
        CascadeExec(schedule=plan.schedule, route="warp")
    tables, statics = _random_net(pcfg, seed=1)
    conns = [torch.as_tensor(s["conn"]) for s in statics]
    tbls = [torch.as_tensor(t.astype(np.int32)) for t in tables]
    LayerOperands(conns, tbls, plan.schedule, pcfg.in_features)
    with pytest.raises(ValueError, match="layer 1"):
        LayerOperands(conns, tbls[:1] + [tbls[1][:, :64]] + tbls[2:],
                      plan.schedule, pcfg.in_features)
    with pytest.raises(ValueError, match="disagree"):
        LayerOperands(conns[:2], tbls, plan.schedule, pcfg.in_features)


def test_per_layer_plan_on_a_dag_raises():
    dag = LUTGraphConfig(
        name="dag", in_features=16, num_classes=5, beta=3,
        nodes=(LUTNodeSpec("a", 8, 2, (INPUT,), 2),
               LUTNodeSpec("out", 5, 2, ("a",))))
    with pytest.raises(UnsupportedTopology):
        plan_cascade_exec(dag, fused=False)


def test_ctypes_signatures_match_the_c_sources():
    """Every C entry point of ``csrc/`` is bound with as many argument
    types as its definition has parameters (a missing one would pass
    the wrong values to a kernel on the card, where nothing checks)."""
    class Lib:
        def __getattr__(self, name):
            fn = types.SimpleNamespace()
            setattr(self, name, fn)
            return fn
    lib = build._bind(Lib())
    found = {}
    for src in sorted(Path(build.CSRC).glob("*.cu")) + sorted(
            Path(build.CSRC).glob("*.h")):
        for name, params in re.findall(
                r'extern "C" [\w\s*]*?\b(repro_\w+)\(([^)]*)\)',
                src.read_text()):
            found[name] = len([p for p in params.split(",") if p.strip()])
    assert {"repro_lut_cascade", "repro_lut_gather", "repro_lut_layer",
            "repro_lut_layer_plan", "repro_grouped_subnet",
            "repro_grouped_subnet_launch_plan", "repro_grouped_subnet_plan",
            "repro_subnet_train_fwd", "repro_subnet_train_bwd",
            "repro_subnet_train_plan", "repro_launch_floor",
            "repro_cuda_error_string"} <= set(found)
    for name, n in found.items():
        assert len(getattr(lib, name).argtypes) == n, name
