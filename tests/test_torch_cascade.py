"""Port parity: the plain gather cascade (what the CUDA cascade kernel's
wrapper runs for CPU tensors) against the JAX package's integer oracle
``lut_infer.lut_forward`` and its Pallas cascade kernel in interpret
mode — bit for bit, including batch sizes that do not divide the tile.
"""
import functools
import importlib

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import lut_infer as JLI
from repro.kernels import lut_cascade as JLC
from repro_torch.bridge import statics_from_numpy
from repro_torch.config import get_config
from repro_torch.core.exec_plan import CascadeExec, plan_cascade_exec
from repro_torch.core.nl_config import (INPUT, LUTGraphConfig, LUTNodeSpec,
                                        UnsupportedTopology)
from repro_torch.kernels.lut_cascade import (CascadeOperands, cascade_meta,
                                             cascade_tables, lut_cascade)
from repro_torch.kernels.ref import as_schedule

# Small shapes: one intra-op thread keeps these tests from loading the
# CPU that the other test workers share.
torch.set_num_threads(1)

REDUCED = ["neuralut_hdr_5l", "neuralut_jsc_2l", "neuralut_jsc_5l"]
BATCHES = [1, 7, 256, 1000]


def _cfgs(mod, variant):
    jcfg = getattr(importlib.import_module(f"repro.configs.{mod}"),
                   variant)()
    return jcfg, get_config(mod.replace("_", "-"),
                            reduced=variant == "reduced")


def _random_net(cfg, seed):
    """Random uniform tables and connectivity with cfg's geometry."""
    rng = np.random.default_rng(seed)
    statics, tables = [], []
    w_prev = cfg.in_features
    for i, o in enumerate(cfg.layer_widths):
        statics.append({"conn": rng.integers(
            0, w_prev, (o, cfg.layer_fan_in(i))).astype(np.int32)})
        tables.append(rng.integers(0, 2 ** cfg.beta, (o, cfg.table_size(i))
                                   ).astype(np.uint16))
        w_prev = o
    return tables, statics


def _codes(cfg, b, seed):
    rng = np.random.default_rng(seed)
    return rng.integers(0, 2 ** cfg.layer_in_bits(0),
                        (b, cfg.in_features)).astype(np.int32)


def _port_ops(pcfg, tables, statics):
    st = statics_from_numpy(pcfg, statics)
    return CascadeOperands(
        [torch.as_tensor(s["conn"]) for s in st],
        [torch.as_tensor(p) for p in cascade_tables(pcfg, tables)],
        cascade_meta(pcfg), pcfg.in_features)


@functools.lru_cache(maxsize=None)
def _reference(mod, variant, seed, interpret):
    """One network per geometry and the JAX outputs for the largest
    batch; both JAX functions are row-wise, so a smaller batch's
    reference is a prefix of these rows (one interpret compile per
    geometry instead of one per batch size)."""
    jcfg, pcfg = _cfgs(mod, variant)
    tables, statics = _random_net(jcfg, seed=seed)
    codes = _codes(jcfg, max(BATCHES), seed=seed + 1)
    oracle = np.asarray(JLI.lut_forward(jcfg, tables, statics,
                                        jnp.asarray(codes)))
    kern = None
    if interpret:
        kern = np.asarray(JLC.lut_cascade(
            jnp.asarray(codes),
            [jnp.asarray(m) for m in JLC.build_shift_mats(jcfg, statics)],
            [jnp.asarray(t) for t in JLC.cascade_tables(jcfg, tables)],
            JLC.cascade_meta(jcfg), block_b=128, interpret=True))
    return pcfg, tables, statics, codes, oracle, kern


@pytest.mark.parametrize("b", BATCHES)
@pytest.mark.parametrize("mod", REDUCED)
def test_plain_cascade_bit_exact_reduced(mod, b):
    pcfg, tables, statics, codes, oracle, kern = _reference(
        mod, "reduced", 3, True)
    codes, oracle, kern = codes[:b], oracle[:b], kern[:b]
    ops = _port_ops(pcfg, tables, statics)
    got = lut_cascade(torch.as_tensor(codes), ops).numpy()
    assert got.dtype == np.int32
    assert np.array_equal(got, oracle)
    assert np.array_equal(got, kern)
    # the serving plan on CPU tensors runs the plain gather cascade
    plan = plan_cascade_exec(pcfg)
    assert np.array_equal(plan.apply(torch.as_tensor(codes), ops).numpy(),
                          oracle)


@pytest.mark.parametrize("b", BATCHES)
def test_plain_cascade_bit_exact_full_jsc5l(b):
    pcfg, tables, statics, codes, oracle, _ = _reference(
        "neuralut_jsc_5l", "full", 100, False)
    got = lut_cascade(torch.as_tensor(codes[:b]),
                      _port_ops(pcfg, tables, statics)).numpy()
    assert np.array_equal(got, oracle[:b])


def test_cascade_meta_and_geometry_checks():
    _, pcfg = _cfgs("neuralut_jsc_5l", "full")
    # (in_bits, word_bits, slot_bits, beta): 2^14 / 8 words in layer 0
    assert cascade_meta(pcfg)[0] == (7, 11, 3, 4)
    assert cascade_meta(pcfg)[1] == (4, 9, 3, 4)
    tables, statics = _random_net(pcfg, seed=0)
    bad = [dict(s) for s in statics]
    bad[1] = {"conn": np.full_like(statics[1]["conn"], 128)}
    with pytest.raises(ValueError, match="conn"):
        _port_ops(pcfg, tables, bad)
    ops = _port_ops(pcfg, tables, statics)
    # only CPU codes run the plain version: codes on another device than
    # the operands raise instead of running quietly elsewhere
    plan = CascadeExec(schedule=cascade_meta(pcfg))
    with pytest.raises(ValueError, match="operands"):
        plan.apply(torch.empty((4, pcfg.in_features), dtype=torch.int32,
                               device="meta"), ops)


def test_non_chain_graph_raises_at_plan_time():
    """A DAG plans on the fused route (K1 walks its node schedule) and
    raises ``UnsupportedTopology`` on the per-layer route when the plan
    is built; a chain written as a graph plans exactly as its chain."""
    _, pcfg = _cfgs("neuralut_jsc_2l", "reduced")
    dag = LUTGraphConfig(
        name="dag", in_features=16, num_classes=5, beta=3,
        nodes=(LUTNodeSpec("a", 8, 2, (INPUT,), 2),
               LUTNodeSpec("out", 5, 2, ("a",))))
    fused = plan_cascade_exec(dag)
    assert fused.fused and not fused.is_chain
    assert fused.schedule == (((0,), 2, 3, 3, 3, 3), ((1,), 1, 4, 5, 3, 3))
    with pytest.raises(UnsupportedTopology):
        plan_cascade_exec(dag, fused=False)
    for fu in (True, False):
        chain = plan_cascade_exec(pcfg.graph(), fused=fu)
        assert chain == plan_cascade_exec(pcfg, fused=fu) and chain.is_chain
        assert chain.schedule == as_schedule(cascade_meta(pcfg))
