"""Port parity: K3's layer entry ``lut_layer`` (``kernels/lut_gather``),
one chain layer's gather, pack and lookup in one call.

Integer paths, so every comparison is bit for bit.  On the CPU the
wrapper runs its plain version ``kernels.ref.lut_layer_ref``; the
reference is the JAX per-layer step, ``lut_lookup_op(tables,
pack_index(codes[:, conn], in_bits), interpret=True)``, with the Pallas
kernel interpreted.  Codes outside [0, 2^in_bits) make addresses outside
the table, which the port clamps into [0, T) (``lut_gather_ref``); the
Pallas kernel reads only the address's low bits, so there the reference
is the JAX address, clamped.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import lut_infer as JLI
from repro.kernels.ops import lut_lookup_op
from repro_torch.config import get_config
from repro_torch.core import lut_infer as LI
from repro_torch.core.exec_plan import LayerOperands, plan_cascade_exec
from repro_torch.kernels.lut_gather import lut_layer
from repro_torch.kernels.ref import lut_gather_ref, lut_layer_ref
from test_torch_cascade import _random_net

torch.set_num_threads(1)

_RED = get_config("neuralut-jsc-5l", reduced=True)
# (I, O, F, in_bits): the reduced jsc-5l layers, then the sweep's first
# NeuraLUT layer (196 pooled inputs, F 6, 2-bit codes) at a narrow width.
SHAPES = [(_RED.in_features if i == 0 else _RED.layer_widths[i - 1], o,
           _RED.layer_fan_in(i), _RED.layer_in_bits(i))
          for i, o in enumerate(_RED.layer_widths)] + [(196, 16, 6, 2)]
BATCHES = (0, 1, 7, 33, 256)


def _shape_id(s):
    return "I{}-O{}-F{}-bits{}".format(*s)


def _operands(n_in, o, f, in_bits, b, seed, beta=4):
    rng = np.random.default_rng(seed)
    tbl = rng.integers(0, 2 ** beta, (o, 1 << (in_bits * f))).astype(np.int32)
    conn = rng.integers(0, n_in, (o, f)).astype(np.int32)
    codes = rng.integers(0, 2 ** in_bits, (b, n_in)).astype(np.int32)
    if b > 1:                      # the edge codes
        codes[0] = 0
        codes[1] = 2 ** in_bits - 1
    return tbl, conn, codes


def _jax_step(tbl, conn, codes, in_bits):
    addr = JLI.pack_index(jnp.asarray(codes)[:, conn], in_bits)
    return np.asarray(lut_lookup_op(jnp.asarray(tbl), addr, interpret=True))


@pytest.mark.parametrize("b", BATCHES)
@pytest.mark.parametrize("shape", SHAPES, ids=_shape_id)
def test_lut_layer_matches_the_jax_layer_step(shape, b):
    n_in, o, f, in_bits = shape
    tbl, conn, codes = _operands(n_in, o, f, in_bits, b, seed=b + 3)
    got = lut_layer(torch.as_tensor(tbl), torch.as_tensor(codes),
                    torch.as_tensor(conn), in_bits)
    assert got.dtype == torch.int32 and tuple(got.shape) == (b, o)
    if b:
        assert np.array_equal(got.numpy(), _jax_step(tbl, conn, codes,
                                                     in_bits))


@pytest.mark.parametrize("shape", SHAPES, ids=_shape_id)
def test_lut_layer_clamps_out_of_range_codes_as_today(shape):
    """Codes -1 and 2^in_bits (and beyond): addresses below 0 or past the
    table, clamped into [0, T) as the route before ``lut_layer`` clamped
    them (``lut_gather_ref`` of ``pack_index``)."""
    n_in, o, f, in_bits = shape
    tbl, conn, codes = _operands(n_in, o, f, in_bits, 33, seed=11)
    rng = np.random.default_rng(12)
    codes[2:] = rng.integers(-2 ** in_bits, 2 ** (in_bits + 1),
                             codes[2:].shape)
    codes[2, 0::2], codes[2, 1::2] = -1, 2 ** in_bits
    t = torch.as_tensor
    got = lut_layer(t(tbl), t(codes), t(conn), in_bits)
    today = lut_gather_ref(t(tbl), LI.pack_index(t(codes)[:, t(conn).long()],
                                                 in_bits))
    assert torch.equal(got, today)
    addr = np.asarray(JLI.pack_index(jnp.asarray(codes)[:, conn], in_bits))
    assert (addr < 0).any() and (addr >= tbl.shape[1]).any()
    want = tbl[np.arange(o)[None, :], np.clip(addr, 0, tbl.shape[1] - 1)]
    assert np.array_equal(got.numpy(), want)


def test_lut_layer_is_lut_layer_ref_and_counts_no_launch_on_the_cpu():
    tbl, conn, codes = _operands(16, 32, 2, 4, 7, seed=1)
    t = torch.as_tensor
    before = lut_layer.launches
    got = lut_layer(t(tbl), t(codes), t(conn), 4)
    assert torch.equal(got, lut_layer_ref(t(tbl), t(codes), t(conn), 4))
    assert lut_layer.launches == before


def _bad(**kw):
    args = dict(tables=torch.zeros((8, 64), dtype=torch.int32),
                codes=torch.zeros((4, 10), dtype=torch.int32),
                conn=torch.zeros((8, 3), dtype=torch.int32), in_bits=2)
    args.update(kw)
    return args


@pytest.mark.parametrize("args,match", [
    (_bad(tables=torch.zeros((8, 100), dtype=torch.int32)), "power of two"),
    (_bad(tables=torch.zeros((8, 128), dtype=torch.int32)), r"2\^6"),
    (_bad(conn=torch.zeros((8, 31), dtype=torch.int32), in_bits=1,
          tables=torch.zeros((8, 4), dtype=torch.int32)), "address bits"),
    (_bad(in_bits=0), "address bits"),
    (_bad(conn=torch.zeros((7, 3), dtype=torch.int32)), "disagree"),
    (_bad(codes=torch.zeros((4,), dtype=torch.int32)), "disagree"),
    (_bad(codes=torch.zeros((4, 0), dtype=torch.int32)), "I = 0"),
    (_bad(codes=torch.zeros((4, 10), dtype=torch.int64)), "int32"),
    (_bad(conn=torch.zeros((8, 3), dtype=torch.int64)), "int32"),
    (_bad(tables=torch.zeros((8, 64), dtype=torch.float32)), "int32"),
    (_bad(tables=torch.zeros((8, 64), dtype=torch.uint8)), "int32"),
    # a launch needs every operand on one CUDA device: CPU tables with
    # codes elsewhere raise instead of running on the CPU
    (_bad(codes=torch.zeros((4, 10), dtype=torch.int32, device="meta")),
     "CUDA"),
    (_bad(tables=torch.zeros((8, 64), dtype=torch.int32, device="meta"),
          codes=torch.zeros((4, 10), dtype=torch.int32, device="meta"),
          conn=torch.zeros((8, 3), dtype=torch.int32, device="meta")),
     "CUDA"),
], ids=["non-pow2", "T-vs-F", "31-bits", "in_bits-0", "conn-rows",
        "codes-1d", "no-inputs", "codes-int64", "conn-int64", "float-tables",
        "uint8-tables", "meta-codes", "meta-all"])
def test_lut_layer_rejects_bad_operands(args, match):
    with pytest.raises(ValueError, match=match):
        lut_layer(**args)


@pytest.mark.parametrize("b", [1, 33])
@pytest.mark.parametrize("mod", ["neuralut-jsc-5l", "neuralut-jsc-2l"])
def test_per_layer_cascade_matches_the_jax_layer_loop(mod, b):
    """``CascadeExec(route="layer").apply`` on integer codes against the
    reference's per-layer loop (``serve/engine.py`` layer_kernel: gather,
    ``pack_index``, Pallas ``lut_lookup`` interpreted)."""
    cfg = get_config(mod, reduced=True)
    tables, statics = _random_net(cfg, seed=b)
    codes = np.random.default_rng(b).integers(
        0, 2 ** cfg.layer_in_bits(0), (b, cfg.in_features)).astype(np.int32)
    plan = plan_cascade_exec(cfg, fused=False)
    ops = LayerOperands([torch.as_tensor(s["conn"]) for s in statics],
                        [torch.as_tensor(t.astype(np.int32)) for t in tables],
                        plan.schedule, cfg.in_features)
    assert all(c.dtype == torch.int32 for c in ops.conns)
    got = plan.apply(torch.as_tensor(codes), ops)
    c = jnp.asarray(codes)
    for i, (t, s) in enumerate(zip(tables, statics)):
        c = jnp.asarray(_jax_step(t.astype(np.int32), s["conn"],
                                  np.asarray(c), cfg.layer_in_bits(i)))
    assert got.dtype == torch.int32
    assert np.array_equal(got.numpy(), np.asarray(c))


@pytest.mark.parametrize("i,bad", [
    (1, "width"), (0, -1), (0, "in_features"), (2, "width")])
def test_layer_operands_reject_connections_outside_the_layer_below(i, bad):
    """Each layer's connections in [0, the width below): the previous
    layer's, or the input codes' for layer 0 (the kernel clamps them,
    where the plain version reads another column or raises)."""
    cfg = get_config("neuralut-jsc-5l", reduced=True)
    tables, statics = _random_net(cfg, seed=2)
    plan = plan_cascade_exec(cfg, fused=False)
    conns = [torch.as_tensor(s["conn"]) for s in statics]
    tbls = [torch.as_tensor(t.astype(np.int32)) for t in tables]
    LayerOperands(conns, tbls, plan.schedule, cfg.in_features)
    broken = list(conns)
    broken[i] = broken[i].clone()
    broken[i][0, 0] = {"width": cfg.layer_widths[i - 1],
                       "in_features": cfg.in_features}.get(bad, bad)
    with pytest.raises(ValueError, match=f"layer {i}: connections"):
        LayerOperands(broken, tbls, plan.schedule, cfg.in_features)
