"""Port parity: truth-table conversion on bridged parameters.

Three contracts, on the reduced chain geometries:

* the port's tables equal the JAX package's ``convert_packed`` tables up
  to +-1-code flips at round() boundaries, at most two entries per
  model (the constant allowance of tests/test_convert_fused.py: exp and
  summation order differ between XLA:CPU and torch);
* the packed words are exactly ``pack_tables`` of the port's tables;
* the port's tables equal the codes of the port's own quantized eval
  layer on every enumerated input, exactly.
"""
import importlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import model as JM
from repro.core import truth_table as JTT
from repro_torch import bridge
from repro_torch.config import get_config
from repro_torch.core import layers as L
from repro_torch.core import lut_infer as LI
from repro_torch.core import model as M
from repro_torch.core import quant as Q
from repro_torch.core import truth_table as TT
from repro_torch.core.exec_plan import plan_subnet_exec

# Small shapes: one intra-op thread keeps these tests from loading the
# CPU that the other test workers share.
torch.set_num_threads(1)

REDUCED = ["neuralut_hdr_5l", "neuralut_jsc_2l", "neuralut_jsc_5l"]
ALLOWED_FLIPS = 2


def numpy_model(jcfg, seed):
    """Seeded numpy (params, state) in the JAX package's tree layout."""
    rng = np.random.default_rng(seed)
    spec_p, spec_s = JM.model_spec(jcfg)

    def leaf(path, sds):
        name = jax.tree_util.keystr(path)
        if "log_s" in name:
            base = 0.25 if "in_quant" in name else 2 / 7
            return np.log(base * rng.uniform(0.8, 1.25, sds.shape)
                          ).astype(np.float32)
        if sds.ndim >= 2:
            return (rng.normal(0, 1, sds.shape) / np.sqrt(sds.shape[-2])
                    ).astype(np.float32)
        if name.endswith("['var']"):
            return rng.uniform(0.5, 2.0, sds.shape).astype(np.float32)
        if name.endswith("['g']"):
            return rng.normal(1, 0.1, sds.shape).astype(np.float32)
        return rng.normal(0, 0.3, sds.shape).astype(np.float32)

    def fill(tree):
        return jax.tree_util.tree_map_with_path(
            leaf, tree, is_leaf=lambda x: isinstance(x, jax.ShapeDtypeStruct))
    return fill(spec_p), fill(spec_s)


def _models(mod, seed):
    jcfg = getattr(importlib.import_module(f"repro.configs.{mod}"),
                   "reduced")()
    pcfg = get_config(mod.replace("_", "-"), reduced=True)
    statics = JM.model_static(jcfg)
    params_np, state_np = numpy_model(jcfg, seed)
    p, s = bridge.params_from_numpy(pcfg, params_np, state_np,
                                    device="cpu")
    st = bridge.statics_from_numpy(pcfg, statics)
    return (jcfg, params_np, state_np, statics), (pcfg, p, s, st)


@pytest.mark.parametrize("mod", REDUCED)
def test_tables_match_jax_convert(mod):
    (jcfg, jp, js, jst), (pcfg, p, s, st) = _models(mod, seed=4)
    want, want_packed = JTT.convert_packed(
        jcfg, jax.tree.map(jnp.asarray, jp), jax.tree.map(jnp.asarray, js),
        jst)
    tables, packed = TT.convert_packed(pcfg, p, s, st)
    flips = 0
    for i, (a, b) in enumerate(zip(tables, want)):
        assert a.shape == b.shape and a.dtype == np.uint16
        d = np.abs(a.astype(np.int32) - b.astype(np.int32))
        assert d.max() <= 1, f"layer {i}: not a rounding-boundary flip"
        flips += int((d != 0).sum())
    assert flips <= ALLOWED_FLIPS, f"{flips} flips"
    for i, (t, w) in enumerate(zip(tables, packed)):
        assert np.array_equal(w, LI.pack_tables(t, pcfg.beta)), i
    if flips == 0:
        for w, jw in zip(packed, want_packed):
            assert np.array_equal(w, jw)


@pytest.mark.parametrize("mod", REDUCED)
def test_tables_equal_own_eval_layer_on_every_code(mod, monkeypatch):
    """Feed each neuron every code combination through the port's eval
    layer (gather -> sub-network -> BN -> quantize): one row block per
    neuron, that neuron's sources set to the dequantized codes."""
    _, (pcfg, p, s, st) = _models(mod, seed=5)
    monkeypatch.setattr(TT, "SWEEP_BATCH", 128)  # chunked sweep
    tables = TT.convert(pcfg, p, s, st)
    plan = plan_subnet_exec(pcfg, purpose="eval", device="cpu")
    widths = M.model_widths(pcfg)
    for i in range(pcfg.num_layers):
        bits, f = pcfg.layer_in_bits(i), pcfg.layer_fan_in(i)
        codes = torch.as_tensor(TT.enumerate_codes(bits, f))  # (T, F)
        t, o = codes.shape[0], widths[i + 1]
        src = (p["in_quant"] if i == 0 else p["layers"][i - 1]["quant"])
        scale = torch.exp(src["log_s"])
        conn = torch.as_tensor(st[i]["conn"]).long()          # (O, F)
        x = torch.zeros(o * t, widths[i])
        rows = torch.arange(o * t)
        for j in range(f):
            cols = conn[:, j].repeat_interleave(t)
            x[rows, cols] = ((codes[:, j].repeat(o) - 2 ** (bits - 1))
                             .float() * scale[cols])
        _, pre, _ = L.layer_apply(pcfg, i, p["layers"][i], s["layers"][i],
                                  st[i], x, train=False, exec_plan=plan)
        got = L.layer_codes(pcfg, p["layers"][i], pre)       # (O*T, O)
        own = got.reshape(o, t, o)[torch.arange(o), :, torch.arange(o)]
        assert np.array_equal(own.numpy(), tables[i].astype(np.int32)), i


def test_lut_path_equals_quantized_forward():
    """End to end on data: the LUT cascade over the port's tables gives
    the codes of the port's quantized eval forward, bit for bit."""
    _, (pcfg, p, s, st) = _models("neuralut_jsc_5l", seed=6)
    tables = TT.convert(pcfg, p, s, st)
    x = torch.as_tensor(np.random.default_rng(0).normal(
        0, 1, (300, pcfg.in_features)).astype(np.float32))
    pre, _, _ = M.model_apply(pcfg, p, s, st, x)
    want = Q.quant_codes(p["layers"][-1]["quant"], pre, pcfg.beta)
    got = LI.lut_forward(pcfg, tables, st, LI.input_codes(pcfg, p, x))
    assert torch.equal(got, want)
