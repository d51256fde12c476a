"""Port parity: the eval forward and batch norm on bridged parameters.

The JAX package draws its parameters from ``jax.random`` and seeds its
connectivity with the per-process salted ``hash``; the bridge carries
both (and the BN state) across, so the two packages run the same model.
"""
import importlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import model as JM
from repro.core import quant as JQ
from repro.core.sparsity import random_connectivity
from repro_torch import bridge
from repro_torch.config import get_config
from repro_torch.core import model as M
from repro_torch.core import quant as Q

# Small shapes: one intra-op thread keeps these tests from loading the
# CPU that the other test workers share.
torch.set_num_threads(1)

REDUCED = ["neuralut_hdr_5l", "neuralut_jsc_2l", "neuralut_jsc_5l"]
TOL = dict(atol=1e-5, rtol=1e-5)


def numpy_model(jcfg, seed):
    """Seeded numpy (params, state) in the JAX package's tree layout
    (``model_spec``): random sub-network weights, quantizer scales near
    their init, a non-trivial BN state."""
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


def fixed_connectivity(jcfg, statics, seed):
    """``statics`` with every layer's connectivity redrawn from
    ``np.random.default_rng(seed)``: the same in every process, where
    ``model_static`` seeds it with the salted ``hash``."""
    rng = np.random.default_rng(seed)
    widths = [jcfg.in_features] + list(jcfg.layer_widths)
    return [dict(st, conn=random_connectivity(
        widths[i], widths[i + 1], jcfg.layer_fan_in(i),
        seed=int(rng.integers(2 ** 31))))
        for i, st in enumerate(statics)]


def bridged_model(mod, variant="reduced", seed=0, conn_seed=None):
    """A seeded model in both packages: the JAX trees (jnp) and their
    bridged port counterpart on the CPU, with the same connectivity
    (``model_static``'s, or drawn from ``conn_seed`` when it is given)."""
    jcfg = getattr(importlib.import_module(f"repro.configs.{mod}"),
                   variant)()
    pcfg = get_config(mod.replace("_", "-"), reduced=variant == "reduced")
    statics = JM.model_static(jcfg)
    if conn_seed is not None:
        statics = fixed_connectivity(jcfg, statics, conn_seed)
    params_np, state_np = numpy_model(jcfg, seed)
    p, s = bridge.params_from_numpy(pcfg, params_np, state_np,
                                    device="cpu")
    st = bridge.statics_from_numpy(pcfg, statics)
    return ((jcfg, jax.tree.map(jnp.asarray, params_np),
             jax.tree.map(jnp.asarray, state_np), statics),
            (pcfg, p, s, st))


@pytest.mark.parametrize("mod", REDUCED)
def test_eval_forward_matches(mod):
    (jcfg, jp, js, jst), (pcfg, p, s, st) = bridged_model(mod, seed=1)
    x = np.random.default_rng(5).normal(
        0, 1.5, (97, jcfg.in_features)).astype(np.float32)
    j_logits, j_vals, _ = jax.jit(lambda p_, s_, x_: JM.model_apply(
        jcfg, p_, s_, jst, x_, train=False))(jp, js, jnp.asarray(x))
    logits, vals, _ = M.model_apply(pcfg, p, s, st, torch.as_tensor(x))
    np.testing.assert_allclose(logits.numpy(), np.asarray(j_logits), **TOL)
    np.testing.assert_allclose(vals.numpy(), np.asarray(j_vals), **TOL)


def test_bn_train_update_matches():
    rng = np.random.default_rng(2)
    x = rng.normal(1.0, 2.0, (33, 12)).astype(np.float32)
    p = {"g": rng.normal(1, 0.1, 12).astype(np.float32),
         "b": rng.normal(0, 0.1, 12).astype(np.float32)}
    s = {"mean": rng.normal(0, 1, 12).astype(np.float32),
         "var": rng.uniform(0.5, 2, 12).astype(np.float32)}
    jy, js = JQ.bn_apply(jax.tree.map(jnp.asarray, p),
                         jax.tree.map(jnp.asarray, s), jnp.asarray(x),
                         train=True, momentum=0.1)
    t = {k: torch.as_tensor(v) for k, v in p.items()}
    ts = {k: torch.as_tensor(v) for k, v in s.items()}
    y, ns = Q.bn_apply(t, ts, torch.as_tensor(x), train=True, momentum=0.1)
    np.testing.assert_allclose(y.numpy(), np.asarray(jy), **TOL)
    for k in ("mean", "var"):  # biased batch variance, as the reference
        np.testing.assert_allclose(ns[k].numpy(), np.asarray(js[k]), **TOL)


def test_quant_codes_and_init_shapes():
    (jcfg, jp, _, _), (pcfg, p, _, _) = bridged_model("neuralut_jsc_5l")
    x = np.random.default_rng(3).normal(0, 2, (50, 16)).astype(np.float32)
    want = JQ.quant_codes(jp["in_quant"], jnp.asarray(x), 4)
    got = Q.quant_codes(p["in_quant"], torch.as_tensor(x), 4)
    assert np.array_equal(got.numpy(), np.asarray(want))
    # port init: same tree, shapes and quantizer / BN starting values
    ip, istate = M.model_init(pcfg, torch.Generator().manual_seed(0),
                              device="cpu")
    spec_p, _ = JM.model_spec(jcfg)
    assert jax.tree.structure(jax.tree.map(lambda a: a.numpy(), ip)) \
        == jax.tree.structure(spec_p)
    np.testing.assert_allclose(ip["layers"][0]["quant"]["log_s"].numpy(),
                               np.log(2 / 3), **TOL)  # 2 / (2^(3-1) - 1)
    w = ip["layers"][0]["fn"]["layers"][1]["w"]
    assert float(w.abs().max()) <= 2 / np.sqrt(w.shape[-2]) + 1e-6
    assert float(istate["layers"][0]["bn"]["var"].min()) == 1.0
