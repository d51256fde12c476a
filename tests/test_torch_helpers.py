"""Port parity of the small public helpers against the reference:
``core.quant.code_values`` and ``bn_init``, ``core.truth_table.
layer_truth_table``, ``core.model.total_params`` and ``optim.adamw.
adamw_init_spec``.

Params are seeded with numpy in the JAX package's tree layout
(``model_spec``; JAX ``model_init`` costs ~11 s per model here) and
bridged.  ``code_values`` is a float32 product (rtol 1e-6: exp differs
by an ulp between XLA:CPU and torch); ``bn_init``, ``total_params`` and
the spec trees are exact; a layer's table is integer and held equal to
the reference's bit for bit, and to the port's own ``convert`` layer.
"""
import importlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.config import get_config as j_get_config
from repro.core import model as JM
from repro.core import quant as JQ
from repro.core import truth_table as JTT
from repro.models import api as JA
from repro.optim.adamw import adamw_init_spec as j_adamw_init_spec
from repro_torch import bridge
from repro_torch.config import get_config
from repro_torch.core import model as M
from repro_torch.core import quant as Q
from repro_torch.core import truth_table as TT
from repro_torch.models import api
from repro_torch.models.layers.common import TensorSpec
from repro_torch.optim import adamw_init, adamw_init_spec
from repro_torch.sharding.partition import map_with_path

torch.set_num_threads(1)

CHAINS = ["neuralut_jsc_2l", "neuralut_jsc_5l", "neuralut_hdr_5l"]
GRAPHS = ["polylut_add_jsc_2l", "polylut_add_jsc_5l"]


def _numpy_model(jcfg, seed):
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


def _configs(mod):
    jcfg = getattr(importlib.import_module(f"repro.configs.{mod}"),
                   "reduced")()
    return jcfg, get_config(mod.replace("_", "-"), reduced=True)


@pytest.mark.parametrize("beta", [1, 2, 4, 7])
def test_code_values_matches_reference(beta):
    log_s = np.log(np.random.default_rng(beta).uniform(0.05, 2.0, (9,))
                   ).astype(np.float32)
    got = Q.code_values({"log_s": torch.as_tensor(log_s)}, beta)
    want = JQ.code_values({"log_s": jnp.asarray(log_s)}, beta)
    assert got.shape == (9, 2 ** beta) and got.dtype == torch.float32
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-6)


@pytest.mark.parametrize("channels", [1, 5, 64])
def test_bn_init_matches_reference(channels):
    got, want = Q.bn_init(channels), JQ.bn_init(channels)
    for g, w in zip(got, want):
        assert sorted(g) == sorted(w)
        for k in g:
            assert g[k].dtype == torch.float32
            np.testing.assert_array_equal(g[k].numpy(), np.asarray(w[k]))


@pytest.mark.parametrize("mod", CHAINS + GRAPHS)
@pytest.mark.parametrize("reduced", [True, False])
def test_total_params_matches_reference(mod, reduced):
    jcfg = getattr(importlib.import_module(f"repro.configs.{mod}"),
                   "reduced" if reduced else "full")()
    pcfg = get_config(mod.replace("_", "-"), reduced=reduced)
    assert M.total_params(pcfg) == JM.total_params(jcfg) > 0


@pytest.mark.parametrize("mod", CHAINS)
def test_layer_truth_table_matches_reference(mod):
    jcfg, pcfg = _configs(mod)
    params_np, state_np = _numpy_model(jcfg, seed=11)
    statics = JM.model_static(jcfg)
    p, s = bridge.params_from_numpy(pcfg, params_np, state_np, device="cpu")
    st = bridge.statics_from_numpy(pcfg, statics)
    own = TT.convert(pcfg, p, s, st)
    jp = jax.tree.map(jnp.asarray, params_np)
    js = jax.tree.map(jnp.asarray, state_np)
    for i in range(pcfg.num_layers):
        got = TT.layer_truth_table(pcfg, p, s, st, i)
        assert got.dtype == np.uint16
        np.testing.assert_array_equal(got, own[i])
        want = JTT.layer_truth_table(jcfg, jp, js, statics, i)
        np.testing.assert_array_equal(got, want, err_msg=f"layer {i}")


def _spec_flat(tree):
    out = {}

    def put(path, leaf):
        out["/".join(path)] = (tuple(leaf.shape), str(leaf.dtype).split(".")[-1])
    map_with_path(put, tree)
    return out


def _ref_spec_flat(tree):
    out = {}
    for path, leaf in jax.tree_util.tree_flatten_with_path(tree)[0]:
        key = "/".join(str(p.key) if hasattr(p, "key") else f"[{p.idx}]"
                       for p in path)
        out[key] = (tuple(leaf.shape), str(leaf.dtype))
    return out


@pytest.mark.parametrize("arch", ["lm-100m", "qwen2-moe-a2.7b",
                                  "xlstm-350m", "whisper-small"])
@pytest.mark.parametrize("dtype", ["bfloat16", "float32"])
def test_adamw_init_spec_matches_reference(arch, dtype):
    import dataclasses
    cfg = dataclasses.replace(get_config(arch), dtype=dtype)
    jcfg = dataclasses.replace(j_get_config(arch), dtype=dtype)
    got = adamw_init_spec(api.param_spec(cfg))
    want = j_adamw_init_spec(JA.param_spec(jcfg))
    assert _spec_flat(got) == _ref_spec_flat(want)
    # the reference keeps an all-None master without bfloat16 leaves,
    # where the port (as its adamw_init) has none
    assert ("master" in got) == (dtype == "bfloat16")
    # and it mirrors adamw_init leaf for leaf on a small tree
    small = {"a": torch.zeros(3, 2, dtype=getattr(torch, dtype)),
             "b": [torch.zeros(4)]}
    real = adamw_init(small)
    spec = adamw_init_spec(map_with_path(
        lambda _, t: TensorSpec(tuple(t.shape), t.dtype), small))
    assert _spec_flat(spec) == _spec_flat(real)
