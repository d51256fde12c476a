"""Port parity: the serving engine on a bundle made from bridged
parameters and JAX-converted tables.  Served predictions equal the JAX
package's ``lut_infer.predict`` exactly, for mixed request sizes
including one larger than the largest bucket."""
import importlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import lut_infer as JLI
from repro.core import model as JM
from repro.core import truth_table as JTT
from repro_torch import bridge
from repro_torch.config import get_config
from repro_torch.data import jsc_synthetic
from repro_torch.serve import LUTServeEngine, bundle_from_training
from repro_torch.serve.engine import pick_bucket

# Small shapes: one intra-op thread keeps these tests from loading the
# CPU that the other test workers share.
torch.set_num_threads(1)


def _seeded(jcfg, seed):
    """Seeded numpy params/state in the JAX tree layout."""
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


@pytest.fixture(scope="module")
def served():
    jcfg = importlib.import_module("repro.configs.neuralut_jsc_5l").reduced()
    pcfg = get_config("neuralut-jsc-5l", reduced=True)
    statics = JM.model_static(jcfg)
    params_np, state_np = _seeded(jcfg, 7)
    jp = jax.tree.map(jnp.asarray, params_np)
    tables = JTT.convert(jcfg, jp, jax.tree.map(jnp.asarray, state_np),
                         statics)
    p, _ = bridge.params_from_numpy(pcfg, params_np, state_np,
                                    device="cpu")
    bundle = bundle_from_training(pcfg, p, tables,
                                  bridge.statics_from_numpy(pcfg, statics))
    x, _ = jsc_synthetic(1500, seed=2)
    want = np.asarray(JLI.predict(jcfg, jp, tables, statics,
                                  jnp.asarray(x)))
    return bundle, x, want


def test_engine_predictions_equal_jax_predict(served):
    bundle, x, want = served
    sizes = [1, 3, 8, 9, 64, 100, 256, 300, 1, 17]  # 300 > max bucket
    offs = np.cumsum([0] + sizes)
    with LUTServeEngine(bundle, device="cpu", max_wait_ms=1.0) as eng:
        eng.warmup()
        futs = [eng.submit(x[a:b]) for a, b in zip(offs[:-1], offs[1:])]
        got = [f.result(timeout=60) for f in futs]
        single = eng.predict(x[5])  # a flat sample
    for (a, b), g in zip(zip(offs[:-1], offs[1:]), got):
        assert g.dtype == np.int32 and g.shape == (b - a,)
        assert np.array_equal(g, want[a:b])
    assert np.array_equal(single, want[5:6])
    rep = eng.metrics.report()
    assert rep["requests"] == len(sizes) + 1
    assert rep["samples"] == sum(sizes) + 1


def test_engine_close_and_submit_after_close(served):
    bundle, x, want = served
    eng = LUTServeEngine(bundle, device="cpu", max_wait_ms=50.0)
    futs = [eng.submit(x[i:i + 4]) for i in range(0, 40, 4)]
    eng.close()  # serves what was queued before it, then stops
    for i, f in zip(range(0, 40, 4), futs):
        assert np.array_equal(f.result(timeout=10), want[i:i + 4])
    with pytest.raises(RuntimeError, match="closed"):
        eng.submit(x[:1])
    eng.close()  # idempotent
    with pytest.raises(ValueError):
        LUTServeEngine(bundle, device="cpu").submit(np.zeros((2, 3)))
    with pytest.raises(ValueError):
        LUTServeEngine(bundle, device="cpu", buckets=(8, 1))
    assert [pick_bucket(n, (1, 8, 64)) for n in (1, 2, 64, 65)] \
        == [1, 8, 64, 64]
