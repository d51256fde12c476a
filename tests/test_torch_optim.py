"""Port parity: AdamW and the SGDR schedule against the JAX package's
``repro.optim``, on the same numpy-seeded parameters and gradients.

Tolerances: SGDR atol/rtol 1e-7 (the same float32 ops in the same
order; the cycle index must match exactly); AdamW rtol 1e-6 / atol 1e-9
on parameters and moments after 3 steps (elementwise float32 ops in the
same order; only the global norm's sum and the library's pow/sqrt may
round differently).
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.optim import adamw as JA
from repro.optim.schedule import sgdr_schedule as j_sgdr
from repro_torch import bridge
from repro_torch.config import get_config
from repro_torch.optim import adamw_init, adamw_update, sgdr_schedule
from repro_torch.tree import tree_leaves

# Small shapes: one intra-op thread keeps these tests from loading the
# CPU that the other test workers share.
torch.set_num_threads(1)


@pytest.mark.parametrize("t_mult,t0", [(1, 7), (2, 5), (2, 100)])
def test_sgdr_matches_jax_across_cycles(t_mult, t0):
    steps = np.arange(0, 12 * t0 if t_mult == 1 else 40 * t0,
                      dtype=np.float32)
    want = np.asarray(j_sgdr(jnp.asarray(steps), lr_max=2e-3, lr_min=2e-5,
                             t0=t0, t_mult=t_mult))
    got = sgdr_schedule(torch.as_tensor(steps), lr_max=2e-3, lr_min=2e-5,
                        t0=t0, t_mult=t_mult).numpy()
    np.testing.assert_allclose(got, want, atol=1e-7, rtol=1e-7)
    # the restarts are there: the rate jumps back to lr_max
    assert (np.diff(got) > 1e-3).sum() >= 3
    # a scalar step (the optimizer's int32 count) gives the same value
    k = int(steps[len(steps) // 3])
    assert float(sgdr_schedule(torch.tensor(k, dtype=torch.int32),
                               lr_max=2e-3, lr_min=2e-5, t0=t0,
                               t_mult=t_mult)) == pytest.approx(
        float(want[k]), abs=1e-9)


def _tree(rng, scale=1.0):
    return {"a": {"w": (rng.normal(0, scale, (4, 3, 5))).astype(np.float32),
                  "b": (rng.normal(0, scale, (4, 5))).astype(np.float32)},
            "layers": [{"log_s": rng.normal(0, scale, (6,)).astype(np.float32)},
                       {"log_s": rng.normal(0, scale, (2,)).astype(np.float32)}]}


@pytest.mark.parametrize("grad_clip,gscale", [(1.0, 3.0), (1.0, 0.01),
                                              (0.0, 1.0)])
def test_adamw_update_matches_jax(grad_clip, gscale):
    """3 steps on identical numpy gradients, with the clip active
    (gnorm ~ 3 * sqrt(97) > 1), inactive (gnorm < 1), and off."""
    rng = np.random.default_rng(int(gscale * 100) + int(grad_clip))
    params = _tree(rng)
    grads = [_tree(rng, gscale) for _ in range(3)]
    jp = jax.tree.map(jnp.asarray, params)
    jo = JA.adamw_init(jp)
    tp = jax.tree.map(torch.as_tensor, params)
    to = adamw_init(tp)
    for k, g in enumerate(grads):
        lr = 2e-3 * (1 - 0.2 * k)
        jp, jo = JA.adamw_update(jax.tree.map(jnp.asarray, g), jo, jp,
                                 lr=jnp.float32(lr), weight_decay=1e-4,
                                 grad_clip=grad_clip)
        tp, to = adamw_update(jax.tree.map(torch.as_tensor, g), to, tp,
                              lr=torch.tensor(lr, dtype=torch.float32),
                              weight_decay=1e-4, grad_clip=grad_clip)
    tol = dict(rtol=1e-6, atol=1e-9)
    for got, want in ((tp, jp), (to["m"], jo["m"]), (to["v"], jo["v"])):
        gl, wl = tree_leaves(got), jax.tree.leaves(want)
        assert len(gl) == len(wl) == 4
        for a, b in zip(gl, wl):
            np.testing.assert_allclose(a.numpy(), np.asarray(b), **tol)
    assert int(to["count"]) == int(jo["count"]) == 3
    assert to["count"].dtype == torch.int32


def test_opt_bridge_round_trip():
    """The reference's AdamW state (master all None) bridges to the
    port's, and params_to_numpy gives back the reference layout."""
    import importlib
    from repro.core import model as JM
    jcfg = importlib.import_module("repro.configs.neuralut_jsc_2l").reduced()
    pcfg = get_config("neuralut-jsc-2l", reduced=True)
    spec_p, _ = JM.model_spec(jcfg)
    rng = np.random.default_rng(0)
    params = jax.tree.map(
        lambda s: rng.normal(0, 1, s.shape).astype(np.float32), spec_p,
        is_leaf=lambda x: isinstance(x, jax.ShapeDtypeStruct))
    jo = JA.adamw_init(jax.tree.map(jnp.asarray, params))
    jo["m"] = jax.tree.map(lambda a: a + 0.5, jo["m"])
    jo["count"] = jnp.asarray(4, jnp.int32)
    opt = bridge.opt_from_numpy(pcfg, jax.tree.map(
        lambda a: None if a is None else np.asarray(a), jo,
        is_leaf=lambda x: x is None), device="cpu")
    assert set(opt) == {"m", "v", "count"} and int(opt["count"]) == 4
    back = bridge.params_to_numpy(opt["m"])
    assert jax.tree.structure(back) == jax.tree.structure(
        jax.tree.map(np.asarray, jo["m"]))
    for a, b in zip(jax.tree.leaves(back), jax.tree.leaves(jo["m"])):
        np.testing.assert_array_equal(a, np.asarray(b))
    bad = dict(jo, master=jax.tree.map(np.asarray, jo["m"]))
    with pytest.raises(ValueError, match="master"):
        bridge.opt_from_numpy(pcfg, bad, device="cpu")
