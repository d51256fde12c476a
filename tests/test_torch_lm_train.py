"""Port parity of the LM training step (``repro_torch.train.step``,
``repro_torch.optim``) against the reference's on the CPU: one and three
``make_train_step`` steps from one bridged state, gradient accumulation
(as ``tests/test_system.py``), the error-feedback int8 compressor (as
``tests/test_optim.py``) and AdamW's float32 master for bfloat16
parameters.

Tolerances (float32): the loss to rtol 1e-5; params and moments after
a step to atol 1e-5 (lr / 300) + rtol 1e-5 where the reference's gradient at each
step so far is at least 1e-5 of its leaf's largest element, within the
steps' reach (2 lr per step) elsewhere: Adam's update lr m / sqrt(v)
takes the size of the gradient away, so at an element whose gradient
is mostly cancellation the two packages' rounding moves it by up to lr.
The params move by ~lr per step, so a wrong update (sign, scale, bias
correction) is off by ~1e-4 or more where the gradient is not small.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.config import TrainConfig as JTrain
from repro.config import get_config as j_get_config
from repro.models import api as JA
from repro.optim.adamw import adamw_init as j_adamw_init
from repro.optim.adamw import adamw_update as j_adamw_update
from repro.optim.grad_compress import make_ef_int8_compressor as j_ef
from repro.train.step import make_train_step as j_make_train_step
from repro_torch import bridge
from repro_torch.config import TrainConfig, get_config
from repro_torch.data import lm_batch_fn
from repro_torch.models import api
from repro_torch.optim import (adamw_init, adamw_update,
                               make_ef_int8_compressor)
from repro_torch.optim.grad_compress import psum_int8
from repro_torch.train.step import make_train_step
from repro_torch.tree import tree_leaves

torch.set_num_threads(1)

ARCH = "lm-100m"
STEP = dict(rtol=1e-5, atol=1e-5)
TCFG = dict(lr=3e-3, sgdr_t0=4, weight_decay=0.01)


def _cfgs(dtype="float32"):
    return (dataclasses.replace(get_config(ARCH, reduced=True), dtype=dtype),
            dataclasses.replace(j_get_config(ARCH, reduced=True),
                                dtype=dtype))


def _np(tree):
    return jax.tree.map(lambda a: np.asarray(a, np.float32), tree)


GRAD_T = 1e-5   # of a leaf's largest gradient: below it, within reach


def _close_trees(got, want, loose=None, reach=0.0):
    """Leaf by leaf at STEP; elements marked in ``loose`` within
    ``reach`` instead."""
    g, w = tree_leaves(bridge.params_to_numpy(got)), jax.tree.leaves(want)
    assert len(g) == len(w)
    masks = loose or [np.zeros(a.shape, bool) for a in g]
    for a, b, m in zip(g, w, masks):
        np.testing.assert_allclose(a[~m], b[~m], **STEP)
        assert np.all(np.abs(a[m] - b[m]) <= reach + STEP["atol"])


def _small(grads, loose=None):
    """Where each gradient leaf is below GRAD_T of its largest element,
    or'ed into ``loose``."""
    out = [np.abs(g) < GRAD_T * np.abs(g).max()
           for g in jax.tree.leaves(_np(grads))]
    return out if loose is None else [a | b for a, b in zip(loose, out)]


@pytest.fixture(scope="module")
def three_steps():
    """The reference's params and opt state after steps 1, 2 and 3 of
    lm_batch_fn's batches, from params the port drew."""
    cfg, jcfg = _cfgs()
    p_np = bridge.params_to_numpy(api.init_params(
        cfg, torch.Generator().manual_seed(0)))
    make = lm_batch_fn(cfg.vocab_size, 4, 32, seed=0)
    step = jax.jit(j_make_train_step(jcfg, JTrain(**TCFG), q_chunk=16))
    grad = jax.jit(jax.grad(lambda p, b: JA.loss_fn(jcfg, p, b,
                                                    q_chunk=16)[0]))
    p = jax.tree.map(jnp.asarray, p_np)
    o = j_adamw_init(p)
    out, loose = [], None
    for s in range(3):
        loose = _small(grad(p, make(s)), loose)
        p, o, m = step(p, o, make(s))
        out.append((_np(p), _np({k: o[k] for k in ("m", "v", "count")}),
                    float(m["loss"]), float(m["lr"]), loose))
    return p_np, make, out


def test_one_and_three_steps_match_reference(three_steps):
    cfg, _ = _cfgs()
    p_np, make, out = three_steps
    params = bridge.lm_params_from_numpy(cfg, p_np, device="cpu")
    opt = adamw_init(params)
    assert "master" not in opt   # float32 params keep no master
    step = make_train_step(cfg, TrainConfig(**TCFG), q_chunk=16)
    for s, (jp, jo, jloss, jlr, loose) in enumerate(out):
        batch = {k: torch.as_tensor(v) for k, v in make(s).items()}
        before = [t.clone() for t in tree_leaves((params, opt))]
        new_p, new_o, m = step(params, opt, batch)
        # the step builds new trees: its inputs are left as they were
        assert all(torch.equal(a, b) for a, b in
                   zip(before, tree_leaves((params, opt))))
        params, opt = new_p, new_o
        assert float(m["loss"]) == pytest.approx(jloss, rel=1e-5)
        assert float(m["lr"]) == pytest.approx(jlr, rel=1e-6)
        reach = 2 * TCFG["lr"] * (s + 1)
        _close_trees(params, jp, loose, reach)
        _close_trees(opt["m"], jo["m"], loose, reach)
        assert int(opt["count"]) == int(jo["count"]) == s + 1
        # the split leaves at most 0.5 % of the elements to their reach
        assert sum(int(m.sum()) for m in loose) < 5e-3 * sum(
            m.size for m in loose)


def test_opt_bridge_round_trip(three_steps):
    """The reference's AdamW state of an LM bridges to the port's; a
    bfloat16 config's carries the master tree."""
    cfg, jcfg = _cfgs("bfloat16")
    p_np = bridge.params_to_numpy(api.init_params(
        cfg, torch.Generator().manual_seed(0)))
    jo = j_adamw_init(jax.tree.map(lambda a: jnp.asarray(a, jnp.bfloat16),
                                   p_np))
    o = bridge.lm_opt_from_numpy(cfg, jax.tree.map(
        lambda a: np.asarray(a, np.float32), jo), device="cpu")
    assert set(o) == {"m", "v", "count", "master"}
    ours = adamw_init(bridge.lm_params_from_numpy(cfg, p_np, device="cpu"))
    for a, b in zip(tree_leaves(o), tree_leaves(ours)):
        assert torch.equal(a, b)
    f32, _ = _cfgs()
    jo32 = j_adamw_init(jax.tree.map(jnp.asarray, p_np))
    o32 = bridge.lm_opt_from_numpy(f32, jax.tree.map(np.asarray, jo32),
                                   device="cpu")
    assert set(o32) == {"m", "v", "count"}


def test_grad_accum_matches_single_batch():
    """Microbatched gradient accumulation equals one big batch (the
    reference's tolerances, tests/test_system.py), and the port's
    accumulated step equals the reference's."""
    cfg, jcfg = _cfgs()
    params = api.init_params(cfg, torch.Generator().manual_seed(1))
    batch = api.make_batch(cfg, api.ShapeConfig("t", "train", 32, 4),
                           torch.Generator().manual_seed(2))
    s1 = make_train_step(cfg, TrainConfig(grad_accum=1), q_chunk=32)
    s2 = make_train_step(cfg, TrainConfig(grad_accum=2), q_chunk=32)
    p1, _, m1 = s1(params, adamw_init(params), batch)
    p2, _, m2 = s2(params, adamw_init(params), batch)
    for a, b in zip(tree_leaves(p1), tree_leaves(p2)):
        np.testing.assert_allclose(a.numpy(), b.numpy(), rtol=2e-2,
                                   atol=2e-3)
    assert float(m2["loss"]) == pytest.approx(float(m1["loss"]), rel=1e-5)
    jp = jax.tree.map(jnp.asarray, bridge.params_to_numpy(params))
    jstep = jax.jit(j_make_train_step(jcfg, JTrain(grad_accum=2),
                                      q_chunk=32))
    nb = {k: v.numpy() for k, v in batch.items()}
    jp2, _, jm2 = jstep(jp, j_adamw_init(jp), nb)
    assert float(m2["loss"]) == pytest.approx(float(jm2["loss"]), rel=1e-5)
    loose = _small(jax.jit(jax.grad(lambda p, b: JA.loss_fn(
        jcfg, p, b, q_chunk=32)[0]))(jp, nb))
    _close_trees(p2, _np(jp2), loose, 2 * TrainConfig().lr)


def test_compressed_step_matches_reference():
    """make_train_step with the EF-int8 hook (the launcher's
    --compress-grads) against the reference's, two steps."""
    cfg, jcfg = _cfgs()
    p_np = bridge.params_to_numpy(api.init_params(
        cfg, torch.Generator().manual_seed(3)))
    make = lm_batch_fn(cfg.vocab_size, 2, 32, seed=1)

    def hooked(init, compress, params):
        cell = {"ef": init(params)}

        def hook(g):
            g2, cell["ef"] = compress(g, cell["ef"])
            return g2
        return hook, cell

    params = bridge.lm_params_from_numpy(cfg, p_np, device="cpu")
    hook, cell = hooked(*make_ef_int8_compressor(), params)
    step = make_train_step(cfg, TrainConfig(**TCFG), q_chunk=16,
                           compress_grads=hook)
    j_init, j_compress = j_ef()

    @jax.jit
    def jstep(p, o, ef, b):
        # the hook's residual cell lives inside the trace
        jhook, jcell = hooked(lambda _: ef, j_compress, p)
        p, o, m = j_make_train_step(jcfg, JTrain(**TCFG), q_chunk=16,
                                    compress_grads=jhook)(p, o, b)
        return p, o, jcell["ef"]

    jp = jax.tree.map(jnp.asarray, p_np)
    opt, jo, jef = adamw_init(params), j_adamw_init(jp), j_init(jp)
    for s in range(2):
        b = make(s)
        params, opt, _ = step(params, opt,
                              {k: torch.as_tensor(v) for k, v in b.items()})
        jp, jo, jef = jstep(jp, jo, jef, b)
    _close_trees(params, _np(jp))
    for a, b in zip(tree_leaves(cell["ef"]), jax.tree.leaves(jef)):
        assert a.dtype == torch.float32
        np.testing.assert_allclose(a.numpy(), np.asarray(b), rtol=1e-3,
                                   atol=1e-6)


def test_ef_int8_compressor_converges():
    """Error feedback: compressed SGD still drives a quadratic to zero
    and the residual stays bounded (tests/test_optim.py)."""
    init, compress = make_ef_int8_compressor()
    w = {"w": torch.as_tensor(np.random.default_rng(1).normal(0, 1, (16,))
                              .astype(np.float32))}
    ef = init(w)
    for _ in range(200):
        gq, ef = compress({"w": w["w"]}, ef)   # grad of 0.5||w||^2
        w = {"w": w["w"] - 0.1 * gq["w"]}
    assert float(torch.linalg.norm(w["w"])) < 1e-2
    assert float(torch.linalg.norm(ef["w"])) < 1.0


def test_ef_quantization_is_int8_grid():
    init, compress = make_ef_int8_compressor()
    g = {"w": torch.tensor([0.5, -1.0, 0.25, 1.0])}
    gq, ef = compress(g, init(g))
    ratio = gq["w"].numpy() / (1.0 / 127.0)
    np.testing.assert_allclose(ratio, np.round(ratio), atol=1e-4)
    jgq, jef = j_ef()[1]({"w": jnp.asarray(g["w"].numpy())},
                         {"w": jnp.zeros(4)})
    np.testing.assert_array_equal(gq["w"].numpy(), np.asarray(jgq["w"]))
    np.testing.assert_array_equal(ef["w"].numpy(), np.asarray(jef["w"]))
    # the compressed collective needs a mesh axis to sum over (the
    # reference's outside shard_map: an unbound axis name)
    with pytest.raises(NameError, match="unbound axis name: data"):
        psum_int8(g, "data")


def test_adamw_bf16_master_matches_reference():
    """bfloat16 params: the update steps a float32 master and rounds it
    to the param; three steps against the reference's adamw_update."""
    rng = np.random.default_rng(4)
    p_np = {"a": rng.normal(0, 1, (8, 4)).astype(np.float32),
            "b": rng.normal(0, 1, (4,)).astype(np.float32)}
    params = {"a": torch.as_tensor(p_np["a"]).to(torch.bfloat16),
              "b": torch.as_tensor(p_np["b"])}
    jparams = {"a": jnp.asarray(p_np["a"], jnp.bfloat16),
               "b": jnp.asarray(p_np["b"])}
    opt, jopt = adamw_init(params), j_adamw_init(jparams)
    assert opt["master"]["b"] is None and jopt["master"]["b"] is None
    assert opt["master"]["a"].dtype == torch.float32
    kw = dict(lr=1e-3, weight_decay=0.1, grad_clip=1.0)
    for s in range(3):
        g = {k: rng.normal(0, 1, v.shape).astype(np.float32)
             for k, v in p_np.items()}
        params, opt = adamw_update(
            {"a": torch.as_tensor(g["a"]).to(torch.bfloat16),
             "b": torch.as_tensor(g["b"])}, opt, params, **kw)
        jparams, jopt = j_adamw_update(
            {"a": jnp.asarray(g["a"], jnp.bfloat16),
             "b": jnp.asarray(g["b"])}, jopt, jparams, **kw)
        assert params["a"].dtype == torch.bfloat16
        assert torch.equal(params["a"], opt["master"]["a"].to(torch.bfloat16))
        np.testing.assert_allclose(opt["master"]["a"].numpy(),
                                   np.asarray(jopt["master"]["a"]), **STEP)
        np.testing.assert_array_equal(
            params["a"].float().numpy(),
            np.asarray(jparams["a"], np.float32))
        np.testing.assert_allclose(params["b"].numpy(),
                                   np.asarray(jparams["b"]), **STEP)
    # the master keeps updates below a bfloat16 ulp
    tiny = {"a": torch.full((8, 4), 1e-30).to(torch.bfloat16),
            "b": torch.zeros(4)}
    p2, o2 = adamw_update(tiny, opt, params, lr=1e-6)
    assert not torch.equal(o2["master"]["a"], opt["master"]["a"])
    assert torch.equal(p2["a"], params["a"])
