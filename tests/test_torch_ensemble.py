"""Port parity: the seed ensemble (``train_neuralut_ensemble``,
``make_ensemble_step_fn``) and the training kernels over a leading seed
axis, against the JAX package's ``jax.vmap`` of the same functions.

Both packages start from one bridged stacked state (numpy-seeded
members in the JAX tree layout, one connectivity) and get the same
numpy batches per seed.  Tolerances, and why:

* sub-network outputs atol/rtol 1e-5, gradients rtol 2e-4 / atol 3e-5
  (the reference's own gradient tolerance): float32 sums taken in
  another order;
* one ensemble step: loss rtol 1e-5, new BN state atol/rtol 1e-5, the
  moments at the gradients' tolerance scaled as they are, and the
  parameters where the gradient carries signal (|g| > 1e-5) at rtol
  1e-3 / atol 1e-6, as ``tests/test_torch_train.py`` holds one step;
* AdamW under vmap rtol 1e-6 / atol 1e-9, as ``test_torch_optim.py``;
* an ensemble member against ``train_neuralut`` of its seed: atol 1e-5
  / rtol 1e-4 on every parameter and BN leaf and on the history after
  6 steps (the same float32 ops per seed, batched; bit-identical in
  CPU runs, the tolerance covers a batched product summing in another
  order).
"""
import importlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import model as JM
from repro.core import subnet as JS
from repro.core.exec_plan import plan_subnet_exec as j_plan
from repro.core.train import make_step_fn_dynamic
from repro.kernels.ops import subnet_train_apply as j_subnet_train_apply
from repro.optim import adamw as JA
from repro_torch import bridge
from repro_torch.config import get_config
from repro_torch.core import train as TR
from repro_torch.core.exec_plan import plan_subnet_exec
from repro_torch.data import jsc_synthetic
from repro_torch.kernels import neuralut_grad as NG
from repro_torch.kernels.ref import subnet_train_bwd_ref, subnet_train_fwd_ref
from repro_torch.launch import train as LT
from repro_torch.optim import adamw_init, adamw_update
from repro_torch.tree import tree_leaves
from test_torch_model import numpy_model

# Small shapes: one intra-op thread keeps these tests from loading the
# CPU that the other test workers share.
torch.set_num_threads(1)

OUT_TOL = dict(atol=1e-5, rtol=1e-5)
GRAD_TOL = dict(atol=3e-5, rtol=2e-4)
TOL = dict(rtol=1e-5, atol=1e-5)
LR, WD, T0 = 2e-3, 1e-4, 50
S, B = 3, 64


def _stack(trees):
    return jax.tree.map(lambda *a: np.stack(a), *trees)


def _subnets(o, f, depth, width, skip, seed):
    """S seeded numpy sub-networks (the reference's tree, stacked) and an
    (S, B, O, F) input."""
    rng = np.random.default_rng(seed)
    spec = JS.subnet_spec(o, f, depth, width, skip)

    def leaf(sds):
        return (rng.normal(0, 1, (S,) + sds.shape)
                / np.sqrt(max(sds.shape[-2], 1)) if len(sds.shape) >= 2
                else rng.normal(0, 0.3, (S,) + sds.shape)).astype(np.float32)
    p = jax.tree.map(leaf, spec,
                     is_leaf=lambda x: isinstance(x, jax.ShapeDtypeStruct))
    return p, rng.normal(0, 1, (S, B, o, f)).astype(np.float32)


@pytest.mark.parametrize("skip", [0, 2])
def test_vmapped_train_fn_matches_jax_vmap(skip):
    """``torch.func.vmap`` of the training op's value and gradient
    against ``jax.vmap`` of the reference's Pallas training op in
    interpret mode; the vmap rules run each plain version once, on the
    whole seed axis."""
    o, f, depth, width = 5, 3, 4, 8
    p, x = _subnets(o, f, depth, width, skip, seed=40 + skip)

    def jloss(pp, xx):
        y = j_subnet_train_apply(pp, xx, skip, interpret=True)
        return jnp.sum(jnp.sin(y)), y
    (_, jy), (jgp, jgx) = jax.vmap(jax.value_and_grad(
        jloss, argnums=(0, 1), has_aux=True))(
        jax.tree.map(jnp.asarray, p), jnp.asarray(x))

    calls = []
    fwd, bwd = NG.subnet_train_fwd_ref, NG.subnet_train_bwd_ref

    def spy(fn, name):
        def wrapped(*a, **k):
            calls.append((name, tuple(a[1].shape if name == "bwd"
                                      else a[0].shape)))
            return fn(*a, **k)
        return wrapped
    NG.subnet_train_fwd_ref = spy(fwd, "fwd")
    NG.subnet_train_bwd_ref = spy(bwd, "bwd")
    try:
        def tloss(pp, xx):
            y = NG.subnet_train_apply(pp, xx, skip)
            return torch.sin(y).sum(), y
        (tgp, tgx), (_, ty) = torch.func.vmap(torch.func.grad_and_value(
            tloss, argnums=(0, 1), has_aux=True))(
            jax.tree.map(torch.as_tensor, p), torch.as_tensor(x))
    finally:
        NG.subnet_train_fwd_ref, NG.subnet_train_bwd_ref = fwd, bwd
    assert calls == [("fwd", (S, B, o, f)), ("bwd", (S, B, o, f))]
    np.testing.assert_allclose(ty.numpy(), np.asarray(jy), **OUT_TOL)
    np.testing.assert_allclose(tgx.numpy(), np.asarray(jgx), **GRAD_TOL)
    got, want = tree_leaves(tgp), jax.tree.leaves(jgp)
    assert len(got) == len(want) == len(jax.tree.leaves(p))
    for a, b in zip(got, want):
        assert a.shape[0] == S
        np.testing.assert_allclose(a.numpy(), np.asarray(b), **GRAD_TOL)


def test_seed_axis_plain_versions_match_per_seed():
    """The plain forward and backward over a leading seed axis equal
    S separate single-network calls."""
    o, f, depth, width, skip = 6, 3, 4, 8, 2
    p, x = _subnets(o, f, depth, width, skip, seed=7)
    g = np.random.default_rng(8).normal(0, 1, (S, B, o)).astype(np.float32)
    t = jax.tree.map(torch.as_tensor, p)
    lw = [lp["w"] for lp in t["layers"]]
    lb = [lp["b"] for lp in t["layers"]]
    sw = [sp["w"] for sp in t["skips"]]
    sb = [sp["b"] for sp in t["skips"]]
    out, acts = subnet_train_fwd_ref(torch.as_tensor(x), lw, lb, sw, sb,
                                     skip=skip)
    grads = subnet_train_bwd_ref(torch.as_tensor(g), torch.as_tensor(x),
                                 acts, lw, sw, skip=skip)
    assert out.shape == (S, B, o)
    for s in range(S):
        one = [a[s] for a in lw], [a[s] for a in lb], [a[s] for a in sw], \
            [a[s] for a in sb]
        o1, a1 = subnet_train_fwd_ref(torch.as_tensor(x[s]), *one,
                                      skip=skip)
        np.testing.assert_allclose(out[s].numpy(), o1.numpy(), **OUT_TOL)
        for a, b in zip(acts, a1):
            np.testing.assert_allclose(a[s].numpy(), b.numpy(), **OUT_TOL)
        g1 = subnet_train_bwd_ref(torch.as_tensor(g[s]),
                                  torch.as_tensor(x[s]), a1, one[0],
                                  one[2], skip=skip)
        flat = [grads[0][s]] + [v[s] for grp in grads[1:] for v in grp]
        flat1 = [g1[0]] + [v for grp in g1[1:] for v in grp]
        assert len(flat) == len(flat1) == 1 + 2 * depth + 2 * (depth // skip)
        for a, b in zip(flat, flat1):
            np.testing.assert_allclose(a.numpy(), b.numpy(), **GRAD_TOL)


def _stacked_model(seeds):
    jcfg = importlib.import_module("repro.configs.neuralut_jsc_5l").reduced()
    pcfg = get_config("neuralut-jsc-5l", reduced=True)
    statics = JM.model_static(jcfg)
    members = [numpy_model(jcfg, s) for s in seeds]
    params_np = _stack([m[0] for m in members])
    state_np = _stack([m[1] for m in members])
    p, s = bridge.params_from_numpy(pcfg, params_np, state_np,
                                    device="cpu", seeds=len(seeds))
    return (jcfg, params_np, state_np, statics,
            pcfg, p, s, bridge.statics_from_numpy(pcfg, statics))


@pytest.mark.parametrize("route", ["neuron_leading", "kernel_train"])
def test_one_ensemble_step_matches_jax_vmap(route):
    """One step of S = 3 seeds from one bridged stacked state, each seed
    on its own batch, against ``jax.vmap(make_step_fn_dynamic(...),
    in_axes=(0, 0, 0, None, 0, 0))`` on the reference's neuron_leading
    route."""
    (jcfg, params_np, state_np, statics,
     pcfg, p, s, st) = _stacked_model((10, 11, 12))
    x, y = jsc_synthetic(S * B, seed=9)
    x, y = x.reshape(S, B, -1), y.reshape(S, B)

    jp = jax.tree.map(jnp.asarray, params_np)
    js = jax.tree.map(jnp.asarray, state_np)
    jo = jax.vmap(JA.adamw_init)(jp)
    o = bridge.opt_from_numpy(pcfg, jax.tree.map(
        lambda a: None if a is None else np.asarray(a), jo,
        is_leaf=lambda a: a is None), device="cpu", seeds=S)
    jstep = jax.jit(jax.vmap(make_step_fn_dynamic(
        jcfg, lr=LR, weight_decay=WD, t0=T0,
        exec_plan=j_plan(jcfg, purpose="train", route="neuron_leading")),
        in_axes=(0, 0, 0, None, 0, 0)))
    jp1, js1, jo1, jl = jstep(jp, js, jo, statics, jnp.asarray(x),
                              jnp.asarray(y))

    step = TR.make_ensemble_step_fn(
        pcfg, lr=LR, weight_decay=WD, t0=T0,
        exec_plan=plan_subnet_exec(pcfg, purpose="train", route=route))
    sd = [{"conn": torch.as_tensor(a["conn"]).long()} for a in st]
    p1, s1, o1, loss = step(p, s, o, TR.unit_statics(sd, S),
                            torch.as_tensor(x), torch.as_tensor(y))

    assert loss.shape == (S,)
    np.testing.assert_allclose(loss.numpy(), np.asarray(jl), rtol=1e-5)
    assert o1["count"].tolist() == np.asarray(jo1["count"]).tolist() == [1] * S
    for a, b in zip(tree_leaves(s1), jax.tree.leaves(js1)):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), **TOL)
    for key, tol in (("m", dict(rtol=2e-4, atol=3e-6)),
                     ("v", dict(rtol=4e-4, atol=1e-7))):
        for a, b in zip(tree_leaves(o1[key]), jax.tree.leaves(jo1[key])):
            np.testing.assert_allclose(a.numpy(), np.asarray(b), **tol)
    # each seed's own gradient marks where a parameter carries signal
    masks = [[], [], []]
    for k in range(S):
        pk = jax.tree.map(lambda a: a[k], p)
        sk = jax.tree.map(lambda a: a[k], s)
        _, g, _ = TR.loss_and_grads(
            pcfg, pk, sk, sd, torch.as_tensor(x[k]), torch.as_tensor(y[k]),
            exec_plan=plan_subnet_exec(pcfg, purpose="train", device="cpu"))
        masks[k] = [np.abs(a.numpy()) > 1e-5 for a in tree_leaves(g)]
    compared = 0
    for i, (a, b) in enumerate(zip(tree_leaves(p1), jax.tree.leaves(jp1))):
        m = np.stack([masks[k][i] for k in range(S)])
        compared += int(m.sum())
        np.testing.assert_allclose(a.numpy()[m], np.asarray(b)[m],
                                   rtol=1e-3, atol=1e-6)
    assert compared > 300  # the mask must not trivialize the check


def test_clip_is_per_seed_under_the_seed_axis():
    """AdamW under ``torch.func.vmap`` (as the ensemble step runs it)
    clips each seed's global norm on its own: seed 0's gradient norm is
    above 1 and is clipped, seed 1's is below and is not, and both equal
    their single-seed updates and ``jax.vmap`` of the reference's."""
    rng = np.random.default_rng(3)
    shapes = {"w": (4, 3, 5), "b": (4, 5), "log_s": (6,)}
    params = {k: rng.normal(0, 1, (2,) + v).astype(np.float32)
              for k, v in shapes.items()}
    grads = {k: (rng.normal(0, 1, (2,) + v) * np.array([3.0, 0.01]).reshape(
        (2,) + (1,) * len(v))).astype(np.float32) for k, v in shapes.items()}
    norms = np.sqrt(sum((g.reshape(2, -1) ** 2).sum(1)
                        for g in grads.values()))
    assert norms[0] > 1 > norms[1]

    def upd(g, o, p):
        return adamw_update(g, o, p, lr=torch.tensor(2e-3), weight_decay=1e-4,
                            grad_clip=1.0)
    tp = {k: torch.as_tensor(v) for k, v in params.items()}
    to = adamw_init(tp)
    to["count"] = torch.zeros(2, dtype=torch.int32)
    vp, vo = torch.func.vmap(upd)({k: torch.as_tensor(v)
                                   for k, v in grads.items()}, to, tp)

    jp = jax.tree.map(jnp.asarray, params)
    jvp, jvo = jax.vmap(lambda g, o, p: JA.adamw_update(
        g, o, p, lr=jnp.float32(2e-3), weight_decay=1e-4, grad_clip=1.0))(
        jax.tree.map(jnp.asarray, grads), jax.vmap(JA.adamw_init)(jp), jp)
    tol = dict(rtol=1e-6, atol=1e-9)
    for got, want in ((vp, jvp), (vo["m"], jvo["m"]), (vo["v"], jvo["v"])):
        for k in shapes:
            np.testing.assert_allclose(got[k].numpy(), np.asarray(want[k]),
                                       **tol)
    for sd in range(2):
        one = {k: torch.as_tensor(v[sd]) for k, v in params.items()}
        p1, o1 = adamw_update({k: torch.as_tensor(v[sd])
                               for k, v in grads.items()}, adamw_init(one),
                              one, lr=torch.tensor(2e-3), weight_decay=1e-4,
                              grad_clip=1.0)
        for k in shapes:
            np.testing.assert_allclose(vp[k][sd].numpy(), p1[k].numpy(),
                                       **tol)
            np.testing.assert_allclose(vo["m"][k][sd].numpy(),
                                       o1["m"][k].numpy(), **tol)
    # m = 0.1 * (clip scale) * g: seed 0 scaled by 1 / norm, seed 1 not
    for sd, scale in ((0, 1 / norms[0]), (1, 1.0)):
        np.testing.assert_allclose(vo["m"]["w"][sd].numpy(),
                                   0.1 * scale * grads["w"][sd], rtol=1e-5)


def _data(n_train=768, n_test=200):
    x, y = jsc_synthetic(n_train, seed=0)
    xt, yt = jsc_synthetic(n_test, seed=1)
    return x, y, xt, yt


def test_ensemble_member_follows_its_single_seed_run():
    cfg = get_config("neuralut-jsc-5l", reduced=True)
    x, y, xt, yt = _data()
    seeds = (0, 3)
    params, state, hist = TR.train_neuralut_ensemble(
        cfg, x, y, xt, yt, seeds=seeds, epochs=2, batch=256, device="cpu")
    for k, sd in enumerate(seeds):
        p1, s1, h1 = TR.train_neuralut(cfg, x, y, xt, yt, epochs=2,
                                       batch=256, seed=sd, device="cpu")
        pm, sm = TR.ensemble_member(params, state, k)
        for a, b in zip(tree_leaves(pm) + tree_leaves(sm),
                        tree_leaves(p1) + tree_leaves(s1)):
            assert a.shape == b.shape
            np.testing.assert_allclose(a.numpy(), b.numpy(), atol=1e-5,
                                       rtol=1e-4)
        for key in h1:
            np.testing.assert_allclose(hist[key][:, k], h1[key], atol=1e-5,
                                       rtol=1e-4)


def test_ensemble_history_shapes_and_distinct_members():
    cfg = get_config("neuralut-jsc-5l", reduced=True)
    x, y, xt, yt = _data()
    params, state, hist = TR.train_neuralut_ensemble(
        cfg, x, y, xt, yt, seeds=(0, 1, 2), epochs=2, batch=256,
        device="cpu")
    assert set(hist) == {"loss", "test_acc", "test_acc_q"}
    for v in hist.values():
        assert v.shape == (2, 3) and v.dtype == np.float64
        assert np.isfinite(v).all()
    assert all(leaf.shape[0] == 3
               for leaf in tree_leaves(params) + tree_leaves(state))
    w = params["layers"][0]["fn"]["layers"][0]["w"]
    assert not torch.equal(w[0], w[1]) and not torch.equal(w[1], w[2])
    # the input quantizer is calibrated once, from the data, for all
    p0, s0, o0 = TR.init_ensemble(cfg, (0, 1, 2), x, device="cpu")
    iq = p0["in_quant"]["log_s"]
    assert torch.equal(iq[0], iq[1]) and torch.equal(iq[1], iq[2])
    assert o0["count"].shape == (3,)
    assert all(a.shape[0] == 3 for a in tree_leaves(s0))
    pm, sm = TR.ensemble_member(params, state, 2)
    p1, s1 = bridge.params_from_numpy(
        cfg, bridge.params_to_numpy(pm), bridge.params_to_numpy(sm),
        device="cpu")  # the member has the single-model shape tree
    assert [a.shape for a in tree_leaves(p1)] \
        == [a.shape[1:] for a in tree_leaves(params)]
    with pytest.raises(ValueError, match="seed"):
        TR.init_ensemble(cfg, (), x, device="cpu")


def test_stacked_bridge_checks_the_seed_axis():
    cfg = get_config("neuralut-jsc-5l", reduced=True)
    (_, params_np, state_np, _, _, p, s, _) = _stacked_model((1, 2))
    assert all(a.shape[0] == 2 for a in tree_leaves(p) + tree_leaves(s))
    with pytest.raises(ValueError, match="shape"):
        bridge.params_from_numpy(cfg, params_np, state_np, device="cpu",
                                 seeds=3)
    with pytest.raises(ValueError, match="shape"):
        bridge.params_from_numpy(cfg, params_np, state_np, device="cpu")
    o = adamw_init(p)
    with pytest.raises(ValueError, match="count"):
        bridge.opt_from_numpy(cfg, {"m": bridge.params_to_numpy(o["m"]),
                                    "v": bridge.params_to_numpy(o["v"]),
                                    "count": np.int32(0)},
                              device="cpu", seeds=2)


def test_launch_train_seeds_cpu():
    out = LT.main(["--arch", "neuralut-jsc-5l", "--reduced", "--epochs",
                   "1", "--seeds", "2", "--device", "cpu",
                   "--log-every", "0"])
    assert out["mismatches"] == 0 and out["steps"] == 2 * 78
    assert out["best_seed"] in (0, 1)
    assert out["history"]["test_acc_q"].shape == (1, 2)
    assert out["acc_q"] == out["history"]["test_acc_q"][0, out["best_seed"]]
    with pytest.raises(SystemExit):
        LT.main(["--arch", "neuralut-jsc-5l", "--reduced", "--epochs", "1",
                 "--seeds", "0", "--device", "cpu"])
