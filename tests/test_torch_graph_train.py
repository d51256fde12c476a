"""Port parity: training LUT graphs (PolyLUT-Add adder trees).

The reduced ``polylut-add-jsc-2l`` and ``-5l`` graphs start in both
packages from one bridged model (numpy parameters in the JAX
``graph_spec`` layout, per-branch BN state, connectivity drawn from a
fixed rng: the salted ``hash`` differs between processes) and get the
same numpy batches.  Tolerances, and why (as tests/test_torch_train.py
holds the chains):

* loss rtol 1e-5, every leaf's gradient rtol 2e-4 / atol 3e-5 (the
  reference's own gradient tolerance), new BN state atol/rtol 1e-5:
  float32 sums taken in another order;
* after one optimizer step the moments at the gradients' tolerance
  scaled as they are, the parameters where the gradient carries signal
  (|g| > 1e-5) at rtol 1e-3 / atol 1e-6 (Adam's first step is
  ``lr * sign(g)``);
* a 5-step loss trajectory at rtol 1e-3, loss level;
* an ensemble member against the single-seed run of its seed: atol 1e-5
  / rtol 1e-4, the ensemble test's rule (tests/test_torch_ensemble.py).

On the CPU the kernel_train route runs the training kernels' plain
versions; a spy on them shows one forward and one backward call per
branch per step, with the seed axis in front for the ensemble.
"""
import importlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import model as JM
from repro.core.exec_plan import plan_subnet_exec as j_plan
from repro.core.sparsity import random_connectivity
from repro.core.train import make_step_fn_dynamic
from repro.optim import adamw as JA
from repro_torch import bridge
from repro_torch.config import get_config
from repro_torch.core import lut_infer as LI
from repro_torch.core import model as M
from repro_torch.core import train as TR
from repro_torch.core import truth_table as TT
from repro_torch.core.exec_plan import plan_subnet_exec
from repro_torch.data import jsc_synthetic
from repro_torch.kernels import neuralut_grad as NG
from repro_torch.launch import train as LT
from repro_torch.serve import LUTServeEngine, bundle_from_training
from repro_torch.tree import tree_leaves
from test_torch_graph import _numpy_model

# Small shapes: one intra-op thread keeps these tests from loading the
# CPU that the other test workers share.
torch.set_num_threads(1)

POLYLUT = ["polylut_add_jsc_2l", "polylut_add_jsc_5l"]
GRAD_TOL = dict(rtol=2e-4, atol=3e-5)
TOL = dict(rtol=1e-5, atol=1e-5)
LR, WD, T0 = 2e-3, 1e-4, 50


def _fixed_conns(jcfg, seed):
    """Graph statics with every branch's connectivity drawn from
    ``np.random.default_rng(seed)``: the same in every process."""
    rng = np.random.default_rng(seed)
    return [{"conns": [random_connectivity(
        jcfg.node_in_width(i), nd.width, nd.fan_in,
        seed=int(rng.integers(2 ** 31))) for _ in range(nd.arity)]}
        for i, nd in enumerate(jcfg.nodes)]


def _models(mod, seed, conn_seed=0):
    jcfg = importlib.import_module(f"repro.configs.{mod}").reduced()
    pcfg = get_config(mod.replace("_", "-"), reduced=True)
    statics = _fixed_conns(jcfg, conn_seed)
    params_np, state_np = _numpy_model(jcfg, seed)
    p, s = bridge.params_from_numpy(pcfg, params_np, state_np,
                                    device="cpu")
    st = bridge.statics_from_numpy(pcfg, statics)
    return ((jcfg, jax.tree.map(jnp.asarray, params_np),
             jax.tree.map(jnp.asarray, state_np), statics),
            (pcfg, p, s, M.device_statics(st, torch.device("cpu"))))


def _batches(n_batches, b=64, seed=0):
    x, y = jsc_synthetic(n_batches * b, seed=seed)
    return [(x[k * b:(k + 1) * b], y[k * b:(k + 1) * b])
            for k in range(n_batches)]


def _branches(cfg) -> int:
    return sum(nd.arity for nd in cfg.nodes)


@pytest.mark.parametrize("route", ["neuron_leading", "kernel_train",
                                   "canonical"])
@pytest.mark.parametrize("mod", POLYLUT)
def test_graph_loss_grads_and_bn_state_match_jax(mod, route):
    (jcfg, jp, js, jst), (pcfg, p, s, st) = _models(mod, seed=2)
    (x, y), = _batches(1)

    def jloss(pp):
        logits, _, ns = JM.model_apply(
            jcfg, pp, js, jst, jnp.asarray(x), train=True,
            exec_plan=j_plan(jcfg, purpose="train", route="neuron_leading"))
        return JM.ce_loss(logits, jnp.asarray(y)), ns
    (jl, jns), jg = jax.value_and_grad(jloss, has_aux=True)(jp)

    loss, grads, ns = TR.loss_and_grads(
        pcfg, p, s, st, torch.as_tensor(x), torch.as_tensor(y),
        exec_plan=plan_subnet_exec(pcfg, purpose="train", route=route))
    np.testing.assert_allclose(float(loss), float(jl), rtol=1e-5)
    gl, wl = tree_leaves(grads), jax.tree.leaves(jg)
    assert len(gl) == len(wl) == len(tree_leaves(p))
    for a, b in zip(gl, wl):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), **GRAD_TOL)
    nl, wnl = tree_leaves(ns), jax.tree.leaves(jns)
    assert len(nl) == len(wnl) == len(tree_leaves(s))   # every branch's BN
    for a, b in zip(nl, wnl):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), **TOL)
    # every branch of the adder nodes is on the loss's path
    for i, nd in enumerate(pcfg.nodes[:-1]):
        for a in range(nd.arity):
            fn = grads["layers"][i]["fn"][a] if nd.arity > 1 \
                else grads["layers"][i]["fn"]
            assert any(g.abs().max() > 0 for g in tree_leaves(fn)), (i, a)


def _steps_both(mod, n_steps, route="neuron_leading"):
    (jcfg, jp, js, jst), (pcfg, p, s, st) = _models(mod, seed=3)
    jo = JA.adamw_init(jp)
    o = bridge.opt_from_numpy(pcfg, jax.tree.map(
        lambda a: None if a is None else np.asarray(a), jo,
        is_leaf=lambda a: a is None), device="cpu")
    jstep = jax.jit(make_step_fn_dynamic(
        jcfg, lr=LR, weight_decay=WD, t0=T0,
        exec_plan=j_plan(jcfg, purpose="train", route="neuron_leading")))
    step = TR.make_step_fn(pcfg, lr=LR, weight_decay=WD, t0=T0,
                           exec_plan=plan_subnet_exec(
                               pcfg, purpose="train", route=route))
    jlosses, losses = [], []
    for x, y in _batches(n_steps, seed=4):
        jp, js, jo, jl = jstep(jp, js, jo, jst, jnp.asarray(x),
                               jnp.asarray(y))
        p, s, o, loss = step(p, s, o, st, torch.as_tensor(x),
                             torch.as_tensor(y))
        jlosses.append(float(jl))
        losses.append(float(loss))
    return (jp, js, jo, jlosses), (p, s, o, losses)


@pytest.mark.parametrize("mod", POLYLUT)
def test_graph_one_optimizer_step_matches_jax(mod):
    (jp, js, jo, jl), (p, s, o, pl) = _steps_both(mod, 1)
    _, (pcfg, p0, s0, st) = _models(mod, seed=3)
    (x, y), = _batches(1, seed=4)
    _, g, _ = TR.loss_and_grads(
        pcfg, p0, s0, st, torch.as_tensor(x), torch.as_tensor(y),
        exec_plan=plan_subnet_exec(pcfg, purpose="train", device="cpu"))
    np.testing.assert_allclose(pl, jl, rtol=1e-5)
    assert int(o["count"]) == int(jo["count"]) == 1
    for key, tol in (("m", dict(rtol=2e-4, atol=3e-6)),
                     ("v", dict(rtol=4e-4, atol=1e-7))):
        for a, b in zip(tree_leaves(o[key]), jax.tree.leaves(jo[key])):
            np.testing.assert_allclose(a.numpy(), np.asarray(b), **tol)
    compared = 0
    for a, b, gg in zip(tree_leaves(p), jax.tree.leaves(jp),
                        tree_leaves(g)):
        m = np.abs(gg.numpy()) > 1e-5
        compared += int(m.sum())
        np.testing.assert_allclose(a.numpy()[m], np.asarray(b)[m],
                                   rtol=1e-3, atol=1e-6)
    assert compared > 100  # the mask must not trivialize the check
    for a, b in zip(tree_leaves(s), jax.tree.leaves(js)):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), **TOL)


@pytest.mark.parametrize("route", ["neuron_leading", "kernel_train"])
@pytest.mark.parametrize("mod", POLYLUT)
def test_graph_five_step_loss_trajectory_matches_jax(mod, route):
    (_, _, _, jl), (_, _, _, pl) = _steps_both(mod, 5, route=route)
    np.testing.assert_allclose(pl, jl, rtol=1e-3)
    assert pl[-1] < pl[0]


def _spy(monkeypatch):
    """Record the leading shape of every call of the training kernels'
    plain versions (what the wrappers run for CPU tensors)."""
    calls = []
    for name in ("subnet_train_fwd_ref", "subnet_train_bwd_ref"):
        fn = getattr(NG, name)

        def wrapped(*a, _fn=fn, _name=name, **k):
            bwd = _name.endswith("bwd_ref")
            xg = a[1] if bwd else a[0]
            calls.append(("bwd" if bwd else "fwd", tuple(xg.shape[:-2])))
            return _fn(*a, **k)
        monkeypatch.setattr(NG, name, wrapped)
    return calls


@pytest.mark.parametrize("mod", POLYLUT)
def test_graph_step_makes_one_training_call_per_branch(mod, monkeypatch):
    """kernel_train: one forward and one backward call per branch per
    step, for one seed and for a vmapped ensemble of two (one seed-axis
    call per branch, whatever S)."""
    _, (pcfg, p, s, st) = _models(mod, seed=5)
    (x, y), = _batches(1)
    plan = plan_subnet_exec(pcfg, purpose="train", route="kernel_train")
    calls = _spy(monkeypatch)
    TR.loss_and_grads(pcfg, p, s, st, torch.as_tensor(x),
                      torch.as_tensor(y), exec_plan=plan)
    nb = _branches(pcfg)
    assert sorted(calls) == sorted([("fwd", (64,))] * nb
                                   + [("bwd", (64,))] * nb)
    calls.clear()
    xs, ys = jsc_synthetic(128, seed=1)
    params, state, opt = TR.init_ensemble(pcfg, (0, 1), xs, device="cpu")
    step = TR.make_ensemble_step_fn(pcfg, lr=LR, weight_decay=WD, t0=T0,
                                    exec_plan=plan)
    _, _, _, loss = step(params, state, opt, TR.unit_statics(st, 2),
                         torch.as_tensor(xs).view(2, 64, -1),
                         torch.as_tensor(ys).view(2, 64))
    assert loss.shape == (2,) and torch.isfinite(loss).all()
    assert sorted(calls) == sorted([("fwd", (2, 64))] * nb
                                   + [("bwd", (2, 64))] * nb)


@pytest.mark.parametrize("mod", POLYLUT)
def test_graph_ensemble_member_follows_its_single_seed_run(mod):
    cfg = get_config(mod.replace("_", "-"), reduced=True)
    x, y = jsc_synthetic(768, seed=0)
    xt, yt = jsc_synthetic(200, seed=1)
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
    # a member has the single model's graph tree: it bridges back
    pm, sm = TR.ensemble_member(params, state, 1)
    pb, sb = bridge.params_from_numpy(cfg, bridge.params_to_numpy(pm),
                                      bridge.params_to_numpy(sm),
                                      device="cpu")
    for a, b in zip(tree_leaves(pb) + tree_leaves(sb),
                    tree_leaves(pm) + tree_leaves(sm)):
        assert torch.equal(a, b)


def test_trained_graph_goes_through_bridge_and_bundle():
    """A trained graph's statics bridge back to themselves, its device
    statics hold one int64 tensor per branch, and its bundle carries
    per-node branch tables and conns and serves exactly ``predict``."""
    cfg = get_config("polylut-add-jsc-5l", reduced=True)
    x, y = jsc_synthetic(512, seed=0)
    xt, yt = jsc_synthetic(200, seed=1)
    params, state, hist = TR.train_neuralut(cfg, x, y, xt, yt, epochs=1,
                                            batch=256, device="cpu")
    assert all(np.isfinite(v).all() for v in hist.values())
    statics = M.model_static(cfg)
    dev = M.device_statics(statics, torch.device("cpu"))
    for st, d, nd in zip(statics, dev, cfg.nodes):
        assert len(d["conns"]) == nd.arity
        for c, t in zip(st["conns"], d["conns"]):
            assert t.dtype == torch.long and np.array_equal(t.numpy(), c)
    again = bridge.statics_from_numpy(cfg, statics)
    assert all(np.array_equal(a, b) for s1, s2 in zip(again, statics)
               for a, b in zip(s1["conns"], s2["conns"]))
    tables, packed = TT.convert_packed(cfg, params, state, statics)
    bundle = bundle_from_training(cfg, params, tables, statics,
                                  packed_tables=packed)
    assert [len(t) for t in bundle.tables] \
        == [nd.arity for nd in cfg.nodes] \
        == [len(s["conns"]) for s in bundle.statics]
    assert len(bundle.packed_tables) == _branches(cfg)
    with LUTServeEngine(bundle, device="cpu") as eng:
        served = eng.predict(xt)
    want = LI.predict(cfg, params, tables, statics, torch.as_tensor(xt))
    assert np.array_equal(served, want.numpy())


@pytest.mark.parametrize("arch,seeds", [("polylut-add-jsc-5l", 1),
                                        ("polylut-add-jsc-5l", 2),
                                        ("polylut-add-jsc-2l", 1)])
def test_launch_train_graph_cpu(arch, seeds):
    out = LT.main(["--arch", arch, "--reduced", "--epochs", "1",
                   "--seeds", str(seeds), "--device", "cpu",
                   "--log-every", "0"])
    assert out["mismatches"] == 0 and out["steps"] == seeds * 78
    assert out["bundle"].topology[0] == "dag"
    assert len(out["bundle"].packed_tables) == _branches(
        get_config(arch, reduced=True))
    assert (out["best_seed"] is None) == (seeds == 1)
