"""Port parity: the training step, the trainer and the launcher.

Both packages start from one bridged model (numpy-seeded parameters in
the JAX tree layout, the same connectivity, the same BN state and
AdamW state) and get the same numpy batches: ``jax.random``
permutations cannot be reproduced.  Tolerances, and why:

* loss rtol 1e-5, gradients of every leaf rtol 2e-4 / atol 3e-5 (the
  reference's own gradient tolerance), new BN state atol/rtol 1e-5:
  float32 sums taken in another order;
* after one optimizer step, the moments at the gradients' tolerance
  scaled as they are (m = 0.1 g, v = 0.001 g^2), and the parameters
  where the gradient carries signal (|g| > 1e-5) at rtol
  1e-3 / atol 1e-6, as the reference's own kernel-route step test
  holds them: Adam's first step is ``lr * sign(g)``, so a gradient near
  0 whose sign differs by rounding moves a parameter by 2 lr;
* a 5-step loss trajectory at rtol 1e-3, loss level, for the same
  reason.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import model as JM
from repro.core.exec_plan import plan_subnet_exec as j_plan
from repro.core.train import make_step_fn_dynamic
from repro.optim import adamw as JA
from repro_torch import bridge
from repro_torch.config import get_config
from repro_torch.core import lut_infer as LI
from repro_torch.core import model as M
from repro_torch.core import quant as Q
from repro_torch.core import train as TR
from repro_torch.core import truth_table as TT
from repro_torch.core.exec_plan import plan_subnet_exec
from repro_torch.data import device_dataset, jsc_synthetic
from repro_torch.launch import train as LT
from repro_torch.serve import LUTServeEngine, bundle_from_training
from repro_torch.tree import tree_leaves
from test_torch_model import bridged_model

# Small shapes: one intra-op thread keeps these tests from loading the
# CPU that the other test workers share.
torch.set_num_threads(1)

GRAD_TOL = dict(rtol=2e-4, atol=3e-5)
TOL = dict(rtol=1e-5, atol=1e-5)
LR, WD, T0 = 2e-3, 1e-4, 50


def _batches(jcfg, n_batches, b=64, seed=0):
    x, y = jsc_synthetic(n_batches * b, seed=seed)
    return [(x[k * b:(k + 1) * b], y[k * b:(k + 1) * b])
            for k in range(n_batches)]


@pytest.mark.parametrize("route", ["neuron_leading", "kernel_train",
                                   "canonical"])
def test_model_loss_grads_and_bn_state_match_jax(route):
    """One bridged batch of reduced jsc-5l: loss, the gradient of every
    leaf and the new BN state, against jax.value_and_grad of the
    reference's training forward (its CPU route)."""
    (jcfg, jp, js, jst), (pcfg, p, s, st) = bridged_model(
        "neuralut_jsc_5l", seed=2)
    (x, y), = _batches(jcfg, 1)

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
    for a, b in zip(tree_leaves(ns), jax.tree.leaves(jns)):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), **TOL)
    # the last layer's quantizer scale is not on the loss's path
    assert not tree_leaves(grads["layers"][-1]["quant"])[0].any()


def _steps_both(n_steps, route="neuron_leading"):
    # connectivity from a fixed seed, not the per-process salted hash
    (jcfg, jp, js, jst), (pcfg, p, s, st) = bridged_model(
        "neuralut_jsc_5l", seed=3, conn_seed=0)
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
    for x, y in _batches(jcfg, n_steps, seed=4):
        jp, js, jo, jl = jstep(jp, js, jo, jst, jnp.asarray(x),
                               jnp.asarray(y))
        p, s, o, loss = step(p, s, o, st, torch.as_tensor(x),
                             torch.as_tensor(y))
        jlosses.append(float(jl))
        losses.append(float(loss))
    return (jp, js, jo, jlosses), (p, s, o, losses), (jcfg, jst, pcfg, st)


def test_one_optimizer_step_matches_jax():
    (jp, js, jo, jl), (p, s, o, pl), (jcfg, jst, pcfg, st) = _steps_both(1)
    _, (_, p0, s0, _) = bridged_model("neuralut_jsc_5l", seed=3,
                                      conn_seed=0)
    (x, y), = _batches(jcfg, 1, seed=4)
    _, g, _ = TR.loss_and_grads(
        pcfg, p0, s0, st, torch.as_tensor(x), torch.as_tensor(y),
        exec_plan=plan_subnet_exec(pcfg, purpose="train", device="cpu"))
    np.testing.assert_allclose(pl, jl, rtol=1e-5)
    assert int(o["count"]) == int(jo["count"]) == 1
    # m = 0.1 g and v = 0.001 g^2 after one step: the gradient's
    # tolerance carried through
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
def test_five_step_loss_trajectory_matches_jax(route):
    (_, _, _, jl), (_, _, _, pl), _ = _steps_both(5, route=route)
    np.testing.assert_allclose(pl, jl, rtol=1e-3)
    assert pl[-1] < pl[0]


def test_train_neuralut_cpu_converts_and_serves_exactly():
    """The trainer at a reduced size on the CPU: its trained model's
    tables equal its own quantized forward, and the engine serves
    exactly what ``lut_infer.predict`` predicts."""
    cfg = get_config("neuralut-jsc-5l", reduced=True)
    x, y = jsc_synthetic(1536, seed=0)
    xt, yt = jsc_synthetic(300, seed=1)
    params, state, hist = TR.train_neuralut(
        cfg, x, y, xt, yt, epochs=2, batch=256, device="cpu")
    assert set(hist) == {"loss", "test_acc", "test_acc_q"}
    assert all(len(v) == 2 for v in hist.values())
    assert all(np.isfinite(v).all() for v in hist.values())
    statics = M.model_static(cfg)
    tables = TT.convert(cfg, params, state, statics)
    xt_t = torch.as_tensor(xt)
    pre, _, _ = M.model_apply(cfg, params, state, statics, xt_t)
    want = Q.quant_codes(params["layers"][-1]["quant"], pre, cfg.beta)
    got = LI.lut_forward(cfg, tables, statics,
                         LI.input_codes(cfg, params, xt_t))
    assert torch.equal(got, want)
    tables, packed = TT.convert_packed(cfg, params, state, statics)
    bundle = bundle_from_training(cfg, params, tables, statics,
                                  packed_tables=packed)
    with LUTServeEngine(bundle, device="cpu") as eng:
        served = eng.predict(xt)
    assert np.array_equal(served, LI.predict(cfg, params, tables, statics,
                                             xt_t).numpy())


def test_launch_train_cpu():
    out = LT.main(["--arch", "neuralut-jsc-5l", "--reduced", "--epochs",
                   "1", "--device", "cpu", "--log-every", "0"])
    assert out["mismatches"] == 0 and out["steps"] == 78
    assert len(out["history"]["loss"]) == 1
    assert out["bundle"].packed_tables is not None


@pytest.mark.parametrize("argv,err", [
    (["--seeds", "2", "--registry", "reg"], None),
    (["--registry", "reg"], None),
    (["--arch", "qwen2-vl-72b"], ValueError),
    (["--arch", "polylut-add-jsc-2l", "--registry", "reg"], None),
    (["--arch", "neuralut-hdr-5l"], SystemExit),
])
def test_launch_train_refuses_what_is_not_ported(argv, err, tmp_path,
                                                 capsys):
    """An LM arch whose loss needs inputs the launcher does not make
    (qwen2-vl-72b's patch embeddings and positions) and archs without a
    dataset are refused; ``--registry``
    (refused until the serving stack was ported) saves the served bundle
    to a TableRegistry, bit-identical on load."""
    from repro_torch.serve import TableRegistry
    base = ["--arch", "neuralut-jsc-5l", "--reduced", "--epochs", "1",
            "--device", "cpu", "--log-every", "0"]
    argv = [str(tmp_path) if a == "reg" else a for a in argv]
    if err is None:
        out = LT.main(base + argv)
        assert "saved serving-ready bundle" in capsys.readouterr().out
        name = out["bundle"].cfg.name
        loaded = TableRegistry(tmp_path).load(name)
        assert TableRegistry(tmp_path).versions(name) == [0]
        assert loaded.meta["train_acc_q"] == pytest.approx(out["acc_q"])
        for a, b in zip(loaded.packed_tables, out["bundle"].packed_tables):
            assert np.array_equal(a, b)
        return
    with pytest.raises(err) as e:
        LT.main(base + argv)
    if err is ValueError:
        assert "patch_embeds" in str(e.value) and "positions" in str(
            e.value)


def test_device_dataset_is_resident_and_reused():
    a = device_dataset(jsc_synthetic, 300, seed=5, device="cpu")
    b = device_dataset(jsc_synthetic, 300, seed=5, device="cpu")
    assert all(u is v for u, v in zip(a, b))
    c = device_dataset(jsc_synthetic, 300, seed=6, device="cpu")
    assert not torch.equal(a[0], c[0])
    x, y = jsc_synthetic(300, seed=5)
    assert np.array_equal(a[0].numpy(), x) and np.array_equal(a[1].numpy(), y)


def test_training_entry_points_default_to_cuda(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    cfg = get_config("neuralut-jsc-5l", reduced=True)
    x, y = jsc_synthetic(64, seed=0)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        TR.train_neuralut(cfg, x, y, x, y, epochs=1)
    with pytest.raises(RuntimeError, match="no CUDA"):
        device_dataset(jsc_synthetic, 64, seed=0)
    with pytest.raises(RuntimeError, match="no CUDA"):
        plan_subnet_exec(cfg, purpose="train")
    with pytest.raises(RuntimeError, match="no CUDA"):
        LT.main(["--arch", "neuralut-jsc-5l", "--reduced", "--epochs", "1"])
