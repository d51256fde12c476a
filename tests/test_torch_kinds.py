"""Port parity: the LogicNets (``linear``) and PolyLUT (``poly``) neuron
kinds, on chains and on a LUT graph.

The reduced ``neuralut-jsc-2l`` and ``-5l`` chains and the reduced
``polylut-add-jsc-5l`` graph, with ``kind`` replaced, run in both
packages from one bridged model (numpy parameters in the JAX tree
layout, the same connectivity and BN state).  Tolerances, and why:

* Table I's counts and the monomial exponents: equal;
* the eval forward and the training-mode BN state: atol/rtol 1e-5;
* loss rtol 1e-5, every leaf's gradient rtol 2e-4 / atol 3e-5 (the
  reference's own gradient tolerance);
* after one AdamW step, the parameters where the gradient carries
  signal (|g| > 1e-5) at rtol 1e-3 / atol 1e-6 (Adam's first step is
  ``lr * sign(g)``, as tests/test_torch_train.py holds the subnet kind);
* tables: equal to JAX ``convert_packed`` but for +-1 flips at round()
  boundaries, at most two per model (tests/test_torch_convert.py), and
  equal to the port's own quantized eval branch on every code, exactly.

These kinds have no kernel: every route clamps to the plain product.
"""
import dataclasses
import importlib
import itertools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import model as JM
from repro.core import subnet as JS
from repro.core import truth_table as JTT
from repro.core.exec_plan import plan_subnet_exec as j_plan
from repro.core.train import make_step_fn_dynamic
from repro.optim import adamw as JA
from repro_torch import bridge
from repro_torch.config import get_config, list_archs
from repro_torch.core import lut_infer as LI
from repro_torch.core import model as M
from repro_torch.core import quant as Q
from repro_torch.core import subnet as S
from repro_torch.core import train as TR
from repro_torch.core import truth_table as TT
from repro_torch.core.exec_plan import (ROUTES, SubnetExec,
                                        plan_subnet_exec)
from repro_torch.core.nl_config import is_graph_config
from repro_torch.data import jsc_synthetic
from repro_torch.serve import LUTServeEngine, bundle_from_training
from repro_torch.tree import tree_leaves
from test_torch_graph import _numpy_model

# Small shapes: one intra-op thread keeps these tests from loading the
# CPU that the other test workers share.
torch.set_num_threads(1)

MODS = ["neuralut_jsc_2l", "neuralut_jsc_5l", "polylut_add_jsc_5l"]
CASES = [(m, k) for m in MODS for k in ("linear", "poly")]
TOL = dict(atol=1e-5, rtol=1e-5)
GRAD_TOL = dict(rtol=2e-4, atol=3e-5)
ALLOWED_FLIPS = 2
LR, WD, T0 = 2e-3, 1e-4, 50


def _cfgs(mod, kind, variant="reduced"):
    jcfg = getattr(importlib.import_module(f"repro.configs.{mod}"),
                   variant)()
    pcfg = get_config(mod.replace("_", "-"), reduced=variant == "reduced")
    return (dataclasses.replace(jcfg, kind=kind, degree=2),
            dataclasses.replace(pcfg, kind=kind, degree=2))


def _models(mod, kind, seed=0):
    """A seeded model of ``kind`` in both packages, with the reference's
    statics (one process, so one connectivity) bridged to the port."""
    jcfg, pcfg = _cfgs(mod, kind)
    statics = JM.model_static(jcfg)
    params_np, state_np = _numpy_model(jcfg, seed)
    p, s = bridge.params_from_numpy(pcfg, params_np, state_np,
                                    device="cpu")
    st = bridge.statics_from_numpy(pcfg, statics)
    return ((jcfg, jax.tree.map(jnp.asarray, params_np),
             jax.tree.map(jnp.asarray, state_np), statics),
            (pcfg, p, s, st))


def _batch(n=64, seed=0):
    return jsc_synthetic(n, seed=seed)


# ---------------------------------------------------------------------------
# Table I and the monomials


@pytest.mark.parametrize("F", range(1, 7))
def test_monomial_exponents_match_reference(F):
    for D in range(4):
        got = S.monomial_exponents(F, D)
        want = JS.monomial_exponents(F, D)
        assert got.dtype == want.dtype and np.array_equal(got, want)
        assert len(got) == len(list(itertools.combinations_with_replacement(
            range(F + 1), D)))          # C(F + D, D)


def test_param_count_formula_matches_reference():
    for F, L, N in itertools.product(range(1, 7), range(1, 7), (1, 4, 16)):
        for S_ in [0] + [d for d in range(1, L + 1) if L % d == 0]:
            assert S.param_count_formula(F, L, N, S_) \
                == JS.param_count_formula(F, L, N, S_)
            spec = S.subnet_spec(1, F, L, N, S_)
            leaves = [np.prod(v) for sub in spec.values() for lp in sub
                      for v in lp.values()]
            assert sum(leaves) == S.param_count_formula(F, L, N, S_)
    assert S.t_affine(3, 16) == JS.t_affine(3, 16) == 64


def _spec_sizes(spec):
    if isinstance(spec, dict):
        return [x for k in sorted(spec) for x in _spec_sizes(spec[k])]
    if isinstance(spec, list):
        return [x for s in spec for x in _spec_sizes(s)]
    return [int(np.prod(spec))]


@pytest.mark.parametrize("arch", list_archs())
def test_neuron_param_count_matches_reference(arch):
    """Table I's count per neuron, against the reference and against the
    port's own shape tree (one branch of a graph node)."""
    mod = arch.replace("-", "_")
    for variant, kind in itertools.product(("full", "reduced"),
                                           ("subnet", "linear", "poly")):
        jcfg, pcfg = _cfgs(mod, kind, variant)
        spec_p, _ = M.model_spec(pcfg)
        for i in range(pcfg.num_layers):
            n = S.neuron_param_count(pcfg, i)
            assert n == JS.neuron_param_count(jcfg, i)
            fn = spec_p["layers"][i]["fn"]
            width = (pcfg.nodes[i].width if is_graph_config(pcfg)
                     else pcfg.layer_widths[i])
            assert sum(_spec_sizes(fn[0] if isinstance(fn, list) else fn)) \
                == n * width


# ---------------------------------------------------------------------------
# plans, statics, bridge and bundle


@pytest.mark.parametrize("kind", ["linear", "poly"])
def test_kinds_plan_to_the_plain_product(kind):
    _, pcfg = _cfgs("neuralut_jsc_5l", kind)
    for purpose, route in itertools.product(("train", "eval", "convert"),
                                            (None,) + ROUTES):
        if purpose == "train" and route == "kernel_infer":
            with pytest.raises(ValueError, match="forward-only"):
                plan_subnet_exec(pcfg, purpose=purpose, route=route,
                                 device="cpu")
            continue
        plan = plan_subnet_exec(pcfg, purpose=purpose, route=route,
                                device="cpu")
        assert plan == SubnetExec(kind=kind, route="canonical",
                                  degree=2 if kind == "poly" else 0)
    with pytest.raises(ValueError, match="canonical"):
        SubnetExec(kind=kind, route="kernel_train")
    with pytest.raises(ValueError, match="unknown route"):
        plan_subnet_exec(pcfg, purpose="eval", route="fast")


@pytest.mark.parametrize("mod", MODS)
def test_poly_statics_carry_the_reference_exponents(mod):
    jcfg, pcfg = _cfgs(mod, "poly", "full")
    want = JM.model_static(jcfg)
    got = M.model_static(pcfg)
    for w, g in zip(want, got):
        assert np.array_equal(g["exps"], w["exps"])
    (_, _, _, jst), (rcfg, _, _, st) = _models(mod, "poly")
    dev = M.device_statics(st, torch.device("cpu"))
    for w, b, d in zip(jst, st, dev):
        assert np.array_equal(b["exps"], w["exps"])
        assert isinstance(d["exps"], np.ndarray)   # a host array
        conns = d["conns"] if "conns" in d else [d["conn"]]
        assert all(c.dtype == torch.long for c in conns)
    broken = [{k: v for k, v in w.items() if k != "exps"} for w in jst]
    with pytest.raises(ValueError, match="exps"):
        bridge.statics_from_numpy(rcfg, broken)
    # linear statics hold no exponents
    _, (lcfg, _, _, lst) = _models(mod, "linear")
    assert all("exps" not in s for s in M.model_static(lcfg) + lst)


@pytest.mark.parametrize("mod,kind", CASES)
def test_kind_init_has_the_reference_tree(mod, kind):
    """The port's seeded init, calibrated, has the reference's tree,
    shapes and quantizer / BN starting values."""
    jcfg, pcfg = _cfgs(mod, kind)
    x, _ = jsc_synthetic(200, seed=0)
    p, s = M.model_init(pcfg, torch.Generator().manual_seed(0),
                        device="cpu")
    p = M.calibrate_in_quant(pcfg, p, x)
    spec_p, spec_s = JM.model_spec(jcfg)
    for tree, spec in ((p, spec_p), (s, spec_s)):
        got = jax.tree.map(lambda a: a.numpy(), tree)
        assert jax.tree.structure(got) == jax.tree.structure(spec)
        assert [a.shape for a in jax.tree.leaves(got)] \
            == [a.shape for a in jax.tree.leaves(spec)]
    jp = JM.calibrate_in_quant(jcfg, {"in_quant": None}, x)
    np.testing.assert_allclose(p["in_quant"]["log_s"].numpy(),
                               np.asarray(jp["in_quant"]["log_s"]), **TOL)
    for path, a in jax.tree_util.tree_leaves_with_path(
            bridge.params_to_numpy(s)):   # BN state at identity
        assert np.all(a == (1.0 if jax.tree_util.keystr(path).endswith(
            "['var']") else 0.0))


# ---------------------------------------------------------------------------
# the model against the reference


@pytest.mark.parametrize("mod,kind", CASES)
def test_kind_forward_matches_jax(mod, kind):
    (jcfg, jp, js, jst), (pcfg, p, s, st) = _models(mod, kind, seed=1)
    x = np.random.default_rng(5).normal(
        0, 1.5, (97, jcfg.in_features)).astype(np.float32)
    for train in (False, True):
        jpre, jvals, jns = JM.model_apply(jcfg, jp, js, jst, jnp.asarray(x),
                                          train=train)
        pre, vals, ns = M.model_apply(pcfg, p, s, st, torch.as_tensor(x),
                                      train=train)
        np.testing.assert_allclose(pre.numpy(), np.asarray(jpre), **TOL)
        np.testing.assert_allclose(vals.numpy(), np.asarray(jvals), **TOL)
        for a, b in zip(tree_leaves(ns), jax.tree.leaves(jns)):
            np.testing.assert_allclose(a.numpy(), np.asarray(b), **TOL)


@pytest.mark.parametrize("mod,kind", CASES)
def test_kind_grads_match_jax(mod, kind):
    (jcfg, jp, js, jst), (pcfg, p, s, st) = _models(mod, kind, seed=2)
    x, y = _batch()

    def jloss(pp):
        logits, _, ns = JM.model_apply(jcfg, pp, js, jst, jnp.asarray(x),
                                       train=True)
        return JM.ce_loss(logits, jnp.asarray(y)), ns
    (jl, jns), jg = jax.value_and_grad(jloss, has_aux=True)(jp)
    # the kernel route asked for: the kinds clamp to the plain product
    plan = plan_subnet_exec(pcfg, purpose="train", route="kernel_train",
                            device="cpu")
    loss, grads, ns = TR.loss_and_grads(
        pcfg, p, s, st, torch.as_tensor(x), torch.as_tensor(y),
        exec_plan=plan)
    np.testing.assert_allclose(float(loss), float(jl), rtol=1e-5)
    gl, wl = tree_leaves(grads), jax.tree.leaves(jg)
    assert len(gl) == len(wl) == len(tree_leaves(p))
    for a, b in zip(gl, wl):
        assert np.isfinite(a.numpy()).all()
        np.testing.assert_allclose(a.numpy(), np.asarray(b), **GRAD_TOL)
    for a, b in zip(tree_leaves(ns), jax.tree.leaves(jns)):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), **TOL)


def test_poly_gradient_is_finite_at_exact_zeros():
    """Quantized activations hit exact zeros; x^0 through ``torch.pow``
    would give 0 * 0^-1 = NaN there.  The masked products give the
    reference's finite gradient."""
    rng = np.random.default_rng(3)
    exps = S.monomial_exponents(3, 3)
    x = rng.normal(0, 1, (17, 4, 3)).astype(np.float32)
    x[rng.random(x.shape) < 0.4] = 0.0
    w = rng.normal(0, 1, (4, len(exps))).astype(np.float32)
    g = rng.normal(0, 1, (17, 4)).astype(np.float32)
    jx, jw = jax.grad(lambda xx, ww: jnp.sum(JS.poly_apply(
        {"w": ww}, xx, exps) * g), argnums=(0, 1))(jnp.asarray(x),
                                                   jnp.asarray(w))
    xt = torch.as_tensor(x).requires_grad_(True)
    wt = torch.as_tensor(w).requires_grad_(True)
    out = S.poly_apply({"w": wt}, xt, exps)
    np.testing.assert_allclose(out.detach().numpy(), np.asarray(
        JS.poly_apply({"w": jnp.asarray(w)}, jnp.asarray(x), exps)), **TOL)
    gx, gw = torch.autograd.grad(out, (xt, wt), grad_outputs=torch.as_tensor(g))
    assert torch.isfinite(gx).all() and torch.isfinite(gw).all()
    np.testing.assert_allclose(gx.numpy(), np.asarray(jx), **GRAD_TOL)
    np.testing.assert_allclose(gw.numpy(), np.asarray(jw), **GRAD_TOL)


@pytest.mark.parametrize("mod,kind", CASES)
def test_kind_adamw_step_matches_jax(mod, kind):
    (jcfg, jp, js, jst), (pcfg, p, s, st) = _models(mod, kind, seed=3)
    jo = JA.adamw_init(jp)
    o = bridge.opt_from_numpy(pcfg, jax.tree.map(
        lambda a: None if a is None else np.asarray(a), jo,
        is_leaf=lambda a: a is None), device="cpu")
    jfn = make_step_fn_dynamic(jcfg, lr=LR, weight_decay=WD, t0=T0,
                               exec_plan=j_plan(jcfg, purpose="train"))
    # the statics close over the step: poly's exponents bound its loops
    jstep = jax.jit(lambda a, b, c, xx, yy: jfn(a, b, c, jst, xx, yy))
    plan = plan_subnet_exec(pcfg, purpose="train", device="cpu")
    step = TR.make_step_fn(pcfg, lr=LR, weight_decay=WD, t0=T0,
                           exec_plan=plan)
    x, y = _batch(seed=4)
    _, g, _ = TR.loss_and_grads(pcfg, p, s, st, torch.as_tensor(x),
                                torch.as_tensor(y), exec_plan=plan)
    jp1, js1, jo1, jl = jstep(jp, js, jo, jnp.asarray(x), jnp.asarray(y))
    p1, s1, o1, loss = step(p, s, o, st, torch.as_tensor(x),
                            torch.as_tensor(y))
    np.testing.assert_allclose(float(loss), float(jl), rtol=1e-5)
    assert int(o1["count"]) == int(jo1["count"]) == 1
    compared = 0
    for a, b, gg in zip(tree_leaves(p1), jax.tree.leaves(jp1),
                        tree_leaves(g)):
        m = np.abs(gg.numpy()) > 1e-5
        compared += int(m.sum())
        np.testing.assert_allclose(a.numpy()[m], np.asarray(b)[m],
                                   rtol=1e-3, atol=1e-6)
    assert compared > 50  # the mask must not trivialize the check
    for a, b in zip(tree_leaves(s1), jax.tree.leaves(js1)):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), **TOL)


# ---------------------------------------------------------------------------
# conversion


@pytest.mark.parametrize("mod,kind", CASES)
def test_kind_tables_match_jax_convert(mod, kind):
    (jcfg, jp, js, jst), (pcfg, p, s, st) = _models(mod, kind, seed=4)
    want, _ = JTT.convert_packed(jcfg, jp, js, jst)
    tables, packed = TT.convert_packed(pcfg, p, s, st)
    if not is_graph_config(pcfg):
        want, tables, packed = [[w] for w in want], [[t] for t in tables], \
            [[w] for w in packed]
    flips = 0
    for i, (node, jnode) in enumerate(zip(tables, want)):
        assert len(node) == len(jnode)
        for a, (t, w) in enumerate(zip(node, jnode)):
            w = np.asarray(w)
            assert t.shape == w.shape and t.dtype == np.uint16
            d = np.abs(t.astype(np.int32) - w.astype(np.int32))
            assert d.max() <= 1, f"node {i} branch {a}: not a flip"
            flips += int((d != 0).sum())
            assert np.array_equal(packed[i][a], LI.pack_tables(t, pcfg.beta))
    assert flips <= ALLOWED_FLIPS, f"{flips} flips"


@pytest.mark.parametrize("mod,kind", CASES)
def test_kind_tables_equal_own_eval_branch_on_every_code(mod, kind,
                                                         monkeypatch):
    """Feed each neuron of each layer (or branch) every code combination
    through the port's eval branch (gather -> hidden function -> BN ->
    quantize), its sources set to the dequantized codes; then the LUT
    path on data against the quantized forward."""
    _, (pcfg, p, s, st) = _models(mod, kind, seed=5)
    monkeypatch.setattr(TT, "SWEEP_BATCH", 256)   # a chunked sweep
    tables = TT.convert(pcfg, p, s, st)
    g = pcfg if is_graph_config(pcfg) else pcfg.graph()
    node_tables = tables if is_graph_config(pcfg) else [[t] for t in tables]
    plan = plan_subnet_exec(pcfg, purpose="eval", device="cpu")
    for i, nd in enumerate(g.nodes):
        bits, f = g.node_in_bits(i), nd.fan_in
        codes = torch.as_tensor(TT.enumerate_codes(bits, f))  # (T, F)
        t, o, pool_w = codes.shape[0], nd.width, g.node_in_width(i)
        scale = torch.cat([torch.exp(
            p["in_quant"]["log_s"] if b == 0
            else p["layers"][b - 1]["quant"]["log_s"])
            for b in g.node_sources(i)])
        lp, ls = p["layers"][i], s["layers"][i]
        for a, (conn, (fn, bn_p, bn_s)) in enumerate(zip(
                M.node_static_conns(st[i]),
                M.node_branch_params(nd, lp, ls))):
            conn = torch.as_tensor(conn).long()              # (O, F)
            pool = torch.zeros(o * t, pool_w)
            rows = torch.arange(o * t)
            for j in range(f):
                cols = conn[:, j].repeat_interleave(t)
                pool[rows, cols] = ((codes[:, j].repeat(o)
                                     - 2 ** (bits - 1)).float()
                                    * scale[cols])
            pre, _ = Q.bn_apply(bn_p, bn_s, plan.apply(
                fn, pool[:, conn], exps=st[i].get("exps")), train=False)
            got = Q.quant_codes(lp["quant"], pre, pcfg.beta)  # (O*T, O)
            own = got.reshape(o, t, o)[torch.arange(o), :, torch.arange(o)]
            assert np.array_equal(own.numpy(),
                                  node_tables[i][a].astype(np.int32)), (i, a)
    x = torch.as_tensor(np.random.default_rng(2).normal(
        0, 1, (300, pcfg.in_features)).astype(np.float32))
    pre, vals, _ = M.model_apply(pcfg, p, s, st, x)
    want = Q.quant_codes(p["layers"][-1]["quant"], pre, pcfg.beta)
    fwd = LI.graph_lut_forward if is_graph_config(pcfg) else LI.lut_forward
    assert torch.equal(fwd(pcfg, tables, st, LI.input_codes(pcfg, p, x)),
                       want)


# ---------------------------------------------------------------------------
# the trainer end to end


@pytest.mark.parametrize("mod,kind", CASES)
def test_kind_trains_converts_and_serves_exactly(mod, kind):
    _, pcfg = _cfgs(mod, kind)
    x, y = jsc_synthetic(768, seed=0)
    xt, yt = jsc_synthetic(200, seed=1)
    params, state, hist = TR.train_neuralut(pcfg, x, y, xt, yt, epochs=2,
                                            batch=128, device="cpu")
    assert all(np.isfinite(v).all() for v in hist.values())
    assert hist["loss"][-1] < hist["loss"][0]
    statics = M.model_static(pcfg)
    tables, packed = TT.convert_packed(pcfg, params, state, statics)
    bundle = bundle_from_training(pcfg, params, tables, statics,
                                  packed_tables=packed)
    if kind == "poly":
        assert all(np.array_equal(b["exps"], s["exps"])
                   for b, s in zip(bundle.statics, statics))
    with LUTServeEngine(bundle, device="cpu") as eng:
        served = eng.predict(xt)
    want = LI.predict(pcfg, params, tables, statics, torch.as_tensor(xt))
    assert np.array_equal(served, want.numpy())
