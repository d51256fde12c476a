"""Port parity: the training forward and backward of the grouped
sub-network (the plain versions that the K4/K5 wrappers and
``SubnetTrainFn`` run for CPU tensors) against the JAX package's Pallas
training kernel in interpret mode (``subnet_train_apply``, ``_forward``,
``_backward``), and the neuron-leading route against the canonical one.

Tolerances: outputs and saved activations atol/rtol 1e-5; gradients
rtol 2e-4 / atol 3e-5, the reference's own gradient tolerance
(tests/test_train_kernel.py): float32 sums taken in another order.
"""
import importlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels import neuralut_grad as JG
from repro.kernels.ops import subnet_train_apply as j_subnet_train_apply
from repro.core import subnet as JS
from repro_torch.config import get_config
from repro_torch.core import subnet as S
from repro_torch.core.exec_plan import plan_subnet_exec
from repro_torch.kernels.neuralut_grad import (SubnetTrainFn,
                                               subnet_train_apply,
                                               subnet_train_bwd,
                                               subnet_train_fwd)
from repro_torch.kernels.ref import grouped_subnet_ref

# Small shapes: one intra-op thread keeps these tests from loading the
# CPU that the other test workers share.
torch.set_num_threads(1)

OUT_TOL = dict(atol=1e-5, rtol=1e-5)
GRAD_TOL = dict(atol=3e-5, rtol=2e-4)
B = 32

# first and last layer of every reduced geometry and of full jsc-5l
CASES = [(mod, variant, layer)
         for mod, variant in [("neuralut_hdr_5l", "reduced"),
                              ("neuralut_jsc_2l", "reduced"),
                              ("neuralut_jsc_5l", "reduced"),
                              ("neuralut_jsc_5l", "full")]
         for layer in ("first", "last")]


def _subnet(o, f, depth, width, skip, seed):
    """Seeded numpy sub-network params (the reference's tree) and a
    (B, O, F) input."""
    rng = np.random.default_rng(seed)
    spec = JS.subnet_spec(o, f, depth, width, skip)

    def leaf(sds):
        return (rng.normal(0, 1, sds.shape) / np.sqrt(max(sds.shape[-2], 1))
                if len(sds.shape) >= 2 else rng.normal(0, 0.3, sds.shape)
                ).astype(np.float32)
    p = jax.tree.map(leaf, spec,
                     is_leaf=lambda x: isinstance(x, jax.ShapeDtypeStruct))
    x = rng.normal(0, 1, (B, o, f)).astype(np.float32)
    return p, x


def _torch_tree(p, requires_grad=False):
    return jax.tree.map(
        lambda a: torch.tensor(np.asarray(a), requires_grad=requires_grad),
        p)


def _geometry(mod, variant, layer):
    jcfg = getattr(importlib.import_module(f"repro.configs.{mod}"),
                   variant)()
    i = 0 if layer == "first" else jcfg.num_layers - 1
    return jcfg, jcfg.layer_widths[i], jcfg.layer_fan_in(i)


@pytest.mark.parametrize("mod,variant,layer", CASES)
def test_train_fn_matches_jax_kernel(mod, variant, layer):
    jcfg, o, f = _geometry(mod, variant, layer)
    p, x = _subnet(o, f, jcfg.depth, jcfg.width, jcfg.skip,
                   seed=len(mod) + len(layer))

    def jloss(pp, xx):
        y = j_subnet_train_apply(pp, xx, jcfg.skip, interpret=True)
        return jnp.sum(jnp.sin(y)), y
    (_, jy), (jgp, jgx) = jax.value_and_grad(
        jloss, argnums=(0, 1), has_aux=True)(
        jax.tree.map(jnp.asarray, p), jnp.asarray(x))

    tp = _torch_tree(p, requires_grad=True)
    tx = torch.tensor(x, requires_grad=True)
    y = subnet_train_apply(tp, tx, jcfg.skip)
    torch.sin(y).sum().backward()

    np.testing.assert_allclose(y.detach().numpy(), np.asarray(jy),
                               **OUT_TOL)
    np.testing.assert_allclose(tx.grad.numpy(), np.asarray(jgx), **GRAD_TOL)
    got = jax.tree.leaves(jax.tree.map(lambda t: t.grad.numpy(), tp))
    want = jax.tree.leaves(jgp)
    assert len(got) == len(want) == len(jax.tree.leaves(p))
    for a, b in zip(got, want):
        np.testing.assert_allclose(a, np.asarray(b), **GRAD_TOL)


@pytest.mark.parametrize("skip", [0, 2])
def test_plain_fwd_bwd_match_jax_kernel_bodies(skip):
    """The plain versions step by step against the Pallas bodies: the
    saved activations of ``_forward`` and every output of ``_backward``,
    on the same cotangent."""
    o, f, depth, width = 6, 3, 4, 8
    p, x = _subnet(o, f, depth, width, skip, seed=3 + skip)
    g = np.random.default_rng(9).normal(0, 1, (B, o)).astype(np.float32)
    lw = [lp["w"] for lp in p["layers"]]
    lb = [lp["b"] for lp in p["layers"]]
    sw = [sp["w"] for sp in p.get("skips", [])]
    sb = [sp["b"] for sp in p.get("skips", [])]
    meta = JG.subnet_train_meta(B, o, depth, skip, interpret=True)
    jj = [jnp.asarray(a) for a in (x, g)]
    j_out, j_acts = JG._forward(meta, jj[0], [jnp.asarray(a) for a in lw],
                                [jnp.asarray(a) for a in lb],
                                [jnp.asarray(a) for a in sw],
                                [jnp.asarray(a) for a in sb])
    j_bwd = JG._backward(meta, jj[1], jj[0], j_acts,
                         [jnp.asarray(a) for a in lw],
                         [jnp.asarray(a) for a in sw])

    t = [torch.as_tensor(a) for a in (x, g)]
    tw = [[torch.as_tensor(a) for a in group] for group in (lw, lb, sw, sb)]
    out, acts = subnet_train_fwd(t[0], *tw, skip=skip, wpack=None)
    np.testing.assert_allclose(out.numpy(), np.asarray(j_out), **OUT_TOL)
    assert len(acts) == len(j_acts) == depth - 1
    for a, b in zip(acts, j_acts):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), **OUT_TOL)
    dx, dws, dbs, drs, drbs = subnet_train_bwd(t[1], t[0], acts, *tw,
                                               skip=skip, wpack=None)
    got = [dx] + dws + dbs + drs + drbs
    want = ([j_bwd[0]] + list(j_bwd[1]) + list(j_bwd[2]) + list(j_bwd[3])
            + list(j_bwd[4]))
    assert len(got) == len(want)
    for a, b in zip(got, want):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), **GRAD_TOL)


def test_train_fn_matches_torch_autograd_and_relu_zero():
    """SubnetTrainFn's backward against torch autograd of the plain
    grouped sub-network, with inputs that put exact zeros through the
    ReLUs (both give 0 at 0)."""
    o, f, depth, width, skip = 5, 3, 4, 8, 2
    p, x = _subnet(o, f, depth, width, skip, seed=21)
    x[:, :, 0] = 0.0
    for lp in p["layers"]:
        lp["b"][:] = 0.0
    x[: B // 2] = 0.0       # whole rows of zeros: every ReLU sees 0
    tp = _torch_tree(p, requires_grad=True)
    tx = torch.tensor(x, requires_grad=True)
    y = subnet_train_apply(tp, tx, skip)
    cot = torch.as_tensor(np.random.default_rng(4).normal(0, 1, (B, o))
                          .astype(np.float32))
    (y * cot).sum().backward()
    rp = _torch_tree(p, requires_grad=True)
    rx = torch.tensor(x, requires_grad=True)
    yr = grouped_subnet_ref(
        rx, [lp["w"] for lp in rp["layers"]], [lp["b"] for lp in rp["layers"]],
        [sp["w"] for sp in rp["skips"]], [sp["b"] for sp in rp["skips"]],
        skip=skip)
    (yr * cot).sum().backward()
    np.testing.assert_allclose(y.detach().numpy(), yr.detach().numpy(),
                               **OUT_TOL)
    np.testing.assert_allclose(tx.grad.numpy(), rx.grad.numpy(), **GRAD_TOL)
    for a, b in zip(jax.tree.leaves(jax.tree.map(lambda t: t.grad, tp)),
                    jax.tree.leaves(jax.tree.map(lambda t: t.grad, rp))):
        np.testing.assert_allclose(a.numpy(), b.numpy(), **GRAD_TOL)
    assert y.grad_fn._forward_cls is SubnetTrainFn


@pytest.mark.parametrize("skip", [0, 2, 4])
def test_neuron_leading_matches_canonical_and_jax(skip):
    o, f, depth, width = 7, 3, 4, 8
    p, x = _subnet(o, f, depth, width, skip, seed=30 + skip)
    tp = _torch_tree(p)
    tx = torch.as_tensor(x)
    canon = S.subnet_apply(tp, tx, skip)
    lead = S.subnet_apply(tp, tx, skip, batch_leading=True)
    j_lead = JS.subnet_apply(jax.tree.map(jnp.asarray, p), jnp.asarray(x),
                             skip, batch_leading=True)
    assert lead.shape == (B, o)
    np.testing.assert_allclose(lead.numpy(), canon.numpy(), **OUT_TOL)
    np.testing.assert_allclose(lead.numpy(), np.asarray(j_lead), **OUT_TOL)


def test_train_plans():
    cfg = get_config("neuralut-jsc-5l", reduced=True)
    plan = plan_subnet_exec(cfg, purpose="train", device="cpu")
    assert plan.route == "neuron_leading" and plan.differentiable
    assert plan_subnet_exec(cfg, purpose="eval", device="cpu").route \
        == "canonical"
    assert plan_subnet_exec(cfg, purpose="convert", device="cpu").route \
        == "canonical"
    forced = plan_subnet_exec(cfg, purpose="train", route="kernel_train")
    assert forced.route == "kernel_train" and forced.differentiable
    assert not plan_subnet_exec(cfg, purpose="convert",
                                route="kernel_infer").differentiable
    with pytest.raises(ValueError, match="forward-only"):
        plan_subnet_exec(cfg, purpose="train", route="kernel_infer")
    # the kernel_train route reaches SubnetTrainFn (its plain versions on
    # the CPU) and matches the neuron-leading route
    p, x = _subnet(cfg.layer_widths[0], cfg.layer_fan_in(0), cfg.depth,
                   cfg.width, cfg.skip, seed=5)
    tp = _torch_tree(p, requires_grad=True)
    y = forced.apply(tp, torch.as_tensor(x))
    assert y.grad_fn._forward_cls is SubnetTrainFn
    np.testing.assert_allclose(
        y.detach().numpy(), plan.apply(tp, torch.as_tensor(x)).detach().numpy(),
        **OUT_TOL)
