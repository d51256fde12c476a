"""Port parity of the MoE layer (``repro_torch.models.layers.moe``)
against the reference's (``repro.models.layers.moe``) on the CPU, in
float32: the top-k gates (padded experts included), both dispatches'
forward and gradients, the NeuraLUT router's connectivity, forward and
sub-network gradient; then ``tests/test_moe.py``'s own cases on the
port.

Both packages start from one set of params (drawn by the port, handed
to the reference as numpy) and one input.  Tolerances, stated before
the first reading: a forward to rtol 1e-5 / atol 1e-5; a gradient to
rtol 2e-4 / atol 2e-4; the two dispatches against each other to rtol
2e-4 / atol 2e-4 (the reference's own).
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.nn.functional as F

from repro.config import MoEConfig as JMoEConfig
from repro.models.layers import moe as JM
from repro_torch import bridge
from repro_torch.config import MoEConfig
from repro_torch.models.layers import moe as M
from repro_torch.models.layers.common import init_from_spec
from repro_torch.tree import tree_leaves, tree_map

torch.set_num_threads(1)

FWD = dict(rtol=1e-5, atol=1e-5)
GRAD = dict(rtol=2e-4, atol=2e-4)


def _cfgs(**kw):
    base = dict(num_experts=8, top_k=2, num_shared=0, d_ff_expert=32,
                d_ff_shared=32)
    base.update(kw)
    return MoEConfig(**base), JMoEConfig(**base)


def _setup(router_type="linear", num_experts=8, top_k=2, num_shared=0,
           d_model=16, model_axis=1, seed=0):
    """(cfg, jcfg, port params, numpy params, x (2, 8, d_model))."""
    cfg, jcfg = _cfgs(num_experts=num_experts, top_k=top_k,
                      num_shared=num_shared, router_type=router_type)
    spec = M.moe_spec(cfg, d_model, torch.float32, model_axis=model_axis)
    p = init_from_spec(spec, torch.Generator().manual_seed(seed))
    if router_type == "neuralut":
        p["router_nl"]["log_s"] = torch.full((d_model,), float(np.log(0.5)))
    x = np.random.default_rng(seed).normal(0, 1, (2, 8, d_model)).astype(
        np.float32)
    return cfg, jcfg, p, bridge.params_to_numpy(p), x


def _jtree(p_np):
    return jax.tree.map(jnp.asarray, p_np)


def _leaf_close(got_tree, want_tree, **tol):
    got, want = tree_leaves(got_tree), jax.tree.leaves(want_tree)
    assert len(got) == len(want)
    for g, w in zip(got, want):
        np.testing.assert_allclose(g.detach().numpy(), np.asarray(w), **tol)


@pytest.mark.parametrize("e,e_pad,k", [(8, 8, 2), (6, 16, 2), (60, 64, 4)])
def test_topk_gates_match_reference(e, e_pad, k):
    """Gates and aux loss against the reference's, the padded experts
    never chosen; rows with ties (equal logits) pick the lower index,
    as ``lax.top_k``."""
    cfg, jcfg = _cfgs(num_experts=e, top_k=k)
    rng = np.random.default_rng(e)
    logits = rng.normal(0, 1, (32, e_pad)).astype(np.float32)
    logits[0, :] = 0.5                       # every expert tied
    logits[1, 1:4] = logits[1, 0] = 3.0      # a tie at the top
    gates, aux = M._topk_gates(torch.as_tensor(logits), cfg, e_pad)
    jg, jaux = JM._topk_gates(jnp.asarray(logits), jcfg, e_pad)
    np.testing.assert_allclose(gates.numpy(), np.asarray(jg), **FWD)
    np.testing.assert_array_equal(gates.numpy() > 0, np.asarray(jg) > 0)
    assert float(aux) == pytest.approx(float(jaux), rel=1e-5)
    assert float(gates[:, e:].abs().max() if e_pad > e else 0.0) == 0.0
    assert ((gates > 0).sum(-1) == k).all()
    np.testing.assert_allclose(gates.sum(-1).numpy(), 1.0, rtol=1e-5)


@pytest.mark.parametrize("dispatch,cf", [("dense", 1.25),
                                         ("sparse_capacity", 1.25),
                                         ("sparse_capacity", 8.0)])
@pytest.mark.parametrize("num_shared", [0, 2])
def test_apply_moe_matches_reference(dispatch, cf, num_shared):
    """Forward, aux loss and every parameter's and the input's gradient
    of a weighted sum of the output plus the aux loss."""
    cfg, jcfg, p, p_np, x = _setup(num_shared=num_shared, top_k=3)
    w = np.random.default_rng(7).normal(0, 1, x.shape).astype(np.float32)

    def jf(p, x):
        o, a = JM.apply_moe(p, jcfg, x, jax.nn.silu, dispatch=dispatch,
                            capacity_factor=cf)
        return jnp.sum(o * w) + a, (o, a)

    (_, (jo, ja)), jg = jax.value_and_grad(jf, argnums=(0, 1),
                                           has_aux=True)(_jtree(p_np),
                                                         jnp.asarray(x))
    tp = tree_map(lambda a: a.clone().requires_grad_(True), p)
    tx = torch.as_tensor(x).requires_grad_(True)
    o, a = M.apply_moe(tp, cfg, tx, F.silu, dispatch=dispatch,
                       capacity_factor=cf)
    np.testing.assert_allclose(o.detach().numpy(), np.asarray(jo), **FWD)
    assert float(a.detach()) == pytest.approx(float(ja), rel=1e-5)
    ((o * torch.as_tensor(w)).sum() + a).backward()
    _leaf_close(tree_map(lambda t: t.grad, tp), jg[0], **GRAD)
    np.testing.assert_allclose(tx.grad.numpy(), np.asarray(jg[1]), **GRAD)


def test_neuralut_router_connectivity_matches_reference():
    """An integer seed, not the salted hash: the reference's exactly."""
    for d, e in ((16, 8), (64, 8), (2048, 64), (2048, 60)):
        np.testing.assert_array_equal(M._router_conn(d, e),
                                      JM._router_conn(d, e))
    assert M.ROUTER_BETA * M.ROUTER_FAN_IN <= 16
    conn = M._router_conn(64, 8)
    assert conn.shape == (8, M.ROUTER_FAN_IN) and conn.dtype == np.int32
    assert (conn < 64).all() and (conn >= 0).all()


def test_neuralut_router_matches_reference():
    """The router's logits, then the layer's output and the gradients
    of every leaf, the router sub-network's and its scale's included."""
    cfg, jcfg, p, p_np, x = _setup(router_type="neuralut")
    xt = x.reshape(-1, x.shape[-1])
    np.testing.assert_allclose(
        M.apply_neuralut_router(p["router_nl"], torch.as_tensor(xt)).numpy(),
        np.asarray(JM.apply_neuralut_router(_jtree(p_np)["router_nl"],
                                            jnp.asarray(xt))), **FWD)

    def jloss(p):
        o, a = JM.apply_moe(p, jcfg, jnp.asarray(x), jax.nn.silu)
        return jnp.mean(o ** 2) + a

    jl, jg = jax.value_and_grad(jloss)(_jtree(p_np))
    tp = tree_map(lambda a: a.clone().requires_grad_(True), p)
    o, a = M.apply_moe(tp, cfg, torch.as_tensor(x), F.silu)
    loss = torch.mean(o ** 2) + a
    assert float(loss) == pytest.approx(float(jl), rel=1e-5)
    loss.backward()
    g = tree_map(lambda t: t.grad, tp)
    gn = float(g["router_nl"]["fn"]["layers"][0]["w"].norm())
    assert np.isfinite(gn) and gn > 0     # the router subnet learns
    # the linear router is in the tree but unused: no gradient
    assert tp["router"].grad is None
    g["router"] = torch.zeros_like(p["router"])
    _leaf_close(g, jg, **GRAD)


def test_router_fn_overrides_the_router():
    cfg, _, p, _, x = _setup()
    seen = []

    def router(extra, xt):
        seen.append(extra)
        return xt[:, :8].float() * 3.0

    o, _ = M.apply_moe(p, cfg, torch.as_tensor(x), F.silu, router_fn=router)
    o2, _ = M.apply_moe(dict(p, router=torch.zeros_like(p["router"])), cfg,
                        torch.as_tensor(x), F.silu, router_fn=router)
    assert seen == [None, None] and torch.equal(o, o2)
    with pytest.raises(ValueError):
        M.apply_moe(p, cfg, torch.as_tensor(x), F.silu, dispatch="ragged")


# ---------------------------------------------------------------------------
# tests/test_moe.py's cases, on the port


def test_topk_gates_sum_to_one():
    cfg, _, p, _, x = _setup()
    logits = torch.as_tensor(x).reshape(-1, 16) @ p["router"]
    gates, aux = M._topk_gates(logits, cfg, 8)
    np.testing.assert_allclose(gates.sum(-1).numpy(), 1.0, rtol=1e-5)
    assert ((gates > 0).sum(-1) <= cfg.top_k).all()
    assert float(aux) > 0


def test_dense_vs_capacity_dispatch_agree():
    """With ample capacity, scatter dispatch == dense dispatch."""
    cfg, _, p, _, x = _setup()
    xt = torch.as_tensor(x)
    out_d, _ = M.apply_moe(p, cfg, xt, F.silu, dispatch="dense")
    out_c, _ = M.apply_moe(p, cfg, xt, F.silu, dispatch="sparse_capacity",
                           capacity_factor=8.0)
    np.testing.assert_allclose(out_d.numpy(), out_c.numpy(), rtol=2e-4,
                               atol=2e-4)


def test_capacity_drops_overflow():
    """With capacity floored at 1 slot per expert most pairs drop: the
    output is smaller than with ample capacity, and equals the
    reference's (the dropped pairs' clipped scatter adds zeros)."""
    cfg, jcfg, p, p_np, x = _setup()
    xt = torch.as_tensor(x)
    tiny, _ = M.apply_moe(p, cfg, xt, F.silu, dispatch="sparse_capacity",
                          capacity_factor=1e-9)
    full, _ = M.apply_moe(p, cfg, xt, F.silu, dispatch="sparse_capacity",
                          capacity_factor=8.0)
    assert float(tiny.norm()) < float(full.norm())
    assert not np.allclose(tiny.numpy(), full.numpy())
    jt, _ = JM.apply_moe(_jtree(p_np), jcfg, jnp.asarray(x), jax.nn.silu,
                         dispatch="sparse_capacity", capacity_factor=1e-9)
    np.testing.assert_allclose(tiny.numpy(), np.asarray(jt), **FWD)
    # one slot per expert: at most E of the T * k pairs are served
    kept = (tiny.reshape(-1, 16).abs().sum(-1) > 0).sum()
    assert int(kept) <= 8


def test_expert_padding():
    cfg = MoEConfig(num_experts=60, top_k=4, d_ff_expert=8)
    assert M.padded_num_experts(cfg, 16) == 64
    assert M.padded_num_experts(cfg, 1) == 60
    assert M.padded_num_experts(dataclasses.replace(cfg, sharding="tp"),
                                16) == 60
    spec = M.moe_spec(cfg, 8, torch.float32, model_axis=16)
    assert spec["w_gate"].shape[0] == 64 and spec["router"].shape == (8, 64)
    jspec = JM.moe_spec(JMoEConfig(num_experts=60, top_k=4, d_ff_expert=8),
                        8, jnp.float32, model_axis=16)
    assert {k: tuple(v.shape) for k, v in spec.items()} == \
        {k: tuple(v.shape) for k, v in jspec.items()}
    # padded (inert) experts can never be selected, even when the
    # padded logits are the largest
    logits = torch.as_tensor(np.random.default_rng(0).normal(0, 1, (32, 64)))
    logits[:, 60:] = 50.0
    gates, _ = M._topk_gates(logits, cfg, 64)
    assert float(gates[:, 60:].max()) == 0.0
