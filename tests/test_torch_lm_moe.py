"""Port parity of the MoE and MLA + MoE LMs against the reference on the
CPU, in float32, at their reduced sizes: qwen2-moe-a2.7b (16 experts
after padding 6 to the reference's 16-wide model axis),
deepseek-v2-lite-16b (MLA, a dense prefix layer, then MoE) and qwen
with the NeuraLUT router (as ``tests/test_moe.py``'s full-model case).

Both packages start from one set of params (drawn by the port, bridged
to the reference as numpy) and one batch.  Tolerances, stated before
the first reading: ``lm_loss``'s CE and ``moe_aux`` to rtol 1e-5 / atol
1e-5, each gradient leaf to rtol 2e-4 / atol 2e-4, decode logits to atol
1e-5 x the largest logit, MLA decode against prefill to the reference's
3e-3.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.config import get_config as j_get_config
from repro.models import api as JA
from repro_torch import bridge
from repro_torch.config import get_config
from repro_torch.models import api, lm
from repro_torch.models.layers.common import zeros_from_spec
from repro_torch.train.step import value_and_grad
from repro_torch.tree import tree_leaves

torch.set_num_threads(1)

FWD = dict(rtol=1e-5, atol=1e-5)
GRAD = dict(rtol=2e-4, atol=2e-4)
Q_CHUNK = 16
B, S = 2, 32
MODELS = {
    "qwen2-moe-a2.7b": {},
    "deepseek-v2-lite-16b": {},
    "qwen2-moe-a2.7b-neuralut": {"router_type": "neuralut"},
    "qwen2-moe-a2.7b-capacity": {"moe_dispatch": "sparse_capacity"},
}


def _cfgs(model):
    arch = model.split("-neuralut")[0].split("-capacity")[0]
    kw = MODELS[model]
    out = []
    for c in (get_config(arch, reduced=True),
              j_get_config(arch, reduced=True)):
        c = dataclasses.replace(c, dtype="float32")
        if "router_type" in kw:
            c = dataclasses.replace(c, moe=dataclasses.replace(
                c.moe, router_type=kw["router_type"]))
        if "moe_dispatch" in kw:
            c = dataclasses.replace(c, moe_dispatch=kw["moe_dispatch"])
        out.append(c)
    return out


def _params(cfg, seed=0):
    p = api.init_params(cfg, torch.Generator().manual_seed(seed))
    if cfg.moe.router_type == "neuralut":
        # a wider quantizer step than the init's exp(0) = 1 (as
        # tests/test_moe.py sets it), so the router sees several codes
        for blk in p["blocks"]:
            blk["ffn"]["router_nl"]["log_s"].fill_(float(np.log(0.5)))
    return p


def _batch(vocab, seed=0):
    rng = np.random.default_rng(seed)
    return {"tokens": rng.integers(0, vocab, (B, S)).astype(np.int32),
            "labels": rng.integers(0, vocab, (B, S)).astype(np.int32)}


def _jtree(p_np):
    return jax.tree.map(jnp.asarray, p_np)


@pytest.mark.parametrize("model", list(MODELS))
def test_lm_loss_aux_and_grads_match_reference(model):
    cfg, jcfg = _cfgs(model)
    p_np = bridge.params_to_numpy(_params(cfg))
    batch = _batch(cfg.vocab_size)
    f = jax.jit(jax.value_and_grad(lambda p, b: JA.loss_fn(
        jcfg, p, b, q_chunk=Q_CHUNK), has_aux=True))
    (jl, jm), jg = f(_jtree(p_np), batch)
    params = bridge.lm_params_from_numpy(cfg, p_np, device="cpu")
    (loss, m), grads = value_and_grad(
        lambda p, b: api.loss_fn(cfg, p, b, q_chunk=Q_CHUNK), params,
        {k: torch.as_tensor(v) for k, v in batch.items()})
    np.testing.assert_allclose(float(m["ce"]), float(jm["ce"]), **FWD)
    np.testing.assert_allclose(float(m["moe_aux"]), float(jm["moe_aux"]),
                               **FWD)
    assert float(m["moe_aux"]) > 0.0
    np.testing.assert_allclose(float(loss), float(jl), **FWD)
    got, want = tree_leaves(grads), jax.tree.leaves(jg)
    assert len(got) == len(want)
    for g, w in zip(got, want):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), **GRAD)
    if "neuralut" in model:
        gw = grads["blocks"][0]["ffn"]["router_nl"]["fn"]["layers"][0]["w"]
        assert float(gw.norm()) > 0.0    # the router subnet learns
        assert float(grads["blocks"][0]["ffn"]["router"].abs().max()) == 0.0


def test_lm_params_bridge_the_expert_stacks():
    """The bridge carries every MoE and MLA leaf of the reference's
    tree: expert stacks (E, D, F) / (E, F, D), the shared experts, the
    float32 router, the NeuraLUT router, the MLA projections and the
    dense prefix; a leaf of the wrong shape is refused."""
    cfg, jcfg = _cfgs("qwen2-moe-a2.7b-neuralut")
    jspec = JA.param_spec(jcfg)
    p_np = jax.tree.map(lambda s: np.random.default_rng(0).normal(
        0, 1, s.shape).astype(np.float32), jspec)
    p = bridge.lm_params_from_numpy(cfg, p_np, device="cpu")
    ffn = p["blocks"][0]["ffn"]
    e = 16      # 6 experts padded to the 16-wide model axis
    assert ffn["w_gate"].shape == (2, e, 64, 32)
    assert ffn["w_down"].shape == (2, e, 32, 64)
    assert ffn["ws_up"].shape == (2, 64, 64)
    assert ffn["router"].dtype == torch.float32
    assert ffn["router_nl"]["fn"]["layers"][0]["w"].shape == (2, e, 6, 8)
    for a, w in zip(tree_leaves(p), jax.tree.leaves(p_np)):
        np.testing.assert_array_equal(a.numpy(), w)
    bad = dict(p_np, blocks=[dict(p_np["blocks"][0], ffn=dict(
        p_np["blocks"][0]["ffn"], w_up=np.zeros((2, 15, 64, 32))))])
    with pytest.raises(ValueError, match="w_up"):
        bridge.lm_params_from_numpy(cfg, bad, device="cpu")
    dcfg, djcfg = _cfgs("deepseek-v2-lite-16b")
    d_np = jax.tree.map(lambda s: np.zeros(s.shape, np.float32),
                        JA.param_spec(djcfg))
    d = bridge.lm_params_from_numpy(dcfg, d_np, device="cpu")
    assert set(d["prefix_blocks"][0]["mixer"]) == {
        "wq", "w_dkv", "w_kr", "w_uk", "w_uv", "wo"}
    assert set(d["prefix_blocks"][0]["ffn"]) == {"w_gate", "w_up", "w_down"}
    assert d["blocks"][0]["ffn"]["w_gate"].shape == (2, 16, 64, 32)


@pytest.mark.parametrize("model", ["qwen2-moe-a2.7b", "deepseek-v2-lite-16b"])
def test_decode_step_matches_reference(model):
    """Six decode steps of batch 2 in a context of 10, each step's
    logits and (deepseek) latent cache against the reference's."""
    cfg, jcfg = _cfgs(model)
    params = _params(cfg)
    jp = _jtree(bridge.params_to_numpy(params))
    state = zeros_from_spec(api.decode_state_spec(cfg, 2, 10))
    jstate = jax.tree.map(lambda s: jnp.zeros(s.shape, s.dtype),
                          JA.decode_state_spec(jcfg, 2, 10))
    assert [tuple(s.shape) for s in tree_leaves(state)] == \
        [tuple(s.shape) for s in jax.tree.leaves(jstate)]
    jstep = jax.jit(lambda p, s, t: JA.decode_step(jcfg, p, s, t))
    toks = np.random.default_rng(1).integers(0, cfg.vocab_size, (2, 6))
    for i in range(6):
        tok = toks[:, i:i + 1].astype(np.int32)
        with torch.no_grad():
            logits, state = api.decode_step(cfg, params, state,
                                            torch.as_tensor(tok))
        jlogits, jstate = jstep(jp, jstate, jnp.asarray(tok))
        jl = np.asarray(jlogits)
        np.testing.assert_allclose(logits.numpy(), jl, rtol=0,
                                   atol=1e-5 * float(np.abs(jl).max()))
    for a, w in zip(tree_leaves(state), jax.tree.leaves(jstate)):
        np.testing.assert_allclose(a.numpy(), np.asarray(w), rtol=1e-5,
                                   atol=1e-5)
    if cfg.attention.kind == "mla":
        assert set(state["blocks"][0]) == {"c_kv", "k_rope"}
        assert state["blocks"][0]["c_kv"].shape == (2, 2, 10, 32)


def test_mla_decode_matches_prefill_logits():
    """deepseek's absorbed decode (MLA, the dense prefix, MoE with the
    dense dispatch) equals the expanded forward at every position, to
    the reference's MLA tolerance 3e-3."""
    cfg, _ = _cfgs("deepseek-v2-lite-16b")
    params = _params(cfg)
    toks = torch.as_tensor(np.random.default_rng(2).integers(
        0, cfg.vocab_size, (2, 24)).astype(np.int32))
    with torch.no_grad():
        pre = lm.prefill_logits(cfg, params, toks, q_chunk=8)
        state = zeros_from_spec(api.decode_state_spec(cfg, 2, 24))
        for i in range(24):
            logits, state = api.decode_step(cfg, params, state,
                                            toks[:, i:i + 1])
            np.testing.assert_allclose(logits.numpy(), pre[:, i].numpy(),
                                       rtol=3e-3, atol=3e-3)


def test_moe_remat_policies_agree():
    """remat none / dots / full give the same loss and gradients on the
    MoE and MLA models; under "dots" the experts' gate and up products
    are 2-D matmuls, which the policy saves."""
    for model in ("qwen2-moe-a2.7b", "deepseek-v2-lite-16b"):
        cfg, _ = _cfgs(model)
        params = _params(cfg)
        batch = {k: torch.as_tensor(v)
                 for k, v in _batch(cfg.vocab_size, seed=3).items()}
        runs = [value_and_grad(lambda p, b: api.loss_fn(
            cfg, p, b, remat=r, q_chunk=Q_CHUNK), params, batch)
            for r in ("none", "dots", "full")]
        for (loss, _), grads in runs[1:]:
            assert float(loss) == float(runs[0][0][0])
            for a, b in zip(tree_leaves(grads), tree_leaves(runs[0][1])):
                np.testing.assert_allclose(a.numpy(), b.numpy(), rtol=1e-6,
                                           atol=1e-9)


def test_dots_remat_saves_the_expert_products():
    """remat="dots" keeps every 2-D matmul's output, the experts' gate
    and up products included (dots without batch dims, which the
    reference's policy saves): its backward runs as many ``aten.mm``
    as remat="none"'s, while "full" recomputes them."""
    from torch.utils._python_dispatch import TorchDispatchMode

    class CountMM(TorchDispatchMode):
        def __init__(self):
            super().__init__()
            self.n = 0

        def __torch_dispatch__(self, func, types, args=(), kwargs=None):
            self.n += func is torch.ops.aten.mm.default
            return func(*args, **(kwargs or {}))

    cfg, _ = _cfgs("qwen2-moe-a2.7b")
    params = _params(cfg)
    batch = {k: torch.as_tensor(v) for k, v in _batch(cfg.vocab_size).items()}
    counts = {}
    for remat in ("none", "dots", "full"):
        p = {k: v for k, v in params.items()}
        leaves = [t.requires_grad_(True) for t in tree_leaves(p)]
        loss, _ = api.loss_fn(cfg, p, batch, remat=remat, q_chunk=Q_CHUNK)
        with CountMM() as c:
            torch.autograd.grad(loss, leaves, allow_unused=True)
        counts[remat] = c.n
        for t in leaves:
            t.requires_grad_(False)
    assert counts["dots"] == counts["none"] < counts["full"], counts


def test_keep_policy_reads_this_threads_mark():
    """``moe.keep_policy`` keeps a product only where this thread marked
    it (``moe._kept``).  Under a torch whose recompute asks the policy
    again (2.11 does, 2.13 does not), a flag shared by the threads raised
    "encountered during backward, but not found in storage" when one
    thread's MoE combine ran inside ``_kept`` while another recomputed
    its block, as ``chip_smoke.py``'s MoE phase does with its CPU step
    beside the card's."""
    import threading

    from torch.utils.checkpoint import (CheckpointPolicy,
                                        SelectiveCheckpointContext)
    from repro_torch.models.layers import moe
    ctx = SelectiveCheckpointContext(is_recompute=True)
    mm = torch.ops.aten.mm.default
    inside, done = threading.Event(), threading.Event()

    def hold():
        with moe._kept():
            inside.set()
            done.wait(60)

    other = threading.Thread(target=hold)
    other.start()
    try:
        assert inside.wait(60)
        assert moe.keep_policy(ctx, mm) == CheckpointPolicy.PREFER_RECOMPUTE
        with moe._kept():
            assert moe.keep_policy(ctx, mm) == CheckpointPolicy.MUST_SAVE
        assert moe.keep_policy(ctx, mm) == CheckpointPolicy.PREFER_RECOMPUTE
    finally:
        done.set()
        other.join()
