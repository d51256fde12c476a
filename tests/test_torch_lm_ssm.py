"""Port parity of the hybrid and SSM LMs against the reference on the
CPU, at their reduced sizes: jamba-v0.1-52b (Mamba and attention
layers, dense and MoE FFNs) and xlstm-350m (mLSTM and sLSTM layers, no
FFN, tied embeddings).  ``lm_loss`` and its gradients, one training
step, ``decode_step`` from the zero state (the reference's
``launch.serve``) and from stabilizers at -inf, decode against prefill,
the remat policies, and both launchers.

Both packages start from one set of params (drawn by the port, bridged
to the reference as numpy) and one batch.  Tolerances, stated before
the readings below were taken:

* float32 loss to rtol 1e-5.  Gradients: jamba each leaf to rtol 1e-4 /
  atol 1e-5 x its largest element, as the other LMs; xLSTM to atol 1e-4
  x its largest.  The xLSTM model's float32 gradient is that sensitive
  to rounding in either package: against the port run in float64
  (whose gates stay float32, as the reference's), the port reads 2.0e-4
  and the reference 1.6e-4 of a leaf's largest element, and the two
  read 4.2e-5 against each other (one of 23 leaves has 3 elements
  beyond 1e-5 there);
* bfloat16: the loss to rtol 1e-3.  Both packages' bfloat16 gradients
  of these recurrences stray from the float32 gradient of the same
  (bfloat16-valued) params by up to 0.41 (jamba) and 0.86 (xLSTM) of a
  leaf's largest element, so each leaf of the port is held to at most
  twice the reference's own bfloat16 error there, plus 1e-2 of the
  leaf's largest element (the port reads at most 1.55x);
* one training step: the loss to rtol 1e-5; the new params and first
  moments to rtol 1e-5 / atol 1e-5 where the reference's gradient is 0
  or certain (at least 1e-5 of its leaf's largest element, at least
  1e-7, 10x Adam's eps, and 100x the two packages' difference), within
  the step's reach (2 lr) on the rest, which must be under 0.5 % of the
  elements (``tests/test_torch_lm_train.py``'s split, with the
  difference added for the xLSTM's gradients above);
* decode logits (float32) against the reference's to atol 1e-5 x the
  largest logit; decode against prefill from stabilizers at -inf to
  3e-3 x the largest prefill logit (the reference's mLSTM bound).
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
from repro.train.step import make_train_step as j_make_train_step
from repro_torch import bridge
from repro_torch.config import TrainConfig, get_config
from repro_torch.launch import serve as launch_serve
from repro_torch.launch import train as launch_train
from repro_torch.models import api, lm
from repro_torch.models.layers.common import zeros_from_spec
from repro_torch.optim import adamw_init
from repro_torch.train.step import make_train_step, value_and_grad
from repro_torch.tree import tree_leaves

torch.set_num_threads(1)

ARCHS = ("jamba-v0.1-52b", "xlstm-350m")
Q_CHUNK = 16
B, S = 2, 32
GRAD_ATOL = {"jamba-v0.1-52b": 1e-5, "xlstm-350m": 1e-4}
GRAD_T = 1e-5
GRAD_ABS = 1e-7     # 10x Adam's eps: below it eps shapes the step
TCFG = dict(lr=3e-3, sgdr_t0=4, weight_decay=0.01)
STEP = dict(rtol=1e-5, atol=1e-5)


def _cfgs(arch, dtype="float32"):
    return (dataclasses.replace(get_config(arch, reduced=True), dtype=dtype),
            dataclasses.replace(j_get_config(arch, reduced=True),
                                dtype=dtype))


def _batch(vocab, seed=0):
    rng = np.random.default_rng(seed)
    return {"tokens": rng.integers(0, vocab, (B, S)).astype(np.int32),
            "labels": rng.integers(0, vocab, (B, S)).astype(np.int32)}


def _tbatch(b):
    return {k: torch.as_tensor(v) for k, v in b.items()}


def _jtree(jcfg, p_np):
    """numpy params -> the reference's tree in its spec's dtypes."""
    return jax.tree.map(lambda a, s: jnp.asarray(a, s.dtype), p_np,
                        JA.param_spec(jcfg))


def _grads(arch, dtype, p_np, batch):
    """(port loss, metrics, grads as float32 numpy; reference loss,
    grads) from the same params."""
    cfg, jcfg = _cfgs(arch, dtype)
    f = jax.jit(jax.value_and_grad(lambda p, b: JA.loss_fn(
        jcfg, p, b, q_chunk=Q_CHUNK), has_aux=True))
    (jl, _), jg = f(_jtree(jcfg, p_np), batch)
    params = bridge.lm_params_from_numpy(cfg, p_np, device="cpu")
    (loss, m), g = value_and_grad(
        lambda p, b: api.loss_fn(cfg, p, b, q_chunk=Q_CHUNK), params,
        _tbatch(batch))
    for a, p in zip(tree_leaves(g), tree_leaves(params)):
        assert a.dtype == p.dtype
    return (float(loss), m, [a.float().numpy() for a in tree_leaves(g)],
            float(jl), [np.asarray(a, np.float32) for a in jax.tree.leaves(jg)])


@pytest.mark.parametrize("arch", ARCHS)
def test_lm_loss_and_grads_match_reference(arch):
    cfg, _ = _cfgs(arch)
    p_np = bridge.params_to_numpy(api.init_params(
        cfg, torch.Generator().manual_seed(0)))
    batch = _batch(cfg.vocab_size)
    loss, m, got, jloss, want = _grads(arch, "float32", p_np, batch)
    assert loss == pytest.approx(jloss, rel=1e-5)
    if arch.startswith("jamba"):     # MoE on the odd layers
        assert float(m["moe_aux"]) > 0.0
    else:
        assert float(m["moe_aux"]) == 0.0
    assert len(got) == len(want)
    for g, w in zip(got, want):
        np.testing.assert_allclose(g, w, rtol=1e-4,
                                   atol=GRAD_ATOL[arch] * np.abs(w).max())


@pytest.mark.parametrize("arch", ARCHS)
def test_bf16_loss_and_grads_match_reference(arch):
    """bfloat16 params (the float32 leaves kept float32): the loss, and
    each gradient leaf's error against the float32 gradient of the same
    params no more than twice the reference's own."""
    cfg, _ = _cfgs(arch, "bfloat16")
    p_np = bridge.params_to_numpy(api.init_params(
        cfg, torch.Generator().manual_seed(0)))
    batch = _batch(cfg.vocab_size)
    loss, _, got, jloss, want = _grads(arch, "bfloat16", p_np, batch)
    assert loss == pytest.approx(jloss, rel=1e-3)
    _, _, exact, _, _ = _grads(arch, "float32", p_np, batch)
    for g, w, e in zip(got, want, exact):
        scale = float(np.abs(e).max())
        assert np.abs(g - e).max() <= 2 * np.abs(w - e).max() + 1e-2 * scale


def _np(tree):
    return jax.tree.map(lambda a: np.asarray(a, np.float32), tree)


@pytest.mark.parametrize("arch", ARCHS)
def test_one_train_step_matches_reference(arch):
    cfg, jcfg = _cfgs(arch)
    p_np = bridge.params_to_numpy(api.init_params(
        cfg, torch.Generator().manual_seed(1)))
    batch = _batch(cfg.vocab_size, seed=1)
    jp = _jtree(jcfg, p_np)
    jgrad = jax.grad(lambda p, b: JA.loss_fn(jcfg, p, b, q_chunk=Q_CHUNK)[0])(
        jp, batch)
    params = bridge.lm_params_from_numpy(cfg, p_np, device="cpu")
    _, grads = value_and_grad(lambda p, b: api.loss_fn(
        cfg, p, b, q_chunk=Q_CHUNK), params, _tbatch(batch))
    loose = [(w != 0) & ((np.abs(w) < max(GRAD_T * np.abs(w).max(),
                                          GRAD_ABS))
                         | (np.abs(w) < 100 * np.abs(g.numpy() - w)))
             for g, w in zip(tree_leaves(grads), jax.tree.leaves(_np(jgrad)))]
    p2, o2, jm = jax.jit(j_make_train_step(jcfg, JTrain(**TCFG),
                                           q_chunk=Q_CHUNK))(
        jp, j_adamw_init(jp), batch)
    new_p, new_o, m = make_train_step(cfg, TrainConfig(**TCFG),
                                      q_chunk=Q_CHUNK)(
        params, adamw_init(params), _tbatch(batch))
    assert float(m["loss"]) == pytest.approx(float(jm["loss"]), rel=1e-5)
    reach = 2 * TCFG["lr"]
    for got, want in ((new_p, p2), (new_o["m"], o2["m"])):
        g = tree_leaves(bridge.params_to_numpy(got))
        w = jax.tree.leaves(_np(want))
        assert len(g) == len(w) == len(loose)
        for a, b, lm_ in zip(g, w, loose):
            np.testing.assert_allclose(a[~lm_], b[~lm_], **STEP)
            assert np.all(np.abs(a[lm_] - b[lm_]) <= reach + STEP["atol"])
    assert sum(int(x.sum()) for x in loose) < 5e-3 * sum(
        x.size for x in loose)


def _states(cfg, jcfg, batch, ctx, start):
    state = zeros_from_spec(api.decode_state_spec(cfg, batch, ctx))
    jstate = jax.tree.map(lambda s: jnp.zeros(s.shape, s.dtype),
                          JA.decode_state_spec(jcfg, batch, ctx))
    assert [tuple(s.shape) for s in tree_leaves(state)] == \
        [tuple(s.shape) for s in jax.tree.leaves(jstate)]
    if start == "-inf":
        state = lm.with_minus_inf_stabilizers(state)
        jstate = dict(jstate, blocks=[
            dict(c, m=jnp.full(c["m"].shape, -jnp.inf)) if "m" in c else c
            for c in jstate["blocks"]])
    return state, jstate


@pytest.mark.parametrize("start", ["zeros", "-inf"])
@pytest.mark.parametrize("arch", ARCHS)
def test_decode_step_matches_reference(arch, start):
    """Six decode steps of batch 2 in a context of 10, each step's
    logits and the final state against the reference's."""
    cfg, jcfg = _cfgs(arch)
    params = api.init_params(cfg, torch.Generator().manual_seed(0))
    jp = _jtree(jcfg, bridge.params_to_numpy(params))
    state, jstate = _states(cfg, jcfg, 2, 10, start)
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
        w = np.asarray(w, np.float32)
        np.testing.assert_allclose(a.float().numpy(), w, rtol=1e-5,
                                   atol=1e-5 * max(1.0, np.abs(w).max()))


@pytest.mark.parametrize("arch", ARCHS)
def test_decode_matches_prefill_logits(arch):
    """From stabilizers at -inf (jamba has none: its states start at
    zero) the decode steps equal the prefill forward at every
    position."""
    cfg, _ = _cfgs(arch)
    params = api.init_params(cfg, torch.Generator().manual_seed(0))
    toks = torch.as_tensor(np.random.default_rng(2).integers(
        0, cfg.vocab_size, (2, 16)).astype(np.int32))
    with torch.no_grad():
        pre = lm.prefill_logits(cfg, params, toks, q_chunk=8)
        state = lm.with_minus_inf_stabilizers(
            zeros_from_spec(api.decode_state_spec(cfg, 2, 16)))
        tol = 3e-3 * float(pre.abs().max())
        for i in range(16):
            logits, state = api.decode_step(cfg, params, state,
                                            toks[:, i:i + 1])
            np.testing.assert_allclose(logits.numpy(), pre[:, i].numpy(),
                                       rtol=0, atol=tol)


def test_decode_walks_the_blocks_as_the_reference_does():
    """The reference's ``decode_step`` runs every repeat of pattern
    position 0, then of position 1, ...; its ``apply_stack`` runs the
    repeats in turn, each over the whole pattern.  With a pattern of two
    layers repeated twice (mLSTM, sLSTM, mLSTM, sLSTM) the port's decode
    equals the reference's decode and so, like it, not the prefill (a
    caveat about the reference, ROADMAP.md)."""
    cfg, jcfg = (dataclasses.replace(c, num_layers=4)
                 for c in _cfgs("xlstm-350m"))
    params = api.init_params(cfg, torch.Generator().manual_seed(0))
    jp = _jtree(jcfg, bridge.params_to_numpy(params))
    state, jstate = _states(cfg, jcfg, 2, 8, "-inf")
    toks = np.random.default_rng(4).integers(0, cfg.vocab_size, (2, 8))
    jstep = jax.jit(lambda p, s, t: JA.decode_step(jcfg, p, s, t))
    with torch.no_grad():
        pre = lm.prefill_logits(cfg, params, torch.as_tensor(
            toks.astype(np.int32)), q_chunk=8)
    off = 0.0
    for i in range(8):
        tok = toks[:, i:i + 1].astype(np.int32)
        with torch.no_grad():
            logits, state = api.decode_step(cfg, params, state,
                                            torch.as_tensor(tok))
        jlogits, jstate = jstep(jp, jstate, jnp.asarray(tok))
        jl = np.asarray(jlogits)
        np.testing.assert_allclose(logits.numpy(), jl, rtol=0,
                                   atol=1e-5 * float(np.abs(jl).max()))
        off = max(off, float((logits - pre[:, i]).abs().max()))
    assert off > 0.1 * float(pre.abs().max())


def test_zero_state_decode_is_the_reference_start():
    """``with_minus_inf_stabilizers`` sets the mLSTM's and the sLSTM's
    ``m`` and nothing else; a zero state keeps m = 0."""
    cfg, _ = _cfgs("xlstm-350m")
    zero = zeros_from_spec(api.decode_state_spec(cfg, 2, 8))
    st = lm.with_minus_inf_stabilizers(zero)
    assert [sorted(c) for c in st["blocks"]] == [sorted(c) for c in
                                                 zero["blocks"]]
    for c, z in zip(st["blocks"], zero["blocks"]):
        assert bool(torch.isinf(c["m"]).all()) and float(z["m"].abs().max()) == 0
        for k in c:
            if k != "m":
                assert c[k] is z[k]
    jam, _ = _cfgs("jamba-v0.1-52b")
    js = zeros_from_spec(api.decode_state_spec(jam, 2, 8))
    assert all(a is b for a, b in zip(
        tree_leaves(lm.with_minus_inf_stabilizers(js)), tree_leaves(js)))


@pytest.mark.parametrize("arch", ARCHS)
def test_remat_policies_agree(arch):
    """remat none / dots / full give the same loss and gradients with
    the mixers' Python loops (the scan's chunks, the sLSTM's steps)
    inside the checkpointed blocks."""
    cfg, _ = _cfgs(arch)
    params = api.init_params(cfg, torch.Generator().manual_seed(0))
    batch = _tbatch(_batch(cfg.vocab_size, seed=3))
    runs = [value_and_grad(lambda p, b: api.loss_fn(
        cfg, p, b, remat=r, q_chunk=Q_CHUNK), params, batch)
        for r in ("none", "dots", "full")]
    for (loss, _), grads in runs[1:]:
        assert float(loss) == float(runs[0][0][0])
        for a, b in zip(tree_leaves(grads), tree_leaves(runs[0][1])):
            np.testing.assert_allclose(a.numpy(), b.numpy(), rtol=1e-6,
                                       atol=1e-9)


@pytest.mark.parametrize("arch", ARCHS)
def test_launch_train_and_serve(arch, capsys):
    """Both archs train through launch.train (the loss falls) and decode
    through launch.serve --mode lm on the CPU."""
    out = launch_train.main(["--arch", arch, "--reduced", "--steps", "6",
                             "--lr", "3e-3", "--global-batch", "2",
                             "--seq-len", "32", "--device", "cpu",
                             "--log-every", "0"])
    assert out["steps"] == 6 and out["last_loss"] < out["first_loss"]
    text = capsys.readouterr().out
    assert f"{arch}-reduced" in text and "lm train summary" in text
    served = launch_serve.main(["--mode", "lm", "--arch", arch, "--device",
                                "cpu", "--requests", "4", "--batch", "2"])
    assert served["steps"] == 4 and served["last_tokens"].shape == (2, 1)
    assert "ms/token" in capsys.readouterr().out
