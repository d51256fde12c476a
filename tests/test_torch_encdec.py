"""Port parity of the encoder-decoder LM (``repro_torch.models.encdec``,
whisper-small) and of cross attention against the reference's
(``repro.models.encdec``, ``repro.models.layers.attention``) on the CPU,
at the reduced config (2 + 2 layers, d 64, 4 heads, 24 frames).

Both packages start from one set of params (drawn by the port, bridged
to the reference as numpy) and one numpy batch.  Tolerances, stated
before the first reading:

* cross attention (float32): forward rtol 1e-5 / atol 1e-5, each
  gradient to rtol 1e-4 / atol 1e-5 x its largest element;
* the sinusoid table: 4 float32 ulps of its largest angle (seq
  radians): 4 x 2^-24 x seq;
* ``encode`` to rtol 1e-5 / atol 1e-5 x its largest element;
* ``encdec_loss`` (float32) to rtol 1e-5, each gradient leaf to rtol
  1e-4 / atol 1e-5 x its largest element;
* ``prefill_cross`` to rtol 1e-5 / atol 1e-6, decode logits to atol
  1e-5 x the largest logit;
* one ``make_train_step`` step: ``tests/test_torch_lm_train.py``'s
  split (atol / rtol 1e-5 where the reference's gradient is at least
  1e-5 of its leaf's largest element, the step's reach elsewhere).
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.config import AttentionConfig as JAttentionConfig
from repro.config import TrainConfig as JTrain
from repro.config import get_config as j_get_config
from repro.models import api as JA
from repro.models import encdec as JE
from repro.models.layers import attention as JAttn
from repro.optim.adamw import adamw_init as j_adamw_init
from repro.train.step import make_train_step as j_make_train_step
from repro_torch import bridge
from repro_torch.config import AttentionConfig, TrainConfig, get_config
from repro_torch.models import api, encdec
from repro_torch.models.layers import attention as A
from repro_torch.models.layers.common import zeros_from_spec
from repro_torch.optim import adamw_init
from repro_torch.train.step import (_accum_grads, make_train_step,
                                    value_and_grad)
from repro_torch.tree import tree_leaves

from test_torch_lm_train import TCFG, _close_trees, _np, _small

torch.set_num_threads(1)

ARCH = "whisper-small"
B, S = 2, 16
Q_CHUNK = 8


def _t(a):
    return torch.as_tensor(np.asarray(a))


def _cfgs(dtype="float32"):
    return (dataclasses.replace(get_config(ARCH, reduced=True), dtype=dtype),
            dataclasses.replace(j_get_config(ARCH, reduced=True),
                                dtype=dtype))


def _batch(cfg, seed=0, b=B, s=S):
    rng = np.random.default_rng(seed)
    e = cfg.encoder
    return {"tokens": rng.integers(0, cfg.vocab_size, (b, s)).astype(
                np.int32),
            "labels": rng.integers(0, cfg.vocab_size, (b, s)).astype(
                np.int32),
            "frames": rng.normal(0, 1, (b, e.seq_len, e.feature_dim)).astype(
                np.float32)}


def _tbatch(b):
    return {k: torch.as_tensor(v) for k, v in b.items()}


def _jtree(np_tree):
    return jax.tree.map(jnp.asarray, np_tree)


@pytest.fixture(scope="module")
def model():
    """(cfg, jcfg, port params, the reference's params) from one draw."""
    cfg, jcfg = _cfgs()
    params = api.init_params(cfg, torch.Generator().manual_seed(0))
    return cfg, jcfg, params, _jtree(bridge.params_to_numpy(params))


@pytest.mark.parametrize("impl", ["chunked", "flash"])
@pytest.mark.parametrize("heads,kv", [(4, 4), (4, 2)])
def test_cross_attention_matches_reference(heads, kv, impl):
    """MHA and GQA, 24 decoder queries in chunks of 8 against 40 encoder
    states: the output and the gradients of x, enc and every weight."""
    kw = dict(kind="gqa", num_heads=heads, num_kv_heads=kv, head_dim=16,
              rope_kind="none")
    cfg, jcfg = AttentionConfig(**kw), JAttentionConfig(**kw)
    rng = np.random.default_rng(heads * 10 + kv)
    d = 32
    p = {k: rng.normal(0, d ** -0.5, s).astype(np.float32)
         for k, s in (("wq", (d, cfg.q_dim)), ("wk", (d, cfg.kv_dim)),
                      ("wv", (d, cfg.kv_dim)), ("wo", (cfg.q_dim, d)))}
    x = rng.normal(0, 1, (2, 24, d)).astype(np.float32)
    enc = rng.normal(0, 1, (2, 40, d)).astype(np.float32)
    w = rng.normal(0, 1, (2, 24, d)).astype(np.float32)

    def jf(p, x, enc):
        o = JAttn.apply_cross_attention(p, jcfg, x, enc, q_chunk=8,
                                        impl=impl)
        return jnp.sum(o * w), o

    (_, want), jg = jax.jit(jax.value_and_grad(jf, argnums=(0, 1, 2),
                                               has_aux=True))(
        _jtree(p), jnp.asarray(x), jnp.asarray(enc))
    tp = {k: _t(v).requires_grad_(True) for k, v in p.items()}
    tx, tenc = _t(x).requires_grad_(True), _t(enc).requires_grad_(True)
    got = A.apply_cross_attention(tp, cfg, tx, tenc, q_chunk=8, impl=impl)
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(want),
                               rtol=1e-5, atol=1e-5)
    (got * _t(w)).sum().backward()
    pairs = [(tp[k].grad, jg[0][k]) for k in sorted(p)] + [
        (tx.grad, jg[1]), (tenc.grad, jg[2])]
    for g, j in pairs:
        j = np.asarray(j)
        np.testing.assert_allclose(g.numpy(), j, rtol=1e-4,
                                   atol=1e-5 * float(np.abs(j).max()))


@pytest.mark.parametrize("seq,d", [(24, 64), (448, 768), (1500, 768)])
def test_sinusoid_matches_reference(seq, d):
    got = encdec._sinusoid(seq, d, torch.zeros((), dtype=torch.float32))
    assert tuple(got.shape) == (seq, d) and got.dtype == torch.float32
    np.testing.assert_allclose(got.numpy(), np.asarray(JE._sinusoid(seq, d)),
                               rtol=0, atol=4 * 2.0 ** -24 * seq)
    # cast to the activations' dtype, as the reference's .astype
    assert encdec._sinusoid(seq, d, torch.zeros(
        (), dtype=torch.bfloat16)).dtype == torch.bfloat16


def test_encode_matches_reference(model):
    cfg, jcfg, params, jp = model
    frames = _batch(cfg)["frames"]
    want = np.asarray(jax.jit(lambda p, f: JE.encode(
        jcfg, p, f, q_chunk=Q_CHUNK))(jp, frames))
    with torch.no_grad():
        got = encdec.encode(cfg, params, _t(frames), q_chunk=Q_CHUNK)
    assert tuple(got.shape) == (B, cfg.encoder.seq_len, cfg.d_model)
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-5,
                               atol=1e-5 * float(np.abs(want).max()))


@pytest.mark.parametrize("remat", ["full", "none"])
def test_encdec_loss_and_grads_match_reference(model, remat):
    """From encode to the loss: float32 loss and every gradient leaf
    (enc_in, both stacks, the cross projections, embed and head)."""
    cfg, jcfg, params, jp = model
    batch = _batch(cfg, seed=1)
    (jl, jm), jg = jax.jit(jax.value_and_grad(lambda p, b: JA.loss_fn(
        jcfg, p, b, q_chunk=Q_CHUNK), has_aux=True))(jp, batch)
    (loss, m), grads = value_and_grad(lambda p, b: api.loss_fn(
        cfg, p, b, q_chunk=Q_CHUNK, remat=remat), params, _tbatch(batch))
    assert float(loss) == pytest.approx(float(jl), rel=1e-5)
    assert float(m["ce"]) == float(loss) and float(m["moe_aux"]) == 0.0
    got, want = tree_leaves(grads), jax.tree.leaves(jg)
    assert len(got) == len(want) == len(tree_leaves(params))
    for g, w in zip(got, want):
        w = np.asarray(w)
        assert float(np.abs(w).max()) > 0.0
        np.testing.assert_allclose(g.numpy(), w, rtol=1e-4,
                                   atol=1e-5 * float(np.abs(w).max()))


def _decode_pair(cfg, jcfg, params, jp, state, jstate, toks):
    """Decode ``toks`` step by step through both packages; the logits of
    every step within 1e-5 x the largest, the step's inputs untouched."""
    jstep = jax.jit(lambda p, s, t: JA.decode_step(jcfg, p, s, t))
    for i in range(toks.shape[1]):
        tok = toks[:, i:i + 1]
        before = [t.clone() for t in tree_leaves(state)]
        with torch.no_grad():
            logits, new = api.decode_step(cfg, params, state, _t(tok))
        assert all(torch.equal(a, b)
                   for a, b in zip(before, tree_leaves(state)))
        jlogits, jstate = jstep(jp, jstate, jnp.asarray(tok))
        jl = np.asarray(jlogits)
        assert logits.dtype == torch.float32
        np.testing.assert_allclose(logits.numpy(), jl, rtol=0,
                                   atol=1e-5 * float(np.abs(jl).max()))
        state = new
    return state, jstate


@pytest.mark.parametrize("start", ["zeros", "encoded"])
def test_decode_matches_reference(model, start):
    """Four decode steps from a zero state (the reference's serve:
    zero cross K/V) and from ``prefill_cross(encode(frames))``; the
    cross K/V are carried over, the self cache filled at 0..3."""
    cfg, jcfg, params, jp = model
    ctx = 8
    state = zeros_from_spec(api.decode_state_spec(cfg, B, ctx))
    jstate = jax.tree.map(lambda s: jnp.zeros(s.shape, s.dtype),
                          JA.decode_state_spec(jcfg, B, ctx))
    assert [tuple(a.shape) for a in tree_leaves(state)] == \
        [tuple(a.shape) for a in jax.tree.leaves(jstate)]
    if start == "encoded":
        frames = _batch(cfg, seed=2)["frames"]
        with torch.no_grad():
            cross = encdec.prefill_cross(cfg, params, encdec.encode(
                cfg, params, _t(frames), q_chunk=Q_CHUNK))
        jcross = jax.jit(lambda p, f: JE.prefill_cross(jcfg, p, JE.encode(
            jcfg, p, f, q_chunk=Q_CHUNK)))(jp, frames)
        for k in ("k", "v"):
            assert tuple(cross[k].shape) == (
                cfg.num_layers, B, cfg.encoder.seq_len,
                cfg.attention.num_kv_heads, cfg.attention.head_dim)
            np.testing.assert_allclose(cross[k].numpy(),
                                       np.asarray(jcross[k]), rtol=1e-5,
                                       atol=1e-6)
        state = dict(state, cross=cross)
        jstate = dict(jstate, cross=jcross)
    toks = np.random.default_rng(3).integers(
        0, cfg.vocab_size, (B, 4)).astype(np.int32)
    state, jstate = _decode_pair(cfg, jcfg, params, jp, state, jstate, toks)
    assert int(state["pos"]) == int(jstate["pos"]) == 4
    np.testing.assert_allclose(state["self"]["k"].numpy(),
                               np.asarray(jstate["self"]["k"]), rtol=1e-5,
                               atol=1e-6)
    assert float(state["self"]["k"][:, :, 4:].abs().max()) == 0.0


def test_decode_follows_prefill_at_the_first_token_only(model):
    """Decode from the encoded frames' cross K/V gives the decoder
    forward's position-0 logits at its first token; after it, decode
    adds position 0's sinusoid again (the reference's quirk), so the
    forward's later positions are not decode's."""
    cfg, _, params, _ = model
    frames = _t(_batch(cfg, seed=4)["frames"])
    toks = _t(np.random.default_rng(5).integers(
        0, cfg.vocab_size, (B, 3)).astype(np.int32))
    with torch.no_grad():
        enc = encdec.encode(cfg, params, frames, q_chunk=Q_CHUNK)
        pre = encdec.prefill_logits(cfg, params, toks, enc, q_chunk=Q_CHUNK)
        state = dict(zeros_from_spec(api.decode_state_spec(cfg, B, 8)),
                     cross=encdec.prefill_cross(cfg, params, enc))
        errs = []
        for i in range(3):
            logits, state = api.decode_step(cfg, params, state,
                                            toks[:, i:i + 1])
            errs.append(float((logits - pre[:, i]).abs().max()))
    scale = float(pre.abs().max())
    assert errs[0] <= 1e-5 * scale
    assert min(errs[1:]) > 1e-2 * scale


def test_train_step_matches_reference():
    """One make_train_step step (float32, AdamW, SGDR) from one bridged
    state and one batch, against the reference's."""
    cfg, jcfg = _cfgs()
    p_np = bridge.params_to_numpy(api.init_params(
        cfg, torch.Generator().manual_seed(6)))
    batch = _batch(cfg, seed=7)
    jp = _jtree(p_np)
    jgrad = jax.jit(jax.grad(lambda p, b: JA.loss_fn(
        jcfg, p, b, q_chunk=Q_CHUNK)[0]))(jp, batch)
    loose = _small(jgrad)
    # the embedding rows of tokens absent from the batch: gradient 0
    moving = [np.asarray(g) != 0 for g in jax.tree.leaves(jgrad)]
    jp2, jo2, jm = jax.jit(j_make_train_step(jcfg, JTrain(**TCFG),
                                             q_chunk=Q_CHUNK))(
        jp, j_adamw_init(jp), batch)
    params = bridge.lm_params_from_numpy(cfg, p_np, device="cpu")
    step = make_train_step(cfg, TrainConfig(**TCFG), q_chunk=Q_CHUNK)
    p2, o2, m = step(params, adamw_init(params), _tbatch(batch))
    assert float(m["loss"]) == pytest.approx(float(jm["loss"]), rel=1e-5)
    reach = 2 * TCFG["lr"]
    _close_trees(p2, _np(jp2), loose, reach)
    _close_trees(o2["m"], _np(jo2["m"]), loose, reach)
    # of the elements with a gradient, the split leaves at most 0.5 %
    # to their reach
    assert sum(int((a & m).sum()) for a, m in zip(loose, moving)) \
        < 5e-3 * sum(int(m.sum()) for m in moving)


def test_grad_accum_splits_frames():
    """grad_accum=2 splits frames along the batch as it splits tokens:
    the accumulated gradients equal the whole batch's mean."""
    cfg, _ = _cfgs()
    params = api.init_params(cfg, torch.Generator().manual_seed(8))
    batch = _tbatch(_batch(cfg, seed=9, b=4))
    loss_fn = (lambda p, b: api.loss_fn(cfg, p, b, q_chunk=Q_CHUNK))
    (whole, _), gw = value_and_grad(loss_fn, params, batch)
    halves = [value_and_grad(loss_fn, params,
                             {k: v[i * 2:(i + 1) * 2]
                              for k, v in batch.items()})
              for i in range(2)]
    ga, (la, _) = _accum_grads(loss_fn, params, batch, 2)
    assert float(la) == pytest.approx(
        (float(halves[0][0][0]) + float(halves[1][0][0])) / 2, rel=1e-6)
    assert float(la) == pytest.approx(float(whole), rel=1e-5)
    for a, w in zip(tree_leaves(ga), tree_leaves(gw)):
        np.testing.assert_allclose(a.numpy(), w.numpy(), rtol=1e-4,
                                   atol=1e-5 * float(w.abs().max()))


def test_bridge_carries_the_encdec_tree():
    """lm_params_from_numpy / lm_opt_from_numpy take the reference's
    whisper tree (enc_in, enc_blocks, enc_norm, dec_blocks with their
    cross projections, the empty prefix_blocks); a bfloat16 config's
    AdamW state carries the float32 master."""
    cfg, jcfg = _cfgs("bfloat16")
    p_np = bridge.params_to_numpy(api.init_params(
        cfg, torch.Generator().manual_seed(10)))
    assert p_np["prefix_blocks"] == []
    params = bridge.lm_params_from_numpy(cfg, p_np, device="cpu")
    assert params["enc_blocks"]["self"]["wq"].shape == (
        cfg.encoder.num_layers, cfg.d_model, cfg.attention.q_dim)
    assert params["dec_blocks"]["cross"]["wk"].dtype == torch.bfloat16
    assert params["enc_in"].shape == (cfg.encoder.feature_dim, cfg.d_model)
    jo = j_adamw_init(jax.tree.map(lambda a: jnp.asarray(a, jnp.bfloat16),
                                   p_np))
    o = bridge.lm_opt_from_numpy(cfg, jax.tree.map(
        lambda a: np.asarray(a, np.float32), jo), device="cpu")
    assert set(o) == {"m", "v", "count", "master"}
    for a, b in zip(tree_leaves(o), tree_leaves(adamw_init(params))):
        assert torch.equal(a, b)
    bad = dict(p_np, enc_in=np.zeros((3, 3), np.float32))
    with pytest.raises(ValueError, match="enc_in"):
        bridge.lm_params_from_numpy(cfg, bad, device="cpu")
