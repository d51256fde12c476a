"""Port parity of the LM layers (``repro_torch.models.layers``) against
the reference's (``repro.models.layers``) on the CPU, in float32: the
norms, the gated MLP (plain and fused), RoPE, query-chunked attention
over causal / window / chunk cases (as ``tests/test_attention.py``), the
two-level flash attention's forward and gradients (as
``tests/test_flash.py``) and decode against prefill.

Tolerances: a forward to rtol 1e-5 / atol 1e-5 (float32 over reductions
of at most a few hundred terms); a gradient to rtol 1e-4 / atol 1e-5 x
the largest element of its tensor.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.config import AttentionConfig as JAttentionConfig
from repro.models.layers import attention as JA
from repro.models.layers import common as JC
from repro.models.layers import rope as JR
from repro_torch.config import AttentionConfig
from repro_torch.models.layers import attention as A
from repro_torch.models.layers import common as C
from repro_torch.models.layers import rope as R

# one thread: a reduction's order then does not depend on the load
torch.set_num_threads(1)

FWD = dict(rtol=1e-5, atol=1e-5)


def _t(a):
    return torch.as_tensor(np.asarray(a))


def _grad_close(got, want):
    want = np.asarray(want)
    np.testing.assert_allclose(got.detach().numpy(), want, rtol=1e-4,
                               atol=1e-5 * float(np.abs(want).max()))


def _qkv(rng, b, s, t, h, kv, d):
    return (rng.normal(0, 1, (b, s, h, d)).astype(np.float32),
            rng.normal(0, 1, (b, t, kv, d)).astype(np.float32),
            rng.normal(0, 1, (b, t, kv, d)).astype(np.float32))


@pytest.mark.parametrize("kind", ["rmsnorm", "layernorm"])
def test_norm_matches_reference(kind):
    rng = np.random.default_rng(0)
    x = rng.normal(0, 2, (2, 5, 16)).astype(np.float32)
    p = {"g": rng.normal(1, 0.1, 16).astype(np.float32),
         "b": rng.normal(0, 0.1, 16).astype(np.float32)}
    if kind == "rmsnorm":
        p = {"g": p["g"]}
    want = JC.apply_norm({k: jnp.asarray(v) for k, v in p.items()},
                         jnp.asarray(x), kind)
    got = C.apply_norm({k: _t(v) for k, v in p.items()}, _t(x), kind)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **FWD)
    # bfloat16 in, bfloat16 out, float32 inside
    xb = _t(x).to(torch.bfloat16)
    assert C.apply_norm({k: _t(v) for k, v in p.items()}, xb,
                        kind).dtype == torch.bfloat16


@pytest.mark.parametrize("act", ["silu", "gelu", "relu"])
@pytest.mark.parametrize("fused", [False, True])
def test_mlp_matches_reference(act, fused):
    rng = np.random.default_rng(1)
    x = rng.normal(0, 1, (2, 7, 12)).astype(np.float32)
    p = {k: rng.normal(0, 0.3, s).astype(np.float32) for k, s in (
        ("w_gate", (12, 24)), ("w_up", (12, 24)), ("w_down", (24, 12)))}
    want = JC.apply_mlp({k: jnp.asarray(v) for k, v in p.items()},
                        jnp.asarray(x), act, fused=fused)
    got = C.apply_mlp({k: _t(v) for k, v in p.items()}, _t(x), act,
                      fused=fused)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **FWD)


@pytest.mark.parametrize("theta", [1e4, 5e5])
def test_rope_matches_reference(theta):
    rng = np.random.default_rng(2)
    x = rng.normal(0, 1, (2, 9, 3, 16)).astype(np.float32)
    pos = np.arange(9, dtype=np.int32)[None].repeat(2, 0) + 5
    np.testing.assert_allclose(R.rope_freqs(16, theta).numpy(),
                               np.asarray(JR.rope_freqs(16, theta)),
                               rtol=1e-6)
    want = jax.jit(JR.apply_rope, static_argnums=2)(
        jnp.asarray(x), jnp.asarray(pos), theta)
    got = R.apply_rope(_t(x), _t(pos), theta)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **FWD)
    cfg, jcfg = AttentionConfig(), JAttentionConfig()
    np.testing.assert_array_equal(
        R.positions_for(cfg, 3, 7, offset=2).numpy(),
        np.asarray(JR.positions_for(jcfg, 3, 7, offset=2)))
    # M-RoPE's text-only ids, t = h = w: (batch, seq, 3)
    mcfg, jmcfg = (AttentionConfig(rope_kind="mrope"),
                   JAttentionConfig(rope_kind="mrope"))
    got = R.positions_for(mcfg, 3, 7, offset=2)
    assert tuple(got.shape) == (3, 7, 3) and got.dtype == torch.int32
    np.testing.assert_array_equal(
        got.numpy(), np.asarray(JR.positions_for(jmcfg, 3, 7, offset=2)))


# the cases of tests/test_attention.py, then cross attention
CHUNKED = [(128, 128, 0, 32, True), (128, 128, 24, 32, True),
           (96, 96, 0, 96, True), (128, 128, 48, 64, True),
           (60, 60, 0, 32, True), (64, 80, 0, 32, False)]


@pytest.mark.parametrize("s,t,window,q_chunk,causal", CHUNKED)
def test_chunked_attention_matches_reference(s, t, window, q_chunk, causal):
    rng = np.random.default_rng(3)
    q, k, v = _qkv(rng, 2, s, t, 4, 2, 16)
    w = rng.normal(0, 1, (2, s, 4, 16)).astype(np.float32)

    def jf(q, k, v):
        o = JA.chunked_attention(q, k, v, causal=causal, window=window,
                                 q_chunk=q_chunk)
        return jnp.sum(o * w), o

    (_, want), jg = jax.jit(jax.value_and_grad(jf, argnums=(0, 1, 2),
                                               has_aux=True))(
        jnp.asarray(q), jnp.asarray(k), jnp.asarray(v))
    tq, tk, tv = (_t(a).requires_grad_(True) for a in (q, k, v))
    got = A.chunked_attention(tq, tk, tv, causal=causal, window=window,
                              q_chunk=q_chunk)
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(want),
                               **FWD)
    (got * _t(w)).sum().backward()
    for g, j in zip((tq.grad, tk.grad, tv.grad), jg):
        _grad_close(g, j)


@pytest.mark.parametrize("causal,window", [(True, 0), (True, 24),
                                           (False, 0)])
def test_flash_matches_reference(causal, window):
    rng = np.random.default_rng(4)
    q, k, v = _qkv(rng, 2, 128, 128, 4, 4, 16)
    w = rng.normal(0, 1, q.shape).astype(np.float32)
    kw = dict(causal=causal, window=window, q_chunk=32, kv_chunk=32)

    def jf(q, k, v):
        o = JA.flash_attention(q, k, v, **kw)
        return jnp.sum(o * w), o

    (_, want), jg = jax.jit(jax.value_and_grad(jf, argnums=(0, 1, 2),
                                               has_aux=True))(
        jnp.asarray(q), jnp.asarray(k), jnp.asarray(v))
    tq, tk, tv = (_t(a).requires_grad_(True) for a in (q, k, v))
    got = A.flash_attention(tq, tk, tv, **kw)
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(want),
                               **FWD)
    (got * _t(w)).sum().backward()
    for g, j in zip((tq.grad, tk.grad, tv.grad), jg):
        _grad_close(g, j)
    # and against the port's own chunked path (tests/test_flash.py)
    ref = A.chunked_attention(_t(q), _t(k), _t(v), causal=causal,
                              window=window, q_chunk=64)
    np.testing.assert_allclose(got.detach().numpy(), ref.numpy(),
                               rtol=2e-4, atol=2e-4)


def test_flash_chunk_invariance_and_gradients_finite():
    rng = np.random.default_rng(5)
    q, k, v = (_t(a) for a in _qkv(rng, 1, 96, 96, 2, 2, 8))
    a = A.flash_attention(q, k, v, causal=True, q_chunk=96, kv_chunk=96)
    b = A.flash_attention(q, k, v, causal=True, q_chunk=16, kv_chunk=24)
    np.testing.assert_allclose(a.numpy(), b.numpy(), rtol=2e-4, atol=2e-4)
    q.requires_grad_(True)
    A.flash_attention(q, k, v, causal=True, q_chunk=16,
                      kv_chunk=16).square().sum().backward()
    assert torch.isfinite(q.grad).all()


def _attn_params(d_model, cfg):
    rng = np.random.default_rng(6)
    return {k: rng.normal(0, d_model ** -0.5, s).astype(np.float32)
            for k, s in (("wq", (d_model, cfg.q_dim)),
                         ("wk", (d_model, cfg.kv_dim)),
                         ("wv", (d_model, cfg.kv_dim)),
                         ("wo", (cfg.q_dim, d_model)))}


@pytest.mark.parametrize("impl", ["chunked", "flash"])
@pytest.mark.parametrize("fused_qkv", [False, True])
def test_apply_attention_matches_reference(impl, fused_qkv):
    kw = dict(kind="gqa", num_heads=4, num_kv_heads=2, head_dim=16,
              rope_theta=1e4)
    cfg, jcfg = AttentionConfig(**kw), JAttentionConfig(**kw)
    p = _attn_params(32, cfg)
    x = np.random.default_rng(7).normal(0, 1, (2, 32, 32)).astype(
        np.float32)
    want = jax.jit(lambda p, x: JA.apply_attention(
        p, jcfg, x, causal=True, window=8, q_chunk=16, impl=impl,
        fused_qkv=fused_qkv))({k: jnp.asarray(v) for k, v in p.items()},
                              jnp.asarray(x))
    got = A.apply_attention({k: _t(v) for k, v in p.items()}, cfg, _t(x),
                            causal=True, window=8, q_chunk=16, impl=impl,
                            fused_qkv=fused_qkv)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **FWD)


@pytest.mark.parametrize("window", [0, 8])
def test_decode_matches_prefill(window):
    """Decoding tokens one by one (a ring buffer for local layers) equals
    the full prefill attention at every position, and the reference's
    decode step by step."""
    kw = dict(kind="gqa", num_heads=4, num_kv_heads=2, head_dim=16,
              rope_theta=1e4)
    cfg, jcfg = AttentionConfig(**kw), JAttentionConfig(**kw)
    p = _attn_params(32, cfg)
    tp = {k: _t(v) for k, v in p.items()}
    jp = {k: jnp.asarray(v) for k, v in p.items()}
    s = 24
    x = np.random.default_rng(8).normal(0, 1, (2, s, 32)).astype(np.float32)
    full = A.apply_attention(tp, cfg, _t(x), causal=True, window=window,
                             q_chunk=64)
    t = window if window > 0 else s
    cache = {"k": torch.zeros(2, t, 2, 16), "v": torch.zeros(2, t, 2, 16)}
    jcache = {"k": jnp.zeros((2, t, 2, 16)), "v": jnp.zeros((2, t, 2, 16))}
    jdecode = jax.jit(lambda p, x, c, pos: JA.decode_attention(
        p, jcfg, x, c, pos, window=window))
    outs = []
    for pos in range(s):
        before = {k: v.clone() for k, v in cache.items()}
        o, new = A.decode_attention(tp, cfg, _t(x[:, pos:pos + 1]), cache,
                                    torch.tensor(pos, dtype=torch.int32),
                                    window=window)
        assert all(torch.equal(before[k], cache[k]) for k in cache)
        cache = new
        jo, jcache = jdecode(jp, jnp.asarray(x[:, pos:pos + 1]), jcache,
                             jnp.int32(pos))
        np.testing.assert_allclose(o.numpy(), np.asarray(jo), **FWD)
        outs.append(o)
    np.testing.assert_allclose(torch.cat(outs, 1).numpy(), full.numpy(),
                               rtol=2e-3, atol=2e-3)
    np.testing.assert_allclose(cache["k"].numpy(), np.asarray(jcache["k"]),
                               **FWD)


def test_repeat_kv():
    k = torch.arange(2 * 3 * 2 * 4, dtype=torch.float32).reshape(2, 3, 2, 4)
    r = A.repeat_kv(k, 3)
    assert r.shape == (2, 3, 6, 4)
    np.testing.assert_array_equal(
        r.numpy(), np.asarray(JA.repeat_kv(jnp.asarray(k.numpy()), 3)))
    assert A.repeat_kv(k, 1) is k


def test_init_from_spec_follows_the_reference_rules():
    """Truncated normal (+-2 sigma) at 1/sqrt(fan_in) for every leaf of
    two or more dims (a stacked norm scale included), ones for a 1-D
    ``g``, zeros for a 1-D ``b``; the same generator seed gives the same
    tree."""
    spec = {"w": C.TensorSpec((64, 32), torch.float32),
            "n": {"g": C.TensorSpec((8,), torch.bfloat16),
                  "b": C.TensorSpec((8,), torch.float32)},
            "stack": [{"g": C.TensorSpec((3, 8), torch.float32)}]}
    a = C.init_from_spec(spec, torch.Generator().manual_seed(1))
    b = C.init_from_spec(spec, torch.Generator().manual_seed(1))
    assert torch.equal(a["w"], b["w"]) and a["n"]["g"].dtype == \
        torch.bfloat16
    assert a["w"].abs().max() <= 2 / 8 and a["w"].std() > 0.08
    assert torch.equal(a["n"]["g"], torch.ones(8, dtype=torch.bfloat16))
    assert torch.equal(a["n"]["b"], torch.zeros(8))
    assert a["stack"][0]["g"].abs().max() <= 2 / 3 ** 0.5 and \
        a["stack"][0]["g"].std() > 0
