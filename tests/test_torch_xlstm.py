"""Port parity of the xLSTM mixers (``repro_torch.models.layers.xlstm``:
mLSTM and sLSTM) against the reference's (``repro.models.layers.xlstm``)
on the CPU: the chunkwise mLSTM against its step-by-step form and
against the reference's, its chunk invariance, both layers' forward and
gradients in float32 and bfloat16 (finite gradients at S = chunk and 2
x chunk, where the stabilizer starts at -inf), the decode steps from a
state whose stabilizer starts at -inf or at 0 (the reference's
``launch.serve``), and decode against prefill.

Both packages start from one set of params (drawn by the port, handed
to the reference as numpy) and one input.  Tolerances, stated before
the first reading:

* float32: a layer's output to rtol 1e-5 / atol 1e-5; each gradient
  leaf to rtol 1e-4 / atol 1e-5 x its largest element;
* bfloat16: the output to atol 3e-2 x its largest element, each
  gradient leaf to atol 0.1 x its largest (as ``test_torch_mamba.py``);
* the reference's own tests/test_mixers.py bounds for the port against
  itself: chunkwise against recurrent 2e-4, chunk invariance 3e-4,
  mLSTM decode against prefill 3e-3, sLSTM decode against the scan
  2e-4.
"""
import math

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.config import SSMConfig as JSSMConfig
from repro.models.layers import xlstm as JX
from repro_torch.config import SSMConfig
from repro_torch.models.layers import xlstm as X
from repro_torch.models.layers.common import init_from_spec
from repro_torch.tree import tree_map

torch.set_num_threads(1)

FWD = dict(rtol=1e-5, atol=1e-5)
D_MODEL = 16
JD = {"float32": jnp.float32, "bfloat16": jnp.bfloat16}
TD = {"float32": torch.float32, "bfloat16": torch.bfloat16}
KINDS = {"mlstm": (X.mlstm_spec, JX.mlstm_spec, X.apply_mlstm,
                   JX.apply_mlstm, X.mlstm_state_spec, JX.mlstm_state_spec,
                   X.decode_mlstm, JX.decode_mlstm),
         "slstm": (X.slstm_spec, JX.slstm_spec, X.apply_slstm,
                   JX.apply_slstm, X.slstm_state_spec, JX.slstm_state_spec,
                   X.decode_slstm, JX.decode_slstm)}


def _setup(kind, dtype="float32", seed=0, s=12):
    """(cfg, jcfg, port params, reference params, x (2, s, D_MODEL)),
    the zero-initialized biases and skip drawn so that they count."""
    cfg, jcfg = SSMConfig(num_heads=2), JSSMConfig(num_heads=2)
    spec, jspec_fn = KINDS[kind][0], KINDS[kind][1]
    p = init_from_spec(spec(cfg, D_MODEL, TD[dtype]),
                       torch.Generator().manual_seed(seed))
    rng = np.random.default_rng(seed + 11)
    for k in ("if_bias", "bias", "skip", "conv_b"):
        if k in p:
            p[k] = torch.as_tensor(rng.normal(0, 0.5, tuple(p[k].shape)),
                                   dtype=torch.float32).to(p[k].dtype)
    jspec = jspec_fn(jcfg, D_MODEL, JD[dtype])
    jp = {k: jnp.asarray(np.asarray(v.float()), jspec[k].dtype)
          for k, v in p.items()}
    x = np.random.default_rng(seed + 4).normal(0, 1, (2, s, D_MODEL))
    return cfg, jcfg, p, jp, x.astype(np.float32)


def _qkv(seed, b=2, s=64, h=2, dh=8, lf_mean=2.0):
    rng = np.random.default_rng(seed)
    q = rng.normal(0, 1, (b, s, h, dh))
    k = rng.normal(0, 1, (b, s, h, dh)) / np.sqrt(dh)
    v = rng.normal(0, 1, (b, s, h, dh))
    li = rng.normal(0, 1, (b, s, h))
    lf = np.log(1 / (1 + np.exp(-rng.normal(lf_mean, 1, (b, s, h)))))
    return [a.astype(np.float32) for a in (q, k, v, li, lf)]


def test_spec_dtypes_and_init_match_reference():
    """Every leaf's shape and dtype as the reference's (the float32
    gates of a bfloat16 layer: w_if, if_bias, the sLSTM bias); the init
    gives norm_g ones and skip zeros, as the reference's."""
    cfg, jcfg = SSMConfig(), JSSMConfig()
    for kind, (spec, jspec, *_) in KINDS.items():
        a, b = spec(cfg, 64, torch.bfloat16), jspec(jcfg, 64, jnp.bfloat16)
        assert list(a) == list(b), kind
        for k in a:
            assert tuple(a[k].shape) == tuple(b[k].shape), k
            assert str(a[k].dtype).split(".")[-1] == str(b[k].dtype), k
        p = init_from_spec(a, torch.Generator().manual_seed(0))
        assert float(p["norm_g"].float().min()) == 1.0, kind
    p = init_from_spec(X.mlstm_spec(cfg, 64, torch.bfloat16),
                       torch.Generator().manual_seed(0))
    assert p["w_if"].dtype == p["if_bias"].dtype == torch.float32
    assert float(p["skip"].float().abs().max()) == 0.0


def test_mlstm_chunkwise_matches_recurrent_and_reference():
    q, k, v, li, lf = _qkv(0)
    t = [torch.as_tensor(a) for a in (q, k, v, li, lf)]
    out = X.mlstm_chunkwise(*t, chunk=16)
    want = JX.mlstm_chunkwise(*[jnp.asarray(a) for a in (q, k, v, li, lf)],
                              chunk=16)
    np.testing.assert_allclose(out.numpy(), np.asarray(want), **FWD)
    b, s, h, dh = q.shape
    c, n = torch.zeros((b, h, dh, dh)), torch.zeros((b, h, dh))
    m = torch.full((b, h), -math.inf)
    outs = []
    for i in range(s):
        c, n, m, ht = X.mlstm_recurrent_step(c, n, m, *(a[:, i] for a in t))
        outs.append(ht)
    np.testing.assert_allclose(out.numpy(), torch.stack(outs, 1).numpy(),
                               rtol=2e-4, atol=2e-4)


@pytest.mark.parametrize("chunk", [8, 16, 64])
def test_mlstm_chunk_invariance(chunk):
    q, k, v, li, _ = _qkv(1, b=1, h=2, dh=4)
    lf = -np.abs(np.random.default_rng(1).normal(0.1, 0.2, li.shape))
    t = [torch.as_tensor(a) for a in (q, k, v, li, lf.astype(np.float32))]
    ref = X.mlstm_chunkwise(*t, chunk=64)
    np.testing.assert_allclose(X.mlstm_chunkwise(*t, chunk=chunk).numpy(),
                               ref.numpy(), rtol=3e-4, atol=3e-4)


def _layer_grads(kind, dtype, s=12):
    cfg, jcfg, p, jp, x = _setup(kind, dtype, s=s)
    apply, japply = KINDS[kind][2], KINDS[kind][3]
    kw = {"chunk": 8} if kind == "mlstm" else {}
    w = np.random.default_rng(7).normal(0, 1, x.shape).astype(np.float32)

    def jf(p, x):
        o = japply(p, jcfg, x, **kw)
        return jnp.sum(o.astype(jnp.float32) * w), o

    (_, jo), jg = jax.value_and_grad(jf, argnums=(0, 1), has_aux=True)(
        jp, jnp.asarray(x, JD[dtype]))
    tp = tree_map(lambda a: a.clone().requires_grad_(True), p)
    tx = torch.as_tensor(x).to(TD[dtype]).requires_grad_(True)
    o = apply(tp, cfg, tx, **kw)
    (o.float() * torch.as_tensor(w)).sum().backward()
    got = {k: tp[k].grad for k in tp}
    got["x"] = tx.grad
    want = dict(jg[0], x=jg[1])
    return o, jo, got, want


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("kind", ["mlstm", "slstm"])
def test_layer_matches_reference(kind, dtype):
    """Forward, the output's dtype, and every parameter's and the
    input's gradient (its dtype too) of a weighted sum of the output;
    the mLSTM at chunk 8 over 12 tokens is refused (12 % 8), so 16."""
    o, jo, got, want = _layer_grads(kind, dtype, s=16)
    assert o.dtype == TD[dtype] and str(jo.dtype) == dtype
    jo = np.asarray(jo, np.float32)
    if dtype == "float32":
        np.testing.assert_allclose(o.detach().numpy(), jo, **FWD)
    else:
        assert float(np.abs(o.detach().float().numpy() - jo).max()) \
            <= 3e-2 * float(np.abs(jo).max())
    assert set(got) == set(want)
    for k in sorted(got):
        g, wg = got[k], want[k]
        assert str(g.dtype).split(".")[-1] == str(wg.dtype), k
        wg = np.asarray(wg, np.float32)
        scale = float(np.abs(wg).max())
        assert scale > 0, k
        if dtype == "float32":
            np.testing.assert_allclose(g.numpy(), wg, rtol=1e-4,
                                       atol=1e-5 * scale, err_msg=k)
        else:
            assert float(np.abs(g.float().numpy() - wg).max()) \
                <= 0.1 * scale, k


@pytest.mark.parametrize("s", [8, 16])
@pytest.mark.parametrize("kind", ["mlstm", "slstm"])
def test_gradients_are_finite_from_the_minus_inf_start(kind, s):
    """At S = chunk (one chunk, the stabilizer's -inf start in every
    max) and S = 2 x chunk (the state carried once), every gradient is
    finite and the input's is not zero."""
    _, _, got, _ = _layer_grads(kind, "float32", s=s)
    for k, g in got.items():
        assert bool(torch.isfinite(g).all()), k
    assert float(got["x"].abs().max()) > 0.0


def _state(kind, cfg, jcfg, start, dtype="float32"):
    spec = KINDS[kind][4](cfg, D_MODEL, 2, TD[dtype])
    jspec = KINDS[kind][5](jcfg, D_MODEL, 2, JD[dtype])
    assert {k: (tuple(s.shape), str(s.dtype).split(".")[-1])
            for k, s in spec.items()} == {
        k: (tuple(s.shape), str(s.dtype)) for k, s in jspec.items()}
    st = {k: torch.zeros(s.shape, dtype=s.dtype) for k, s in spec.items()}
    jst = {k: jnp.zeros(s.shape, s.dtype) for k, s in jspec.items()}
    if start == "-inf":
        st["m"] = torch.full(st["m"].shape, -math.inf)
        jst["m"] = jnp.full(jst["m"].shape, -jnp.inf)
    return st, jst


@pytest.mark.parametrize("start", ["-inf", "zeros"])
@pytest.mark.parametrize("kind", ["mlstm", "slstm"])
def test_decode_matches_reference(kind, start):
    """Twelve decode steps of batch 2, each output and the final state
    against the reference's, from a stabilizer started at -inf (as the
    reference's tests) and at 0 (as the reference's launch.serve)."""
    cfg, jcfg, p, jp, x = _setup(kind)
    st, jst = _state(kind, cfg, jcfg, start)
    dec, jdec = KINDS[kind][6], KINDS[kind][7]
    jstep = jax.jit(lambda p, x, s: jdec(p, jcfg, x, s))
    for t in range(12):
        with torch.no_grad():
            o, st = dec(p, cfg, torch.as_tensor(x[:, t:t + 1]), st)
        jo, jst = jstep(jp, jnp.asarray(x[:, t:t + 1]), jst)
        jo = np.asarray(jo)
        np.testing.assert_allclose(o.numpy(), jo, rtol=0, atol=1e-5 * max(
            1.0, float(np.abs(jo).max())))
    assert set(st) == set(jst)
    for k in st:
        w = np.asarray(jst[k], np.float32)
        np.testing.assert_allclose(st[k].float().numpy(), w, rtol=1e-5,
                                   atol=1e-5 * max(1.0, np.abs(w).max()),
                                   err_msg=k)


@pytest.mark.parametrize("kind", ["mlstm", "slstm"])
def test_decode_from_minus_inf_matches_prefill(kind):
    """With the stabilizer started at -inf the decode steps equal the
    prefill forward (mLSTM 3e-3, sLSTM 2e-4: the reference's own
    bounds)."""
    cfg, jcfg, p, _, x = _setup(kind)
    apply, dec = KINDS[kind][2], KINDS[kind][6]
    tx = torch.as_tensor(x)
    st, _ = _state(kind, cfg, jcfg, "-inf")
    with torch.no_grad():
        full = apply(p, cfg, tx, **({"chunk": 4} if kind == "mlstm" else {}))
        outs = []
        for t in range(12):
            o, st = dec(p, cfg, tx[:, t:t + 1], st)
            outs.append(o)
    tol = 3e-3 if kind == "mlstm" else 2e-4
    np.testing.assert_allclose(torch.cat(outs, 1).numpy(), full.numpy(),
                               rtol=tol, atol=tol)


def test_bf16_decode_keeps_the_dtypes():
    """A bfloat16 decode step returns bfloat16 and keeps the float32
    states (c, n, m; the sLSTM's h) float32, the conv state bfloat16."""
    for kind in KINDS:
        cfg, jcfg, p, _, x = _setup(kind, "bfloat16")
        st, _ = _state(kind, cfg, jcfg, "-inf", "bfloat16")
        with torch.no_grad():
            o, st2 = KINDS[kind][6](p, cfg, torch.as_tensor(
                x[:, :1]).bfloat16(), st)
        assert o.dtype == torch.bfloat16
        assert {k: v.dtype for k, v in st2.items()} == {
            k: v.dtype for k, v in st.items()}
        assert all(bool(torch.isfinite(v.float()).all())
                   for k, v in st2.items())
