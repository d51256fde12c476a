"""Port parity of the Mamba mixer (``repro_torch.models.layers.mamba``)
against the reference's (``repro.models.layers.mamba``) on the CPU: the
port's Hillis-Steele scan against the sequential recurrence and against
the reference's chunked associative scan, the causal conv, the layer's
forward and gradients in float32 and bfloat16, the decode step and
decode against prefill.

Both packages start from one set of params (drawn by the port, handed
to the reference as numpy) and one input.  Tolerances, stated before
the first reading:

* float32: the scan and a layer's output to rtol 1e-5 / atol 1e-5; each
  gradient leaf to rtol 1e-4 / atol 1e-5 x its largest element;
* bfloat16: the output to atol 3e-2 x its largest element (about 8
  bf16 ulps there), each gradient leaf to atol 0.1 x its largest (the
  LM tests' bfloat16 bound); the output's dtype and the float32 leaves'
  gradient dtypes as the reference's;
* decode against prefill (float32): the reference's own 2e-3
  (``tests/test_mixers.py``).
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.config import SSMConfig as JSSMConfig
from repro.models.layers import mamba as JM
from repro_torch import bridge
from repro_torch.config import SSMConfig
from repro_torch.models.layers import mamba as M
from repro_torch.models.layers.common import init_from_spec
from repro_torch.tree import tree_leaves, tree_map

torch.set_num_threads(1)

FWD = dict(rtol=1e-5, atol=1e-5)
D_MODEL = 16
JD = {"float32": jnp.float32, "bfloat16": jnp.bfloat16}
TD = {"float32": torch.float32, "bfloat16": torch.bfloat16}


def _setup(dtype="float32", seed=0, d_state=4):
    """(cfg, jcfg, port params, reference params, x (2, 12, D_MODEL)),
    with ``a_log`` drawn so that the decays spread over (0.5, 1.5)."""
    kw = dict(d_state=d_state, d_conv=4, expand=2)
    cfg, jcfg = SSMConfig(**kw), JSSMConfig(**kw)
    p = init_from_spec(M.mamba_spec(cfg, D_MODEL, TD[dtype]),
                       torch.Generator().manual_seed(seed))
    rng = np.random.default_rng(seed + 3)
    p["a_log"] = torch.as_tensor(np.log(rng.uniform(
        0.5, 1.5, tuple(p["a_log"].shape))).astype(np.float32))
    p["dt_bias"] = torch.as_tensor(rng.normal(
        0, 0.5, tuple(p["dt_bias"].shape)).astype(np.float32))
    p["d_skip"] = torch.as_tensor(rng.normal(
        0, 1, tuple(p["d_skip"].shape)).astype(np.float32))
    jspec = JM.mamba_spec(jcfg, D_MODEL, JD[dtype])
    jp = {k: jnp.asarray(np.asarray(v.float()), jspec[k].dtype)
          for k, v in p.items()}
    x = np.random.default_rng(seed + 4).normal(0, 1, (2, 12, D_MODEL))
    return cfg, jcfg, p, jp, x.astype(np.float32)


def test_spec_dtypes_and_init_match_reference():
    """The float32 leaves of a bfloat16 layer (dt_bias, a_log, d_skip)
    keep their dtype through the spec, the init and the bridge; the
    init gives the reference's ones and zeros."""
    cfg, jcfg = SSMConfig(), JSSMConfig()
    spec = M.mamba_spec(cfg, 64, torch.bfloat16)
    jspec = JM.mamba_spec(jcfg, 64, jnp.bfloat16)
    assert list(spec) == list(jspec)
    for k in spec:
        assert tuple(spec[k].shape) == tuple(jspec[k].shape), k
        assert str(spec[k].dtype).split(".")[-1] == str(jspec[k].dtype), k
    p = init_from_spec(spec, torch.Generator().manual_seed(0))
    assert p["dt_bias"].dtype == p["a_log"].dtype == torch.float32
    assert float(p["d_skip"].abs().max()) == 0.0
    assert float(p["conv_b"].abs().max()) == 0.0
    assert float(p["a_log"].abs().max()) > 0.0     # 2-D: drawn
    assert M._dt_rank(cfg, 4096) == 256 == JM._dt_rank(jcfg, 4096)


@pytest.mark.parametrize("chunk", [1, 8, 32])
def test_scan_matches_sequential_recurrence(chunk):
    """The port's scan (log-depth within a chunk, a loop across chunks)
    against h_t = abar_t h_{t-1} + bx_t step by step, and against the
    reference's chunked associative scan."""
    rng = np.random.default_rng(2)
    b, s, di, n = 2, 32, 8, 4
    abar = np.exp(-np.abs(rng.normal(0.2, 0.2, (b, s, di, n)))).astype(
        np.float32)
    bx = rng.normal(0, 1, (b, s, di, n)).astype(np.float32)
    h0 = rng.normal(0, 1, (b, di, n)).astype(np.float32)
    ys, hf = M.ssm_scan_chunked(torch.as_tensor(abar), torch.as_tensor(bx),
                                torch.as_tensor(h0), chunk)
    h, ref = torch.as_tensor(h0), []
    for t in range(s):
        h = torch.as_tensor(abar[:, t]) * h + torch.as_tensor(bx[:, t])
        ref.append(h)
    ref = torch.stack(ref, 1)
    np.testing.assert_allclose(ys.numpy(), ref.numpy(), **FWD)
    np.testing.assert_allclose(hf.numpy(), ref[:, -1].numpy(), **FWD)
    jys, jhf = JM._ssm_scan_chunked(jnp.asarray(abar), jnp.asarray(bx),
                                    jnp.asarray(h0), chunk)
    np.testing.assert_allclose(ys.numpy(), np.asarray(jys), **FWD)
    np.testing.assert_allclose(hf.numpy(), np.asarray(jhf), **FWD)
    with pytest.raises(ValueError, match="chunk"):
        M.ssm_scan_chunked(torch.as_tensor(abar), torch.as_tensor(bx),
                           torch.as_tensor(h0), 5)


def test_causal_conv_matches_reference():
    """The depthwise conv with zeros and with a given state before x."""
    rng = np.random.default_rng(5)
    x = rng.normal(0, 1, (2, 7, 6)).astype(np.float32)
    w = rng.normal(0, 1, (4, 6)).astype(np.float32)
    b = rng.normal(0, 1, (6,)).astype(np.float32)
    st = rng.normal(0, 1, (2, 3, 6)).astype(np.float32)
    t = [torch.as_tensor(a) for a in (x, w, b, st)]
    j = [jnp.asarray(a) for a in (x, w, b, st)]
    np.testing.assert_allclose(M.causal_conv(*t[:3]).numpy(),
                               np.asarray(JM._causal_conv(*j[:3])), **FWD)
    np.testing.assert_allclose(M.causal_conv(*t).numpy(),
                               np.asarray(JM._causal_conv(*j)), **FWD)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_apply_mamba_matches_reference(dtype):
    """The forward and every parameter's and the input's gradient of a
    weighted sum of the output, at chunk 4 (three chunks) and at the
    default chunk (one)."""
    cfg, jcfg, p, jp, x = _setup(dtype)
    w = np.random.default_rng(7).normal(0, 1, x.shape).astype(np.float32)
    for chunk in (4, 256):
        def jf(p, x):
            o = JM.apply_mamba(p, jcfg, x, chunk=chunk)
            return jnp.sum(o.astype(jnp.float32) * w), o

        (_, jo), jg = jax.value_and_grad(jf, argnums=(0, 1), has_aux=True)(
            jp, jnp.asarray(x, JD[dtype]))
        tp = tree_map(lambda a: a.clone().requires_grad_(True), p)
        tx = torch.as_tensor(x).to(TD[dtype]).requires_grad_(True)
        o = M.apply_mamba(tp, cfg, tx, chunk=chunk)
        assert o.dtype == TD[dtype] and str(jo.dtype) == dtype
        (o.float() * torch.as_tensor(w)).sum().backward()
        jo = np.asarray(jo, np.float32)
        got = [tp[k].grad for k in sorted(tp)] + [tx.grad]
        want = [jg[0][k] for k in sorted(tp)] + [jg[1]]
        if dtype == "float32":
            np.testing.assert_allclose(o.detach().numpy(), jo, **FWD)
        else:
            assert float(np.abs(o.detach().float().numpy() - jo).max()) \
                <= 3e-2 * float(np.abs(jo).max())
        for k, g, wg in zip(sorted(tp) + ["x"], got, want):
            assert str(g.dtype).split(".")[-1] == str(wg.dtype), k
            wg = np.asarray(wg, np.float32)
            scale = float(np.abs(wg).max())
            if dtype == "float32":
                np.testing.assert_allclose(g.numpy(), wg, rtol=1e-4,
                                           atol=1e-5 * scale, err_msg=k)
            else:
                assert float(np.abs(g.float().numpy() - wg).max()) \
                    <= 0.1 * scale, k


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_decode_mamba_matches_reference(dtype):
    """Twelve decode steps: each output and the state (h and the last
    K-1 pre-conv inputs) against the reference's."""
    cfg, jcfg, p, jp, x = _setup(dtype)
    spec = M.mamba_state_spec(cfg, D_MODEL, 2, TD[dtype])
    jspec = JM.mamba_state_spec(jcfg, D_MODEL, 2, JD[dtype])
    assert {k: (tuple(s.shape), str(s.dtype).split(".")[-1])
            for k, s in spec.items()} == {
        k: (tuple(s.shape), str(s.dtype)) for k, s in jspec.items()}
    st = {k: torch.zeros(s.shape, dtype=s.dtype) for k, s in spec.items()}
    jst = {k: jnp.zeros(s.shape, s.dtype) for k, s in jspec.items()}
    jstep = jax.jit(lambda p, x, s: JM.decode_mamba(p, jcfg, x, s))
    tol = 1e-5 if dtype == "float32" else 3e-2
    for t in range(12):
        xt = x[:, t:t + 1]
        with torch.no_grad():
            o, st = M.decode_mamba(p, cfg, torch.as_tensor(xt).to(TD[dtype]),
                                   st)
        jo, jst = jstep(jp, jnp.asarray(xt, JD[dtype]), jst)
        jo = np.asarray(jo, np.float32)
        np.testing.assert_allclose(o.float().numpy(), jo, rtol=0,
                                   atol=tol * max(1.0, np.abs(jo).max()))
    np.testing.assert_allclose(st["h"].numpy(), np.asarray(jst["h"]),
                               rtol=0, atol=tol * max(
                                   1.0, float(np.abs(jst["h"]).max())))
    jc = np.asarray(jst["conv"], np.float32)
    np.testing.assert_allclose(st["conv"].float().numpy(), jc, rtol=0,
                               atol=tol * max(1.0, float(np.abs(jc).max())))


def test_decode_matches_prefill():
    """The decode state carries the layer from token to token: twelve
    decode steps equal the prefill forward (the reference's 2e-3)."""
    cfg, _, p, _, x = _setup()
    tx = torch.as_tensor(x)
    with torch.no_grad():
        full = M.apply_mamba(p, cfg, tx, chunk=4)
        st = {k: torch.zeros(s.shape, dtype=s.dtype) for k, s in
              M.mamba_state_spec(cfg, D_MODEL, 2, torch.float32).items()}
        outs = []
        for t in range(12):
            o, st = M.decode_mamba(p, cfg, tx[:, t:t + 1], st)
            outs.append(o)
    np.testing.assert_allclose(torch.cat(outs, 1).numpy(), full.numpy(),
                               rtol=2e-3, atol=2e-3)
    # the conv state is the last K-1 inputs before the conv
    xz = tx @ p["w_in"]
    np.testing.assert_allclose(st["conv"].numpy(),
                               xz[:, -3:, :2 * D_MODEL].numpy(), **FWD)


def test_bridge_keeps_the_float32_leaves():
    """A bfloat16 layer's params bridged from the reference's numpy tree
    keep dt_bias, a_log and d_skip in float32, value for value."""
    from repro_torch.config import get_config
    from repro_torch.models import api
    cfg = get_config("jamba-v0.1-52b", reduced=True)
    spec = api.param_spec(cfg)
    p_np = tree_map(lambda s: np.random.default_rng(0).normal(
        0, 1, s.shape).astype(np.float32), spec)
    p = bridge.lm_params_from_numpy(cfg, p_np, device="cpu")
    mix = p["blocks"][0]["mixer"]
    for k in ("dt_bias", "a_log", "d_skip"):
        assert mix[k].dtype == torch.float32, k
    assert mix["w_in"].dtype == torch.bfloat16
    assert mix["a_log"].shape == (1, 2 * 64, 8)     # stacked over 1 repeat
    for a, s in zip(tree_leaves(p), tree_leaves(spec)):
        assert a.dtype == s.dtype
