"""Port parity of multi-head latent attention
(``repro_torch.models.layers.mla``) against the reference's
(``repro.models.layers.mla``) on the CPU, in float32: the expanded
form's forward and gradients (chunked and flash), the absorbed decode
step by step, decode against prefill (``tests/test_mla.py``'s own 3e-3)
and the compressed cache.

Tolerances, stated before the first reading: a forward to rtol 1e-5 /
atol 1e-5; a gradient to rtol 2e-4 / atol 2e-4.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.config import AttentionConfig as JAttentionConfig
from repro.models.layers import mla as JMLA
from repro_torch import bridge
from repro_torch.config import AttentionConfig
from repro_torch.models.layers import mla as MLA
from repro_torch.models.layers.common import init_from_spec, zeros_from_spec
from repro_torch.tree import tree_leaves, tree_map

torch.set_num_threads(1)

FWD = dict(rtol=1e-5, atol=1e-5)
GRAD = dict(rtol=2e-4, atol=2e-4)
D_MODEL = 32
ATTN = dict(kind="mla", num_heads=4, num_kv_heads=4, head_dim=16,
            kv_lora_rank=24, rope_head_dim=8, nope_head_dim=16,
            rope_theta=1e4)


def _setup(seed=0, s=16):
    cfg, jcfg = AttentionConfig(**ATTN), JAttentionConfig(**ATTN)
    p = init_from_spec(MLA.mla_spec(cfg, D_MODEL, torch.float32),
                       torch.Generator().manual_seed(seed))
    x = np.random.default_rng(seed).normal(0, 1, (2, s, D_MODEL)).astype(
        np.float32)
    return cfg, jcfg, p, bridge.params_to_numpy(p), x


def test_mla_spec_matches_reference():
    cfg, jcfg = AttentionConfig(**ATTN), JAttentionConfig(**ATTN)
    spec = MLA.mla_spec(cfg, D_MODEL, torch.float32)
    jspec = JMLA.mla_spec(jcfg, D_MODEL, jnp.float32)
    assert {k: tuple(v.shape) for k, v in spec.items()} == \
        {k: tuple(v.shape) for k, v in jspec.items()}


@pytest.mark.parametrize("impl,q_chunk", [("chunked", 32), ("chunked", 8),
                                          ("flash", 8)])
def test_apply_mla_matches_reference(impl, q_chunk):
    """The expanded form's output and the gradients of every weight and
    of the input."""
    cfg, jcfg, p, p_np, x = _setup(s=32)
    w = np.random.default_rng(5).normal(0, 1, x.shape).astype(np.float32)

    def jf(p, x):
        o = JMLA.apply_mla(p, jcfg, x, q_chunk=q_chunk, impl=impl)
        return jnp.sum(o * w), o

    (_, jo), jg = jax.value_and_grad(jf, argnums=(0, 1), has_aux=True)(
        jax.tree.map(jnp.asarray, p_np), jnp.asarray(x))
    tp = tree_map(lambda a: a.clone().requires_grad_(True), p)
    tx = torch.as_tensor(x).requires_grad_(True)
    o = MLA.apply_mla(tp, cfg, tx, q_chunk=q_chunk, impl=impl)
    np.testing.assert_allclose(o.detach().numpy(), np.asarray(jo), **FWD)
    (o * torch.as_tensor(w)).sum().backward()
    for g, j in zip(tree_leaves(tree_map(lambda t: t.grad, tp)),
                    jax.tree.leaves(jg[0])):
        np.testing.assert_allclose(g.numpy(), np.asarray(j), **GRAD)
    np.testing.assert_allclose(tx.grad.numpy(), np.asarray(jg[1]), **GRAD)


def test_decode_mla_matches_reference():
    """Each absorbed decode step's output and cache against the
    reference's, the step's inputs left as they were."""
    cfg, jcfg, p, p_np, x = _setup(seed=1)
    jp = jax.tree.map(jnp.asarray, p_np)
    cache = zeros_from_spec(MLA.mla_cache_spec(cfg, 2, 16, torch.float32))
    jcache = {"c_kv": jnp.zeros((2, 16, 24)), "k_rope": jnp.zeros((2, 16, 8))}
    jstep = jax.jit(lambda p, x, c, pos: JMLA.decode_mla(p, jcfg, x, c, pos))
    for pos in range(12):
        before = [t.clone() for t in tree_leaves(cache)]
        with torch.no_grad():
            o, new = MLA.decode_mla(p, cfg, torch.as_tensor(
                x[:, pos:pos + 1]), cache, torch.tensor(pos, dtype=torch.int32))
        assert all(torch.equal(a, b) for a, b in zip(before,
                                                     tree_leaves(cache)))
        jo, jcache = jstep(jp, jnp.asarray(x[:, pos:pos + 1]), jcache,
                           jnp.int32(pos))
        np.testing.assert_allclose(o.numpy(), np.asarray(jo), **FWD)
        for k in ("c_kv", "k_rope"):
            np.testing.assert_allclose(new[k].numpy(), np.asarray(jcache[k]),
                                       **FWD)
        cache = new


def test_mla_decode_matches_prefill():
    """tests/test_mla.py's case on the port: the absorbed decode equals
    the expanded prefill at every position to 3e-3."""
    cfg, _, p, _, x = _setup()
    xt = torch.as_tensor(x)
    with torch.no_grad():
        full = MLA.apply_mla(p, cfg, xt, q_chunk=32)
        cache = {"c_kv": torch.zeros(2, 16, 24), "k_rope": torch.zeros(2, 16, 8)}
        outs = []
        for pos in range(16):
            o, cache = MLA.decode_mla(p, cfg, xt[:, pos:pos + 1], cache,
                                      torch.tensor(pos, dtype=torch.int32))
            outs.append(o)
    np.testing.assert_allclose(torch.cat(outs, 1).numpy(), full.numpy(),
                               rtol=3e-3, atol=3e-3)


def test_mla_cache_is_compressed():
    """The decode cache stores kv_lora + rope_dim values per token
    (DeepSeek-V2-Lite: 576 against 2 x 16 x 128 for GQA)."""
    cfg = AttentionConfig(kind="mla", num_heads=16, num_kv_heads=16,
                          head_dim=128, kv_lora_rank=512, rope_head_dim=64,
                          nope_head_dim=128)
    spec = MLA.mla_cache_spec(cfg, batch=3, seq=100, dtype=torch.bfloat16)
    assert spec["c_kv"].shape == (3, 100, 512)
    assert spec["k_rope"].shape == (3, 100, 64)
    assert spec["c_kv"].dtype == torch.bfloat16
    per_tok = spec["c_kv"].shape[-1] + spec["k_rope"].shape[-1]
    assert per_tok == 576 and 2 * 16 * 128 / per_tok > 7
    jspec = JMLA.mla_cache_spec(JAttentionConfig(
        kind="mla", num_heads=16, num_kv_heads=16, head_dim=128,
        kv_lora_rank=512, rope_head_dim=64, nope_head_dim=128), 3, 100,
        jnp.bfloat16)
    assert {k: tuple(v.shape) for k, v in spec.items()} == \
        {k: tuple(v.shape) for k, v in jspec.items()}
