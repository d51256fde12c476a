"""Work the port's LM step used to do past the reference's, now gone,
with its values unchanged:

* an untied embedding's backward sums the output gradient's rows by
  token id (``lm.segment_rows``: a stable sort and a sum per id, no
  float atomics), where it was a one-hot matmul of 2 T V d FLOPs: the
  embedding's gradient equals the reference's (a scatter) on the ten
  reduced LM archs of the dry run, to rtol 1e-5 / atol 1e-6 x its
  largest element; two runs give the same bits; and on the CPU it is
  ``np.add.at``'s float32 sum in token order, bit for bit;
* a windowed attention layer cuts its key and value bands once
  (``unfold``), where each query chunk sliced them and each slice's
  backward wrote a zero tensor of all the keys: at a fixed window and
  query chunk the counted bytes of a layer's forward and backward grow
  linearly in the sequence (they grew as the chunks times the keys),
  and the values and gradients equal the reference's
  ``chunked_attention`` (float32, rtol 1e-5 / atol 1e-6 x the largest
  element), as reduced gemma3-12b's step does the reference's.

The MoE recompute that ran the routed combine again is held by
``tests/test_torch_roofline_flops.py`` (no named term for it).
"""
import dataclasses

import numpy as np
import pytest
import torch

from repro_torch.config import get_config
from repro_torch.models import lm

torch.set_num_threads(1)

LM_ARCHS = (
    "deepseek-v2-lite-16b", "qwen2-moe-a2.7b", "xlstm-350m",
    "jamba-v0.1-52b", "whisper-small", "qwen2-vl-72b", "granite-34b",
    "gemma3-12b", "llama3-8b", "yi-9b",
)
B, S = 4, 64


def _close(got, want):
    np.testing.assert_allclose(got, want, rtol=1e-5,
                               atol=1e-6 * float(np.abs(want).max()))


@pytest.mark.parametrize("arch", LM_ARCHS)
def test_embedding_gradient_equals_the_reference(arch):
    import jax
    import jax.numpy as jnp
    from repro.config import get_config as j_get_config
    from repro.models import lm as jlm
    cfg = get_config(arch, reduced=True)
    jcfg = j_get_config(arch, reduced=True)
    rng = np.random.default_rng(LM_ARCHS.index(arch))
    emb = rng.normal(0, 1, (cfg.vocab_size, cfg.d_model)).astype(np.float32)
    # few ids, many repeats: every row sums several tokens
    tokens = rng.integers(0, min(cfg.vocab_size, 40), (B, S)).astype(
        np.int32)
    r = rng.normal(0, 1, (B, S, cfg.d_model)).astype(np.float32)
    cfg = dataclasses.replace(cfg, dtype="float32")
    jcfg = dataclasses.replace(jcfg, dtype="float32")
    e = torch.as_tensor(emb).requires_grad_(True)
    out = lm.embed_tokens(cfg, {"embed": e}, torch.as_tensor(tokens))
    (got,) = torch.autograd.grad(torch.sum(out * torch.as_tensor(r)), e)
    want = jax.grad(lambda t: jnp.sum(jlm.embed_tokens(
        jcfg, {"embed": t}, jnp.asarray(tokens)) * r))(jnp.asarray(emb))
    _close(got.numpy(), np.asarray(want))


def test_segment_sum_is_the_ordered_float32_sum_and_reproducible():
    rng = np.random.default_rng(3)
    n, t, d = 50, 3000, 2100          # d spans three column blocks
    ids = rng.integers(0, n, t)
    ids[:1000] = 7                    # one long run
    g = (rng.normal(0, 1, (t, d)) * 10.0 ** rng.integers(-3, 3, (t, 1))
         ).astype(np.float32)
    a = lm.segment_rows(torch.as_tensor(g), torch.as_tensor(ids), n)
    b = lm.segment_rows(torch.as_tensor(g), torch.as_tensor(ids), n)
    assert torch.equal(a, b)
    want = np.zeros((n, d), np.float32)
    np.add.at(want, ids, g)
    np.testing.assert_array_equal(a.numpy(), want)
    # bfloat16 rows: the float32 sum rounded once
    h = torch.as_tensor(g).to(torch.bfloat16)
    got = lm.segment_rows(h, torch.as_tensor(ids), n)
    assert got.dtype == torch.bfloat16
    want = np.zeros((n, d), np.float32)
    np.add.at(want, ids, h.float().numpy())
    assert torch.equal(got, torch.as_tensor(want).to(torch.bfloat16))


def _window_step(s, window, q_chunk):
    from repro_torch.models.layers.attention import chunked_attention

    def step(q, k, v):
        q, k, v = (t.requires_grad_(True) for t in (q, k, v))
        o = chunked_attention(q, k, v, causal=True, window=window,
                              q_chunk=q_chunk)
        return torch.autograd.grad(o.sum(), (q, k, v))
    return step


def test_windowed_layer_bytes_grow_linearly_in_the_sequence():
    from repro_torch.roofline import count_step
    window, q_chunk = 32, 16
    got = {}
    for s in (256, 512, 1024):
        args = [torch.empty((1, s, 2, 16), device="meta") for _ in range(3)]
        got[s] = count_step(_window_step(s, window, q_chunk),
                            *args).hbm_bytes
    # every band is ceil(window / chunk) + 1 chunks: the bytes per query
    # chunk do not depend on the sequence (one zero tensor of all the
    # keys per chunk made them grow with it)
    per_chunk = [got[s] / (s // q_chunk) for s in got]
    assert max(per_chunk) / min(per_chunk) < 1.05, got


@pytest.mark.parametrize("window,q_chunk", [(24, 16), (16, 16), (40, 8)])
def test_windowed_layer_equals_the_reference(window, q_chunk):
    import jax
    import jax.numpy as jnp
    from repro.models.layers.attention import chunked_attention as j_attn
    from repro_torch.models.layers.attention import chunked_attention
    rng = np.random.default_rng(window + q_chunk)
    q, k, v = (rng.normal(0, 1, (2, 128, 4, 16)).astype(np.float32)
               for _ in range(3))
    r = rng.normal(0, 1, (2, 128, 4, 16)).astype(np.float32)
    ts = [torch.as_tensor(x).requires_grad_(True) for x in (q, k, v)]
    out = chunked_attention(*ts, causal=True, window=window,
                            q_chunk=q_chunk)
    grads = torch.autograd.grad(torch.sum(out * torch.as_tensor(r)), ts)

    def ref(q, k, v):
        return jnp.sum(j_attn(q, k, v, causal=True, window=window,
                              q_chunk=q_chunk) * r)
    want_out = j_attn(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
                      causal=True, window=window, q_chunk=q_chunk)
    want = jax.grad(ref, argnums=(0, 1, 2))(q, k, v)
    _close(out.detach().numpy(), np.asarray(want_out))
    for g, w in zip(grads, want):
        _close(g.numpy(), np.asarray(w))


def test_gemma3_windowed_step_equals_the_reference():
    """Reduced gemma3-12b (five windowed layers of 32 keys, one global)
    at 64 tokens in query chunks of 16, so its windowed layers take the
    band route: the loss and every gradient leaf equal the reference's
    (float32: the loss to rtol 1e-5, each leaf to rtol 1e-4 / atol 1e-5
    x its largest element, tests/test_torch_lm.py's limits)."""
    import jax
    import jax.numpy as jnp
    from repro.config import get_config as j_get_config
    from repro.models import api as JA
    from repro_torch import bridge
    from repro_torch.models import api
    from repro_torch.train.step import value_and_grad
    from repro_torch.tree import tree_leaves
    q_chunk, s = 16, 64
    cfg = dataclasses.replace(get_config("gemma3-12b", reduced=True),
                              dtype="float32")
    jcfg = dataclasses.replace(j_get_config("gemma3-12b", reduced=True),
                               dtype="float32")
    assert any(0 < (p.window or 0) < s for p in cfg.pattern)
    rng = np.random.default_rng(5)
    batch = {k: rng.integers(0, cfg.vocab_size, (2, s)).astype(np.int32)
             for k in ("tokens", "labels")}
    p_np = bridge.params_to_numpy(api.init_params(
        cfg, torch.Generator().manual_seed(0)))
    (jloss, _), jgrads = jax.value_and_grad(lambda p, b: JA.loss_fn(
        jcfg, p, b, q_chunk=q_chunk), has_aux=True)(
        jax.tree.map(jnp.asarray, p_np), batch)
    params = bridge.lm_params_from_numpy(cfg, p_np, device="cpu")
    (loss, _), grads = value_and_grad(
        lambda p, b: api.loss_fn(cfg, p, b, q_chunk=q_chunk), params,
        {k: torch.as_tensor(v) for k, v in batch.items()})
    assert float(loss) == pytest.approx(float(jloss), rel=1e-5)
    for g, w in zip(tree_leaves(grads), jax.tree.leaves(jgrads)):
        w = np.asarray(w, np.float32)
        np.testing.assert_allclose(g.numpy(), w, rtol=1e-4,
                                   atol=1e-5 * float(np.abs(w).max()))
