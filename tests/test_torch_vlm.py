"""Port parity of the VLM backbone (qwen2-vl-72b: M-RoPE, the vision
stub) and of the model API's ``input_specs`` / ``runnable_cells``
against the reference's on the CPU, at the reduced config (2 layers,
d 64, 4 heads / 2 KV of 16, sections (2, 3, 3), 8 patches).

Both packages start from one set of params (drawn by the port, bridged
to the reference as numpy) and one numpy batch.  Tolerances, stated
before the first reading:

* ``apply_mrope`` forward (float32) to rtol 1e-6 / atol 1e-6 at
  positions below 16 (a 4 x 4 patch grid); at positions up to P the
  two packages' float32 frequencies (``theta ** (i / half)``, rounded
  apart by an ulp) turn an element by up to P x 2^-23 of its angle, so
  there atol 1e-6 + P x 2^-23 x max |x|;
* ``lm_loss`` with patch embeddings and 3-D positions (float32) to rtol
  1e-5, each gradient leaf to rtol 1e-4 / atol 1e-5 x its largest
  element;
* decode logits to atol 1e-5 x the largest logit, against the
  reference's decode and against the port's prefill of a text-only
  prompt;
* one ``make_train_step`` step: ``tests/test_torch_lm_train.py``'s
  split;
* ``input_specs`` and ``runnable_cells``: equal, key for key.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.config import SHAPES as J_SHAPES
from repro.config import AttentionConfig as JAttentionConfig
from repro.config import ShapeConfig as JShape
from repro.config import TrainConfig as JTrain
from repro.config import get_config as j_get_config
from repro.models import api as JA
from repro.models.layers import rope as JR
from repro.optim.adamw import adamw_init as j_adamw_init
from repro.train.step import make_train_step as j_make_train_step
from repro_torch import bridge
from repro_torch.config import (SHAPES, AttentionConfig, ShapeConfig,
                                TrainConfig, get_config, list_lm_archs)
from repro_torch.models import api, lm
from repro_torch.models.layers import rope as R
from repro_torch.models.layers.common import zeros_from_spec
from repro_torch.optim import adamw_init
from repro_torch.train.step import (_accum_grads, make_train_step,
                                    value_and_grad)
from repro_torch.tree import tree_leaves

from test_torch_lm_train import TCFG, _close_trees, _np, _small

torch.set_num_threads(1)

ARCH = "qwen2-vl-72b"
B, S = 2, 24
Q_CHUNK = 8


def _t(a):
    return torch.as_tensor(np.asarray(a))


def _cfgs(dtype="float32"):
    return (dataclasses.replace(get_config(ARCH, reduced=True), dtype=dtype),
            dataclasses.replace(j_get_config(ARCH, reduced=True),
                                dtype=dtype))


def _grid_positions(b, s, npatch, side):
    """The patches at (0, r, c) of a side x side grid, then the text at
    (p, p, p) from p = side (Qwen2-VL's ids for one image first)."""
    pos = np.zeros((b, s, 3), np.int32)
    r, c = np.divmod(np.arange(npatch), side)
    pos[:, :npatch, 1], pos[:, :npatch, 2] = r, c
    pos[:, npatch:] = (side + np.arange(s - npatch))[:, None]
    return pos


def _batch(cfg, seed=0, b=B, s=S):
    rng = np.random.default_rng(seed)
    v = cfg.vision
    return {"tokens": rng.integers(0, cfg.vocab_size, (b, s)).astype(
                np.int32),
            "labels": rng.integers(0, cfg.vocab_size, (b, s)).astype(
                np.int32),
            "patch_embeds": rng.normal(0, 1, (b, v.num_patches,
                                              v.patch_dim)).astype(
                np.float32),
            "positions": _grid_positions(b, s, v.num_patches, 4)
            if s >= v.num_patches else np.zeros((b, s, 3), np.int32)}


def _tbatch(b):
    return {k: torch.as_tensor(v) for k, v in b.items()}


def _jtree(np_tree):
    return jax.tree.map(jnp.asarray, np_tree)


@pytest.fixture(scope="module")
def model():
    cfg, jcfg = _cfgs()
    params = api.init_params(cfg, torch.Generator().manual_seed(0))
    return cfg, jcfg, params, _jtree(bridge.params_to_numpy(params))


@pytest.mark.parametrize("top", [16, 300])
@pytest.mark.parametrize("theta", [1e4, 1e6])
def test_mrope_matches_reference(theta, top):
    """Random 3-D positions in [0, top) at sections (2, 3, 3); a
    bfloat16 input comes back bfloat16."""
    rng = np.random.default_rng(1)
    x = rng.normal(0, 1, (2, 9, 3, 16)).astype(np.float32)
    pos = rng.integers(0, top, (2, 9, 3)).astype(np.int32)
    want = jax.jit(JR.apply_mrope, static_argnums=(2, 3))(
        jnp.asarray(x), jnp.asarray(pos), theta, (2, 3, 3))
    got = R.apply_mrope(_t(x), _t(pos), theta, (2, 3, 3))
    atol = 1e-6 if top <= 16 else \
        1e-6 + top * 2.0 ** -23 * float(np.abs(x).max())
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-6,
                               atol=atol)
    assert R.apply_mrope(_t(x).to(torch.bfloat16), _t(pos), theta,
                         (2, 3, 3)).dtype == torch.bfloat16
    with pytest.raises(AssertionError):
        R.apply_mrope(_t(x), _t(pos), theta, (2, 3, 2))


def test_mrope_of_text_positions_is_rope():
    """t = h = w: M-RoPE is standard RoPE; positions_for(mrope) gives
    the reference's ids, with an offset tensor too."""
    x = _t(np.random.default_rng(2).normal(0, 1, (2, 7, 3, 16)).astype(
        np.float32))
    mcfg, jmcfg = (AttentionConfig(rope_kind="mrope"),
                   JAttentionConfig(rope_kind="mrope"))
    pos3 = R.positions_for(mcfg, 2, 7, offset=3)
    np.testing.assert_allclose(
        R.apply_mrope(x, pos3, 1e4, (2, 3, 3)).numpy(),
        R.apply_rope(x, pos3[..., 0], 1e4).numpy(), rtol=0, atol=0)
    off = torch.tensor([[5], [9]], dtype=torch.int32)
    np.testing.assert_array_equal(
        R.positions_for(mcfg, 2, 4, offset=off).numpy(),
        np.asarray(JR.positions_for(jmcfg, 2, 4,
                                    offset=jnp.asarray(off.numpy()))))


@pytest.mark.parametrize("positions", ["grid", "default"])
def test_vlm_loss_and_grads_match_reference(model, positions):
    """The patch embeddings projected over the first 8 token embeddings,
    M-RoPE from the batch's 3-D positions (or the text-only default):
    float32 loss and every gradient leaf, vision_proj's included."""
    cfg, jcfg, params, jp = model
    batch = _batch(cfg, seed=3)
    if positions == "default":
        del batch["positions"]
    (jl, _), jg = jax.jit(jax.value_and_grad(lambda p, b: JA.loss_fn(
        jcfg, p, b, q_chunk=Q_CHUNK), has_aux=True))(jp, batch)
    (loss, m), grads = value_and_grad(lambda p, b: api.loss_fn(
        cfg, p, b, q_chunk=Q_CHUNK), params, _tbatch(batch))
    assert float(loss) == pytest.approx(float(jl), rel=1e-5)
    got, want = tree_leaves(grads), jax.tree.leaves(jg)
    assert len(got) == len(want)
    for g, w in zip(got, want):
        w = np.asarray(w)
        np.testing.assert_allclose(g.numpy(), w, rtol=1e-4,
                                   atol=1e-5 * float(np.abs(w).max()))
    assert float(grads["vision_proj"].abs().max()) > 0.0
    # the overwritten tokens' embedding rows get no gradient from them
    toks = batch["tokens"]
    only_patch = set(toks[:, :cfg.vision.num_patches].ravel()) - set(
        toks[:, cfg.vision.num_patches:].ravel())
    for t in only_patch:
        assert float(grads["embed"][t].abs().max()) == 0.0


def test_vlm_patches_must_fit_and_are_needed(model):
    cfg, _, params, _ = model
    batch = _tbatch(_batch(cfg, s=cfg.vision.num_patches - 1))
    with pytest.raises(ValueError, match="do not fit"):
        api.loss_fn(cfg, params, batch)
    del batch["patch_embeds"]
    with pytest.raises(ValueError, match="patch_embeds"):
        api.loss_fn(cfg, params, batch)


def test_vlm_decode_matches_reference(model):
    """Six decode steps from a zero state (1-D positions broadcast to
    the three sections, (B, 1, 3)) against the reference's."""
    cfg, jcfg, params, jp = model
    state = zeros_from_spec(api.decode_state_spec(cfg, B, 8))
    jstate = jax.tree.map(lambda s: jnp.zeros(s.shape, s.dtype),
                          JA.decode_state_spec(jcfg, B, 8))
    jstep = jax.jit(lambda p, s, t: JA.decode_step(jcfg, p, s, t))
    toks = np.random.default_rng(4).integers(
        0, cfg.vocab_size, (B, 6)).astype(np.int32)
    for i in range(6):
        tok = toks[:, i:i + 1]
        with torch.no_grad():
            logits, state = api.decode_step(cfg, params, state, _t(tok))
        jlogits, jstate = jstep(jp, jstate, jnp.asarray(tok))
        jl = np.asarray(jlogits)
        np.testing.assert_allclose(logits.numpy(), jl, rtol=0,
                                   atol=1e-5 * float(np.abs(jl).max()))
    assert int(state["pos"]) == 6


def test_vlm_decode_matches_prefill_on_text():
    """Teacher-forced decode of a text-only prompt (M-RoPE with
    t = h = w) equals prefill's logits at every position; a prompt with
    patches is not held against decode (decode's positions are 1-D)."""
    cfg, _ = _cfgs()
    params = api.init_params(cfg, torch.Generator().manual_seed(5))
    toks = _t(np.random.default_rng(6).integers(
        0, cfg.vocab_size, (2, 20)).astype(np.int32))
    with torch.no_grad():
        pre = lm.prefill_logits(cfg, params, toks, q_chunk=Q_CHUNK)
        explicit = lm.prefill_logits(
            cfg, params, toks, q_chunk=Q_CHUNK,
            positions=R.positions_for(cfg.attention, 2, 20))
        np.testing.assert_array_equal(pre.numpy(), explicit.numpy())
        state = zeros_from_spec(api.decode_state_spec(cfg, 2, 24))
        scale = float(pre.abs().max())
        for i in range(20):
            logits, state = api.decode_step(cfg, params, state,
                                            toks[:, i:i + 1])
            np.testing.assert_allclose(logits.numpy(), pre[:, i].numpy(),
                                       rtol=0, atol=1e-5 * scale)


def test_vlm_prefill_with_patches_matches_loss_forward(model):
    """prefill_logits takes the loss's patch_embeds and positions: its
    mean CE over the labels is lm_loss."""
    cfg, _, params, _ = model
    batch = _tbatch(_batch(cfg, seed=7))
    with torch.no_grad():
        logits = lm.prefill_logits(cfg, params, batch["tokens"],
                                   patch_embeds=batch["patch_embeds"],
                                   positions=batch["positions"],
                                   q_chunk=Q_CHUNK)
        loss, _ = api.loss_fn(cfg, params, batch, q_chunk=Q_CHUNK)
    ce = torch.nn.functional.cross_entropy(
        logits.reshape(-1, cfg.vocab_size), batch["labels"].reshape(
            -1).long())
    assert float(ce) == pytest.approx(float(loss), rel=1e-5)


def test_vlm_train_step_matches_reference():
    cfg, jcfg = _cfgs()
    p_np = bridge.params_to_numpy(api.init_params(
        cfg, torch.Generator().manual_seed(8)))
    batch = _batch(cfg, seed=9)
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
    assert params["vision_proj"].shape == (cfg.vision.patch_dim,
                                           cfg.d_model)
    step = make_train_step(cfg, TrainConfig(**TCFG), q_chunk=Q_CHUNK)
    p2, o2, m = step(params, adamw_init(params), _tbatch(batch))
    assert float(m["loss"]) == pytest.approx(float(jm["loss"]), rel=1e-5)
    reach = 2 * TCFG["lr"]
    _close_trees(p2, _np(jp2), loose, reach)
    _close_trees(o2["m"], _np(jo2["m"]), loose, reach)
    assert sum(int((a & m).sum()) for a, m in zip(loose, moving)) \
        < 5e-3 * sum(int(m.sum()) for m in moving)


def test_grad_accum_splits_patches_and_positions():
    cfg, _ = _cfgs()
    params = api.init_params(cfg, torch.Generator().manual_seed(10))
    batch = _tbatch(_batch(cfg, seed=11, b=4))

    def loss_fn(p, b):
        return api.loss_fn(cfg, p, b, q_chunk=Q_CHUNK)

    (whole, _), gw = value_and_grad(loss_fn, params, batch)
    ga, (la, _) = _accum_grads(loss_fn, params, batch, 2)
    assert float(la) == pytest.approx(float(whole), rel=1e-5)
    for a, w in zip(tree_leaves(ga), tree_leaves(gw)):
        np.testing.assert_allclose(a.numpy(), w.numpy(), rtol=1e-4,
                                   atol=1e-5 * float(w.abs().max()))


SHAPES_T = [ShapeConfig("t", "train", 64, 2),
            ShapeConfig("p", "prefill", 128, 1),
            ShapeConfig("d", "decode", 32, 3)]


def _spec_list(tree):
    flat = jax.tree_util.tree_flatten_with_path(tree)[0]
    return [(jax.tree_util.keystr(p), tuple(s.shape), str(s.dtype))
            for p, s in flat]


def _port_spec_list(tree, path=""):
    if isinstance(tree, dict):
        return [x for k in sorted(tree)
                for x in _port_spec_list(tree[k], f"{path}['{k}']")]
    if isinstance(tree, list):
        return [x for i, t in enumerate(tree)
                for x in _port_spec_list(t, f"{path}[{i}]")]
    return [(path, tuple(tree.shape), str(tree.dtype).replace("torch.", ""))]


@pytest.mark.parametrize("reduced", [True, False])
@pytest.mark.parametrize("arch", list_lm_archs())
def test_input_specs_and_runnable_cells_match_reference(arch, reduced):
    """Every LM arch at a train, a prefill and a decode shape: the same
    keys, shapes and dtypes as the reference's input_specs (whisper's
    frames, the VLM's patch_embeds and positions, the decode state);
    runnable_cells over the published shapes equal too."""
    cfg, jcfg = get_config(arch, reduced=reduced), \
        j_get_config(arch, reduced=reduced)
    for sh in SHAPES_T:
        got = _port_spec_list(api.input_specs(cfg, sh))
        want = _spec_list(JA.input_specs(
            jcfg, JShape(**dataclasses.asdict(sh))))
        assert got == want, (arch, sh.name)
    assert api.runnable_cells(cfg, list(SHAPES.values())) == \
        JA.runnable_cells(jcfg, list(J_SHAPES.values()))


def test_make_batch_draws_every_input():
    """make_batch over input_specs: frames and patch embeddings bf16
    N(0, 0.1), positions (B, S, 3) in [0, vocab) as the reference's,
    a decode state with pos 0."""
    g = torch.Generator().manual_seed(0)
    v = get_config(ARCH, reduced=True)
    b = api.make_batch(v, ShapeConfig("t", "train", 32, 2), g)
    assert set(b) == {"tokens", "labels", "patch_embeds", "positions"}
    assert b["positions"].shape == (2, 32, 3)
    assert b["positions"].dtype == torch.int32
    assert 0 <= int(b["positions"].min()) and int(
        b["positions"].max()) < v.vocab_size
    assert b["patch_embeds"].dtype == torch.bfloat16
    assert 0.05 < float(b["patch_embeds"].float().std()) < 0.2
    w = get_config("whisper-small", reduced=True)
    bw = api.make_batch(w, ShapeConfig("t", "train", 32, 2), g)
    assert bw["frames"].shape == (2, w.encoder.seq_len, w.encoder.feature_dim)
    d = api.make_batch(w, ShapeConfig("d", "decode", 16, 2), g)
    assert int(d["state"]["pos"]) == 0
    assert d["state"]["cross"]["k"].shape == (
        w.num_layers, 2, w.encoder.seq_len, w.attention.num_kv_heads,
        w.attention.head_dim)
    # both models run on what make_batch drew
    for cfg, batch in ((v, b), (w, bw)):
        params = api.init_params(cfg, torch.Generator().manual_seed(1))
        batch = dict(batch, labels=batch["labels"] % cfg.vocab_size)
        loss, _ = api.loss_fn(cfg, params, batch, q_chunk=16)
        assert bool(torch.isfinite(loss))
