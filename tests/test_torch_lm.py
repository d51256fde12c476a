"""Port parity of the LMs (``repro_torch.models``) against the
reference's (``repro.models``) on the CPU, for every registered LM
arch's reduced form whose layers are all attention (the dense ones and,
since the MoE and MLA layers, qwen2-moe-a2.7b and deepseek-v2-lite-16b;
since the enc-dec and VLM layers, whisper-small with its frames and
qwen2-vl-72b with its patch embeddings and 3-D positions):
``lm_loss`` and its gradients, ``decode_step``'s logits; the parameter
layout and ``config_fingerprint`` of every LM arch
(``tests/test_torch_lm_moe.py`` holds the MoE models closer,
``tests/test_torch_lm_ssm.py`` the jamba and xLSTM models).

Both packages start from one set of params (drawn by the port, bridged
to the reference as numpy) and one batch.  Tolerances, stated before
the first reading:

* float32: the loss to rtol 1e-5, each gradient leaf to rtol 1e-4 /
  atol 1e-5 x its largest element (readings: ~2e-6);
* bfloat16: the loss to rtol 1e-3, each gradient leaf to atol 0.1 x its
  largest element (readings: 3.5e-5 and 3e-2): the reference's XLA CPU
  dots and PyTorch's round bfloat16 products at other points;
* decode logits (float32) to atol 1e-5 x the largest logit.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.config import config_fingerprint as j_fingerprint
from repro.config import get_config as j_get_config
from repro.config.base import MeshConfig as JMesh
from repro.config.base import ShapeConfig as JShape
from repro.config.base import TrainConfig as JTrain
from repro.models import api as JA
from repro_torch import bridge
from repro_torch.config import (MeshConfig, ShapeConfig, TrainConfig,
                                config_fingerprint, get_config,
                                list_lm_archs)
from repro_torch.models import api, lm
from repro_torch.models.layers.common import zeros_from_spec
from repro_torch.train.step import value_and_grad
from repro_torch.tree import tree_leaves

torch.set_num_threads(1)

ARCHS = list_lm_archs()
# the archs whose layers are all attention; the SSM and hybrid ones
# (jamba, xLSTM) are held in tests/test_torch_lm_ssm.py, to tolerances
# stated there from their own float32 and bfloat16 readings
ATTN_ARCHS = [a for a in ARCHS if all(
    s.mixer == "attn" for s in get_config(a, reduced=True).pattern)]
Q_CHUNK = 16
B, S = 2, 64


def _cfgs(arch, dtype):
    return (dataclasses.replace(get_config(arch, reduced=True), dtype=dtype),
            dataclasses.replace(j_get_config(arch, reduced=True),
                                dtype=dtype))


def _jax_tree(np_tree, dtype):
    jd = {"float32": jnp.float32, "bfloat16": jnp.bfloat16}[dtype]
    return jax.tree.map(lambda a: jnp.asarray(a, jd), np_tree)


def _batch(vocab, seed=0, cfg=None):
    """Tokens and labels (B, S); with ``cfg`` its modality stubs too:
    whisper's frames, the VLM's patch embeddings and 3-D positions."""
    rng = np.random.default_rng(seed)
    out = {"tokens": rng.integers(0, vocab, (B, S)).astype(np.int32),
           "labels": rng.integers(0, vocab, (B, S)).astype(np.int32)}
    if cfg is not None and cfg.encoder is not None:
        e = cfg.encoder
        out["frames"] = rng.normal(0, 1, (B, e.seq_len, e.feature_dim)
                                   ).astype(np.float32)
    if cfg is not None and cfg.vision is not None:
        v = cfg.vision
        out["patch_embeds"] = rng.normal(0, 1, (B, v.num_patches,
                                                v.patch_dim)
                                         ).astype(np.float32)
        out["positions"] = rng.integers(0, S, (B, S, 3)).astype(np.int32)
    return out


def _params(cfg, seed=0):
    return api.init_params(cfg, torch.Generator().manual_seed(seed))


def _tbatch(b):
    return {k: torch.as_tensor(v) for k, v in b.items()}


@pytest.fixture(scope="module")
def reference():
    """(arch, dtype) -> (np params, batch, loss, moe aux, np grads) of
    the reference, computed once."""
    cache = {}

    def get(arch, dtype):
        if (arch, dtype) not in cache:
            cfg, jcfg = _cfgs(arch, dtype)
            p_np = bridge.params_to_numpy(_params(cfg))
            batch = _batch(cfg.vocab_size, cfg=cfg)
            f = jax.jit(jax.value_and_grad(lambda p, b: JA.loss_fn(
                jcfg, p, b, q_chunk=Q_CHUNK), has_aux=True))
            (loss, m), g = f(_jax_tree(p_np, dtype), batch)
            cache[arch, dtype] = (p_np, batch, float(loss),
                                  float(m["moe_aux"]), jax.tree.map(
                                      lambda a: np.asarray(a, np.float32), g))
        return cache[arch, dtype]
    return get


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("arch", ATTN_ARCHS)
def test_lm_loss_and_grads_match_reference(arch, dtype, reference):
    cfg, _ = _cfgs(arch, dtype)
    p_np, batch, jloss, jaux, jgrads = reference(arch, dtype)
    params = bridge.lm_params_from_numpy(cfg, p_np, device="cpu")
    (loss, metrics), grads = value_and_grad(
        lambda p, b: api.loss_fn(cfg, p, b, q_chunk=Q_CHUNK), params,
        _tbatch(batch))
    tight = dtype == "float32"
    if cfg.family == "moe":
        assert float(metrics["moe_aux"]) > 0.0
        assert float(metrics["moe_aux"]) == pytest.approx(
            jaux, rel=1e-5 if tight else 1e-2)
        assert float(metrics["ce"] + metrics["moe_aux"]) == float(loss)
    else:
        assert float(metrics["moe_aux"]) == 0.0
        assert float(metrics["ce"]) == float(loss)
    assert float(loss) == pytest.approx(jloss, rel=1e-5 if tight else 1e-3)
    got, want = tree_leaves(grads), jax.tree.leaves(jgrads)
    assert len(got) == len(want)
    for g, w, p in zip(got, want, tree_leaves(params)):
        assert g.dtype == p.dtype    # an MoE router stays float32
        scale = float(np.abs(w).max())
        if tight:
            np.testing.assert_allclose(g.numpy(), w, rtol=1e-4,
                                       atol=1e-5 * scale)
        else:
            assert float(np.abs(g.float().numpy() - w).max()) \
                <= 0.1 * scale


@pytest.mark.parametrize("arch", ["lm-100m", "gemma3-12b"])
def test_decode_step_matches_reference(arch):
    """Eight decode steps of batch 2 in a context of 12 (gemma3's reduced
    local layers keep a ring of 32), each step's logits against the
    reference's, and the step's inputs left as they were."""
    cfg, jcfg = _cfgs(arch, "float32")
    params = _params(cfg)
    jp = _jax_tree(bridge.params_to_numpy(params), "float32")
    state = zeros_from_spec(api.decode_state_spec(cfg, 2, 12))
    jstate = jax.tree.map(lambda s: jnp.zeros(s.shape, s.dtype),
                          JA.decode_state_spec(jcfg, 2, 12))
    jstep = jax.jit(lambda p, s, t: JA.decode_step(jcfg, p, s, t))
    toks = np.random.default_rng(1).integers(0, cfg.vocab_size, (2, 8))
    for i in range(8):
        tok = toks[:, i:i + 1].astype(np.int32)
        before = [t.clone() for t in tree_leaves(state)]
        with torch.no_grad():
            logits, new = api.decode_step(cfg, params, state,
                                          torch.as_tensor(tok))
        assert all(torch.equal(a, b)
                   for a, b in zip(before, tree_leaves(state)))
        jlogits, jstate = jstep(jp, jstate, jnp.asarray(tok))
        jl = np.asarray(jlogits)
        np.testing.assert_allclose(logits.numpy(), jl, rtol=0,
                                   atol=1e-5 * float(np.abs(jl).max()))
        state = new
    assert int(state["pos"]) == 8


def test_decode_matches_prefill_logits():
    """Teacher-forced decode equals the forward's logits at every
    position (float32), the check chip_smoke.py makes at full size."""
    cfg, _ = _cfgs("gemma3-12b", "float32")
    params = _params(cfg)
    toks = torch.as_tensor(np.random.default_rng(2).integers(
        0, cfg.vocab_size, (2, 40)).astype(np.int32))
    with torch.no_grad():
        pre = lm.prefill_logits(cfg, params, toks, q_chunk=8)
        state = zeros_from_spec(api.decode_state_spec(cfg, 2, 48))
        for i in range(40):
            logits, state = api.decode_step(cfg, params, state,
                                            toks[:, i:i + 1])
            np.testing.assert_allclose(logits.numpy(), pre[:, i].numpy(),
                                       rtol=0, atol=1e-5)


def test_remat_and_layer_modes_agree():
    """remat none / dots / full and layer_mode scan / unroll compute the
    same loss and gradients (recomputation repeats the same float32
    operations)."""
    cfg, _ = _cfgs("llama3-8b", "float32")
    params = _params(cfg)
    batch = _tbatch(_batch(cfg.vocab_size))
    runs = [value_and_grad(lambda p, b: api.loss_fn(
        cfg, p, b, remat=r, layer_mode=m, q_chunk=Q_CHUNK), params, batch)
        for r, m in (("none", "scan"), ("dots", "scan"), ("full", "scan"),
                     ("full", "unroll"))]
    for (loss, _), grads in runs[1:]:
        assert float(loss) == float(runs[0][0][0])
        for a, b in zip(tree_leaves(grads), tree_leaves(runs[0][1])):
            np.testing.assert_allclose(a.numpy(), b.numpy(), rtol=1e-6,
                                       atol=1e-9)
    with pytest.raises(ValueError, match="remat"):
        api.loss_fn(cfg, params, batch, remat="some")


def test_flash_in_model_loss_matches_chunked():
    """attn_impl='flash' gives the baseline's loss (as the reference's
    tests/test_flash.py holds its own)."""
    cfg, _ = _cfgs("llama3-8b", "float32")
    params = _params(cfg)
    batch = _tbatch(_batch(cfg.vocab_size))
    l1, _ = api.loss_fn(cfg, params, batch, q_chunk=32)
    l2, _ = api.loss_fn(dataclasses.replace(cfg, attn_impl="flash"),
                        params, batch, q_chunk=32)
    assert abs(float(l1) - float(l2)) < 1e-5


def test_fused_qkv_matches_reference():
    cfg, jcfg = _cfgs("yi-9b", "float32")
    cfg = dataclasses.replace(cfg, fused_qkv=True)
    jcfg = dataclasses.replace(jcfg, fused_qkv=True)
    p_np = bridge.params_to_numpy(_params(cfg))
    batch = _batch(cfg.vocab_size, seed=3)
    jl, _ = jax.jit(lambda p, b: JA.loss_fn(jcfg, p, b, q_chunk=Q_CHUNK))(
        _jax_tree(p_np, "float32"), batch)
    pl, _ = api.loss_fn(cfg, bridge.lm_params_from_numpy(cfg, p_np,
                                                         device="cpu"),
                        _tbatch(batch), q_chunk=Q_CHUNK)
    assert float(pl) == pytest.approx(float(jl), rel=1e-5)


def test_dense_prefix_matches_reference():
    """``num_dense_prefix`` (deepseek's layer 0 as a separate unstacked
    block, the stack's first repeat skipped) on a dense config: loss,
    gradients (the skipped repeat's are zero) and two decode steps."""
    cfg, jcfg = (dataclasses.replace(c, num_dense_prefix=1, attn_chunk=16)
                 for c in _cfgs("granite-34b", "float32"))
    params = _params(cfg)
    assert len(params["prefix_blocks"]) == 1
    p_np = bridge.params_to_numpy(params)
    jp = _jax_tree(p_np, "float32")
    batch = _batch(cfg.vocab_size, seed=4)
    jl, jg = jax.jit(jax.value_and_grad(lambda p, b: JA.loss_fn(
        jcfg, p, b)[0]))(jp, batch)
    (pl, _), pg = value_and_grad(lambda p, b: api.loss_fn(cfg, p, b),
                                 params, _tbatch(batch))
    assert float(pl) == pytest.approx(float(jl), rel=1e-5)
    for g, w in zip(tree_leaves(pg), jax.tree.leaves(jg)):
        w = np.asarray(w)
        np.testing.assert_allclose(g.numpy(), w, rtol=1e-4,
                                   atol=1e-5 * float(np.abs(w).max()))
    assert float(pg["blocks"][0]["ffn"]["w_up"][0].abs().max()) == 0.0
    state = zeros_from_spec(api.decode_state_spec(cfg, 2, 8))
    jstate = jax.tree.map(lambda s: jnp.zeros(s.shape, s.dtype),
                          JA.decode_state_spec(jcfg, 2, 8))
    jstep = jax.jit(lambda p, s, t: JA.decode_step(jcfg, p, s, t))
    for i in range(2):
        tok = batch["tokens"][:, i:i + 1]
        with torch.no_grad():
            logits, state = api.decode_step(cfg, params, state,
                                            torch.as_tensor(tok))
        jlogits, jstate = jstep(jp, jstate, jnp.asarray(tok))
        np.testing.assert_allclose(logits.numpy(), np.asarray(jlogits),
                                   rtol=0, atol=1e-5)
    np.testing.assert_allclose(state["blocks"][0]["k"].numpy(),
                               np.asarray(jstate["blocks"][0]["k"]),
                               rtol=1e-5, atol=1e-6)


def test_param_spec_matches_reference_layout():
    for arch in ARCHS:
        for reduced in (False, True):
            cfg = get_config(arch, reduced=reduced)
            jspec = JA.param_spec(j_get_config(arch, reduced=reduced))
            spec = api.param_spec(cfg)
            assert [tuple(s.shape) for s in tree_leaves(spec)] == \
                [tuple(s.shape) for s in jax.tree.leaves(jspec)], arch


def test_make_batch_shapes():
    cfg = get_config("lm-100m", reduced=True)
    g = torch.Generator().manual_seed(0)
    b = api.make_batch(cfg, ShapeConfig("t", "train", 32, 4), g)
    assert b["tokens"].shape == (4, 32) and b["tokens"].dtype == torch.int32
    assert int(b["labels"].max()) < cfg.vocab_size
    d = api.make_batch(cfg, ShapeConfig("d", "decode", 16, 2), g)
    assert d["token"].shape == (2, 1) and int(d["state"]["pos"]) == 0
    assert d["state"]["blocks"][0]["k"].shape == (2, 2, 16, 2, 16)
    # input_specs, which make_batch draws from, is the reference's
    for sh in (ShapeConfig("t", "train", 32, 4),
               ShapeConfig("d", "decode", 16, 2)):
        specs, jspecs = (api.input_specs(cfg, sh), JA.input_specs(
            j_get_config("lm-100m", reduced=True),
            JShape(**dataclasses.asdict(sh))))
        assert [tuple(s.shape) for s in tree_leaves(specs)] == \
            [tuple(s.shape) for s in jax.tree.leaves(jspecs)]


@pytest.mark.parametrize("arch,reduced", [
    ("whisper-small", True), ("whisper-small", False),
    ("qwen2-vl-72b", True), ("qwen2-vl-72b", False)])
def test_other_lm_archs_are_refused(arch, reduced):
    """The enc-dec and VLM archs, refused until their layers were
    ported, now build: the port's config equals the reference's field
    for field, and ``param_spec`` (``enc_in``, ``enc_blocks``,
    ``dec_blocks``, the empty ``prefix_blocks``; ``vision_proj``)
    equals the reference's layout, key for key and shape for shape."""
    cfg, jcfg = get_config(arch, reduced=reduced), \
        j_get_config(arch, reduced=reduced)
    assert dataclasses.asdict(cfg) == dataclasses.asdict(jcfg)
    spec, jspec = api.param_spec(cfg), JA.param_spec(jcfg)
    assert spec["prefix_blocks"] == jspec["prefix_blocks"] == []
    flat = jax.tree_util.tree_flatten_with_path(jspec)[0]
    assert [tuple(s.shape) for s in tree_leaves(spec)] == \
        [tuple(s.shape) for _, s in flat]
    assert [s.dtype for s in tree_leaves(spec)] == \
        [getattr(torch, str(s.dtype)) for _, s in flat]
    extra = {"enc_in", "enc_blocks", "dec_blocks"} if cfg.encoder \
        else {"vision_proj"}
    assert extra <= set(spec) and set(spec) == set(jspec)


def test_config_fingerprints_equal_reference():
    for arch in ARCHS:
        for reduced in (False, True):
            assert config_fingerprint(get_config(arch, reduced=reduced)) \
                == j_fingerprint(j_get_config(arch, reduced=reduced))
    for ours, theirs in ((TrainConfig(), JTrain()),
                         (TrainConfig(lr=3e-3, grad_accum=2),
                          JTrain(lr=3e-3, grad_accum=2)),
                         (MeshConfig(), JMesh()),
                         (ShapeConfig("t", "train", 64, 2),
                          JShape("t", "train", 64, 2))):
        assert config_fingerprint(ours) == j_fingerprint(theirs)
        assert dataclasses.asdict(ours) == dataclasses.asdict(theirs)
