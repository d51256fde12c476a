"""Decoder-only LM assembly: embeds -> repeated block pattern -> head
(port of ``repro.models.lm`` for the dense, MoE, SSM and hybrid
families: every layer is a mixer (attention, GQA or MLA; Mamba; mLSTM
or sLSTM) + a dense gated MLP, a mixture of experts or no FFN).

Layer stacking: per-pattern-position parameter *stacks* with leading
dim ``pattern_repeat``, as in the reference, so a tree bridges leaf for
leaf.  The reference's ``layer_mode`` "scan" and "unroll" are one loop
here over the stacked leaves (each stack is unbound once, so the
backward stacks its gradients once).  ``remat``: "full" recomputes each
block in the backward (``torch.utils.checkpoint``, non-reentrant),
"dots" saves the outputs of the matmuls without batch dims (the
projections, the MLP and the experts' gate and up products) and
recomputes the rest, "none" saves all.

Embeddings: a tied table goes in through a chunked one-hot matmul, as
the reference's; an untied one through a gather whose backward is the
same one-hot matmul.  Both backward passes are therefore matmuls, with
no atomics, so a step is bitwise reproducible on the card.  The loss is
computed in chunks over the tokens, each chunk's (tokens, vocab) logits
recomputed in the backward, so the full logits never materialize.

The parameter tree pads an MoE layer's experts to a multiple of the
reference's model axis (``model_axis=16``: qwen2's 60 to 64 inert
experts), so a reference tree bridges leaf for leaf.  The VLM's vision
stub (qwen2-vl) projects precomputed patch embeddings through
``vision_proj`` and writes them over the first ``num_patches`` token
embeddings; its 3-D M-RoPE positions come with the batch.  The
encoder-decoder (whisper) lives in ``encdec.py`` and reuses the
embedding, the loss, remat and stacking from here.  The reference's
sharding constraints are dropped: one device has no sharding.
"""
from __future__ import annotations

import functools
from typing import Any, Dict, List, Optional, Tuple

import torch
import torch.nn.functional as F
from torch.utils.checkpoint import (CheckpointPolicy, checkpoint,
                                    create_selective_checkpoint_contexts)

from repro_torch.config.base import LayerSpec, ModelConfig
from repro_torch.tree import tree_leaves, tree_map, tree_unflatten
from .layers import attention as attn_lib
from .layers import mamba as mamba_lib
from .layers import mla as mla_lib
from .layers import moe as moe_lib
from .layers import xlstm as xlstm_lib
from .layers.common import (TensorSpec, activation, apply_mlp, apply_norm,
                            dtype_of, mlp_spec, norm_spec, sequential_loop)

Params = Dict[str, Any]

LOSS_CHUNK = 512
EMBED_CHUNK = 2048


# ---------------------------------------------------------------------------
# Param specs


def _mixer_spec(spec: LayerSpec, cfg: ModelConfig, dtype) -> Params:
    a = cfg.attention
    if spec.mixer == "attn":
        if a.kind == "mla":
            return mla_lib.mla_spec(a, cfg.d_model, dtype)
        return attn_lib.attention_spec(a, cfg.d_model, dtype)
    if spec.mixer == "mamba":
        return mamba_lib.mamba_spec(cfg.ssm, cfg.d_model, dtype)
    if spec.mixer == "mlstm":
        return xlstm_lib.mlstm_spec(cfg.ssm, cfg.d_model, dtype)
    if spec.mixer == "slstm":
        return xlstm_lib.slstm_spec(cfg.ssm, cfg.d_model, dtype)
    raise ValueError(spec.mixer)


def _ffn_spec(spec: LayerSpec, cfg: ModelConfig, dtype,
              model_axis: int) -> Optional[Params]:
    if spec.ffn == "none":
        return None
    if spec.ffn == "dense":
        return mlp_spec(cfg.d_model, cfg.d_ff, dtype)
    return moe_lib.moe_spec(cfg.moe, cfg.d_model, dtype, model_axis)


def block_spec(spec: LayerSpec, cfg: ModelConfig, dtype,
               model_axis: int) -> Params:
    p: Params = {
        "ln1": norm_spec(cfg.d_model, cfg.norm, dtype),
        "mixer": _mixer_spec(spec, cfg, dtype),
    }
    ffn = _ffn_spec(spec, cfg, dtype, model_axis)
    if ffn is not None:
        p["ln2"] = norm_spec(cfg.d_model, cfg.norm, dtype)
        p["ffn"] = ffn
    return p


def _stack(tree: Params, n: int) -> Params:
    return tree_map(lambda s: TensorSpec((n,) + s.shape, s.dtype), tree)


def param_spec(cfg: ModelConfig, *, model_axis: int = 16) -> Params:
    """Full parameter tree of :class:`TensorSpec`.  ``blocks`` is a list
    over pattern positions, each the block tree stacked over
    ``pattern_repeat``; dense-prefix overrides are separate unstacked
    entries in ``prefix_blocks``.  MoE experts are padded to a multiple
    of ``model_axis`` (``moe.padded_num_experts``); a VLM adds the
    vision stub's ``vision_proj`` (patch_dim, d_model)."""
    dtype = dtype_of(cfg.dtype)
    rep = cfg.pattern_repeat
    v, d = cfg.vocab_size, cfg.d_model
    p: Params = {"embed": TensorSpec((v, d), dtype)}
    if not cfg.tie_embeddings:
        p["lm_head"] = TensorSpec((d, v), dtype)
    p["final_norm"] = norm_spec(d, cfg.norm, dtype)
    p["prefix_blocks"] = [
        block_spec(LayerSpec(mixer=s.mixer, ffn="dense", window=s.window),
                   cfg, dtype, model_axis)
        for s in cfg.layer_specs()[:cfg.num_dense_prefix]]
    p["blocks"] = [_stack(block_spec(spec, cfg, dtype, model_axis), rep)
                   for spec in cfg.pattern]
    if cfg.vision is not None:
        p["vision_proj"] = TensorSpec((cfg.vision.patch_dim, d), dtype)
    return p


# ---------------------------------------------------------------------------
# Embedding / head / loss


def _onehot_rows(tk: torch.Tensor, emb: torch.Tensor) -> torch.Tensor:
    return F.one_hot(tk.long(), emb.shape[0]).to(emb.dtype) @ emb


class _GatherRows(torch.autograd.Function):
    """``emb[tokens]`` with the one-hot matmul as its backward (chunks
    of ``EMBED_CHUNK`` tokens): no scatter atomics."""

    @staticmethod
    def forward(ctx, emb, flat):
        ctx.save_for_backward(flat)
        ctx.vocab = emb.shape[0]
        return emb[flat.long()]

    @staticmethod
    def backward(ctx, g):
        (flat,) = ctx.saved_tensors
        out = None
        for c in range(0, flat.shape[0], EMBED_CHUNK):
            oh = F.one_hot(flat[c:c + EMBED_CHUNK].long(),
                           ctx.vocab).to(g.dtype)
            part = oh.t() @ g[c:c + EMBED_CHUNK]
            out = part if out is None else out + part
        return out, None


def _maybe_checkpoint(fn, *args):
    if torch.is_grad_enabled():
        return checkpoint(fn, *args, use_reentrant=False)
    return fn(*args)


def embed_tokens(cfg: ModelConfig, params: Params,
                 tokens: torch.Tensor) -> torch.Tensor:
    emb = params["embed"]
    b, s = tokens.shape
    flat = tokens.reshape(-1)
    if not cfg.tie_embeddings:
        return _GatherRows.apply(emb, flat).reshape(b, s, cfg.d_model)
    # Tied: chunked one-hot matmul, each chunk recomputed in backward.
    n = flat.shape[0]
    chunk = min(EMBED_CHUNK, n)
    xs = [_maybe_checkpoint(_onehot_rows, flat[c:c + chunk], emb)
          for c in range(0, n, chunk)]
    return torch.cat(xs, dim=0).reshape(b, s, cfg.d_model)


def _head_logits(cfg: ModelConfig, params: Params,
                 x: torch.Tensor) -> torch.Tensor:
    """x: (..., D) -> logits (..., V)."""
    if cfg.tie_embeddings:
        return x @ params["embed"].t()
    return x @ params["lm_head"]


def _ce_chunk(cfg, params, xc, lc):
    logits = _head_logits(cfg, params, xc).float()
    lse = torch.logsumexp(logits, dim=-1)
    iota = torch.arange(cfg.vocab_size, device=lc.device)[None, :]
    ll = torch.sum(torch.where(iota == lc[:, None], logits, 0.0), dim=-1)
    return torch.sum(torch.where(lc >= 0, lse - ll, 0.0))


def chunked_ce_loss(cfg: ModelConfig, params: Params, x: torch.Tensor,
                    labels: torch.Tensor) -> torch.Tensor:
    """Mean cross-entropy without materializing (tokens, vocab) logits:
    chunks of ``LOSS_CHUNK * batch`` tokens, each recomputed in the
    backward, summed in order in float32."""
    b, s, d = x.shape
    xf = x.reshape(b * s, d)
    lf = labels.reshape(b * s)
    n = xf.shape[0]
    chunk = min(LOSS_CHUNK * max(1, b), n)
    pad = (-n) % chunk
    if pad:
        xf = F.pad(xf, (0, 0, 0, pad))
        lf = F.pad(lf, (0, pad), value=-1)
    tot = torch.zeros((), dtype=torch.float32, device=x.device)
    with sequential_loop("ce_chunks", xf.shape[0] // chunk) as steps:
        xs, ls = steps.pieces(xf, 0, chunk), steps.pieces(lf, 0, chunk)
        for c in steps:
            tot = tot + _maybe_checkpoint(
                functools.partial(_ce_chunk, cfg), params, xs[c], ls[c])
    return tot / n


# ---------------------------------------------------------------------------
# Block application


def _resolve_window(spec: LayerSpec, cfg: ModelConfig) -> int:
    if spec.window is not None:
        return spec.window
    return cfg.attention.window


def apply_block(spec: LayerSpec, cfg: ModelConfig, p: Params,
                x: torch.Tensor, *, positions=None, q_chunk: int = 512
                ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Returns (x, moe_aux_loss) — the aux loss is 0 for a dense FFN."""
    a = cfg.attention
    if cfg.attn_chunk:
        q_chunk = cfg.attn_chunk
    aux = torch.zeros((), dtype=torch.float32, device=x.device)
    h = apply_norm(p["ln1"], x, cfg.norm)
    if spec.mixer == "attn":
        if a.kind == "mla":
            h = mla_lib.apply_mla(p["mixer"], a, h, q_chunk=q_chunk,
                                  impl=cfg.attn_impl)
        else:
            h = attn_lib.apply_attention(
                p["mixer"], a, h, causal=True,
                window=_resolve_window(spec, cfg), positions=positions,
                q_chunk=q_chunk, impl=cfg.attn_impl,
                fused_qkv=cfg.fused_qkv)
    elif spec.mixer == "mamba":
        h = mamba_lib.apply_mamba(p["mixer"], cfg.ssm, h)
    elif spec.mixer == "mlstm":
        h = xlstm_lib.apply_mlstm(p["mixer"], cfg.ssm, h)
    elif spec.mixer == "slstm":
        h = xlstm_lib.apply_slstm(p["mixer"], cfg.ssm, h)
    else:
        raise ValueError(spec.mixer)
    x = x + h
    if spec.ffn != "none":
        h = apply_norm(p["ln2"], x, cfg.norm)
        if spec.ffn == "dense":
            h = apply_mlp(p["ffn"], h, cfg.act, fused=cfg.fused_qkv)
        else:
            h, aux = moe_lib.apply_moe(p["ffn"], cfg.moe, h,
                                       activation(cfg.act),
                                       dispatch=cfg.moe_dispatch)
        x = x + h
    return x, aux


_MATMULS = (torch.ops.aten.mm.default, torch.ops.aten.addmm.default)


def _save_dots(ctx, op, *args, **kwargs):
    """The reference's ``checkpoint_dots_with_no_batch_dims``: keep the
    2-D matmuls (a (B, S, D) @ (D, F) product folds to one), recompute
    everything else, the batched attention products included."""
    if op in _MATMULS:
        return CheckpointPolicy.MUST_SAVE
    return CheckpointPolicy.PREFER_RECOMPUTE


def _remat(fn, policy: str):
    if policy not in ("none", "full", "dots"):
        raise ValueError(f"remat {policy!r}: 'none', 'full' or 'dots'")

    def run(p, x, *rest):
        if policy == "none" or not torch.is_grad_enabled():
            return fn(p, x, *rest)
        if policy == "dots":
            return checkpoint(fn, p, x, *rest, use_reentrant=False,
                              context_fn=functools.partial(
                                  create_selective_checkpoint_contexts,
                                  _save_dots))
        return checkpoint(fn, p, x, *rest, use_reentrant=False)
    return run


def _unstack(tree, n: int) -> List[Any]:
    """A stacked tree -> n trees, one per repeat (each leaf unbound
    once)."""
    cols = [leaf.unbind(0) for leaf in tree_leaves(tree)]
    return [tree_unflatten(tree, [c[r] for c in cols]) for r in range(n)]


def _check_layer_mode(layer_mode: str) -> None:
    if layer_mode not in ("scan", "unroll"):
        raise ValueError(f"layer_mode {layer_mode!r}: 'scan' or 'unroll'")


def apply_stack(cfg: ModelConfig, params: Params, x: torch.Tensor, *,
                positions=None, layer_mode: str = "scan",
                remat: str = "full", q_chunk: int = 512
                ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Run all layers. Returns (x, total_moe_aux)."""
    _check_layer_mode(layer_mode)
    aux_total = torch.zeros((), dtype=torch.float32, device=x.device)
    n_prefix = cfg.num_dense_prefix
    specs = cfg.layer_specs()

    def block(spec):
        return _remat(functools.partial(apply_block, spec, cfg,
                                        positions=positions,
                                        q_chunk=q_chunk), remat)

    for i, bp in enumerate(params["prefix_blocks"]):
        s = LayerSpec(mixer=specs[i].mixer, ffn="dense",
                      window=specs[i].window)
        x, aux = block(s)(bp, x)
        aux_total = aux_total + aux
    if n_prefix:
        # the prefix layers replace the first repeats of the pattern
        assert len(cfg.pattern) == 1, (
            "num_dense_prefix requires pattern length 1")
    rep = cfg.pattern_repeat
    stacks = [_unstack(params["blocks"][j], rep)
              for j in range(len(cfg.pattern))]
    fns = [block(spec) for spec in cfg.pattern]
    for r in range(n_prefix, rep):
        for j, fn in enumerate(fns):
            x, aux = fn(stacks[j][r], x)
            aux_total = aux_total + aux
    return x, aux_total


# ---------------------------------------------------------------------------
# Train-mode forward + loss


def embed_inputs(cfg: ModelConfig, params: Params, tokens: torch.Tensor,
                 patch_embeds: Optional[torch.Tensor] = None
                 ) -> torch.Tensor:
    """Token embeddings (B, S, D); given a VLM's ``patch_embeds``
    (B, P, patch_dim), their projection through ``vision_proj``
    replaces the first P token embeddings (the reference's
    ``dynamic_update_slice`` at 0, whose update must fit: S >= P)."""
    x = embed_tokens(cfg, params, tokens)
    if cfg.vision is None or patch_embeds is None:
        return x
    patches = patch_embeds.to(x.dtype) @ params["vision_proj"]
    npatch, s = patches.shape[1], x.shape[1]
    if s < npatch:
        raise ValueError(
            f"{cfg.name}: {npatch} patch embeddings do not fit in {s} "
            "tokens; they overwrite the first num_patches token "
            "embeddings, so the sequence must hold at least as many")
    return torch.cat([patches, x[:, npatch:]], dim=1)


def lm_loss(cfg: ModelConfig, params: Params, batch: Dict[str, Any], *,
            layer_mode: str = "scan", remat: str = "full",
            q_chunk: int = 512
            ) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
    """Mean CE (+ the MoE aux loss).  A VLM's batch carries
    ``patch_embeds`` and, optionally, ``positions`` (B, S, 3) for
    M-RoPE (text-only ids when absent)."""
    positions = None
    if cfg.vision is not None:
        if "patch_embeds" not in batch:
            raise ValueError(
                f"{cfg.name}: the vision stub needs patch_embeds (B, "
                f"{cfg.vision.num_patches}, {cfg.vision.patch_dim})")
        positions = batch.get("positions")
    x = embed_inputs(cfg, params, batch["tokens"], batch.get("patch_embeds"))
    x, aux = apply_stack(cfg, params, x, positions=positions,
                         layer_mode=layer_mode, remat=remat, q_chunk=q_chunk)
    x = apply_norm(params["final_norm"], x, cfg.norm)
    ce = chunked_ce_loss(cfg, params, x, batch["labels"])
    return ce + aux, {"ce": ce, "moe_aux": aux}


def prefill_logits(cfg: ModelConfig, params: Params, tokens: torch.Tensor,
                   *, patch_embeds: Optional[torch.Tensor] = None,
                   positions: Optional[torch.Tensor] = None,
                   q_chunk: int = 512) -> torch.Tensor:
    """The forward of ``lm_loss`` up to the head: float32 logits
    (B, S, V) at every position (to hold decode against; it
    materializes the full logits).  ``patch_embeds`` and ``positions``
    as in ``lm_loss``'s batch; a VLM without them reads a text-only
    prompt (M-RoPE with t = h = w)."""
    x = embed_inputs(cfg, params, tokens, patch_embeds)
    x, _ = apply_stack(cfg, params, x, positions=positions, remat="none",
                       q_chunk=q_chunk)
    x = apply_norm(params["final_norm"], x, cfg.norm)
    return _head_logits(cfg, params, x).float()


# ---------------------------------------------------------------------------
# Decode: state spec + one step


def _mixer_cache_spec(spec: LayerSpec, cfg: ModelConfig, batch: int,
                      seq: int, dtype) -> Params:
    a = cfg.attention
    if spec.mixer == "attn":
        if a.kind == "mla":
            return mla_lib.mla_cache_spec(a, batch, seq, dtype)
        return attn_lib.cache_spec(a, batch, seq, _resolve_window(spec, cfg),
                                   dtype)
    if spec.mixer == "mamba":
        return mamba_lib.mamba_state_spec(cfg.ssm, cfg.d_model, batch, dtype)
    if spec.mixer == "mlstm":
        return xlstm_lib.mlstm_state_spec(cfg.ssm, cfg.d_model, batch, dtype)
    if spec.mixer == "slstm":
        return xlstm_lib.slstm_state_spec(cfg.ssm, cfg.d_model, batch, dtype)
    raise ValueError(spec.mixer)


def decode_state_spec(cfg: ModelConfig, batch: int, seq: int) -> Params:
    """Tree of :class:`TensorSpec` for the decode cache."""
    dtype = dtype_of(cfg.dtype)
    rep = cfg.pattern_repeat
    st: Params = {"pos": TensorSpec((), torch.int32)}
    st["prefix_blocks"] = [
        _mixer_cache_spec(s, cfg, batch, seq, dtype)
        for s in cfg.layer_specs()[:cfg.num_dense_prefix]]
    st["blocks"] = [_stack(_mixer_cache_spec(spec, cfg, batch, seq, dtype),
                           rep) for spec in cfg.pattern]
    return st


def with_minus_inf_stabilizers(state: Params) -> Params:
    """``state`` with every xLSTM stabilizer ``m`` (the mLSTM's and the
    sLSTM's) at -inf, the start the prefill forward takes, so that
    decode from it follows prefill.  A zero state (``launch.serve``'s,
    as the reference's) starts them at 0, where the sLSTM's output
    differs."""
    def fix(cache):
        if "m" not in cache:
            return cache
        return dict(cache, m=torch.full_like(cache["m"], float("-inf")))
    return dict(state, prefix_blocks=[fix(c) for c in state["prefix_blocks"]],
                blocks=[fix(c) for c in state["blocks"]])


def _decode_mixer(spec: LayerSpec, cfg: ModelConfig, p, h, cache, pos):
    a = cfg.attention
    if spec.mixer == "attn":
        if a.kind == "mla":
            return mla_lib.decode_mla(p["mixer"], a, h, cache, pos)
        return attn_lib.decode_attention(p["mixer"], a, h, cache, pos,
                                         window=_resolve_window(spec, cfg))
    if spec.mixer == "mamba":
        return mamba_lib.decode_mamba(p["mixer"], cfg.ssm, h, cache)
    if spec.mixer == "mlstm":
        return xlstm_lib.decode_mlstm(p["mixer"], cfg.ssm, h, cache)
    if spec.mixer == "slstm":
        return xlstm_lib.decode_slstm(p["mixer"], cfg.ssm, h, cache)
    raise ValueError(spec.mixer)


def _decode_block(spec: LayerSpec, cfg: ModelConfig, p, x, cache, pos):
    h = apply_norm(p["ln1"], x, cfg.norm)
    h, new_cache = _decode_mixer(spec, cfg, p, h, cache, pos)
    x = x + h
    if spec.ffn != "none":
        h = apply_norm(p["ln2"], x, cfg.norm)
        if spec.ffn == "dense":
            h = apply_mlp(p["ffn"], h, cfg.act, fused=cfg.fused_qkv)
        else:
            # decode always takes the dense dispatch, as the reference's
            h, _ = moe_lib.apply_moe(p["ffn"], cfg.moe, h,
                                     activation(cfg.act))
        x = x + h
    return x, new_cache


def decode_step(cfg: ModelConfig, params: Params, state: Params,
                token: torch.Tensor, *, layer_mode: str = "scan"
                ) -> Tuple[torch.Tensor, Params]:
    """One token for the whole batch.  token: (B, 1) int.  Returns
    (logits (B, vocab) float32, new state); ``state`` is left as it
    was."""
    _check_layer_mode(layer_mode)
    pos = state["pos"]
    x = embed_tokens(cfg, params, token)
    new_state: Params = {"pos": pos + 1}
    specs = cfg.layer_specs()
    new_state["prefix_blocks"] = []
    for i, bp in enumerate(params["prefix_blocks"]):
        s = LayerSpec(mixer=specs[i].mixer, ffn="dense",
                      window=specs[i].window)
        x, c = _decode_block(s, cfg, bp, x, state["prefix_blocks"][i], pos)
        new_state["prefix_blocks"].append(c)

    n_prefix = cfg.num_dense_prefix
    rep = cfg.pattern_repeat
    new_state["blocks"] = []
    for j, spec in enumerate(cfg.pattern):
        ps = _unstack(params["blocks"][j], rep)
        cs = _unstack(state["blocks"][j], rep)
        if n_prefix and j == 0:
            assert len(cfg.pattern) == 1
        new_cs = cs[:n_prefix] if j == 0 else []
        for r in range(n_prefix if j == 0 else 0, rep):
            x, c = _decode_block(spec, cfg, ps[r], x, cs[r], pos)
            new_cs.append(c)
        new_state["blocks"].append(tree_map(lambda *xs: torch.stack(xs),
                                            *new_cs))
    x = apply_norm(params["final_norm"], x, cfg.norm)
    logits = _head_logits(cfg, params, x[:, 0]).float()
    return logits, new_state
