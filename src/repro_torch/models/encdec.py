"""Whisper-style encoder-decoder assembly (port of
``repro.models.encdec``).

The audio conv frontend is a stub, as in the reference: the batch
carries precomputed frame embeddings ``frames`` (B, T_enc, feature_dim).
Positions are sinusoidal on both sides, as the reference's are (whisper
learns the decoder's).

Decode caches the decoder's self-attention K/V (full sequence) and the
cross-attention K/V, projected from the encoder's states once
(``prefill_cross``), not at every step.  Two quirks of the reference
are kept: ``decode_step`` adds position 0's sinusoid at every step, so
decode follows the forward only at the first token; and a zero decode
state (``launch.serve``'s) holds zero cross K/V, not an encoded input.

The blocks are stacked over layers (``enc_blocks``, ``dec_blocks``) and
``prefix_blocks`` is empty, so a reference tree bridges leaf for leaf;
the reference's ``layer_mode`` "scan" and "unroll" are one loop here.
In a mesh step the blocks are gathered per layer; self-attention and
cross attention whose heads divide the model axis, the FFNs of both
stacks and the vocabulary split over it (``_split``), in decode too.  The encoder's
blocks and the cross attention take ``wide`` products
(``tensor_parallel``): the encoder's states enter every decoder layer's
cross attention, so a float32 split of theirs rounds as one process
does; the decoder's self-attention and FFN round their parts as the
dense LM's do.
"""
from __future__ import annotations

import functools
from typing import Any, Dict, Tuple

import torch

from repro_torch.config.base import ModelConfig
from repro_torch.sharding import tensor_parallel as tp
from .layers import attention as attn_lib
from .layers.common import (TensorSpec, apply_mlp, apply_norm, dtype_of,
                            mlp_spec, norm_spec)
from .lm import (DECODE_TOP_KEYS, _check_layer_mode, _head_logits, _remat,
                 _stack, _unstack, chunked_ce_loss, decode_logits,
                 embed_tokens, gathering, heads_split)

Params = Dict[str, Any]


@functools.lru_cache(maxsize=16)
def _sinusoid_table(seq: int, d: int, device: str) -> torch.Tensor:
    # computed on the host in float32, so every device adds the same
    # table (a device's pow and sin may round otherwise at ~1e-4 by
    # position 1,500)
    pos = torch.arange(seq, dtype=torch.float32)[:, None]
    i = torch.arange(d // 2, dtype=torch.float32)[None, :]
    angle = pos / torch.pow(torch.tensor(10000.0), 2 * i / d)
    return torch.cat([torch.sin(angle), torch.cos(angle)], dim=-1).to(device)


def _sinusoid(seq: int, d: int, like: torch.Tensor) -> torch.Tensor:
    """(seq, d) sinusoidal positions [sin | cos], float32, cast to
    ``like``'s dtype on its device.  On the meta device (a cost count)
    the table is a constant with no data, as the cached one is on a
    card, made in every step alike and nothing on the host."""
    if like.device.type == "meta":
        table = torch.empty((seq, d), dtype=torch.float32, device="meta")
    else:
        table = _sinusoid_table(seq, d, str(like.device))
    return table.to(like.dtype)


def _enc_block_spec(cfg: ModelConfig, dtype) -> Params:
    return {
        "ln1": norm_spec(cfg.d_model, cfg.norm, dtype),
        "self": attn_lib.attention_spec(cfg.attention, cfg.d_model, dtype),
        "ln2": norm_spec(cfg.d_model, cfg.norm, dtype),
        "ffn": mlp_spec(cfg.d_model, cfg.d_ff, dtype),
    }


def _dec_block_spec(cfg: ModelConfig, dtype) -> Params:
    p = _enc_block_spec(cfg, dtype)
    p["ln_x"] = norm_spec(cfg.d_model, cfg.norm, dtype)
    p["cross"] = attn_lib.cross_attention_spec(cfg.attention, cfg.d_model,
                                               dtype)
    return p


def param_spec(cfg: ModelConfig, *, model_axis: int = 16) -> Params:
    dtype = dtype_of(cfg.dtype)
    enc = cfg.encoder
    return {
        "embed": TensorSpec((cfg.vocab_size, cfg.d_model), dtype),
        "lm_head": TensorSpec((cfg.d_model, cfg.vocab_size), dtype),
        "enc_in": TensorSpec((enc.feature_dim, cfg.d_model), dtype),
        "enc_blocks": _stack(_enc_block_spec(cfg, dtype), enc.num_layers),
        "enc_norm": norm_spec(cfg.d_model, cfg.norm, dtype),
        "dec_blocks": _stack(_dec_block_spec(cfg, dtype), cfg.num_layers),
        "final_norm": norm_spec(cfg.d_model, cfg.norm, dtype),
        # the decoder-only tree's key, empty (the reference's layout)
        "prefix_blocks": [],
    }


# the leaves outside the stacks, gathered once per step over a mesh
TOP_KEYS = ("embed", "lm_head", "enc_in", "enc_norm", "final_norm")


def _enc_block(cfg, p, x, *, q_chunk):
    h = apply_norm(p["ln1"], x, cfg.norm)
    h = attn_lib.apply_attention(p["self"], cfg.attention, h, causal=False,
                                 q_chunk=q_chunk, impl=cfg.attn_impl,
                                 wide=True)
    x = x + h
    h = apply_norm(p["ln2"], x, cfg.norm)
    return x + _mlp(cfg, p, h, wide=True)


def _mlp(cfg, p, h, wide=False):
    return apply_mlp(p["ffn"], h, cfg.act,
                     split=p["ffn"]["w_down"].shape[-2] != cfg.d_ff,
                     wide=wide)


def _dec_block(cfg, p, x, enc_out, *, q_chunk):
    h = apply_norm(p["ln1"], x, cfg.norm)
    h = attn_lib.apply_attention(p["self"], cfg.attention, h, causal=True,
                                 q_chunk=q_chunk, impl=cfg.attn_impl)
    x = x + h
    h = apply_norm(p["ln_x"], x, cfg.norm)
    h = attn_lib.apply_cross_attention(p["cross"], cfg.attention, h,
                                       enc_out, q_chunk=q_chunk,
                                       impl=cfg.attn_impl)
    x = x + h
    h = apply_norm(p["ln2"], x, cfg.norm)
    return x + _mlp(cfg, p, h)


def _n_layers(stack) -> int:
    return stack["ln1"]["g"].shape[0]


def encode(cfg: ModelConfig, params: Params, frames: torch.Tensor, *,
           layer_mode: str = "scan", remat: str = "full",
           q_chunk: int = 512) -> torch.Tensor:
    """frames (B, T, feature_dim) -> the encoder's states (B, T, D):
    ``frames @ enc_in`` + sinusoid, non-causal blocks, ``enc_norm``."""
    _check_layer_mode(layer_mode)
    if cfg.attn_chunk:
        q_chunk = cfg.attn_chunk
    x = frames.to(dtype_of(cfg.dtype)) @ params["enc_in"]
    x = x + _sinusoid(x.shape[1], cfg.d_model, x)
    fn = _remat(gathering(functools.partial(_enc_block, cfg, q_chunk=q_chunk),
                          tp.shardings_of("enc_blocks"), _split(cfg),
                          stacked=True), remat)
    stack = params["enc_blocks"]
    for bp in _unstack(stack, _n_layers(stack)):
        x = fn(bp, x)
    return apply_norm(params["enc_norm"], x, cfg.norm)


def _split(cfg, attention=("self",)):
    """The parts of a block that a mesh step computes split over the
    model axis: the FFN, and the ``attention`` parts where
    ``lm.heads_split``."""
    if heads_split(cfg.attention):
        return attention + ("ffn",)
    return ("ffn",)


def _decoder(cfg, params, tokens, enc_out, *, remat, q_chunk):
    x = embed_tokens(cfg, params, tokens)
    x = x + _sinusoid(x.shape[1], cfg.d_model, x)
    fn = _remat(gathering(functools.partial(_dec_block, cfg, q_chunk=q_chunk),
                          tp.shardings_of("dec_blocks"),
                          _split(cfg, ("self", "cross")),
                          stacked=True), remat)
    stack = params["dec_blocks"]
    for bp in _unstack(stack, _n_layers(stack)):
        x = fn(bp, x, enc_out)
    return apply_norm(params["final_norm"], x, cfg.norm)


def encdec_loss(cfg: ModelConfig, params: Params, batch, *,
                layer_mode: str = "scan", remat: str = "full",
                q_chunk: int = 512
                ) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
    """Mean CE of the decoder over ``tokens`` / ``labels``, attending to
    ``encode(frames)``; the aux loss is 0."""
    if cfg.attn_chunk:
        q_chunk = cfg.attn_chunk
    params = tp.gather_top(params, TOP_KEYS, split=("embed", "lm_head"))
    enc_out = encode(cfg, params, batch["frames"], layer_mode=layer_mode,
                     remat=remat, q_chunk=q_chunk)
    x = _decoder(cfg, params, batch["tokens"], enc_out, remat=remat,
                 q_chunk=q_chunk)
    ce = chunked_ce_loss(cfg, params, x, batch["labels"])
    return ce, {"ce": ce, "moe_aux": torch.zeros((), dtype=torch.float32,
                                                 device=ce.device)}


def prefill_logits(cfg: ModelConfig, params: Params, tokens: torch.Tensor,
                   enc_out: torch.Tensor, *,
                   q_chunk: int = 512) -> torch.Tensor:
    """The decoder's forward up to the head over ``tokens`` against
    ``enc_out``: float32 logits (B, S, V) at every position."""
    if cfg.attn_chunk:
        q_chunk = cfg.attn_chunk
    x = _decoder(cfg, params, tokens, enc_out, remat="none", q_chunk=q_chunk)
    return _head_logits(cfg, params, x).float()


# ---------------------------------------------------------------------------
# Decode


def decode_state_spec(cfg: ModelConfig, batch: int, seq: int) -> Params:
    """``pos``, the decoder's self-attention cache over ``seq`` tokens
    and the cross K/V over the encoder's ``seq_len`` frames, stacked
    over the decoder's layers."""
    dtype = dtype_of(cfg.dtype)
    a = cfg.attention
    kv = TensorSpec((batch, cfg.encoder.seq_len, a.num_kv_heads,
                     a.head_dim), dtype)
    return {
        "pos": TensorSpec((), torch.int32),
        "self": _stack(attn_lib.cache_spec(a, batch, seq, 0, dtype),
                       cfg.num_layers),
        "cross": _stack({"k": kv, "v": kv}, cfg.num_layers),
    }


def prefill_cross(cfg: ModelConfig, params: Params,
                  enc_out: torch.Tensor) -> Params:
    """Project the encoder's states into each decoder layer's cross K/V
    once: {"k", "v"} of (L, B, T, KV, hd)."""
    a = cfg.attention
    b, t, _ = enc_out.shape
    stack = params["dec_blocks"]
    ks, vs = [], []
    for bp in _unstack(stack, _n_layers(stack)):
        ks.append((enc_out @ bp["cross"]["wk"]).reshape(
            b, t, a.num_kv_heads, a.head_dim))
        vs.append((enc_out @ bp["cross"]["wv"]).reshape(
            b, t, a.num_kv_heads, a.head_dim))
    return {"k": torch.stack(ks), "v": torch.stack(vs)}


def _dec_block_step(cfg, p, x, self_c, cross_c, pos):
    a = cfg.attention
    h = apply_norm(p["ln1"], x, cfg.norm)
    h, new_self = attn_lib.decode_attention(p["self"], a, h, self_c, pos)
    x = x + h
    h = apply_norm(p["ln_x"], x, cfg.norm)
    x = x + attn_lib.decode_cross_attention(p["cross"], a, h, cross_c)
    h = apply_norm(p["ln2"], x, cfg.norm)
    return x + _mlp(cfg, p, h), new_self


def decode_step(cfg: ModelConfig, params: Params, state: Params,
                token: torch.Tensor, *, layer_mode: str = "scan"
                ) -> Tuple[torch.Tensor, Params]:
    """One decoder token for the whole batch.  token: (B, 1) int.
    Returns (logits (B, vocab) float32, new state); ``state`` is left as
    it was and its cross K/V are carried over.  In a mesh step each
    decoder block is gathered before it, its self and cross attention
    (where ``lm.heads_split``) and its FFN kept as the rank's model
    block; ``cache_partition`` leaves both caches whole over the model
    axis (their stacked leaves sit outside "blocks"), so the rank's
    query heads read their kv heads from them."""
    _check_layer_mode(layer_mode)
    pos = state["pos"]
    params = tp.gather_top(params, DECODE_TOP_KEYS,
                           split=("embed", "lm_head"))
    x = embed_tokens(cfg, params, token)
    # position 0's sinusoid at every step, as the reference's decode
    x = x + _sinusoid(1, cfg.d_model, x)
    n = _n_layers(params["dec_blocks"])
    fn = gathering(functools.partial(_dec_block_step, cfg),
                   tp.shardings_of("dec_blocks"),
                   _split(cfg, ("self", "cross")), stacked=True)
    # each layer's new cache copied into its slot as it comes
    new_self = {k: torch.empty_like(t) for k, t in state["self"].items()}
    for i, (bp, sc, cc) in enumerate(zip(_unstack(params["dec_blocks"], n),
                                         _unstack(state["self"], n),
                                         _unstack(state["cross"], n))):
        x, ns = fn(bp, x, sc, cc, pos)
        for k, t in ns.items():
            new_self[k][i].copy_(t)
        del ns
    x = apply_norm(params["final_norm"], x, cfg.norm)
    logits = decode_logits(cfg, params, x[:, 0])
    return logits, {"pos": pos + 1, "self": new_self,
                    "cross": state["cross"]}
