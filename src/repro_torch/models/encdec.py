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
"""
from __future__ import annotations

import functools
from typing import Any, Dict, Tuple

import torch

from repro_torch.config.base import ModelConfig
from .layers import attention as attn_lib
from .layers.common import (TensorSpec, apply_mlp, apply_norm, dtype_of,
                            mlp_spec, norm_spec)
from .lm import (_check_layer_mode, _head_logits, _remat, _stack, _unstack,
                 chunked_ce_loss, embed_tokens)

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


def _enc_block(cfg, p, x, *, q_chunk):
    h = apply_norm(p["ln1"], x, cfg.norm)
    h = attn_lib.apply_attention(p["self"], cfg.attention, h, causal=False,
                                 q_chunk=q_chunk, impl=cfg.attn_impl)
    x = x + h
    h = apply_norm(p["ln2"], x, cfg.norm)
    return x + apply_mlp(p["ffn"], h, cfg.act)


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
    return x + apply_mlp(p["ffn"], h, cfg.act)


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
    fn = _remat(functools.partial(_enc_block, cfg, q_chunk=q_chunk), remat)
    stack = params["enc_blocks"]
    for bp in _unstack(stack, _n_layers(stack)):
        x = fn(bp, x)
    return apply_norm(params["enc_norm"], x, cfg.norm)


def _decoder(cfg, params, tokens, enc_out, *, remat, q_chunk):
    x = embed_tokens(cfg, params, tokens)
    x = x + _sinusoid(x.shape[1], cfg.d_model, x)
    fn = _remat(functools.partial(_dec_block, cfg, q_chunk=q_chunk), remat)
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
    b = x.shape[0]
    q = (h @ p["cross"]["wq"]).reshape(b, 1, a.num_kv_heads,
                                       a.num_heads // a.num_kv_heads,
                                       a.head_dim)
    o = attn_lib._sdpa(q, cross_c["k"], cross_c["v"], mask=None)
    x = x + o.reshape(b, 1, a.q_dim) @ p["cross"]["wo"]
    h = apply_norm(p["ln2"], x, cfg.norm)
    return x + apply_mlp(p["ffn"], h, cfg.act), new_self


def decode_step(cfg: ModelConfig, params: Params, state: Params,
                token: torch.Tensor, *, layer_mode: str = "scan"
                ) -> Tuple[torch.Tensor, Params]:
    """One decoder token for the whole batch.  token: (B, 1) int.
    Returns (logits (B, vocab) float32, new state); ``state`` is left as
    it was and its cross K/V are carried over."""
    _check_layer_mode(layer_mode)
    pos = state["pos"]
    x = embed_tokens(cfg, params, token)
    # position 0's sinusoid at every step, as the reference's decode
    x = x + _sinusoid(1, cfg.d_model, x)
    n = _n_layers(params["dec_blocks"])
    new_selfs = []
    for bp, sc, cc in zip(_unstack(params["dec_blocks"], n),
                          _unstack(state["self"], n),
                          _unstack(state["cross"], n)):
        x, ns = _dec_block_step(cfg, bp, x, sc, cc, pos)
        new_selfs.append(ns)
    x = apply_norm(params["final_norm"], x, cfg.norm)
    logits = _head_logits(cfg, params, x[:, 0]).float()
    new_self = {k: torch.stack([c[k] for c in new_selfs])
                for k in new_selfs[0]}
    return logits, {"pos": pos + 1, "self": new_self,
                    "cross": state["cross"]}
