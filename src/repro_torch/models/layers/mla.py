"""Multi-head latent attention (DeepSeek-V2; port of
``repro.models.layers.mla``).

Training and prefill run the *expanded* form: K and V are decompressed
from the latent ``c_kv`` and attended with the query-chunked (or flash)
attention of ``attention.py``, the shared rope key broadcast over the
heads.  Decode runs the *absorbed* form: the query is projected into
the latent space (``w_uk`` folded into it) and ``w_uv`` is applied after
the latent mix, so the cache holds only ``kv_lora_rank + rope_head_dim``
values per token (512 + 64 for DeepSeek-V2-Lite, against 2 x 16 x 128
for the expanded K/V).
"""
from __future__ import annotations

from typing import Dict

import torch

from repro_torch.config.base import AttentionConfig
from .attention import NEG_INF, _scale, chunked_attention, flash_attention
from .common import TensorSpec
from .rope import apply_rope

Params = Dict[str, torch.Tensor]


def mla_spec(cfg: AttentionConfig, d_model: int, dtype) -> Params:
    h, dn, dr = cfg.num_heads, cfg.nope_head_dim, cfg.rope_head_dim
    r = cfg.kv_lora_rank
    return {
        # queries (lite variant: no q compression)
        "wq": TensorSpec((d_model, h * (dn + dr)), dtype),
        # kv compression
        "w_dkv": TensorSpec((d_model, r), dtype),
        "w_kr": TensorSpec((d_model, dr), dtype),
        # decompression
        "w_uk": TensorSpec((r, h * dn), dtype),
        "w_uv": TensorSpec((r, h * dn), dtype),
        "wo": TensorSpec((h * dn, d_model), dtype),
    }


def apply_mla(p: Params, cfg: AttentionConfig, x: torch.Tensor, *,
              q_chunk: int = 512, impl: str = "chunked") -> torch.Tensor:
    """Expanded-form causal MLA.  x: (B, S, D) -> (B, S, D)."""
    b, s, _ = x.shape
    h, dn, dr = cfg.num_heads, cfg.nope_head_dim, cfg.rope_head_dim
    pos = torch.arange(s, dtype=torch.int32, device=x.device).expand(b, s)

    q = (x @ p["wq"]).reshape(b, s, h, dn + dr)
    qn, qr = q[..., :dn], q[..., dn:]
    qr = apply_rope(qr, pos, cfg.rope_theta)

    c_kv = x @ p["w_dkv"]                                      # (B, S, r)
    kr = apply_rope((x @ p["w_kr"]).reshape(b, s, 1, dr), pos,
                    cfg.rope_theta)
    kn = (c_kv @ p["w_uk"]).reshape(b, s, h, dn)
    v = (c_kv @ p["w_uv"]).reshape(b, s, h, dn)

    # nope and rope parts side by side; the shared rope key over heads
    qf = torch.cat([qn, qr], dim=-1)                           # (B,S,H,dn+dr)
    kf = torch.cat([kn, kr.expand(b, s, h, dr)], dim=-1)
    if impl == "flash":
        o = flash_attention(qf, kf, v, causal=True, q_chunk=q_chunk,
                            kv_chunk=q_chunk)
    else:
        o = chunked_attention(qf, kf, v, causal=True, q_chunk=q_chunk)
    return o.reshape(b, s, h * dn) @ p["wo"]


def mla_cache_spec(cfg: AttentionConfig, batch: int, seq: int,
                   dtype) -> Params:
    return {
        "c_kv": TensorSpec((batch, seq, cfg.kv_lora_rank), dtype),
        "k_rope": TensorSpec((batch, seq, cfg.rope_head_dim), dtype),
    }


def decode_mla(p: Params, cfg: AttentionConfig, x: torch.Tensor,
               cache: Params, pos: torch.Tensor):
    """Absorbed-form decode of one token.  x: (B, 1, D); cache
    ``c_kv`` (B, T, r), ``k_rope`` (B, T, dr); pos: int32 scalar
    tensor.  Returns (out (B, 1, D), new cache); the old cache is left
    as it was."""
    b = x.shape[0]
    h, dn, dr = cfg.num_heads, cfg.nope_head_dim, cfg.rope_head_dim
    r = cfg.kv_lora_rank
    posb = pos.to(torch.int32).reshape(1, 1).expand(b, 1)

    q = (x @ p["wq"]).reshape(b, 1, h, dn + dr)
    qn, qr = q[..., :dn], q[..., dn:]
    qr = apply_rope(qr, posb, cfg.rope_theta)
    # absorb w_uk into the query: q_lat[h] = qn[h] @ w_uk[:, h]^T
    wuk = p["w_uk"].reshape(r, h, dn)
    q_lat = torch.einsum("bqhd,rhd->bqhr", qn, wuk)            # (B,1,H,r)

    c_new = x @ p["w_dkv"]                                     # (B, 1, r)
    kr_new = apply_rope((x @ p["w_kr"]).reshape(b, 1, 1, dr), posb,
                        cfg.rope_theta).reshape(b, 1, dr)

    t = cache["c_kv"].shape[1]
    # an update slice's start is clamped to fit, as the reference's
    slot = torch.clamp(pos, 0, t - 1).reshape(1).long()
    c_kv = cache["c_kv"].index_copy(1, slot, c_new.to(cache["c_kv"].dtype))
    k_rope = cache["k_rope"].index_copy(1, slot,
                                        kr_new.to(cache["k_rope"].dtype))

    scores = (torch.einsum("bqhr,btr->bhqt", q_lat, c_kv)
              + torch.einsum("bqhd,btd->bhqt", qr, k_rope)).float() \
        * _scale(dn + dr)
    mask = (torch.arange(t, device=x.device) <= pos)[None, None, None, :]
    scores = torch.where(mask, scores, NEG_INF)
    w = torch.softmax(scores, dim=-1).to(x.dtype)
    o_lat = torch.einsum("bhqt,btr->bqhr", w, c_kv)            # (B,1,H,r)
    wuv = p["w_uv"].reshape(r, h, dn)
    o = torch.einsum("bqhr,rhd->bqhd", o_lat, wuv).reshape(b, 1, h * dn)
    return o @ p["wo"], {"c_kv": c_kv, "k_rope": k_rope}
