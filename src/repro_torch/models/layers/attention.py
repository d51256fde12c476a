"""Grouped-query attention with query chunking, sliding windows, a
two-level flash attention, ring-buffer KV caches and cross-attention
(whisper) (port of ``repro.models.layers.attention``).

Every path is the reference's algorithm in plain PyTorch, tile for
tile: the scores and the softmax in float32, masked entries at
``NEG_INF``.  ``scaled_dot_product_attention`` is not called, so the
parity tests hold the port to the reference's own arithmetic.

  * Prefill attention is chunked over query blocks (one-level chunking
    with a full-row stable softmax); sliding-window layers attend over a
    band of KV per query chunk.
  * ``flash_attention`` is the online softmax over KV tiles with a
    tile-recomputing backward (``torch.autograd.Function``, the
    reference's custom VJP): only (out, lse) are saved.
  * Decode keeps a ring buffer of size ``window`` for local layers.
  * Cross-attention attends, without a mask, from the decoder's
    queries to the encoder's states, chunked over the queries.
"""
from __future__ import annotations

from typing import Dict, Optional

import numpy as np
import torch

from repro_torch.config.base import AttentionConfig
from .common import TensorSpec, sequential_loop
from .rope import apply_mrope, apply_rope

Params = Dict[str, torch.Tensor]

NEG_INF = -2.0 ** 30


def _scale(d: int) -> float:
    """1 / sqrt(d) as the reference rounds it: float32 sqrt, float32
    division."""
    return float(np.float32(1.0) / np.sqrt(np.float32(d)))


def repeat_kv(k: torch.Tensor, n_rep: int) -> torch.Tensor:
    """(B, T, KV, D) -> (B, T, KV*n_rep, D), kv-major."""
    if n_rep == 1:
        return k
    b, t, kv, d = k.shape
    k = k[:, :, :, None, :].expand(b, t, kv, n_rep, d)
    return k.reshape(b, t, kv * n_rep, d)


# ---------------------------------------------------------------------------
# Params


def attention_spec(cfg: AttentionConfig, d_model: int, dtype) -> Params:
    return {
        "wq": TensorSpec((d_model, cfg.q_dim), dtype),
        "wk": TensorSpec((d_model, cfg.kv_dim), dtype),
        "wv": TensorSpec((d_model, cfg.kv_dim), dtype),
        "wo": TensorSpec((cfg.q_dim, d_model), dtype),
    }


def cross_attention_spec(cfg: AttentionConfig, d_model: int,
                         dtype) -> Params:
    return attention_spec(cfg, d_model, dtype)


# ---------------------------------------------------------------------------
# Core grouped scaled-dot-product with banding


def _sdpa(q, k, v, *, mask) -> torch.Tensor:
    """q: (B, Lq, KV, G, D); k/v: (B, Lk, KV, D); mask: (B?, Lq, Lk)
    bool or None.  Returns (B, Lq, KV, G, D).  Softmax in fp32."""
    scores = torch.einsum("bqkgd,btkd->bkgqt", q, k).float() \
        * _scale(q.shape[-1])
    if mask is not None:
        while mask.ndim < scores.ndim:
            mask = mask[:, None]
        scores = torch.where(mask, scores, NEG_INF)
    w = torch.softmax(scores, dim=-1).to(q.dtype)
    return torch.einsum("bkgqt,btkd->bqkgd", w, v)


def _build_mask(s, t, *, causal, window, q_offset, device):
    if not causal and window <= 0:
        return None
    rows = q_offset + torch.arange(s, device=device)
    cols = torch.arange(t, device=device)
    return _tile_mask(rows, cols, causal, window)[None]


def chunked_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                      *, causal: bool, window: int = 0, q_chunk: int = 512,
                      q_offset: int = 0) -> torch.Tensor:
    """Attention chunked over query blocks.  q: (B, S, H, D); k/v:
    (B, T, KV, D).  For windowed (local) layers with self-attention
    (T == S and causal), only the KV band [chunk_start - window,
    chunk_end) is touched per q-chunk."""
    b, s, h, d = q.shape
    t = k.shape[1]
    kv = k.shape[2]
    dv = v.shape[-1]
    g = h // kv
    qg = q.reshape(b, s, kv, g, d)

    if s % q_chunk != 0:
        # the largest divisor of s not exceeding q_chunk
        q_chunk = next((c for c in range(q_chunk, 0, -1) if s % c == 0), s)
    if s <= q_chunk:
        mask = _build_mask(s, t, causal=causal, window=window,
                           q_offset=q_offset, device=q.device)
        return _sdpa(qg, k, v, mask=mask).reshape(b, s, h, dv)

    nchunk = s // q_chunk
    banded = window > 0 and causal and t == s and q_offset == 0
    if banded:
        # Band size: window rounded up to q_chunk + the chunk itself.
        band = ((window + q_chunk - 1) // q_chunk) * q_chunk + q_chunk
        if band > t:
            raise ValueError(f"window band {band} exceeds {t} keys")
    ar_q = torch.arange(q_chunk, device=q.device)
    outs = []
    with sequential_loop("attn_q_chunks", nchunk) as steps:
        qcs = steps.pieces(qg, 1, q_chunk)
        for ci in steps:
            start = ci * q_chunk
            qc = qcs[ci]
            if banded:
                kstart = max(start + q_chunk - band, 0)
                kc = k[:, kstart:kstart + band]
                vc = v[:, kstart:kstart + band]
                rows = start + ar_q
                cols = kstart + torch.arange(band, device=q.device)
                m = (cols[None, :] <= rows[:, None]) & (
                    cols[None, :] > rows[:, None] - window)
                outs.append(_sdpa(qc, kc, vc, mask=m[None]))
            else:
                rows = q_offset + start + ar_q
                cols = torch.arange(t, device=q.device)
                m = _tile_mask(rows, cols, causal, window)
                outs.append(_sdpa(qc, k, v, mask=m[None]))
    return steps.join(outs, 1, stack=False).reshape(b, s, h, dv)


def _pick_chunk(n: int, chunk: int) -> int:
    if n % chunk == 0:
        return chunk
    return next((c for c in range(chunk, 0, -1) if n % c == 0), n)


def _tile_mask(rows, cols, causal, window):
    m = torch.ones((rows.shape[0], cols.shape[0]), dtype=torch.bool,
                   device=rows.device)
    if causal:
        m &= cols[None, :] <= rows[:, None]
    if window > 0:
        m &= cols[None, :] > rows[:, None] - window
    return m


# ---------------------------------------------------------------------------
# Two-level flash attention


def _flash_fwd_lse(q, k, v, causal, window, q_chunk, kv_chunk, q_offset):
    """Online softmax over KV tiles -> (out (B, S, H, Dv), lse (B, H, S)
    float32)."""
    b, s, h, d = q.shape
    dv = v.shape[-1]
    t = k.shape[1]
    q_chunk = _pick_chunk(s, q_chunk)
    kv_chunk = _pick_chunk(t, kv_chunk)
    nq, nk = s // q_chunk, t // kv_chunk
    scale = _scale(d)
    dev = q.device
    f32 = dict(dtype=torch.float32, device=dev)
    outs, lses = [], []
    for qi in range(nq):
        qc = q[:, qi * q_chunk:(qi + 1) * q_chunk]
        rows = q_offset + qi * q_chunk + torch.arange(q_chunk, device=dev)
        m_run = torch.full((b, h, q_chunk), NEG_INF, **f32)
        l_run = torch.zeros((b, h, q_chunk), **f32)
        acc = torch.zeros((b, q_chunk, h, dv), **f32)
        for ki in range(nk):
            kc = k[:, ki * kv_chunk:(ki + 1) * kv_chunk]
            vc = v[:, ki * kv_chunk:(ki + 1) * kv_chunk]
            cols = ki * kv_chunk + torch.arange(kv_chunk, device=dev)
            sc = torch.einsum("bqhd,bthd->bhqt", qc, kc).float() * scale
            msk = _tile_mask(rows, cols, causal, window)
            sc = torch.where(msk[None, None], sc, NEG_INF)
            m_new = torch.maximum(m_run, sc.amax(dim=-1))
            p = torch.exp(sc - m_new[..., None])
            corr = torch.exp(m_run - m_new)
            l_run = l_run * corr + p.sum(dim=-1)
            pv = torch.einsum("bhqt,bthd->bqhd", p.to(qc.dtype), vc)
            acc = acc * corr.transpose(1, 2)[..., None].to(acc.dtype) \
                + pv.float()
            m_run = m_new
        out = acc / torch.clamp(l_run, min=1e-30).transpose(1, 2)[..., None]
        lses.append(m_run + torch.log(torch.clamp(l_run, min=1e-30)))
        outs.append(out.to(q.dtype))
    return torch.cat(outs, dim=1), torch.cat(lses, dim=-1)


def _flash_bwd(q, k, v, out, lse, dout, causal, window, q_chunk, kv_chunk,
               q_offset):
    """Tile-recomputing backward: one pass for dq (outer loop over q
    tiles), one for dk/dv (outer over kv tiles); tile-sized float32
    accumulators."""
    b, s, h, d = q.shape
    dv_dim = v.shape[-1]
    t = k.shape[1]
    q_chunk = _pick_chunk(s, q_chunk)
    kv_chunk = _pick_chunk(t, kv_chunk)
    nq, nk = s // q_chunk, t // kv_chunk
    scale = _scale(d)
    dev = q.device
    delta = torch.sum(dout.float() * out.float(), dim=-1)  # (B, S, H)

    def q_tile(qi):
        sl = slice(qi * q_chunk, (qi + 1) * q_chunk)
        return (q[:, sl], dout[:, sl], lse[:, :, sl],
                delta[:, sl].transpose(1, 2),
                q_offset + qi * q_chunk + torch.arange(q_chunk, device=dev))

    def kv_tile(ki):
        sl = slice(ki * kv_chunk, (ki + 1) * kv_chunk)
        return (k[:, sl], v[:, sl],
                ki * kv_chunk + torch.arange(kv_chunk, device=dev))

    def p_tile(qc, kc, lse_c, rows, cols):
        sc = torch.einsum("bqhd,bthd->bhqt", qc, kc).float() * scale
        msk = _tile_mask(rows, cols, causal, window)
        sc = torch.where(msk[None, None], sc, NEG_INF)
        return torch.exp(sc - lse_c[..., None])  # (B, H, cq, ct)

    # pass 1: dq, outer over q tiles
    dqs = []
    for qi in range(nq):
        qc, do_c, lse_c, dl_c, rows = q_tile(qi)
        acc = torch.zeros((b, q_chunk, h, d), dtype=torch.float32,
                          device=dev)
        for ki in range(nk):
            kc, vc, cols = kv_tile(ki)
            p = p_tile(qc, kc, lse_c, rows, cols)
            dp = torch.einsum("bqhd,bthd->bhqt", do_c, vc).float()
            ds = p * (dp - dl_c[..., None])
            acc = acc + torch.einsum("bhqt,bthd->bqhd", ds.to(qc.dtype),
                                     kc).float() * scale
        dqs.append(acc.to(q.dtype))

    # pass 2: dk/dv, outer over kv tiles
    dks, dvs = [], []
    for ki in range(nk):
        kc, vc, cols = kv_tile(ki)
        dk_c = torch.zeros((b, kv_chunk, h, d), dtype=torch.float32,
                           device=dev)
        dv_c = torch.zeros((b, kv_chunk, h, dv_dim), dtype=torch.float32,
                           device=dev)
        for qi in range(nq):
            qc, do_c, lse_c, dl_c, rows = q_tile(qi)
            p = p_tile(qc, kc, lse_c, rows, cols)
            dv_c = dv_c + torch.einsum("bhqt,bqhd->bthd", p.to(qc.dtype),
                                       do_c).float()
            dp = torch.einsum("bqhd,bthd->bhqt", do_c, vc).float()
            ds = p * (dp - dl_c[..., None])
            dk_c = dk_c + torch.einsum("bhqt,bqhd->bthd", ds.to(qc.dtype),
                                       qc).float() * scale
        dks.append(dk_c.to(k.dtype))
        dvs.append(dv_c.to(v.dtype))
    return (torch.cat(dqs, dim=1), torch.cat(dks, dim=1),
            torch.cat(dvs, dim=1))


class _FlashCore(torch.autograd.Function):
    """Flash attention with the reference's custom VJP: the forward
    saves (q, k, v, out, lse), the backward recomputes tiles."""

    @staticmethod
    def forward(ctx, q, k, v, causal, window, q_chunk, kv_chunk, q_offset):
        out, lse = _flash_fwd_lse(q, k, v, causal, window, q_chunk,
                                  kv_chunk, q_offset)
        ctx.save_for_backward(q, k, v, out, lse)
        ctx.args = (causal, window, q_chunk, kv_chunk, q_offset)
        return out

    @staticmethod
    def backward(ctx, dout):
        q, k, v, out, lse = ctx.saved_tensors
        dq, dk, dv = _flash_bwd(q, k, v, out, lse, dout.contiguous(),
                                *ctx.args)
        return dq, dk, dv, None, None, None, None, None


def flash_attention(q, k, v, *, causal=True, window=0, q_chunk=512,
                    kv_chunk=512, q_offset=0):
    """Two-level flash attention.  q: (B, S, H, D); k/v: (B, T, H, D)
    (KV already repeated to H heads)."""
    return _FlashCore.apply(q, k, v, causal, window, q_chunk, kv_chunk,
                            q_offset)


# ---------------------------------------------------------------------------
# Full block: projections + rope + attention


def _tile_kv_weight(w: torch.Tensor, kv: int, rep: int) -> torch.Tensor:
    """(D, KV*hd) -> (D, KV*rep*hd): repeat each kv head's columns so
    the projection directly produces full-head outputs (kv-major order,
    matching repeat_kv)."""
    d = w.shape[0]
    hd = w.shape[1] // kv
    w = w.reshape(d, kv, 1, hd).expand(d, kv, rep, hd)
    return w.reshape(d, kv * rep * hd)


def _rope_qk(cfg, q, k, positions, b, s):
    if cfg.rope_kind == "none":
        return q, k
    if positions is None:
        positions = torch.arange(s, dtype=torch.int32,
                                 device=q.device).expand(b, s)
        if cfg.rope_kind == "mrope":
            positions = positions[..., None].expand(b, s, 3)
    if cfg.rope_kind == "mrope":
        return (apply_mrope(q, positions, cfg.rope_theta,
                            cfg.mrope_sections),
                apply_mrope(k, positions, cfg.rope_theta,
                            cfg.mrope_sections))
    return (apply_rope(q, positions, cfg.rope_theta),
            apply_rope(k, positions, cfg.rope_theta))


def apply_attention(p: Params, cfg: AttentionConfig, x: torch.Tensor, *,
                    causal: bool = True, window: int = 0,
                    positions: Optional[torch.Tensor] = None,
                    q_chunk: int = 512, impl: str = "chunked",
                    fused_qkv: bool = False) -> torch.Tensor:
    """x: (B, S, D) -> (B, S, D)."""
    b, s, _ = x.shape
    hd = cfg.head_dim
    rep = cfg.num_heads // cfg.num_kv_heads
    h = cfg.num_heads
    if fused_qkv:
        wk = _tile_kv_weight(p["wk"], cfg.num_kv_heads, rep)
        wv = _tile_kv_weight(p["wv"], cfg.num_kv_heads, rep)
        wqkv = torch.cat([p["wq"], wk, wv], dim=1)
        qkv = (x @ wqkv).reshape(b, s, 3, h, hd)
        q, k, v = qkv[:, :, 0], qkv[:, :, 1], qkv[:, :, 2]
        q, k = _rope_qk(cfg, q, k, positions, b, s)
    else:
        q = (x @ p["wq"]).reshape(b, s, cfg.num_heads, hd)
        k = (x @ p["wk"]).reshape(b, s, cfg.num_kv_heads, hd)
        v = (x @ p["wv"]).reshape(b, s, cfg.num_kv_heads, hd)
        q, k = _rope_qk(cfg, q, k, positions, b, s)
        k = repeat_kv(k, rep)
        v = repeat_kv(v, rep)
    if impl == "flash":
        o = flash_attention(q, k, v, causal=causal, window=window,
                            q_chunk=q_chunk, kv_chunk=q_chunk)
    else:
        o = chunked_attention(q, k, v, causal=causal, window=window,
                              q_chunk=q_chunk)
    return o.reshape(b, s, cfg.q_dim) @ p["wo"]


def apply_cross_attention(p: Params, cfg: AttentionConfig,
                          x: torch.Tensor, enc: torch.Tensor, *,
                          q_chunk: int = 512,
                          impl: str = "chunked") -> torch.Tensor:
    """Non-causal attention from the decoder's states x (B, S, D) to the
    encoder's enc (B, T, D), KV heads repeated to the query heads, no
    position embedding; -> (B, S, D)."""
    b, s, _ = x.shape
    t = enc.shape[1]
    hd = cfg.head_dim
    q = (x @ p["wq"]).reshape(b, s, cfg.num_heads, hd)
    k = (enc @ p["wk"]).reshape(b, t, cfg.num_kv_heads, hd)
    v = (enc @ p["wv"]).reshape(b, t, cfg.num_kv_heads, hd)
    rep = cfg.num_heads // cfg.num_kv_heads
    k, v = repeat_kv(k, rep), repeat_kv(v, rep)
    if impl == "flash":
        o = flash_attention(q, k, v, causal=False, q_chunk=q_chunk,
                            kv_chunk=q_chunk)
    else:
        o = chunked_attention(q, k, v, causal=False, q_chunk=q_chunk)
    return o.reshape(b, s, cfg.q_dim) @ p["wo"]


# ---------------------------------------------------------------------------
# Decode with KV cache (ring buffer for windowed layers)


def cache_spec(cfg: AttentionConfig, batch: int, seq: int, window: int,
               dtype) -> Params:
    """Cache for one layer. Windowed layers keep a ring of size
    ``window``."""
    t = window if window > 0 else seq
    kshape = (batch, t, cfg.num_kv_heads, cfg.head_dim)
    return {"k": TensorSpec(kshape, dtype), "v": TensorSpec(kshape, dtype)}


def decode_attention(p: Params, cfg: AttentionConfig, x: torch.Tensor,
                     cache: Params, pos: torch.Tensor, *, window: int = 0):
    """One decode step: write the new KV at ``pos`` (mod window for
    local layers), attend over the cache.  x: (B, 1, D); cache k/v:
    (B, T, KV, hd); pos: int32 scalar tensor.  Returns (out (B, 1, D),
    new cache); the old cache is left as it was."""
    b = x.shape[0]
    hd = cfg.head_dim
    q = (x @ p["wq"]).reshape(b, 1, cfg.num_heads, hd)
    k = (x @ p["wk"]).reshape(b, 1, cfg.num_kv_heads, hd)
    v = (x @ p["wv"]).reshape(b, 1, cfg.num_kv_heads, hd)
    posb = pos.to(torch.int32).reshape(1, 1).expand(b, 1)
    if cfg.rope_kind == "mrope":
        # one position for all three sections (text-only decode)
        posb = posb[..., None].expand(b, 1, 3)
    q, k = _rope_qk(cfg, q, k, posb, b, 1)

    t = cache["k"].shape[1]
    slot = pos % t if window > 0 else pos
    # an update slice's start is clamped to fit, as the reference's
    slot = torch.clamp(slot, 0, t - 1).reshape(1).long()
    ck = cache["k"].index_copy(1, slot, k.to(cache["k"].dtype))
    cv = cache["v"].index_copy(1, slot, v.to(cache["v"].dtype))

    kv = cfg.num_kv_heads
    g = cfg.num_heads // kv
    qg = q.reshape(b, 1, kv, g, hd)
    cols = torch.arange(t, device=x.device)
    if window > 0:
        # Ring buffer: slot i holds the largest position p <= pos with
        # p % t == i; since t == window every written slot is in the
        # window, and before the first wrap some slots are unwritten.
        valid = (cols <= pos) | (pos >= t)
        mask = valid[None, :]
    else:
        mask = (cols <= pos)[None, :]
    out = _sdpa(qg, ck, cv, mask=mask)
    out = out.reshape(b, 1, cfg.q_dim) @ p["wo"]
    return out, {"k": ck, "v": cv}
