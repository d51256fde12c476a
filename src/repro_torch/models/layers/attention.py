"""Grouped-query attention with query chunking, sliding windows, a
two-level flash attention, ring-buffer KV caches and cross-attention
(whisper) (port of ``repro.models.layers.attention``).

Every path is the reference's algorithm in plain PyTorch, tile for
tile: the scores and the softmax in float32, masked entries at
``NEG_INF``.  ``scaled_dot_product_attention`` is not called, so the
parity tests hold the port to the reference's own arithmetic.

  * Prefill attention is chunked over query blocks (one-level chunking
    with a full-row stable softmax); sliding-window layers attend over a
    band of KV per query chunk, the bands cut from the keys once
    (``unfold``), so the backward adds their gradients into one tensor
    of the keys, not one per chunk.
  * In a step that splits the model axis a layer given its model block
    of the weights computes this rank's query heads: ``wq``/``wk``/``wv``
    by columns, ``wo`` by rows, the output summed over the model ranks;
    kv heads that the axis does not divide (``wk``/``wv`` split across
    ``head_dim``) are gathered from their owners, the rank's query heads'
    kept, and their gradient summed back.
  * ``flash_attention`` is the online softmax over KV tiles with a
    tile-recomputing backward (``torch.autograd.Function``, the
    reference's custom VJP): only (out, lse) are saved.
  * Decode keeps a ring buffer of size ``window`` for local layers.
    Over the model axis it splits as prefill does, its cache as
    ``cache_partition`` lays it out: by kv heads, by head_dim (the
    scores' parts summed over the axis) or whole.
  * Cross-attention attends, without a mask, from the decoder's
    queries to the encoder's states, chunked over the queries; it splits
    over the model axis as self-attention does, the encoder's states
    entering the rank's column split beside the decoder's.
  * ``wide`` (whisper's encoder; cross attention always): the
    projections take ``tp.wide`` operands, split or not, so that a
    float32 layer's split rounds as one process does (q, k and v
    rounded to the layer's dtype after rope and the kv repeat, the
    output after the sum over the model ranks).
"""
from __future__ import annotations

from typing import Dict, Optional

import numpy as np
import torch

from repro_torch.config.base import AttentionConfig
from repro_torch.sharding import tensor_parallel as tp
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
        if banded:
            # every band, cut once: band w holds keys [w * q_chunk,
            # w * q_chunk + band), (B, KV, D, band) each
            kbs = steps.pieces(k.unfold(1, band, q_chunk), 1)
            vbs = steps.pieces(v.unfold(1, band, q_chunk), 1)
            lead = band // q_chunk - 1
        for ci in steps:
            start = ci * q_chunk
            qc = qcs[ci]
            if banded:
                kstart = max(start + q_chunk - band, 0)
                w = max(ci - lead, 0)
                kc = kbs[w].permute(0, 3, 1, 2)
                vc = vbs[w].permute(0, 3, 1, 2)
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


def _kv_runs(first_q: int, n_q: int, rep: int):
    """[(kv head, query heads on it), ...] of query heads first_q ..
    first_q + n_q - 1 in order (query head i reads kv head i // rep)."""
    runs = []
    for i in range(first_q, first_q + n_q):
        if runs and runs[-1][0] == i // rep:
            runs[-1][1] += 1
        else:
            runs.append([i // rep, 1])
    return runs


def _split_qkv(p: Params, cfg: AttentionConfig, x: torch.Tensor,
               positions, fused_qkv: bool, enc: Optional[torch.Tensor] = None):
    """This rank's query heads' q, k, v (B, S, H / model, hd), roped,
    k and v repeated to the query heads, from its model block of the
    weights.  ``enc``: cross attention's, keys and values projected from
    it (B, T, D), with no position embedding.  The weights take ``x``'s
    dtype (a wide ``x``: ``apply_attention``'s ``wide``)."""
    b, s, _ = x.shape
    hd = cfg.head_dim
    m, r = tp.model_size(), tp.model_rank()
    h_l = cfg.num_heads // m
    kv = cfg.num_kv_heads
    rep = cfg.num_heads // kv
    p = {k: p[k].to(x.dtype) for k in ("wq", "wk", "wv")}
    x = tp.copy_to_model(x)
    src = x if enc is None else tp.copy_to_model(enc)
    t = src.shape[1]

    def rope(q, k):
        if enc is not None:
            return q, k
        return _rope_qk(cfg, q, k, positions, b, s)

    if kv % m == 0:
        # the rank's kv heads are those its query heads read
        kv_l = kv // m
        if fused_qkv:
            wqkv = torch.cat([p["wq"], _tile_kv_weight(p["wk"], kv_l, rep),
                              _tile_kv_weight(p["wv"], kv_l, rep)], dim=1)
            qkv = (x @ wqkv).reshape(b, s, 3, h_l, hd)
            q, k, v = qkv[:, :, 0], qkv[:, :, 1], qkv[:, :, 2]
            return (*rope(q, k), v)
        q = (x @ p["wq"]).reshape(b, s, h_l, hd)
        k = (src @ p["wk"]).reshape(b, t, kv_l, hd)
        v = (src @ p["wv"]).reshape(b, t, kv_l, hd)
        q, k = rope(q, k)
        return q, repeat_kv(k, rep), repeat_kv(v, rep)
    # wk / wv split across head_dim: every rank's columns gathered, the
    # kv heads of this rank's query heads kept (the backward sums their
    # gradient over the ranks, each of which keeps its columns)
    runs = _kv_runs(r * h_l, h_l, rep)
    first, n = runs[0][0], runs[-1][0] - runs[0][0] + 1
    q = (x @ p["wq"]).reshape(b, s, h_l, hd)

    def heads(w):
        y = tp.gather_from_model(src @ w, -1, grad="sum")
        return y.reshape(b, t, kv, hd)[:, :, first:first + n]

    k, v = heads(p["wk"]), heads(p["wv"])
    q, k = rope(q, k)

    def expand(y):
        if n == 1:
            return repeat_kv(y, h_l)
        return torch.cat([y[:, :, j - first:j - first + 1].expand(
            b, t, c, hd) for j, c in runs], dim=2)
    return q, expand(k), expand(v)


def apply_attention(p: Params, cfg: AttentionConfig, x: torch.Tensor, *,
                    causal: bool = True, window: int = 0,
                    positions: Optional[torch.Tensor] = None,
                    q_chunk: int = 512, impl: str = "chunked",
                    fused_qkv: bool = False, wide: bool = False
                    ) -> torch.Tensor:
    """x: (B, S, D) -> (B, S, D).  Given this rank's model block of the
    weights (``wq`` narrower than ``q_dim``), it computes the rank's
    query heads and sums the output over the model ranks.  ``wide``:
    the products take ``tp.wide`` operands."""
    b, s, _ = x.shape
    hd = cfg.head_dim
    rep = cfg.num_heads // cfg.num_kv_heads
    h = cfg.num_heads
    dt = x.dtype
    if wide:
        x = tp.wide(x)
    if p["wq"].shape[1] != cfg.q_dim:
        q, k, v = _split_qkv(p, cfg, x, positions, fused_qkv)
        o = _attend(q.to(dt), k.to(dt), v.to(dt), causal, window, q_chunk,
                    impl)
        return tp.reduce_from_model(
            o.reshape(b, s, -1).to(x.dtype) @ p["wo"].to(x.dtype)).to(dt)
    wq, wk, wv = (p[k].to(x.dtype) for k in ("wq", "wk", "wv"))
    if fused_qkv:
        wk = _tile_kv_weight(wk, cfg.num_kv_heads, rep)
        wv = _tile_kv_weight(wv, cfg.num_kv_heads, rep)
        wqkv = torch.cat([wq, wk, wv], dim=1)
        qkv = (x @ wqkv).reshape(b, s, 3, h, hd)
        q, k, v = qkv[:, :, 0], qkv[:, :, 1], qkv[:, :, 2]
        q, k = _rope_qk(cfg, q, k, positions, b, s)
    else:
        q = (x @ wq).reshape(b, s, cfg.num_heads, hd)
        k = (x @ wk).reshape(b, s, cfg.num_kv_heads, hd)
        v = (x @ wv).reshape(b, s, cfg.num_kv_heads, hd)
        q, k = _rope_qk(cfg, q, k, positions, b, s)
        k = repeat_kv(k, rep)
        v = repeat_kv(v, rep)
    o = _attend(q.to(dt), k.to(dt), v.to(dt), causal, window, q_chunk, impl)
    return (o.reshape(b, s, cfg.q_dim).to(x.dtype)
            @ p["wo"].to(x.dtype)).to(dt)


def _attend(q, k, v, causal, window, q_chunk, impl):
    if impl == "flash":
        return flash_attention(q, k, v, causal=causal, window=window,
                               q_chunk=q_chunk, kv_chunk=q_chunk)
    return chunked_attention(q, k, v, causal=causal, window=window,
                             q_chunk=q_chunk)


def apply_cross_attention(p: Params, cfg: AttentionConfig,
                          x: torch.Tensor, enc: torch.Tensor, *,
                          q_chunk: int = 512,
                          impl: str = "chunked") -> torch.Tensor:
    """Non-causal attention from the decoder's states x (B, S, D) to the
    encoder's enc (B, T, D), KV heads repeated to the query heads, no
    position embedding; -> (B, S, D).  Given this rank's model block of
    the weights (``wq`` narrower than ``q_dim``) it computes the rank's
    query heads, x and enc entering as ``apply_attention``'s x does, and
    sums the output over the model ranks.  Always ``wide`` (as
    ``apply_attention``'s): the encoder's states enter every decoder
    layer here."""
    b, s, _ = x.shape
    t = enc.shape[1]
    hd = cfg.head_dim
    split = p["wq"].shape[1] != cfg.q_dim
    dt = x.dtype
    x, enc = tp.wide(x), tp.wide(enc)
    if split:
        q, k, v = _split_qkv(p, cfg, x, None, False, enc=enc)
    else:
        wq, wk, wv = (p[k].to(x.dtype) for k in ("wq", "wk", "wv"))
        q = (x @ wq).reshape(b, s, cfg.num_heads, hd)
        k = (enc @ wk).reshape(b, t, cfg.num_kv_heads, hd)
        v = (enc @ wv).reshape(b, t, cfg.num_kv_heads, hd)
        rep = cfg.num_heads // cfg.num_kv_heads
        k, v = repeat_kv(k, rep), repeat_kv(v, rep)
    q, k, v = q.to(dt), k.to(dt), v.to(dt)
    if impl == "flash":
        o = flash_attention(q, k, v, causal=False, q_chunk=q_chunk,
                            kv_chunk=q_chunk)
    else:
        o = chunked_attention(q, k, v, causal=False, q_chunk=q_chunk)
    out = o.reshape(b, s, -1).to(x.dtype) @ p["wo"].to(x.dtype)
    return (tp.reduce_from_model(out) if split else out).to(dt)


# ---------------------------------------------------------------------------
# Decode with KV cache (ring buffer for windowed layers)


def cache_spec(cfg: AttentionConfig, batch: int, seq: int, window: int,
               dtype) -> Params:
    """Cache for one layer. Windowed layers keep a ring of size
    ``window``."""
    t = window if window > 0 else seq
    kshape = (batch, t, cfg.num_kv_heads, cfg.head_dim)
    return {"k": TensorSpec(kshape, dtype), "v": TensorSpec(kshape, dtype)}


def _gather_cols(*ts: torch.Tensor):
    """Every model rank's columns of each ``ts[i]`` (..., n_i), whole
    (..., m * n_i) in rank order: one gather of them side by side."""
    sizes = [t.shape[-1] for t in ts]
    g = tp.gather_from_model(torch.cat(ts, dim=-1), -1)
    g = g.reshape(*g.shape[:-1], tp.model_size(), sum(sizes))
    return [part.reshape(*part.shape[:-2], -1)
            for part in g.split(sizes, dim=-1)]


def _kv_read(c: torch.Tensor, cfg: AttentionConfig, h_l: int):
    """The kv heads (B, T, n, hd) that this rank's ``h_l`` query heads
    read, each read by ``h_l // n`` of them in order, from a cache ``c``
    whole over the model axis; ``c`` itself when the rank computes every
    head or ``c`` is its block of the kv heads already."""
    kv = cfg.num_kv_heads
    if h_l == cfg.num_heads or c.shape[2] != kv:
        return c
    rep = cfg.num_heads // kv
    first = tp.model_rank() * h_l
    runs = _kv_runs(first, h_l, rep)
    if len({n for _, n in runs}) == 1:
        return c[:, :, runs[0][0]:runs[-1][0] + 1]
    idx = torch.arange(first, first + h_l, device=c.device) // rep
    return c.index_select(2, idx)


def _head_scores(qg: torch.Tensor, k: torch.Tensor) -> torch.Tensor:
    """(B, KV, G, 1, T) float32 scores, unscaled, of one query token qg
    (B, 1, KV, G, D) against k (B, T, KV, D), a cache or a view of its
    kv heads: each kv head's product batched over the rows on the
    cache's own strides, so the cache is not copied (an einsum over
    (B, T, KV, D) copies it to merge B and KV)."""
    return torch.stack([
        torch.matmul(qg[:, 0, j], k[:, :, j].transpose(1, 2))
        for j in range(k.shape[2])], dim=1)[:, :, :, None].float()


def _head_mix(w: torch.Tensor, v: torch.Tensor) -> torch.Tensor:
    """p @ v per kv head on v's strides: w (B, KV, G, 1, T), v (B, T,
    KV, D) -> (B, 1, KV, G, D)."""
    return torch.stack([torch.matmul(w[:, j, :, 0], v[:, :, j])
                        for j in range(v.shape[2])], dim=1)[:, None]


def _decode_sdpa(qg, k, v, mask, hd: Optional[int] = None
                 ) -> torch.Tensor:
    """``_sdpa`` of one query token qg (B, 1, KV, G, D) against a cache
    k/v (B, T, KV, D) per kv head (``_head_scores``); mask (1, T) bool
    or None.  ``hd``: qg and k are this rank's block of head_dim ``hd``,
    so the scores' parts are summed over the model axis (float32)
    before the softmax.  Returns (B, 1, KV, G, Dv)."""
    scores = _head_scores(qg, k)
    if hd is not None:
        scores = tp.reduce_from_model(scores)
    scores = scores * _scale(hd or qg.shape[-1])
    if mask is not None:
        scores = torch.where(mask[:, None, None, None], scores, NEG_INF)
    return _head_mix(torch.softmax(scores, dim=-1).to(qg.dtype), v)


def _rope_token(cfg: AttentionConfig, q, k, pos):
    """One decode token's q and k (B, 1, ., hd) roped at ``pos`` (M-RoPE:
    one position for all three sections, text-only decode)."""
    b = q.shape[0]
    posb = pos.to(torch.int32).reshape(1, 1).expand(b, 1)
    if cfg.rope_kind == "mrope":
        posb = posb[..., None].expand(b, 1, 3)
    return _rope_qk(cfg, q, k, posb, b, 1)


def _decode_mask(t: int, pos, window: int, device):
    cols = torch.arange(t, device=device)
    if window > 0:
        # Ring buffer: slot i holds the largest position p <= pos with
        # p % t == i; since t == window every written slot is in the
        # window, and before the first wrap some slots are unwritten.
        return ((cols <= pos) | (pos >= t))[None, :]
    return (cols <= pos)[None, :]


def _write(cache: Params, k, v, pos, window: int) -> Params:
    t = cache["k"].shape[1]
    slot = pos % t if window > 0 else pos
    # an update slice's start is clamped to fit, as the reference's
    slot = torch.clamp(slot, 0, t - 1).reshape(1).long()
    return {"k": cache["k"].index_copy(1, slot, k.to(cache["k"].dtype)),
            "v": cache["v"].index_copy(1, slot, v.to(cache["v"].dtype))}


def decode_attention(p: Params, cfg: AttentionConfig, x: torch.Tensor,
                     cache: Params, pos: torch.Tensor, *, window: int = 0):
    """One decode step: write the new KV at ``pos`` (mod window for
    local layers), attend over the cache.  x: (B, 1, D); cache k/v:
    (B, T, KV, hd); pos: int32 scalar tensor.  Returns (out (B, 1, D),
    new cache); the old cache is left as it was.

    In a step that splits the model axis the layer reads its split from
    the shapes.  ``wq`` narrower than ``q_dim``: the rank's query heads
    (``wq``/``wk``/``wv`` by columns, ``wo`` by rows, the output summed
    over the model ranks).  The cache as ``cache_partition`` lays it
    out: (i) by kv heads (narrower on dim 2), the kv heads that the
    rank's query heads read; (ii) by head_dim (narrower on dim 3,
    ``_decode_by_dim``); (iii) whole, when the rank computes its query
    heads: every rank writes the whole new K/V (its columns gathered,
    (B, 1, kv_dim)) and reads its heads' kv heads from the cache."""
    b = x.shape[0]
    hd = cfg.head_dim
    if cache["k"].shape[-1] != hd:
        return _decode_by_dim(p, cfg, x, cache, pos, window)
    h_l = p["wq"].shape[1] // hd
    split = h_l != cfg.num_heads
    q = (x @ p["wq"]).reshape(b, 1, h_l, hd)
    k, v = x @ p["wk"], x @ p["wv"]
    if split and cache["k"].shape[2] == cfg.num_kv_heads:
        k, v = _gather_cols(k, v)
    q, k = _rope_token(cfg, q, k.reshape(b, 1, -1, hd), pos)
    new = _write(cache, k, v.reshape(b, 1, -1, hd), pos, window)
    ck, cv = (_kv_read(new[n], cfg, h_l) for n in ("k", "v"))
    kv = ck.shape[2]
    qg = q.reshape(b, 1, kv, h_l // kv, hd)
    mask = _decode_mask(ck.shape[1], pos, window, x.device)
    out = _decode_sdpa(qg, ck, cv, mask)
    out = out.reshape(b, 1, h_l * hd) @ p["wo"]
    return (tp.reduce_from_model(out) if split else out), new


def _decode_by_dim(p: Params, cfg: AttentionConfig, x: torch.Tensor,
                   cache: Params, pos: torch.Tensor, window: int):
    """``decode_attention`` on a cache split across head_dim (layout
    (ii): the kv heads do not divide the model axis, head_dim does; the
    rank holds a head_dim block of every kv head).  Rope pairs dim i
    with i + hd/2, so a block cannot be roped alone: the new token's q,
    k and v, (B, 1, ...) each, are computed whole (gathered from the
    ranks' columns when the weights are split) and roped whole, and the
    rank writes its block of k and v.  The scores' parts over the
    blocks are summed over the model axis in float32 and the softmax
    runs whole; the rank's block of p @ v, (B, 1, H, hd / m), is
    gathered whole over head_dim rather than the cache, and enters
    ``wo`` (its rows, the rank's query heads, when split)."""
    b = x.shape[0]
    hd, h, kv = cfg.head_dim, cfg.num_heads, cfg.num_kv_heads
    hd_l = cache["k"].shape[-1]
    r = tp.model_rank()
    h_l = p["wq"].shape[1] // hd
    split = h_l != h
    q, k, v = x @ p["wq"], x @ p["wk"], x @ p["wv"]
    if split:
        q, k, v = _gather_cols(q, k, v)
    q, k = _rope_token(cfg, q.reshape(b, 1, h, hd),
                       k.reshape(b, 1, kv, hd), pos)
    v = v.reshape(b, 1, kv, hd)
    lo = r * hd_l
    new = _write(cache, k[..., lo:lo + hd_l], v[..., lo:lo + hd_l], pos,
                 window)
    qg = q[..., lo:lo + hd_l].reshape(b, 1, kv, h // kv, hd_l)
    mask = _decode_mask(new["k"].shape[1], pos, window, x.device)
    o = _decode_sdpa(qg, new["k"], new["v"], mask, hd)
    o = tp.gather_from_model(o, -1).reshape(b, 1, h * hd)
    if split:
        o = o[..., r * h_l * hd:(r + 1) * h_l * hd]
        return tp.reduce_from_model(o @ p["wo"]), new
    return o @ p["wo"], new


def decode_cross_attention(p: Params, cfg: AttentionConfig,
                           x: torch.Tensor, cache: Params) -> torch.Tensor:
    """One decoder token's cross attention against the cached K/V
    (B, T, KV, hd) of the encoder's states: no mask, no position.  Its
    products take ``tp.wide`` operands, as ``apply_cross_attention``'s.
    Given this rank's model block of the weights (``wq`` narrower than
    ``q_dim``) its query heads read their kv heads (``_kv_read``; the
    cache is never split over the model axis, ``cache_partition``
    leaves whisper's stacked K/V whole there) and the output, ``wo``'s
    rows, is summed over the model ranks."""
    b = x.shape[0]
    hd = cfg.head_dim
    dt = x.dtype
    h_l = p["wq"].shape[1] // hd
    q = (tp.wide(x) @ tp.wide(p["wq"])).to(dt).reshape(b, 1, h_l, hd)
    ck, cv = (_kv_read(cache[n], cfg, h_l) for n in ("k", "v"))
    kv = ck.shape[2]
    o = _decode_sdpa(q.reshape(b, 1, kv, h_l // kv, hd), ck, cv, None)
    out = tp.wide(o.reshape(b, 1, h_l * hd)) @ tp.wide(p["wo"])
    if h_l != cfg.num_heads:
        out = tp.reduce_from_model(out)
    return out.to(dt)
