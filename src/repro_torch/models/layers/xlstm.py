"""xLSTM blocks: mLSTM (matrix memory, chunkwise-parallel) and sLSTM
(scalar memory, sequential scan) (port of ``repro.models.layers.xlstm``).

mLSTM recurrence (per head, stabilized, following arXiv:2405.04517):

    m_t = max(lf_t + m_{t-1}, li_t)                      (stabilizer)
    C_t = exp(lf_t + m_{t-1} - m_t) C_{t-1} + exp(li_t - m_t) v_t k_t^T
    n_t = exp(lf_t + m_{t-1} - m_t) n_{t-1} + exp(li_t - m_t) k_t
    h_t = (C_t q_t) / max(|n_t . q_t|, exp(-m_t))

Training uses the chunkwise-parallel form (quadratic attention with a
decay mask inside a chunk, the recurrent state across chunks, a Python
loop over the chunks); ``mlstm_recurrent_step`` is the step-by-step form
that decode uses.  sLSTM has a true sequential dependency through its
recurrent weights, so it is a Python loop over time.

The stabilizer starts at -inf.  Every max is ``torch.amax`` or
``torch.maximum``, which share the gradient at ties as JAX's ``max`` and
``maximum`` do, and every -inf meets only ``exp`` of -inf (0, with a 0
gradient) or a max against a finite value, so the forward and the
gradients stay finite.
"""
from __future__ import annotations

import math
from typing import Dict, Tuple

import torch
import torch.nn.functional as F

from repro_torch.config.base import SSMConfig
from .common import TensorSpec, apply_norm, sequential_loop
from .mamba import causal_conv

Params = Dict[str, torch.Tensor]


# ---------------------------------------------------------------------------
# mLSTM


def mlstm_spec(cfg: SSMConfig, d_model: int, dtype) -> Dict[str, TensorSpec]:
    di = int(cfg.proj_factor * d_model)
    h = cfg.num_heads
    return {
        "w_up": TensorSpec((d_model, 2 * di), dtype),
        "conv_w": TensorSpec((cfg.d_conv, di), dtype),
        "conv_b": TensorSpec((di,), dtype),
        "wq": TensorSpec((di, di), dtype),
        "wk": TensorSpec((di, di), dtype),
        "wv": TensorSpec((di, di), dtype),
        "w_if": TensorSpec((di, 2 * h), torch.float32),
        "if_bias": TensorSpec((2 * h,), torch.float32),
        "skip": TensorSpec((di,), dtype),
        "norm_g": TensorSpec((di,), dtype),
        "w_down": TensorSpec((di, d_model), dtype),
    }


def _headwise_norm(x: torch.Tensor, g: torch.Tensor,
                   nheads: int) -> torch.Tensor:
    """GroupNorm with one group per head (affine g): the population
    variance, eps 1e-6, in float32."""
    b, s, di = x.shape
    xh = x.reshape(b, s, nheads, di // nheads).float()
    mu = torch.mean(xh, dim=-1, keepdim=True)
    var = torch.mean(torch.square(xh - mu), dim=-1, keepdim=True)
    y = (xh - mu) * torch.rsqrt(var + 1e-6)
    return (y.reshape(b, s, di) * g.float()).to(x.dtype)


def _promoted_mm(a: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """``a @ w`` in the promoted dtype of the two (JAX promotes a
    bfloat16 activation against a float32 weight; torch refuses)."""
    dt = torch.promote_types(a.dtype, w.dtype)
    return a.to(dt) @ w.to(dt)


def _k_scale(dh: int, dtype: torch.dtype, device) -> torch.Tensor:
    """``jnp.sqrt(dh).astype(x.dtype)``: float32 sqrt, then the dtype."""
    return torch.tensor(math.sqrt(dh), dtype=torch.float32,
                        device=device).to(dtype)


def _gates(p: Params, xc: torch.Tensor, h: int):
    gates = _promoted_mm(xc, p["w_if"]) + p["if_bias"]    # float32
    li = gates[..., :h].float()                            # log input gate
    lf = F.logsigmoid(gates[..., h:].float())              # log forget gate
    return li, lf


def _qkv_gates(p: Params, cfg: SSMConfig, x: torch.Tensor):
    b, s, _ = x.shape
    di = p["wq"].shape[0]
    h = cfg.num_heads
    dh = di // h
    up = x @ p["w_up"]
    xi, z = up[..., :di], up[..., di:]
    xc = F.silu(causal_conv(xi, p["conv_w"], p["conv_b"]))
    q = (xc @ p["wq"]).reshape(b, s, h, dh)
    k = (xc @ p["wk"]).reshape(b, s, h, dh) / _k_scale(dh, x.dtype, x.device)
    v = (xi @ p["wv"]).reshape(b, s, h, dh)
    li, lf = _gates(p, xc, h)
    return xi, z, q, k, v, li, lf


def mlstm_chunkwise(q, k, v, li, lf, *, chunk: int = 128) -> torch.Tensor:
    """Chunkwise-parallel stabilized mLSTM.

    q, k, v: (B, S, H, dh); li, lf: (B, S, H).  Returns h: (B, S, H, dh)
    in float32."""
    b, s, h, dh = q.shape
    chunk = min(chunk, s)
    if s % chunk:
        raise ValueError(f"seq {s} % chunk {chunk}")
    dev = q.device
    qf, kf, vf = (t.float() for t in (q, k, v))
    tri = torch.tril(torch.ones((chunk, chunk), dtype=torch.bool,
                                device=dev))[None, :, :, None]
    neg_inf = torch.tensor(-math.inf, dtype=torch.float32, device=dev)
    c_prev = torch.zeros((b, h, dh, dh), dtype=torch.float32, device=dev)
    n_prev = torch.zeros((b, h, dh), dtype=torch.float32, device=dev)
    m_prev = torch.full((b, h), -math.inf, dtype=torch.float32, device=dev)
    hs = []
    with sequential_loop("mlstm_chunks", s // chunk) as steps:
        parts = list(zip(*(steps.pieces(t, 1, chunk)
                           for t in (qf, kf, vf, li, lf))))
        for c in steps:
            qc, kc, vc, lic, lfc = parts[c]
            # cumulative log-forget within the chunk: bc[j] = sum_{u<=j} lf_u
            bc = torch.cumsum(lfc, dim=1)
            bt = bc[:, -1]                                       # (B, H)
            # intra-chunk log weights: lw[j,u] = bc[j] - bc[u] + li[u], u <= j
            lw = bc[:, :, None, :] - bc[:, None, :, :] + lic[:, None, :, :]
            lw = torch.where(tri, lw, neg_inf)
            l_inter = bc + m_prev[:, None, :]                    # (B, W, H)
            m_intra = torch.amax(lw, dim=2)
            m_cur = torch.maximum(l_inter, m_intra)              # (B, W, H)
            wts = torch.exp(lw - m_cur[:, :, None, :])           # (B, W, W, H)
            scores = torch.einsum("bwhd,buhd->bwuh", qc, kc)
            intra = torch.einsum("bwuh,buhd->bwhd", scores * wts, vc)
            inter_scale = torch.exp(l_inter - m_cur)
            inter = torch.einsum("bwhd,bhde->bwhe", qc, c_prev) \
                * inter_scale[..., None]
            num = intra + inter
            n_intra = torch.einsum("bwuh,buhd->bwhd", wts, kc)
            n_vec = n_intra + n_prev[:, None] * inter_scale[..., None]
            qdot = torch.abs(torch.einsum("bwhd,bwhd->bwh", n_vec, qc))
            denom = torch.maximum(qdot, torch.exp(-m_cur))
            hs.append(num / denom[..., None])
            if c + 1 == len(steps):
                break   # the state after the last chunk is not used
            # chunk-final state update (stabilized at m_new)
            lk = bt[:, None] - bc + lic          # log weight of k_u into state
            m_new = torch.maximum(bt + m_prev, torch.amax(lk, dim=1))
            dec_state = torch.exp(bt + m_prev - m_new)           # (B, H)
            kw = torch.exp(lk - m_new[:, None])
            c_prev = dec_state[:, :, None, None] * c_prev + torch.einsum(
                "bwhd,bwhe->bhde", kw[..., None] * kc, vc)
            n_prev = dec_state[:, :, None] * n_prev + torch.einsum(
                "bwh,bwhd->bhd", kw, kc)
            m_prev = m_new
    return steps.join(hs, 1, stack=False)


def mlstm_recurrent_step(c, n, m, q, k, v, li, lf):
    """Decode step. c: (B, H, dh, dh) n: (B, H, dh) m: (B, H); q, k, v:
    (B, H, dh); li, lf: (B, H)."""
    qf, kf, vf = (t.float() for t in (q, k, v))
    m_new = torch.maximum(lf + m, li)
    fg = torch.exp(lf + m - m_new)[..., None]
    ig = torch.exp(li - m_new)[..., None]
    c_new = fg[..., None] * c + ig[..., None] * (vf[..., None]
                                                 * kf[..., None, :])
    n_new = fg * n + ig * kf
    num = torch.einsum("bhde,bhe->bhd", c_new, qf)
    qdot = torch.abs(torch.einsum("bhd,bhd->bh", n_new, qf))
    denom = torch.maximum(qdot, torch.exp(-m_new))
    return c_new, n_new, m_new, num / denom[..., None]


def apply_mlstm(p: Params, cfg: SSMConfig, x: torch.Tensor, *,
                chunk: int = 128) -> torch.Tensor:
    xi, z, q, k, v, li, lf = _qkv_gates(p, cfg, x)
    hs = mlstm_chunkwise(q, k, v, li, lf, chunk=chunk)
    b, s, h, dh = hs.shape
    hs = hs.reshape(b, s, h * dh).to(x.dtype)
    hs = _headwise_norm(hs, p["norm_g"], cfg.num_heads)
    hs = hs + xi * p["skip"]
    out = hs * F.silu(z)
    return out @ p["w_down"]


def mlstm_state_spec(cfg: SSMConfig, d_model: int, batch: int,
                     dtype) -> Dict[str, TensorSpec]:
    di = int(cfg.proj_factor * d_model)
    h = cfg.num_heads
    dh = di // h
    return {
        "c": TensorSpec((batch, h, dh, dh), torch.float32),
        "n": TensorSpec((batch, h, dh), torch.float32),
        "m": TensorSpec((batch, h), torch.float32),
        "conv": TensorSpec((batch, cfg.d_conv - 1, di), dtype),
    }


def decode_mlstm(p: Params, cfg: SSMConfig, x: torch.Tensor, state: Params
                 ) -> Tuple[torch.Tensor, Params]:
    """One token. x: (B, 1, D)."""
    b = x.shape[0]
    di = p["wq"].shape[0]
    h = cfg.num_heads
    dh = di // h
    up = x @ p["w_up"]
    xi, z = up[..., :di], up[..., di:]
    xc = F.silu(causal_conv(xi, p["conv_w"], p["conv_b"], state["conv"]))
    new_conv = torch.cat([state["conv"][:, 1:],
                          xi.to(state["conv"].dtype)], dim=1)
    q = (xc @ p["wq"]).reshape(b, h, dh)
    k = ((xc @ p["wk"]) / _k_scale(dh, x.dtype, x.device)).reshape(b, h, dh)
    v = (xi @ p["wv"]).reshape(b, h, dh)
    li, lf = _gates(p, xc[:, 0], h)
    c, n, m, hv = mlstm_recurrent_step(state["c"], state["n"], state["m"],
                                       q, k, v, li, lf)
    hv = hv.reshape(b, 1, di).to(x.dtype)
    hv = _headwise_norm(hv, p["norm_g"], cfg.num_heads)
    hv = hv + xi * p["skip"]
    out = hv * F.silu(z)
    return out @ p["w_down"], {"c": c, "n": n, "m": m, "conv": new_conv}


# ---------------------------------------------------------------------------
# sLSTM


def slstm_spec(cfg: SSMConfig, d_model: int, dtype) -> Dict[str, TensorSpec]:
    h = cfg.num_heads
    dh = d_model // h
    return {
        # input projections for gates i, f, z, o
        "w_gates": TensorSpec((d_model, 4 * d_model), dtype),
        # per-head recurrent weights for each gate: (4, H, dh, dh)
        "r_gates": TensorSpec((4, h, dh, dh), dtype),
        "bias": TensorSpec((4 * d_model,), torch.float32),
        "norm_g": TensorSpec((d_model,), dtype),
        "w_out": TensorSpec((d_model, d_model), dtype),
    }


def slstm_state_spec(cfg: SSMConfig, d_model: int, batch: int,
                     dtype) -> Dict[str, TensorSpec]:
    h = cfg.num_heads
    sh = (batch, h, d_model // h)
    return {k: TensorSpec(sh, torch.float32) for k in ("c", "n", "m", "h")}


def _slstm_step(p: Params, cfg: SSMConfig, state: Params,
                xw: torch.Tensor) -> Params:
    """xw: (B, 4 D), the step's input projection (float32)."""
    nh = cfg.num_heads
    bsz = xw.shape[0]
    dh = xw.shape[-1] // 4 // nh
    r = p["r_gates"]
    rec = torch.einsum("bhd,ghde->bghe", state["h"].to(r.dtype), r)
    z = xw.reshape(bsz, 4, nh, dh) + rec.float()
    li, lf_raw, zt, ot = z[:, 0], z[:, 1], z[:, 2], z[:, 3]
    lf = F.logsigmoid(lf_raw)
    m_new = torch.maximum(lf + state["m"], li)
    fg = torch.exp(lf + state["m"] - m_new)
    ig = torch.exp(li - m_new)
    c_new = fg * state["c"] + ig * torch.tanh(zt)
    n_new = fg * state["n"] + ig
    # maximum, not clamp: at n = 1 (the first step's) the gradient is
    # shared, as JAX's maximum shares it
    one = torch.ones((), dtype=n_new.dtype, device=n_new.device)
    h_new = torch.sigmoid(ot) * c_new / torch.maximum(n_new, one)
    return {"c": c_new, "n": n_new, "m": m_new, "h": h_new}


def _slstm_out(p: Params, hs: torch.Tensor) -> torch.Tensor:
    g = p["norm_g"]
    hs = apply_norm({"g": g, "b": torch.zeros_like(g)}, hs, "layernorm")
    return hs @ p["w_out"]


def apply_slstm(p: Params, cfg: SSMConfig, x: torch.Tensor) -> torch.Tensor:
    """Sequential scan over time. x: (B, S, D)."""
    b, s, d = x.shape
    xw = (x @ p["w_gates"]).float() + p["bias"]              # (B, S, 4D)
    sh = (b, cfg.num_heads, d // cfg.num_heads)
    zeros = torch.zeros(sh, dtype=torch.float32, device=x.device)
    state = {"c": zeros, "n": zeros, "h": zeros,
             "m": torch.full(sh, -math.inf, dtype=torch.float32,
                             device=x.device)}
    hs = []
    with sequential_loop("slstm_steps", s) as steps:
        xws = steps.pieces(xw, 1)
        for t in steps:
            state = _slstm_step(p, cfg, state, xws[t])
            hs.append(state["h"])
    hs = steps.join(hs, 1).reshape(b, s, d).to(x.dtype)
    return _slstm_out(p, hs)


def decode_slstm(p: Params, cfg: SSMConfig, x: torch.Tensor, state: Params
                 ) -> Tuple[torch.Tensor, Params]:
    b, _, d = x.shape
    xw = (x[:, 0] @ p["w_gates"]).float() + p["bias"]
    st = _slstm_step(p, cfg, state, xw)
    return _slstm_out(p, st["h"].reshape(b, 1, d).to(x.dtype)), st
