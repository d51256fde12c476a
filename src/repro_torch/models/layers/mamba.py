"""Mamba (selective SSM) block (port of ``repro.models.layers.mamba``).

The recurrence, per channel and state dimension (diagonal A),

    h_t = Abar_t * h_{t-1} + Bbar_t x_t

is a first-order linear recurrence.  The reference evaluates it with a
chunked associative scan (``lax.associative_scan`` within a chunk,
``lax.scan`` across chunks).  Eager PyTorch has no associative scan, so
within a chunk this is a Hillis-Steele scan: log2(chunk) doublings, each
combining every element with the one ``shift`` places before it, and a
Python loop carries the (B, d_inner, d_state) state across chunks.  The
scan's tree differs from the reference's, so its rounding does too; both
are held to the sequential recurrence at float32 tolerance.
"""
from __future__ import annotations

from typing import Dict, Optional, Tuple

import torch
import torch.nn.functional as F

from repro_torch.config.base import SSMConfig
from .common import TensorSpec, sequential_loop

Params = Dict[str, torch.Tensor]


def _dt_rank(cfg: SSMConfig, d_model: int) -> int:
    return cfg.dt_rank or max(1, -(-d_model // 16))


def mamba_spec(cfg: SSMConfig, d_model: int, dtype) -> Dict[str, TensorSpec]:
    di = cfg.expand * d_model
    dr = _dt_rank(cfg, d_model)
    n = cfg.d_state
    return {
        "w_in": TensorSpec((d_model, 2 * di), dtype),
        "conv_w": TensorSpec((cfg.d_conv, di), dtype),
        "conv_b": TensorSpec((di,), dtype),
        "w_x": TensorSpec((di, dr + 2 * n), dtype),
        "w_dt": TensorSpec((dr, di), dtype),
        "dt_bias": TensorSpec((di,), torch.float32),
        "a_log": TensorSpec((di, n), torch.float32),
        "d_skip": TensorSpec((di,), torch.float32),
        "w_out": TensorSpec((di, d_model), dtype),
    }


def causal_conv(x: torch.Tensor, w: torch.Tensor, b: torch.Tensor,
                state: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Depthwise causal conv. x: (B, S, C), w: (K, C), state: (B, K-1,
    C), the last K-1 inputs before x (zeros when None).  The K shifted
    products are summed in order i = 0..K-1, as the reference's."""
    k = w.shape[0]
    if state is None:
        pad = torch.zeros((x.shape[0], k - 1, x.shape[2]), dtype=x.dtype,
                          device=x.device)
    else:
        pad = state.to(x.dtype)
    xp = torch.cat([pad, x], dim=1)
    s = x.shape[1]
    out = sum(xp[:, i:i + s, :] * w[i] for i in range(k))
    return out + b


def _softplus(x: torch.Tensor) -> torch.Tensor:
    """``jax.nn.softplus``: log(1 + e^x) as ``logaddexp(x, 0)``."""
    return torch.logaddexp(x, torch.zeros((), dtype=x.dtype,
                                          device=x.device))


def _chunk_scan(a: torch.Tensor, b: torch.Tensor
                ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Inclusive scan over axis 1 of the pairs (a, b) under
    (al, bl) . (ar, br) = (al ar, bl ar + br): Hillis-Steele doublings,
    the first ``shift`` elements combined with the identity (1, 0),
    which leaves them exact."""
    w = a.shape[1]
    shift = 1
    while shift < w:
        lead = a.shape[:1] + (shift,) + a.shape[2:]
        a_prev = torch.cat([a.new_ones(lead), a[:, :-shift]], dim=1)
        b_prev = torch.cat([b.new_zeros(lead), b[:, :-shift]], dim=1)
        b = b_prev * a + b
        a = a_prev * a
        shift *= 2
    return a, b


def ssm_scan_chunked(abar: torch.Tensor, bx: torch.Tensor, h0: torch.Tensor,
                     chunk: int) -> Tuple[torch.Tensor, torch.Tensor]:
    """abar, bx: (B, S, DI, N) float32; h0: (B, DI, N).  Returns (hs,
    h_final): every h_t and the last."""
    s = abar.shape[1]
    if s % chunk:
        raise ValueError(f"seq {s} % chunk {chunk}")
    h, hs = h0, []
    with sequential_loop("mamba_chunks", s // chunk) as steps:
        abars, bxs = steps.pieces(abar, 1, chunk), steps.pieces(bx, 1, chunk)
        for c in steps:
            aa, bb = _chunk_scan(abars[c], bxs[c])
            part = aa * h[:, None] + bb
            hs.append(part)
            h = part[:, -1]
    return steps.join(hs, 1, stack=False), h


def _ssm_inputs(p: Params, cfg: SSMConfig, xc: torch.Tensor, d: int):
    """(dt, B, C) in float32 from the conv output ``xc`` (B, S, DI)."""
    dbc = xc @ p["w_x"]
    dr = _dt_rank(cfg, d)
    n = cfg.d_state
    # bf16 @ bf16 + the float32 bias promotes to float32, as in JAX
    dt = _softplus(dbc[..., :dr] @ p["w_dt"] + p["dt_bias"]).float()
    bmat = dbc[..., dr:dr + n].float()
    cmat = dbc[..., dr + n:].float()
    return dt, bmat, cmat


def apply_mamba(p: Params, cfg: SSMConfig, x: torch.Tensor, *,
                chunk: int = 256) -> torch.Tensor:
    """Training/prefill forward. x: (B, S, D) -> (B, S, D)."""
    b, s, d = x.shape
    di = cfg.expand * d
    xz = x @ p["w_in"]
    xi, z = xz[..., :di], xz[..., di:]
    xi = F.silu(causal_conv(xi, p["conv_w"], p["conv_b"]))
    dt, bmat, cmat = _ssm_inputs(p, cfg, xi, d)
    a = -torch.exp(p["a_log"])                          # (DI, N)
    abar = torch.exp(dt[..., None] * a)                 # (B, S, DI, N)
    bx = (dt * xi.float())[..., None] * bmat[..., None, :]
    h0 = torch.zeros((b, di, cfg.d_state), dtype=torch.float32,
                     device=x.device)
    hs, _ = ssm_scan_chunked(abar, bx, h0, min(chunk, s))
    y = torch.einsum("bsdn,bsn->bsd", hs, cmat)
    y = y + xi.float() * p["d_skip"]
    y = y.to(x.dtype) * F.silu(z)
    return y @ p["w_out"]


# ---------------------------------------------------------------------------
# Decode


def mamba_state_spec(cfg: SSMConfig, d_model: int, batch: int,
                     dtype) -> Dict[str, TensorSpec]:
    di = cfg.expand * d_model
    return {
        "h": TensorSpec((batch, di, cfg.d_state), torch.float32),
        "conv": TensorSpec((batch, cfg.d_conv - 1, di), dtype),
    }


def decode_mamba(p: Params, cfg: SSMConfig, x: torch.Tensor, state: Params
                 ) -> Tuple[torch.Tensor, Params]:
    """One token. x: (B, 1, D).  The new conv state holds the last K-1
    inputs before the conv."""
    d = x.shape[-1]
    di = cfg.expand * d
    xz = x @ p["w_in"]
    xi, z = xz[..., :di], xz[..., di:]
    xi_conv = F.silu(causal_conv(xi, p["conv_w"], p["conv_b"],
                                 state["conv"]))
    new_conv = torch.cat([state["conv"][:, 1:],
                          xi.to(state["conv"].dtype)], dim=1)
    dt, bmat, cmat = _ssm_inputs(p, cfg, xi_conv, d)
    a = -torch.exp(p["a_log"])
    abar = torch.exp(dt[:, 0, :, None] * a)             # (B, DI, N)
    bx = (dt[:, 0] * xi_conv[:, 0].float())[..., None] * bmat[:, 0, None, :]
    h = abar * state["h"] + bx
    y = torch.einsum("bdn,bn->bd", h, cmat[:, 0])
    y = y + xi_conv[:, 0].float() * p["d_skip"]
    y = y[:, None].to(x.dtype) * F.silu(z)
    return y @ p["w_out"], {"h": h, "conv": new_conv}
