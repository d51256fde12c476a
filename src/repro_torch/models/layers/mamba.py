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

In a step that splits the model axis a layer given its model block of
the weights (``conv_w`` narrower than ``expand * d_model``) computes this
rank's block of the channels: ``w_in`` by columns, ``conv_w``,
``conv_b``, ``w_dt``, ``dt_bias``, ``d_skip`` by channel, ``w_x``,
``a_log``, ``w_out`` by rows.  ``w_in`` is [x | z] joined, so a rank's
block of its columns is a block of the joined columns (at two ranks
rank 0 holds all of x, rank 1 all of z): it is gathered over the model
axis and the rank's x and z channels taken, its gradient summed over
the ranks before each keeps its block.  ``w_x``'s rows give each rank
its part of (dt, B, C), summed over the axis; the scan runs per channel;
``w_out``'s rows end the layer with the sum over the axis.  Each sum
over the channels (``w_x``'s and ``w_out``'s products, the gradients of
x, of dt's low rank, of B and of C) accumulates in ``tp.wide`` operands,
split or not (``tensor_parallel``): ``_Outer`` and ``_ReadOut`` are the
scan's products with B and C, whose backward sums over the channels.
"""
from __future__ import annotations

from typing import Dict, Optional, Tuple

import torch
import torch.nn.functional as F

from repro_torch.config.base import SSMConfig
from repro_torch.sharding import tensor_parallel as tp
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


def _ssm_inputs(p: Params, cfg: SSMConfig, xc: torch.Tensor, d: int,
                split: bool = False):
    """(dt, B, C) from the conv output ``xc`` (B, S, DI): dt in float32,
    B and C in float32 or, for a float32 ``xc``, float64 (wide: their
    gradients sum over the channels); ``split``: ``xc`` is the rank's
    channels and ``w_x`` its rows, so the product is summed over the
    model axis (g) and enters the rank's channels again (f: B and C
    feed every rank's, dt_low ``w_dt``'s column split)."""
    dbc = tp.wide(xc) @ tp.wide(p["w_x"])
    if split:
        dbc = tp.copy_to_model(tp.reduce_from_model(dbc))
    dr = _dt_rank(cfg, d)
    n = cfg.d_state
    # bf16 @ bf16 + the float32 bias promotes to float32, as in JAX
    low = (dbc[..., :dr] @ tp.wide(p["w_dt"])).to(xc.dtype)
    dt = _softplus(low + p["dt_bias"]).float()
    up = torch.promote_types(dbc.dtype, torch.float32)
    return dt, dbc[..., dr:dr + n].to(up), dbc[..., dr + n:].to(up)


_CHANNELS = 1024    # channels a backward widens at once


def _sum_mul(a: torch.Tensor, u: torch.Tensor) -> torch.Tensor:
    """sum over d of a[b, s, d, n] * u[b, s, d] as autograd's backward
    of a broadcast product takes it: a product and a sum."""
    return torch.sum(a * u[..., None], 2)


def _sum_dot(a: torch.Tensor, u: torch.Tensor) -> torch.Tensor:
    """The same sum as an einsum's backward takes it: a batched
    product."""
    return torch.einsum("bsdn,bsd->bsn", a, u)


def _channel_sum(product, a: torch.Tensor, u: torch.Tensor,
                 dtype) -> torch.Tensor:
    """``product(a, u)`` (``_sum_mul`` or ``_sum_dot``) in ``dtype``: at
    once where ``a`` is in it, else ``_CHANNELS`` channels widened at a
    time and their sums added."""
    step = a.shape[2] if a.dtype == dtype else _CHANNELS
    out = None
    for lo in range(0, a.shape[2], step):
        part = product(a[:, :, lo:lo + step].to(dtype),
                       u[:, :, lo:lo + step].to(dtype))
        out = part if out is None else out + part
    return out


class _Outer(torch.autograd.Function):
    """u (B, S, DI) float32 times ``b`` (B, S, N) over every channel:
    (B, S, DI, N) float32; ``b``'s gradient sums over the channels in
    ``b``'s dtype."""

    @staticmethod
    def forward(ctx, u, b):
        ctx.save_for_backward(u, b)
        return u[..., None] * b.to(u.dtype)[..., None, :]

    @staticmethod
    def backward(ctx, g):
        u, b = ctx.saved_tensors
        gu = torch.sum(g * b.to(g.dtype)[..., None, :], -1)
        return gu, _channel_sum(_sum_mul, g, u, b.dtype)


class _ReadOut(torch.autograd.Function):
    """``einsum("bsdn,bsn->bsd", hs, c)`` in float32; ``c``'s gradient
    sums over the channels in ``c``'s dtype."""

    @staticmethod
    def forward(ctx, hs, c):
        ctx.save_for_backward(hs, c)
        return torch.einsum("bsdn,bsn->bsd", hs, c.to(hs.dtype))

    @staticmethod
    def backward(ctx, g):
        hs, c = ctx.saved_tensors
        # the outer product as a matmul of contraction 1, as autograd's
        ghs = torch.matmul(g[..., None], c.to(g.dtype)[..., None, :])
        return ghs, _channel_sum(_sum_dot, hs, g, c.dtype)


def _split_in_proj(w_in: torch.Tensor, x: torch.Tensor, di: int):
    """This rank's channels of x and z from its block of ``w_in``'s
    joined [x | z] columns: every rank's block gathered, the rank's
    x columns and z columns taken (its gradient summed over the model
    ranks, each keeping its block)."""
    k = w_in.shape[1] // 2
    first = tp.model_rank() * k
    w = tp.gather_from_model(w_in, -1, grad="sum")
    xz = x @ tp.wide(torch.cat([w[:, first:first + k],
                                w[:, di + first:di + first + k]], dim=1))
    return xz[..., :k], xz[..., k:]


def apply_mamba(p: Params, cfg: SSMConfig, x: torch.Tensor, *,
                chunk: int = 256) -> torch.Tensor:
    """Training/prefill forward. x: (B, S, D) -> (B, S, D).  Given this
    rank's model block of the weights it computes the rank's channels
    and sums the output over the model ranks."""
    b, s, d = x.shape
    di = cfg.expand * d
    split = p["conv_w"].shape[1] != di
    dt_x = x.dtype
    x = tp.wide(x)
    if split:
        x = tp.copy_to_model(x)
        xi, z = _split_in_proj(p["w_in"], x, di)
    else:
        xz = x @ tp.wide(p["w_in"])
        xi, z = xz[..., :di], xz[..., di:]
    xi, z = xi.to(dt_x), z.to(dt_x)
    xi = F.silu(causal_conv(xi, p["conv_w"], p["conv_b"]))
    dt, bmat, cmat = _ssm_inputs(p, cfg, xi, d, split)
    a = -torch.exp(p["a_log"])                          # (DI, N)
    abar = torch.exp(dt[..., None] * a)                 # (B, S, DI, N)
    bx = _Outer.apply(dt * xi.float(), bmat)
    h0 = torch.zeros((b, xi.shape[-1], cfg.d_state), dtype=torch.float32,
                     device=x.device)
    hs, _ = ssm_scan_chunked(abar, bx, h0, min(chunk, s))
    y = _ReadOut.apply(hs, cmat)
    y = y + xi.float() * p["d_skip"]
    y = y.to(dt_x) * F.silu(z)
    out = tp.wide(y) @ tp.wide(p["w_out"])
    return (tp.reduce_from_model(out) if split else out).to(dt_x)


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
    inputs before the conv.  Given this rank's model block of the
    weights and of the state (``h`` (B, DI / m, N) and ``conv``
    (B, K-1, DI / m), by channel) it computes the rank's channels as
    ``apply_mamba`` does (``w_in`` regathered, ``w_x``'s part of (dt, B,
    C) and ``w_out``'s of the output summed over the model ranks), with
    its ``tp.wide`` products on both paths."""
    d = x.shape[-1]
    di = cfg.expand * d
    split = p["conv_w"].shape[1] != di
    dt_x = x.dtype
    xw = tp.wide(x)
    if split:
        xi, z = _split_in_proj(p["w_in"], tp.copy_to_model(xw), di)
    else:
        xz = xw @ tp.wide(p["w_in"])
        xi, z = xz[..., :di], xz[..., di:]
    xi, z = xi.to(dt_x), z.to(dt_x)
    xi_conv = F.silu(causal_conv(xi, p["conv_w"], p["conv_b"],
                                 state["conv"]))
    new_conv = torch.cat([state["conv"][:, 1:],
                          xi.to(state["conv"].dtype)], dim=1)
    dt, bmat, cmat = _ssm_inputs(p, cfg, xi_conv, d, split)
    bmat, cmat = bmat.float(), cmat.float()
    a = -torch.exp(p["a_log"])
    abar = torch.exp(dt[:, 0, :, None] * a)             # (B, DI, N)
    bx = (dt[:, 0] * xi_conv[:, 0].float())[..., None] * bmat[:, 0, None, :]
    h = abar * state["h"] + bx
    y = torch.einsum("bdn,bn->bd", h, cmat[:, 0])
    y = y + xi_conv[:, 0].float() * p["d_skip"]
    y = y[:, None].to(dt_x) * F.silu(z)
    out = tp.wide(y) @ tp.wide(p["w_out"])
    return (tp.reduce_from_model(out) if split else out).to(dt_x), \
        {"h": h, "conv": new_conv}
