"""Quantization primitives (port of ``repro.core.quant``).

Signed symmetric ``beta``-bit quantizer with a learned per-channel scale
``s = exp(log_s)``:

    q(x) = clip(round(x / s), -2^{beta-1}, 2^{beta-1} - 1)
    y    = q(x) * s
    code = q(x) + 2^{beta-1}

``torch.round`` rounds half to even, as ``jnp.round`` does, so codes
agree with the JAX package bit for bit on equal inputs.  BatchNorm is
written out by hand: ``nn.BatchNorm1d`` keeps the unbiased variance in
its running state, the reference keeps the biased one.

Every reduction over the batch rows of a training step (BN's batch
statistics, and the gradients of the per-channel scale, gain and bias,
which autograd sums over the rows they were broadcast to) runs in
float64 and is rounded to float32 once.  On CUDA the order of a float32
reduction follows the tensor's shape, which under ``torch.func.vmap``
includes the unit count; in float64 the order no longer shows in the
float32 result, so a seed trained in an ensemble or a sweep group takes
the same step as when trained alone.
"""
from __future__ import annotations

import functools
import math
from typing import Dict, Tuple

import torch

Params = Dict[str, torch.Tensor]


def quant_spec(channels: int) -> Dict[str, Tuple[int, ...]]:
    return {"log_s": (channels,)}


def quant_init(channels: int, init_scale: float = 0.25) -> Params:
    return {"log_s": torch.full((channels,), math.log(init_scale),
                                dtype=torch.float32)}


def _ste_round(v: torch.Tensor) -> torch.Tensor:
    return v + (v.round() - v).detach()


@functools.lru_cache(maxsize=None)
def _clip_bounds(beta: int, device: torch.device
                 ) -> Tuple[torch.Tensor, torch.Tensor]:
    lo, hi = -(2 ** (beta - 1)), 2 ** (beta - 1) - 1
    return (torch.tensor(float(lo), device=device),
            torch.tensor(float(hi), device=device))


def rows_f64(t: torch.Tensor, x: torch.Tensor) -> torch.Tensor:
    """``t`` (C,) broadcast to ``x``'s shape (..., C), with its gradient
    summed over the rows in float64 (see the module docstring)."""
    return t.double().expand(x.shape).to(t.dtype)


def quant_apply(p: Params, x: torch.Tensor, beta: int) -> torch.Tensor:
    """Fake-quantize x (..., C) to beta bits; returns dequantized values.

    The clip is a ``maximum``/``minimum`` pair against float32 tensor
    bounds, as ``jnp.clip`` is: at a tie (a value that rounds to exactly
    the lowest or highest code) each side takes half the gradient.
    ``torch.clamp`` would pass all of it to the input, doubling the
    gradient of every saturated activation and of its ``log_s``."""
    s = rows_f64(torch.exp(p["log_s"]), x)
    lo, hi = _clip_bounds(beta, x.device)
    vq = torch.minimum(torch.maximum(_ste_round(x / s), lo), hi)
    return vq * s


def quant_codes(p: Params, x: torch.Tensor, beta: int) -> torch.Tensor:
    """Unsigned integer LUT codes in [0, 2^beta), int32."""
    s = torch.exp(p["log_s"])
    lo, hi = -(2 ** (beta - 1)), 2 ** (beta - 1) - 1
    q = torch.clamp(torch.round(x / s), lo, hi).to(torch.int32)
    return q + 2 ** (beta - 1)


def code_values(p: Params, beta: int) -> torch.Tensor:
    """(C, 2^beta) dequantized value of every code for every channel."""
    s = torch.exp(p["log_s"])
    codes = (torch.arange(2 ** beta, dtype=torch.float32,
                          device=s.device) - 2 ** (beta - 1))
    return s[:, None] * codes[None, :]


def bn_spec(channels: int):
    return ({"g": (channels,), "b": (channels,)},
            {"mean": (channels,), "var": (channels,)})


def bn_init(channels: int) -> Tuple[Params, Params]:
    """Identity BatchNorm: (params {g: 1, b: 0}, state {mean: 0, var:
    1}), float32."""
    return ({"g": torch.ones((channels,), dtype=torch.float32),
             "b": torch.zeros((channels,), dtype=torch.float32)},
            {"mean": torch.zeros((channels,), dtype=torch.float32),
             "var": torch.ones((channels,), dtype=torch.float32)})


def bn_apply(p: Params, state: Params, x: torch.Tensor, *, train: bool,
             momentum: float = 0.1, eps: float = 1e-5
             ) -> Tuple[torch.Tensor, Params]:
    """x: (B, C).  Returns (normalized, new_state); the running variance
    takes the biased batch variance, as the reference does.  In training
    the batch statistics and the row sums of the gradients are float64
    (see the module docstring)."""
    if not train:
        y = (x - state["mean"]) * torch.rsqrt(state["var"] + eps) \
            * p["g"] + p["b"]
        return y, state
    x64 = x.double()
    mu64 = x64.mean(dim=0)
    mu = mu64.to(x.dtype)
    var = torch.square(x64 - mu64).mean(dim=0).to(x.dtype)
    new_state = {
        "mean": (1 - momentum) * state["mean"] + momentum * mu,
        "var": (1 - momentum) * state["var"] + momentum * var,
    }
    y = (x - rows_f64(mu, x)) * rows_f64(torch.rsqrt(var + eps), x) \
        * rows_f64(p["g"], x) + rows_f64(p["b"], x)
    return y, new_state
