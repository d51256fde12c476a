"""The function hidden inside each L-LUT (port of ``repro.core.subnet``).

Three neuron kinds, each batched over a whole circuit layer of O
neurons:

  * ``subnet`` (NeuraLUT): an MLP of depth L, width N, skip period S,

        f = F_{L/S} o phi o F_{L/S-1} o ... o phi o F_1,
        F_i(x) = hatF_i(x) + R_i(x),
        hatF_i = A_{Si} o phi o ... o phi o A_{S(i-1)+1}

    (S=0: plain MLP, no skips; phi = ReLU);
  * ``linear`` (LogicNets): one affine map;
  * ``poly`` (PolyLUT): every monomial of the F inputs up to degree D,
    then a linear map.

Parameters carry a leading neuron dim O.  On the canonical layout every
dense layer is the grouped product ``'boi,oij->boj'`` — the layout the
truth tables are defined against; the neuron-leading layout
(``batch_leading=True``) runs the same ops on (O, B, n) (the
reference's CPU training route).  ``param_count_formula`` is the
paper's Table I / eqs. (5)-(7).
"""
from __future__ import annotations

import itertools
from typing import Any, Dict, List, Optional

import numpy as np

import torch

from repro_torch.kernels.ref import grouped_subnet_ref

Params = Dict[str, Any]


def _widths(F: int, L: int, N: int) -> List[int]:
    """n_0=F, n_1..n_{L-1}=N, n_L=1 (paper: n_out=1 per L-LUT)."""
    return [F] + [N] * (L - 1) + [1]


def subnet_spec(out_width: int, F: int, L: int, N: int, S: int) -> Params:
    """Shape tree of one layer's sub-networks (same keys as the JAX
    ``subnet_spec``)."""
    w = _widths(F, L, N)
    spec: Params = {"layers": [
        {"w": (out_width, w[i], w[i + 1]), "b": (out_width, w[i + 1])}
        for i in range(L)]}
    if S > 0:
        if L % S:
            raise ValueError(f"depth {L} is not a multiple of skip {S}")
        spec["skips"] = [
            {"w": (out_width, w[i * S], w[(i + 1) * S]),
             "b": (out_width, w[(i + 1) * S])}
            for i in range(L // S)]
    return spec


def subnet_apply(p: Params, x: torch.Tensor, S: int, *,
                 batch_leading: bool = False) -> torch.Tensor:
    """x: (B, O, F) -> (B, O).

    Canonical: the plain grouped sub-network of ``kernels/ref.py``,
    which the CUDA kernels are held against.  ``batch_leading=True``:
    the same stack in neuron-leading (O, B, n) layout, one transpose in
    and one out, every layer a batched product over neurons; equal to
    the canonical route to float32 rounding, not bit for bit."""
    lw = [lp["w"] for lp in p["layers"]]
    lb = [lp["b"] for lp in p["layers"]]
    sw = [sp["w"] for sp in p.get("skips", [])]
    sb = [sp["b"] for sp in p.get("skips", [])]
    if not batch_leading:
        return grouped_subnet_ref(x, lw, lb, sw, sb, skip=S)

    def mm(h, w, b):
        return torch.bmm(h, w) + b[:, None, :]

    h = x.transpose(0, 1)                              # (O, B, F)
    L = len(lw)
    if S == 0:
        for i in range(L):
            h = mm(h, lw[i], lb[i])
            if i < L - 1:
                h = torch.relu(h)
        return h[..., 0].T
    nch = L // S
    for c in range(nch):
        res = mm(h, sw[c], sb[c])
        hh = h
        for j in range(S):
            hh = mm(hh, lw[c * S + j], lb[c * S + j])
            if j < S - 1:
                hh = torch.relu(hh)
        h = hh + res
        if c < nch - 1:
            h = torch.relu(h)
    return h[..., 0].T


def apply_hidden(kind: str, p: Params, x: torch.Tensor, *, skip: int = 0,
                 exps: Optional[np.ndarray] = None,
                 batch_leading: bool = False) -> torch.Tensor:
    """The plain hidden function of any kind: (B, O, F) -> (B, O)."""
    if kind == "linear":
        return linear_apply(p, x)
    if kind == "poly":
        return poly_apply(p, x, exps)
    return subnet_apply(p, x, skip, batch_leading=batch_leading)


# ---------------------------------------------------------------------------
# LogicNets: the linear neuron


def linear_spec(out_width: int, F: int) -> Params:
    return {"w": (out_width, F), "b": (out_width,)}


def linear_apply(p: Params, x: torch.Tensor) -> torch.Tensor:
    """x: (B, O, F) -> (B, O)."""
    return torch.einsum("bof,of->bo", x, p["w"]) + p["b"]


# ---------------------------------------------------------------------------
# PolyLUT: the polynomial neuron


def monomial_exponents(F: int, D: int) -> np.ndarray:
    """(C(F+D, D), F) int32: every exponent vector of total degree 0 to
    D, in the reference's order (by degree, then
    ``combinations_with_replacement``)."""
    rows = []
    for deg in range(D + 1):
        for combo in itertools.combinations_with_replacement(range(F), deg):
            e = np.zeros(F, np.int32)
            for i in combo:
                e[i] += 1
            rows.append(e)
    return np.stack(rows)


def poly_spec(out_width: int, F: int, D: int) -> Params:
    return {"w": (out_width, len(monomial_exponents(F, D)))}


def poly_apply(p: Params, x: torch.Tensor, exps: np.ndarray) -> torch.Tensor:
    """x: (B, O, F) -> (B, O) through the monomial features ``exps``
    ((M, F), a host array: its column maxima bound the loops).

    A monomial is built by masked repeated multiplication, not
    ``torch.pow``: the gradient of x^0 is 0 * x^-1, NaN at the exact
    zeros that quantized activations produce."""
    exps = np.asarray(exps)
    m, f = exps.shape
    feats = torch.ones(x.shape[:-1] + (m,), dtype=x.dtype, device=x.device)
    for j in range(f):
        col_max = int(exps[:, j].max())
        if col_max == 0:
            continue
        xj = x[..., j, None]                               # (B, O, 1)
        ej = torch.as_tensor(exps[:, j], device=x.device)  # (M,)
        for k in range(1, col_max + 1):
            feats = feats * torch.where(ej >= k, xj, torch.ones_like(xj))
    return torch.einsum("bom,om->bo", feats, p["w"])


# ---------------------------------------------------------------------------
# Table I / eqs. (5)-(7)


def t_affine(d1: int, d2: int) -> int:
    return d1 * d2 + d2


def param_count_formula(F: int, L: int, N: int, S: int) -> int:
    """T_N = T_A + T_R (eqs. 5-7)."""
    if L == 1:
        ta = F + 1
    elif L == 2:
        ta = (F + 2) * N + 1
    else:
        ta = (L - 2) * N * N + (F + L) * N + 1
    if S == 0:
        return ta
    c = L // S
    if c == 1:
        tr = F + 1
    elif c == 2:
        tr = (F + 2) * N + 1
    else:
        tr = (c - 2) * N * N + (F + c) * N + 1
    return ta + tr


def neuron_param_count(cfg, layer_idx: int) -> int:
    F = cfg.layer_fan_in(layer_idx)
    if cfg.kind == "linear":
        return F + 1
    if cfg.kind == "poly":
        return len(monomial_exponents(F, cfg.degree))
    return param_count_formula(F, cfg.depth, cfg.width, cfg.skip)
