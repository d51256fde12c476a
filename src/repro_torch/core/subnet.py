"""The function hidden inside each L-LUT (port of ``repro.core.subnet``,
the ``subnet`` kind).

    f = F_{L/S} o phi o F_{L/S-1} o ... o phi o F_1,
    F_i(x) = hatF_i(x) + R_i(x),
    hatF_i = A_{Si} o phi o ... o phi o A_{S(i-1)+1}

(S=0: plain MLP, no skips; phi = ReLU.)  Parameters carry a leading
neuron dim O.  On the canonical layout every dense layer is the grouped
product ``'boi,oij->boj'`` — the layout the truth tables are defined
against; the neuron-leading layout (``batch_leading=True``) runs the
same ops on (O, B, n) (the reference's CPU training route).  The
linear/poly kinds are not ported yet.
"""
from __future__ import annotations

from typing import Any, Dict, List

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
