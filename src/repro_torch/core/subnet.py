"""The function hidden inside each L-LUT (port of ``repro.core.subnet``,
the ``subnet`` kind on the canonical layout).

    f = F_{L/S} o phi o F_{L/S-1} o ... o phi o F_1,
    F_i(x) = hatF_i(x) + R_i(x),
    hatF_i = A_{Si} o phi o ... o phi o A_{S(i-1)+1}

(S=0: plain MLP, no skips; phi = ReLU.)  Parameters carry a leading
neuron dim O and every dense layer is the grouped product
``'boi,oij->boj'`` — the layout the truth tables are defined against.
The neuron-leading layout and the linear/poly kinds are not ported yet.
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


def subnet_apply(p: Params, x: torch.Tensor, S: int) -> torch.Tensor:
    """x: (B, O, F) -> (B, O).  The canonical route: the plain grouped
    sub-network of ``kernels/ref.py``, which the CUDA kernel of
    ``kernels/neuralut_mlp.py`` is held against."""
    return grouped_subnet_ref(
        x, [lp["w"] for lp in p["layers"]], [lp["b"] for lp in p["layers"]],
        [sp["w"] for sp in p.get("skips", [])],
        [sp["b"] for sp in p.get("skips", [])], skip=S)
