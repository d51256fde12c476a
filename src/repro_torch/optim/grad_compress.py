"""Gradient compression with error feedback (port of
``repro.optim.grad_compress``).

``make_ef_int8_compressor()`` is a ``compress_grads`` hook for
``make_train_step``: it fake-quantizes each gradient leaf to int8 (per-
leaf absmax scale) with an error-feedback residual carried across
steps, so a data-parallel reduction of the int8 values would keep
convergence.  ``psum_int8``, the reference's explicit compressed
collective, waits for the sharding slice.
"""
from __future__ import annotations

from typing import Any, Tuple

import torch

from repro_torch import NOT_PORTED
from repro_torch.tree import tree_leaves, tree_map, tree_unflatten


def _quantize(g: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    scale = torch.clamp(torch.max(torch.abs(g)), min=1e-12) / 127.0
    q = torch.clamp(torch.round(g / scale), -127, 127).to(torch.int8)
    return q, scale


def make_ef_int8_compressor():
    """Error-feedback int8 compressor: ``init(params)`` gives the float32
    residual tree, ``compress(grads, ef)`` -> (grads', ef'), both new
    trees."""

    def init(params):
        return tree_map(lambda p: torch.zeros(p.shape, dtype=torch.float32,
                                              device=p.device), params)

    def compress(grads, ef):
        def one(g, e):
            g32 = g.to(torch.float32) + e
            q, s = _quantize(g32)
            deq = q.to(torch.float32) * s
            return deq.to(g.dtype), g32 - deq

        outs = [one(g, e) for g, e in zip(tree_leaves(grads),
                                          tree_leaves(ef))]
        return (tree_unflatten(grads, [o[0] for o in outs]),
                tree_unflatten(grads, [o[1] for o in outs]))

    return init, compress


def psum_int8(tree: Any, axis_name: str) -> Any:
    raise NotImplementedError(
        "psum_int8 (a collective over a device mesh) " + NOT_PORTED.format(
            "Queue A item 7"))
