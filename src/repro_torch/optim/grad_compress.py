"""Gradient compression with error feedback (port of
``repro.optim.grad_compress``).

``make_ef_int8_compressor()`` is a ``compress_grads`` hook for
``make_train_step``: it fake-quantizes each gradient leaf to int8 (per-
leaf absmax scale) with an error-feedback residual carried across
steps, so a data-parallel reduction of the int8 values would keep
convergence.

``psum_int8(tree, axis_name)`` is the reference's explicit compressed
collective over the active mesh's ranks along ``axis_name``: the scale
shared by an all-reduce MAX of the local absmax / 127, the int8 codes,
an int32 all-reduce SUM of them, dequantized.  Integer sums and a MAX
are exact, so it equals the reference's bit for bit on equal inputs.
"""
from __future__ import annotations

from typing import Any, Tuple

import torch

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


def psum_int8(tree: Any, axis_name) -> Any:
    """Compressed sum of every leaf over the active mesh's ranks along
    ``axis_name`` (an axis name or a tuple of them), in the leaf's dtype.

    The scale is SHARED across ranks before quantizing (a scalar
    all-reduce MAX), so the sum of the int8 codes times the scale has
    one meaning; the codes are summed as int32 (no overflow across
    >= 256 ranks).  Outside an active mesh the axis is unbound, as in
    JAX outside ``shard_map``."""
    from repro_torch.sharding import ctx
    mesh = ctx.get_active_mesh()
    names = (axis_name,) if isinstance(axis_name, str) else tuple(axis_name)
    if mesh is None or any(a not in mesh.axes for a in names):
        raise NameError(f"unbound axis name: {axis_name}")

    def one(g):
        g32 = g.to(torch.float32)
        local = torch.clamp(torch.max(torch.abs(g32)), min=1e-12) / 127.0
        scale = mesh.all_reduce(local, "max", names)
        q = torch.clamp(torch.round(g32 / scale), -127, 127).to(torch.int8)
        tot = mesh.all_reduce(q.to(torch.int32), "sum", names)
        return (tot.to(torch.float32) * scale).to(g.dtype)

    return tree_map(one, tree)
