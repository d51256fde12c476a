"""AdamW with decoupled weight decay and a global-norm clip (port of
``repro.optim.adamw``), written out by hand: ``torch.optim.AdamW``
decays by multiplying the parameter before the step, and
``clip_grad_norm_`` divides by ``norm + 1e-6``; the reference does
neither.

State: {"m": tree, "v": tree, "count": int32 scalar}, trees of float32
tensors shaped like the parameters, and, when any parameter is
bfloat16, {"master": tree} as in the reference: a float32 copy of each
bfloat16 parameter (``None`` for the others) that the update steps, so
that repeated tiny updates do not underflow; the parameter is the
master rounded to bfloat16.  NeuraLUT's parameters are all float32, so
its state has no ``master`` (the reference's is all ``None``).  The
update builds new tensors (as the reference's pure function does)
rather than writing in place, so a caller may keep the old state.
"""
from __future__ import annotations

from typing import Any, Dict, Tuple

import torch

from repro_torch.tree import tree_leaves, tree_map, tree_unflatten

OptState = Dict[str, Any]


def adamw_init(params) -> OptState:
    def zeros32(p):
        return torch.zeros(p.shape, dtype=torch.float32, device=p.device)
    leaves = tree_leaves(params)
    state = {"m": tree_map(zeros32, params), "v": tree_map(zeros32, params),
             "count": torch.zeros((), dtype=torch.int32,
                                  device=leaves[0].device)}
    if any(p.dtype == torch.bfloat16 for p in leaves):
        state["master"] = tree_map(
            lambda p: p.to(torch.float32) if p.dtype == torch.bfloat16
            else None, params)
    return state


def adamw_init_spec(param_spec) -> OptState:
    """``TensorSpec`` mirror of :func:`adamw_init` (shapes and dtypes,
    no storage) over a tree of ``TensorSpec``: float32 ``m`` and ``v``,
    an int32 scalar ``count`` and, when any leaf is bfloat16, float32
    ``master`` specs of the bfloat16 leaves (``None`` for the others).
    The reference's always holds ``master``, all ``None`` for a tree
    without bfloat16, where ``adamw_init`` has none."""
    from repro_torch.models.layers.common import TensorSpec

    def f32(p):
        return TensorSpec(tuple(p.shape), torch.float32)

    leaves = tree_leaves(param_spec)
    state = {"m": tree_map(f32, param_spec), "v": tree_map(f32, param_spec),
             "count": TensorSpec((), torch.int32)}
    if any(p.dtype == torch.bfloat16 for p in leaves):
        state["master"] = tree_map(
            lambda p: f32(p) if p.dtype == torch.bfloat16 else None,
            param_spec)
    return state


def adamw_update(grads, state: OptState, params, *, lr,
                 beta1: float = 0.9, beta2: float = 0.999,
                 eps: float = 1e-8, weight_decay: float = 0.0,
                 grad_clip: float = 0.0,
                 clip_from=None) -> Tuple[Any, OptState]:
    """One AdamW step -> (new params, new state).  ``lr`` may be a
    float32 tensor (the SGDR schedule's).  The clip scale is
    ``min(1, clip / max(gnorm, 1e-12))`` with the norm over all leaves;
    ``clip_from`` is the tree that norm is taken over when it is not
    ``grads`` (a mesh step updates a rank's shards by the norm of the
    whole gradient); the step is ``lr * (mh / (sqrt(vh) + eps) + wd *
    base)`` where ``base`` is the float32 master of a bfloat16
    parameter, else the parameter.  Under ``torch.func.vmap`` over a leading seed axis (the
    ensemble step) the norm, and so the clip, is each seed's own."""
    count = state["count"] + 1
    cf = count.to(torch.float32)
    bc1 = 1.0 - beta1 ** cf
    bc2 = 1.0 - beta2 ** cf
    if grad_clip > 0:
        # float64, so that the sum's order (on CUDA it follows the
        # leaf's shape, the seed count included) does not show
        gsq = sum(torch.sum(torch.square(g.to(torch.float64)))
                  for g in tree_leaves(grads if clip_from is None
                                       else clip_from))
        gnorm = torch.sqrt(gsq).to(torch.float32)
        scale = torch.clamp(grad_clip / torch.clamp(gnorm, min=1e-12),
                            max=1.0)
    else:
        scale = None
    has_master = "master" in state
    masters = (tree_leaves(state["master"]) if has_master
               else [None] * len(tree_leaves(params)))

    def upd(g, m, v, p, master):
        g32 = g.to(torch.float32)
        if scale is not None:
            g32 = g32 * scale
        m2 = beta1 * m + (1 - beta1) * g32
        v2 = beta2 * v + (1 - beta2) * g32 * g32
        mh = m2 / bc1
        vh = v2 / bc2
        base = master if master is not None else p.to(torch.float32)
        new_master = base - lr * (mh / (torch.sqrt(vh) + eps)
                                  + weight_decay * base)
        return (new_master.to(p.dtype), m2, v2,
                new_master if master is not None else None)

    outs = [upd(*z) for z in zip(tree_leaves(grads), tree_leaves(state["m"]),
                                 tree_leaves(state["v"]),
                                 tree_leaves(params), masters)]
    new_state = {"m": tree_unflatten(params, [o[1] for o in outs]),
                 "v": tree_unflatten(params, [o[2] for o in outs]),
                 "count": count}
    if has_master:
        new_state["master"] = tree_unflatten(params, [o[3] for o in outs])
    return tree_unflatten(params, [o[0] for o in outs]), new_state
