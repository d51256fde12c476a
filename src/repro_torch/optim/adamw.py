"""AdamW with decoupled weight decay and a global-norm clip (port of
``repro.optim.adamw``), written out by hand: ``torch.optim.AdamW``
decays by multiplying the parameter before the step, and
``clip_grad_norm_`` divides by ``norm + 1e-6``; the reference does
neither.

State: {"m": tree, "v": tree, "count": int32 scalar}, trees of float32
tensors shaped like the parameters.  The reference also keeps a
``master`` tree of float32 copies for bf16 parameters; NeuraLUT's
parameters are all float32, so its ``master`` is all ``None`` and the
port drops it.  The update builds new tensors (as the reference's pure
function does) rather than writing in place, so a caller may keep the
old state.
"""
from __future__ import annotations

from typing import Any, Dict, Tuple

import torch

from repro_torch.tree import tree_leaves, tree_map, tree_unflatten

OptState = Dict[str, Any]


def adamw_init(params) -> OptState:
    def zeros32(p):
        return torch.zeros(p.shape, dtype=torch.float32, device=p.device)
    dev = tree_leaves(params)[0].device
    return {"m": tree_map(zeros32, params), "v": tree_map(zeros32, params),
            "count": torch.zeros((), dtype=torch.int32, device=dev)}


def adamw_update(grads, state: OptState, params, *, lr,
                 beta1: float = 0.9, beta2: float = 0.999,
                 eps: float = 1e-8, weight_decay: float = 0.0,
                 grad_clip: float = 0.0) -> Tuple[Any, OptState]:
    """One AdamW step -> (new params, new state).  ``lr`` may be a
    float32 tensor (the SGDR schedule's).  The clip scale is
    ``min(1, clip / max(gnorm, 1e-12))`` with the norm over all leaves;
    the step is ``lr * (mh / (sqrt(vh) + eps) + wd * p)``.  Under
    ``torch.func.vmap`` over a leading seed axis (the ensemble step)
    the norm, and so the clip, is each seed's own."""
    count = state["count"] + 1
    cf = count.to(torch.float32)
    bc1 = 1.0 - beta1 ** cf
    bc2 = 1.0 - beta2 ** cf
    if grad_clip > 0:
        gsq = sum(torch.sum(torch.square(g.to(torch.float32)))
                  for g in tree_leaves(grads))
        gnorm = torch.sqrt(gsq)
        scale = torch.clamp(grad_clip / torch.clamp(gnorm, min=1e-12),
                            max=1.0)
    else:
        scale = None

    def upd(g, m, v, p):
        g32 = g.to(torch.float32)
        if scale is not None:
            g32 = g32 * scale
        m2 = beta1 * m + (1 - beta1) * g32
        v2 = beta2 * v + (1 - beta2) * g32 * g32
        mh = m2 / bc1
        vh = v2 / bc2
        base = p.to(torch.float32)
        step = lr * (mh / (torch.sqrt(vh) + eps) + weight_decay * base)
        return ((base - step).to(p.dtype), m2, v2)

    outs = [upd(*z) for z in zip(tree_leaves(grads), tree_leaves(state["m"]),
                                 tree_leaves(state["v"]),
                                 tree_leaves(params))]
    return (tree_unflatten(params, [o[0] for o in outs]),
            {"m": tree_unflatten(params, [o[1] for o in outs]),
             "v": tree_unflatten(params, [o[2] for o in outs]),
             "count": count})

