"""Train/serve step factories for the LMs (port of ``repro.train.step``).

``make_train_step`` builds the full step: loss -> grad -> optional
gradient compression -> SGDR learning rate -> AdamW with the global-
norm clip -> new params.  With ``grad_accum > 1`` the batch is split
into that many microbatches along its first dim, their gradients summed
in float32 and averaged, with the update once at the end.

The step is a pure function of (params, opt_state, batch): it builds
new trees and never writes into its inputs, so a caller (the training
supervisor) may still save or restore from the carry it passed in.
"""
from __future__ import annotations

from typing import Any, Callable, Dict, Optional

import torch

from repro_torch.config.base import ModelConfig, TrainConfig
from repro_torch.models import api
from repro_torch.optim import adamw_update, sgdr_schedule
from repro_torch.tree import tree_leaves, tree_map, tree_unflatten


def value_and_grad(loss_fn: Callable, params, batch):
    """((loss, metrics), grads) of ``loss_fn(params, batch)`` with
    respect to every leaf of ``params``, metrics detached; grads shaped
    and typed like the params (zeros where a leaf is unused)."""
    p = tree_map(lambda a: a.detach().requires_grad_(True), params)
    loss, metrics = loss_fn(p, batch)
    leaves = tree_leaves(p)
    grads = torch.autograd.grad(loss, leaves, allow_unused=True)
    grads = [torch.zeros_like(a) if g is None else g
             for a, g in zip(leaves, grads)]
    metrics = {k: v.detach() for k, v in metrics.items()}
    return (loss.detach(), metrics), tree_unflatten(params, grads)


def make_train_step(cfg: ModelConfig, tcfg: TrainConfig, *,
                    q_chunk: int = 512,
                    compress_grads: Optional[Callable] = None):
    """Returns step(params, opt_state, batch) -> (params, opt_state,
    metrics); metrics hold ``loss``, ``lr``, ``ce`` and ``moe_aux``."""

    loss_fn = make_loss_fn(cfg, tcfg, q_chunk=q_chunk)

    def step(params, opt_state, batch):
        grads, (loss, metrics) = loss_and_grads(loss_fn, params, batch,
                                                tcfg.grad_accum)
        if compress_grads is not None:
            grads = compress_grads(grads)
        lr = sgdr_schedule(opt_state["count"], lr_max=tcfg.lr,
                           lr_min=tcfg.lr_min, t0=tcfg.sgdr_t0,
                           t_mult=tcfg.sgdr_t_mult)
        params, opt_state = adamw_update(
            grads, opt_state, params, lr=lr, beta1=tcfg.beta1,
            beta2=tcfg.beta2, eps=tcfg.eps, weight_decay=tcfg.weight_decay,
            grad_clip=tcfg.grad_clip)
        metrics = dict(metrics, loss=loss, lr=lr)
        return params, opt_state, metrics

    return step


def make_loss_fn(cfg: ModelConfig, tcfg: TrainConfig, *,
                 q_chunk: int = 512) -> Callable:
    """loss_fn(params, batch) -> (loss, metrics) at ``tcfg``'s layer
    mode and remat policy."""
    def loss_fn(params, batch):
        return api.loss_fn(cfg, params, batch, layer_mode=tcfg.layer_mode,
                           remat=tcfg.remat, q_chunk=q_chunk)
    return loss_fn


def loss_and_grads(loss_fn: Callable, params, batch: Dict[str, Any],
                   accum: int = 1):
    """(grads, (loss, metrics)): one value-and-grad, or ``accum``
    microbatches along the batch's first dim."""
    if accum > 1:
        return _accum_grads(loss_fn, params, batch, accum)
    (loss, metrics), grads = value_and_grad(loss_fn, params, batch)
    return grads, (loss, metrics)


def _accum_grads(loss_fn, params, batch: Dict[str, Any], accum: int):
    """Microbatch gradient accumulation over batch slices: float32
    gradient sums, mean loss, the last microbatch's metrics."""
    def slice_mb(x, i):
        b = x.shape[0]
        assert b % accum == 0, (b, accum)
        return x[i * (b // accum):(i + 1) * (b // accum)]

    g_acc = tree_map(lambda p: torch.zeros(p.shape, dtype=torch.float32,
                                           device=p.device), params)
    loss_acc = None
    metrics = None
    for i in range(accum):
        mb = {k: slice_mb(v, i) for k, v in batch.items()}
        (loss, metrics), g = value_and_grad(loss_fn, params, mb)
        g_acc = tree_map(lambda a, b_: a + b_.to(torch.float32), g_acc, g)
        loss_acc = loss if loss_acc is None else loss_acc + loss
    g = tree_map(lambda a: a / accum, g_acc)
    return g, (loss_acc / accum, metrics)


def make_serve_step(cfg: ModelConfig, *, layer_mode: str = "scan"):
    """Returns step(params, state, token) -> (logits, new_state), run
    without autograd."""

    @torch.no_grad()
    def step(params, state, token):
        return api.decode_step(cfg, params, state, token,
                               layer_mode=layer_mode)

    return step
