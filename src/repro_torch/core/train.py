"""NeuraLUT training (port of ``repro.core.train``, one seed): AdamW
with decoupled weight decay, SGDR cosine warm restarts, the
quantization-aware forward and BN state threading.

The reference compiles each epoch into one jitted scan.  The port runs
an eager step in a Python epoch loop: the training and test sets stay
on the device, each epoch's minibatch permutation is drawn on the
device from a ``torch.Generator`` seeded from ``seed`` and the epoch,
and the per-epoch metrics stay on the device until one fetch at the
end.  Inside the step the grouped sub-network runs on the
``core.exec_plan`` train route: the CUDA training kernels on the card,
the neuron-leading layout on the CPU.

The permutations differ from the reference's (``jax.random`` cannot be
reproduced), so the two packages agree step by step only when they are
handed the same batches.
"""
from __future__ import annotations

from typing import Dict, List, Tuple

import numpy as np
import torch

from repro_torch.core import model as M
from repro_torch.core.exec_plan import SubnetExec, plan_subnet_exec
from repro_torch.core.nl_config import NeuraLUTConfig
from repro_torch.device import DeviceLike, resolve_device
from repro_torch.optim import adamw_init, adamw_update, sgdr_schedule
from repro_torch.tree import tree_leaves, tree_map, tree_unflatten


def loss_and_grads(cfg: NeuraLUTConfig, params, state, statics,
                   xb: torch.Tensor, yb: torch.Tensor, *,
                   exec_plan: SubnetExec):
    """Training forward and backward of one batch -> (loss, grads shaped
    like ``params``, new BN state), all detached."""
    p = tree_map(lambda a: a.detach().requires_grad_(True), params)
    logits, _, new_state = M.model_apply(cfg, p, state, statics, xb,
                                         train=True, exec_plan=exec_plan)
    loss = M.ce_loss(logits, yb)
    leaves = tree_leaves(p)
    # The loss reads the last layer's pre-quant logits, so that layer's
    # quantizer scale gets no gradient: zero, as jax.grad gives it.
    grads = torch.autograd.grad(loss, leaves, allow_unused=True)
    grads = [torch.zeros_like(a) if g is None else g
             for a, g in zip(leaves, grads)]
    return (loss.detach(), tree_unflatten(params, grads),
            tree_map(torch.Tensor.detach, new_state))


def make_step_fn(cfg: NeuraLUTConfig, *, lr: float, weight_decay: float,
                 t0: int, exec_plan: SubnetExec):
    """One optimizer step (the counterpart of
    ``make_step_fn_dynamic``): (params, state, opt, statics, xb, yb) ->
    (params, state, opt, loss).  The learning rate comes from SGDR at
    the optimizer's count, the update clips the global norm at 1."""

    def step_fn(params, state, opt, statics, xb, yb):
        loss, grads, new_state = loss_and_grads(
            cfg, params, state, statics, xb, yb, exec_plan=exec_plan)
        lr_t = sgdr_schedule(opt["count"], lr_max=lr, lr_min=lr * 1e-2,
                             t0=t0, t_mult=2)
        params, opt = adamw_update(grads, opt, params, lr=lr_t,
                                   weight_decay=weight_decay, grad_clip=1.0)
        return params, new_state, opt, loss

    return step_fn


@torch.no_grad()
def evaluate(cfg: NeuraLUTConfig, params, state, statics,
             x: torch.Tensor, y: torch.Tensor
             ) -> Tuple[torch.Tensor, torch.Tensor]:
    """(accuracy of the pre-quant logits, accuracy of the quantized class
    values) as device scalars; always the canonical eval route, the one
    the truth tables are bit-exact against."""
    logits, values, _ = M.model_apply(cfg, params, state, statics, x,
                                      train=False)
    return (M.accuracy_from_values(logits, y),
            M.accuracy_from_values(values, y))


def epoch_batches(n: int, steps: int, batch: int, *, seed: int, epoch: int,
                  device: torch.device) -> torch.Tensor:
    """(steps, batch) int64 row indices: a permutation of ``n`` drawn on
    ``device`` from a generator seeded from (seed, epoch)."""
    gen = torch.Generator(device=device)
    gen.manual_seed(seed * 1_000_003 + epoch)
    perm = torch.randperm(n, generator=gen, device=device)
    return perm[:steps * batch].view(steps, batch)


def train_neuralut(
    cfg: NeuraLUTConfig,
    x_train, y_train, x_test, y_test,
    *,
    epochs: int = 30,
    batch: int = 256,
    lr: float = 2e-3,
    weight_decay: float = 1e-4,
    seed: int = 0,
    log_every: int = 0,
    device: DeviceLike = None,
) -> Tuple[Dict, Dict, Dict[str, List[float]]]:
    """Train from a seeded init -> (params, state, history).  The data
    may be numpy arrays or tensors (kept where they are when already on
    ``device``); ``history`` holds per-epoch ``loss``, ``test_acc`` and
    ``test_acc_q``, fetched from the device once at the end.  SGDR runs
    one cosine cycle over all steps; the grouped sub-network takes the
    planner's train route for ``device``."""
    dev = resolve_device(device)
    xd = torch.as_tensor(x_train, device=dev)
    yd = torch.as_tensor(y_train, device=dev)
    xe = torch.as_tensor(x_test, device=dev)
    ye = torch.as_tensor(y_test, device=dev)
    statics = M.device_statics(M.model_static(cfg), dev)
    params, state = M.model_init(cfg, torch.Generator().manual_seed(seed),
                                 device=dev)
    params = M.calibrate_in_quant(cfg, params, xd)
    opt = adamw_init(params)

    n = xd.shape[0]
    batch = min(batch, n)
    steps = max(1, n // batch)
    step_fn = make_step_fn(
        cfg, lr=lr, weight_decay=weight_decay, t0=epochs * steps,
        exec_plan=plan_subnet_exec(cfg, purpose="train", device=dev))

    traces: Dict[str, List[torch.Tensor]] = {
        "loss": [], "test_acc": [], "test_acc_q": []}
    for ep in range(epochs):
        idx = epoch_batches(n, steps, batch, seed=seed, epoch=ep, device=dev)
        losses = []
        for ib in idx:
            params, state, opt, loss = step_fn(params, state, opt, statics,
                                               xd[ib], yd[ib])
            losses.append(loss)
        acc, acc_q = evaluate(cfg, params, state, statics, xe, ye)
        traces["loss"].append(torch.stack(losses).mean())
        traces["test_acc"].append(acc)
        traces["test_acc_q"].append(acc_q)
        if log_every and (ep + 1) % log_every == 0:
            print(f"  epoch {ep + 1}/{epochs} loss="
                  f"{float(traces['loss'][-1]):.4f} acc={float(acc):.4f} "
                  f"acc_q={float(acc_q):.4f}", flush=True)
    history = {k: np.asarray(torch.stack(v).cpu()).tolist()
               for k, v in traces.items()}
    return params, state, history
