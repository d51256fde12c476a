"""NeuraLUT training (port of ``repro.core.train``): AdamW with
decoupled weight decay, SGDR cosine warm restarts, the
quantization-aware forward and BN state threading, for one seed
(``train_neuralut``) or an ensemble of S seeds trained together
(``train_neuralut_ensemble``).

The reference compiles each epoch into one jitted scan.  The port runs
an eager step in a Python epoch loop: the training and test sets stay
on the device, each epoch's minibatch permutation is drawn on the
device from a ``torch.Generator`` seeded from ``seed`` and the epoch,
and the per-epoch metrics stay on the device until one fetch at the
end.  Inside the step the grouped sub-network runs on the
``core.exec_plan`` train route: the CUDA training kernels on the card,
the neuron-leading layout on the CPU.

The ensemble is the reference's ``jax.vmap`` of the step:
``torch.func.vmap`` of a functional step (``torch.func.grad_and_value``
of the loss, then SGDR and AdamW) over a leading seed axis S on every
parameter, BN state and optimizer leaf.  BN batch statistics and the
optimizer's global-norm clip are per seed by construction, and the
training kernels' vmap rules make one K4 and one K5 call per layer per
step for all S seeds.  Seed s draws its init and its permutations as
``train_neuralut(seed=s)`` does, so member s follows that run's
trajectory to float32 rounding.  The statics carry the leading axis
too (the reference's ``make_step_fn_dynamic`` vmapped with its statics
on axis 0): the ensemble passes its one connectivity expanded to S (a
view, :func:`unit_statics`), and every unit of a sweep's geometry group
gathers through its own padded connectivity (``repro_torch.sweep``) on
the same path.

The permutations differ from the reference's (``jax.random`` cannot be
reproduced), so the two packages agree step by step only when they are
handed the same batches.
"""
from __future__ import annotations

import time
from typing import Dict, List, Sequence, Tuple

import numpy as np
import torch

from torch.utils import _pytree as pytree

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
    sgdr_t0: int = 0,
    log_every: int = 0,
    device: DeviceLike = None,
) -> Tuple[Dict, Dict, Dict[str, List[float]]]:
    """Train from a seeded init -> (params, state, history).  The data
    may be numpy arrays or tensors (kept where they are when already on
    ``device``); ``history`` holds per-epoch ``loss``, ``test_acc`` and
    ``test_acc_q``, fetched from the device once at the end.  SGDR's
    first cycle lasts ``sgdr_t0`` steps (0: one cycle over all steps);
    the grouped sub-network takes the planner's train route for
    ``device``."""
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
        cfg, lr=lr, weight_decay=weight_decay,
        t0=sgdr_t0 or epochs * steps,
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


# ---------------------------------------------------------------------------
# The seed ensemble: S independent restarts trained together


def unit_statics(statics, units: int):
    """``statics`` with every tensor (the connectivity) expanded to a
    leading unit axis of ``units``, as a view; host arrays (the poly
    kind's exps) stay shared."""
    return pytree.tree_map(
        lambda v: v.expand(units, *v.shape) if isinstance(v, torch.Tensor)
        else v, statics)


def _statics_dims(statics):
    """``torch.func.vmap`` in_dims of a unit-axis statics list: axis 0
    on every tensor, None on host arrays."""
    return pytree.tree_map(
        lambda v: 0 if isinstance(v, torch.Tensor) else None, statics)


def make_ensemble_step_fn(cfg: NeuraLUTConfig, *, lr: float,
                          weight_decay: float, t0: int,
                          exec_plan: SubnetExec):
    """One optimizer step of S seeds at once (the counterpart of
    ``jax.vmap(make_step_fn_dynamic(...), in_axes=(0, 0, 0, 0, 0,
    0))``): (params, state, opt, statics, xb, yb) -> (params, state,
    opt, loss), every tree, batch and statics tensor with a leading
    seed (or sweep unit) axis S (:func:`unit_statics` expands one
    connectivity).  Each seed's gradient norm is clipped on its own."""

    def loss_fn(params, state, statics, xb, yb):
        logits, _, new_state = M.model_apply(cfg, params, state, statics,
                                             xb, train=True,
                                             exec_plan=exec_plan)
        return M.ce_loss(logits, yb), new_state

    grad_fn = torch.func.grad_and_value(loss_fn, has_aux=True)

    def step_fn(params, state, opt, statics, xb, yb):
        grads, (loss, new_state) = grad_fn(params, state, statics, xb, yb)
        lr_t = sgdr_schedule(opt["count"], lr_max=lr, lr_min=lr * 1e-2,
                             t0=t0, t_mult=2)
        params, opt = adamw_update(grads, opt, params, lr=lr_t,
                                   weight_decay=weight_decay, grad_clip=1.0)
        return params, new_state, opt, loss

    def vstep(params, state, opt, statics, xb, yb):
        dims = (0, 0, 0, _statics_dims(statics), 0, 0)
        return torch.func.vmap(step_fn, in_dims=dims)(params, state, opt,
                                                      statics, xb, yb)

    return vstep


def make_ensemble_eval_fn(cfg: NeuraLUTConfig):
    """:func:`evaluate` over a leading seed (or unit) axis:
    (params, state, statics, x, y) -> (acc (S,), acc_q (S,)), the
    statics with that axis too."""

    def veval(params, state, statics, x, y):
        return torch.func.vmap(
            lambda p, s, st: evaluate(cfg, p, s, st, x, y),
            in_dims=(0, 0, _statics_dims(statics)))(params, state, statics)

    return veval


def init_ensemble(cfg: NeuraLUTConfig, seeds: Sequence[int], x_train, *,
                  device: DeviceLike = None) -> Tuple[Dict, Dict, Dict]:
    """Stacked (params, state, opt) of S restarts on ``device``: seed s
    initialized as ``train_neuralut(seed=s)`` initializes, the input
    quantizer calibrated once (it depends on the data only) and
    broadcast, the optimizer's count (S,)."""
    if not seeds:
        raise ValueError("need at least one seed")
    dev = resolve_device(device)
    members = [M.model_init(cfg, torch.Generator().manual_seed(int(s)),
                            device=dev) for s in seeds]
    params = tree_map(lambda *a: torch.stack(a), *[m[0] for m in members])
    state = tree_map(lambda *a: torch.stack(a), *[m[1] for m in members])
    calib = M.calibrate_in_quant(cfg, members[0][0], x_train)
    params["in_quant"] = {"log_s": calib["in_quant"]["log_s"]
                          .repeat(len(seeds), 1)}
    opt = adamw_init(params)
    opt["count"] = torch.zeros(len(seeds), dtype=torch.int32, device=dev)
    return params, state, opt


def train_neuralut_ensemble(
    cfg: NeuraLUTConfig,
    x_train, y_train, x_test, y_test,
    *,
    seeds: Sequence[int] = (0, 1, 2, 3),
    epochs: int = 30,
    batch: int = 256,
    lr: float = 2e-3,
    weight_decay: float = 1e-4,
    sgdr_t0: int = 0,
    log_every: int = 0,
    device: DeviceLike = None,
) -> Tuple[Dict, Dict, Dict[str, np.ndarray]]:
    """Train S networks, one per seed, together -> (stacked params,
    stacked state, history).  Seed s draws its own init and its own
    per-epoch permutation (``epoch_batches(seed=s)``), as
    ``train_neuralut(seed=s)`` does; the connectivity is one
    ``model_static(cfg)`` for all.  Each history entry is a float64
    (epochs, S) array, fetched from the device once at the end.  Use
    :func:`ensemble_member` to take one network out of the stack."""
    dev = resolve_device(device)
    xd = torch.as_tensor(x_train, device=dev)
    yd = torch.as_tensor(y_train, device=dev)
    xe = torch.as_tensor(x_test, device=dev)
    ye = torch.as_tensor(y_test, device=dev)
    statics = unit_statics(M.device_statics(M.model_static(cfg), dev),
                           len(seeds))
    params, state, opt = init_ensemble(cfg, seeds, xd, device=dev)

    n = xd.shape[0]
    batch = min(batch, n)
    steps = max(1, n // batch)
    step_fn = make_ensemble_step_fn(
        cfg, lr=lr, weight_decay=weight_decay,
        t0=sgdr_t0 or epochs * steps,
        exec_plan=plan_subnet_exec(cfg, purpose="train", device=dev))
    params, state, traces, _ = ensemble_epochs(
        step_fn, make_ensemble_eval_fn(cfg), params, state, opt, statics,
        seeds, xd, yd, xe, ye, epochs=epochs, batch=batch,
        log_every=log_every)
    history = {k: v.cpu().numpy().astype(np.float64)
               for k, v in traces.items()}
    return params, state, history


def ensemble_epochs(step_fn, eval_fn, params, state, opt, statics,
                    seeds: Sequence[int], xd, yd, xe, ye, *, epochs: int,
                    batch: int, log_every: int = 0):
    """The ensemble's epoch loop: per epoch, member s draws its
    permutation from ``seeds[s]`` (``epoch_batches``), one ``step_fn``
    call per minibatch for all members, then ``eval_fn`` on the test
    set -> (params, state, {loss, test_acc, test_acc_q: (epochs, S)
    device tensors}, seconds until the first step returned,
    synchronized)."""
    n = xd.shape[0]
    steps = max(1, n // batch)
    t0, first_s = time.perf_counter(), None
    traces: Dict[str, List[torch.Tensor]] = {
        "loss": [], "test_acc": [], "test_acc_q": []}
    for ep in range(epochs):
        idx = torch.stack([epoch_batches(n, steps, batch, seed=int(s),
                                         epoch=ep, device=xd.device)
                           for s in seeds], dim=1)   # (steps, S, batch)
        losses = []
        for ib in idx:
            params, state, opt, loss = step_fn(params, state, opt, statics,
                                               xd[ib], yd[ib])
            losses.append(loss)
            if first_s is None:
                if xd.device.type == "cuda":
                    torch.cuda.synchronize(xd.device)
                first_s = time.perf_counter() - t0
        acc, acc_q = eval_fn(params, state, statics, xe, ye)
        traces["loss"].append(torch.stack(losses).mean(dim=0))
        traces["test_acc"].append(acc)
        traces["test_acc_q"].append(acc_q)
        if log_every and (ep + 1) % log_every == 0:
            aq = acc_q.cpu().numpy()
            print(f"  epoch {ep + 1}/{epochs} loss="
                  f"{float(traces['loss'][-1].mean()):.4f} "
                  f"acc_q[best/mean]={aq.max():.4f}/{aq.mean():.4f}",
                  flush=True)
    return (params, state, {k: torch.stack(v) for k, v in traces.items()},
            first_s)


def ensemble_member(params: Dict, state: Dict, s: int) -> Tuple[Dict, Dict]:
    """Network ``s`` of an ensemble's stacked (params, state)."""
    return (tree_map(lambda a: a[s], params),
            tree_map(lambda a: a[s], state))
