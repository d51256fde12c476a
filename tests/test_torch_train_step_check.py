"""The training paths' step-1 check (``chip_smoke.train_step_check``) on
the CPU, on planted routes, for the chain ``neuralut-jsc-5l`` and the
LUT graph ``polylut-add-jsc-5l`` at full width.

On the card the check holds one step's gradients through the training
kernels against plain autograd.
The two routes round the hidden function differently, so a value within
rounding of a ``round()`` boundary can take neighbouring codes in the
two routes, and everything downstream then differs by more than the
tolerance: 3 of 160 connectivities on the card.  The check now walks the
plain route on the kernel route's quantized activations.  Here the
"kernel" route is the plain one with a planted change, and the check
must:

* pass a route that differs by rounding-size nudges that flip five to
  eight codes of the first branch (which the direct comparison
  of the two routes' gradients fails, as the card's did);
* fail a route whose gradient is off by 1e-3 (forward unchanged);
* fail a route whose forward is off by 1e-3 on one neuron.
"""
import importlib.util
from pathlib import Path

import numpy as np
import pytest
import torch

from repro_torch.config import get_config
from repro_torch.core import model as M
from repro_torch.core import quant
from repro_torch.core import train as TR
from repro_torch.core.exec_plan import plan_subnet_exec
from repro_torch.core.nl_config import is_graph_config
from repro_torch.core.sparsity import random_connectivity
from repro_torch.data import jsc_synthetic

torch.set_num_threads(1)

_spec = importlib.util.spec_from_file_location(
    "chip_smoke", Path(__file__).resolve().parents[1] / "chip_smoke.py")
C = importlib.util.module_from_spec(_spec)
_spec.loader.exec_module(C)


FLIPS = 8   # codes of the first branch flipped by rounding-size nudges


class _Planted:
    """The canonical route with a planted change in the first branch's
    hidden function: ``delta`` added to its output (a constant: the
    gradient is untouched), or its gradient scaled by ``1 + gscale``
    (the forward untouched).  Branches are told apart by the order of
    the calls, ``calls`` of them per forward."""

    route = "kernel_train"

    def __init__(self, base, calls, delta=None, gscale=0.0):
        self.base, self.per_forward = base, calls
        self.delta, self.gscale, self.calls = delta, gscale, 0

    def apply(self, p, xg, *, exps=None):
        f = self.base.apply(p, xg, exps=exps)
        first = self.calls % self.per_forward == 0
        self.calls += 1
        if first and self.delta is not None:
            f = f + self.delta
        if first and self.gscale:
            f = f + self.gscale * (f - f.detach())
        return f


def _statics(cfg):
    """Connectivity from fixed seeds: the same in every process."""
    if is_graph_config(cfg):
        return [{"conns": [random_connectivity(
            cfg.node_in_width(i), nd.width, nd.fan_in, seed=10 * i + a)
            for a in range(nd.arity)]} for i, nd in enumerate(cfg.nodes)]
    w = M.model_widths(cfg)
    return [{"conn": random_connectivity(w[i], w[i + 1],
                                         cfg.layer_fan_in(i), seed=i)}
            for i in range(cfg.num_layers)]


@pytest.fixture(scope="module", params=["neuralut-jsc-5l",
                                        "polylut-add-jsc-5l"])
def setup(request):
    cfg = get_config(request.param)
    sd = M.device_statics(_statics(cfg), "cpu")
    x, y = (torch.as_tensor(a) for a in jsc_synthetic(2048, seed=0))
    p0, s0 = M.model_init(cfg, torch.Generator().manual_seed(0),
                          device="cpu")
    p0 = M.calibrate_in_quant(cfg, p0, x)
    plan = plan_subnet_exec(cfg, purpose="train", device="cpu",
                            route="canonical")
    return cfg, p0, s0, sd, x[:C.TRAIN_B], y[:C.TRAIN_B], plan


def _calls(cfg):
    """Hidden-function calls per forward: one per branch."""
    if is_graph_config(cfg):
        return sum(nd.arity for nd in cfg.nodes)
    return cfg.num_layers


def _first_branch(cfg, p0, s0, sd, xb, plan):
    """The first branch's (hidden function output, BN params) at init."""
    lp, ls = p0["layers"][0], s0["layers"][0]
    if is_graph_config(cfg):
        fnp, bnp, bns = M.node_branch_params(cfg.nodes[0], lp, ls)[0]
    else:
        fnp, bnp, bns = lp["fn"], lp["bn"], ls["bn"]
    with torch.no_grad():
        v = quant.quant_apply(p0["in_quant"], xb, cfg.beta_in or cfg.beta)
        f = plan.apply(fnp, v[:, M.node_static_conns(sd[0])[0]])
    return f, bnp, bns


def _flip_delta(cfg, p0, s0, sd, xb, plan, n=FLIPS):
    """A (B, O) tensor, zero but at the first branch's ``n`` elements
    nearest a rounding boundary of its quantizer, where it moves each
    pre-quantization value across the boundary by as much as it lay
    short of it, where that is within half the check's tolerance.
    Returns it and the number of elements it nudges."""
    f, bnp, bns = _first_branch(cfg, p0, s0, sd, xb, plan)
    with torch.no_grad():
        pre, _ = quant.bn_apply(bnp, bns, f, train=True)
        s = torch.exp(p0["layers"][0]["quant"]["log_s"])
        t = pre / s
        lim = 2 ** (cfg.beta - 1) - 1
        dist = (t - torch.floor(t) - 0.5).abs()
        dist[t.abs() > lim - 1] = float("inf")   # away from the clip
        # rounding size: within half the check's tolerance
        dist[2 * dist * s > 0.5 * (C.K5_ATOL + C.K5_RTOL * pre.abs())] = \
            float("inf")
        var = f.double().var(dim=0, unbiased=False)
        delta = torch.zeros_like(f)
        near = torch.argsort(dist.flatten())[:n]
        near = near[torch.isfinite(dist.flatten()[near])]
        for r, o in zip(*np.unravel_index(near.numpy(), dist.shape)):
            d_pre = 2 * (torch.floor(t[r, o]) + 0.5 - t[r, o]) * s[o]
            delta[r, o] = d_pre / (bnp["g"][o]
                                   * torch.rsqrt(var[o] + 1e-5).float())
    return delta, len(near)


def test_a_rounding_flip_passes_the_walk_and_fails_the_direct_check(setup):
    cfg, p0, s0, sd, xb, yb, plan = setup
    delta, nudged = _flip_delta(cfg, p0, s0, sd, xb, plan)
    assert nudged >= FLIPS // 2   # 8 on the chain, 5 on the graph
    route = _Planted(plan, _calls(cfg), delta=delta)
    got = C.train_step_check(cfg, p0, s0, sd, xb, yb, route, plan)
    assert got["flips"][0] >= nudged and got["grad_err"] < C.K5_ATOL
    # the direct comparison of the two routes' gradients, as the check
    # made it before: the flip's cascade puts it beyond the tolerance
    _, gk, _ = TR.loss_and_grads(cfg, p0, s0, sd, xb, yb, exec_plan=route)
    _, gc, _ = TR.loss_and_grads(cfg, p0, s0, sd, xb, yb, exec_plan=plan)
    with pytest.raises(RuntimeError, match="step-1 gradient"):
        for (q, a), (_, b) in zip(C._paths(gk), C._paths(gc)):
            C._close(a, b, C.K5_RTOL, C.K5_ATOL, f"step-1 gradient {q}")


def test_the_same_route_passes_with_no_flip(setup):
    cfg, p0, s0, sd, xb, yb, plan = setup
    got = C.train_step_check(cfg, p0, s0, sd, xb, yb, plan, plan)
    assert got["flips"] == [0] * len(sd)
    assert got["grad_err"] == 0.0 and got["loss_k"] == got["loss_c"]


def test_a_wrong_gradient_fails(setup):
    cfg, p0, s0, sd, xb, yb, plan = setup
    route = _Planted(plan, _calls(cfg), gscale=1e-3)
    with pytest.raises(RuntimeError, match="step-1 gradient"):
        C.train_step_check(cfg, p0, s0, sd, xb, yb, route, plan)


def test_a_wrong_forward_fails(setup):
    cfg, p0, s0, sd, xb, yb, plan = setup
    f, _, _ = _first_branch(cfg, p0, s0, sd, xb, plan)
    delta = torch.zeros_like(f)
    delta[:, 3] = 1e-3 * f[:, 3].abs().max()
    delta[::2, 3] *= -1
    route = _Planted(plan, _calls(cfg), delta=delta)
    with pytest.raises(RuntimeError, match="pre-quant node 0 branch 0"):
        C.train_step_check(cfg, p0, s0, sd, xb, yb, route, plan)
