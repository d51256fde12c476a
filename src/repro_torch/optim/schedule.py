"""SGDR: cosine annealing with warm restarts (port of
``repro.optim.schedule``).

Computed in float32 tensors, as the reference computes it: at a cycle
boundary ``floor(log(ratio) / log(t_mult))`` depends on the precision,
so a float64 host formula could pick the other cycle.
"""
from __future__ import annotations

import math

import torch


def sgdr_schedule(step, *, lr_max: float, lr_min: float = 0.0,
                  t0: int = 100, t_mult: int = 2) -> torch.Tensor:
    """Learning rate at ``step`` (a number or a tensor, read as float32;
    the result lies on the step's device).

    Restart cycle i has length t0 * t_mult**i.  Within a cycle of length
    T at progress t: lr = lr_min + 0.5*(lr_max-lr_min)*(1+cos(pi*t/T)).
    """
    step = torch.as_tensor(step).to(torch.float32)
    # constants filled on the step's device: a host-to-device copy of a
    # scalar would wait for the device once per training step
    f32 = dict(dtype=torch.float32, device=step.device)
    t0f = torch.full((), float(t0), **f32)
    if t_mult == 1:
        t_in = torch.remainder(step, t0f)
        t_len = t0f
    else:
        tm = torch.full((), float(t_mult), **f32)
        # cycle index: smallest i with t0*(tm^(i+1)-1)/(tm-1) > step
        ratio = step * (tm - 1.0) / t0f + 1.0
        i = torch.floor(torch.log(ratio) / torch.log(tm))
        start = t0f * (tm ** i - 1.0) / (tm - 1.0)
        t_in = step - start
        t_len = t0f * tm ** i
    cos = 0.5 * (1.0 + torch.cos(math.pi * t_in / t_len))
    return lr_min + (lr_max - lr_min) * cos
