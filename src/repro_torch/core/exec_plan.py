"""Execution plans for the hidden function and for the LUT cascade
(port of ``repro.core.exec_plan``).

``SubnetExec`` routes the hidden function:

  * ``canonical``      — the plain (B, O, n) grouped product
                         (``core.subnet.subnet_apply``): the reference
                         the truth tables are defined against, and the
                         autograd oracle of the kernel routes.  The
                         only route of the linear and poly kinds, whose
                         whole hidden function is one product.
  * ``neuron_leading`` — the same ops in (O, B, n) layout
                         (``subnet_apply(batch_leading=True)``): the
                         CPU training route; equal to canonical to
                         float32 rounding.
  * ``kernel_infer``   — the CUDA grouped sub-network kernel
                         (``kernels/neuralut_mlp.subnet_kernel_apply``);
                         forward only.
  * ``kernel_train``   — the CUDA training kernels
                         (``kernels/neuralut_grad.subnet_train_apply``):
                         the forward saves the sub-layer inputs, the
                         backward computes dx and every weight gradient.

  purpose   linear/poly   subnet on CPU    subnet on CUDA
  -------   -----------   --------------   --------------
  train     canonical     neuron_leading   kernel_train
  eval      canonical     canonical        canonical
  convert   canonical     canonical        kernel_infer

The kernels compute the subnet kind only, so the planner clamps the
linear and poly kinds to ``canonical`` whatever route is asked for, as
the reference's planner does.  A ``kernel_infer`` route for training is
rejected when the plan is built: it has no backward.  The kernel routes
take CUDA tensors (their wrappers run the plain versions for CPU
tensors, which is how the CPU tests reach them).

``CascadeExec`` routes the bit-exact LUT cascade (the serving path):

  * ``fused`` — the whole network, chain or DAG, in one launch of
                ``kernels/lut_cascade.lut_cascade`` (K1) over the
                bit-packed tables: the serving default.
  * ``layer`` — one ``kernels/lut_gather.lut_layer`` (K3) launch per
                layer over the unpacked tables: it gathers the layer's
                connected codes, packs them into addresses and looks
                them up (the reference's ``layer_kernel``, whose gather
                and pack XLA fuses into its jit).  It walks one buffer
                per layer, so a DAG schedule raises
                ``UnsupportedTopology`` when the plan is built.

Each wrapper picks the kernel or its plain version from the codes'
device: the CUDA kernel for a CUDA tensor, the plain version
(``kernels/ref.lut_cascade_ref`` / ``lut_layer_ref``) for a CPU
tensor.  Nothing moves work between devices: a CUDA tensor goes through
the kernel or the call raises.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Any, Dict, Optional, Sequence, Tuple

import numpy as np
import torch

from repro_torch.core import subnet
from repro_torch.core.nl_config import (NeuraLUTConfig, UnsupportedTopology,
                                        is_graph_config)
from repro_torch.device import DeviceLike, resolve_device
from repro_torch.kernels.lut_cascade import (cascade_meta,
                                             graph_cascade_meta, lut_cascade)
from repro_torch.kernels.lut_gather import lut_layer
from repro_torch.kernels.ref import NodeSched, as_schedule

ROUTES = ("canonical", "neuron_leading", "kernel_infer", "kernel_train")
PURPOSES = ("train", "eval", "convert")
CASCADE_ROUTES = ("fused", "layer")


@dataclass(frozen=True)
class SubnetExec:
    """Execution plan for one model's hidden functions (hashable; one
    plan serves every layer).  ``kind``, ``skip`` and ``degree`` are
    model-wide."""
    kind: str                  # "subnet" | "linear" | "poly"
    route: str
    skip: int = 0
    degree: int = 0

    def __post_init__(self) -> None:
        if self.route not in ROUTES:
            raise ValueError(f"unknown route {self.route!r}; one of "
                             f"{ROUTES}")
        if self.kind != "subnet" and self.route != "canonical":
            raise ValueError(f"kind {self.kind!r} only runs the "
                             f"canonical route, got {self.route!r}")

    @property
    def differentiable(self) -> bool:
        """Whether autograd may flow through :meth:`apply`."""
        return self.route != "kernel_infer"

    def apply(self, p: Dict[str, Any], xg: torch.Tensor, *,
              exps: Optional[np.ndarray] = None) -> torch.Tensor:
        """Evaluate the hidden function: (B, O, F) -> (B, O).  ``exps``:
        the poly kind's monomial exponents (``subnet.monomial_exponents``)."""
        if self.route == "kernel_infer":
            from repro_torch.kernels.neuralut_mlp import subnet_kernel_apply
            return subnet_kernel_apply(p, xg, self.skip)
        if self.route == "kernel_train":
            from repro_torch.kernels.neuralut_grad import subnet_train_apply
            return subnet_train_apply(p, xg, self.skip)
        return subnet.apply_hidden(
            self.kind, p, xg, skip=self.skip, exps=exps,
            batch_leading=self.route == "neuron_leading")


def plan_subnet_exec(cfg: NeuraLUTConfig, *, purpose: str,
                     device: DeviceLike = None,
                     route: Optional[str] = None) -> SubnetExec:
    """Pick the hidden-function route for ``purpose`` on ``device``
    (``None`` = CUDA).  ``route`` overrides the default; the linear and
    poly kinds take ``canonical`` whatever it says."""
    if purpose not in PURPOSES:
        raise ValueError(f"unknown purpose {purpose!r}; one of {PURPOSES}")
    if route is not None and route not in ROUTES:
        raise ValueError(f"unknown route {route!r}; one of {ROUTES}")
    if purpose == "train" and route == "kernel_infer":
        raise ValueError("kernel_infer is forward-only; training needs a "
                         "differentiable route (kernel_train, canonical or "
                         "neuron_leading)")
    if cfg.kind != "subnet":
        return SubnetExec(kind=cfg.kind, route="canonical",
                          degree=cfg.degree if cfg.kind == "poly" else 0)
    if route is None:
        on_cuda = resolve_device(device).type == "cuda"
        route = {"train": "kernel_train" if on_cuda else "neuron_leading",
                 "convert": "kernel_infer" if on_cuda else "canonical",
                 "eval": "canonical"}[purpose]
    return SubnetExec(kind=cfg.kind, route=route, skip=cfg.skip)


class LayerOperands:
    """The per-layer route's operands of one converted chain, on one
    device: ``conns[i]`` (O_i, F_i) int32 and ``tables[i]`` (O_i, T_i)
    int32 (unpacked), T_i = 2^(in_bits_i * F_i) by the plan's chain
    ``schedule``; ``in_features`` is the width of the input codes.  The
    serving forward builds this once and passes it with every batch.
    Connections are checked once, here: each in [0, the width of the
    layer's input), as the kernel assumes (it clamps them into it)."""

    def __init__(self, conns: Sequence[torch.Tensor],
                 tables: Sequence[torch.Tensor], schedule,
                 in_features: int):
        self.conns = tuple(c.to(torch.int32) for c in conns)
        self.tables = tuple(tables)
        if not len(self.conns) == len(self.tables) == len(schedule) >= 1:
            raise ValueError(f"{len(self.conns)} conns, {len(self.tables)} "
                             f"tables and {len(schedule)} layers disagree")
        for i, (c, t, m) in enumerate(zip(self.conns, self.tables,
                                          as_schedule(schedule))):
            want = (c.shape[0], 1 << (m[2] * c.shape[1]))
            if t.dtype != torch.int32 or tuple(t.shape) != want \
                    or c.dim() != 2 or c.device != t.device:
                raise ValueError(
                    f"layer {i}: conn {tuple(c.shape)} on {c.device} and "
                    f"table {tuple(t.shape)} {t.dtype} on {t.device}; want "
                    f"(O, F) and {want} int32 on one device")
            width = self.conns[i - 1].shape[0] if i else int(in_features)
            if c.numel() and (int(c.min()) < 0 or int(c.max()) >= width):
                raise ValueError(f"layer {i}: connections outside [0, "
                                 f"{width})")


@dataclass(frozen=True)
class CascadeExec:
    """Execution plan for the bit-exact LUT cascade.

    ``schedule`` is the node schedule (``kernels.ref.NodeSched``: srcs,
    arity, in_bits, word_bits, slot_bits, beta per node); a chain's
    ``cascade_meta`` is taken too and normalized to its nodes.
    ``route`` is ``fused`` (K1, over ``CascadeOperands``) or ``layer``
    (one K3 ``lut_layer`` launch per layer, over :class:`LayerOperands`,
    chain schedules only).
    """
    schedule: Tuple[NodeSched, ...]
    route: str = "fused"

    def __post_init__(self) -> None:
        if self.route not in CASCADE_ROUTES:
            raise ValueError(f"unknown cascade route {self.route!r}; one "
                             f"of {CASCADE_ROUTES}")
        object.__setattr__(self, "schedule", as_schedule(self.schedule))
        if not self.fused and not self.is_chain:
            raise UnsupportedTopology(
                "the per-layer route walks one buffer per layer; a DAG "
                "schedule (several sources or adder-tree nodes) needs the "
                "fused route")

    @property
    def fused(self) -> bool:
        return self.route == "fused"

    @property
    def is_chain(self) -> bool:
        """True iff node i reads only buffer i (the node before it, or
        the input) and has one branch."""
        return all(srcs == (i,) and arity == 1
                   for i, (srcs, arity, *_r) in enumerate(self.schedule))

    def apply(self, codes: torch.Tensor, ops) -> torch.Tensor:
        """(B, in) int32 codes -> (B, classes) int32 output codes.
        ``ops`` is the network's ``kernels.lut_cascade.CascadeOperands``
        (fused) or :class:`LayerOperands` (layer)."""
        if self.fused:
            return lut_cascade(codes, ops)
        c = codes
        for conn, table, (_s, _a, in_bits, *_r) in zip(
                ops.conns, ops.tables, self.schedule):
            c = lut_layer(table, c, conn, in_bits)
        return c


def plan_cascade_exec(cfg, *, fused: bool = True) -> CascadeExec:
    """Build the cascade plan for ``cfg``: ``fused`` (K1) for a chain or
    any ``LUTGraphConfig``, or, with ``fused=False``, ``layer`` (K3 per
    layer), for which a non-chain graph raises ``UnsupportedTopology``
    here, when the plan is built.  A chain graph plans exactly as its
    chain."""
    sched = (graph_cascade_meta(cfg) if is_graph_config(cfg)
             else as_schedule(cascade_meta(cfg)))
    return CascadeExec(schedule=sched, route="fused" if fused else "layer")
