"""Execution plans for the hidden function and for the LUT cascade
(port of ``repro.core.exec_plan``, chain geometries).

``SubnetExec`` routes the hidden function:

  * ``canonical``      — the plain (B, O, n) grouped product
                         (``core.subnet.subnet_apply``): the reference
                         the truth tables are defined against, and the
                         autograd oracle of the kernel routes.
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

  purpose   on CPU           on CUDA
  -------   --------------   ------------
  train     neuron_leading   kernel_train
  eval      canonical        canonical
  convert   canonical        kernel_infer

A ``kernel_infer`` route for training is rejected when the plan is
built: it has no backward.  The kernel routes take CUDA tensors (their
wrappers run the plain versions for CPU tensors, which is how the CPU
tests reach them).

``CascadeExec`` runs the bit-exact LUT cascade (the serving path)
through ``kernels/lut_cascade.lut_cascade``, whose wrapper picks the
route from the codes' device: the CUDA kernel for a CUDA tensor, the
plain gather cascade (``kernels/ref.lut_cascade_ref``) for a CPU tensor.
Nothing moves work between devices: a CUDA tensor goes through the
kernel or the call raises.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Any, Dict, Optional, Tuple

import torch

from repro_torch.core import subnet
from repro_torch.core.nl_config import (NeuraLUTConfig, UnsupportedTopology,
                                        is_graph_config)
from repro_torch.device import DeviceLike, resolve_device
from repro_torch.kernels.lut_cascade import cascade_meta, lut_cascade

ROUTES = ("canonical", "neuron_leading", "kernel_infer", "kernel_train")
PURPOSES = ("train", "eval", "convert")


@dataclass(frozen=True)
class SubnetExec:
    """Execution plan for one model's hidden functions (hashable; one
    plan serves every layer)."""
    kind: str
    route: str
    skip: int = 0

    def __post_init__(self) -> None:
        if self.kind != "subnet":
            raise NotImplementedError(
                f"kind {self.kind!r}: only the subnet kind is ported")
        if self.route not in ROUTES:
            raise ValueError(f"unknown route {self.route!r}; one of "
                             f"{ROUTES}")

    @property
    def differentiable(self) -> bool:
        """Whether autograd may flow through :meth:`apply`."""
        return self.route != "kernel_infer"

    def apply(self, p: Dict[str, Any], xg: torch.Tensor) -> torch.Tensor:
        """Evaluate the hidden function: (B, O, F) -> (B, O)."""
        if self.route == "kernel_infer":
            from repro_torch.kernels.neuralut_mlp import subnet_kernel_apply
            return subnet_kernel_apply(p, xg, self.skip)
        if self.route == "kernel_train":
            from repro_torch.kernels.neuralut_grad import subnet_train_apply
            return subnet_train_apply(p, xg, self.skip)
        return subnet.subnet_apply(
            p, xg, self.skip, batch_leading=self.route == "neuron_leading")


def plan_subnet_exec(cfg: NeuraLUTConfig, *, purpose: str,
                     device: DeviceLike = None,
                     route: Optional[str] = None) -> SubnetExec:
    """Pick the hidden-function route for ``purpose`` on ``device``
    (``None`` = CUDA).  ``route`` overrides the default."""
    if purpose not in PURPOSES:
        raise ValueError(f"unknown purpose {purpose!r}; one of {PURPOSES}")
    if purpose == "train" and route == "kernel_infer":
        raise ValueError("kernel_infer is forward-only; training needs a "
                         "differentiable route (kernel_train, canonical or "
                         "neuron_leading)")
    if route is None:
        on_cuda = resolve_device(device).type == "cuda"
        route = {"train": "kernel_train" if on_cuda else "neuron_leading",
                 "convert": "kernel_infer" if on_cuda else "canonical",
                 "eval": "canonical"}[purpose]
    return SubnetExec(kind=cfg.kind, route=route, skip=cfg.skip)


@dataclass(frozen=True)
class CascadeExec:
    """Execution plan for the bit-exact LUT cascade.

    ``schedule`` is ``kernels.lut_cascade.cascade_meta(cfg)``: one
    ``(in_bits, word_bits, slot_bits, beta)`` tuple per chain layer.
    """
    schedule: Tuple[Tuple[int, int, int, int], ...]

    def __post_init__(self) -> None:
        if any(len(m) != 4 for m in self.schedule):
            raise UnsupportedTopology(
                "the cascade plan takes a chain schedule of (in_bits, "
                "word_bits, slot_bits, beta) layers; DAG schedules are not "
                "ported")

    def apply(self, codes: torch.Tensor, ops) -> torch.Tensor:
        """(B, in) int32 codes -> (B, classes) int32 output codes.
        ``ops`` is the chain's ``kernels.lut_cascade.CascadeOperands``."""
        return lut_cascade(codes, ops)


def plan_cascade_exec(cfg) -> CascadeExec:
    """Build the cascade plan for a chain ``cfg``.  A non-chain
    ``LUTGraphConfig`` raises ``UnsupportedTopology`` here, when the plan
    is built."""
    if is_graph_config(cfg):
        cfg = cfg.as_chain()  # raises UnsupportedTopology for DAGs
    return CascadeExec(schedule=cascade_meta(cfg))
