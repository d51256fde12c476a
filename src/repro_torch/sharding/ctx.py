"""Ambient mesh context (port of ``repro.sharding.ctx``).

The launcher and the mesh step set the active mesh (``active_mesh``)
and the axes that split the batch in hand (``batch_split``);
``psum_int8`` and the MoE layer's batch statistics read them.  The
reference's ``constrain`` pins an activation's layout for GSPMD at
block boundaries; its pins are layout only and never change a value.  In the port a tensor's layout is
set by where its shard is placed (``sharding.spmd``), so ``constrain``
keeps the reference's arity check and returns ``x`` unchanged, and no
model code needs to call it.

Roles (the reference's):
    "batch"  -> the data axes ("pod","data") / ("data",)
    "model"  -> the tensor axis
    None     -> unsharded
"""
from __future__ import annotations

import types
from contextlib import contextmanager
from typing import List, Optional, Sequence, Tuple

import torch

# Process-wide, not per thread as the reference's: autograd runs a CUDA
# backward, and with it the recompute of every remat block, on its own
# device threads, which must see the mesh and the batch split.
_state = types.SimpleNamespace()

#: Mesh axis name used by the serving layer (``serve.sharded``): a 1-D
#: data/table-parallel axis over whichever devices serve the model.
REPLICA_AXIS = "replica"


def replica_mesh(num_replicas: Optional[int] = None, *,
                 devices: Optional[Sequence] = None,
                 axis: str = REPLICA_AXIS) -> List[torch.device]:
    """The first ``num_replicas`` devices of a 1-D ``(replica,)`` mesh,
    as the device list that ``serve.sharded`` and
    ``run_pareto_sweep(devices=)`` take.  ``devices`` defaults to every
    visible card (none raises: the CPU runs only when named, e.g.
    ``devices=["cpu"] * 4`` for four logical replicas of the host);
    ``axis`` names the one axis and changes nothing in a device list."""
    del axis
    if devices is not None:
        devs = [torch.device(d) for d in devices]
    else:
        from repro_torch.device import resolve_device
        resolve_device("cuda")
        devs = [torch.device("cuda", i)
                for i in range(torch.cuda.device_count())]
    n = len(devs) if num_replicas is None else int(num_replicas)
    if not 1 <= n <= len(devs):
        raise ValueError(f"num_replicas={n} not in [1, {len(devs)}] "
                         f"available devices")
    return devs[:n]


def set_active_mesh(mesh, data_axes: Tuple[str, ...] = ("data",),
                    model_axis: str = "model") -> None:
    _state.mesh = mesh
    _state.data_axes = tuple(data_axes)
    _state.model_axis = model_axis


def clear_active_mesh() -> None:
    _state.mesh = None


def get_active_mesh():
    return getattr(_state, "mesh", None)


@contextmanager
def active_mesh(mesh, data_axes=("data",), model_axis="model"):
    prev = (getattr(_state, "mesh", None),
            getattr(_state, "data_axes", ("data",)),
            getattr(_state, "model_axis", "model"))
    set_active_mesh(mesh, data_axes, model_axis)
    try:
        yield
    finally:
        _state.mesh, _state.data_axes, _state.model_axis = prev


@contextmanager
def batch_split(axes: Optional[Tuple[str, ...]]):
    """Within it, the rows of the batch in hand are split over the
    active mesh's ``axes`` (``None``: every rank holds all of them), so
    a statistic over the batch must be reduced over those ranks."""
    prev = getattr(_state, "batch_axes", None)
    _state.batch_axes = tuple(axes) if axes else None
    try:
        yield
    finally:
        _state.batch_axes = prev


def batch_split_axes() -> Optional[Tuple[str, ...]]:
    if getattr(_state, "mesh", None) is None:
        return None
    return getattr(_state, "batch_axes", None)


def constrain(x: torch.Tensor, *roles) -> torch.Tensor:
    """The reference's layout pin: checks one role per dim under an
    active mesh and returns ``x`` itself."""
    if getattr(_state, "mesh", None) is not None:
        assert len(roles) == x.ndim, (roles, tuple(x.shape))
    return x
