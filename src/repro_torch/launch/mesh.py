"""Mesh construction (port of ``repro.launch.mesh``).

The reference builds its meshes over the devices of one controller.
The port runs one process per device, so a mesh is the open process
group laid out by shape and axes (``sharding.spmd.ProcessMesh``, with
its ``DeviceMesh``), and a shape whose device count differs from the
world size is refused with both numbers.  Single pod: (16, 16) = 256
processes, axes (data, model).  Multi-pod: (2, 16, 16) = 512, axes
(pod, data, model); the "pod" axis carries data parallelism across pods
(gradients reduce over pod + data).
"""
from __future__ import annotations

from repro_torch.config import MULTI_POD, SINGLE_POD, MeshConfig


def mesh_config(*, multi_pod: bool = False) -> MeshConfig:
    return MULTI_POD if multi_pod else SINGLE_POD


def make_mesh_from_config(mcfg: MeshConfig, *, device=None):
    """The mesh of ``mcfg`` over the open process group (without one:
    a mesh of one device); ``device`` is this rank's compute device
    (``None``: the card, which raises without one; pass ``"cpu"`` to
    run on the host)."""
    from repro_torch.sharding.spmd import ProcessMesh
    return ProcessMesh(mcfg, device=device)


def make_production_mesh(*, multi_pod: bool = False, device=None):
    return make_mesh_from_config(mesh_config(multi_pod=multi_pod),
                                 device=device)


def make_host_mesh(shape=(2, 4), axes=("data", "model"), *, device=None):
    """A small mesh over the processes of this host (the multi-process
    tests' meshes)."""
    return make_mesh_from_config(MeshConfig(tuple(shape), tuple(axes)),
                                 device=device)


def make_sweep_mesh(num_devices=None):
    """The Pareto sweep's 1-D ``(replica,)`` mesh: a sweep's stacked
    (point, seed) unit axis has no model-parallel structure, so it
    spreads over one replica axis, the device list that
    ``run_pareto_sweep(devices=)`` takes (``sharding.ctx.replica_mesh``).
    Defaults to every visible card."""
    from repro_torch.sharding.ctx import replica_mesh
    return replica_mesh(num_devices)
