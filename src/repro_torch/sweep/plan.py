"""Pareto sweep planning (port of ``repro.sweep.plan``, pure Python):
pack seeds x geometries into stacked geometry groups.

The paper's deliverable (Figs. 6-7) is a Pareto frontier over circuit
geometries; a sweep trains ``G`` geometries x ``S`` seed restarts.  The
planner turns the grid into *geometry groups*:

  * two configs land in the same group when they share every static
    that shapes the training step (kind, subnet depth/width/skip, poly
    degree, bit-widths, fan-ins, layer count, input features, last-layer
    width, BN momentum) — everything except their hidden
    ``layer_widths`` and their ``name`` (the connectivity seed);

  * within a group, hidden layer widths are padded per position to the
    group maximum, so every member's (params, state, opt, statics) tree
    has identical shapes and the whole group stacks along ONE leading
    unit axis of ``len(points) * len(seeds)`` entries;

  * the unit axis is padded (by repeating unit 0) to a multiple of
    ``num_devices``; padded units' results are dropped.  The runner
    plans with the number of devices it spreads the unit axis over.

Padding is inert for the real lanes: a padded neuron's connectivity row
is all-zero (it reads real lane 0), its output feeds no real neuron
(real connectivity indexes only real lanes, and the last layer — the
loss — is never padded), so its gradient is *exactly* zero: the
per-unit grad-clip norm, the optimizer updates and the BN state of
every real lane match the unpadded per-geometry training up to float32
summation order (runner.py's docstring says what that order does over
a whole training, and what the tests hold).
"""
from __future__ import annotations

import dataclasses
from dataclasses import dataclass, field
from typing import Dict, List, Sequence, Tuple

from repro_torch.core.nl_config import NeuraLUTConfig


@dataclass(frozen=True)
class SweepPoint:
    """One Pareto point: a geometry plus a family tag for the frontier."""

    cfg: NeuraLUTConfig
    tag: str = ""

    @property
    def name(self) -> str:
        return self.cfg.name


def geometry_group_key(cfg: NeuraLUTConfig) -> Tuple:
    """Everything that must match for two configs to share one (padded,
    stacked) training step.  ``layer_widths`` (except the
    last, which carries the loss) and ``name`` are the only free axes."""
    return (cfg.kind, cfg.depth, cfg.width, cfg.skip, cfg.degree,
            cfg.beta, cfg.beta_in, cfg.fan_in, cfg.fan_in_0,
            cfg.in_features, cfg.num_classes, cfg.num_layers,
            cfg.layer_widths[-1], cfg.bn_momentum)


@dataclass
class GeometryGroup:
    """One same-shape group of sweep points, ready to stack.

    ``units`` enumerates the stacked axis in order: every point's seeds
    consecutively (point-major), then ``pad_units`` repeats of unit 0 so
    the total divides ``num_devices``.  ``unit_index(p, s)`` maps back.
    """

    key: Tuple
    padded_cfg: NeuraLUTConfig
    points: List[SweepPoint]
    seeds: Tuple[int, ...]
    pad_units: int = 0
    index: int = 0
    point_offset: int = 0  # global point index of points[0] in the sweep

    units: List[Tuple[int, int]] = field(init=False)

    def __post_init__(self) -> None:
        self.units = [(p, s) for p in range(len(self.points))
                      for s in range(len(self.seeds))]

    @property
    def num_units(self) -> int:
        return len(self.units)

    @property
    def stacked_units(self) -> int:
        return self.num_units + self.pad_units

    def unit_index(self, point_i: int, seed_i: int) -> int:
        return point_i * len(self.seeds) + seed_i

    def describe(self) -> str:
        names = ",".join(p.name for p in self.points)
        return (f"group[{self.index}] {len(self.points)} pts x "
                f"{len(self.seeds)} seeds (+{self.pad_units} pad) "
                f"widths={self.padded_cfg.layer_widths} [{names}]")


def padded_widths(members: Sequence[NeuraLUTConfig]) -> Tuple[int, ...]:
    """Per-position max over the members' layer widths.  The last layer
    is required identical (it feeds the loss unpadded)."""
    last = {c.layer_widths[-1] for c in members}
    if len(last) != 1:
        raise ValueError(f"group members disagree on last-layer width: "
                         f"{sorted(last)}")
    return tuple(max(c.layer_widths[i] for c in members)
                 for i in range(members[0].num_layers))


def plan_sweep(points: Sequence[SweepPoint], *, seeds: Sequence[int],
               num_devices: int = 1) -> List[GeometryGroup]:
    """Group the sweep grid into stacked geometry groups.

    Groups keep first-seen order; each group's unit axis is padded to a
    multiple of ``num_devices``.
    """
    if not points:
        raise ValueError("empty sweep grid")
    if not seeds:
        raise ValueError("need at least one seed")
    if num_devices < 1:
        raise ValueError(f"num_devices={num_devices} must be >= 1")
    by_key: Dict[Tuple, List[SweepPoint]] = {}
    order: List[Tuple] = []
    for pt in points:
        k = geometry_group_key(pt.cfg)
        if k not in by_key:
            by_key[k] = []
            order.append(k)
        by_key[k].append(pt)

    groups: List[GeometryGroup] = []
    offset = 0
    for gi, k in enumerate(order):
        members = by_key[k]
        widths = padded_widths([p.cfg for p in members])
        rep = members[0].cfg
        padded_cfg = dataclasses.replace(
            rep, name=f"sweepgrp{gi}-{'x'.join(map(str, widths))}",
            layer_widths=widths)
        w = len(members) * len(seeds)
        pad = (-w) % num_devices
        groups.append(GeometryGroup(
            key=k, padded_cfg=padded_cfg, points=list(members),
            seeds=tuple(seeds), pad_units=pad, index=gi,
            point_offset=offset))
        offset += len(members)
    return groups


# ---------------------------------------------------------------------------
# The paper's Fig. 6-7 grid (``repro_torch.launch.sweep``)


#: (widths, fan_in) per family: NeuraLUT uses shallower circuits.
PAPER_SWEEP = {
    "logicnets": [((128, 64, 32, 10), 6), ((64, 32, 32, 10), 6),
                  ((48, 24, 10), 6)],
    "neuralut": [((64, 32, 10), 6), ((48, 10), 6), ((32, 10), 6)],
}


def paper_point_cfg(kind: str, widths: Tuple[int, ...],
                    fan_in: int) -> NeuraLUTConfig:
    """One Fig. 6-7 grid config (LogicNets setting N=1,L=1,S=0 vs the
    NeuraLUT setting N=16,L=4,S=2) over pooled synthetic MNIST."""
    name = f"p-{kind}-{'x'.join(map(str, widths))}"
    if kind == "logicnets":
        return NeuraLUTConfig(name=name, in_features=196,
                              layer_widths=widths, num_classes=10, beta=2,
                              fan_in=fan_in, kind="linear", depth=1,
                              width=1, skip=0)
    return NeuraLUTConfig(name=name, in_features=196, layer_widths=widths,
                          num_classes=10, beta=2, fan_in=fan_in,
                          kind="subnet", depth=4, width=16, skip=2)


def paper_sweep_points() -> List[SweepPoint]:
    return [SweepPoint(cfg=paper_point_cfg(kind, widths, fan_in), tag=kind)
            for kind, grid in PAPER_SWEEP.items()
            for widths, fan_in in grid]
