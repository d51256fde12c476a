"""Sharded serving of a converted LUT network over several devices (port
of ``repro.serve.sharded``).

The reference is single-controller: one process ``shard_map``s the
fused cascade over a 1-D mesh of its local devices.  The port keeps that
shape, one process over a list of devices (``devices=[...]``), not
``torch.distributed`` ranks: it fits the serving engine, one process
with a thread per replica.  A device may be listed more than once:
``["cpu"] * R`` runs R logical shards on the CPU, ``["cuda:0"] * R`` R
logical shards on one card, whose launches then follow one another on
its stream (exact, and it says nothing about speed).

  * **replicated** — every device runs the engine's fused forward
    (``make_forward_fn``: the bundle's bit-packed tables and
    connectivity uploaded once per device, the fused cascade
    ``kernels/lut_cascade``, K1, chain or DAG schedule) on its share of
    R near-equal row blocks of the batch; the predictions are joined on
    the first device.

  * **o_sharded** (chains only) — every device holds a contiguous block
    of each layer's table rows and connectivity rows, the tables as
    (O_i, T_i) int32 converted once from the bundle's uint16; the batch
    stays whole.  Per layer each device runs the per-layer kernel
    (``kernels/lut_gather.lut_layer``, K3) on its rows for the full
    batch, then the R code blocks are concatenated along the neuron axis
    and copied to every device: the counterpart of the reference's tiled
    ``all_gather``.  The reference pads every neuron dim to a multiple
    of R (``ShardPlan.pad_widths`` reports those widths); the port's
    blocks need no padded rows, the last ones are shorter or empty.

The layout is a :class:`ShardPlan`, planned once per bundle
(``ServeBundle.plan_shards``; ``TableRegistry.load(shard_replicas=R)``
plans at load).  ``mode="auto"`` replicates when the packed operands fit
the per-device budget.  In place of the reference's 8 MiB of VMEM the
budget is the card's L2 cache (``L2_cache_size``, 50 MiB on the H100),
through which K1 and K3 read their tables; on the CPU it is
:data:`CPU_BUDGET_BYTES`.

There is no ``use_kernel`` switch: on CUDA devices both layouts launch
their kernel, and on the CPU the kernels' plain versions run.  A shard
that gets no rows launches nothing.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Callable, List, Optional, Sequence, Tuple

import numpy as np
import torch

from repro_torch.core import lut_infer as LI
from repro_torch.core.model import node_static_conns
from repro_torch.core.nl_config import UnsupportedTopology, is_graph_config
from repro_torch.device import DeviceLike, resolve_device
from repro_torch.kernels.lut_gather import lut_layer
from repro_torch.serve.engine import _device_pool, make_forward_fn

#: Per-device budget on the CPU: the reference's (half a TPU core's VMEM).
CPU_BUDGET_BYTES = 8 * 2 ** 20


def device_budget(device: DeviceLike = None) -> int:
    """Operand bytes that one device keeps close: a CUDA device's L2
    size, or :data:`CPU_BUDGET_BYTES` for the CPU.  ``None``: the
    current CUDA device (raises without one, as ``resolve_device``)."""
    dev = resolve_device(device)
    if dev.type == "cuda":
        return int(torch.cuda.get_device_properties(dev).L2_cache_size)
    return CPU_BUDGET_BYTES


@dataclass
class ShardPlan:
    """How one bundle is laid out across ``num_replicas`` devices.

    ``operand_bytes_total`` counts the fused cascade's operands (packed
    tables and int32 connectivity), ``operand_bytes_per_device`` its
    share under ``mode`` (:func:`choose_layout`).  For ``mode ==
    "o_sharded"`` the plan carries, built once, each layer's (O_i, T_i)
    int32 ``tables`` and its ``row_blocks``: device r holds rows
    ``row_blocks[i][r]`` = (start, stop) of layer i; ``pad_widths`` are
    the reference's padded widths.  The replicated layout serves the
    bundle's own packed operands."""

    num_replicas: int
    mode: str                                   # "replicated" | "o_sharded"
    budget_bytes: int
    operand_bytes_total: int
    operand_bytes_per_device: int
    pad_widths: Tuple[int, ...] = ()
    row_blocks: Tuple[Tuple[Tuple[int, int], ...], ...] = ()
    tables: Optional[List[np.ndarray]] = None

    def describe(self) -> str:
        per = self.operand_bytes_per_device / 2 ** 10
        return (f"ShardPlan(replicas={self.num_replicas}, mode={self.mode}, "
                f"operands={per:.1f} KiB/device, "
                f"budget={self.budget_bytes / 2 ** 10:.0f} KiB)")


def choose_layout(operand_bytes_total: int, vmem_budget_bytes: int,
                  num_replicas: int, mode: str = "auto"
                  ) -> Tuple[str, int]:
    """Pure layout decision: ``(mode, operand_bytes_per_device)``.

    ``mode="auto"`` replicates when the resident operands fit the
    per-device budget, else shards the neuron dim; explicit modes pass
    through unchanged (an operator may force either).  The reference's
    function, verbatim."""
    if mode not in ("auto", "replicated", "o_sharded"):
        raise ValueError(f"unknown shard mode {mode!r}")
    if num_replicas < 1:
        raise ValueError(f"num_replicas={num_replicas} must be >= 1")
    if mode == "auto":
        mode = ("replicated" if operand_bytes_total <= vmem_budget_bytes
                else "o_sharded")
    per_device = (operand_bytes_total if mode == "replicated"
                  else -(-operand_bytes_total // num_replicas))
    return mode, per_device


def _row_blocks(o: int, r: int) -> Tuple[Tuple[int, int], ...]:
    """Contiguous blocks of ceil(o / r) rows, the last shorter or empty
    (the reference's split of the padded width)."""
    k = -(-o // r)
    return tuple((min(i * k, o), min((i + 1) * k, o)) for i in range(r))


def plan_shards(bundle, num_replicas: int, *, mode: str = "auto",
                budget_bytes: Optional[int] = None,
                device: DeviceLike = None) -> ShardPlan:
    """Choose (or force) a layout for ``bundle`` on ``num_replicas``
    devices (see :func:`choose_layout`) against ``budget_bytes``
    (default: :func:`device_budget` of ``device``) and build its
    operands.  The o_sharded layout of a LUT DAG raises
    ``UnsupportedTopology``."""
    choose_layout(0, 0, num_replicas, mode)  # validate args before packing
    budget = device_budget(device) if budget_bytes is None \
        else int(budget_bytes)
    bundle.prepack()
    total = sum(int(t.nbytes) for t in bundle.packed_tables) + sum(
        4 * np.size(c) for s in bundle.statics for c in node_static_conns(s))
    mode, per_device = choose_layout(total, budget, num_replicas, mode)
    cfg = bundle.cfg
    if mode == "o_sharded" and is_graph_config(cfg) and not cfg.is_chain:
        # The o_sharded walk is one buffer per layer with a gather of the
        # code blocks at each chain boundary; a DAG's fan-out and adder
        # branches have no such single boundary.  Replicated serving
        # covers DAG bundles.
        raise UnsupportedTopology(
            f"o_sharded layout only supports chain topologies; bundle "
            f"'{cfg.name}' is a LUT DAG (operands {total / 2 ** 10:.1f} "
            f"KiB, budget {budget / 2 ** 10:.0f} KiB) — force "
            f"mode='replicated' or raise budget_bytes")
    plan = ShardPlan(num_replicas=num_replicas, mode=mode,
                     budget_bytes=budget, operand_bytes_total=total,
                     operand_bytes_per_device=per_device)
    if mode == "o_sharded":
        r = num_replicas
        plan.pad_widths = tuple(-(-o // r) * r for o in cfg.layer_widths)
        plan.row_blocks = tuple(_row_blocks(o, r) for o in cfg.layer_widths)
        plan.tables = [np.asarray(t[0] if isinstance(t, (list, tuple))
                                  else t).astype(np.int32)
                       for t in bundle.tables]
    return plan


# ---------------------------------------------------------------------------
# the two layouts (floats -> predictions on the first device)


def _replicated_forward(bundle, devs: Sequence[torch.device]) -> Callable:
    """The engine's fused forward (K1) on every device, each with its own
    operands, over R near-equal row blocks of the batch; the predictions
    are joined on ``devs[0]``."""
    fns = {d: make_forward_fn(bundle, device=d) for d in dict.fromkeys(devs)}
    r = len(devs)

    def forward(x: np.ndarray) -> torch.Tensor:
        b = x.shape[0]
        out = [fns[d](x[i * b // r:(i + 1) * b // r]).to(devs[0])
               for i, d in enumerate(devs) if (i + 1) * b // r > i * b // r]
        return torch.cat(out) if out else torch.empty(
            (0,), dtype=torch.int32, device=devs[0])

    return forward


def _o_sharded_forward(bundle, plan: ShardPlan,
                       devs: Sequence[torch.device]) -> Callable:
    """Each device holds its block of every layer's int32 table rows and
    connectivity rows and runs K3 ``lut_layer`` on them for the whole
    batch; after each layer the code blocks are concatenated along the
    neuron axis and copied to every device."""
    cfg = bundle.cfg
    conns = [np.asarray(c, np.int32) for s in bundle.statics
             for c in node_static_conns(s)]
    shards = []   # per layer: [(device, conn rows, table rows)], non-empty
    for li, (conn, table) in enumerate(zip(conns, plan.tables)):
        shards.append([
            (d, torch.as_tensor(conn[lo:hi], device=d),
             torch.as_tensor(table[lo:hi], device=d))
            for d, (lo, hi) in zip(devs, plan.row_blocks[li]) if hi > lo])
    in_bits = [cfg.layer_in_bits(i) for i in range(cfg.num_layers)]
    places = list(dict.fromkeys(devs))
    params = bundle.serve_params(devs[0])
    for d in places:
        if d.type == "cuda":
            # the engine's executor launches on its own stream: the
            # operands uploaded on this thread's stream must be complete
            torch.cuda.current_stream(d).synchronize()

    def forward(x: np.ndarray) -> torch.Tensor:
        xt = torch.as_tensor(np.asarray(x, np.float32)).to(devs[0])
        codes = LI.input_codes(cfg, params, xt)
        if codes.shape[0]:
            on = {d: codes.to(d) for d in places}
            for bits, layer in zip(in_bits, shards):
                full = torch.cat([lut_layer(t, on[d], c, bits).to(devs[0])
                                  for d, c, t in layer], dim=1)
                on = {d: full.to(d) for d in places}
            codes = on[devs[0]]
        else:
            codes = torch.empty((0, cfg.layer_widths[-1]),
                                dtype=torch.int32, device=devs[0])
        vals = LI.class_values(cfg, params, codes)
        return torch.argmax(vals, dim=-1).to(torch.int32)

    return forward


def make_sharded_forward_fn(bundle, *, devices: Optional[Sequence] = None,
                            mode: str = "auto",
                            budget_bytes: Optional[int] = None
                            ) -> Callable[[np.ndarray], torch.Tensor]:
    """(B, in_features) float32 -> (B,) int32 class predictions on the
    first device, the cascade laid out over ``devices`` (one shard per
    entry; ``None``: every CUDA device) by ``bundle.plan_shards``
    against the first device's budget unless ``budget_bytes`` is given.
    Bit-identical to ``lut_infer.predict`` for any B, including B < R
    (shards without rows launch nothing) and B = 0."""
    devs = _device_pool(None, devices)
    if budget_bytes is None:
        budget_bytes = device_budget(devs[0])
    plan = bundle.plan_shards(len(devs), mode=mode,
                              budget_bytes=budget_bytes)
    if plan.mode == "replicated":
        return _replicated_forward(bundle, devs)
    return _o_sharded_forward(bundle, plan, devs)
