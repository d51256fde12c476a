"""Pareto sweep engine (port of ``repro.sweep.runner``): the whole
seeds x geometries grid as one stacked training run per geometry group,
its unit axis spread over R devices, with results streamed per group.

For every :class:`~repro_torch.sweep.plan.GeometryGroup` the runner

  1. initializes every (point, seed) unit with its TRUE config
     (``core.train.init_ensemble``: exactly the init
     ``train_neuralut_ensemble`` draws), zero-pads each leaf to the
     group's padded shapes and stacks everything along one leading unit
     axis, on the device, once per group;

  2. trains the group: the epochs x steps of
     ``train_neuralut_ensemble``'s schedule, every step one
     ``make_ensemble_step_fn`` call —
     ``torch.func.vmap`` of the functional step over the unit axis,
     every unit gathering through its own padded connectivity — and
     every epoch the vmapped canonical evaluation.  On the card the
     subnet kind's step makes one K4 and one K5 launch per layer for
     all units of a device (the training kernels' vmap rules); the
     linear and poly kinds take the plain product and launch neither;

  3. streams each finished group's frontier points to the
     :class:`~repro_torch.runtime.tracker.Tracker` at once, and with
     ``convert=True`` runs each point's best member through
     ``core.truth_table.convert_packed`` (K2 on the card for the subnet
     kind).

Eager PyTorch has no ahead-of-time compile and no asynchronous program
dispatch, so groups train one after the other and the reference's
cold/warm split is redefined: a group's ``cold_s`` is the seconds from
the start of its training until its first step returns, synchronized
(the kernel library's first load, autograd and vmap set-up, the first
launches); its ``warm_s`` is the rest of its training and evaluation,
up to its history's fetch.

Several devices (the reference's ``shard_map`` of the unit axis over
``make_sweep_mesh``): one process over a list of R devices, as
``serve/sharded.py`` is, with no ``torch.distributed`` ranks.
``plan_sweep(num_devices=R)`` pads each group's unit axis to a multiple
of R; the stacked operands (the per-unit seeds included, sliced, never
redrawn) are cut into R contiguous blocks of W / R units, each block
trains through the same vmapped step on its device, and params, state
and histories join on the first device in unit order.  Each distinct
device runs its blocks in a thread of its own, on its own CUDA stream
on the card; a list may repeat a device (R logical replicas of one
card, or of the host), and the blocks of one device then run one after
another in its thread: threads that share a device have no device time
to overlap and only contend for the interpreter lock.  A step has no
collective, as in the reference.

Equivalence contract: a group's units train on the code path of
``train_neuralut_ensemble`` (one vmapped step with the statics on the
unit axis; the ensemble expands its one connectivity over that axis),
from the same inits on the same per-seed permutations.  So a point
alone in its group reproduces that ensemble bit for bit
(tests/test_torch_sweep.py on the CPU, ``chip_smoke.py`` on the card).
In a group of several points, padded lanes and, on the card, the unit
count change the order of a unit's float32 reductions (the gradient of
a per-lane quantizer scale is a sum over the batch that rounds
otherwise over a wider lane axis), so a member's first gradients may
differ from its ensemble's in the last bits.  Adam turns that on
the leaves whose exact gradient is 0 (the biases feeding BN, which BN
subtracts again) into lr-sized steps, and the BN means follow them.
tests/test_torch_sweep.py holds such a member's histories within 2e-3,
its signal elements within 2e-5 and the rest within its
``ZERO_GRAD_ATOL``; ``chip_smoke.py`` holds the paper grid's padded
group at its ``SWEEP_*_ATOL`` limits.
"""
from __future__ import annotations

import contextlib
import hashlib
import json
import threading
import time
from dataclasses import dataclass
from typing import Dict, List, Optional, Sequence, Tuple, Union

import numpy as np
import torch

from repro_torch.checkpoint.store import CheckpointStore
from repro_torch.config import config_fingerprint
from repro_torch.core import cost_model as CM
from repro_torch.core import model as M
from repro_torch.core import truth_table as TT
from repro_torch.core.exec_plan import plan_subnet_exec
from repro_torch.core.nl_config import NeuraLUTConfig
from repro_torch.core.train import (ensemble_epochs, init_ensemble,
                                    make_ensemble_eval_fn,
                                    make_ensemble_step_fn)
from repro_torch.device import DeviceLike, resolve_device
from repro_torch.runtime.chaos import ChaosHarness
from repro_torch.runtime.straggler import StepWatchdog
from repro_torch.runtime.tracker import NoopTracker, Tracker
from repro_torch.sweep.plan import GeometryGroup, SweepPoint, plan_sweep
from repro_torch.tree import tree_map

Params = Dict
HIST_KEYS = ("loss", "test_acc", "test_acc_q")
Devices = Union[int, Sequence, None]


class SweepGroupFailed(RuntimeError):
    """A geometry group kept failing after ``max_group_retries``
    retries — the sweep aborts (its journal, if any, keeps every group
    that did finish, so a rerun with ``resume=`` replays them)."""


# ---------------------------------------------------------------------------
# stacked-group operands


def _pad_stack(member_trees: Sequence, pad_units: int):
    """Stack per-member (S, ...)-leaf trees along the unit axis, zero-
    padding every trailing dim to the per-leaf max across members (the
    group's padded shapes).  ``pad_units`` extra units replicate unit 0.
    Leaves may be tensors (the result stays on their device) or numpy
    arrays (the result is a CPU tensor)."""

    def stack(*leaves):
        leaves = [torch.as_tensor(x) for x in leaves]
        s = leaves[0].shape[0]
        tgt = tuple(max(x.shape[d] for x in leaves)
                    for d in range(1, leaves[0].dim()))
        w = len(leaves) * s + pad_units
        out = leaves[0].new_zeros((w,) + tgt)
        for m, x in enumerate(leaves):
            out[(slice(m * s, (m + 1) * s),)
                + tuple(slice(0, d) for d in x.shape[1:])] = x
        if pad_units:
            out[len(leaves) * s:] = out[:1]
        return out

    return tree_map(stack, *member_trees)


def _stack_statics(group: GeometryGroup, device: torch.device
                   ) -> List[Dict]:
    """Per-layer statics stacked over units: every point's connectivity
    padded to (O_pad, F) with all-zero rows (padded neurons read real
    lane 0 — inert, see plan.py) and repeated per seed, as one (U,
    O_pad, F) int64 tensor on ``device``.  The poly kind's exps are one
    host array (equal across a group: degree and fan-in are in its
    key)."""
    s = len(group.seeds)
    per_point = [M.model_static(p.cfg) for p in group.points]
    padded = group.padded_cfg
    out: List[Dict] = []
    for li in range(padded.num_layers):
        conn = np.zeros((len(per_point), padded.layer_widths[li],
                         padded.layer_fan_in(li)), np.int64)
        for pi, st in enumerate(per_point):
            real = np.asarray(st[li]["conn"])
            conn[pi, :real.shape[0]] = real
        conns = np.repeat(conn, s, axis=0)
        if group.pad_units:
            conns = np.concatenate([conns] + [conns[:1]] * group.pad_units)
        layer: Dict = {"conn": torch.as_tensor(conns, device=device)}
        if "exps" in per_point[0][li]:
            layer["exps"] = per_point[0][li]["exps"]
        out.append(layer)
    return out


def stack_group_operands(group: GeometryGroup, x_train, *,
                         device: DeviceLike = None) -> Tuple:
    """(params, state, opt, statics, unit_seeds) stacked over the unit
    axis on ``device``.

    Every unit is initialized with its point's TRUE config — the exact
    draws ``train_neuralut_ensemble`` makes — then padded into the
    group's canvas shapes, so real lanes train as the per-geometry
    ensemble does.  ``unit_seeds[u]`` is the seed whose permutations
    unit u draws (``core.train.epoch_batches``)."""
    dev = resolve_device(device)
    members = [init_ensemble(pt.cfg, group.seeds, x_train, device=dev)
               for pt in group.points]
    params, state, opt = (_pad_stack([m[i] for m in members],
                                     group.pad_units) for i in range(3))
    seeds = [int(s) for _ in group.points for s in group.seeds]
    unit_seeds = seeds + seeds[:1] * group.pad_units
    return params, state, opt, _stack_statics(group, dev), unit_seeds


# ---------------------------------------------------------------------------
# the devices of a sweep


def sweep_devices(device: DeviceLike = None,
                  devices: Devices = None) -> List[torch.device]:
    """The devices a sweep spreads its unit axis over (the reference's
    ``make_sweep_mesh``).

    * ``None``: every visible device of ``device``'s type (CUDA unless
      ``device`` says otherwise): ``torch.cuda.device_count()`` cards,
      or the host alone;
    * an int R: the first R visible CUDA devices (more raises), or R
      logical devices of the host for ``device="cpu"``;
    * a sequence of devices, which may repeat one: ``["cuda:0"] * 4``
      runs four logical replicas of one card, ``["cpu"] * 4`` four of
      the host.  All of one type.
    """
    if devices is None or isinstance(devices, int):
        dev = resolve_device(device)
        if dev.type != "cuda":
            return [dev] * (1 if devices is None else _positive(devices))
        n = torch.cuda.device_count()
        r = n if devices is None else _positive(devices)
        if r > n:
            raise ValueError(
                f"devices={r}: only {n} CUDA device(s) visible (name "
                f"logical replicas of one card as ['cuda:0'] * {r})")
        return [torch.device("cuda", i) for i in range(r)]
    pool = [resolve_device(d) for d in devices]
    if not pool:
        raise ValueError("devices= must name at least one device")
    if len({d.type for d in pool}) > 1:
        raise ValueError(f"devices={devices}: mixes device types")
    return [torch.device("cuda", torch.cuda.current_device())
            if d.type == "cuda" and d.index is None else d for d in pool]


def _positive(r: int) -> int:
    if r < 1:
        raise ValueError(f"devices={r} must be >= 1")
    return int(r)


# ---------------------------------------------------------------------------
# one training run per group


def make_group_train_fn(padded_cfg: NeuraLUTConfig, *, n: int, batch: int,
                        epochs: int, lr: float, weight_decay: float,
                        sgdr_t0: int = 0, device: DeviceLike = None,
                        devices: Optional[Sequence[torch.device]] = None,
                        subnet_route: Optional[str] = None):
    """(params, state, opt, statics, unit_seeds, xd, yd, xe, ye) ->
    (params, state, history, cold_s) over a stacked unit axis.

    ``train_neuralut_ensemble``'s epoch loop (``core.train.
    ensemble_epochs``) for every unit at once: each unit's own
    permutations (``epoch_batches(seed=unit_seeds[u])``), one vmapped
    step per minibatch with the statics on the unit axis, then the
    vmapped canonical evaluation.  ``history`` maps loss / test_acc /
    test_acc_q to (U, epochs) float32 tensors; ``cold_s`` is the
    seconds until the first step returned, synchronized (the slowest
    block's).

    With ``devices`` (R of them, from :func:`sweep_devices`) the unit
    axis, whose length must be a multiple of R, is cut into R
    contiguous blocks, one per entry, trained by one thread per distinct
    device (on its own CUDA stream on the card; a repeated device's
    blocks one after another) and joined on ``devices[0]`` in unit
    order; a block that raises fails the call."""
    pool = list(devices) if devices else [resolve_device(device)]
    t0 = sgdr_t0 or epochs * max(1, n // batch)
    evalf = make_ensemble_eval_fn(padded_cfg)
    steps = {d: make_ensemble_step_fn(
        padded_cfg, lr=lr, weight_decay=weight_decay, t0=t0,
        exec_plan=plan_subnet_exec(padded_cfg, purpose="train", device=d,
                                   route=subnet_route))
        for d in dict.fromkeys(pool)}

    def train_block(dev, params, state, opt, statics, unit_seeds, data):
        params, state, traces, cold_s = ensemble_epochs(
            steps[dev], evalf, params, state, opt, statics, unit_seeds,
            *data, epochs=epochs, batch=batch)
        return params, state, {k: v.T for k, v in traces.items()}, cold_s

    def train(params, state, opt, statics, unit_seeds, xd, yd, xe, ye):
        if len(pool) == 1:
            return train_block(pool[0], params, state, opt, statics,
                               unit_seeds, (xd, yd, xe, ye))
        return _train_blocks(train_block, pool, params, state, opt,
                             statics, unit_seeds, (xd, yd, xe, ye))

    return train


def _unit_block(tree, lo: int, hi: int, dev: torch.device):
    """Units [lo, hi) of every tensor leaf on ``dev`` (host arrays, the
    poly kind's exps, pass through)."""
    if isinstance(tree, dict):
        return {k: _unit_block(v, lo, hi, dev) for k, v in tree.items()}
    if isinstance(tree, list):
        return [_unit_block(v, lo, hi, dev) for v in tree]
    if isinstance(tree, torch.Tensor):
        return tree[lo:hi].to(dev)
    return tree


def _train_blocks(train_block, pool, params, state, opt, statics,
                  unit_seeds, data):
    """R contiguous unit blocks, block i on ``pool[i]``, trained by one
    thread per distinct device (a repeated device's blocks in order);
    the results joined on ``pool[0]`` in unit order."""
    units = len(unit_seeds)
    r = len(pool)
    if units % r:
        raise ValueError(f"{units} units do not split over {r} devices")
    w = units // r
    home = pool[0]
    blocks: Dict[torch.device, List[int]] = {}
    for i, d in enumerate(pool):
        blocks.setdefault(d, []).append(i)
    copies = {d: tuple(a.to(d) for a in data) for d in blocks}
    results: List = [None] * r
    errors: List = []

    def run(dev: torch.device) -> None:
        stream = None
        try:
            if dev.type == "cuda":
                stream = torch.cuda.Stream(dev)
                # the blocks' inputs were made on the default stream
                stream.wait_stream(torch.cuda.current_stream(dev))
            with (torch.cuda.stream(stream) if stream is not None
                  else contextlib.nullcontext()):
                for i in blocks[dev]:
                    lo, hi = i * w, (i + 1) * w
                    results[i] = train_block(
                        dev, *(_unit_block(t, lo, hi, dev)
                               for t in (params, state, opt, statics)),
                        list(unit_seeds[lo:hi]), copies[dev])
            if stream is not None:
                stream.synchronize()
        except BaseException as e:     # re-raised in the caller's thread
            errors.append(e)

    threads = [threading.Thread(target=run, args=(d,), daemon=True,
                                name=f"sweep-{d}") for d in blocks]
    for t in threads:
        t.start()
    for t in threads:
        t.join()
    if errors:
        raise errors[0]

    def join(*leaves):
        return torch.cat([x.to(home) for x in leaves])

    params, state, hist = (tree_map(join, *(res[k] for res in results))
                           for k in range(3))
    return params, state, hist, max(res[3] for res in results)


# ---------------------------------------------------------------------------
# resume journal: each finished group's results, content-addressed


def group_fingerprint(group: GeometryGroup, *, epochs: int, batch: int,
                      lr: float, weight_decay: float, sgdr_t0: int,
                      subnet_route: Optional[str],
                      data_digest: str) -> str:
    """Content hash of everything that determines a group's results:
    every point's true config, the padded canvas config, the seed set,
    the training hyperparameters and the dataset bytes — the
    reference's hex digest for the same group and data.  A journal
    entry is replayed on resume only when its fingerprint matches."""
    payload = {
        "points": [config_fingerprint(p.cfg) for p in group.points],
        "padded": config_fingerprint(group.padded_cfg),
        "seeds": list(group.seeds),
        "pad_units": group.pad_units,
        "epochs": epochs, "batch": batch, "lr": lr,
        "weight_decay": weight_decay, "sgdr_t0": sgdr_t0,
        "route": subnet_route, "data": data_digest,
    }
    return hashlib.sha256(
        json.dumps(payload, sort_keys=True).encode()).hexdigest()


def _data_digest(*arrays) -> str:
    """sha256 over each array's dtype, shape and bytes (tensors are
    read back to the host first)."""
    h = hashlib.sha256()
    for a in arrays:
        if isinstance(a, torch.Tensor):
            a = a.detach().cpu().numpy()
        a = np.asarray(a)
        h.update(str(a.dtype).encode())
        h.update(repr(a.shape).encode())
        h.update(np.ascontiguousarray(a).tobytes())
    return h.hexdigest()


class SweepJournal:
    """Per-group result journal over :class:`CheckpointStore` (atomic
    tmp-rename commits, so a kill mid-write never leaves a half entry).
    Step number == group index; the group's fingerprint rides in the
    manifest meta and gates replay."""

    def __init__(self, directory: Union[str, "object"]):
        self.store = CheckpointStore(str(directory), keep=0)

    def lookup(self, group_index: int, fingerprint: str) -> bool:
        if group_index not in self.store.list_steps():
            return False
        try:
            meta = self.store.meta(group_index)
        except Exception:
            return False
        return meta.get("fingerprint") == fingerprint

    def save(self, group_index: int, fingerprint: str, params, state,
             hist: Dict[str, np.ndarray]) -> None:
        tree = {"params": params, "state": state,
                "hist": {k: np.asarray(v) for k, v in hist.items()}}
        self.store.save(group_index, tree,
                        meta={"fingerprint": fingerprint,
                              "group": group_index})

    def load(self, group_index: int, template) -> Dict:
        """The saved tree as numpy arrays (only ``template``'s structure
        is read); raises on a corrupt entry."""
        _, tree = self.store.restore(template, step=group_index)
        return tree


# ---------------------------------------------------------------------------
# results


@dataclass
class PointResult:
    point: SweepPoint
    group_index: int
    history: Dict[str, np.ndarray]          # each (epochs, S) float
    best_seed: int
    err: float                              # 1 - best final acc_q
    err_mean: float
    est: object                             # cost_model.HwEstimate
    packed: Optional[Tuple[List[np.ndarray], List[np.ndarray]]] = None
    params: Optional[Params] = None         # best member, unpadded
    state: Optional[Params] = None
    status: str = "ok"                      # "failed": all seeds diverged
    diverged_seeds: int = 0                 # NaN/inf members quarantined

    @property
    def name(self) -> str:
        return self.point.name


@dataclass
class GroupRun:
    group: GeometryGroup
    cold_s: float                           # until the first step returned
    warm_s: float = 0.0                     # the rest, to the history
    convert_s: float = 0.0
    retries: int = 0                        # retries before success
    replayed: bool = False                  # served from the journal
    straggler: bool = False                 # watchdog outlier


@dataclass
class SweepResult:
    points: List[PointResult]
    groups: List[GroupRun]
    devices: int
    warm_s: float = 0.0                     # sweep wall time - cold_s

    @property
    def cold_s(self) -> float:
        return sum(g.cold_s for g in self.groups)

    @property
    def total_s(self) -> float:
        return self.cold_s + self.warm_s

    def frontier(self, tag: str) -> List[PointResult]:
        # Diverged points never enter the frontier (NaN quarantine).
        return [p for p in self.points
                if p.point.tag == tag and p.status == "ok"]


def _slice_member(tree, spec, unit: int):
    """Unpad one unit back to its true config's shapes (``spec``: the
    ``model_spec`` tree, shape tuples at the leaves), as fresh
    contiguous tensors."""
    if isinstance(tree, dict):
        return {k: _slice_member(tree[k], spec[k], unit) for k in tree}
    if isinstance(tree, list):
        return [_slice_member(t, s, unit) for t, s in zip(tree, spec)]
    return torch.as_tensor(tree)[unit][tuple(slice(0, d)
                                             for d in spec)].clone()


def member_params_state(group: GeometryGroup, params, state, point_i: int,
                        seed_i: int) -> Tuple[Params, Params]:
    """Slice one trained (point, seed) member out of a group's stacked
    (padded) params/state, restored to the point's true shapes."""
    spec_p, spec_s = M.model_spec(group.points[point_i].cfg)
    u = group.unit_index(point_i, seed_i)
    return _slice_member(params, spec_p, u), _slice_member(state, spec_s, u)


def _point_result(g: GeometryGroup, pi: int, hist: Dict[str, np.ndarray]
                  ) -> PointResult:
    """One point's (epochs, S) history, best seed and error, with the
    NaN quarantine: a diverged member (non-finite loss or accuracy
    anywhere) is excluded from the best/err statistics; a point with no
    finite member is ``status="failed"``."""
    pt, s_count = g.points[pi], len(g.seeds)
    u0 = g.unit_index(pi, 0)
    history = {k: np.stack([np.asarray(v[u0 + si]) for si in range(s_count)],
                           axis=1).astype(np.float64)
               for k, v in hist.items()}
    final_q = history["test_acc_q"][-1]
    finite = (np.isfinite(final_q) & np.isfinite(history["loss"]).all(axis=0)
              & np.isfinite(history["test_acc"]).all(axis=0))
    diverged = int(s_count - finite.sum())
    if not finite.any():
        return PointResult(point=pt, group_index=g.index, history=history,
                           best_seed=0, err=float("nan"),
                           err_mean=float("nan"), est=CM.estimate(pt.cfg),
                           status="failed", diverged_seeds=diverged)
    masked = np.where(finite, final_q, -np.inf)
    return PointResult(point=pt, group_index=g.index, history=history,
                       best_seed=int(masked.argmax()),
                       err=float(1.0 - masked.max()),
                       err_mean=float(1.0 - final_q[finite].mean()),
                       est=CM.estimate(pt.cfg), diverged_seeds=diverged)


# ---------------------------------------------------------------------------
# the engine


def run_pareto_sweep(
    points: Sequence[SweepPoint],
    x_train, y_train, x_test, y_test,
    *,
    seeds: Sequence[int] = (0, 1, 2),
    epochs: int = 10,
    batch: int = 256,
    lr: float = 3e-3,
    weight_decay: float = 1e-4,
    sgdr_t0: int = 0,
    device: DeviceLike = None,
    devices: Devices = None,
    tracker: Optional[Tracker] = None,
    convert: bool = False,
    subnet_route: Optional[str] = None,
    resume: Optional[str] = None,
    max_group_retries: int = 2,
    retry_backoff_s: float = 0.25,
    chaos: Optional[ChaosHarness] = None,
    watchdog: Optional[StepWatchdog] = None,
) -> SweepResult:
    """Train the whole Pareto grid, one stacked run per geometry group,
    its unit axis over ``devices`` (:func:`sweep_devices`: ``None`` =
    every visible device of ``device``'s type, CUDA unless ``device``
    says otherwise; an int R; or a list, which may repeat a device).
    The data and the results live on the first of them.

    Streams one tracker record per point (group by group, at step
    ``point_offset + i``) with the error and cost-model coordinates of
    the frontier, plus the group's cold and warm seconds (module
    docstring).  ``convert=True`` also runs each point's best seed
    through the packed truth-table conversion as its group completes.

    Fault tolerance:
      * ``resume=dir`` journals every finished group through
        :class:`SweepJournal`; a rerun replays journaled groups whose
        :func:`group_fingerprint` still matches (no training) and trains
        only the rest — a killed sweep picks up where it stopped,
        bit-identical to an uninterrupted run.  A corrupt entry trains
        live.
      * a group whose training raises (a kernel failure included) is
        retried with exponential backoff (``retry_backoff_s *
        2**attempt``) up to ``max_group_retries`` times, then
        :class:`SweepGroupFailed`.
      * seeds that diverged (NaN/inf loss or accuracy) are quarantined
        per point (:func:`_point_result`).
      * ``chaos`` injects failures at the ``"sweep.group"`` site before
        each training attempt; ``watchdog`` (a :class:`StepWatchdog`)
        records each live group's seconds and flags stragglers into the
        tracker records.
    """
    tracker = tracker or NoopTracker()
    if max_group_retries < 0:
        raise ValueError("max_group_retries must be >= 0")
    pool = sweep_devices(device, devices)
    dev = pool[0]
    groups = plan_sweep(points, seeds=seeds, num_devices=len(pool))

    xd, yd = (torch.as_tensor(a, device=dev) for a in (x_train, y_train))
    xe, ye = (torch.as_tensor(a, device=dev) for a in (x_test, y_test))
    n = int(xd.shape[0])
    batch = min(batch, n)

    journal = SweepJournal(resume) if resume is not None else None
    ddig = (_data_digest(x_train, y_train, x_test, y_test)
            if journal is not None else "")

    results: List[PointResult] = []
    runs: List[GroupRun] = []
    t_sweep = time.perf_counter()
    for g in groups:
        ops = stack_group_operands(g, xd, device=dev)
        run = GroupRun(group=g, cold_s=0.0)
        runs.append(run)
        fp, replay = "", None
        if journal is not None:
            fp = group_fingerprint(
                g, epochs=epochs, batch=batch, lr=lr,
                weight_decay=weight_decay, sgdr_t0=sgdr_t0,
                subnet_route=subnet_route, data_digest=ddig)
            if journal.lookup(g.index, fp):
                try:
                    replay = journal.load(g.index, {
                        "params": ops[0], "state": ops[1],
                        "hist": dict.fromkeys(HIST_KEYS, 0)})
                except Exception:
                    replay = None       # corrupt entry -> train live
        if replay is not None:
            run.replayed = True
            params_w, state_w = (tree_map(lambda a: torch.as_tensor(
                a, device=dev), replay[k]) for k in ("params", "state"))
            hist = {k: np.asarray(v) for k, v in replay["hist"].items()}
        else:
            fn = make_group_train_fn(
                g.padded_cfg, n=n, batch=batch, epochs=epochs, lr=lr,
                weight_decay=weight_decay, sgdr_t0=sgdr_t0, devices=pool,
                subnet_route=subnet_route)
            while True:
                try:
                    if chaos is not None:
                        chaos.check("sweep.group",
                                    detail=f"group {g.index} training")
                    t0 = time.perf_counter()
                    params_w, state_w, hist_t, cold = fn(*ops, xd, yd, xe, ye)
                    hist = {k: v.cpu().numpy() for k, v in hist_t.items()}
                    break
                except Exception as e:
                    run.retries += 1
                    if run.retries > max_group_retries:
                        raise SweepGroupFailed(
                            f"group {g.index} failed after "
                            f"{run.retries} attempts: {e}") from e
                    time.sleep(retry_backoff_s * 2 ** (run.retries - 1))
            run.cold_s = cold
            run.warm_s = time.perf_counter() - t0 - cold
            if journal is not None:
                journal.save(g.index, fp, params_w, state_w, hist)
            if watchdog is not None:
                run.straggler = watchdog.record(run.cold_s + run.warm_s)
        group_points = [_point_result(g, pi, hist)
                        for pi in range(len(g.points))]
        if convert:
            tc = time.perf_counter()
            for pi, res in enumerate(group_points):
                if res.status != "ok":
                    continue
                res.params, res.state = member_params_state(
                    g, params_w, state_w, pi, res.best_seed)
                res.packed = TT.convert_packed(
                    res.point.cfg, res.params, res.state,
                    M.model_static(res.point.cfg))
            run.convert_s = time.perf_counter() - tc
        results.extend(group_points)
        for i, res in enumerate(group_points):
            tracker.log_metrics(
                {"point": res.name, "tag": res.point.tag,
                 "group": g.index, "err": res.err,
                 "err_mean": res.err_mean, "seeds": len(g.seeds),
                 "latency_ns": res.est.latency_ns,
                 "luts": res.est.luts,
                 "area_delay": res.est.area_delay,
                 "cold_s": run.cold_s, "warm_s": run.warm_s,
                 "status": res.status,
                 "diverged_seeds": res.diverged_seeds,
                 "retries": run.retries, "replayed": run.replayed,
                 "straggler": run.straggler,
                 "straggler_persistent": (watchdog.persistent
                                          if watchdog is not None
                                          else False)},
                step=g.point_offset + i)
    wall = time.perf_counter() - t_sweep
    return SweepResult(points=results, groups=runs, devices=len(pool),
                       warm_s=wall - sum(r.cold_s for r in runs))
