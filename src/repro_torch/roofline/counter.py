"""Per-rank costs of one step, counted by running it on the meta device
(the port's twin of ``repro.roofline.hlo``).

PyTorch has no HLO to parse: the step runs eagerly on meta tensors
(shapes and dtypes, no storage) and the counter watches every aten op
it dispatches.  What replaces what in ``hlo.py``:

* ``analyze_hlo``'s dot FLOPs (2 x result x contraction per ``dot``,
  times the loop multipliers) -> ``torch.utils.flop_counter.
  FlopCounterMode`` over the ops the step runs, every loop step
  included (a Python loop runs each step); ``dot_count`` counts the ops
  that its FLOP registry covers;
* ``analyze_hlo``'s HBM traffic (result + operand bytes of every
  instruction outside fusions, no-cost ops left out, tensors under a
  VMEM threshold dropped) -> result + operand bytes of every aten op,
  views and the no-cost ops (``_NOCOST``: allocations with no data, the
  ``iota`` and ``constant`` analogues) left out.  Eager PyTorch fuses
  nothing, so every op reads its operands and writes its results, and
  no threshold applies;
* the collective terms (``hlo.py``'s ring rules per collective
  instruction and its group size) -> the same rules per collective that
  a rank issues through a ``CountingMesh`` (``collective_cost``);
* XLA's buffer assignment (``memory_analysis``) -> the live bytes of
  the tensors the step makes: a result counts from the op that makes
  it until the last tensor on its storage dies (a finalizer on the
  storage), so the autograd graph's saved tensors count as long as the
  graph holds them.  ``peak_bytes`` is the largest such sum;
  ``output_bytes`` those of the step's results;
* ``hlo.py``'s known trip counts -> ``count_step(loop_steps=k)``: every
  long sequential loop of the models (``models.layers.common.
  sequential_loop``: the sLSTM's steps, the mLSTM's, the Mamba scan's,
  the attention's query and the loss's chunks) runs at most k + 2 of
  its n steps, and the counts are extended linearly to n from runs at k
  and k + 1 steps, checked against the run at k + 2 (``_extend``).
"""
from __future__ import annotations

import bisect
import contextlib
import weakref
from dataclasses import dataclass, field
from typing import Any, Callable, Dict, List, Optional, Tuple

import numpy as np
import torch
from torch.utils._python_dispatch import TorchDispatchMode
from torch.utils.flop_counter import FlopCounterMode, flop_registry

from repro_torch.models.layers.common import Steps
from repro_torch.sharding.spmd import ProcessMesh

# a loop this long or longer is counted from a few of its steps
# (count_step(loop_steps=)); a shorter one costs less to run whole than
# the three runs its extension takes
LONG_LOOPS = 32

COLLECTIVES = ("all-reduce", "all-gather", "reduce-scatter", "all-to-all",
               "collective-permute")

_aten = torch.ops.aten
# ops that move no data (hlo.py's _NOCOST_OPS: parameter, constant, iota,
# bitcast, ...): storage without contents, an iota, a constant
_NOCOST = {
    _aten.empty.memory_format, _aten.empty_strided.default,
    _aten.empty_like.default, _aten.new_empty.default,
    _aten.new_empty_strided.default, _aten.arange.default,
    _aten.arange.start, _aten.arange.start_step, _aten.arange.start_out,
    _aten.scalar_tensor.default, _aten.lift_fresh.default,
    _aten.lift_fresh_copy.default,
}


def collective_cost(op: str, nbytes: float, g: int) -> float:
    """Bytes one rank moves for a collective over a group of ``g``
    (``hlo.py``'s ring conventions; ``nbytes`` is the result's size, an
    all-reduce's the tensor's)."""
    if g <= 1:
        return 0.0
    if op == "all-gather":
        return nbytes * (g - 1) / g
    if op == "reduce-scatter":
        return nbytes * (g - 1)
    if op == "all-reduce":
        return 2 * nbytes * (g - 1) / g
    if op == "all-to-all":
        return nbytes * (g - 1) / g
    if op == "collective-permute":
        return nbytes
    raise ValueError(f"unknown collective {op!r}")


@dataclass
class StepAnalysis:
    """``HloAnalysis``'s fields, for one rank's step, plus its memory:
    ``peak_bytes`` (the live peak of what the step made), ``output_bytes``
    and ``loops`` (the trip count of every loop kind whose counts were
    extended from a few steps, ``count_step(loop_steps=)``)."""

    dot_flops: float = 0.0
    collective_bytes: float = 0.0
    hbm_bytes: float = 0.0
    collective_breakdown: Dict[str, float] = field(default_factory=dict)
    per_collective: List[Tuple[str, float, int, float]] = field(
        default_factory=list)
    unknown_trip_loops: int = 0
    dot_count: int = 0
    peak_bytes: float = 0.0
    output_bytes: float = 0.0
    loops: Dict[str, int] = field(default_factory=dict)


def _tensors(tree) -> List[torch.Tensor]:
    if isinstance(tree, torch.Tensor):
        return [tree]
    if isinstance(tree, dict):
        return [t for v in tree.values() for t in _tensors(v)]
    if isinstance(tree, (list, tuple)):
        return [t for v in tree for t in _tensors(v)]
    return []


def _nbytes(t: torch.Tensor) -> int:
    return t.numel() * t.element_size()


def _key(t: torch.Tensor) -> int:
    return t.untyped_storage()._cdata


_ACTIVE: List["_Tracker"] = []   # the counting run in progress


class _Tracker(TorchDispatchMode):
    """Bytes, dot ops, collectives and live memory of the ops dispatched
    under it.  With ``caps`` (trip count -> steps to run) it also keeps,
    per event label, the largest live sum, for ``_extend``: a loop of n
    steps runs ``caps[n]`` of them, or, if n is not in ``caps`` and at
    least ``long_from``, at most ``cap``."""

    def __init__(self, external, caps: Optional[Dict[int, int]] = None,
                 cap: Optional[int] = None, long_from: int = 0):
        super().__init__()
        self.external = {_key(t) for t in external}
        self.caps = caps
        self.cap = cap
        self.long_from = long_from
        self.hbm = 0
        self.dots = 0
        self.live = 0
        self.peak = 0
        self.sizes: Dict[int, int] = {}
        self.coll: List[Tuple[str, int, int]] = []
        self.trips: Dict[int, set] = {}
        self.labels: Dict[Any, int] = {}
        self.outside = 0
        self.node: Optional[Tuple[str, int]] = None
        self.nodes = 0
        self.step: Optional[Tuple[int, int, int]] = None
        self.events: Dict[Tuple[str, int, int], int] = {}
        self.instances = 0
        self.starts: List[int] = []
        self.ranges: List[Tuple[int, int, int, int, List[int]]] = []

    # -- storages --------------------------------------------------------

    def _free(self, key: int) -> None:
        self.live -= self.sizes.pop(key, 0)

    def _made(self, out) -> None:
        for t in _tensors(out):
            st = t.untyped_storage()
            key = st._cdata
            if key in self.external or key in self.sizes:
                continue
            self.sizes[key] = st.nbytes()
            self.live += st.nbytes()
            weakref.finalize(st, self._free, key)
        self.peak = max(self.peak, self.live)
        if self.caps is not None:
            label = self._label()
            if label is not None:
                self.labels[label] = max(self.labels.get(label, 0),
                                         self.live)

    def _label(self):
        """Where an event sits, the same in every run whatever the loops'
        step counts (``_extend``): in a loop's step or in the backward of
        a node made in one, (phase, loop run, step class, its place in
        the step), the step class being ("s", t) for the first two steps
        and ("e", k - 1 - t) for the last two of k, and None for the
        steps between (whose peaks a linear trend over the steps keeps
        below those at the ends); ("node", j) in the j-th run of another
        backward node (whose events may be as many as a loop's steps: an
        unbind's zeros for the steps not run); else its place among the
        other events."""
        if self.step is not None:
            return self._in_step("fwd", *self.step)
        node = torch._C._current_autograd_node()
        if node is None:
            self.outside += 1
            return ("op", self.outside)
        seq = node._sequence_nr()
        i = bisect.bisect_right(self.starts, seq) - 1
        if i >= 0 and seq < self.ranges[i][1]:
            inst, k, steps = self.ranges[i][2:]
            return self._in_step("bwd", inst,
                                 bisect.bisect_right(steps, seq) - 1, k)
        ident = (node.name(), seq)
        if ident != self.node:
            self.node = ident
            self.nodes += 1
        return ("node", self.nodes)

    def _in_step(self, phase, inst, t, k):
        cls = ("s", t) if t < 2 else ("e", k - 1 - t) if t >= k - 2 else None
        if cls is None:
            return None
        key = (phase, inst, t)
        self.events[key] = self.events.get(key, 0) + 1
        return (phase, inst, cls, self.events[key])

    # -- loops ------------------------------------------------------------

    @contextlib.contextmanager
    def loop(self, kind: str, n: int):
        if self.step is not None:
            raise RuntimeError(f"loop {kind!r} inside another loop")
        self.trips.setdefault(n, set()).add(kind)
        if self.caps is None:
            k = n
        elif n in self.caps:
            k = self.caps[n]
        else:
            k = (min(n, self.cap) if self.cap is not None
                 and n >= self.long_from else n)
        inst, seq0 = self.instances, self._seq()
        self.instances += 1
        steps = _CountedSteps(self, inst, n, k)
        try:
            yield steps
        finally:
            self.step = None
            self.starts.append(seq0)
            self.ranges.append((seq0, self._seq(), inst, k, steps.seqs))

    @staticmethod
    def _seq() -> int:
        """The sequence number the next autograd node will take."""
        return torch._C._autograd._get_sequence_nr()

    # -- ops ----------------------------------------------------------------

    def collective(self, op: str, nbytes: int, g: int, in_bytes: int):
        self.coll.append((op, nbytes, g))
        self.hbm += nbytes + in_bytes

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        out = func(*args, **kwargs)
        if func._overloadpacket in flop_registry:
            self.dots += 1
        if not (func.is_view or func in _NOCOST):
            self.hbm += sum(_nbytes(t) for t in _tensors(args))
            self.hbm += sum(_nbytes(t) for t in _tensors(kwargs))
            self.hbm += sum(_nbytes(t) for t in _tensors(out))
        self._made(out)
        return out


class _CountedSteps(Steps):
    """A loop's steps under the counter: ``k`` of its ``n`` run, each
    marked for ``_Tracker._label``; the inputs' pieces and the joined
    outputs cost what those of all ``n`` steps cost (``_Pieces``,
    ``_Join``), in one op each."""

    def __init__(self, tracker: "_Tracker", inst: int, n: int, k: int):
        super().__init__(n)
        self.tracker, self.inst, self.k = tracker, inst, k
        self.seqs: List[int] = []

    def __len__(self) -> int:
        return self.k

    def __iter__(self):
        for t in range(self.k):
            self.seqs.append(_Tracker._seq())
            self.tracker.step = (self.inst, t, self.k)
            yield t
        self.tracker.step = None

    def pieces(self, x, dim, size=None):
        if self.k == self.n:
            return super().pieces(x, dim, size)
        return _Pieces.apply(self.tracker, self.k, dim, size, x)

    def join(self, outs, dim, stack=True):
        if len(outs) == self.n:
            return super().join(outs, dim, stack)
        return _Join.apply(self.tracker, self.n, dim, stack, *outs)


class _Pieces(torch.autograd.Function):
    """The first k of ``x``'s pieces (views, as ``unbind`` or ``split``
    gives them), with the backward of the whole cut: one gradient of
    all of ``x``, at the cost of the stack or cat that builds it."""

    @staticmethod
    def forward(ctx, tracker, k, dim, size, x):
        ctx.set_materialize_grads(False)
        ctx.tracker, ctx.shape = tracker, x.shape
        parts = x.unbind(dim) if size is None else x.split(size, dim)
        return tuple(parts[:k])

    @staticmethod
    def backward(ctx, *grads):
        g = next((g for g in grads if g is not None), None)
        if g is None:
            return None, None, None, None, None
        whole = g.new_empty(ctx.shape)
        ctx.tracker.hbm += 2 * _nbytes(whole)
        return None, None, None, None, whole


class _Join(torch.autograd.Function):
    """The stack (or cat) of a loop's n step outputs of which the first
    k ran: a result of the whole size (no data: the counter reads
    none), at the cost of the stack; its backward hands each step its
    view of the gradient, as a stack's does."""

    @staticmethod
    def forward(ctx, tracker, n, dim, stack, *outs):
        last = outs[-1]
        ctx.k, ctx.dim, ctx.stack = len(outs), dim, stack
        ctx.size = outs[0].shape[dim]
        shape = list(last.shape)
        if stack:
            shape.insert(dim, n)
        else:
            shape[dim] = n * ctx.size
        whole = last.new_empty(shape)
        tracker.hbm += 2 * _nbytes(whole)
        return whole

    @staticmethod
    def backward(ctx, g):
        parts = (g.unbind(ctx.dim) if ctx.stack
                 else g.split(ctx.size, ctx.dim))[:ctx.k]
        return (None, None, None, None) + tuple(parts)


def _run(fn, args, caps=None, cap=None, long_from=0):
    """One counted run -> (raw counts, {trip count: loop kinds})."""
    from repro_torch.models.layers import common
    tr = _Tracker(_tensors(args), caps, cap, long_from)
    _ACTIVE.append(tr)
    common.set_loop_hook(tr.loop)
    try:
        with FlopCounterMode(display=False) as fc, tr:
            out = fn(*args)
        outs = {_key(t): t.untyped_storage().nbytes() for t in _tensors(out)
                if _key(t) in tr.sizes}
        del out
    finally:
        common.set_loop_hook(None)
        _ACTIVE.pop()
    raw = {"dot_flops": int(fc.get_total_flops()), "hbm_bytes": tr.hbm,
           "dot_count": tr.dots, "output_bytes": sum(outs.values()),
           "peak_bytes": tr.peak, "labels": tr.labels,
           "collectives": tr.coll}
    return raw, tr.trips


_ADDITIVE = ("dot_flops", "hbm_bytes", "dot_count", "output_bytes")


def _analysis(raw, loops=None) -> StepAnalysis:
    res = StepAnalysis(dot_flops=float(raw["dot_flops"]),
                       hbm_bytes=float(raw["hbm_bytes"]),
                       dot_count=int(raw["dot_count"]),
                       peak_bytes=float(raw["peak_bytes"]),
                       output_bytes=float(raw["output_bytes"]),
                       loops=dict(loops or {}))
    for op, nbytes, g in raw["collectives"]:
        comm = collective_cost(op, nbytes, g)
        res.collective_bytes += comm
        res.collective_breakdown[op] = (
            res.collective_breakdown.get(op, 0.0) + comm)
        res.per_collective.append((op, float(nbytes), g, 1.0))
    return res


def _extend(base, per_kind, trips, k, check):
    """Counts at every loop's full trip count from the run with every
    loop at ``k`` steps (``base``) and, per kind, the run with that kind
    at k + 1 (``per_kind``): each count, and each event label's live
    sum, is affine in every kind's step count (each step past the first
    is the same ops on the same shapes), so it is base + sum over kinds
    of (n - k) x the kind's difference.  ``check`` is the run with every
    kind at k + 2, which the same rule must give exactly, else the
    counts are not affine and ValueError is raised."""
    def predict(steps):
        out = {}
        for f in _ADDITIVE:
            out[f] = base[f] + sum((steps[kd] - k) * (r[f] - base[f])
                                   for kd, r in per_kind.items())
        labels = {}
        for lb, v in base["labels"].items():
            labels[lb] = v + sum(
                (steps[kd] - k) * (r["labels"][lb] - v)
                for kd, r in per_kind.items())
        out["labels"] = labels
        return out

    for r in list(per_kind.values()) + [check]:
        if r["labels"].keys() != base["labels"].keys() or \
                r["collectives"] != base["collectives"]:
            raise ValueError("a loop's step count changed the step's events "
                             "outside the loop: its counts do not extend")
    want = predict({kd: k + 2 for kd in per_kind})
    for f in _ADDITIVE + ("labels",):
        if want[f] != check[f]:
            raise ValueError(f"{f} is not affine in the loops' step counts "
                             f"({k}, {k + 1}, {k + 2} steps)")
    full = predict(trips)
    full["peak_bytes"] = max(full["labels"].values())
    full["collectives"] = base["collectives"]
    return full


def count_step(fn: Callable, *args, loop_steps: Optional[int] = None
               ) -> StepAnalysis:
    """Run ``fn(*args)`` (tensors on the meta device) and count it.  The
    arguments' storages are not counted as the step's; a caller adds
    them (``MemoryStats``).  With ``loop_steps=k`` the loops of n >=
    ``LONG_LOOPS`` (and > k + 2) steps run k, k + 1 and k + 2 of them in
    separate runs, all loops of one trip count together, and their
    counts are extended to n (module docstring); a step without such a
    loop runs once."""
    if loop_steps is None:
        raw, trips = _run(fn, args, None)
        return _analysis(raw, None)
    k = int(loop_steps)
    if k < 4:
        raise ValueError("loop_steps must be at least 4: a loop's first "
                         "two steps and its last two differ from the "
                         "others (the first starts from a constant state, "
                         "so what the second saves differs; the last "
                         "one's state is not read)")
    long_from = max(LONG_LOOPS, k + 3)
    check, trips = _run(fn, args, {}, k + 2, long_from)
    long = {n: n for n in trips if n >= long_from}
    if not long:
        return _analysis(check, None)
    caps = {n: k for n in long}
    base, _ = _run(fn, args, caps)
    per_kind = {n: _run(fn, args, {**caps, n: k + 1})[0] for n in long}
    loops = {"+".join(sorted(trips[n])): n for n in long}
    return _analysis(_extend(base, per_kind, long, k, check), loops)


class CountingMesh(ProcessMesh):
    """A ``ProcessMesh`` of ``mcfg``'s shape with no process group: this
    rank sits at rank 0's coordinates, a collective records ``(op,
    bytes, group size)`` in ``plan`` (and in the counting run, if one is
    active) and returns meta tensors of the real one's shapes, so that
    ``sharding.spmd``'s steps run unchanged and issue exactly the
    collectives a rank issues."""

    def __init__(self, mcfg, device="meta"):
        self.config = mcfg
        self.shape = tuple(int(s) for s in mcfg.shape)
        self.axes = tuple(mcfg.axes)
        self.device = torch.device(device)
        self.world = mcfg.num_devices
        self.rank = 0
        self.backend = None
        self.stage = False
        self.coords = tuple(int(c) for c in np.unravel_index(0, self.shape))
        self._groups = {}
        self.device_mesh = None
        self.plan: List[Tuple[str, int, int]] = []

    def group(self, axes):
        live = self._live(axes)
        if not live:
            return None
        return None, list(range(self.size(live)))

    def _record(self, op: str, nbytes: int, g: int, in_bytes: int) -> None:
        self.plan.append((op, nbytes, g))
        if _ACTIVE:
            _ACTIVE[-1].collective(op, nbytes, g, in_bytes)

    def all_reduce(self, t: torch.Tensor, op: str, axes) -> torch.Tensor:
        g = self.group(axes)
        if g is None:
            return t.clone()
        self._record("all-reduce", _nbytes(t), len(g[1]), _nbytes(t))
        return torch.empty_like(t)

    def all_gather(self, t: torch.Tensor, axes) -> List[torch.Tensor]:
        g = self.group(axes)
        if g is None:
            return [t]
        n = len(g[1])
        self._record("all-gather", n * _nbytes(t), n, _nbytes(t))
        return [torch.empty_like(t) for _ in range(n)]

    def barrier(self) -> None:
        pass

    def any(self, flag: bool) -> bool:
        return bool(flag)


__all__ = ["COLLECTIVES", "CountingMesh", "StepAnalysis", "collective_cost",
           "count_step"]
