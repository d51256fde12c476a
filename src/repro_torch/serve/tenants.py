"""Multi-tenant LUT serving: N bundles behind one admission-controlled
engine (port of ``repro.serve.tenants``).

  * **Admission control.**  Every tenant has its own bounded request
    queue, an optional token-bucket rate limit and a priority.  A
    request that would overflow the queue or exceed the rate is shed at
    the door (:class:`TenantOverloaded`, counted in the tenant's and the
    engine's ``shed_rate``) instead of being accepted and served late.
  * **Cross-tenant batch packing.**  Tenants are grouped by
    ``ServeBundle.geometry_key`` (operand shapes, not contents).  Each
    geometry group owns one forward, :func:`make_tenant_forward_fn`,
    over stacked per-tenant operands, and one dispatch carries rows of
    many tenants, a per-row tenant id selecting each row's tables.  The
    reference's forward is jnp, not a Pallas kernel (a one-hot
    shift-matmul); this one is plain PyTorch of its own: per row it
    gathers the codes through its tenant's connectivity, builds the
    address, reads the packed word and shifts out the code.  It is
    bit-identical to serving each tenant alone.
  * **Priority scheduling.**  The per-group dispatcher drains tenant
    queues in descending priority order when coalescing a dispatch.
  * **Shared replica pools.**  Each group routes coalesced dispatches
    over its own pool of executors (``replicas``, each on its own CUDA
    stream, all reading the group's one copy of the operands on
    ``device``) with the single-bundle engine's routing, health
    eviction, redispatch and deadlines (serve/engine.py).
  * **Hot-swap deployment.**  ``swap()`` runs validate -> shadow ->
    cutover -> committed: live traffic for the tenant is mirrored
    through the candidate's own single-bundle forward
    (``engine.make_forward_fn``: the LUT-cascade kernel K1 on the card)
    and every mirrored prediction must equal the incumbent's.  A
    1-replica :class:`ReplicaHealthTracker` canary drives rollback: a
    mismatch or a candidate failure evicts it and the swap rolls back
    with the incumbent still serving.  Cutover is atomic: the group's
    tuple of stacked operands is replaced by one assignment, and every
    dispatch reads one snapshot, so no request sees a torn bundle.
"""
from __future__ import annotations

import threading
import time
from collections import deque
from dataclasses import dataclass, field
from typing import Callable, Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from repro_torch.core.lut_infer import pack_index
from repro_torch.core.model import node_static_conns
from repro_torch.core.nl_config import is_graph_config
from repro_torch.device import DeviceLike, resolve_device
from repro_torch.kernels.lut_cascade import cascade_meta, graph_cascade_meta
from repro_torch.kernels.ref import as_schedule
from repro_torch.runtime.chaos import ChaosHarness
from repro_torch.runtime.fault import ReplicaHealthTracker
from repro_torch.serve.engine import (DEFAULT_BUCKETS, NoHealthyReplicas,
                                      _complete, _drop_expired,
                                      _ReplicaExecutor, _Request,
                                      make_forward_fn, route_least_loaded)
from repro_torch.serve.metrics import ServeMetrics
from repro_torch.serve.registry import ServeBundle


class TenantOverloaded(RuntimeError):
    """A request shed at the admission door (never enqueued)."""

    def __init__(self, tenant: str, reason: str, detail: str = ""):
        self.tenant = tenant
        self.reason = reason  # "queue_full" | "rate_limited"
        super().__init__(
            f"tenant '{tenant}' shed request ({reason})"
            + (f": {detail}" if detail else ""))


@dataclass
class Tenant:
    """One tenant's serving contract: its bundle plus admission policy."""

    name: str
    bundle: ServeBundle
    priority: int = 0                    # higher drains first
    rate_limit: Optional[float] = None   # requests/s; None = unlimited
    burst: Optional[int] = None          # token-bucket capacity
    max_queue_depth: int = 256           # queued requests before shedding


@dataclass
class SwapReport:
    """Outcome of one ``swap()`` run (see the state machine above)."""

    tenant: str
    status: str                          # committed | rolled_back | timeout
    shadow_samples: int = 0              # mirrored rows compared
    mismatches: int = 0
    swap_latency_s: float = 0.0          # validate -> terminal state
    cutover_latency_s: float = 0.0       # the atomic operand replacement
    states: Tuple[str, ...] = ()
    canary: List = field(default_factory=list)   # health.status() snapshot
    error: str = ""


class _TokenBucket:
    """Classic token bucket on ``time.monotonic``; the caller holds the
    tenant's group lock."""

    def __init__(self, rate: float, burst: int):
        if rate <= 0:
            raise ValueError(f"rate_limit={rate} must be positive")
        if burst < 1:
            raise ValueError(f"burst={burst} must be >= 1")
        self.rate = float(rate)
        self.burst = float(burst)
        self.tokens = float(burst)
        self.t_last = time.monotonic()

    def try_take(self, now: float) -> bool:
        self.tokens = min(self.burst,
                          self.tokens + (now - self.t_last) * self.rate)
        self.t_last = now
        if self.tokens >= 1.0:
            self.tokens -= 1.0
            return True
        return False


class _TenantRequest(_Request):
    __slots__ = ("lane", "tenant")

    def __init__(self, x: np.ndarray, lane: int, tenant: "_TenantState",
                 timeout_s: Optional[float] = None):
        super().__init__(x, timeout_s)
        self.lane = lane
        self.tenant = tenant


class _TenantState:
    """Engine-internal per-tenant state: queue, rate bucket, metrics."""

    def __init__(self, spec: Tenant, lane: int, group: "_GeometryGroup"):
        self.spec = spec
        self.lane = lane
        self.group = group
        self.metrics = ServeMetrics()
        self.pending: "deque[_TenantRequest]" = deque()
        self.bucket = (None if spec.rate_limit is None else
                       _TokenBucket(spec.rate_limit,
                                    spec.burst or max(
                                        1, int(spec.rate_limit))))


def make_tenant_forward_fn(cfg) -> Callable:
    """Cross-tenant packed forward for one geometry group, in plain
    PyTorch.

    ``forward(x, tid, in_log_s, conns, pts, out_log_s) -> (B,) int32``:
    ``x`` (B, in_features) float32 and ``tid`` (B,) int64 (each row's
    tenant lane) on the operands' device; every operand carries a
    leading tenant axis T: ``in_log_s`` (T, in_features),
    ``conns[k]`` (T, O, F) int64 and ``pts[k]`` (T, O, Tw) int32 per
    flat (node, branch) operand, ``out_log_s`` (T, classes).

    The walk follows the group's DAG schedule (a chain is the degenerate
    case): per node the source buffers are concatenated into the pool;
    per branch each row gathers its codes through ``conns[k][tid]``,
    packs the address (slot 0 = MSB), loads word ``addr >> slot_bits``
    of its tenant's packed row and shifts out the code; an adder-tree
    node sums its branch codes.  Every step is integer arithmetic on the
    row's own tenant's operands, and the scales are the tenant's own
    rows, so each prediction is bit-identical to serving that tenant
    alone.  The operands are arguments, so one forward serves every
    tenant of the group and a hot swap only rebinds them."""
    schedule = (graph_cascade_meta(cfg) if is_graph_config(cfg)
                else as_schedule(cascade_meta(cfg)))
    beta = cfg.beta
    beta_in = cfg.beta_in or cfg.beta
    lo, hi = -(2 ** (beta_in - 1)), 2 ** (beta_in - 1) - 1

    def forward(x, tid, in_log_s, conns, pts, out_log_s):
        # Per-row input quantization with the row's tenant's scales:
        # the codes quant.quant_codes gives for that tenant alone.
        s_in = torch.exp(in_log_s)[tid]                     # (B, F)
        q = torch.clamp(torch.round(x / s_in), lo, hi).to(torch.int32)
        bufs = [q + 2 ** (beta_in - 1)]
        b = x.shape[0]
        k = 0
        for srcs, arity, in_bits, _wb, slot_bits, nb in schedule:
            pool = (bufs[srcs[0]] if len(srcs) == 1
                    else torch.cat([bufs[s] for s in srcs], dim=1))
            node_code = None
            for _a in range(arity):
                conn, pt = conns[k][tid], pts[k]            # (B, O, F)
                k += 1
                o, f = conn.shape[1:]
                gathered = torch.gather(pool, 1, conn.reshape(b, o * f))
                addr = pack_index(gathered.reshape(b, o, f), in_bits)
                wsel = (addr >> slot_bits).long()           # (B, O)
                slot = addr & ((1 << slot_bits) - 1)
                rows = torch.arange(o, device=x.device)[None, :]
                word = pt[tid[:, None], rows, wsel]
                code = (word >> (nb * slot)) & ((1 << nb) - 1)
                node_code = code if node_code is None else node_code + code
            bufs.append(node_code)
        s_out = torch.exp(out_log_s)[tid]                   # (B, O_last)
        vals = (bufs[-1].to(torch.float32) - 2 ** (beta - 1)) * s_out
        return torch.argmax(vals, dim=-1).to(torch.int32)

    return forward


class _Shadow:
    """One in-flight shadow deployment on a tenant lane.

    The candidate's own single-bundle forward mirrors live rows; the
    1-replica health tracker is the canary: any mismatch or candidate
    failure records a failure, the canary evicts, and ``on_evict`` flips
    the swap into rollback."""

    def __init__(self, lane: int, forward: Callable, target: int,
                 max_failures: int):
        self.lane = lane
        self.forward = forward
        self.target = target
        self.compared = 0
        self.mismatches = 0
        self.error = ""
        self.finished = threading.Event()
        self.aborted = False
        self._lock = threading.Lock()

        def _on_evict(rid, exc):
            with self._lock:
                self.aborted = True
                if exc is not None and not self.error:
                    self.error = str(exc)
            self.finished.set()

        self.health = ReplicaHealthTracker(
            1, max_consecutive_failures=max_failures, on_evict=_on_evict)

    def observe(self, x_rows: np.ndarray, primary_preds: np.ndarray) -> None:
        """Mirror ``x_rows`` through the candidate and compare exactly."""
        try:
            got = self.forward(x_rows).cpu().numpy()
        except Exception as e:  # candidate unhealthy: canary failure
            self.health.record_failure(0, e)
            return
        bad = int((got != primary_preds).sum())
        with self._lock:
            self.compared += len(x_rows)
            self.mismatches += bad
            done = self.compared >= self.target and not self.aborted
        if bad:
            self.health.record_failure(0, RuntimeError(
                f"shadow mismatch: {bad}/{len(x_rows)} mirrored "
                f"predictions diverge from the incumbent"))
        else:
            self.health.record_success(0)
            if done:
                self.finished.set()


class _GeometryGroup:
    """All tenants sharing one geometry key: stacked operands on one
    device, one forward, one dispatcher, one executor pool."""

    def __init__(self, key: tuple, cfg, device: torch.device):
        self.key = key
        self.cfg = cfg
        self.device = device
        self.tenants: List[_TenantState] = []
        self.cond = threading.Condition()      # guards tenant queues
        self._state_lock = threading.Lock()    # guards operands + shadows
        self._operands: Optional[tuple] = None
        self._shadows: Dict[int, _Shadow] = {}
        self.version = 0
        self.forward = make_tenant_forward_fn(cfg)
        self.executors: List["_TenantExecutor"] = []
        self.health: Optional[ReplicaHealthTracker] = None
        self.rr = 0
        self.thread: Optional[threading.Thread] = None

    # -- tenants / operands ------------------------------------------------

    def add_tenant(self, state: _TenantState) -> None:
        self.tenants.append(state)
        self.tenants.sort(key=lambda t: (-t.spec.priority, t.lane))

    def restack(self) -> None:
        """Rebuild the stacked (T, ...) operand tuple from the current
        bundles and upload it.  The whole tuple is replaced as one
        reference under the state lock — executors snapshot it once per
        dispatch, which is what makes cutover atomic."""
        bundles = [t.spec.bundle for t in sorted(self.tenants,
                                                 key=lambda t: t.lane)]
        for b in bundles:
            b.prepack()
        dev = self.device

        def stack(arrays, dtype):
            return torch.as_tensor(
                np.stack([np.asarray(a, dtype) for a in arrays]),
                device=dev)

        # One stacked tensor per flat (node, branch) operand; equal
        # geometry keys guarantee equal operand counts and shapes.
        flat_conns = [[c for s in b.statics for c in node_static_conns(s)]
                      for b in bundles]
        conns = [stack([fc[i] for fc in flat_conns], np.int64)
                 for i in range(len(flat_conns[0]))]
        pts = [stack([b.packed_tables[i] for b in bundles], np.int32)
               for i in range(len(bundles[0].packed_tables))]
        ops = (stack([b.in_log_s for b in bundles], np.float32), conns, pts,
               stack([b.layer_log_s[-1] for b in bundles], np.float32))
        if dev.type == "cuda":
            # Executors read the operands on their own streams.
            torch.cuda.current_stream(dev).synchronize()
        with self._state_lock:
            self._operands = ops
            self.version += 1

    def operands(self) -> tuple:
        with self._state_lock:
            return self._operands

    # -- shadows -----------------------------------------------------------

    def install_shadow(self, shadow: _Shadow) -> None:
        with self._state_lock:
            if shadow.lane in self._shadows:
                raise RuntimeError(
                    f"a swap is already in flight on lane {shadow.lane}")
            self._shadows[shadow.lane] = shadow

    def remove_shadow(self, lane: int) -> None:
        with self._state_lock:
            self._shadows.pop(lane, None)

    def mirror(self, x: np.ndarray, tid: np.ndarray,
               preds: np.ndarray) -> None:
        """Executor-side hook, after the primary futures resolved: feed
        each active shadow its tenant's rows of this dispatch."""
        with self._state_lock:
            shadows = list(self._shadows.values())
        for sh in shadows:
            sel = tid == sh.lane
            if sel.any():
                sh.observe(x[sel], preds[sel])

    # -- dispatcher-side queue accounting ---------------------------------

    def has_work(self) -> bool:
        return any(t.pending for t in self.tenants)

    def pop(self, budget: int) -> Tuple[List[_TenantRequest], int]:
        """Drain queued requests in descending tenant priority, up to
        ``budget`` rows (one oversized request may exceed it — the
        executor chunks).  Caller holds ``cond``."""
        batch: List[_TenantRequest] = []
        total = 0
        for t in self.tenants:  # sorted by (-priority, lane)
            while t.pending and total < budget:
                r = t.pending.popleft()
                batch.append(r)
                total += r.n
        return batch, total


class _TenantExecutor(_ReplicaExecutor):
    """A replica worker for one geometry group.  The batching, failure,
    redispatch and metrics logic is ``_ReplicaExecutor``'s; its hooks
    thread the per-row tenant id through the bucket-padded dispatch,
    snapshot the group operands once per dispatch (atomicity), and
    mirror served rows to any active shadow after the primary futures
    resolved."""

    def __init__(self, rid: int, group: _GeometryGroup, *,
                 buckets: Sequence[int], engine_metrics: ServeMetrics,
                 health: ReplicaHealthTracker,
                 redispatch: Optional[Callable] = None,
                 chaos: Optional[ChaosHarness] = None):
        super().__init__(rid, group.forward, buckets=buckets,
                         device=group.device,
                         engine_metrics=engine_metrics, health=health,
                         redispatch=redispatch, chaos=chaos)
        self._group = group

    def warmup(self, in_features: int) -> None:
        ops = self._group.operands()
        with self._on_stream():
            for b in self._buckets:
                x = torch.zeros((b, in_features), device=self.device)
                tid = torch.zeros((b,), dtype=torch.long,
                                  device=self.device)
                self._forward(x, tid, *ops).cpu()

    def _dispatch_args(self, batch: List[_TenantRequest]) -> tuple:
        tid = np.concatenate([np.full(r.n, r.lane, np.int64)
                              for r in batch])
        return tid, self._group.operands()  # ONE snapshot per dispatch

    def _call(self, chunk: np.ndarray, rows: slice, bucket: int,
              extra: tuple) -> torch.Tensor:
        tid, ops = extra
        tchunk = tid[rows]
        if len(tchunk) < bucket:
            # lane 0 is always a valid row of the stacked operands; the
            # padded rows' predictions are dropped.
            tchunk = np.concatenate(
                [tchunk, np.zeros(bucket - len(tchunk), np.int64)])
        return self._forward(torch.as_tensor(chunk).to(self.device),
                             torch.as_tensor(tchunk).to(self.device), *ops)

    def _after_serve(self, x: np.ndarray, preds: np.ndarray,
                     extra: tuple) -> None:
        # Shadows see exactly what was served, only after every client
        # future resolved: mirroring adds capacity cost, never latency
        # to the batch being mirrored.
        self._group.mirror(x, extra[0], preds)


class MultiTenantEngine:
    """Serve N ServeBundles behind one admission-controlled front door
    (see module docstring), on ``device`` (``None`` = CUDA)."""

    def __init__(self, tenants: Sequence[Tenant], *,
                 buckets: Sequence[int] = DEFAULT_BUCKETS,
                 max_wait_ms: float = 2.0,
                 replicas: int = 1,
                 device: DeviceLike = None,
                 metrics: Optional[ServeMetrics] = None,
                 max_dispatch_retries: int = 2,
                 revive_probe: Optional[Callable[[int], bool]] = None,
                 chaos: Optional[ChaosHarness] = None):
        if not tenants:
            raise ValueError("MultiTenantEngine needs at least one tenant")
        if list(buckets) != sorted(set(buckets)):
            raise ValueError(f"buckets must be strictly increasing: {buckets}")
        if replicas < 1:
            raise ValueError(f"replicas={replicas} must be >= 1")
        if max_dispatch_retries < 0:
            raise ValueError(f"max_dispatch_retries={max_dispatch_retries} "
                             f"must be >= 0")
        self.device = resolve_device(device)
        self.buckets = tuple(int(b) for b in buckets)
        self.max_wait_s = max_wait_ms / 1e3
        self.max_dispatch_retries = max_dispatch_retries
        self.revive_probe = revive_probe
        self.metrics = metrics or ServeMetrics()
        self._groups: Dict[tuple, _GeometryGroup] = {}
        self._tenants: Dict[str, _TenantState] = {}
        self._closed = False
        self._started = False
        self._lifecycle = threading.Lock()
        for spec in tenants:
            if spec.name in self._tenants:
                raise ValueError(f"duplicate tenant name '{spec.name}'")
            key = spec.bundle.geometry_key
            group = self._groups.get(key)
            if group is None:
                group = self._groups[key] = _GeometryGroup(
                    key, spec.bundle.cfg, self.device)
            state = _TenantState(spec, lane=len(
                [t for t in self._tenants.values() if t.group is group]),
                group=group)
            group.add_tenant(state)
            self._tenants[spec.name] = state
        for group in self._groups.values():
            group.restack()
            group.health = ReplicaHealthTracker(replicas)
            group.executors = [
                _TenantExecutor(i, group, buckets=self.buckets,
                                engine_metrics=self.metrics,
                                health=group.health,
                                redispatch=self._make_redispatch(group),
                                chaos=chaos)
                for i in range(replicas)]

    def _make_redispatch(self, group: "_GeometryGroup") -> Callable:
        """Per-group self-healing hook (see LUTServeEngine._redispatch):
        re-route a failed batch inside the group's own replica pool."""
        def redispatch(batch, total, attempts, failed_rid) -> bool:
            if attempts > self.max_dispatch_retries:
                return False
            chosen = route_least_loaded(group.executors, group.health,
                                        group.rr, exclude=failed_rid)
            if chosen is None:
                self._probe_evicted(group)
                chosen = route_least_loaded(group.executors, group.health,
                                            group.rr, exclude=failed_rid)
            if chosen is None:
                return False
            group.rr = chosen.rid
            self.metrics.record_redispatch()
            chosen.dispatch(batch, total, 0, attempts)
            return True
        return redispatch

    def _probe_evicted(self, group: "_GeometryGroup") -> None:
        """Ask ``revive_probe(rid)`` about every evicted replica of one
        group; a raising probe counts as 'still down'."""
        if self.revive_probe is None:
            return
        healthy = set(group.health.healthy_ids())
        for ex in group.executors:
            if ex.rid in healthy:
                continue
            try:
                ok = bool(self.revive_probe(ex.rid))
            except Exception:
                ok = False
            if ok:
                group.health.revive(ex.rid)

    # -- introspection -----------------------------------------------------

    @property
    def num_groups(self) -> int:
        return len(self._groups)

    @property
    def tenant_names(self) -> List[str]:
        return list(self._tenants)

    @property
    def forwards(self) -> int:
        """Bucket-padded forwards that served batches, over every group
        and replica (``warmup`` not counted)."""
        return sum(ex.forwards for g in self._groups.values()
                   for ex in g.executors)

    def tenant_metrics(self, name: str) -> ServeMetrics:
        return self._tenant(name).metrics

    def group_of(self, name: str) -> _GeometryGroup:
        return self._tenant(name).group

    def _tenant(self, name: str) -> _TenantState:
        try:
            return self._tenants[name]
        except KeyError:
            raise ValueError(
                f"unknown tenant '{name}' (have {sorted(self._tenants)})"
            ) from None

    # -- lifecycle ---------------------------------------------------------

    def start(self) -> "MultiTenantEngine":
        with self._lifecycle:
            if self._closed:
                raise RuntimeError("engine is closed")
            if self._started:
                return self
            self._started = True
        for group in self._groups.values():
            for ex in group.executors:
                ex.start()
            group.thread = threading.Thread(
                target=self._dispatch_loop, args=(group,), daemon=True,
                name=f"mt-serve-dispatch-{len(group.tenants)}t")
            group.thread.start()
        return self

    def warmup(self) -> None:
        """Run every bucket shape once for every geometry group."""
        for group in self._groups.values():
            for ex in group.executors:
                ex.warmup(group.cfg.in_features)

    def close(self) -> None:
        """Stop admission, drain every admitted request, join all
        threads.  Idempotent."""
        with self._lifecycle:
            if self._closed:
                return
            self._closed = True
            started = self._started
        for group in self._groups.values():
            with group.cond:
                group.cond.notify_all()
        if started:
            for group in self._groups.values():
                if group.thread is not None:
                    group.thread.join()
                    group.thread = None
                for ex in group.executors:
                    ex.stop()
        # Never started: nothing is draining the queues — fail any
        # requests admitted before close instead of leaving them pending.
        for group in self._groups.values():
            with group.cond:
                leftovers, _ = group.pop(float("inf"))
            for r in leftovers:
                _complete(r.future, exc=RuntimeError("engine closed"))

    def __enter__(self) -> "MultiTenantEngine":
        self.start()
        return self

    def __exit__(self, *exc) -> None:
        self.close()

    # -- client API --------------------------------------------------------

    def submit(self, tenant: str, x: np.ndarray, *,
               timeout_s: Optional[float] = None):
        """Admission-controlled enqueue for one tenant.  Raises
        :class:`TenantOverloaded` (and counts the shed) when the tenant's
        rate limit or queue bound would be exceeded, and RuntimeError
        once the engine is closed.  Returns a Future of the (n,) int32
        predictions.  ``timeout_s`` sets a per-request deadline
        (``serve.engine.DeadlineExceeded``).  Requests admitted before
        ``start()`` queue up and are served, strictly by priority, once
        the engine starts."""
        state = self._tenant(tenant)
        x = np.asarray(x, np.float32)
        if x.ndim == 1:
            x = x[None, :]
        f = state.group.cfg.in_features
        if x.ndim != 2 or x.shape[1] != f or x.shape[0] == 0:
            raise ValueError(f"request shape {x.shape} != (n >= 1, {f})")
        if timeout_s is not None and timeout_s <= 0:
            raise ValueError(f"timeout_s={timeout_s} must be positive")
        req = _TenantRequest(x, state.lane, state, timeout_s)
        group = state.group
        with group.cond:
            if self._closed:
                raise RuntimeError("engine is closed")
            now = time.monotonic()
            if state.bucket is not None and not state.bucket.try_take(now):
                state.metrics.record_shed()
                self.metrics.record_shed()
                raise TenantOverloaded(
                    tenant, "rate_limited",
                    f"{state.spec.rate_limit:.0f} req/s exceeded")
            if len(state.pending) >= state.spec.max_queue_depth:
                state.metrics.record_shed()
                self.metrics.record_shed()
                raise TenantOverloaded(
                    tenant, "queue_full",
                    f"{len(state.pending)} queued >= bound "
                    f"{state.spec.max_queue_depth}")
            state.pending.append(req)
            state.metrics.record_admitted()
            self.metrics.record_admitted()
            group.cond.notify_all()
        return req.future

    def predict(self, tenant: str, x: np.ndarray, *,
                timeout_s: Optional[float] = None) -> np.ndarray:
        if not self._started:
            self.start()
        return self.submit(tenant, x, timeout_s=timeout_s).result()

    # -- dispatcher (one thread per geometry group) ------------------------

    def _dispatch_loop(self, group: _GeometryGroup) -> None:
        max_bucket = self.buckets[-1]
        while True:
            with group.cond:
                while not group.has_work():
                    if self._closed:
                        return
                    group.cond.wait(timeout=0.05)
                batch, total = group.pop(max_bucket)
            deadline = time.perf_counter() + self.max_wait_s
            # Coalesce across tenants until the largest bucket fills or
            # the admission window closes (skipped once draining).
            while total < max_bucket and not self._closed:
                wait = deadline - time.perf_counter()
                if wait <= 0:
                    break
                with group.cond:
                    if not group.has_work():
                        group.cond.wait(timeout=wait)
                    more, n = group.pop(max_bucket - total)
                if more:
                    batch += more
                    total += n
            self._route(group, batch, total)

    def _route(self, group: _GeometryGroup, batch: List[_TenantRequest],
               total: int) -> None:
        batch = _drop_expired(batch, self.metrics)
        if not batch:
            return
        total = sum(r.n for r in batch)
        with group.cond:
            depth = sum(len(t.pending) for t in group.tenants)
        chosen = route_least_loaded(group.executors, group.health, group.rr)
        if chosen is None:
            self._probe_evicted(group)
            chosen = route_least_loaded(group.executors, group.health,
                                        group.rr)
        if chosen is None:
            err = NoHealthyReplicas(
                f"no healthy replicas (of {len(group.executors)}) in "
                f"geometry group — failure counts "
                f"{group.health.failure_counts()}")
            for r in batch:
                if _complete(r.future, exc=err):
                    r.tenant.metrics.record_shed()
                    self.metrics.record_shed()
            return
        group.rr = chosen.rid
        chosen.dispatch(batch, total, depth)

    # -- hot-swap deployment ----------------------------------------------

    def swap(self, tenant: str, candidate: ServeBundle, *,
             shadow_samples: int = 64, timeout_s: float = 30.0,
             max_shadow_failures: int = 1) -> SwapReport:
        """Hot-swap ``tenant`` onto ``candidate``.

        State machine: validate -> shadow -> cutover -> committed.  The
        shadow phase mirrors live traffic through the candidate's own
        forward (``make_forward_fn``: K1 on the card) until
        ``shadow_samples`` rows agreed exactly with the incumbent; any
        mismatch or candidate failure (one that fails to build its
        forward included) trips the 1-replica canary and rolls the swap
        back with the incumbent untouched.  ``shadow_samples=0`` skips
        the shadow check — an explicit opt-out for candidates that are
        supposed to change predictions.  No live traffic within
        ``timeout_s`` also rolls back (status "timeout").  Cutover is
        the atomic replacement of the group's stacked operands; the old
        bundle is evicted from the group on commit."""
        state = self._tenant(tenant)
        group = state.group
        t0 = time.perf_counter()
        states = ["validate"]
        if candidate.geometry_key != group.key:
            raise ValueError(
                f"candidate geometry {candidate.geometry_key} does not "
                f"match tenant '{tenant}' group {group.key} — hot-swap "
                f"requires identical operand shapes")
        compared = mismatches = 0
        canary_status: List = []
        error = ""
        if shadow_samples > 0:
            states.append("shadow")
            try:
                forward = make_forward_fn(candidate, device=group.device)
            except Exception as e:
                # Its operands do not even build: the first mirrored
                # batch fails the canary, as a failing forward would.
                def forward(x, _e=e):
                    raise _e
            shadow = _Shadow(state.lane, forward, shadow_samples,
                             max_shadow_failures)
            group.install_shadow(shadow)
            try:
                shadow.finished.wait(timeout=timeout_s)
            finally:
                group.remove_shadow(state.lane)
            compared, mismatches = shadow.compared, shadow.mismatches
            canary_status = shadow.health.status()
            error = shadow.error
            if shadow.aborted or not shadow.finished.is_set():
                states.append("rolled_back")
                return SwapReport(
                    tenant=tenant,
                    status="rolled_back" if shadow.aborted else "timeout",
                    shadow_samples=compared, mismatches=mismatches,
                    swap_latency_s=time.perf_counter() - t0,
                    states=tuple(states), canary=canary_status,
                    error=(error or "shadow canary evicted")
                    if shadow.aborted else
                    f"only {compared}/{shadow_samples} rows mirrored "
                    f"within {timeout_s:.1f}s")
        states.append("cutover")
        t_cut = time.perf_counter()
        incumbent = state.spec.bundle
        state.spec.bundle = candidate
        try:
            group.restack()             # atomic: one reference swap
        except Exception:
            state.spec.bundle = incumbent
            raise
        cutover_s = time.perf_counter() - t_cut
        states.append("committed")
        return SwapReport(
            tenant=tenant, status="committed",
            shadow_samples=compared, mismatches=mismatches,
            swap_latency_s=time.perf_counter() - t0,
            cutover_latency_s=cutover_s, states=tuple(states),
            canary=canary_status)


__all__ = [
    "MultiTenantEngine",
    "SwapReport",
    "Tenant",
    "TenantOverloaded",
    "make_tenant_forward_fn",
]
