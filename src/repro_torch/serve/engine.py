"""Batched LUT serving engine: request queue, dynamic bucketed batcher
and replica routing (port of ``repro.serve.engine``).

  * Clients ``submit()`` requests of any size; a dispatcher thread
    coalesces whatever is queued into one batch (up to the largest
    bucket), bounded by a ``max_wait_ms`` admission window so a lone
    request is never stuck behind an empty queue.
  * Batches are padded up to a fixed bucket size (default 1/8/64/256);
    oversized requests are served in max-bucket chunks.  ``warmup()``
    runs every bucket on every replica, so the kernel library is built
    and loaded before the first client request.
  * Coalesced batches are routed to one of ``replicas`` executors, each
    a worker thread with its own copy of the operands on its device and
    its own CUDA stream, on which its forwards launch.  Replicas cycle
    over the device pool (``devices``, by default every CUDA device), as
    the reference cycles over ``jax.local_devices()``: on one card two
    replicas share it.  Routing (:func:`route_least_loaded`) is
    queue-depth-aware sticky round-robin over the replicas the
    :class:`repro_torch.runtime.fault.ReplicaHealthTracker` reports
    healthy.  A replica whose dispatches keep failing is evicted; a
    failed batch is redispatched to another healthy replica up to
    ``max_dispatch_retries`` times, then its futures resolve with
    :class:`DispatchFailed`.  A request past its ``submit(timeout_s=)``
    deadline resolves with :class:`DeadlineExceeded`; with no healthy
    replica left (after the ``revive_probe`` round) a batch is shed with
    :class:`NoHealthyReplicas`.  ``chaos`` injects failures at the
    ``serve.replica`` site.
  * The forward is ``make_forward_fn``: input codes, the cascade plan,
    class values and argmax.  The plan's route is ``fused`` (default:
    the LUT-cascade kernel K1 over the bit-packed tables, one launch a
    forward for a chain or a LUT graph) or, with ``fused=False``,
    ``layer`` (the per-layer lookup kernel K3, chains only).  On the
    CPU both run their plain versions.

**No fallback.**  The reference wraps every fused kernel route in a
one-shot degradation to its jnp twin (``make_degradable_forward_fn``,
used by ``_replica_forward``): a failing kernel is replaced, silently,
by the reference path.  The port has no such wrapper: a failing forward
fails its batch like any replica failure (health report, redispatch to
another replica, then ``DispatchFailed`` chaining the error), so a
broken K1 on the card can never hide behind its plain version.

``sharded=True`` serves every batch through one executor whose forward
lays the cascade out over ``devices`` (or the device pool), replicated
or o_sharded (``serve/sharded.py``): the counterpart of the
reference's ``shard_map``'d cascade over its replica mesh.
"""
from __future__ import annotations

import contextlib
import queue
import threading
import time
from concurrent.futures import Future
from typing import Callable, List, Optional, Sequence, Tuple

import numpy as np
import torch

from repro_torch.core import lut_infer as LI
from repro_torch.core.exec_plan import (CascadeExec, LayerOperands,
                                        plan_cascade_exec)
from repro_torch.core.model import node_static_conns
from repro_torch.device import DeviceLike, resolve_device
from repro_torch.kernels.lut_cascade import CascadeOperands
from repro_torch.runtime.chaos import ChaosHarness
from repro_torch.runtime.fault import ReplicaHealthTracker
from repro_torch.serve.metrics import ServeMetrics
from repro_torch.serve.registry import ServeBundle

DEFAULT_BUCKETS: Tuple[int, ...] = (1, 8, 64, 256)


class DispatchFailed(RuntimeError):
    """A batch failed on a replica and exhausted its redispatch budget;
    every waiting future resolves with this (the original replica error
    is chained as ``__cause__``)."""

    def __init__(self, attempts: int, cause: BaseException):
        self.attempts = attempts
        self.cause = cause
        super().__init__(
            f"replica dispatch failed after {attempts} attempt(s): "
            f"{cause!r}")
        self.__cause__ = cause


class DeadlineExceeded(RuntimeError):
    """A request's ``submit(timeout_s=)`` deadline passed before it was
    served; counted in ``ServeMetrics.deadline_exceeded``."""


class NoHealthyReplicas(RuntimeError):
    """Every replica is evicted and the revive probe (if any) could not
    bring one back; the batch is shed, not queued behind a pool that can
    never serve it."""


def pick_bucket(n: int, buckets: Sequence[int]) -> int:
    """Smallest bucket >= n; callers chunk anything larger than the max."""
    if n <= 0:
        raise ValueError(f"batch size {n} must be positive")
    for b in buckets:
        if n <= b:
            return b
    return buckets[-1]


def make_forward_fn(bundle: ServeBundle, *, fused: bool = True,
                    device: DeviceLike = None,
                    plan: Optional[CascadeExec] = None
                    ) -> Callable[[np.ndarray], torch.Tensor]:
    """(B, in_features) float32 -> (B,) int32 class predictions on
    ``device`` (``None`` = CUDA).  ``plan`` names the route (default
    ``plan_cascade_exec(cfg, fused=fused)``).  The route's operands and
    the quantizer scales are uploaded once, here, so each replica holds
    its own copy: the fused route takes the bit-packed tables only (the
    unpacked int32 tables are ~8x larger), the per-layer route the
    unpacked tables as int32."""
    dev = resolve_device(device)
    cfg = bundle.cfg
    if plan is None:
        plan = plan_cascade_exec(cfg, fused=fused)
    params = bundle.serve_params(dev)
    conns = [torch.as_tensor(np.asarray(c, np.int32), device=dev)
             for s in bundle.statics for c in node_static_conns(s)]
    if plan.fused:
        bundle.prepack()
        ops = CascadeOperands(
            conns, [torch.as_tensor(p, device=dev)
                    for p in bundle.packed_tables],
            plan.schedule, cfg.in_features)
    else:
        # One branch per layer here: a graph table is its one-item list.
        ops = LayerOperands(conns, [
            torch.as_tensor(np.asarray(t[0] if isinstance(t, list) else t)
                            .astype(np.int32), device=dev)
            for t in bundle.tables], plan.schedule, cfg.in_features)
    if dev.type == "cuda":
        # Executors launch on their own streams: the operands built on
        # this thread's stream must be complete before any reads them.
        torch.cuda.current_stream(dev).synchronize()

    def forward(x: np.ndarray) -> torch.Tensor:
        xt = torch.as_tensor(np.asarray(x, np.float32)).to(dev)
        codes = LI.input_codes(cfg, params, xt)
        out = plan.apply(codes, ops)
        vals = LI.class_values(cfg, params, out)
        return torch.argmax(vals, dim=-1).to(torch.int32)

    return forward


class _Request:
    __slots__ = ("x", "n", "future", "t_submit", "deadline")

    def __init__(self, x: np.ndarray, timeout_s: Optional[float] = None):
        self.x = x
        self.n = x.shape[0]
        self.future: "Future[np.ndarray]" = Future()
        self.t_submit = time.perf_counter()
        self.deadline = (None if timeout_s is None
                         else self.t_submit + timeout_s)


_STOP = object()


def route_least_loaded(executors: Sequence["_ReplicaExecutor"],
                       health: ReplicaHealthTracker,
                       rr: int, *,
                       exclude: Optional[int] = None
                       ) -> Optional["_ReplicaExecutor"]:
    """Queue-depth-aware sticky round-robin over healthy replicas: the
    least-loaded healthy executor wins, with depth ties broken in
    round-robin order from the last-used replica inclusive — so light
    load sticks to one warm replica and spills to the next exactly when
    the current one has queued work.  Returns None when no replica is
    healthy.  ``exclude`` (a replica id) is a preference, not a bar:
    the redispatch path avoids the replica that just failed when any
    other healthy replica exists.  Shared by the single-bundle engine
    and the multi-tenant geometry-group pools (serve/tenants.py)."""
    healthy = [ex for ex in executors if health.is_healthy(ex.rid)]
    if not healthy:
        return None
    if exclude is not None:
        others = [ex for ex in healthy if ex.rid != exclude]
        healthy = others or healthy
    n = len(executors)
    return min(healthy, key=lambda ex: (ex.depth(), (ex.rid - rr) % n))


def _drop_expired(batch: List["_Request"],
                  engine_metrics: ServeMetrics) -> List["_Request"]:
    """Resolve every past-deadline request with ``DeadlineExceeded``
    (counted in the engine metrics, and the tenant's where the request
    carries one) and return the live remainder.  Called at every
    hand-off — dispatcher routing and executor serve — so an expired
    request never pays for a forward it can no longer use."""
    now = time.perf_counter()
    live: List[_Request] = []
    for r in batch:
        if r.deadline is not None and now > r.deadline:
            waited = now - r.t_submit
            if _complete(r.future, exc=DeadlineExceeded(
                    f"request expired after {waited * 1e3:.1f}ms in "
                    f"queue (timeout "
                    f"{(r.deadline - r.t_submit) * 1e3:.1f}ms)")):
                engine_metrics.record_deadline_exceeded()
                tenant = getattr(r, "tenant", None)
                if tenant is not None:
                    tenant.metrics.record_deadline_exceeded()
        else:
            live.append(r)
    return live


def _complete(future: Future, result=None, exc=None) -> bool:
    """Resolve a future, tolerating a client-side cancel(): a cancelled
    future makes set_result/set_exception raise, which must never kill
    a serving thread."""
    try:
        if exc is not None:
            future.set_exception(exc)
        else:
            future.set_result(result)
        return True
    except Exception:
        return False


class _ReplicaExecutor:
    """One serving replica: a worker thread draining its own batch queue
    through a forward whose operands live on its device, launching on
    its own CUDA stream.

    The dispatcher routes coalesced batches here; the executor serves
    them FIFO, records into its per-replica metrics and the engine
    aggregate, and reports every dispatch outcome to the health
    tracker (a request that carries a ``tenant`` also records into its
    tenant's metrics).  On shutdown it drains the batches queued before
    the stop sentinel — an accepted batch is never dropped.
    ``forwards`` counts the bucket-padded forward calls it made (one K1
    launch each on the fused route)."""

    def __init__(self, rid: int, forward: Callable, *,
                 buckets: Sequence[int], device: torch.device,
                 engine_metrics: ServeMetrics,
                 health: ReplicaHealthTracker,
                 redispatch: Optional[Callable] = None,
                 chaos: Optional[ChaosHarness] = None):
        self.rid = rid
        self.device = device
        self.metrics = ServeMetrics()
        self.forwards = 0
        self._forward = forward
        self._buckets = tuple(buckets)
        self._engine_metrics = engine_metrics
        self._health = health
        # redispatch(batch, total, attempts, failed_rid) -> bool: the
        # engine's self-healing hook, False once the budget is spent.
        self._redispatch = redispatch
        self._chaos = chaos
        self._stream = (torch.cuda.Stream(device) if device.type == "cuda"
                        else None)
        self._queue: "queue.Queue" = queue.Queue()
        self._thread: Optional[threading.Thread] = None

    # -- lifecycle --------------------------------------------------------

    def start(self) -> None:
        if self._thread is None:
            self._thread = threading.Thread(
                target=self._loop, daemon=True,
                name=f"lut-serve-replica-{self.rid}")
            self._thread.start()

    def stop(self) -> None:
        """Request shutdown and join; queued batches are served first.
        A batch redispatched here after the stop sentinel (a failure
        elsewhere racing shutdown) has no worker left — resolve its
        futures with DispatchFailed rather than stranding them."""
        if self._thread is not None:
            self._queue.put(_STOP)
            self._thread.join()
            self._thread = None
        while True:
            try:
                item = self._queue.get_nowait()
            except queue.Empty:
                break
            if item is _STOP:
                continue
            batch, _, _, attempts = item
            err = DispatchFailed(attempts + 1, RuntimeError(
                "replica stopped during redispatch"))
            for r in batch:
                _complete(r.future, exc=err)

    def _on_stream(self):
        """This replica's stream as the current one (its launches go
        there), or nothing on the CPU."""
        return (torch.cuda.stream(self._stream) if self._stream is not None
                else contextlib.nullcontext())

    def warmup(self, in_features: int) -> None:
        with self._on_stream():
            for b in self._buckets:
                self._forward(np.zeros((b, in_features), np.float32)).cpu()

    # -- dispatcher-facing ------------------------------------------------

    def depth(self) -> int:
        """Batches in flight on this replica — queued and being served
        (``unfinished_tasks`` pairs every put() with the task_done()
        below): a replica mid-dispatch must not look idle."""
        return self._queue.unfinished_tasks

    def dispatch(self, batch: List[_Request], total: int,
                 queue_depth: int, attempts: int = 0) -> None:
        self._queue.put((batch, total, queue_depth, attempts))

    # -- worker -----------------------------------------------------------

    def _loop(self) -> None:
        while True:
            item = self._queue.get()
            if item is _STOP:
                self._queue.task_done()
                break
            batch, total, depth, attempts = item
            try:
                self._serve(batch, total, depth, attempts)
            finally:
                self._queue.task_done()

    def _fail_or_redispatch(self, batch: List[_Request], total: int,
                            attempts: int, exc: BaseException) -> None:
        """Report health first (so the redispatch route sees the failure
        it routes around), then hand the batch to the engine's
        redispatch hook; once the budget is spent the waiters see a
        typed DispatchFailed chaining the root cause."""
        self._health.record_failure(self.rid, exc)
        if (self._redispatch is not None
                and self._redispatch(batch, total, attempts + 1, self.rid)):
            return
        err = DispatchFailed(attempts + 1, exc)
        for r in batch:
            _complete(r.future, exc=err)

    def _serve(self, batch: List[_Request], total: int, depth: int,
               attempts: int = 0) -> None:
        batch = _drop_expired(batch, self._engine_metrics)
        if not batch:
            return
        total = sum(r.n for r in batch)
        x = (batch[0].x if len(batch) == 1
             else np.concatenate([r.x for r in batch], axis=0))
        extra = self._dispatch_args(batch)
        try:
            if self._chaos is not None:
                self._chaos.check("serve.replica")
            preds, padded = self._run(x, extra)
        except Exception as e:
            self._fail_or_redispatch(batch, total, attempts, e)
            return
        self._health.record_success(self.rid)
        t_done = time.perf_counter()
        off = 0
        for r in batch:
            delivered = _complete(r.future, preds[off:off + r.n])
            off += r.n
            if delivered:
                lat = t_done - r.t_submit
                tenant = getattr(r, "tenant", None)
                if tenant is not None:
                    tenant.metrics.record_request(lat, r.n)
                self.metrics.record_request(lat, r.n)
                self._engine_metrics.record_request(lat, r.n)
        self.metrics.record_batch(total, padded, depth)
        self._engine_metrics.record_batch(total, padded, depth)
        self._after_serve(x, preds, extra)

    # Hooks for executors whose forward takes more than the rows
    # (serve/tenants.py): what a dispatch passes besides x, one bucket's
    # forward call, and what runs after every future resolved.

    def _dispatch_args(self, batch: List[_Request]) -> tuple:
        return ()

    def _call(self, chunk: np.ndarray, rows: slice, bucket: int,
              extra: tuple) -> torch.Tensor:
        return self._forward(chunk)

    def _after_serve(self, x: np.ndarray, preds: np.ndarray,
                     extra: tuple) -> None:
        pass

    def _chunks(self, n: int):
        """(start, rows, bucket) of each bucket-padded forward of n rows."""
        max_bucket = self._buckets[-1]
        for s in range(0, n, max_bucket):
            m = min(max_bucket, n - s)
            yield s, m, pick_bucket(m, self._buckets)

    def _run(self, x: np.ndarray, extra: tuple = ()
             ) -> Tuple[np.ndarray, int]:
        """Serve (n, F) through bucket-padded forwards; returns the (n,)
        predictions and the number of dispatched (padded) slots."""
        outs: List[np.ndarray] = []
        padded = 0
        with self._on_stream():
            for s, m, b in self._chunks(x.shape[0]):
                chunk = x[s:s + m]
                if m < b:
                    chunk = np.concatenate(
                        [chunk, np.zeros((b - m, x.shape[1]), x.dtype)])
                out = self._call(chunk, slice(s, s + m), b, extra)
                outs.append(out.cpu().numpy()[:m])
                self.forwards += 1
                padded += b
        return np.concatenate(outs, axis=0), padded


def _device_pool(device: DeviceLike, devices: Optional[Sequence]
                 ) -> List[torch.device]:
    """The devices replicas cycle over: ``devices``, else ``[device]``,
    else every CUDA device (``device=None`` means CUDA, and raises
    without it).  A CUDA device without an index gets the current one,
    so that equal devices compare equal."""
    if devices is not None:
        pool = [resolve_device(d) for d in devices]
        if not pool:
            raise ValueError("devices= must name at least one device")
    elif device is None:
        resolve_device(None)
        return [torch.device("cuda", i)
                for i in range(torch.cuda.device_count())]
    else:
        pool = [resolve_device(device)]
    return [torch.device("cuda", torch.cuda.current_device())
            if d.type == "cuda" and d.index is None else d for d in pool]


class LUTServeEngine:
    """Serve a ServeBundle behind a dynamic batcher with replica routing
    (see module docstring).  ``device`` (``None`` = every CUDA device)
    or ``devices`` names the pool the ``replicas`` cycle over; with
    ``sharded=True`` (one replica) the shards of ``shard_mode``'s layout,
    one per entry of that pool (``["cpu"] * 4``: four logical shards)."""

    def __init__(self, bundle: ServeBundle, *,
                 buckets: Sequence[int] = DEFAULT_BUCKETS,
                 max_wait_ms: float = 2.0,
                 fused: bool = True,
                 device: DeviceLike = None,
                 metrics: Optional[ServeMetrics] = None,
                 replicas: int = 1,
                 devices: Optional[Sequence] = None,
                 health: Optional[ReplicaHealthTracker] = None,
                 sharded: bool = False,
                 shard_mode: str = "auto",
                 plan: Optional[CascadeExec] = None,
                 max_dispatch_retries: int = 2,
                 revive_probe: Optional[Callable[[int], bool]] = None,
                 chaos: Optional[ChaosHarness] = None):
        buckets = tuple(int(b) for b in buckets)
        if not buckets or list(buckets) != sorted(set(buckets)) \
                or buckets[0] < 1:
            raise ValueError(f"buckets must be strictly increasing "
                             f"positive sizes: {buckets}")
        if sharded and replicas != 1:
            raise ValueError(
                "sharded=True serves through ONE executor whose forward "
                "spans the shard devices; combine it with replicas=1 (use "
                "plain replicas=N for independent-executor routing)")
        if sharded and plan is not None:
            raise ValueError("sharded=True plans its own sharded dispatch; "
                             "plan= applies to replica engines")
        if replicas < 1:
            raise ValueError(f"replicas={replicas} must be >= 1")
        if max_dispatch_retries < 0:
            raise ValueError(f"max_dispatch_retries={max_dispatch_retries} "
                             f"must be >= 0")
        self.bundle = bundle
        self.buckets = buckets
        self.max_wait_s = max_wait_ms / 1e3
        self.plan = plan or plan_cascade_exec(bundle.cfg, fused=fused)
        self.fused = self.plan.fused
        self.sharded = sharded
        self.max_dispatch_retries = max_dispatch_retries
        self.revive_probe = revive_probe
        self.chaos = chaos
        self.metrics = metrics or ServeMetrics()
        self.health = health or ReplicaHealthTracker(replicas)
        if self.health.num_replicas != replicas:
            raise ValueError(
                f"health tracker covers {self.health.num_replicas} "
                f"replicas, engine has {replicas}")
        pool = _device_pool(device, devices)
        if sharded:
            from repro_torch.serve.sharded import make_sharded_forward_fn
            devs = pool[:1]
            forwards = [make_sharded_forward_fn(bundle, devices=pool,
                                                mode=shard_mode)]
        else:
            devs = [pool[i % len(pool)] for i in range(replicas)]
            forwards = [make_forward_fn(bundle, plan=self.plan, device=d)
                        for d in devs]
        self.device = devs[0]
        self._executors = [
            _ReplicaExecutor(i, f, buckets=self.buckets, device=d,
                             engine_metrics=self.metrics,
                             health=self.health,
                             redispatch=self._redispatch, chaos=chaos)
            for i, (f, d) in enumerate(zip(forwards, devs))]
        self._rr = 0  # round-robin cursor for routing tie-breaks
        self._queue: "queue.Queue" = queue.Queue()
        self._thread: Optional[threading.Thread] = None
        self._closed = False
        # Serializes the closed-check + enqueue in submit() against
        # close(), so a request never lands behind the stop sentinel.
        self._submit_lock = threading.Lock()

    @property
    def replicas(self) -> int:
        return len(self._executors)

    @property
    def replica_metrics(self) -> List[ServeMetrics]:
        return [ex.metrics for ex in self._executors]

    @property
    def forwards(self) -> int:
        """Bucket-padded forwards that served batches, over all replicas
        (``warmup`` not counted)."""
        return sum(ex.forwards for ex in self._executors)

    # -- lifecycle --------------------------------------------------------

    def start(self) -> "LUTServeEngine":
        if self._thread is None:
            for ex in self._executors:
                ex.start()
            self._thread = threading.Thread(target=self._dispatch_loop,
                                            daemon=True,
                                            name="lut-serve-dispatch")
            self._thread.start()
        return self

    def warmup(self) -> None:
        """Run every bucket shape once on every replica, so no client
        request pays for building or loading the kernels."""
        f = self.bundle.cfg.in_features
        for ex in self._executors:
            ex.warmup(f)

    def close(self) -> None:
        """Serve what was submitted before, then stop every thread."""
        with self._submit_lock:
            if self._closed:
                return
            self._closed = True
            self._queue.put(_STOP)
        if self._thread is not None:
            self._thread.join()
            self._thread = None
        # Executors drain already-routed batches, then exit.
        for ex in self._executors:
            ex.stop()
        # Never started: nothing routed what was queued — fail it.
        while True:
            try:
                r = self._queue.get_nowait()
            except queue.Empty:
                break
            if r is not _STOP:
                _complete(r.future, exc=RuntimeError("engine closed"))

    def __enter__(self) -> "LUTServeEngine":
        self.start()
        return self

    def __exit__(self, *exc) -> None:
        self.close()

    # -- client API -------------------------------------------------------

    def submit(self, x: np.ndarray, *,
               timeout_s: Optional[float] = None) -> "Future[np.ndarray]":
        """Enqueue a request of shape (n, in_features) or (in_features,).
        The future resolves to the (n,) int32 class predictions.
        ``timeout_s`` sets a per-request deadline: a request still
        unserved when it passes resolves with :class:`DeadlineExceeded`
        (counted in ``metrics``)."""
        x = np.asarray(x, np.float32)
        if x.ndim == 1:
            x = x[None, :]
        if x.ndim != 2 or x.shape[1] != self.bundle.cfg.in_features \
                or x.shape[0] == 0:
            raise ValueError(
                f"request shape {x.shape} != (n >= 1, "
                f"{self.bundle.cfg.in_features})")
        if timeout_s is not None and timeout_s <= 0:
            raise ValueError(f"timeout_s={timeout_s} must be positive")
        req = _Request(x, timeout_s)
        with self._submit_lock:
            if self._closed:
                raise RuntimeError("engine is closed")
            if self._thread is None:
                self.start()
            self._queue.put(req)
        return req.future

    def predict(self, x: np.ndarray, *,
                timeout_s: Optional[float] = None) -> np.ndarray:
        """Synchronous convenience wrapper over submit()."""
        return self.submit(x, timeout_s=timeout_s).result()

    # -- dispatcher -------------------------------------------------------

    def _dispatch_loop(self) -> None:
        max_bucket = self.buckets[-1]
        stop = False
        while not stop:
            first = self._queue.get()
            if first is _STOP:
                break
            batch: List[_Request] = [first]
            total = first.n
            deadline = time.perf_counter() + self.max_wait_s
            # Coalesce until the largest bucket is full or the admission
            # window closes, whichever is first.
            while total < max_bucket:
                wait = deadline - time.perf_counter()
                if wait <= 0:
                    break
                try:
                    nxt = self._queue.get(timeout=wait)
                except queue.Empty:
                    break
                if nxt is _STOP:
                    stop = True
                    break
                batch.append(nxt)
                total += nxt.n
            self._route(batch, total)

    def _route(self, batch: List[_Request], total: int) -> None:
        """Route one coalesced batch via :func:`route_least_loaded`; with
        no healthy replica left (after one revive-probe round), shed it
        with a typed :class:`NoHealthyReplicas`."""
        batch = _drop_expired(batch, self.metrics)
        if not batch:
            return
        total = sum(r.n for r in batch)
        depth = self._queue.qsize()
        chosen = route_least_loaded(self._executors, self.health, self._rr)
        if chosen is None:
            self._probe_evicted()
            chosen = route_least_loaded(self._executors, self.health,
                                        self._rr)
        if chosen is None:
            err = NoHealthyReplicas(
                f"no healthy replicas (of {len(self._executors)}) — "
                f"failure counts {self.health.failure_counts()}")
            for r in batch:
                if _complete(r.future, exc=err):
                    self.metrics.record_shed()
            return
        self._rr = chosen.rid
        chosen.dispatch(batch, total, depth)

    def _probe_evicted(self) -> None:
        """Ask ``revive_probe(rid)`` about every evicted replica and
        re-admit the ones it vouches for.  A raising probe counts as
        'still down' — a health check must never take the dispatcher
        thread with it."""
        if self.revive_probe is None:
            return
        healthy = set(self.health.healthy_ids())
        for ex in self._executors:
            if ex.rid in healthy:
                continue
            try:
                ok = bool(self.revive_probe(ex.rid))
            except Exception:
                ok = False
            if ok:
                self.health.revive(ex.rid)

    def _redispatch(self, batch: List[_Request], total: int,
                    attempts: int, failed_rid: int) -> bool:
        """Self-healing hook handed to every executor: after a dispatch
        failure, re-route the batch to a healthy replica — preferring
        any other than the one that just failed — up to
        ``max_dispatch_retries`` retries.  Requests hold their inputs on
        the host, so replaying a batch is always safe."""
        if attempts > self.max_dispatch_retries:
            return False
        chosen = route_least_loaded(self._executors, self.health, self._rr,
                                    exclude=failed_rid)
        if chosen is None:
            self._probe_evicted()
            chosen = route_least_loaded(self._executors, self.health,
                                        self._rr, exclude=failed_rid)
        if chosen is None:
            return False
        self._rr = chosen.rid
        self.metrics.record_redispatch()
        chosen.dispatch(batch, total, self._queue.qsize(), attempts)
        return True
