"""Fault tolerance: supervised training with checkpoint/restart, and
serving-side replica health (port of ``repro.runtime.fault``).

``TrainSupervisor`` runs a step function from a deterministic batch
source, saves the carry asynchronously every ``ckpt_every`` steps and,
on any failure, restores the latest committed checkpoint and continues
from its step (up to ``max_restarts`` times).  The batch source is a
function of the step index, so the sample order survives a restart and
a resumed run equals an uninterrupted one.

Over a mesh of processes (``mesh`` and the carry's ``shardings``; the
carry holds each rank's shards) every rank gathers the carry whole at a
checkpoint and rank 0 writes it; a restore waits at a barrier for that
write and re-places the checkpoint onto the mesh.  Every rank takes the
same restart decision: a failure before the step (the injector, the
batch) is all-reduced over the ranks after it, so all restore together
and none waits in a collective of a step the others left.  A rank whose
step itself fails cannot leave its peers' collectives, so it raises
(the process exits non-zero) and does not retry.

The tracker is a copy of the reference's (it uses no JAX); the chaos
harness's ``FailureInjector`` and ``NodeFailure`` are re-exported from
``runtime.chaos`` under their historical path, as in the reference.
"""
from __future__ import annotations

import threading
import time
from dataclasses import dataclass, field
from typing import Any, Callable, Dict, List, Optional

from repro_torch.checkpoint import CheckpointStore
from .chaos import FailureInjector, NodeFailure  # noqa: F401
from .straggler import StepWatchdog


class ReplicaHealthTracker:
    """Serving-side replica health: consecutive-failure eviction.

    The serving analogue of the training supervisor above: instead of
    checkpoint/restart, a replica that keeps failing forward dispatches
    is *evicted* — the engine's router (serve/engine.py) stops sending
    it batches and the remaining replicas absorb the load.  A transient
    failure (one bad dispatch followed by a success) resets the
    counter; ``revive`` re-admits an evicted replica after operator
    intervention.  All methods are thread-safe: executor worker threads
    record, the dispatcher thread reads.
    """

    def __init__(self, num_replicas: int, *,
                 max_consecutive_failures: int = 3,
                 on_evict: Optional[Callable[[int, Optional[BaseException]],
                                             None]] = None):
        if num_replicas < 1:
            raise ValueError(f"num_replicas={num_replicas} must be >= 1")
        if max_consecutive_failures < 1:
            raise ValueError("max_consecutive_failures must be >= 1")
        self.num_replicas = num_replicas
        self.max_consecutive_failures = max_consecutive_failures
        self.on_evict = on_evict
        self._lock = threading.Lock()
        self._consecutive = [0] * num_replicas
        self._healthy = [True] * num_replicas
        self._failures = [0] * num_replicas

    def _check(self, rid: int) -> None:
        if not 0 <= rid < self.num_replicas:
            raise IndexError(f"replica {rid} out of range "
                             f"[0, {self.num_replicas})")

    def _fire_on_evict(self, rid: int,
                       exc: Optional[BaseException]) -> None:
        """A raising user hook must never propagate into the serving
        threads that report health (it would kill a replica worker)."""
        if self.on_evict is None:
            return
        try:
            self.on_evict(rid, exc)
        except Exception:
            pass

    def record_success(self, rid: int) -> None:
        self._check(rid)
        with self._lock:
            self._consecutive[rid] = 0

    def record_failure(self, rid: int,
                       exc: Optional[BaseException] = None) -> bool:
        """Record one failed dispatch; returns whether the replica is
        still healthy afterwards (evicts when the consecutive-failure
        budget is exhausted)."""
        self._check(rid)
        with self._lock:
            self._failures[rid] += 1
            self._consecutive[rid] += 1
            if (self._healthy[rid]
                    and self._consecutive[rid]
                    >= self.max_consecutive_failures):
                self._healthy[rid] = False
                evicted = True
            else:
                evicted = False
            healthy = self._healthy[rid]
        if evicted:
            self._fire_on_evict(rid, exc)
        return healthy

    def evict(self, rid: int, exc: Optional[BaseException] = None) -> None:
        """Force a replica out of rotation (health probe / operator)."""
        self._check(rid)
        with self._lock:
            was = self._healthy[rid]
            self._healthy[rid] = False
        if was:
            self._fire_on_evict(rid, exc)

    def revive(self, rid: int) -> None:
        self._check(rid)
        with self._lock:
            self._healthy[rid] = True
            self._consecutive[rid] = 0

    def is_healthy(self, rid: int) -> bool:
        self._check(rid)
        with self._lock:
            return self._healthy[rid]

    def healthy_ids(self) -> List[int]:
        with self._lock:
            return [i for i, h in enumerate(self._healthy) if h]

    def failure_counts(self) -> List[int]:
        with self._lock:
            return list(self._failures)

    def status(self) -> List[Dict[str, Any]]:
        """One *consistent* per-replica snapshot (a single lock
        acquisition — stitching healthy_ids/failure_counts together
        races against concurrent recording).  Consumed by the
        multi-tenant swap/canary reports (serve/tenants.py) and the
        serving launcher's health printout."""
        with self._lock:
            return [{"replica": i,
                     "healthy": self._healthy[i],
                     "failures": self._failures[i],
                     "consecutive": self._consecutive[i]}
                    for i in range(self.num_replicas)]


def _carry_device(carry):
    """The device of the carry's first tensor (None: numpy leaves)."""
    stack = [carry]
    while stack:
        t = stack.pop(0)
        if isinstance(t, dict):
            stack[:0] = [t[k] for k in sorted(t)]
        elif isinstance(t, (list, tuple)):
            stack[:0] = list(t)
        elif hasattr(t, "device"):
            return t.device
    return None


@dataclass
class TrainSupervisor:
    """Checkpoint/restart + straggler-aware training loop.

    ``make_step()`` -> ``step_fn(carry, batch) -> (carry, metrics)``;
    the carry is the (params, opt_state, ...) tree the checkpoint
    covers, and ``step_fn`` must not write into the carry it is given
    (a save of it may still be in flight).  A restored carry comes back
    on the device of the carry it replaces.  ``mesh`` (a
    ``sharding.spmd.ProcessMesh`` of more than one rank) and
    ``shardings`` (the carry's ``NamedSharding`` tree) run it over ranks
    (module docstring).
    """

    store: CheckpointStore
    make_step: Callable[..., Callable]
    make_batch: Callable[[int], Any]
    ckpt_every: int = 50
    max_restarts: int = 8
    watchdog: StepWatchdog = field(default_factory=StepWatchdog)
    mesh: Any = None
    shardings: Any = None

    def run(self, carry, *, start_step: int = 0, num_steps: int = 100,
            injector: Optional[FailureInjector] = None,
            on_restart: Optional[Callable[[int], None]] = None
            ) -> Dict[str, Any]:
        if self.mesh is not None and self.mesh.world > 1:
            return self._run_ranks(carry, start_step, num_steps, injector,
                                   on_restart)
        step_fn = self.make_step()
        step = start_step
        restarts = 0
        metrics = None
        pending = None
        while step < num_steps:
            try:
                t0 = time.time()
                if injector is not None:
                    injector.check(step)
                batch = self.make_batch(step)
                carry, metrics = step_fn(carry, batch)
                self.watchdog.record(time.time() - t0)
                step += 1
                if step % self.ckpt_every == 0 or step == num_steps:
                    pending = self.store.save_async(
                        step, carry, meta={"step": step})
            except Exception:  # noqa: BLE001 — any failure: restart
                restarts += 1
                if restarts > self.max_restarts:
                    raise
                if pending is not None:
                    pending.result()  # drain the in-flight checkpoint
                last = self.store.latest_step()
                if last is not None:
                    last, carry = self.store.restore(
                        carry, device=_carry_device(carry))
                    step = last
                else:
                    step = start_step
                if on_restart is not None:
                    on_restart(step)
                step_fn = self.make_step()
        if pending is not None:
            pending.result()
        return {"carry": carry, "step": step, "restarts": restarts,
                "metrics": metrics}

    def _run_ranks(self, carry, start_step, num_steps, injector,
                   on_restart) -> Dict[str, Any]:
        from repro_torch.sharding.spmd import gather_tree
        mesh = self.mesh
        step_fn = self.make_step()
        step = start_step
        restarts = 0
        metrics = None
        pending = None

        def drain():
            if pending is not None:
                pending.result()
            mesh.barrier()  # the write is committed for every rank

        while step < num_steps:
            t0 = time.time()
            error = None
            try:
                if injector is not None:
                    injector.check(step)
                batch = self.make_batch(step)
            except Exception as e:  # noqa: BLE001 — any failure: restart
                error = e
            if mesh.any(error is not None):
                restarts += 1
                if restarts > self.max_restarts:
                    raise error or RuntimeError(
                        f"step {step} failed on another rank "
                        f"{restarts - 1} times")
                drain()
                last = self.store.latest_step()
                if last is not None:
                    last, carry = self.store.restore(
                        carry, shardings=self.shardings)
                    step = last
                else:
                    step = start_step
                if on_restart is not None:
                    on_restart(step)
                step_fn = self.make_step()
                continue
            carry, metrics = step_fn(carry, batch)  # raises: exit
            self.watchdog.record(time.time() - t0)
            step += 1
            if step % self.ckpt_every == 0 or step == num_steps:
                whole = gather_tree(carry, self.shardings)
                if mesh.rank == 0:
                    if pending is not None:
                        pending.result()
                    pending = self.store.save_async(
                        step, whole, meta={"step": step})
                del whole
        drain()
        return {"carry": carry, "step": step, "restarts": restarts,
                "metrics": metrics}


__all__ = ["FailureInjector", "NodeFailure", "ReplicaHealthTracker",
           "TrainSupervisor"]
