"""Serving-side fault tolerance (port of ``repro.runtime.fault``:
``ReplicaHealthTracker`` only; ``TrainSupervisor`` waits for the
training supervisor's slice, ROADMAP.md Queue A).

The tracker is a copy of the reference's (it uses no JAX); the chaos
harness's ``FailureInjector`` and ``NodeFailure`` are re-exported from
``runtime.chaos`` under their historical path, as in the reference.
"""
from __future__ import annotations

import threading
from typing import Any, Callable, Dict, List, Optional

from .chaos import FailureInjector, NodeFailure  # noqa: F401


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


__all__ = ["FailureInjector", "NodeFailure", "ReplicaHealthTracker"]
