"""Serving metrics: request latency percentiles, throughput, queue depth,
batch occupancy.

A verbatim copy of ``repro.serve.metrics``; the port keeps its own copy
of every jax-free module it needs and imports nothing of the JAX
package.

The tracker is deliberately dependency-free and lock-guarded so the engine's
dispatcher thread can record while a client thread reads a report.  Latency
percentiles use the nearest-rank method (exact on the recorded sample set,
no interpolation) — the same convention the EXPERIMENTS.md §Perf serving
tables use, and trivially unit-testable (tests/test_serve_engine.py).
"""
from __future__ import annotations

import json
import math
import threading
import time
from typing import Dict, List, Optional, Sequence


def percentile(sorted_values: Sequence[float], p: float) -> float:
    """Nearest-rank percentile of an ascending-sorted sequence.

    p in (0, 100]; rank = ceil(p/100 * n), so percentile(v, 100) is the max
    and small samples resolve to real observations (no interpolation).
    """
    n = len(sorted_values)
    if n == 0:
        raise ValueError("percentile of empty sequence")
    if not 0 < p <= 100:
        raise ValueError(f"p={p} out of (0, 100]")
    rank = max(1, math.ceil(p * n / 100 - 1e-9))
    return float(sorted_values[min(rank, n) - 1])


class ServeMetrics:
    """Accumulates per-request and per-batch serving statistics."""

    def __init__(self) -> None:
        self._lock = threading.Lock()
        self._lat_s: List[float] = []       # per-request end-to-end latency
        self._samples = 0                   # total samples served
        self._batches = 0
        self._real = 0                      # real samples across batches
        self._padded = 0                    # padded (dispatched) batch slots
        self._queue_depths: List[int] = []
        self._admitted = 0                  # requests accepted at the door
        self._shed = 0                      # requests refused (load shedding)
        self._deadline_exceeded = 0         # futures resolved past deadline
        self._redispatches = 0              # batches re-routed after failure
        self._downgrades = 0                # kernel -> jnp fallback flips
        self._t_first: Optional[float] = None
        self._t_last: Optional[float] = None

    # -- recording (dispatcher thread) ------------------------------------

    def record_request(self, latency_s: float, n_samples: int = 1) -> None:
        now = time.perf_counter()
        with self._lock:
            self._lat_s.append(latency_s)
            self._samples += n_samples
            if self._t_first is None:
                self._t_first = now - latency_s
            self._t_last = now

    def record_batch(self, n_real: int, n_padded: int,
                     queue_depth: int) -> None:
        with self._lock:
            self._batches += 1
            self._real += n_real
            self._padded += n_padded
            self._queue_depths.append(queue_depth)

    # -- admission control (multi-tenant front door, serve/tenants.py) ----

    def record_admitted(self, n_requests: int = 1) -> None:
        with self._lock:
            self._admitted += n_requests

    def record_shed(self, n_requests: int = 1) -> None:
        """One request refused at the admission door (queue bound or rate
        limit).  ``shed_rate`` = shed / (admitted + shed) — the fraction
        of offered load the door turned away."""
        with self._lock:
            self._shed += n_requests

    # -- resilience (self-healing serving, serve/engine.py) ----------------

    def record_deadline_exceeded(self, n_requests: int = 1) -> None:
        """A request whose ``submit(timeout_s=)`` deadline passed before
        it was served; its future resolved with ``DeadlineExceeded``."""
        with self._lock:
            self._deadline_exceeded += n_requests

    def record_redispatch(self) -> None:
        """One coalesced batch re-routed to another replica after a
        dispatch failure (the self-healing path)."""
        with self._lock:
            self._redispatches += 1

    def record_downgrade(self) -> None:
        """One replica forward permanently downgraded from the fused
        kernel route to the jnp reference path."""
        with self._lock:
            self._downgrades += 1

    @property
    def deadline_exceeded(self) -> int:
        with self._lock:
            return self._deadline_exceeded

    @property
    def redispatches(self) -> int:
        with self._lock:
            return self._redispatches

    @property
    def downgrades(self) -> int:
        with self._lock:
            return self._downgrades

    @property
    def shed(self) -> int:
        with self._lock:
            return self._shed

    @property
    def shed_rate(self) -> float:
        with self._lock:
            offered = self._admitted + self._shed
            return self._shed / offered if offered else 0.0

    # -- reading ----------------------------------------------------------

    def latency_ms(self, p: float) -> float:
        with self._lock:
            lat = sorted(self._lat_s)
        return percentile(lat, p) * 1e3 if lat else float("nan")

    def report(self) -> Dict[str, float]:
        with self._lock:
            lat = sorted(self._lat_s)
            samples, batches = self._samples, self._batches
            real, padded = self._real, self._padded
            depths = list(self._queue_depths)
            admitted, shed = self._admitted, self._shed
            deadline = self._deadline_exceeded
            redispatches, downgrades = self._redispatches, self._downgrades
            elapsed = ((self._t_last - self._t_first)
                       if self._t_first is not None and self._t_last is not None
                       and self._t_last > self._t_first else 0.0)
        offered = admitted + shed
        rep: Dict[str, float] = {
            "requests": float(len(lat)),
            "samples": float(samples),
            "batches": float(batches),
            "elapsed_s": elapsed,
            "throughput_sps": samples / elapsed if elapsed > 0 else float("nan"),
            "batch_occupancy": real / padded if padded else float("nan"),
            "mean_queue_depth": (sum(depths) / len(depths)) if depths
            else float("nan"),
            "admitted": float(admitted),
            "shed": float(shed),
            "shed_rate": shed / offered if offered else 0.0,
            "deadline_exceeded": float(deadline),
            "redispatches": float(redispatches),
            "kernel_downgrades": float(downgrades),
        }
        for p in (50, 95, 99):
            rep[f"p{p}_ms"] = percentile(lat, p) * 1e3 if lat else float("nan")
        return rep

    def render(self) -> str:
        r = self.report()
        return (f"requests={int(r['requests'])} samples={int(r['samples'])} "
                f"batches={int(r['batches'])} "
                f"p50={r['p50_ms']:.2f}ms p95={r['p95_ms']:.2f}ms "
                f"p99={r['p99_ms']:.2f}ms "
                f"throughput={r['throughput_sps']:.0f} samples/s "
                f"occupancy={r['batch_occupancy']:.2f} "
                f"queue_depth={r['mean_queue_depth']:.1f}")

    def to_json(self) -> str:
        return json.dumps(self.report(), sort_keys=True)
