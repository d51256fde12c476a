"""Deterministic chaos harness: seeded, schedule-driven fault injection.

A copy of ``repro.runtime.chaos`` (it uses no JAX; the code is the
reference's, this docstring names the port's sites); the port keeps its
own copy of every jax-free module it needs and imports nothing of the
JAX package.  For the same (seed, site, schedule, rates) its decision
streams equal the reference's.

Fault-tolerance paths are exercised by injecting failures at named
*sites*.  A site is a string naming one failure surface; the ones the
port checks are:

    ``sweep.group``     group training in ``run_pareto_sweep``
    ``serve.replica``   replica forward in ``_ReplicaExecutor._serve``
    ``registry.load``   bundle read in ``TableRegistry.load``

(the reference also checks ``train.step``, whose supervisor is not
ported yet, and ``serve.kernel`` in its degradable forward, which the
port does not have: a failing kernel fails its batch).

Two injection modes, combinable per site:

  * **schedule** — ``{"site": (0, 2)}`` fires at exactly those 0-based
    call indices of the site.  Fully deterministic: the i-th ``check``
    of a site fires iff i is scheduled, independent of wall clock,
    process, or seed.
  * **rates** — ``{"site": 0.2}`` fires ~20% of calls, drawn from a
    per-site PRNG derived from ``seed`` and the site name (stable
    CRC-32, not Python's salted ``hash``), so a given (seed, site,
    call-index) triple always makes the same decision.

``check(site, index=...)`` supports *keyed* injection (fire when an
explicit index — e.g. a training step — is scheduled, at most once per
key); :class:`FailureInjector` — the training-supervisor injector that
predates this module (``runtime/fault.py`` re-exports it) — is now a
thin shim over that mode, raising its historical ``NodeFailure``.

Failures raise :class:`ChaosInjected`; the harness records every fired
(site, index) in ``events`` so tests can assert exactly which injection
produced an observed recovery.  All methods are thread-safe: serving
executors check from worker threads.
"""
from __future__ import annotations

import threading
import zlib
from typing import Dict, List, Mapping, Optional, Sequence, Tuple

import numpy as np


class ChaosInjected(RuntimeError):
    """A deterministically injected fault (never a real error)."""

    def __init__(self, site: str, index: int, detail: str = ""):
        self.site = site
        self.index = index
        super().__init__(
            f"chaos injected at {site}[{index}]"
            + (f": {detail}" if detail else ""))


class NodeFailure(RuntimeError):
    """A (simulated) node loss; the training supervisor's restart
    trigger.  Historically defined in runtime/fault.py, which still
    re-exports it."""


class ChaosHarness:
    """Seeded, schedule-driven injection harness (module docstring)."""

    def __init__(self, *, seed: int = 0,
                 schedule: Optional[Mapping[str, Sequence[int]]] = None,
                 rates: Optional[Mapping[str, float]] = None):
        for site, rate in (rates or {}).items():
            if not 0.0 <= rate <= 1.0:
                raise ValueError(f"rate {rate} for site {site!r} "
                                 f"outside [0, 1]")
        self.seed = int(seed)
        self.schedule = {s: frozenset(int(i) for i in ix)
                         for s, ix in (schedule or {}).items()}
        self.rates = dict(rates or {})
        self._lock = threading.Lock()
        self._counters: Dict[str, int] = {}
        self._fired: set = set()          # (site, index) one-shot keys
        self._rngs: Dict[str, np.random.Generator] = {}
        self.events: List[Tuple[str, int]] = []

    # -- decision ---------------------------------------------------------

    def _rate_draw(self, site: str) -> float:
        rng = self._rngs.get(site)
        if rng is None:
            # CRC-32 of the site name: stable across processes (unlike
            # the salted builtin hash), so (seed, site, call-index)
            # always reproduces the same decision stream.
            rng = self._rngs[site] = np.random.default_rng(
                (self.seed, zlib.crc32(site.encode())))
        return float(rng.random())

    def should_fire(self, site: str, index: Optional[int] = None) -> bool:
        """Advance the site and decide; ``index`` keys the decision to
        an explicit value (at most one fire per (site, index))."""
        with self._lock:
            if index is None:
                i = self._counters.get(site, 0)
                self._counters[site] = i + 1
            else:
                i = int(index)
                if (site, i) in self._fired:
                    return False
            fire = i in self.schedule.get(site, ())
            if not fire and index is None:
                rate = self.rates.get(site, 0.0)
                fire = rate > 0.0 and self._rate_draw(site) < rate
            if fire:
                self._fired.add((site, i))
                self.events.append((site, i))
            return fire

    def check(self, site: str, *, index: Optional[int] = None,
              detail: str = "") -> None:
        """Raise :class:`ChaosInjected` when this call is scheduled."""
        if self.should_fire(site, index):
            raise ChaosInjected(site, self._last_index(site), detail)

    def _last_index(self, site: str) -> int:
        with self._lock:
            for s, i in reversed(self.events):
                if s == site:
                    return i
        return -1

    def wrap(self, site: str, fn):
        """``fn`` guarded by a ``check(site)`` before every call."""
        def wrapped(*args, **kwargs):
            self.check(site)
            return fn(*args, **kwargs)
        return wrapped

    # -- introspection ----------------------------------------------------

    def count(self, site: str) -> int:
        """Calls made against ``site`` so far (counter mode only)."""
        with self._lock:
            return self._counters.get(site, 0)

    def fired(self, site: str) -> List[int]:
        """Indices at which ``site`` actually fired, in fire order."""
        with self._lock:
            return [i for s, i in self.events if s == site]


class FailureInjector(ChaosHarness):
    """Back-compat shim: the training-supervisor failure schedule
    (``fail_at`` step indices, one shot each) expressed as a chaos
    harness keyed on the ``train.step`` site.  ``runtime/fault.py``
    re-exports this under its historical import path."""

    SITE = "train.step"

    def __init__(self, fail_at: Sequence[int] = (), fired: object = None):
        super().__init__(schedule={self.SITE: tuple(fail_at)})
        self.fail_at = tuple(fail_at)
        del fired  # legacy dataclass field; state lives in the harness

    def check(self, step: int) -> None:  # type: ignore[override]
        if self.should_fire(self.SITE, index=step):
            raise NodeFailure(f"injected node failure at step {step}")


__all__ = ["ChaosHarness", "ChaosInjected", "FailureInjector",
           "NodeFailure"]
