"""Straggler detection (port of ``repro.runtime.straggler``, pure
Python).

  * ``run_with_backup`` races a backup producer against a slow primary
    (speculative execution): threads stand in for the workers a cluster
    would hand each task to.

  * ``StepWatchdog`` keeps a robust (median + k*MAD) envelope of step
    times and flags the outliers; three flags in a row mark a degraded
    node (``persistent``).  The sweep (``repro_torch.sweep``) records
    each group's training seconds in it and streams the flags.
"""
from __future__ import annotations

import statistics
import threading
from typing import Callable, List, TypeVar

T = TypeVar("T")


def run_with_backup(fn: Callable[[], T], *, timeout_s: float,
                    max_backups: int = 1) -> T:
    """Return the first result of ``fn``; spawn backup runs if slow."""
    result: List = []
    done = threading.Event()

    def runner():
        try:
            r = fn()
        except Exception as e:  # propagate first error if nothing succeeds
            r = e
        if not done.is_set():
            result.append(r)
            done.set()

    threads = [threading.Thread(target=runner, daemon=True)]
    threads[0].start()
    started = 1
    while not done.wait(timeout=timeout_s):
        if started > max_backups:
            done.wait()
            break
        t = threading.Thread(target=runner, daemon=True)
        t.start()
        threads.append(t)
        started += 1
    r = result[0]
    if isinstance(r, Exception):
        raise r
    return r


class StepWatchdog:
    def __init__(self, *, window: int = 50, k_mad: float = 6.0,
                 min_steps: int = 10):
        self.window = window
        self.k = k_mad
        self.min_steps = min_steps
        self.times: List[float] = []
        self.flags = 0

    def record(self, step_time_s: float) -> bool:
        """Returns True if this step is a straggler outlier."""
        ts = self.times
        slow = False
        if len(ts) >= self.min_steps:
            med = statistics.median(ts)
            mad = statistics.median(abs(t - med) for t in ts) or med * 0.05
            slow = step_time_s > med + self.k * mad
        ts.append(step_time_s)
        if len(ts) > self.window:
            ts.pop(0)
        self.flags = self.flags + 1 if slow else 0
        return slow

    @property
    def persistent(self) -> bool:
        """Three consecutive flagged steps => treat as degraded node."""
        return self.flags >= 3
