"""Minimal streaming metrics tracker (port of ``repro.runtime.tracker``,
pure Python; levanter-style ``log_metrics`` / ``finish`` interface).

The sweep engine (``repro_torch.sweep``) produces Pareto frontier
points one geometry group at a time and pushes them through a
:class:`Tracker` as each group finishes, instead of returning everything
at the end of the run.  Consumers range from a print stream to a JSONL
file a plotting process can tail while the sweep is still training.

The interface is deliberately tiny:

  * ``log_metrics(metrics, step=None)`` — one dict of scalars/strings,
    with an optional monotone step (the sweep uses the global point
    index);
  * ``log_summary(metrics)``           — end-of-run aggregates;
  * ``finish()``                       — flush + close; idempotent, and
    logging after it is a programming error that raises.

Implementations here are host-side and tiny on purpose.
"""
from __future__ import annotations

import json
import sys
import threading
from typing import Callable, Mapping, Optional, Sequence

Metrics = Mapping


class Tracker:
    """Base class: implement ``_log``; lifecycle handled here."""

    def __init__(self) -> None:
        self._finished = False
        self._lock = threading.Lock()

    # -- subclass hooks ---------------------------------------------------
    def _log(self, metrics: Metrics, *, step: Optional[int],
             summary: bool) -> None:
        raise NotImplementedError

    def _close(self) -> None:
        pass

    # -- public interface -------------------------------------------------
    def log_metrics(self, metrics: Metrics, *,
                    step: Optional[int] = None) -> None:
        with self._lock:
            if self._finished:
                raise RuntimeError(
                    f"{type(self).__name__}.log_metrics after finish()")
            self._log(metrics, step=step, summary=False)

    def log_summary(self, metrics: Metrics) -> None:
        with self._lock:
            if self._finished:
                raise RuntimeError(
                    f"{type(self).__name__}.log_summary after finish()")
            self._log(metrics, step=None, summary=True)

    def finish(self) -> None:
        with self._lock:
            if self._finished:
                return  # idempotent
            self._finished = True
            self._close()

    @property
    def finished(self) -> bool:
        return self._finished

    def __enter__(self) -> "Tracker":
        return self

    def __exit__(self, *exc) -> None:
        self.finish()


class NoopTracker(Tracker):
    def _log(self, metrics: Metrics, *, step, summary) -> None:
        pass


class CallbackTracker(Tracker):
    """Routes every record to ``fn(metrics, step, summary)`` — the glue
    the benchmarks use to stream frontier points into ``emit``."""

    def __init__(self, fn: Callable[[Metrics, Optional[int], bool], None]
                 ) -> None:
        super().__init__()
        self._fn = fn

    def _log(self, metrics: Metrics, *, step, summary) -> None:
        self._fn(metrics, step, summary)


class PrintTracker(Tracker):
    """Human-readable stream (default: stdout)."""

    def __init__(self, stream=None) -> None:
        super().__init__()
        self._stream = stream or sys.stdout

    def _log(self, metrics: Metrics, *, step, summary) -> None:
        head = "summary" if summary else f"step {step}" \
            if step is not None else "metrics"
        kv = " ".join(f"{k}={v}" for k, v in metrics.items())
        print(f"[track {head}] {kv}", file=self._stream, flush=True)


class JsonlTracker(Tracker):
    """One JSON object per record, flushed per write so a consumer can
    tail the file while the producing sweep is still running."""

    def __init__(self, path: str) -> None:
        super().__init__()
        self.path = str(path)
        self._fh = open(self.path, "w")

    def _log(self, metrics: Metrics, *, step, summary) -> None:
        rec = dict(metrics)
        if step is not None:
            rec["_step"] = int(step)
        if summary:
            rec["_summary"] = True
        self._fh.write(json.dumps(rec) + "\n")
        self._fh.flush()

    def _close(self) -> None:
        self._fh.close()


class CompositeTracker(Tracker):
    """Fan a record out to several trackers; finish() finishes all."""

    def __init__(self, trackers: Sequence[Tracker]) -> None:
        super().__init__()
        self.trackers = list(trackers)

    def _log(self, metrics: Metrics, *, step, summary) -> None:
        for t in self.trackers:
            if summary:
                t.log_summary(metrics)
            else:
                t.log_metrics(metrics, step=step)

    def _close(self) -> None:
        for t in self.trackers:
            t.finish()
