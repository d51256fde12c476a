"""Batched LUT serving engine: request queue + dynamic bucketed batcher
(port of ``repro.serve.engine``, one replica).

  * Clients ``submit()`` requests of any size; a dispatcher thread
    coalesces whatever is queued into one batch (up to the largest
    bucket), bounded by a ``max_wait_ms`` admission window so a lone
    request is never stuck behind an empty queue.
  * Batches are padded up to a fixed bucket size (default 1/8/64/256);
    oversized requests are served in max-bucket chunks.  ``warmup()``
    runs every bucket once, so the kernel library is built and loaded
    before the first client request.
  * The forward is ``make_forward_fn``: input codes, the cascade plan,
    class values and argmax.  The plan's route is ``fused`` (default:
    the LUT-cascade kernel K1 over the bit-packed tables, one launch a
    batch for a chain or a LUT graph) or, with ``fused=False``, ``layer``
    (the per-layer lookup kernel K3 over the unpacked int32 tables, five
    launches a batch on jsc-5l; a DAG raises ``UnsupportedTopology``, as
    in the reference).  On the CPU both run their plain versions.  A
    failing forward fails its batch's futures with the error; nothing
    falls back to another route.

Not ported yet: replicas and routing, health eviction, chaos hooks,
deadlines, redispatch and the kernel-to-reference degradation wrapper.
"""
from __future__ import annotations

import queue
import threading
import time
from concurrent.futures import Future
from typing import Callable, List, Optional, Sequence, Tuple

import numpy as np
import torch

from repro_torch.core import lut_infer as LI
from repro_torch.core.exec_plan import LayerOperands, plan_cascade_exec
from repro_torch.core.model import node_static_conns
from repro_torch.device import DeviceLike, resolve_device
from repro_torch.kernels.lut_cascade import CascadeOperands
from repro_torch.serve.metrics import ServeMetrics
from repro_torch.serve.registry import ServeBundle

DEFAULT_BUCKETS: Tuple[int, ...] = (1, 8, 64, 256)


def pick_bucket(n: int, buckets: Sequence[int]) -> int:
    """Smallest bucket >= n; callers chunk anything larger than the max."""
    if n <= 0:
        raise ValueError(f"batch size {n} must be positive")
    for b in buckets:
        if n <= b:
            return b
    return buckets[-1]


def make_forward_fn(bundle: ServeBundle, *, fused: bool = True,
                    device: DeviceLike = None
                    ) -> Callable[[np.ndarray], torch.Tensor]:
    """(B, in_features) float32 -> (B,) int32 class predictions on
    ``device`` (``None`` = CUDA).  The route's operands and the
    quantizer scales are uploaded once, here: the fused route takes the
    bit-packed tables only (the unpacked int32 tables are ~8x larger),
    the per-layer route the unpacked tables as int32."""
    dev = resolve_device(device)
    cfg = bundle.cfg
    plan = plan_cascade_exec(cfg, fused=fused)  # layer route: chains only
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
            for t in bundle.tables], plan.schedule)

    def forward(x: np.ndarray) -> torch.Tensor:
        xt = torch.as_tensor(np.asarray(x, np.float32)).to(dev)
        codes = LI.input_codes(cfg, params, xt)
        out = plan.apply(codes, ops)
        vals = LI.class_values(cfg, params, out)
        return torch.argmax(vals, dim=-1).to(torch.int32)

    return forward


class _Request:
    __slots__ = ("x", "n", "future", "t_submit")

    def __init__(self, x: np.ndarray):
        self.x = x
        self.n = x.shape[0]
        self.future: "Future[np.ndarray]" = Future()
        self.t_submit = time.perf_counter()


_STOP = object()


def _complete(future: Future, result=None, exc=None) -> bool:
    """Resolve a future, tolerating a client-side cancel()."""
    if not future.set_running_or_notify_cancel():
        return False
    if exc is not None:
        future.set_exception(exc)
    else:
        future.set_result(result)
    return True


class LUTServeEngine:
    """Serve a ServeBundle behind a dynamic batcher (see module
    docstring).  ``device=None`` serves on the CUDA device;
    ``fused=False`` serves through the per-layer route."""

    def __init__(self, bundle: ServeBundle, *,
                 buckets: Sequence[int] = DEFAULT_BUCKETS,
                 max_wait_ms: float = 2.0,
                 fused: bool = True,
                 device: DeviceLike = None):
        buckets = tuple(int(b) for b in buckets)
        if not buckets or list(buckets) != sorted(set(buckets)) \
                or buckets[0] < 1:
            raise ValueError(f"buckets must be strictly increasing "
                             f"positive sizes: {buckets}")
        self.bundle = bundle
        self.buckets = buckets
        self.max_wait_s = max_wait_ms / 1e3
        self.device = resolve_device(device)
        self.metrics = ServeMetrics()
        self._forward = make_forward_fn(bundle, fused=fused,
                                        device=self.device)
        self._queue: "queue.Queue" = queue.Queue()
        self._thread: Optional[threading.Thread] = None
        self._closed = False
        # Serializes the closed-check + enqueue in submit() against
        # close(), so a request never lands behind the stop sentinel.
        self._submit_lock = threading.Lock()

    # -- lifecycle --------------------------------------------------------

    def start(self) -> "LUTServeEngine":
        if self._thread is None:
            self._thread = threading.Thread(target=self._dispatch_loop,
                                            daemon=True,
                                            name="lut-serve-dispatch")
            self._thread.start()
        return self

    def warmup(self) -> None:
        """Run every bucket shape once, so no client request pays for
        building or loading the kernels."""
        f = self.bundle.cfg.in_features
        for b in self.buckets:
            self._forward(np.zeros((b, f), np.float32)).cpu()

    def close(self) -> None:
        """Serve what was submitted before, then stop the dispatcher."""
        with self._submit_lock:
            if self._closed:
                return
            self._closed = True
            self._queue.put(_STOP)
        if self._thread is not None:
            self._thread.join()
            self._thread = None

    def __enter__(self) -> "LUTServeEngine":
        self.start()
        return self

    def __exit__(self, *exc) -> None:
        self.close()

    # -- client API -------------------------------------------------------

    def submit(self, x: np.ndarray) -> "Future[np.ndarray]":
        """Enqueue a request of shape (n, in_features) or (in_features,).
        The future resolves to the (n,) int32 class predictions."""
        x = np.asarray(x, np.float32)
        if x.ndim == 1:
            x = x[None, :]
        if x.ndim != 2 or x.shape[1] != self.bundle.cfg.in_features \
                or x.shape[0] == 0:
            raise ValueError(
                f"request shape {x.shape} != (n >= 1, "
                f"{self.bundle.cfg.in_features})")
        req = _Request(x)
        with self._submit_lock:
            if self._closed:
                raise RuntimeError("engine is closed")
            if self._thread is None:
                self.start()
            self._queue.put(req)
        return req.future

    def predict(self, x: np.ndarray) -> np.ndarray:
        """Synchronous convenience wrapper over submit()."""
        return self.submit(x).result()

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
            self._serve(batch, depth=self._queue.qsize())

    def _serve(self, batch: List[_Request], depth: int) -> None:
        total = sum(r.n for r in batch)
        x = (batch[0].x if len(batch) == 1
             else np.concatenate([r.x for r in batch], axis=0))
        try:
            preds, padded = self._run(x)
        except Exception as e:  # the dispatcher outlives a failed batch
            for r in batch:
                _complete(r.future, exc=e)
            return
        t_done = time.perf_counter()
        off = 0
        for r in batch:
            if _complete(r.future, preds[off:off + r.n]):
                self.metrics.record_request(t_done - r.t_submit, r.n)
            off += r.n
        self.metrics.record_batch(total, padded, depth)

    def _run(self, x: np.ndarray) -> Tuple[np.ndarray, int]:
        """Serve (n, F) through bucket-padded forwards; returns the (n,)
        predictions and the number of dispatched (padded) slots."""
        n = x.shape[0]
        max_bucket = self.buckets[-1]
        outs: List[np.ndarray] = []
        padded = 0
        for s in range(0, n, max_bucket):
            chunk = x[s:s + max_bucket]
            b = pick_bucket(chunk.shape[0], self.buckets)
            if chunk.shape[0] < b:
                pad = np.zeros((b - chunk.shape[0], x.shape[1]), x.dtype)
                chunk = np.concatenate([chunk, pad], axis=0)
            out = self._forward(chunk).cpu().numpy()
            outs.append(out[:min(max_bucket, n - s)])
            padded += b
        return np.concatenate(outs, axis=0), padded
