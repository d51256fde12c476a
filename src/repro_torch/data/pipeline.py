"""The LM input pipeline and device-resident datasets (port of
``repro.data.pipeline``).

``ShardedLoader``: each data-parallel host slices its shard of the
global batch deterministically from the synthetic source
(``lm_batch_fn``), a worker thread prefetches the next batches, and the
consumer gets numpy arrays.  Deterministic across restarts: the loader
state is just (seed, step).  ``backup_after_s`` starts a redundant
producer for a batch whose primary takes too long
(``runtime.straggler.run_with_backup``).

``device_dataset``: a generator's arrays are made once on the host,
copied to the device once, and the same tensors come back on every
later call with the same generator, arguments and device: epochs,
reruns and repeated launches in one process do no host work and no
host-to-device copies.
"""
from __future__ import annotations

import queue
import threading
from typing import Callable, Dict, Iterator, Optional, Tuple

import numpy as np
import torch

from repro_torch.device import DeviceLike, resolve_device
from repro_torch.runtime.straggler import run_with_backup


class ShardedLoader:
    def __init__(self, make_batch: Callable[[int], Dict[str, np.ndarray]],
                 *, start_step: int = 0, prefetch: int = 2,
                 backup_after_s: Optional[float] = None):
        """``make_batch(step)`` must be deterministic in ``step``."""
        self.make_batch = make_batch
        self.step = start_step
        self.prefetch = prefetch
        self.backup_after_s = backup_after_s
        self._q: "queue.Queue" = queue.Queue(maxsize=prefetch)
        self._stop = threading.Event()
        self._thread = threading.Thread(target=self._worker, daemon=True)
        self._thread.start()

    def _produce(self, step: int) -> Dict[str, np.ndarray]:
        if self.backup_after_s is None:
            return self.make_batch(step)
        return run_with_backup(lambda: self.make_batch(step),
                               timeout_s=self.backup_after_s)

    def _worker(self) -> None:
        s = self.step
        while not self._stop.is_set():
            try:
                batch = self._produce(s)
            except Exception as e:  # surfaces in the consumer
                self._q.put(e)
                return
            self._q.put((s, batch))
            s += 1

    def __iter__(self) -> Iterator:
        return self

    def __next__(self):
        item = self._q.get()
        if isinstance(item, Exception):
            raise item
        step, batch = item
        self.step = step + 1
        return batch

    def close(self, timeout_s: float = 10.0) -> None:
        """Stop the worker: drain the queue so a blocked ``put`` returns,
        then wait for the thread."""
        self._stop.set()
        while self._thread.is_alive():
            try:
                while True:
                    self._q.get_nowait()
            except queue.Empty:
                pass
            self._thread.join(timeout=0.05)
            timeout_s -= 0.05
            if timeout_s <= 0:
                break


def lm_batch_fn(vocab: int, global_batch: int, seq_len: int, *,
                seed: int = 0, host_index: int = 0, num_hosts: int = 1):
    """Deterministic per-step LM batch (numpy int32 ``tokens`` and
    next-token ``labels``); hosts carve disjoint row ranges."""
    from .synthetic import token_stream

    rows = global_batch // num_hosts
    lo = host_index * rows

    def make(step: int) -> Dict[str, np.ndarray]:
        rng_seed = (seed * 1_000_003 + step) % (2 ** 31)
        toks = token_stream(rows * (seq_len + 1), vocab,
                            seed=rng_seed + lo)
        toks = toks.reshape(rows, seq_len + 1)
        return {"tokens": toks[:, :-1].astype(np.int32),
                "labels": toks[:, 1:].astype(np.int32)}

    return make

_DEVICE_DATA: Dict[Tuple, Tuple[torch.Tensor, ...]] = {}


def device_dataset(gen: Callable, *args, device: DeviceLike = None,
                   **kwargs) -> Tuple[torch.Tensor, ...]:
    """``gen(*args, **kwargs)`` (a deterministic generator of an array or
    a tuple of arrays) as tensors on ``device`` (``None`` = CUDA), made
    on the first call and returned as the same tensors afterwards."""
    dev = resolve_device(device)
    key = (getattr(gen, "__module__", ""),
           getattr(gen, "__qualname__", repr(gen)), args,
           tuple(sorted(kwargs.items())), str(dev))
    out = _DEVICE_DATA.get(key)
    if out is None:
        arrs = gen(*args, **kwargs)
        if not isinstance(arrs, tuple):
            arrs = (arrs,)
        out = tuple(torch.as_tensor(np.ascontiguousarray(a), device=dev)
                    for a in arrs)
        _DEVICE_DATA[key] = out
    return out



def device_dataset_stats() -> Dict[str, int]:
    """{cached entries, resident bytes}: tests and memory audits."""
    return {"entries": len(_DEVICE_DATA),
            "bytes": sum(int(a.numel() * a.element_size())
                         for v in _DEVICE_DATA.values() for a in v)}


def clear_device_datasets() -> None:
    _DEVICE_DATA.clear()
