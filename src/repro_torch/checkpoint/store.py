"""Atomic, async checkpointing of nested dicts and lists of arrays (port
of ``repro.checkpoint.store``).

Layout, the reference's, so the two packages read each other's files:

    <dir>/step_0000000100/
        manifest.json      (step, tree structure, keys, dtypes, user meta,
                            the COMMITTED marker)
        shard_0.npz        (the leaf arrays, keyed by path)

A leaf's key is its path, dict keys and ``#i`` list indices joined by
``/`` (``"tables/#0"``, ``"in_log_s"``), walked in sorted-key order as
``jax.tree_util.tree_flatten_with_path`` walks a tree; ``None`` is an
empty subtree.  Leaves may be numpy arrays, scalars or tensors (copied
to the host).

Guarantees:
  * atomic: written to a ``.tmp-<pid>-<step>`` dir, fsync'd, then
    renamed; a directory without a committed manifest is ignored, and
    leftover temporary directories are removed by the next save.
  * restart-safe: ``latest_step`` scans for the newest COMMITTED step;
    ``restore(step=None)`` skips a committed step whose shard is
    unreadable, with a ``RuntimeWarning``.
  * async: ``save_async`` copies the leaves to the host synchronously
    and writes on a worker thread.
  * keep-last-k garbage collection.

``restore`` returns numpy arrays, or tensors on the device the caller
names, or, given ``shardings`` (a tree of ``sharding.partition.
NamedSharding`` shaped like the template, as ``named`` makes), each
rank's shard of every leaf on its mesh's device: the reference's
``restore(shardings=)``.  A checkpoint holds whole arrays, so it
restores onto any mesh, another shape than the one that saved it
included.  Over a mesh the caller gathers the leaves whole
(``sharding.spmd.gather_tree``) and one rank saves them.
"""
from __future__ import annotations

import json
import os
import re
import shutil
import threading
import warnings
from concurrent.futures import Future, ThreadPoolExecutor
from pathlib import Path
from typing import Any, Dict, List, Optional, Tuple

import numpy as np

_STD_KINDS = set("biufc")  # bool/int/uint/float/complex natively in numpy


def _leaves_with_path(tree, path: Tuple[str, ...] = ()
                      ) -> List[Tuple[Tuple[str, ...], Any]]:
    """(path segments, leaf) in the reference's order: dict keys sorted,
    list and tuple items by index (``#i``), ``None`` holding no leaf."""
    if tree is None:
        return []
    if isinstance(tree, dict):
        return [x for k in sorted(tree)
                for x in _leaves_with_path(tree[k], path + (str(k),))]
    if isinstance(tree, (list, tuple)):
        return [x for i, t in enumerate(tree)
                for x in _leaves_with_path(t, path + (f"#{i}",))]
    return [(path, tree)]


def _treedef(tree) -> str:
    """The tree's structure as ``str(jax.tree_util.tree_structure)``
    prints it (informational: ``restore`` rebuilds from its template)."""
    def enc(t) -> str:
        if t is None:
            return "None"
        if isinstance(t, dict):
            return "{" + ", ".join(f"{k!r}: {enc(t[k])}"
                                   for k in sorted(t)) + "}"
        if isinstance(t, list):
            return "[" + ", ".join(enc(x) for x in t) + "]"
        if isinstance(t, tuple):
            inner = ", ".join(enc(x) for x in t)
            return f"({inner},)" if len(t) == 1 else f"({inner})"
        return "*"
    return f"PyTreeDef({enc(tree)})"


def _host(leaf) -> Tuple[np.ndarray, Optional[str]]:
    """(host array, dtype name when numpy cannot hold the leaf's own
    dtype: the array is then a same-width uint view)."""
    if hasattr(leaf, "detach"):  # a tensor
        t = leaf.detach().cpu()
        try:
            return t.numpy(), None
        except TypeError:  # bfloat16, float8: no numpy dtype
            import torch
            bits = t.view({1: torch.uint8, 2: torch.int16}[t.element_size()])
            return (bits.numpy().view(np.dtype(f"u{t.element_size()}")),
                    str(t.dtype).replace("torch.", ""))
    arr = np.asarray(leaf)
    if arr.dtype.kind not in _STD_KINDS:
        return arr.view(np.dtype(f"u{arr.dtype.itemsize}")), str(arr.dtype)
    return arr, None


def _flatten(tree) -> Tuple[Dict[str, np.ndarray], Dict[str, str]]:
    """Flatten to {key: array}; leaves of a dtype numpy cannot store
    (bfloat16, fp8) go in as same-width uint views with their true dtype
    recorded, as the reference stores them."""
    out: Dict[str, np.ndarray] = {}
    dtypes: Dict[str, str] = {}
    for path, leaf in _leaves_with_path(tree):
        key = "/".join(path)
        out[key], dtype = _host(leaf)
        if dtype is not None:
            dtypes[key] = dtype
    return out, dtypes


def _rebuild(template, leaves):
    """A tree shaped like ``template`` with ``leaves`` in walk order."""
    it = iter(leaves)

    def build(t):
        if t is None:
            return None
        if isinstance(t, dict):
            return {k: build(t[k]) for k in sorted(t)}
        if isinstance(t, (list, tuple)):
            return type(t)(build(x) for x in t)
        return next(it)
    return build(template)


class CheckpointStore:
    def __init__(self, directory: str, *, keep: int = 3,
                 host_index: int = 0):
        self.dir = Path(directory)
        self.dir.mkdir(parents=True, exist_ok=True)
        self.keep = keep
        self.host = host_index
        self._pool = ThreadPoolExecutor(max_workers=1)
        self._lock = threading.Lock()

    # -- write ------------------------------------------------------------

    def save(self, step: int, tree: Any, *, meta: Optional[Dict] = None
             ) -> Path:
        flat, dtypes = _flatten(tree)
        return self._write(step, flat, _treedef(tree), meta or {}, dtypes)

    def save_async(self, step: int, tree: Any, *,
                   meta: Optional[Dict] = None) -> "Future[Path]":
        flat, dtypes = _flatten(tree)  # synchronous host snapshot
        flat = {k: np.array(v, copy=True) for k, v in flat.items()}
        return self._pool.submit(self._write, step, flat, _treedef(tree),
                                 meta or {}, dtypes)

    def _write(self, step: int, flat: Dict[str, np.ndarray], treedef: str,
               meta: Dict, dtypes: Optional[Dict[str, str]] = None) -> Path:
        with self._lock:
            final = self.dir / f"step_{step:010d}"
            tmp = self.dir / f".tmp-{os.getpid()}-{step}"
            if tmp.exists():
                shutil.rmtree(tmp)
            tmp.mkdir(parents=True)
            np.savez(tmp / f"shard_{self.host}.npz", **flat)
            manifest = {
                "step": step,
                "treedef": treedef,
                "keys": sorted(flat),
                "dtypes": dtypes or {},
                "meta": meta,
                "committed": True,
            }
            with open(tmp / "manifest.json", "w") as f:
                json.dump(manifest, f)
                f.flush()
                os.fsync(f.fileno())
            if final.exists():
                shutil.rmtree(final)
            tmp.rename(final)
            self._gc()
            return final

    def _gc(self) -> None:
        steps = self.list_steps()
        for s in steps[:-self.keep] if self.keep else []:
            shutil.rmtree(self.dir / f"step_{s:010d}", ignore_errors=True)
        for p in self.dir.glob(".tmp-*"):
            shutil.rmtree(p, ignore_errors=True)

    # -- read -------------------------------------------------------------

    def list_steps(self) -> List[int]:
        steps = []
        for p in self.dir.glob("step_*"):
            m = re.match(r"step_(\d+)$", p.name)
            if not m:
                continue
            try:
                if json.loads((p / "manifest.json").read_text()
                              ).get("committed"):
                    steps.append(int(m.group(1)))
            except Exception:
                continue
        return sorted(steps)

    def latest_step(self) -> Optional[int]:
        steps = self.list_steps()
        return steps[-1] if steps else None

    def meta(self, step: int) -> Dict:
        """User metadata recorded at ``save(..., meta=)`` time."""
        path = self.dir / f"step_{step:010d}" / "manifest.json"
        return json.loads(path.read_text()).get("meta", {})

    def restore(self, template: Any, *, step: Optional[int] = None,
                device=None, shardings: Any = None) -> Tuple[int, Any]:
        """Rebuild a ``template``-shaped tree (only its structure is
        read) of numpy arrays, or of tensors on ``device`` when one is
        named, or of this rank's shards by ``shardings`` (on ``device``,
        else the mesh's device).

        With ``step=None`` a checkpoint whose shard is truncated or
        corrupted is skipped with a ``RuntimeWarning`` and the
        next-newest committed step is tried; an explicitly requested
        ``step`` raises on corruption."""
        if step is not None:
            return self._restore_step(step, template, device, shardings)
        steps = self.list_steps()
        if not steps:
            raise FileNotFoundError(f"no committed checkpoint in {self.dir}")
        last_exc: Optional[Exception] = None
        for s in reversed(steps):
            try:
                return self._restore_step(s, template, device, shardings)
            except Exception as e:  # truncated npz, bad zip CRC, ...
                warnings.warn(
                    f"checkpoint step {s} in {self.dir} is unreadable "
                    f"({type(e).__name__}: {e}); falling back to the "
                    f"previous committed step", RuntimeWarning,
                    stacklevel=2)
                last_exc = e
        raise FileNotFoundError(
            f"no readable checkpoint in {self.dir} "
            f"({len(steps)} committed but all corrupt)") from last_exc

    def _restore_step(self, step: int, template: Any, device,
                      shardings: Any = None) -> Tuple[int, Any]:
        path = self.dir / f"step_{step:010d}"
        dtypes = json.loads(
            (path / "manifest.json").read_text()).get("dtypes", {})
        flat = _leaves_with_path(template)
        shard_flat = ([s for _, s in _leaves_with_path(shardings)]
                      if shardings is not None else [None] * len(flat))
        if len(shard_flat) != len(flat):
            raise ValueError(f"shardings hold {len(shard_flat)} leaves, "
                             f"the template {len(flat)}")
        leaves = []
        with np.load(path / f"shard_{self.host}.npz") as data:
            for (p, _), sh in zip(flat, shard_flat):
                key = "/".join(p)
                arr = data[key]  # raises on a missing key or a bad CRC
                if sh is None:
                    leaves.append(_restore_leaf(arr, dtypes.get(key),
                                                device))
                    continue
                from repro_torch.sharding.spmd import local_shard
                t = _restore_leaf(arr, dtypes.get(key),
                                  device if device is not None
                                  else sh.mesh.device)
                leaves.append(local_shard(sh.mesh, t, sh.spec))
        return step, _rebuild(template, leaves)


def _restore_leaf(arr: np.ndarray, dtype: Optional[str], device):
    if device is None:
        if dtype is not None:
            import ml_dtypes  # noqa: F401 — registers the dtypes
            arr = arr.view(np.dtype(dtype))
        return arr
    import torch
    # ascontiguousarray makes a 0-d array 1-d: keep the stored shape
    t = torch.from_numpy(np.ascontiguousarray(arr)).reshape(arr.shape)
    if dtype is not None:
        t = t.view(getattr(torch, dtype))
    return t.to(device)
