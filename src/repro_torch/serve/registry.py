"""Registry of converted LUT models: the deployable serving artifact
(port of ``repro.serve.registry``).

A *bundle* is everything the bit-exact LUT path needs and nothing it
does not: the per-layer truth tables, the connectivity (which is not
re-derivable across processes — ``core.layers.layer_static`` seeds it
with Python's per-process salted ``hash``), and the learned quantizer
scales of the input encoder and the output decoder.  A LUT graph's
bundle holds per-node lists of branch tables and ``{"conns": [...]}``
statics; its packed tables are flat in (node, branch) order, the
kernel's operand order.  Trained float weights stay behind; serving
never retrains.

Storage rides on :class:`repro_torch.checkpoint.CheckpointStore`
(atomic rename, committed manifest, keep-last-k), one store per model:

    <root>/<name>/step_<version>/{manifest.json, shard_0.npz}

The npz keys, the manifest's ``meta`` (the config as a dict, its
fingerprint, the topology, the integrity record) and the directory
layout are the reference's, so a bundle saved by either package loads
in the other, bit-identical.  Poly-kind monomial exponents are
recomputed on load.

**Integrity.**  The LUT is the model — a flipped bit in a stored table
is a silent misclassification — so ``save`` checksums every stored array
(SHA-256 over dtype + shape + bytes) and the manifest meta itself,
under ``meta["integrity"]``.  ``load`` verifies before serving and
raises :class:`BundleIntegrityError` on a mismatch; ``verify``
recomputes on demand (the :class:`IntegrityProbe` background prober
rides on it); ``quarantine`` renames a corrupted version out of the
committed namespace so ``load`` falls back to the newest intact one.
Bundles without an integrity record load unchanged.

The port's bundle carries no shift matrices: its cascade kernel takes
the connectivity itself (``kernels.lut_cascade.CascadeOperands``).
``load(shard_replicas=R)`` plans the bundle's layout over R devices at
load (``serve/sharded.py``).
"""
from __future__ import annotations

import dataclasses
import hashlib
import json
import shutil
import threading
from dataclasses import dataclass, field
from pathlib import Path
from typing import Any, Callable, Dict, List, Optional, Union

import numpy as np
import torch

from repro_torch.checkpoint import CheckpointStore
from repro_torch.checkpoint.store import _flatten
from repro_torch.config import config_fingerprint
from repro_torch.core.model import node_static_conns
from repro_torch.core.nl_config import (LUTGraphConfig, LUTNodeSpec,
                                        NeuraLUTConfig, is_graph_config)
from repro_torch.core.subnet import monomial_exponents
from repro_torch.runtime.chaos import ChaosHarness

BUNDLE_FORMAT = 1          # chain bundles (the original schema)
GRAPH_BUNDLE_FORMAT = 2    # LUT-DAG bundles: per-node branch lists
SUPPORTED_FORMATS = (BUNDLE_FORMAT, GRAPH_BUNDLE_FORMAT)

INTEGRITY_ALGO = "sha256"


class BundleIntegrityError(RuntimeError):
    """Stored bundle bytes disagree with their recorded checksums (or
    the shard is unreadable outright); the bundle is refused rather
    than served."""

    def __init__(self, name: str, version: int, detail: str):
        self.name = name
        self.version = version
        super().__init__(f"bundle '{name}' v{version} failed integrity "
                         f"check: {detail}")


def _array_digest(a: np.ndarray) -> str:
    """SHA-256 over dtype + shape + raw bytes (shape and dtype are part
    of the contract: a resized but byte-equal array must not verify)."""
    a = np.ascontiguousarray(a)
    h = hashlib.sha256()
    h.update(str(a.dtype).encode())
    h.update(repr(a.shape).encode())
    h.update(a.tobytes())
    return h.hexdigest()


def _meta_digest(meta: Dict[str, Any]) -> str:
    """Canonical digest of the manifest meta minus the integrity record
    itself.  JSON round trips normalize containers, so the save-time and
    load-time digests agree on any JSON-native meta."""
    body = {k: v for k, v in meta.items() if k != "integrity"}
    return hashlib.sha256(
        json.dumps(body, sort_keys=True, default=str).encode()).hexdigest()


def _json_native(v):
    """Meta values as JSON writes and reads them back: numpy scalars and
    0-d tensors to Python numbers, arrays and tuples to lists.  Applied
    before the digest, so the digest of what was written equals the
    digest of what is read."""
    if isinstance(v, dict):
        return {k: _json_native(x) for k, x in v.items()}
    if isinstance(v, (list, tuple)):
        return [_json_native(x) for x in v]
    if isinstance(v, torch.Tensor):
        v = v.detach().cpu().numpy()
    if isinstance(v, (np.ndarray, np.generic)):
        return _json_native(v.tolist())
    return v


@dataclass
class ServeBundle:
    """In-memory form of a registry entry, chain or LUT graph (see the
    module docstring).  Arrays live on the host; an engine uploads them
    to its devices."""

    cfg: Union[NeuraLUTConfig, LUTGraphConfig]
    tables: List              # chain [(O_i, T_i) uint16]; graph per node
    #                           [[(O_i, T_i) uint16] per branch]
    statics: List[Dict[str, Any]]  # [{"conn"}] / [{"conns": [...]}],
    #                                 and "exps" for the poly kind
    in_log_s: np.ndarray                     # (in_features,) f32
    layer_log_s: List[np.ndarray]            # [(O_i,) f32]
    meta: Dict[str, Any] = field(default_factory=dict)
    # Cascade operands, filled by prepack(): bit-packed tables, flat in
    # (node, branch) order, and the kernel geometry
    # (kernels/lut_cascade.cascade_meta / graph_cascade_meta).
    packed_tables: Optional[List[np.ndarray]] = None  # [(O, T/P) int32]
    cascade_geom: Optional[tuple] = None
    # Multi-device layout (serve/sharded.py), cached by plan_shards().
    shard_plan: Optional[Any] = None

    def plan_shards(self, num_replicas: int, *, mode: str = "auto",
                    budget_bytes: Optional[int] = None):
        """Compute (and cache) the multi-device layout of this bundle,
        replicated or o_sharded, with its per-device operands built
        once, so sharded serving never converts on the hot path.
        Re-plans only when the requested layout changes, as the
        reference's."""
        from repro_torch.serve.sharded import plan_shards
        plan = self.shard_plan
        if (plan is None or plan.num_replicas != num_replicas
                or (mode != "auto" and plan.mode != mode)
                or (budget_bytes is not None
                    and plan.budget_bytes != budget_bytes)):
            self.shard_plan = plan_shards(self, num_replicas, mode=mode,
                                          budget_bytes=budget_bytes)
        return self.shard_plan

    def prepack(self) -> "ServeBundle":
        """Bit-pack every table and derive the cascade geometry;
        idempotent, returns self.  Bundles built from
        ``truth_table.convert_packed`` arrive packed already."""
        from repro_torch.kernels.lut_cascade import (cascade_meta,
                                                     cascade_tables,
                                                     graph_cascade_meta,
                                                     graph_cascade_tables)
        graph = is_graph_config(self.cfg)
        if self.packed_tables is None:
            self.packed_tables = (graph_cascade_tables if graph
                                  else cascade_tables)(self.cfg, self.tables)
        if self.cascade_geom is None:
            self.cascade_geom = (graph_cascade_meta if graph
                                 else cascade_meta)(self.cfg)
        return self

    @property
    def schema_version(self) -> int:
        """On-disk schema this bundle serializes to: 1 for chains, 2 for
        LUT graphs (per-node branch lists)."""
        return (GRAPH_BUNDLE_FORMAT if is_graph_config(self.cfg)
                else BUNDLE_FORMAT)

    @property
    def topology(self) -> tuple:
        """Structural descriptor of the LUT network: ``("chain",
        layer_widths)`` for a chain, ``("dag", per-node (name, width,
        fan_in, inputs, arity))`` for a graph, as the reference's."""
        if not is_graph_config(self.cfg):
            return ("chain", tuple(self.cfg.layer_widths))
        return ("dag", tuple((n.name, n.width, n.fan_in, tuple(n.inputs),
                              n.arity) for n in self.cfg.nodes))

    @property
    def geometry_key(self) -> tuple:
        """Everything that determines the *shapes* of the cascade
        operands and the bit-layout constants of a forward: two bundles
        with equal keys share one cross-tenant dispatch
        (serve/tenants.py), and only an equal-key candidate may be
        hot-swapped over an incumbent.  Table contents and connectivity
        are per-tenant operand values, not shapes, and are excluded.
        The reference's key, verbatim."""
        cfg = self.cfg
        if is_graph_config(cfg):
            return (cfg.in_features, cfg.num_classes, cfg.beta,
                    cfg.beta_in, self.topology)
        return (cfg.in_features, tuple(cfg.layer_widths), cfg.num_classes,
                cfg.beta, cfg.beta_in, cfg.fan_in, cfg.fan_in_0)

    def serve_params(self, device: torch.device) -> Dict[str, Any]:
        """The params subset ``core.lut_infer`` (input_codes /
        class_values) reads, as tensors on ``device``."""
        def t(a):
            return torch.as_tensor(np.asarray(a, np.float32), device=device)
        return {"in_quant": {"log_s": t(self.in_log_s)},
                "layers": [{"quant": {"log_s": t(s)}}
                           for s in self.layer_log_s]}

    @property
    def num_table_bytes(self) -> int:
        return sum(t.nbytes for t in _flat_arrays(self.tables))

    @property
    def num_packed_table_bytes(self) -> int:
        self.prepack()
        return sum(t.nbytes for t in self.packed_tables)


def _host(a) -> np.ndarray:
    return a.detach().cpu().numpy() if isinstance(a, torch.Tensor) \
        else np.asarray(a)


def _host_tree(v):
    """Arrays (and lists of them, as a node's branches) on the host."""
    if isinstance(v, (list, tuple)):
        return [_host(a) for a in v]
    return _host(v)


def _flat_arrays(nested) -> List[np.ndarray]:
    """Flatten one level of per-node list nesting (graph bundles)."""
    return [_host(a) for item in nested
            for a in (item if isinstance(item, (list, tuple)) else [item])]


def bundle_from_training(cfg, params: Dict, tables: List,
                         statics: List[Dict], *,
                         packed_tables: Optional[List] = None,
                         meta: Optional[Dict] = None) -> ServeBundle:
    """Extract the deployable subset of a (params, tables, statics)
    triple, chain or LUT graph (per-node table lists from
    ``truth_table.convert_graph``).  Pass the packed tables of
    ``truth_table.convert_packed`` (per-node lists for a graph) and the
    bundle is serving-ready on the spot.  A poly model's statics carry
    its monomial exponents, as the reference's registry restores them."""
    if is_graph_config(cfg):
        tables = [node if isinstance(node, (list, tuple)) else [node]
                  for node in tables]
    statics = [{k: _host_tree(v) for k, v in s.items()} for s in statics]
    if cfg.kind == "poly":
        for i, s in enumerate(statics):
            s["exps"] = monomial_exponents(cfg.layer_fan_in(i), cfg.degree)
    bundle = ServeBundle(
        cfg=cfg,
        tables=[_host_tree(t) for t in tables],
        statics=statics,
        in_log_s=_host(params["in_quant"]["log_s"]).astype(np.float32),
        layer_log_s=[_host(lp["quant"]["log_s"]).astype(np.float32)
                     for lp in params["layers"]],
        meta=dict(meta or {}),
    )
    if packed_tables is not None:
        bundle.packed_tables = [p.astype(np.int32)
                                for p in _flat_arrays(packed_tables)]
        bundle.prepack()  # fills only cascade_geom
    return bundle


def _cfg_to_meta(cfg) -> Dict[str, Any]:
    d = dataclasses.asdict(cfg)
    if is_graph_config(cfg):
        d["nodes"] = [{**nd, "inputs": list(nd["inputs"])}
                      for nd in d["nodes"]]
    else:
        d["layer_widths"] = list(d["layer_widths"])
    return d


def _cfg_from_meta(d: Dict[str, Any]):
    d = dict(d)
    if "nodes" in d:
        d["nodes"] = tuple(
            LUTNodeSpec(name=nd["name"], width=nd["width"],
                        fan_in=nd["fan_in"], inputs=tuple(nd["inputs"]),
                        arity=nd["arity"]) for nd in d["nodes"])
        return LUTGraphConfig(**d)
    d["layer_widths"] = tuple(d["layer_widths"])
    return NeuraLUTConfig(**d)


def _topology_to_meta(topology: tuple):
    """JSON-able form of ``ServeBundle.topology`` (tuples -> lists)."""
    def conv(o):
        return [conv(x) for x in o] if isinstance(o, tuple) else o
    return conv(topology)


class TableRegistry:
    """Save and load named ServeBundles under a root directory
    (checksummed; see the module docstring).  ``chaos`` checks the
    ``registry.load`` injection site on every load — the deterministic
    way to test a failing artifact store."""

    def __init__(self, root: str, *, keep: int = 3,
                 chaos: Optional[ChaosHarness] = None):
        self.root = Path(root)
        self.root.mkdir(parents=True, exist_ok=True)
        self.keep = keep
        self._chaos = chaos

    def _store(self, name: str) -> CheckpointStore:
        return CheckpointStore(str(self.root / name), keep=self.keep)

    def _manifest_meta(self, name: str, step: int) -> Dict[str, Any]:
        return json.loads(
            (self.root / name / f"step_{step:010d}" / "manifest.json")
            .read_text())["meta"]

    # -- write ------------------------------------------------------------

    def save(self, name: str, bundle: ServeBundle, *,
             version: int = 0) -> Path:
        # Flat (node, branch) order for a graph; the per-node grouping
        # is re-derived from the config's arities at load.
        tree = {
            "tables": [np.ascontiguousarray(t)
                       for t in _flat_arrays(bundle.tables)],
            "conn": [np.ascontiguousarray(_host(c)) for s in bundle.statics
                     for c in node_static_conns(s)],
            "in_log_s": np.asarray(bundle.in_log_s),
            "layer_log_s": [np.asarray(s) for s in bundle.layer_log_s],
        }
        meta = _json_native({
            "format": bundle.schema_version,
            "config": _cfg_to_meta(bundle.cfg),
            "fingerprint": config_fingerprint(bundle.cfg),
            "topology": _topology_to_meta(bundle.topology),
            **bundle.meta,
        })
        # Checksum every stored array (keyed exactly as the npz shard
        # lays them out) plus the manifest meta itself.
        flat, _ = _flatten(tree)
        meta["integrity"] = {
            "algo": INTEGRITY_ALGO,
            "arrays": {k: _array_digest(v) for k, v in flat.items()},
            "manifest_digest": _meta_digest(meta),
        }
        return self._store(name).save(version, tree, meta=meta)

    # -- read -------------------------------------------------------------

    def list_models(self) -> List[str]:
        return sorted(p.name for p in self.root.iterdir()
                      if p.is_dir() and CheckpointStore(
                          str(p), keep=0).latest_step() is not None)

    def has(self, name: str) -> bool:
        d = self.root / name
        return d.is_dir() and self._store(name).latest_step() is not None

    def versions(self, name: str, *, detail: bool = False) -> List:
        """Committed versions of a model, ascending — the hot-swap
        deployment path (serve/tenants.py) picks its candidate here.
        ``detail=True`` returns one dict per version with its on-disk
        ``schema_version`` (1 = chain, 2 = LUT graph) and ``topology``
        from the manifest, without loading any tables; a manifest
        without a topology record gets one from its config."""
        if not (self.root / name).is_dir():
            return []
        steps = self._store(name).list_steps()
        if not detail:
            return steps
        out = []
        for step in steps:
            meta = self._manifest_meta(name, step)
            topo = meta.get("topology")
            if topo is None:
                cfg_d = meta.get("config", {})
                topo = ["chain", list(cfg_d.get("layer_widths", []))]
            out.append({"version": step,
                        "schema_version": meta.get("format"),
                        "topology": topo})
        return out

    def load(self, name: str, *, version: Optional[int] = None,
             verify: bool = True,
             shard_replicas: Optional[int] = None,
             shard_mode: str = "auto") -> ServeBundle:
        """The newest committed version (or ``version``), verified
        against its checksums unless ``verify=False``, packed and ready
        to serve; with ``shard_replicas`` its layout over that many
        devices is planned here too (``ServeBundle.plan_shards``)."""
        store = self._store(name)
        step = store.latest_step() if version is None else version
        if step is None:
            raise FileNotFoundError(f"no committed bundle '{name}' under "
                                    f"{self.root}")
        if self._chaos is not None:
            self._chaos.check("registry.load", detail=f"{name} v{step}")
        meta = self._manifest_meta(name, step)
        fmt = meta.get("format")
        if fmt not in SUPPORTED_FORMATS:
            raise ValueError(f"bundle '{name}' has format {fmt}, "
                             f"supported: {SUPPORTED_FORMATS}")
        if verify and meta.get("integrity") is not None:
            report = self._verify_dir(name, step)
            if not report["ok"]:
                raise BundleIntegrityError(
                    name, step, f"mismatched: {report['bad']}")
        cfg = _cfg_from_meta(meta["config"])
        nl = cfg.num_layers
        arities = ([nd.arity for nd in cfg.nodes]
                   if fmt == GRAPH_BUNDLE_FORMAT else [1] * nl)
        flat = sum(arities)
        template = {"tables": [0] * flat, "conn": [0] * flat,
                    "in_log_s": 0, "layer_log_s": [0] * nl}
        try:
            tree = store.restore(template, step=step)[1]
        except Exception as e:
            # A shard that fails to read (truncated zip, missing key)
            # is a corrupt artifact: the same typed refusal as a
            # checksum mismatch.
            raise BundleIntegrityError(
                name, step, f"shard unreadable: {e}") from e
        if fmt == GRAPH_BUNDLE_FORMAT:
            tables: List = []
            statics: List[Dict[str, Any]] = []
            pos = 0
            for a in arities:
                tables.append(list(tree["tables"][pos:pos + a]))
                statics.append({"conns": list(tree["conn"][pos:pos + a])})
                pos += a
        else:
            tables = list(tree["tables"])
            statics = [{"conn": c} for c in tree["conn"]]
        if cfg.kind == "poly":
            for i, s in enumerate(statics):
                s["exps"] = monomial_exponents(cfg.layer_fan_in(i),
                                               cfg.degree)
        extra = {k: v for k, v in meta.items()
                 if k not in ("format", "config", "fingerprint",
                              "topology")}
        bundle = ServeBundle(
            cfg=cfg, tables=tables, statics=statics,
            in_log_s=np.asarray(tree["in_log_s"], np.float32),
            layer_log_s=[np.asarray(s, np.float32)
                         for s in tree["layer_log_s"]],
            meta=extra).prepack()
        if shard_replicas is not None:
            # Multi-device deployments plan once, at load.
            bundle.plan_shards(shard_replicas, mode=shard_mode)
        return bundle

    # -- integrity --------------------------------------------------------

    def verify(self, name: str, *, version: Optional[int] = None
               ) -> Dict[str, Any]:
        """Recompute one version's checksums from disk (the latest when
        ``version`` is None).  Never raises — probes call this in a loop
        — the report carries ``ok``, the per-array ``checked`` count, the
        offending ``bad`` keys, and ``legacy`` (True for a bundle without
        an integrity record, which verifies vacuously)."""
        if version is None:
            version = self._store(name).latest_step()
            if version is None:
                return {"name": name, "version": -1, "ok": False,
                        "checked": 0, "bad": ["no committed version"],
                        "legacy": False}
        return self._verify_dir(name, version)

    def _verify_dir(self, name: str, step: int) -> Dict[str, Any]:
        path = self.root / name / f"step_{step:010d}"
        report: Dict[str, Any] = {"name": name, "version": step,
                                  "ok": True, "checked": 0, "bad": [],
                                  "legacy": False}
        try:
            meta = json.loads((path / "manifest.json").read_text())["meta"]
        except Exception as e:
            report["ok"] = False
            report["bad"].append(f"manifest unreadable: {e}")
            return report
        integ = meta.get("integrity")
        if integ is None:
            report["legacy"] = True
            return report
        if _meta_digest(meta) != integ.get("manifest_digest"):
            report["ok"] = False
            report["bad"].append("manifest_digest")
        try:
            with np.load(path / "shard_0.npz") as data:
                for key in sorted(integ.get("arrays", {})):
                    try:
                        got = _array_digest(data[key])
                    except Exception:
                        report["ok"] = False
                        report["bad"].append(key)
                        continue
                    report["checked"] += 1
                    if got != integ["arrays"][key]:
                        report["ok"] = False
                        report["bad"].append(key)
        except Exception as e:
            report["ok"] = False
            report["bad"].append(f"shard unreadable: {e}")
        return report

    def quarantine(self, name: str, version: int) -> Path:
        """Move one version out of the committed namespace (renamed to
        ``quarantined_step_*``, which ``list_steps``/``latest_step``
        never match) so ``load`` falls back to the newest intact
        version.  The bytes are kept for post-mortem, not deleted."""
        src = self.root / name / f"step_{version:010d}"
        if not src.is_dir():
            raise FileNotFoundError(f"no version {version} of '{name}' "
                                    f"under {self.root}")
        dst = self.root / name / f"quarantined_step_{version:010d}"
        if dst.exists():
            shutil.rmtree(dst)
        src.rename(dst)
        return dst


class IntegrityProbe:
    """Background artifact prober: the serving-side analogue of
    ``runtime.fault.ReplicaHealthTracker``, for stored bundles.

    Periodically re-verifies every committed version of the watched
    models (all models when ``names`` is None); a version that fails is
    quarantined (``auto_quarantine=True``) so the next ``load`` serves
    the newest intact version, and ``on_corrupt(name, version, report)``
    fires for operator alerting.  Both are exception-guarded — a probe
    must never die on the artifact it is probing.  ``run_once()`` is
    the synchronous entry."""

    def __init__(self, registry: TableRegistry,
                 names: Optional[List[str]] = None, *,
                 interval_s: float = 60.0,
                 on_corrupt: Optional[Callable[[str, int, Dict], None]]
                 = None,
                 auto_quarantine: bool = True):
        self.registry = registry
        self.names = list(names) if names is not None else None
        self.interval_s = interval_s
        self.on_corrupt = on_corrupt
        self.auto_quarantine = auto_quarantine
        self._stop = threading.Event()
        self._thread: Optional[threading.Thread] = None
        self._lock = threading.Lock()
        self._corrupt: List[Dict[str, Any]] = []
        self._sweeps = 0

    def run_once(self) -> List[Dict[str, Any]]:
        """One full sweep; returns the corrupt-version reports found."""
        found: List[Dict[str, Any]] = []
        names = (self.names if self.names is not None
                 else self.registry.list_models())
        for name in names:
            for step in list(self.registry.versions(name)):
                report = self.registry.verify(name, version=step)
                if report["ok"]:
                    continue
                found.append(report)
                if self.auto_quarantine:
                    try:
                        self.registry.quarantine(name, step)
                    except Exception:
                        pass
                if self.on_corrupt is not None:
                    try:
                        self.on_corrupt(name, step, report)
                    except Exception:
                        pass
        with self._lock:
            self._corrupt.extend(found)
            self._sweeps += 1
        return found

    def status(self) -> Dict[str, Any]:
        with self._lock:
            return {"sweeps": self._sweeps,
                    "corrupt": list(self._corrupt),
                    "running": self._thread is not None}

    def start(self) -> "IntegrityProbe":
        if self._thread is None:
            self._stop.clear()
            self._thread = threading.Thread(
                target=self._loop, daemon=True, name="bundle-integrity")
            self._thread.start()
        return self

    def stop(self, timeout: Optional[float] = 60.0) -> None:
        if self._thread is not None:
            self._stop.set()
            self._thread.join(timeout)
            self._thread = None

    def _loop(self) -> None:
        while not self._stop.is_set():
            try:
                self.run_once()
            except Exception:
                pass  # a probing error must not kill the prober
            self._stop.wait(self.interval_s)
