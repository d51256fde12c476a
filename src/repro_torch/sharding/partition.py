"""Sharding rules: config + param tree -> PartitionSpec tree (port of
``repro.sharding.partition``), pure Python over names and shapes.

The layout is the reference's megatron/FSDP hybrid on a (pod?, data,
model) mesh:

  * TP ("model"): attention heads / FFN hidden / MoE experts / vocab.
  * DP+FSDP (("pod","data")): batch dim of activations; the non-TP dim of
    every large parameter is additionally sharded over the data axes
    (ZeRO-3).
  * EP: MoE expert dim on "model" (padded to divisibility).
  * SP (context parallelism): for decode shapes whose batch does not cover
    the data axes (long_500k has batch=1), KV caches shard their *sequence*
    dim over the data axes instead.

Rules are name-based over the tree paths (dict keys; list indices are
dropped for params, as the reference's ``_path_names`` filter drops
them); every rule degrades to replication when a dim is not divisible
by the axis size, so any architecture lays out on any mesh.  A leaf is
anything with a ``shape`` (a tensor or a ``TensorSpec``).

What the port does with a spec is ``sharding.spmd``'s: every rank
stores the shard of each leaf that the spec names over the whole mesh
and gathers it per layer over the data axes; where the spec puts
attention or MLA heads, dense FFN units, MoE experts (or their units),
shared experts' units, Mamba's channels or the vocabulary on "model"
the rank computes its block of them (``sharding.tensor_parallel``), and
the other layers (xLSTM, heads or channels that do not divide the axis)
are gathered whole over the model axis too (ROADMAP.md, Queue A).
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Any, Callable, Tuple

from repro_torch.config import MeshConfig, ModelConfig, ShapeConfig


class PartitionSpec(tuple):
    """The port's ``jax.sharding.PartitionSpec``: one entry per tensor
    dim, each ``None``, an axis name, or a tuple of axis names (major to
    minor).  A one-name tuple is stored as the name, as JAX stores it."""

    def __new__(cls, *parts):
        norm = [p[0] if isinstance(p, tuple) and len(p) == 1
                else (tuple(p) if isinstance(p, tuple) else p)
                for p in parts]
        return super().__new__(cls, norm)

    def __repr__(self) -> str:
        return f"PartitionSpec{tuple.__repr__(self)}"


P = PartitionSpec


def _axes_size(mesh_cfg: MeshConfig, names) -> int:
    if isinstance(names, str):
        names = (names,)
    n = 1
    for nm in names:
        n *= mesh_cfg.shape[mesh_cfg.axes.index(nm)]
    return n


def _div(dim: int, size: int) -> bool:
    return size > 0 and dim % size == 0


class Ruler:
    def __init__(self, cfg: ModelConfig, mesh_cfg: MeshConfig, fsdp: bool):
        self.cfg = cfg
        self.mesh_cfg = mesh_cfg
        self.model_size = _axes_size(mesh_cfg, "model")
        self.dax: Tuple[str, ...] = mesh_cfg.data_axes
        self.dsize = _axes_size(mesh_cfg, self.dax)
        self.fsdp_on = fsdp

    def model(self, dim: int):
        return "model" if _div(dim, self.model_size) else None

    def fsdp(self, dim: int):
        if not self.fsdp_on:
            return None
        return self.dax if _div(dim, self.dsize) else None


def _param_rule(names, shape, r: Ruler) -> PartitionSpec:
    """PartitionSpec for one leaf; ``names`` is the path of string keys."""
    name = names[-1]
    nd = len(shape)

    def pad(*spec):
        return P(*([None] * (nd - len(spec)) + list(spec)))

    # --- embeddings / head: no FSDP on the contraction dims (the
    # reference's note: GSPMD would otherwise all-reduce full logits).
    if name == "embed":
        if r.cfg.tie_embeddings:
            return P(r.model(shape[0]), None)
        return P(None, r.model(shape[1]))
    if name == "lm_head":
        return P(None, r.model(shape[1]))
    if name in ("vision_proj", "enc_in", "w_gates"):
        return pad(r.fsdp(shape[-2]), None)

    # --- MoE (expert-parallel)
    if name == "router":
        return pad(r.fsdp(shape[-2]), None)
    if "ffn" in names and name in ("w_gate", "w_up", "w_down") \
            and nd - _stack_off(names) == 3:
        if r.cfg.moe is not None and r.cfg.moe.sharding == "tp":
            if name == "w_down":
                return pad(None, r.model(shape[-2]), r.fsdp(shape[-1]))
            return pad(None, r.fsdp(shape[-2]), r.model(shape[-1]))
        if name == "w_down":
            return pad(r.model(shape[-3]), None, r.fsdp(shape[-1]))
        return pad(r.model(shape[-3]), r.fsdp(shape[-2]), None)
    if name in ("ws_gate", "ws_up"):
        return pad(r.fsdp(shape[-2]), r.model(shape[-1]))
    if name == "ws_down":
        return pad(r.model(shape[-2]), r.fsdp(shape[-1]))

    # --- attention / MLA
    if "mixer" in names or "self" in names or "cross" in names:
        if name in ("wq", "wk", "wv"):
            if _mixer_kind(names, r.cfg) in ("mlstm",):
                return pad(r.model(shape[-2]), None)
            return pad(r.fsdp(shape[-2]), r.model(shape[-1]))
        if name == "wo":
            return pad(r.model(shape[-2]), r.fsdp(shape[-1]))
        if name in ("w_dkv", "w_kr"):
            return pad(r.fsdp(shape[-2]), None)
        if name in ("w_uk", "w_uv"):
            return pad(None, r.model(shape[-1]))
        # mamba / mlstm
        if name in ("w_in", "w_up"):
            return pad(r.fsdp(shape[-2]), r.model(shape[-1]))
        if name == "conv_w":
            return pad(None, r.model(shape[-1]))
        if name in ("conv_b", "dt_bias", "d_skip", "skip"):
            return pad(r.model(shape[-1]))
        if name == "w_x":
            return pad(r.model(shape[-2]), None)
        if name == "w_dt":
            return pad(None, r.model(shape[-1]))
        if name == "a_log":
            return pad(r.model(shape[-2]), None)
        if name == "w_out":
            if _mixer_kind(names, r.cfg) == "slstm":
                return pad(None, None)
            return pad(r.model(shape[-2]), r.fsdp(shape[-1]))
        if name == "w_down":
            return pad(None, r.fsdp(shape[-1]))
        if name == "w_if":
            return pad(r.model(shape[-2]), None)

    # --- dense FFN
    if name in ("w_gate", "w_up"):
        return pad(r.fsdp(shape[-2]), r.model(shape[-1]))
    if name == "w_down":
        return pad(r.model(shape[-2]), r.fsdp(shape[-1]))

    # default: replicate (norms, biases, small tensors)
    return P(*([None] * nd))


def _stack_off(names) -> int:
    """1 if the leaf lives under a stacked block list, else 0."""
    return 1 if any(n in ("blocks", "enc_blocks", "dec_blocks")
                    for n in names) else 0


def _mixer_kind(names, cfg: ModelConfig) -> str:
    """Which mixer a leaf belongs to, from the config's mixer kinds and
    the leaf's name (the reference's heuristic, kept as it is)."""
    kinds = {s.mixer for s in cfg.pattern}
    if "mlstm" in kinds and "w_up" in _MLSTM_LEAVES.intersection({names[-1]}):
        return "mlstm"
    if kinds == {"slstm"}:
        return "slstm"
    if "mlstm" in kinds or "slstm" in kinds:
        # xlstm family: decide by leaf name
        if names[-1] in ("w_gates", "r_gates"):
            return "slstm"
        return "mlstm"
    return "other"


_MLSTM_LEAVES = {"w_up"}


def map_with_path(fn: Callable, tree, path: Tuple[str, ...] = ()) -> Any:
    """``fn(path, leaf)`` over a tree of dicts and lists, dict keys in
    sorted order; a list item's segment is ``"[i]"`` (the reference's
    ``_path_names``); ``None`` stays ``None`` (no leaf, as in JAX)."""
    if tree is None:
        return None
    if isinstance(tree, dict):
        return {k: map_with_path(fn, tree[k], path + (str(k),))
                for k in sorted(tree)}
    if isinstance(tree, (list, tuple)) and not isinstance(tree,
                                                          PartitionSpec):
        return [map_with_path(fn, t, path + (f"[{i}]",))
                for i, t in enumerate(tree)]
    return fn(path, tree)


def param_partition(cfg: ModelConfig, spec_tree, mesh_cfg: MeshConfig, *,
                    fsdp: bool = True):
    """PartitionSpec tree matching ``spec_tree``."""
    r = Ruler(cfg, mesh_cfg, fsdp)

    def assign(path, leaf):
        names = [n for n in path if not n.startswith("[")]
        return _param_rule(tuple(names), tuple(leaf.shape), r)

    return map_with_path(assign, spec_tree)


# ---------------------------------------------------------------------------
# Batches and caches


def batch_partition(cfg: ModelConfig, shape: ShapeConfig,
                    mesh_cfg: MeshConfig, batch_tree):
    """Every leaf's first dim over the data axes where it divides."""
    r = Ruler(cfg, mesh_cfg, True)

    def assign(path, leaf):
        nd = len(leaf.shape)
        b = leaf.shape[0] if nd else 0
        spec = [None] * nd
        if nd and _div(b, r.dsize):
            spec[0] = r.dax
        return P(*spec)

    return map_with_path(assign, batch_tree)


def cache_partition(cfg: ModelConfig, shape: ShapeConfig,
                    mesh_cfg: MeshConfig, state_tree):
    """Decode-state sharding with SP fallback for small batches."""
    r = Ruler(cfg, mesh_cfg, True)

    def assign(names, leaf):
        name = names[-1]
        lshape = tuple(leaf.shape)
        nd = len(lshape)
        if nd == 0:
            return P()
        off = 1 if _stack_off(names) else 0
        spec = [None] * nd
        base = lshape[off:] if off else lshape
        bdim = off  # batch dim index
        if name in ("k", "v", "c_kv", "k_rope"):
            # (B, T, ...) caches
            bsz, t = base[0], base[1]
            if _div(bsz, r.dsize):
                spec[bdim] = r.dax
            elif _div(t, r.dsize):
                spec[bdim + 1] = r.dax  # sequence/context parallel
            if name in ("k", "v") and len(base) == 4:
                kvh, hd = base[2], base[3]
                if _div(kvh, r.model_size):
                    spec[bdim + 2] = "model"
                elif _div(hd, r.model_size):
                    spec[bdim + 3] = "model"
        elif name == "h" and len(base) == 3:  # mamba (B, DI, N)
            if _div(base[0], r.dsize):
                spec[bdim] = r.dax
            if _div(base[1], r.model_size):
                spec[bdim + 1] = "model"
        elif name == "conv":  # (B, K-1, DI)
            if _div(base[0], r.dsize):
                spec[bdim] = r.dax
            if _div(base[2], r.model_size):
                spec[bdim + 2] = "model"
        else:  # mlstm/slstm states: (B, H, ...) — batch only
            if _div(base[0], r.dsize):
                spec[bdim] = r.dax
        return P(*spec)

    return map_with_path(assign, state_tree)


@dataclass(frozen=True)
class NamedSharding:
    """A leaf's layout: the mesh and its PartitionSpec (the reference's
    ``jax.sharding.NamedSharding``).  ``placements`` gives the DTensor
    placements on ``mesh.device_mesh``; ``sharding.spmd`` cuts and
    gathers shards by ``spec``."""

    mesh: Any
    spec: PartitionSpec

    @property
    def placements(self) -> tuple:
        return placements(self.mesh.axes, self.spec)


def placements(axes: Tuple[str, ...], spec: PartitionSpec) -> tuple:
    """One DTensor placement per mesh axis: ``Shard(d)`` where tensor
    dim ``d`` is split over the axis, else ``Replicate()``.  A dim split
    over several axes shards over each, major to minor, as DTensor
    splits a dim that two mesh dims shard."""
    from torch.distributed.tensor import Replicate, Shard
    out = []
    for ax in axes:
        dims = [d for d, s in enumerate(spec)
                if s == ax or (isinstance(s, tuple) and ax in s)]
        out.append(Shard(dims[0]) if dims else Replicate())
    return tuple(out)


def named(mesh, spec_tree):
    """PartitionSpec tree -> NamedSharding tree."""
    def one(_, s):
        return NamedSharding(mesh, s)
    return map_with_path(one, spec_tree)
