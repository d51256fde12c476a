"""A training step over a (pod?, data, model) mesh of processes: ZeRO-3
driven by the partition rules, with the model axis's compute split.

The reference is single-controller GSPMD: it places every param by
``param_partition`` and every batch by ``batch_partition`` and lets XLA
insert the gathers and reductions, so a sharded step is by construction
the single-device step laid out across devices.  The port is one
process per device over ``torch.distributed`` and keeps that contract,
a step over a mesh equals one process at the same global batch:

* storage: each rank keeps only its shard of every param and of AdamW's
  ``m``, ``v`` and float32 ``master``, the shard that the leaf's
  PartitionSpec names over the whole mesh (the data axes: FSDP; the
  model axis);
* compute: each rank runs the ``train.step`` loss and backward on its
  rows of the global batch (``local_batch``; ranks along the model axis
  hold the same rows) under a ``tensor_parallel.StepLayout``: the model
  gathers each block's leaves over the data axes inside the block's
  checkpointed function, so that the backward gathers them again, and
  the embedding, the head and the final norm once per step; the
  gather's backward sums the gradient over the data ranks in float32,
  divides by their count and keeps the rank's block;
* the model axis splits attention heads (``wq``/``wk``/``wv`` by
  columns, ``wo`` by rows; kv heads that do not divide the axis are
  gathered from their owners), MLA's heads (``wq``/``w_uk``/``w_uv`` by
  columns, ``wo`` by rows; the latent projections whole), the dense
  FFN's units, an MoE's experts (expert parallelism over the padded
  experts, or each expert's units under ``sharding="tp"``; the router
  whole) and its shared experts' units, Mamba's channels (``w_in``
  regathered for the rank's x and z columns, ``w_x`` and ``w_out`` by
  rows), whisper's encoder and cross attention as its self-attention,
  and the vocabulary (a vocabulary-parallel embedding and loss),
  Megatron's column and row splits (``sharding.tensor_parallel``);
* the ``compress_grads`` hook sees the averaged gradient gathered whole
  (the reference's hook sees the logical global one), the clip norm is
  summed over the whole mesh from each rank's shards (each element
  once), and each rank runs AdamW on its own shards.

The decode step (``make_mesh_serve_step``) splits the same parts under
the same layout, each rank keeping its model block of every cache leaf
that ``cache_partition`` puts on the model axis: K/V caches by kv heads,
or by head_dim where the kv heads do not divide the axis (the scores'
parts summed over it), Mamba's states by channel (and xLSTM's leaves
that the rules put there, gathered for its whole layer); MLA's latent
cache and whisper's caches are off the axis.

Still whole over the model axis, gathered per layer (ROADMAP.md, Queue
A, item 11): xLSTM, attention or MLA whose heads do not divide the
axis, and Mamba whose channels do not.

Collectives run over the mesh's process groups.  Under gloo a CUDA
tensor is staged through pinned host memory for every collective
(gloo reduces and gathers host buffers); under NCCL they run on the
card.  With one rank on an axis a collective over it is the identity,
and no split op runs, so a one-process mesh is the plain step bit for
bit.
"""
from __future__ import annotations

import math
from typing import Any, Callable, Dict, List, Optional, Tuple

import numpy as np
import torch

from repro_torch.config import MeshConfig
from repro_torch.device import resolve_device
from repro_torch.sharding import ctx, tensor_parallel
from repro_torch.sharding.partition import (NamedSharding, PartitionSpec,
                                            batch_partition, named,
                                            param_partition)

Axes = Tuple[str, ...]


def _as_axes(names) -> Axes:
    if names is None:
        return ()
    return (names,) if isinstance(names, str) else tuple(names)


class ProcessMesh:
    """The processes of the open group laid out as ``mcfg.shape`` over
    ``mcfg.axes``, rank-major (rank r sits at ``np.unravel_index(r,
    shape)``, as ``init_device_mesh`` lays it out).  Without an open
    group it is the one-process mesh of a shape of ones.

    ``device_mesh`` is the ``torch.distributed.device_mesh.DeviceMesh``
    over the same ranks (named by the axes; ``None`` without a group);
    ``group(axes)`` is the process group over which ``axes`` vary, the
    other coordinates this rank's, made once per axis tuple by every
    rank in the same order.  ``device`` is this rank's compute device,
    resolved as every entry point resolves it (``None``: the card; the
    CPU only when named)."""

    def __init__(self, mcfg: MeshConfig, device=None):
        import torch.distributed as dist
        self.config = mcfg
        self.shape = tuple(int(s) for s in mcfg.shape)
        self.axes = tuple(mcfg.axes)
        self.device = resolve_device(device)
        joined = dist.is_available() and dist.is_initialized()
        self.world = dist.get_world_size() if joined else 1
        self.rank = dist.get_rank() if joined else 0
        if self.world != mcfg.num_devices:
            need = mcfg.num_devices
            raise ValueError(
                f"mesh {self.shape} over axes {self.axes} needs {need} "
                f"process{'es' if need > 1 else ''}; the world has "
                f"{self.world}" + ("" if joined else
                                   " (no process group is open)")
                + ": start one process per device (torchrun "
                  f"--nproc-per-node {need}) or pick a shape of "
                  f"{self.world} device{'s' if self.world > 1 else ''}")
        self.backend = dist.get_backend() if joined else None
        # gloo reduces and gathers host buffers
        self.stage = self.backend == "gloo" and self.device.type == "cuda"
        self.coords = tuple(int(c) for c in np.unravel_index(self.rank,
                                                             self.shape))
        self._groups: Dict[Axes, Any] = {}
        self.device_mesh = None
        if joined:
            from torch.distributed.device_mesh import init_device_mesh
            self.device_mesh = init_device_mesh(
                "cuda" if self.device.type == "cuda" else "cpu",
                self.shape, mesh_dim_names=self.axes)
            for ax in self.axes:
                self.group((ax,))
            self.group(mcfg.data_axes)

    # -- layout -----------------------------------------------------------

    @property
    def data_axes(self) -> Axes:
        return self.config.data_axes

    def size(self, axes) -> int:
        return math.prod(self.shape[self.axes.index(a)]
                         for a in _as_axes(axes))

    def index(self, axes) -> int:
        """This rank's index over ``axes``, flattened major to minor."""
        i = 0
        for a in _as_axes(axes):
            k = self.axes.index(a)
            i = i * self.shape[k] + self.coords[k]
        return i

    def _live(self, axes) -> Axes:
        """``axes`` without those of size 1 (they move nothing)."""
        return tuple(a for a in _as_axes(axes) if self.size(a) > 1)

    def group(self, axes):
        """(process group over ``axes``, their flattened index of each of
        its group ranks) or None when ``axes`` span one rank."""
        live = self._live(axes)
        if not live:
            return None
        if live in self._groups:
            return self._groups[live]
        import torch.distributed as dist
        ranks = np.arange(self.world).reshape(self.shape)
        ks = [self.axes.index(a) for a in live]
        rest = [k for k in range(len(self.axes)) if k not in ks]
        rows = ranks.transpose(rest + ks).reshape(-1, self.size(live))
        if len(live) == 1 and self.device_mesh is not None:
            grp = self.device_mesh.get_group(live[0])
        else:
            grp, _ = dist.new_subgroups_by_enumeration(rows.tolist())
        mine = next(r for r in rows.tolist() if self.rank in r)
        order = [mine.index(g) for g in dist.get_process_group_ranks(grp)]
        self._groups[live] = (grp, order)
        return self._groups[live]

    # -- collectives --------------------------------------------------------

    def _host(self, t: torch.Tensor) -> torch.Tensor:
        if not self.stage:
            return t.contiguous()
        h = torch.empty(t.shape, dtype=t.dtype, pin_memory=True)
        return h.copy_(t)

    def all_reduce(self, t: torch.Tensor, op: str, axes) -> torch.Tensor:
        """A new tensor: ``t`` reduced (``"sum"`` or ``"max"``) over the
        ranks that ``axes`` span."""
        g = self.group(axes)
        if g is None:
            return t.clone()
        import torch.distributed as dist
        h = self._host(t)
        if h is t:
            h = t.clone()
        dist.all_reduce(h, op={"sum": dist.ReduceOp.SUM,
                               "max": dist.ReduceOp.MAX}[op], group=g[0])
        return h.to(t.device) if self.stage else h

    def all_reduce_f32(self, t: torch.Tensor, axes) -> torch.Tensor:
        """``t`` summed over the ranks that ``axes`` span in float32 (a
        float64 ``t`` in float64), cast back to its dtype (gloo takes no
        bfloat16)."""
        acc = torch.promote_types(t.dtype, torch.float32)
        return self.all_reduce(t.to(acc), "sum", axes).to(t.dtype)

    def all_gather(self, t: torch.Tensor, axes) -> List[torch.Tensor]:
        """Every rank's ``t`` over ``axes``, in flattened index order.
        Moved as bytes, so any dtype goes (gloo takes no bfloat16)."""
        g = self.group(axes)
        if g is None:
            return [t]
        import torch.distributed as dist
        h = self._host(t.contiguous().reshape(-1).view(torch.uint8))
        outs = [torch.empty_like(h) for _ in g[1]]
        dist.all_gather(outs, h, group=g[0])
        by_index = [None] * len(outs)
        for o, i in zip(outs, g[1]):
            by_index[i] = o.to(t.device).view(t.dtype).reshape(t.shape)
        return by_index

    def barrier(self) -> None:
        if self.world > 1:
            import torch.distributed as dist
            dist.barrier()

    def any(self, flag: bool) -> bool:
        """Whether ``flag`` is true on any rank of the world."""
        if self.world == 1:
            return bool(flag)
        t = torch.tensor([1 if flag else 0], dtype=torch.int32,
                         device=torch.device("cpu") if self.stage
                         else self.device)
        return bool(self.all_reduce(t, "max", self.axes).item())


# ---------------------------------------------------------------------------
# Shards of one leaf, and of trees


def _dim_axes(spec: PartitionSpec) -> List[Axes]:
    return [_as_axes(s) for s in spec]


def local_shard(mesh: ProcessMesh, t: torch.Tensor,
                spec: PartitionSpec) -> torch.Tensor:
    """This rank's block of the whole leaf ``t`` (a copy; ``t`` itself
    when the spec splits nothing on this mesh)."""
    out = t
    for d, axes in enumerate(_dim_axes(spec)):
        n = mesh.size(axes)
        if n == 1:
            continue
        if t.shape[d] % n:
            raise ValueError(f"dim {d} of {tuple(t.shape)} does not split "
                             f"over {axes} ({n} ranks)")
        k = t.shape[d] // n
        out = out.narrow(d, mesh.index(axes) * k, k)
    return out if out is t else out.clone()


def gather_leaf(mesh: ProcessMesh, t: torch.Tensor,
                spec: PartitionSpec) -> torch.Tensor:
    """The whole leaf from every rank's block of it (a collective)."""
    for d, axes in enumerate(_dim_axes(spec)):
        if mesh.size(axes) > 1:
            t = torch.cat(mesh.all_gather(t, axes), dim=d)
    return t


def _zip(fn: Callable, tree, shardings):
    """``fn(leaf, sharding)`` over ``tree``, its structure kept (tuples
    stay tuples), ``None`` kept."""
    if tree is None:
        return None
    if isinstance(tree, dict):
        return {k: _zip(fn, tree[k], shardings[k]) for k in tree}
    if isinstance(tree, (list, tuple)):
        return type(tree)(_zip(fn, t, s) for t, s in zip(tree, shardings))
    return fn(tree, shardings)


def shard_tree(tree, shardings):
    """Every leaf's local shard by its ``NamedSharding``."""
    return _zip(lambda t, s: local_shard(s.mesh, t, s.spec), tree, shardings)


def gather_tree(tree, shardings):
    """Every leaf whole (a collective on every rank)."""
    return _zip(lambda t, s: gather_leaf(s.mesh, t, s.spec), tree, shardings)


def tree_bytes(tree) -> int:
    """Bytes of the leaves of a tree, tensors or ``TensorSpec``s
    (``None`` holds none)."""
    if tree is None:
        return 0
    if isinstance(tree, dict):
        return sum(tree_bytes(v) for v in tree.values())
    if isinstance(tree, (list, tuple)):
        return sum(tree_bytes(v) for v in tree)
    return math.prod(tree.shape) * tree.dtype.itemsize


def opt_shardings(opt_state: Dict, param_sh) -> Dict:
    """AdamW state laid out as its params (``count`` replicated)."""
    mesh = _first_mesh(param_sh)
    out = {"m": param_sh, "v": param_sh,
           "count": NamedSharding(mesh, PartitionSpec())}
    if "master" in opt_state:
        out["master"] = _zip(lambda m, s: s, opt_state["master"], param_sh)
    return out


def _first_mesh(shardings):
    while isinstance(shardings, (dict, list, tuple)):
        shardings = (next(iter(shardings.values()))
                     if isinstance(shardings, dict) else shardings[0])
    return shardings.mesh


def param_shardings(cfg, params, mesh: ProcessMesh, *, fsdp: bool = True):
    """``named(mesh, param_partition(...))`` over the params in hand."""
    return named(mesh, param_partition(cfg, params, mesh.config, fsdp=fsdp))


# ---------------------------------------------------------------------------
# Batches


def local_batch(batch: Dict[str, torch.Tensor], mesh: ProcessMesh, cfg,
                shape, *, grad_accum: int = 1) -> Dict[str, torch.Tensor]:
    """This rank's rows of the global ``batch`` by ``batch_partition``.
    With ``grad_accum`` microbatches each rank takes its block of every
    global microbatch, so that its i-th microbatch is a slice of the
    single process's i-th one (the MoE aux loss of a microbatch is
    taken over the whole microbatch)."""
    specs = batch_partition(cfg, shape, mesh.config, batch)
    out = {}
    for k, x in batch.items():
        axes = _as_axes(specs[k][0]) if len(specs[k]) else ()
        n = mesh.size(axes)
        if n == 1:
            out[k] = x
            continue
        b = x.shape[0]
        if b % (n * grad_accum):
            raise ValueError(
                f"batch of {b} rows does not split into {grad_accum} "
                f"microbatches over {n} data ranks")
        blocks = x.reshape(grad_accum, n, b // (n * grad_accum),
                           *x.shape[1:])
        out[k] = blocks[:, mesh.index(axes)].reshape(b // n, *x.shape[1:])
    return out


class _AllReduceSum(torch.autograd.Function):
    """Sum over ranks whose backward sums the gradients over the same
    ranks: averaged over the data ranks afterwards, the gradient of a
    statistic of the whole batch is that of the single process."""

    @staticmethod
    def forward(fctx, t, mesh, axes):
        fctx.mesh, fctx.axes = mesh, axes
        return mesh.all_reduce(t, "sum", axes)

    @staticmethod
    def backward(fctx, grad):
        return fctx.mesh.all_reduce(grad, "sum", fctx.axes), None, None


def batch_mean(t: torch.Tensor) -> torch.Tensor:
    """``t``, a mean over this rank's rows, as the mean over the rows of
    every rank that splits the batch (equal shares), with its gradient;
    ``t`` itself when the batch is not split."""
    axes = ctx.batch_split_axes()
    mesh = ctx.get_active_mesh()
    if not axes or mesh.size(axes) == 1:
        return t
    return _AllReduceSum.apply(t, mesh, axes) / mesh.size(axes)


def batch_counts_before(counts: torch.Tensor):
    """(ranks that split the batch, the sum of ``counts`` over the ranks
    before this one): 1 and 0 when the batch is not split."""
    axes = ctx.batch_split_axes()
    mesh = ctx.get_active_mesh()
    if not axes or mesh.size(axes) == 1:
        return 1, 0
    parts = mesh.all_gather(counts, axes)
    return len(parts), sum(parts[:mesh.index(axes)],
                           torch.zeros_like(counts))


# ---------------------------------------------------------------------------
# The step


def _mean_over(mesh: ProcessMesh, t: torch.Tensor, axes) -> torch.Tensor:
    n = mesh.size(axes)
    if n == 1:
        return t
    s = mesh.all_reduce(t.to(torch.float32), "sum", axes)
    return (s / n).to(t.dtype)


def grad_sq(mesh: ProcessMesh, grads, shardings) -> torch.Tensor:
    """The whole gradient's squared norm (float64) from this rank's
    shards: each leaf's elements are counted once, by the rank at index
    0 of every axis that the leaf's spec does not split, and the ranks'
    sums are added in rank order on every rank.  One process: the sum
    ``adamw_update`` takes over the tree."""
    from repro_torch.optim.adamw import tree_sq
    from repro_torch.tree import tree_leaves
    own = []
    for g, s in zip(tree_leaves(grads), tree_leaves(shardings)):
        named_axes = {a for p in s.spec for a in _as_axes(p)}
        if all(c == 0 for a, c in zip(mesh.axes, mesh.coords)
               if a not in named_axes):
            own.append(g)
    local = tree_sq(own)
    if not torch.is_tensor(local):      # this rank owns no element
        local = torch.zeros((), dtype=torch.float64,
                            device=tree_leaves(grads)[0].device)
    if mesh.world == 1:
        return local
    parts = mesh.all_gather(local.reshape(1), mesh.axes)
    return sum(parts[1:], parts[0]).reshape(())


def mesh_loss_and_grads(loss_fn, mesh: ProcessMesh, shardings, params_s,
                        batch, accum: int, split):
    """(gradient shards averaged over the data ranks, (loss, metrics)):
    the loss on this rank's rows under the step's layout (per-layer
    gathers, the model axis split), differentiated with respect to the
    shards."""
    from repro_torch.train.step import loss_and_grads
    with ctx.active_mesh(mesh, data_axes=mesh.data_axes), \
            ctx.batch_split(split), \
            tensor_parallel.step_layout(mesh, shardings):
        return loss_and_grads(loss_fn, params_s, batch, accum)


def make_mesh_train_step(cfg, tcfg, mesh: ProcessMesh, shardings, shape, *,
                         q_chunk: int = 512,
                         compress_grads: Optional[Callable] = None):
    """step(param shards, opt shards, local batch) -> (param shards, opt
    shards, metrics); ``shardings`` are the params' (``param_shardings``),
    ``shape`` the global batch's ``ShapeConfig``; the local batch is
    ``local_batch``'s.  Metrics are the data ranks' means (the global
    batch's)."""
    from repro_torch.optim import adamw_update, sgdr_schedule
    from repro_torch.optim.adamw import tree_sq
    from repro_torch.train.step import make_loss_fn

    loss_fn = make_loss_fn(cfg, tcfg, q_chunk=q_chunk)
    dax = mesh.data_axes
    n_data = mesh.size(dax)
    # batch_partition's rule: rows split over the data axes where the
    # global batch divides them, else every rank holds them all
    split = dax if n_data > 1 and shape.global_batch % n_data == 0 else None

    def step(params_s, opt_s, batch):
        grads, (loss, metrics) = mesh_loss_and_grads(
            loss_fn, mesh, shardings, params_s, batch, tcfg.grad_accum,
            split)
        if compress_grads is not None:
            whole = compress_grads(gather_tree(grads, shardings))
            grads = shard_tree(whole, shardings)
            sq = tree_sq(whole)
        else:
            sq = grad_sq(mesh, grads, shardings)
        lr = sgdr_schedule(opt_s["count"], lr_max=tcfg.lr,
                           lr_min=tcfg.lr_min, t0=tcfg.sgdr_t0,
                           t_mult=tcfg.sgdr_t_mult)
        params_s, opt_s = adamw_update(
            grads, opt_s, params_s, lr=lr, beta1=tcfg.beta1,
            beta2=tcfg.beta2, eps=tcfg.eps, weight_decay=tcfg.weight_decay,
            grad_clip=tcfg.grad_clip, grad_sq=sq)
        metrics = {k: _mean_over(mesh, v, dax)
                   for k, v in dict(metrics, loss=loss).items()}
        return params_s, opt_s, dict(metrics, lr=lr)

    return step


# the decode state's stacked keys: their leaves' rows are dim 1
_STACKED_STATE = ("blocks", "self", "cross")


class _Kept:
    """How a rank holds one decode-state leaf in the step: ``spec``, the
    leaf's spec without the model axis and without the data axes where
    they split the rows, is what the rank gathers before the step and
    cuts back after it; ``rows``, the leaf's rows dim where the step's rows
    are split over the data axes but the spec splits another dim over
    them (a whisper cache's layers), so the rank cuts its rows after the
    gather and gathers them again after the step."""

    def __init__(self, mesh, sharding: NamedSharding, rows: int, split):
        dax = set(mesh.data_axes)
        spec = list(sharding.spec)
        own = (split is not None and len(spec) > rows
               and set(_as_axes(spec[rows])) == dax)
        self.mesh = mesh
        self.spec = PartitionSpec(*(
            None if "model" in _as_axes(p) or (own and d == rows) else p
            for d, p in enumerate(spec)))
        self.rows = rows if (split is not None and len(spec) > rows
                             and not own) else None
        self.split = split

    def take(self, t: torch.Tensor) -> torch.Tensor:
        t = gather_leaf(self.mesh, t, self.spec)
        if self.rows is None:
            return t
        k = t.shape[self.rows] // self.mesh.size(self.split)
        return t.narrow(self.rows, self.mesh.index(self.split) * k, k)

    def give(self, t: torch.Tensor) -> torch.Tensor:
        if self.rows is not None:
            t = torch.cat(self.mesh.all_gather(t, self.split), dim=self.rows)
        return local_shard(self.mesh, t, self.spec)


def _state_kept(mesh: ProcessMesh, cache_shardings, split):
    """``_Kept`` of every decode-state leaf (a tree of the state's
    structure)."""
    from repro_torch.sharding.partition import map_with_path

    def kept(path, s):
        rows = 1 if any(k in _STACKED_STATE for k in path) else 0
        return _Kept(mesh, s, rows, split)

    return map_with_path(kept, cache_shardings)


def make_mesh_serve_step(cfg, mesh: ProcessMesh, shardings, cache_shardings,
                         shape):
    """step(param shards, state shards, local token) -> (local logits,
    state shards): one decode step over the mesh, split over the model
    axis as ``make_mesh_train_step``'s loss is.  ``decode_step`` runs on
    the rank's rows (``local_batch``'s token) under the params' layout:
    it gathers each block's leaves over the data axes before the block
    and keeps the model block of the parts it computes split.  A state
    leaf keeps its model block (``cache_partition``'s layout,
    ``cache_shardings``): K/V caches by kv heads or by head_dim, Mamba's
    ``h`` and ``conv`` by channel; what the data axes split besides the
    rows (a long context's sequence) is gathered for the step and cut
    back after it (``_Kept``).  Ranks along the model axis decode the
    same rows, and each returns their logits at the whole vocabulary."""
    from repro_torch.train.step import make_serve_step

    serve = make_serve_step(cfg)
    n_data = mesh.size(mesh.data_axes)
    split = (mesh.data_axes if n_data > 1
             and shape.global_batch % n_data == 0 else None)
    kept = _state_kept(mesh, cache_shardings, split)

    def step(params_s, state_s, token):
        state = _zip(lambda t, k: k.take(t), state_s, kept)
        with ctx.active_mesh(mesh, data_axes=mesh.data_axes), \
                ctx.batch_split(split), \
                tensor_parallel.step_layout(mesh, shardings):
            logits, new = serve(params_s, state, token)
        del state
        return logits, _zip(lambda t, k: k.give(t), new, kept)

    return step


__all__ = ["ProcessMesh", "batch_counts_before", "batch_mean", "gather_leaf",
           "gather_tree", "grad_sq", "local_batch", "local_shard",
           "mesh_loss_and_grads",
           "make_mesh_serve_step", "make_mesh_train_step", "opt_shardings",
           "param_shardings", "shard_tree", "tree_bytes"]
