"""The model axis's split of the compute, and the per-layer gathers of a
mesh step (ZeRO-3).

The reference is GSPMD: XLA computes each matmul where
``param_partition`` placed its weight, so attention and MLA heads, FFN
units, MoE experts, Mamba's channels and the vocabulary split over
"model".  The port does the same by hand, in Megatron's column and row
splits, over what the partition rules already place on "model":

* ``copy_to_model`` (Megatron's f): the identity, whose backward sums
  the gradient over the model axis: it stands before a column-split
  product, whose input gradient is each rank's part of the whole;
* ``reduce_from_model`` (g): the sum over the model axis, whose backward
  is the identity: it follows a row-split product, whose output is each
  rank's part of the sum;
* ``gather_from_model``: the ranks' blocks of an activation (or of a
  weight whose block is not the columns the rank computes: Mamba's
  joined ``w_in``) concatenated along a dim; the backward keeps the
  rank's block of the gradient, summed over the model ranks first where
  each rank's gradient is only its part (``grad="sum"``).

Sums run in float32 (float64 for float64 parts) and are cast back;
gathers move bytes (gloo takes no bfloat16 on every build).  Every
collective is ``ProcessMesh``'s ``all_reduce_f32``, ``all_reduce`` or
``all_gather``.

A split sums its parts in another order than one process's product, so
at float32 it adds rounding of its own.  The dense layers keep it: their
float32 products round as the reference's dots do (the dense LM's step
is held to the reference's), and the reference's GSPMD split rounds its
parts in float32 too.  Mamba and whisper's encoder and cross attention
take ``wide`` operands instead, on the whole path as on the split one:
each product whose sum the model axis cuts (a row-split product's
output, a column-split product's input gradient, the sums over Mamba's
channels) accumulates in float64 and is rounded once, after the sum over
the ranks, so the two paths differ by float64 rounding only.  Their cut
sums feed every channel (Mamba's B, C and dt) or every decoder layer
(the encoder's states), where the split's float32 rounding moved
AdamW's steps beyond a float32 step's limits.  A bfloat16 layer keeps
its dtype (``wide`` is the identity), its parts rounded to bfloat16
before the float32 sum.

Inside ``sharding.spmd.make_mesh_train_step``'s loss and
``make_mesh_serve_step``'s decode a ``StepLayout`` is active
(``step_layout``): the mesh and the params' shardings.  The
model code gathers a block's leaves inside the block's checkpointed
function (``gather_block``), so that the backward's recompute gathers
them again, and the embedding, the head and the final norm once per
step (``gather_top``).  A leaf is gathered over the data axes that its
spec names, and over the model axis too unless the block computes that
part of it split; the gather's backward sums the gradient over the data
ranks in float32, divides by their count and keeps the rank's own block
(the gradient of a leaf gathered whole over the model axis is the same
on every model rank, so that block is kept as it is).

The layers decide by their weights' shapes: a weight narrower than its
config's width is the rank's model block, and the layer runs split.
With no layout active, or one rank on the model axis, nothing is split
and no op of this module runs, so the layers take their plain code path.
"""
from __future__ import annotations

import contextlib
from typing import Any, Dict, Iterable, List, Optional, Tuple

import torch

from repro_torch.sharding.partition import PartitionSpec

MODEL = "model"

_LAYOUT: List["StepLayout"] = []


def _axes(names) -> Tuple[str, ...]:
    if names is None:
        return ()
    return (names,) if isinstance(names, str) else tuple(names)


class StepLayout:
    """The mesh of a training step and its params' shardings (a tree of
    ``NamedSharding`` of the params' structure)."""

    def __init__(self, mesh, shardings):
        self.mesh = mesh
        self.shardings = shardings
        self.data_axes = tuple(mesh.data_axes)
        self.n_data = mesh.size(self.data_axes)
        self.n_model = mesh.size(MODEL) if MODEL in mesh.axes else 1


@contextlib.contextmanager
def step_layout(mesh, shardings):
    """Within it the model code gathers per layer and splits the model
    axis's compute (process-wide: autograd recomputes on its own
    threads)."""
    _LAYOUT.append(StepLayout(mesh, shardings))
    try:
        yield _LAYOUT[-1]
    finally:
        _LAYOUT.pop()


def layout() -> Optional[StepLayout]:
    return _LAYOUT[-1] if _LAYOUT else None


def model_size() -> int:
    """Ranks on the model axis of the active step (1 without one)."""
    lay = layout()
    return 1 if lay is None else lay.n_model


def _model_mesh():
    lay = layout()
    if lay is None or lay.n_model == 1:
        raise RuntimeError("a layer got a model block of its weights "
                           "outside a step that splits the model axis")
    return lay.mesh


def model_rank() -> int:
    """This rank's index on the model axis of the active step."""
    return _model_mesh().index(MODEL)


# ---------------------------------------------------------------------------
# The split ops (Megatron's f and g, and the gather of an activation)


class _CopyToModel(torch.autograd.Function):
    @staticmethod
    def forward(fctx, x, mesh):
        fctx.mesh = mesh
        return x.view_as(x)

    @staticmethod
    def backward(fctx, g):
        return fctx.mesh.all_reduce_f32(g, MODEL), None


class _ReduceFromModel(torch.autograd.Function):
    @staticmethod
    def forward(fctx, x, mesh):
        return mesh.all_reduce_f32(x, MODEL)

    @staticmethod
    def backward(fctx, g):
        return g, None


class _GatherFromModel(torch.autograd.Function):
    @staticmethod
    def forward(fctx, x, mesh, dim, grad):
        fctx.mesh, fctx.dim, fctx.grad = mesh, dim, grad
        fctx.size = x.shape[dim]
        return torch.cat(mesh.all_gather(x, MODEL), dim=dim)

    @staticmethod
    def backward(fctx, g):
        mesh, dim = fctx.mesh, fctx.dim
        if fctx.grad == "sum":
            g = mesh.all_reduce_f32(g, MODEL)
        own = g.narrow(dim, mesh.index(MODEL) * fctx.size, fctx.size)
        return own.contiguous(), None, None, None


def wide(t: torch.Tensor) -> torch.Tensor:
    """``t`` in the dtype of a product whose sum the model axis may cut:
    float64 for float32, its own otherwise."""
    return t.to(torch.float64) if t.dtype == torch.float32 else t


def copy_to_model(x: torch.Tensor) -> torch.Tensor:
    """``x``, replicated over the model axis, entering column-split
    products: its gradient is summed over the model ranks."""
    return _CopyToModel.apply(x, _model_mesh())


def reduce_from_model(x: torch.Tensor) -> torch.Tensor:
    """The float32 (for float64, float64) sum of every model rank's
    ``x`` (a row-split product's part), cast back; the gradient passes
    as it is."""
    return _ReduceFromModel.apply(x, _model_mesh())


def gather_from_model(x: torch.Tensor, dim: int,
                      grad: str = "own") -> torch.Tensor:
    """Every model rank's ``x`` concatenated along ``dim`` in rank order.
    The backward keeps this rank's block of the gradient: as it is
    (``"own"``: every rank holds the whole gradient) or summed over the
    model ranks first (``"sum"``: each rank holds its part)."""
    if grad not in ("own", "sum"):
        raise ValueError(f"grad {grad!r}: 'own' or 'sum'")
    return _GatherFromModel.apply(x, _model_mesh(), dim % x.ndim, grad)


def max_over_model(x: torch.Tensor) -> torch.Tensor:
    """The elementwise max over the model ranks (no gradient)."""
    return _model_mesh().all_reduce(x.detach(), "max", MODEL)


# ---------------------------------------------------------------------------
# Per-layer gathers of the params


class _Gathers:
    """How one call gathers its leaves: per leaf, the dims to gather over
    the data axes and over the model axis."""

    def __init__(self, lay: StepLayout, specs: List[PartitionSpec],
                 whole: List[bool]):
        self.lay = lay
        self.data: List[Optional[int]] = []
        self.model: List[Optional[int]] = []
        dax = set(lay.data_axes)
        for spec, w in zip(specs, whole):
            d_dim = m_dim = None
            for d, s in enumerate(spec):
                ax = _axes(s)
                if not ax or lay.mesh.size(ax) == 1:
                    continue
                if MODEL in ax:
                    if w:
                        m_dim = d
                elif set(ax) <= dax:
                    d_dim = d
            self.data.append(d_dim)
            self.model.append(m_dim)

    def needed(self) -> bool:
        return self.lay.n_data > 1 or any(
            d is not None for d in self.data + self.model)

    def _gather(self, ts, dims, axes):
        """Each ``ts[i]`` whose ``dims[i]`` is set, concatenated over
        ``axes`` along it: one all-gather of the leaves' bytes."""
        todo = [i for i, d in enumerate(dims) if d is not None]
        if not todo:
            return ts
        mesh = self.lay.mesh
        flat = [ts[i].contiguous().reshape(-1).view(torch.uint8)
                for i in todo]
        parts = mesh.all_gather(torch.cat(flat), axes)
        out = list(ts)
        off = 0
        for i, f in zip(todo, flat):
            t, n = ts[i], f.numel()
            blocks = [p[off:off + n].view(t.dtype).reshape(t.shape)
                      for p in parts]
            out[i] = torch.cat(blocks, dim=dims[i])
            off += n
        return out

    def forward(self, shards):
        out = self._gather(list(shards), self.data, self.lay.data_axes)
        return self._gather(out, self.model, (MODEL,))

    def backward(self, grads):
        """Every gradient's float32 sum over the data ranks (one
        all-reduce) over their count, cast back, and this rank's block."""
        lay, mesh = self.lay, self.lay.mesh
        grads = list(grads)
        if lay.n_data > 1:
            flat = torch.cat([g.to(torch.float32).reshape(-1)
                              for g in grads])
            s = mesh.all_reduce(flat, "sum", lay.data_axes)
            off = 0
            for i, g in enumerate(grads):
                n = g.numel()
                grads[i] = (s[off:off + n] / lay.n_data).to(
                    g.dtype).reshape(g.shape)
                off += n
        for dims, axes in ((self.model, (MODEL,)),
                           (self.data, lay.data_axes)):
            for i, d in enumerate(dims):
                if d is None:
                    continue
                k = grads[i].shape[d] // mesh.size(axes)
                grads[i] = grads[i].narrow(d, mesh.index(axes) * k,
                                           k).contiguous()
        return grads


class _GatherLeaves(torch.autograd.Function):
    @staticmethod
    def forward(fctx, plan, *shards):
        fctx.plan = plan
        return tuple(plan.forward(shards))

    @staticmethod
    def backward(fctx, *grads):
        return (None,) + tuple(fctx.plan.backward(grads))


def _flatten(p, sh, split: Iterable[str], unstacked: bool):
    """(leaves, their specs, whether each is gathered whole over the
    model axis) of a block's dict of params; ``unstacked``: the specs
    are a stacked block's, one dim more.  A part computed split keeps
    each leaf that its spec puts on the model axis as the rank's block;
    its other leaves (an MoE router, MLA's latent projections) are
    whole there already and gathered over the data axes only."""
    from repro_torch.tree import tree_leaves
    split = set(split)
    leaves, specs, whole = [], [], []
    for k in sorted(p):
        ls = tree_leaves(p[k])
        ss = [s.spec for s in tree_leaves(sh[k])]
        if unstacked:
            ss = [PartitionSpec(*s[1:]) for s in ss]
        leaves += ls
        specs += ss
        whole += [k not in split] * len(ls)
    return leaves, specs, whole


def gather_block(p: Dict[str, Any], sh: Dict[str, Any],
                 split: Iterable[str] = (), *,
                 stacked: bool = False) -> Dict[str, Any]:
    """A block's params (this rank's shards) gathered for its compute,
    under the active ``StepLayout`` (``p`` itself without one): over the
    data axes; over the model axis unless the part (a key of ``p``) is
    in ``split``, whose leaves on the model axis stay the rank's block.
    ``sh``: the block's shardings, a stacked block's (one leading dim
    more in each spec) when ``stacked``."""
    from repro_torch.tree import tree_unflatten
    lay = layout()
    if lay is None:
        return p
    leaves, specs, whole = _flatten(p, sh, split, stacked)
    plan = _Gathers(lay, specs, whole)
    if not plan.needed():
        return p
    out = _GatherLeaves.apply(plan, *leaves)
    return tree_unflatten({k: p[k] for k in sorted(p)}, list(out))


def gather_top(params: Dict[str, Any], keys: Iterable[str],
               split: Iterable[str] = ()) -> Dict[str, Any]:
    """``params`` with the leaves under ``keys`` gathered as
    ``gather_block`` gathers a block's (the embedding, the head, the
    final norm: once per step); the other keys as they are."""
    lay = layout()
    keys = [k for k in keys if k in params and params[k] is not None]
    if lay is None or not keys:
        return params
    sub = gather_block({k: params[k] for k in keys},
                       {k: lay.shardings[k] for k in keys}, split)
    return dict(params, **sub)


def shardings_of(*path) -> Any:
    """The active layout's shardings at ``path`` (keys and indices) into
    the params' tree; ``None`` without a layout."""
    lay = layout()
    if lay is None:
        return None
    sh = lay.shardings
    for k in path:
        sh = sh[k]
    return sh


__all__ = ["StepLayout", "copy_to_model", "gather_block", "gather_from_model",
           "gather_top", "layout", "max_over_model", "model_rank",
           "model_size", "reduce_from_model", "shardings_of", "step_layout"]
