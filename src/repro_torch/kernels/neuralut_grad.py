"""Training forward and backward of the grouped sub-network: the
wrappers of the CUDA kernels in ``csrc/neuralut_grad.cu`` (port of
``repro.kernels.neuralut_grad.subnet_train_op`` and of
``repro.kernels.ops.subnet_train_apply``).

* :func:`subnet_train_fwd` (K4) evaluates every (row, neuron) pair of a
  (B, O, F) input through its neuron's MLP with skips in one launch and
  saves the input of every sub-layer i >= 1, (B, O, n_i) each.
* :func:`subnet_train_bwd` (K5) walks the output's cotangent back in one
  launch and returns dx and the weight gradients of every sub-layer and
  skip chunk, summed over B without atomics (the row tiles of a neuron
  group are one thread-block cluster that sums its ranks' partials on
  chip, in rank order): a rerun is bit-identical.
* :func:`plan_train_launch` reads the launch plan that the kernels' C
  entries make for themselves (``csrc/train_plan.h``): neurons per block,
  row tiles, K5's cluster, shared memory, and the global scratch that K5
  needs where its block sum does not fit in shared memory (deep width-32
  geometries), which the wrapper allocates.
* :class:`SubnetTrainFn` ties the two together as an autograd function
  (K5 behind its own :class:`SubnetTrainBwdFn`);
  :func:`subnet_train_apply` runs a ``core.subnet`` parameter dict
  through it (the ``kernel_train`` route).

Every operand may carry a leading seed axis S (the seed ensemble): the
kernels then run all S networks in one launch (``gridDim.z = S``), with
each seed's weight gradients summed on their own, in a fixed order.
Both functions carry a ``torch.func.vmap`` rule that moves the vmapped
dimension to the front and makes that one launch, so the ensemble's
vmapped training step costs one K4 and one K5 call per layer, whatever
S, as the reference's ``jax.vmap`` batches its ``pallas_call``.

On a CPU tensor each wrapper runs its plain version
(``kernels.ref.subnet_train_fwd_ref`` / ``subnet_train_bwd_ref``); on a
CUDA tensor it launches its kernel or raises.  On the card the kernels
agree with the plain versions to atol/rtol 1e-5 (forward) and rtol 2e-4
/ atol 3e-5 (gradients; the reference's own tolerance,
tests/test_train_kernel.py), the spread of float32 summation order.
"""
from __future__ import annotations

import ctypes
import functools
import math
from collections import namedtuple
from typing import Dict, List, Optional, Sequence, Tuple

import torch

from repro_torch.kernels import build
from repro_torch.kernels.neuralut_mlp import (check_operands,
                                              pack_subnet_weights)
from repro_torch.kernels.ref import subnet_train_bwd_ref, subnet_train_fwd_ref

Tensors = List[torch.Tensor]

# The numbers of ``repro_subnet_train_plan``, in the order of its TP_*
# words (csrc/train_plan.h).
TrainPlan = namedtuple("TrainPlan", (
    "fwd_group", "fwd_flags", "bwd_group", "bwd_flags", "tiles", "cluster",
    "smem_fwd", "smem_bwd", "scratch", "pstride"))
STAGED, ACC_GLOBAL = 1, 2   # the flags' bits: TF_STAGED, TF_ACC_GLOBAL


def plan_train_launch(seeds: int, t: int, o: int, widths: Sequence[int],
                      skip: int, lib=None) -> TrainPlan:
    """The plan of a K4 and a K5 launch of ``seeds`` x ``t`` rows x ``o``
    neurons, as the C entries make it (``lib``: the kernels' library, or
    any library built from ``csrc/train_plan.h``); raises ValueError for
    a launch that they refuse."""
    return _plan(seeds, t, o, tuple(widths), skip,
                 lib or build.load_library())


@functools.lru_cache(maxsize=256)   # every training step asks again
def _plan(seeds, t, o, widths, skip, lib) -> TrainPlan:
    out = (ctypes.c_longlong * len(TrainPlan._fields))()
    rc = lib.repro_subnet_train_plan(
        seeds, t, o, len(widths) - 1, (ctypes.c_int * len(widths))(*widths),
        skip, out)
    if rc:
        raise ValueError(f"the training kernels take no launch of {seeds} x "
                         f"{t} x {o} at widths {widths}, skip {skip} "
                         "(widths <= 32, depth <= 16, skip 0 or a divisor of "
                         "the depth)")
    return TrainPlan(*out)


def _seeds(xg: torch.Tensor) -> Optional[int]:
    """S for an (S, B, O, F) input, None for a (B, O, F) one."""
    if xg.dim() not in (3, 4):
        raise ValueError(f"xg must be (B, O, F) or (S, B, O, F), got "
                         f"{tuple(xg.shape)}")
    return xg.shape[0] if xg.dim() == 4 else None


def _launch_args(xg, layer_ws, layer_bs, skip_ws, skip_bs, skip, wpack):
    seeds = _seeds(xg)
    widths, skip_ws, skip_bs = check_operands(xg, layer_ws, layer_bs,
                                              skip_ws, skip_bs, skip,
                                              seeds=seeds)
    if wpack is None:
        raise ValueError("a CUDA launch needs the packed weights "
                         "(pack_subnet_weights)")
    o = xg.shape[-2]
    p = sum(math.prod(a.shape[-2:] if a is w else a.shape[-1:])
            for w, b in list(zip(layer_ws, layer_bs))
            + list(zip(skip_ws, skip_bs)) for a in (w, b))
    lead = () if seeds is None else (seeds,)
    if tuple(wpack.shape) != lead + (o, p) or wpack.device != xg.device \
            or not wpack.is_contiguous():
        raise ValueError(f"packed weights {tuple(wpack.shape)} on "
                         f"{wpack.device} != {lead + (o, p)} on {xg.device}")
    return widths, skip_ws, skip_bs, wpack, seeds or 1


def subnet_train_fwd(xg: torch.Tensor,
                     layer_ws: Sequence[torch.Tensor],
                     layer_bs: Sequence[torch.Tensor],
                     skip_ws: Optional[Sequence[torch.Tensor]] = None,
                     skip_bs: Optional[Sequence[torch.Tensor]] = None,
                     *, skip: int = 0,
                     wpack: Optional[torch.Tensor]
                     ) -> Tuple[torch.Tensor, Tensors]:
    """(B, O, F) float32 -> (out (B, O), [act_i (B, O, n_i) for i = 1 ..
    L-1]).  Weights as in ``neuralut_mlp.grouped_subnet``; ``wpack`` is
    their ``pack_subnet_weights`` form, which the CUDA launch reads (the
    plain CPU version takes None).  The activations are views of one
    buffer, in order.  With a leading seed axis S on every operand, the
    output is (S, B, O) and act_i (S, B, O, n_i), in one launch."""
    if xg.device.type == "cpu":
        return subnet_train_fwd_ref(xg, layer_ws, layer_bs, skip_ws or (),
                                    skip_bs or (), skip=skip)
    widths, skip_ws, skip_bs, wpack, ns = _launch_args(
        xg, layer_ws, layer_bs, skip_ws, skip_bs, skip, wpack)
    t, o, _ = xg.shape[-3:]
    lead = xg.shape[:-3]
    nl = len(layer_ws)
    xg = xg.contiguous()
    out = torch.empty(lead + (t, o), dtype=torch.float32, device=xg.device)
    sizes = [ns * t * o * n for n in widths[1:nl]]
    buf = torch.empty(sum(sizes), dtype=torch.float32, device=xg.device)
    acts = [a.view(lead + (t, o, n)) for a, n in
            zip(torch.split(buf, sizes), widths[1:nl])]
    if t == 0 or o == 0:
        return out, acts
    rc = build.load_library().repro_subnet_train_fwd(
        xg.device.index, xg.data_ptr(), wpack.data_ptr(), out.data_ptr(),
        buf.data_ptr() if buf.numel() else None, ns, t, o, wpack.shape[-1],
        nl, (ctypes.c_int * len(widths))(*widths), skip,
        torch.cuda.current_stream(xg.device).cuda_stream)
    build.check(rc, "subnet_train_fwd launch")
    subnet_train_fwd.launches += 1
    return out, acts


subnet_train_fwd.launches = 0


def _act_buffer(acts: Sequence[torch.Tensor], lead: Tuple[int, ...],
                t: int, o: int, widths: Sequence[int],
                device) -> Optional[torch.Tensor]:
    """The start of the one buffer that :func:`subnet_train_fwd`'s
    (..., B, O, n_i) activations view, in the kernel's layout; raises for
    activations of any other shape or layout."""
    want = [lead + (t, o, n) for n in widths[1:len(widths) - 1]]
    if [tuple(a.shape) for a in acts] != want or any(
            a.device != device or a.dtype != torch.float32 for a in acts):
        raise ValueError(f"activations {[tuple(a.shape) for a in acts]} "
                         f"!= {want} float32 on {device}")
    if not acts:
        return None
    base, off = acts[0].data_ptr(), 0
    for a in acts:
        if not a.is_contiguous() or a.data_ptr() != base + 4 * off:
            raise ValueError("activations must be the views of one buffer "
                             "that subnet_train_fwd returned")
        off += a.numel()
    return acts[0]


def subnet_train_bwd(g: torch.Tensor, xg: torch.Tensor,
                     acts: Sequence[torch.Tensor],
                     layer_ws: Sequence[torch.Tensor],
                     layer_bs: Sequence[torch.Tensor],
                     skip_ws: Optional[Sequence[torch.Tensor]] = None,
                     skip_bs: Optional[Sequence[torch.Tensor]] = None,
                     *, skip: int = 0,
                     wpack: Optional[torch.Tensor]):
    """Cotangent g (B, O) of the output -> (dx (B, O, F), [dW_i], [db_i],
    [dR_c], [dRb_c]), each gradient shaped like its weight and summed
    over B.  ``acts`` and ``wpack`` are as :func:`subnet_train_fwd`
    took and returned them.  With a leading seed axis S on every
    operand, every result carries it too and each seed's gradients are
    summed over its own rows."""
    if xg.device.type == "cpu":
        return subnet_train_bwd_ref(g, xg, acts, layer_ws, skip_ws or (),
                                    skip=skip)
    widths, skip_ws, skip_bs, wpack, ns = _launch_args(
        xg, layer_ws, layer_bs, skip_ws, skip_bs, skip, wpack)
    t, o, f = xg.shape[-3:]
    lead = tuple(xg.shape[:-3])
    if tuple(g.shape) != lead + (t, o) or g.dtype != torch.float32 \
            or g.device != xg.device:
        raise ValueError(f"g {tuple(g.shape)} {g.dtype} on {g.device} != "
                         f"{lead + (t, o)} float32 on {xg.device}")
    buf = _act_buffer(acts, lead, t, o, widths, xg.device)
    nl = len(layer_ws)
    p = wpack.shape[-1]
    xg, g = xg.contiguous(), g.contiguous()
    dx = torch.empty(lead + (t, o, f), dtype=torch.float32, device=xg.device)
    grads = torch.empty(ns * o * p, dtype=torch.float32, device=xg.device)
    leaves = list(zip(layer_ws, layer_bs)) + list(zip(skip_ws, skip_bs))
    views, off = [], 0
    for w, b in leaves:  # leaf-major: leaf k at S * O * (its row offset)
        for a in (w, b):
            n = math.prod(a.shape[len(lead) + 1:])
            views.append(grads[ns * o * off:ns * o * (off + n)]
                         .view(a.shape))
            off += n
    dws, dbs = views[0:2 * nl:2], views[1:2 * nl:2]
    drs, drbs = views[2 * nl::2], views[2 * nl + 1::2]
    if t == 0 or o == 0:
        dx.zero_()
        grads.zero_()
        return dx, dws, dbs, drs, drbs
    # the block sums' global scratch, where the plan keeps them there
    n_scratch = plan_train_launch(ns, t, o, widths, skip).scratch
    scratch = torch.empty(n_scratch, dtype=torch.float32,
                          device=xg.device) if n_scratch else None
    rc = build.load_library().repro_subnet_train_bwd(
        xg.device.index, g.data_ptr(), xg.data_ptr(),
        buf.data_ptr() if buf is not None else None, wpack.data_ptr(),
        dx.data_ptr(), grads.data_ptr(),
        scratch.data_ptr() if scratch is not None else None, n_scratch,
        ns, t, o, p, nl, (ctypes.c_int * len(widths))(*widths), skip,
        torch.cuda.current_stream(xg.device).cuda_stream)
    build.check(rc, "subnet_train_bwd launch")
    subnet_train_bwd.launches += 1
    return dx, dws, dbs, drs, drbs


subnet_train_bwd.launches = 0


def _split(weights, nl: int, nch: int):
    return (weights[:nl], weights[nl:2 * nl],
            weights[2 * nl:2 * nl + nch], weights[2 * nl + nch:])


def _to_front(info, in_dims, args):
    """vmap rule helper: every tensor with its vmapped dimension moved to
    the front (an unbatched one expanded), so one seed-axis launch runs
    the whole batch."""
    return [a if not isinstance(a, torch.Tensor)
            else a.expand(info.batch_size, *a.shape) if d is None
            else a.movedim(d, 0) for a, d in zip(args, in_dims)]


class SubnetTrainBwdFn(torch.autograd.Function):
    """K5 as a function of its own, so that a vmapped backward (the
    ensemble's) reaches its vmap rule: one seed-axis launch.

    apply(skip, nl, nch, g, xg, wpack, *acts, *weights) -> (dx, *dws,
    *dbs, *drs, *drbs).  Not differentiable itself."""

    @staticmethod
    def forward(skip: int, nl: int, nch: int, g: torch.Tensor,
                xg: torch.Tensor, wpack: torch.Tensor, *rest: torch.Tensor):
        acts, weights = rest[:nl - 1], rest[nl - 1:]
        lw, lb, sw, sb = _split(weights, nl, nch)
        dx, dws, dbs, drs, drbs = subnet_train_bwd(
            g, xg, acts, lw, lb, sw, sb, skip=skip, wpack=wpack)
        return (dx, *dws, *dbs, *drs, *drbs)

    @staticmethod
    def setup_context(ctx, inputs, output) -> None:
        pass

    @staticmethod
    def backward(ctx, *grads):
        raise RuntimeError("the sub-network's backward is differentiable "
                           "once only")

    @staticmethod
    def vmap(info, in_dims, skip, nl, nch, *args):
        outs = SubnetTrainBwdFn.forward(skip, nl, nch,
                                        *_to_front(info, in_dims[3:], args))
        return outs, (0,) * len(outs)


class SubnetTrainFn(torch.autograd.Function):
    """Differentiable grouped sub-network: the forward runs K4 and
    returns the sub-layer inputs and packed weights beside the output
    (for the backward; not differentiable), the backward runs K5
    through :class:`SubnetTrainBwdFn` (the plain versions for CPU
    tensors).  Works under ``torch.autograd`` and under ``torch.func``
    (``grad``, and ``vmap`` over a leading seed axis).

    apply(skip, nl, nch, xg, *layer_ws, *layer_bs, *skip_ws, *skip_bs)
    -> (out (B, O), wpack, *acts)."""

    @staticmethod
    def forward(skip: int, nl: int, nch: int, xg: torch.Tensor,
                *weights: torch.Tensor):
        lw, lb, sw, sb = _split(weights, nl, nch)
        wpack = pack_subnet_weights(lw, lb, sw, sb)
        out, acts = subnet_train_fwd(xg, lw, lb, sw, sb, skip=skip,
                                     wpack=wpack)
        return (out, wpack, *acts)

    @staticmethod
    def setup_context(ctx, inputs, output) -> None:
        skip, nl, nch, xg, *weights = inputs
        _out, wpack, *acts = output
        ctx.mark_non_differentiable(wpack, *acts)
        ctx.skip, ctx.nl, ctx.nch = skip, nl, nch
        ctx.save_for_backward(xg, wpack, *acts, *weights)

    @staticmethod
    def backward(ctx, g: torch.Tensor, *_unused):
        grads = SubnetTrainBwdFn.apply(ctx.skip, ctx.nl, ctx.nch, g,
                                       *ctx.saved_tensors)
        return (None, None, None, *grads)

    @staticmethod
    def vmap(info, in_dims, skip, nl, nch, *args):
        outs = SubnetTrainFn.forward(skip, nl, nch,
                                     *_to_front(info, in_dims[3:], args))
        return outs, (0,) * len(outs)


def subnet_train_apply(fn_params: Dict, xg: torch.Tensor,
                       skip: int) -> torch.Tensor:
    """Differentiable (B, O, F) -> (B, O) evaluation of a ``core.subnet``
    param dict through :class:`SubnetTrainFn` (the ``kernel_train``
    route): one K4 launch forward, one K5 launch backward, under
    ``torch.func.vmap`` too."""
    lw = [lp["w"] for lp in fn_params["layers"]]
    lb = [lp["b"] for lp in fn_params["layers"]]
    sw = [sp["w"] for sp in fn_params.get("skips", [])]
    sb = [sp["b"] for sp in fn_params.get("skips", [])]
    return SubnetTrainFn.apply(skip, len(lw), len(sw), xg, *lw, *lb, *sw,
                               *sb)[0]
