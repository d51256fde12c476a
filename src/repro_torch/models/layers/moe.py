"""Mixture-of-experts FFN with top-k routing, shared experts and the
Switch load-balancing auxiliary loss (port of
``repro.models.layers.moe``).

Dispatch, as the reference's:

  * ``"dense"``: every expert runs on every token and the outputs are
    combined by the (T, E) gate matrix (zeros off the top-k): regular
    products, no routing irregularity, E / top_k times the routed
    work;
  * ``"sparse_capacity"``: each expert takes at most
    ``C = round(T / E * k * cf)`` tokens through a scatter-add into an
    (E, C, D) buffer; overflowing (token, expert) pairs drop to the
    residual path.

Over a mesh whose data ranks split the batch (``sharding.ctx.
batch_split``) the batch statistics are the whole batch's, as under the
reference's GSPMD: the load-balancing loss's two means are averaged
over those ranks (``sharding.spmd.batch_mean``, with their gradient),
and the capacity dispatch counts T over all of them and slots each
rank's tokens after those of the ranks before it.

An expert count that does not divide the model axis (qwen2's 60 on the
reference's 16-way axis) is padded with inert experts whose logits are
pinned at -2^30, so they are never chosen; the port keeps the padded
tree so that a reference tree bridges leaf for leaf.

Over a mesh whose model axis splits the compute (``sharding.
tensor_parallel``) a rank given its model block of the experts runs its
part, where ``param_partition`` puts them: expert parallelism (rank r
holds experts ``[r E / n, (r + 1) E / n)`` of the padded E; the dense
dispatch runs them on every token, the capacity dispatch scatters and
combines only their pairs) or, under ``sharding="tp"``, a block of
every expert's units; the shared experts a block of their units, as the
dense FFN.  Routing runs whole and replicated on every model rank, and
the layer sums its partial output over the model ranks once.

``router_type="neuralut"`` replaces the linear router with a NeuraLUT
sub-network router (the paper's technique applied to MoE routing): each
expert logit is a quantized, sparse sub-network of ``ROUTER_FAN_IN``
inputs at ``ROUTER_BETA`` bits, convertible to one
2^(beta F)-entry table per expert.  It runs the plain grouped
sub-network (``core.subnet.subnet_apply``), as the reference does; no
hand-written kernel is on this path.

The products are plain PyTorch (the reference computes them outside any
Pallas kernel).  The dense dispatch's gate and up products are written
as one 2-D matmul each: they are dots without batch dims, which the
reference's ``remat="dots"`` policy saves, and ``lm._save_dots`` saves
exactly the 2-D matmuls.
"""
from __future__ import annotations

import contextlib
import functools
import threading
from typing import Callable, Dict, Optional, Tuple

import numpy as np
import torch
from torch.utils.checkpoint import CheckpointPolicy

from repro_torch.config.base import MoEConfig
from repro_torch.sharding import tensor_parallel as tp
from repro_torch.sharding.spmd import batch_counts_before, batch_mean
from .attention import NEG_INF
from .common import TensorSpec

Params = Dict[str, torch.Tensor]

# ---------------------------------------------------------------------------
# NeuraLUT router

ROUTER_BETA = 2
ROUTER_FAN_IN = 6
ROUTER_DEPTH = 2
ROUTER_WIDTH = 8


def _f32_specs(shapes):
    """A tree with shape tuples at its leaves -> float32 TensorSpecs."""
    if isinstance(shapes, dict):
        return {k: _f32_specs(v) for k, v in shapes.items()}
    if isinstance(shapes, list):
        return [_f32_specs(v) for v in shapes]
    return TensorSpec(tuple(shapes), torch.float32)


def neuralut_router_spec(d_model: int, num_experts: int) -> Params:
    from repro_torch.core.subnet import subnet_spec
    return {"log_s": TensorSpec((d_model,), torch.float32),
            "fn": _f32_specs(subnet_spec(num_experts, ROUTER_FAN_IN,
                                         ROUTER_DEPTH, ROUTER_WIDTH, 0))}


@functools.lru_cache(maxsize=None)
def _router_conn(d_model: int, num_experts: int) -> np.ndarray:
    """(E, ROUTER_FAN_IN) int32 inputs of each expert logit, from an
    integer seed (not the salted hash): the same in every process and
    equal to the reference's."""
    from repro_torch.core.sparsity import random_connectivity
    conn = random_connectivity(d_model, num_experts, ROUTER_FAN_IN,
                               seed=(d_model * 7919 + num_experts))
    conn.setflags(write=False)
    return conn


def apply_neuralut_router(p: Params, xt: torch.Tensor) -> torch.Tensor:
    """xt: (T, D) -> expert logits (T, E) float32 through the quantized
    sparse sub-network (trainable end to end)."""
    from repro_torch.core import quant
    from repro_torch.core.subnet import subnet_apply
    e = p["fn"]["layers"][0]["w"].shape[0]
    conn = torch.as_tensor(_router_conn(xt.shape[-1], e).astype(np.int64),
                           device=xt.device)
    xq = quant.quant_apply({"log_s": p["log_s"]}, xt.float(), ROUTER_BETA)
    return subnet_apply(p["fn"], xq[:, conn], 0)     # (T, E, F) -> (T, E)


# ---------------------------------------------------------------------------
# Params


def padded_num_experts(cfg: MoEConfig, model_axis: int) -> int:
    e = cfg.num_experts
    if cfg.sharding == "tp" or e % model_axis == 0:
        return e
    return ((e + model_axis - 1) // model_axis) * model_axis


def _shared_width(cfg: MoEConfig) -> int:
    return cfg.num_shared * (cfg.d_ff_shared or cfg.d_ff_expert)


def moe_spec(cfg: MoEConfig, d_model: int, dtype, model_axis: int = 16,
             router_extra: Optional[Params] = None) -> Params:
    e = padded_num_experts(cfg, model_axis)
    ff = cfg.d_ff_expert
    spec: Params = {
        "router": TensorSpec((d_model, e), torch.float32),
        "w_gate": TensorSpec((e, d_model, ff), dtype),
        "w_up": TensorSpec((e, d_model, ff), dtype),
        "w_down": TensorSpec((e, ff, d_model), dtype),
    }
    if cfg.num_shared > 0:
        sff = _shared_width(cfg)
        spec.update({
            "ws_gate": TensorSpec((d_model, sff), dtype),
            "ws_up": TensorSpec((d_model, sff), dtype),
            "ws_down": TensorSpec((sff, d_model), dtype),
        })
    if cfg.router_type == "neuralut":
        spec["router_nl"] = neuralut_router_spec(d_model, e)
    elif router_extra:
        spec["router_nl"] = router_extra
    return spec


# ---------------------------------------------------------------------------
# Routing


def _top_k(x: torch.Tensor, k: int) -> Tuple[torch.Tensor, torch.Tensor]:
    """``lax.top_k`` along the last dim: the k largest, in descending
    order, the lower index first among equal values (a stable sort;
    ``torch.topk`` promises no order among ties)."""
    vals, idx = torch.sort(x, dim=-1, descending=True, stable=True)
    return vals[..., :k], idx[..., :k]


def _topk_gates(logits: torch.Tensor, cfg: MoEConfig, e_padded: int
                ) -> Tuple[torch.Tensor, torch.Tensor]:
    """logits (T, E) -> (gates (T, E) float32 holding the renormalized
    top-k softmax weights and zeros elsewhere, aux loss)."""
    if e_padded > cfg.num_experts:
        # inert padding experts can never win
        pad = torch.full((logits.shape[0], e_padded - cfg.num_experts),
                         NEG_INF, dtype=logits.dtype, device=logits.device)
        logits = torch.cat([logits[:, :cfg.num_experts], pad], dim=-1)
    probs = torch.softmax(logits.float(), dim=-1)
    top_w, top_i = _top_k(probs, cfg.top_k)                    # (T, k)
    top_w = top_w / torch.sum(top_w, dim=-1, keepdim=True)
    gates = torch.zeros_like(probs).scatter(1, top_i, top_w)
    # Switch-style load-balance loss: E * sum_e (frac_tokens_e * mean_prob_e)
    me = batch_mean(torch.mean(probs, dim=0))
    one_hot_top1 = torch.nn.functional.one_hot(
        top_i[:, 0], probs.shape[-1]).float()
    ce = batch_mean(torch.mean(one_hot_top1, dim=0))
    aux = probs.shape[-1] * torch.sum(me * ce)
    return gates, aux


def apply_moe(p: Params, cfg: MoEConfig, x: torch.Tensor, act: Callable, *,
              dispatch: str = "dense", capacity_factor: float = 1.25,
              router_fn: Optional[Callable] = None
              ) -> Tuple[torch.Tensor, torch.Tensor]:
    """x: (B, S, D) -> (output (B, S, D), aux loss x ``aux_loss_coef``).

    Given this rank's model block of the experts (a step that splits the
    model axis; weights narrower than the tree's), it computes its part:
    under expert parallelism its ``E / model`` experts (``w_gate`` of
    fewer experts than the router's columns), under ``sharding="tp"`` a
    block of every expert's ``d_ff_expert`` units; the shared experts a
    block of their units.  The router and the top-k run whole on every
    model rank (so every rank routes alike and the aux loss is
    replicated); the partial sums of the routed and shared experts are
    summed over the model ranks once."""
    b, s, d = x.shape
    xt = x.reshape(b * s, d)
    e = p["router"].shape[-1]
    if router_fn is not None:
        logits = router_fn(p.get("router_nl"), xt)
    elif cfg.router_type == "neuralut":
        logits = apply_neuralut_router(p["router_nl"], xt)
    else:
        logits = xt.float() @ p["router"]
    gates, aux = _topk_gates(logits, cfg, e)

    # the model split, by the weights' shapes: the routed experts' and
    # the shared experts' parts are partial sums over the model ranks
    routed_split = tuple(p["w_gate"].shape) != (e, d, cfg.d_ff_expert)
    shared_split = "ws_gate" in p and \
        p["ws_gate"].shape[-1] != _shared_width(cfg)
    if routed_split or shared_split:
        # the experts' input: its gradient is each rank's part (the
        # router's input is not: its gradient is whole on every rank)
        xs = tp.copy_to_model(xt)
    xr = xs if routed_split else xt
    first = 0
    if routed_split:
        # the gates enter the rank's experts whole, so that the router's
        # gradient is summed over the ranks' columns before the router
        gates = tp.copy_to_model(gates)
        if p["w_gate"].shape[0] != e:
            first = tp.model_rank() * p["w_gate"].shape[0]

    if dispatch == "dense":
        out = _dense_dispatch(p, xr, gates, act, first)
    elif dispatch == "sparse_capacity":
        out = _capacity_dispatch(p, cfg, xr, gates, act, capacity_factor,
                                 first)
    else:
        raise ValueError(dispatch)
    parts = [(out, routed_split)]
    if "ws_gate" in p:
        xh = xs if shared_split else xt
        h = act(xh @ p["ws_gate"]) * (xh @ p["ws_up"])
        with _kept():
            parts.append((h @ p["ws_down"], shared_split))
    out = _sum_parts(parts)
    return out.reshape(b, s, d), aux * cfg.aux_loss_coef


def _sum_parts(parts):
    """The layer's output from its parts, (tensor, whether it is this
    rank's partial sum over the model ranks): the partial ones added and
    summed over the model ranks (one reduction), the whole ones added
    after them, in order."""
    split = [t for t, part in parts if part]
    out = [tp.reduce_from_model(sum(split[1:], split[0]))] if split else []
    out += [t for t, part in parts if not part]
    return sum(out[1:], out[0])


# ---------------------------------------------------------------------------
# What a checkpoint keeps

# per thread: a forward and its recompute each set and read it on the
# thread that runs them, and two threads may run MoE blocks at once
_KEEP = threading.local()


@contextlib.contextmanager
def _kept():
    """The products run within it, on this thread, are kept by
    ``keep_policy``."""
    _KEEP.on = True
    try:
        yield
    finally:
        _KEEP.on = False


_PRODUCTS = (torch.ops.aten.mm.default, torch.ops.aten.bmm.default)


def keep_policy(ctx, op, *args, **kwargs):
    """The selective-checkpoint policy of a block with an MoE FFN under
    remat "full": keep the results of the routed combine and of the
    shared experts' down projection (their products, run in ``_kept``),
    recompute everything else.  No backward reads those results, so the
    recompute need not run them, as XLA's remat does not; a plain
    checkpoint reruns a block up to its last op that saves a tensor,
    the shared experts' projection, and so the combine.  The kept
    results are (tokens, d_model) each."""
    if getattr(_KEEP, "on", False) and op in _PRODUCTS:
        return CheckpointPolicy.MUST_SAVE
    return CheckpointPolicy.PREFER_RECOMPUTE


def _expert_in(xt: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """(T, D) x (E, D, F) -> (E, T, F) as one (T, D) @ (D, E*F) matmul
    (``einsum("td,edf->etf")``, a dot without batch dims)."""
    e, d, f = w.shape
    h = xt @ w.permute(1, 0, 2).reshape(d, e * f)
    return h.reshape(-1, e, f).permute(1, 0, 2)


def _dense_dispatch(p, xt, gates, act, first=0):
    """Every expert of ``p`` on every token, masked by its gate weight:
    ``gates``' columns from ``first`` on where ``p`` holds a block of
    the experts (expert parallelism)."""
    h = act(_expert_in(xt, p["w_gate"])) * _expert_in(xt, p["w_up"])
    o = torch.einsum("etf,efd->etd", h, p["w_down"])           # (E, T, D)
    g = gates.to(o.dtype)
    if o.shape[0] != g.shape[1]:
        g = g[:, first:first + o.shape[0]]
    with _kept():
        return torch.einsum("etd,te->td", o, g)


def _capacity_dispatch(p, cfg, xt, gates, act, capacity_factor, first=0):
    """Capacity-based sparse dispatch, scatter/gather form: each expert
    processes at most C tokens (the first by token order); overflowing
    pairs get weight 0 and their scatter lands, zeroed, in slot C - 1.
    The slots come from the whole gate matrix; where ``p`` holds a block
    of the experts (those from ``first`` on) only their pairs are
    scattered and combined, the others' weights zeroed."""
    t, d = xt.shape
    e = gates.shape[1]
    e_own = p["w_gate"].shape[0]
    k = cfg.top_k
    top_w, top_i = _top_k(gates, k)                            # (T, k)
    # slot of each (token, choice) within its expert's capacity buffer,
    # after the tokens of the ranks before this one
    chosen = gates > 0
    ranks, before = batch_counts_before(
        torch.sum(chosen.to(torch.int32), dim=0))
    cap = int(max(1, round(t * ranks / e * k * capacity_factor)))
    pos_in_e = torch.cumsum(chosen.to(torch.int32), dim=0) - 1  # (T, E)
    pos_in_e = pos_in_e + before
    slot = torch.gather(pos_in_e, 1, top_i)                    # (T, k)
    keep = (slot < cap) & (top_w > 0)
    if e_own != e:
        own = (top_i >= first) & (top_i < first + e_own)
        keep = keep & own
        top_i = torch.where(own, top_i - first, 0)
    slot_c = torch.clamp(slot, 0, cap - 1)

    # scatter tokens into expert buffers: (E, C, D)
    upd = keep[..., None].to(xt.dtype) * xt[:, None, :]        # (T, k, D)
    flat = (top_i * cap + slot_c).reshape(-1)
    xe = torch.zeros((e_own * cap, d), dtype=xt.dtype, device=xt.device)
    xe = xe.index_add(0, flat, upd.reshape(-1, d)).reshape(e_own, cap, d)

    h = act(torch.einsum("ecd,edf->ecf", xe, p["w_gate"]))
    h = h * torch.einsum("ecd,edf->ecf", xe, p["w_up"])
    oe = torch.einsum("ecf,efd->ecd", h, p["w_down"])          # (E, C, D)

    # combine: gather each token's k expert outputs, weight, sum
    y = oe.reshape(e_own * cap, d)[flat].reshape(t, k, d)
    w = torch.where(keep, top_w, 0.0).to(oe.dtype)
    with _kept():
        return torch.einsum("tkd,tk->td", y, w)
