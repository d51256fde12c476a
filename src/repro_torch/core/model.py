"""Full NeuraLUT circuit-level model: input quantizer + stacked layers
(port of ``repro.core.model``; eval and training forward).

API (parameters are nested dicts of tensors with the reference's keys):
    statics   = model_static(cfg)                 # connectivity
    p, s      = model_init(cfg, generator, device=...)
    p         = calibrate_in_quant(cfg, p, x_train)
    logits, values, s = model_apply(cfg, p, s, statics, x, train=...)
    loss      = ce_loss(logits, labels)

Every entry point accepts a ``LUTGraphConfig`` too and routes to the
``graph_*`` twins, which walk the node DAG instead of the layer chain.
An arity-A adder-tree node carries A branches, each with its own
connectivity, hidden function and batch norm, quantized through ONE
shared quantizer and summed, so the node's output is exactly a
``beta + log2(A)``-bit code (core/nl_config.py).  Every neuron kind
(``subnet``, ``linear``, ``poly``) runs on chains and graphs alike.
"""
from __future__ import annotations

import math
from typing import Any, Dict, List, Optional, Tuple

import numpy as np
import torch

from repro_torch.core import layers as L
from repro_torch.core import quant
from repro_torch.core.exec_plan import SubnetExec, plan_subnet_exec
from repro_torch.core.nl_config import (LUTGraphConfig, LUTNodeSpec,
                                        NeuraLUTConfig, is_graph_config)
from repro_torch.core.sparsity import random_connectivity
from repro_torch.core.subnet import monomial_exponents
from repro_torch.device import DeviceLike, resolve_device

Params = Dict[str, Any]


def model_widths(cfg: NeuraLUTConfig) -> List[int]:
    return [cfg.in_features] + list(cfg.layer_widths)


def model_static(cfg) -> List[Dict]:
    if is_graph_config(cfg):
        return graph_static(cfg)
    w = model_widths(cfg)
    return [L.layer_static(cfg, i, w[i], w[i + 1])
            for i in range(cfg.num_layers)]


def model_spec(cfg) -> Tuple[Params, Params]:
    """(params, state) shape trees: tuples at the leaves, the
    reference's keys above them."""
    if is_graph_config(cfg):
        return graph_spec(cfg)
    w = model_widths(cfg)
    lp, ls = [], []
    for i in range(cfg.num_layers):
        pi, si = L.layer_spec(cfg, i, w[i + 1])
        lp.append(pi)
        ls.append(si)
    return ({"in_quant": quant.quant_spec(cfg.in_features), "layers": lp},
            {"layers": ls})


def _init_from_spec(spec, gen: torch.Generator, name: str = ""):
    """Materialize a shape tree as ``init_from_spec`` does: truncated
    normal on (-2, 2) over sqrt(fan_in = shape[-2]) for every leaf of
    rank >= 2, ones for BN gains, zeros for the other vectors."""
    if isinstance(spec, dict):
        return {k: _init_from_spec(spec[k], gen, k) for k in sorted(spec)}
    if isinstance(spec, list):
        return [_init_from_spec(s, gen, name) for s in spec]
    if len(spec) >= 2:
        w = torch.empty(spec, dtype=torch.float32)
        torch.nn.init.trunc_normal_(w, 0.0, 1.0, -2.0, 2.0, generator=gen)
        return w * (1.0 / math.sqrt(max(spec[-2], 1)))
    if name == "g":
        return torch.ones(spec, dtype=torch.float32)
    return torch.zeros(spec, dtype=torch.float32)


def _to(tree, device: torch.device):
    if isinstance(tree, dict):
        return {k: _to(v, device) for k, v in tree.items()}
    if isinstance(tree, list):
        return [_to(v, device) for v in tree]
    return tree.to(device)


def model_init(cfg, generator: torch.Generator, *,
               device: DeviceLike = None) -> Tuple[Params, Params]:
    """Random parameters and BN state, drawn on the CPU from
    ``generator`` and moved to ``device`` (``None`` = CUDA).  Quantizer
    scales start at 0.25 (inputs) and 2/c (layer outputs, c the largest
    positive code), BN at identity."""
    if is_graph_config(cfg):
        return graph_init(cfg, generator, device=device)
    dev = resolve_device(device)
    spec_p, spec_s = model_spec(cfg)
    params = _init_from_spec(spec_p, generator)
    params["in_quant"] = quant.quant_init(cfg.in_features, 0.25)
    c = max(1, 2 ** (cfg.beta - 1) - 1)
    for i, lp in enumerate(params["layers"]):
        o = cfg.layer_widths[i]
        lp["quant"] = quant.quant_init(o, 2.0 / c)
        lp["bn"] = {"g": torch.ones(o), "b": torch.zeros(o)}
    state = {"layers": [{"bn": {"mean": torch.zeros(s["bn"]["mean"]),
                                "var": torch.ones(s["bn"]["var"])}}
                        for s in spec_s["layers"]]}
    return _to(params, dev), _to(state, dev)


def calibrate_in_quant(cfg, params: Params, x_train) -> Params:
    """+-2.5 sigma per feature spans the signed input code range (chain
    or graph: only the input quantizer changes).  Returns ``params``
    with ``in_quant.log_s`` replaced."""
    beta_in = cfg.beta_in or cfg.beta
    max_code = 2 ** (beta_in - 1)
    if isinstance(x_train, torch.Tensor):
        x_train = x_train.detach().cpu().numpy()
    std = np.maximum(np.asarray(x_train).std(axis=0), 1e-3)
    dev = params["in_quant"]["log_s"].device
    params = dict(params)
    params["in_quant"] = {"log_s": torch.as_tensor(
        np.log(2.5 * std / max_code), dtype=torch.float32, device=dev)}
    return params


def device_statics(statics: List[Dict], device) -> List[Dict]:
    """``statics`` with every connectivity as an int64 tensor on
    ``device`` (``conn``, or a graph node's ``conns``, one tensor per
    branch), so a training step moves no connectivity to the device.
    The poly kind's ``exps`` stay a host array: ``subnet.poly_apply``
    reads its loop bounds from them."""
    def conn(c):
        return torch.as_tensor(np.asarray(c)).to(device, torch.long)
    out = []
    for st in statics:
        d = dict(st)
        if "conn" in st:
            d["conn"] = conn(st["conn"])
        if "conns" in st:
            d["conns"] = [conn(c) for c in st["conns"]]
        out.append(d)
    return out


def model_apply(cfg, params: Params, state: Params,
                statics: List[Dict], x: torch.Tensor, *,
                train: bool = False, exec_plan: Optional[SubnetExec] = None):
    """x: (B, in_features) raw features -> (logits (B, classes)
    pre-quant, quantized class values, new_state).  ``train=True``
    normalizes with batch statistics and threads the BN state;
    ``exec_plan`` routes every layer's hidden function (None: the
    planner default for the purpose on ``x``'s device)."""
    if is_graph_config(cfg):
        return graph_apply(cfg, params, state, statics, x, train=train,
                           exec_plan=exec_plan)
    if exec_plan is None:
        exec_plan = plan_subnet_exec(
            cfg, purpose="train" if train else "eval", device=x.device)
    v = quant.quant_apply(params["in_quant"], x, cfg.beta_in or cfg.beta)
    pre = None
    new_states = []
    for i in range(cfg.num_layers):
        v, pre, ns = L.layer_apply(cfg, i, params["layers"][i],
                                   state["layers"][i], statics[i], v,
                                   train=train, exec_plan=exec_plan)
        new_states.append(ns)
    return pre, v, {"layers": new_states}


# ---------------------------------------------------------------------------
# LUT-graph (DAG) twins


def node_static_conns(static: Dict) -> List:
    """Per-branch connectivity of one node's static dict: ``{"conns":
    [...]}`` (graph form) or ``{"conn": arr}`` (one arity-1 branch)."""
    if "conns" in static:
        return list(static["conns"])
    return [static["conn"]]


def node_branch_params(nd: LUTNodeSpec, lp: Params, ls: Params
                       ) -> List[Tuple[Params, Params, Params]]:
    """(fn, bn params, bn state) per branch.  Arity-1 nodes use the flat
    layer tree, so a chain graph shares its trees with the chain."""
    if nd.arity == 1:
        return [(lp["fn"], lp["bn"], ls["bn"])]
    return [(lp["fn"][a], lp["bn"][a], ls["bn"][a])
            for a in range(nd.arity)]


def graph_static(cfg: LUTGraphConfig) -> List[Dict]:
    """Per-node constants: one connectivity per branch over the node's
    concatenated source pool (and the poly kind's ``exps``).  Branch 0
    of node ``i`` is seeded by ``hash((name, i))``, branch ``a`` by
    ``hash((name, i, a))``, as in the reference; the hash is salted per
    process (``layers.layer_static``), so carry ``conns`` with the
    model."""
    out = []
    for i, nd in enumerate(cfg.nodes):
        pool_w = cfg.node_in_width(i)
        conns = []
        for a in range(nd.arity):
            key = (cfg.name, i) if a == 0 else (cfg.name, i, a)
            conns.append(random_connectivity(
                pool_w, nd.width, nd.fan_in, seed=hash(key) % (2 ** 31)))
        st: Dict[str, Any] = {"conns": conns}
        if cfg.kind == "poly":
            st["exps"] = monomial_exponents(nd.fan_in, cfg.degree)
        out.append(st)
    return out


def graph_spec(cfg: LUTGraphConfig) -> Tuple[Params, Params]:
    """(params, state) shape trees of a graph: per node the layer tree
    for arity 1, per-branch ``fn`` and ``bn`` lists (one shared
    ``quant``) for arity > 1."""
    lp, ls = [], []
    for nd in cfg.nodes:
        def fn():
            return L.fn_spec(cfg, nd.fan_in, nd.width)
        bn_p, bn_s = quant.bn_spec(nd.width)
        if nd.arity == 1:
            lp.append({"fn": fn(), "bn": bn_p,
                       "quant": quant.quant_spec(nd.width)})
            ls.append({"bn": bn_s})
        else:
            lp.append({"fn": [fn() for _ in range(nd.arity)],
                       "bn": [dict(bn_p) for _ in range(nd.arity)],
                       "quant": quant.quant_spec(nd.width)})
            ls.append({"bn": [dict(bn_s) for _ in range(nd.arity)]})
    return ({"in_quant": quant.quant_spec(cfg.in_features), "layers": lp},
            {"layers": ls})


def graph_init(cfg: LUTGraphConfig, generator: torch.Generator, *,
               device: DeviceLike = None) -> Tuple[Params, Params]:
    """Graph twin of :func:`model_init`.  The shared quantizer of an
    arity-A node starts at 2*sqrt(A)/c, so the summed branch codes start
    unsaturated; every branch's BN starts at identity."""
    dev = resolve_device(device)
    spec_p, spec_s = graph_spec(cfg)
    params = _init_from_spec(spec_p, generator)
    params["in_quant"] = quant.quant_init(cfg.in_features, 0.25)
    c = max(1, 2 ** (cfg.beta - 1) - 1)
    state = {"layers": []}
    for nd, lp in zip(cfg.nodes, params["layers"]):
        lp["quant"] = quant.quant_init(nd.width,
                                       2.0 * math.sqrt(nd.arity) / c)
        bns = [({"g": torch.ones(nd.width), "b": torch.zeros(nd.width)},
                {"mean": torch.zeros(nd.width), "var": torch.ones(nd.width)})
               for _ in range(nd.arity)]
        lp["bn"] = bns[0][0] if nd.arity == 1 else [p for p, _ in bns]
        state["layers"].append({"bn": bns[0][1] if nd.arity == 1
                                else [s for _, s in bns]})
    return _to(params, dev), _to(state, dev)


def graph_pool(cfg: LUTGraphConfig, bufs: List[torch.Tensor], idx: int
               ) -> torch.Tensor:
    """Concatenate node ``idx``'s source buffers channel-wise."""
    srcs = cfg.node_sources(idx)
    if len(srcs) == 1:
        return bufs[srcs[0]]
    return torch.cat([bufs[s] for s in srcs], dim=1)


def graph_apply(cfg: LUTGraphConfig, params: Params, state: Params,
                statics: List[Dict], x: torch.Tensor, *, train: bool = False,
                exec_plan: Optional[SubnetExec] = None):
    """Graph twin of :func:`model_apply`, with the same return triple;
    ``logits`` is the classifier node's pre-quant BN output (that node
    has arity 1 by config contract)."""
    if exec_plan is None:
        exec_plan = plan_subnet_exec(
            cfg, purpose="train" if train else "eval", device=x.device)
    bufs = [quant.quant_apply(params["in_quant"], x, cfg.beta_in or cfg.beta)]
    new_states = []
    pre = None
    for i, nd in enumerate(cfg.nodes):
        pool = graph_pool(cfg, bufs, i)
        lp, ls = params["layers"][i], state["layers"][i]
        conns = node_static_conns(statics[i])
        exps = statics[i].get("exps")
        y = None
        branch_states = []
        for a, (fnp, bnp, bns) in enumerate(node_branch_params(nd, lp, ls)):
            conn = conns[a]
            if not isinstance(conn, torch.Tensor):
                conn = torch.as_tensor(np.asarray(conn))
            xg = pool[:, conn.to(device=x.device, dtype=torch.long)]
            f = exec_plan.apply(fnp, xg, exps=exps)
            pre, nbn = quant.bn_apply(bnp, bns, f, train=train,
                                      momentum=cfg.bn_momentum)
            qa = quant.quant_apply(lp["quant"], pre, cfg.beta)
            y = qa if y is None else y + qa
            branch_states.append(nbn)
        new_states.append({"bn": branch_states[0] if nd.arity == 1
                           else branch_states})
        bufs.append(y)
    return pre, bufs[-1], {"layers": new_states}


def ce_loss(logits: torch.Tensor, labels: torch.Tensor) -> torch.Tensor:
    """Mean cross-entropy, written as the reference writes it
    (logsumexp minus the label's logit)."""
    lse = torch.logsumexp(logits, dim=-1)
    ll = torch.take_along_dim(logits, labels.long()[:, None], dim=-1)[:, 0]
    return torch.mean(lse - ll)


def accuracy_from_values(values: torch.Tensor,
                         labels: torch.Tensor) -> torch.Tensor:
    return torch.mean((torch.argmax(values, dim=-1) == labels)
                      .to(torch.float32))
