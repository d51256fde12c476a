"""Full NeuraLUT circuit-level model: input quantizer + stacked layers
(port of ``repro.core.model``, chain geometries; eval and training
forward).

API (parameters are nested dicts of tensors with the reference's keys):
    statics   = model_static(cfg)                 # connectivity
    p, s      = model_init(cfg, generator, device=...)
    p         = calibrate_in_quant(cfg, p, x_train)
    logits, values, s = model_apply(cfg, p, s, statics, x, train=...)
    loss      = ce_loss(logits, labels)
"""
from __future__ import annotations

import math
from typing import Any, Dict, List, Optional, Tuple

import numpy as np
import torch

from repro_torch.core import layers as L
from repro_torch.core import quant
from repro_torch.core.exec_plan import SubnetExec, plan_subnet_exec
from repro_torch.core.nl_config import NeuraLUTConfig, is_graph_config
from repro_torch.device import DeviceLike, resolve_device

Params = Dict[str, Any]


def _chain_only(cfg) -> None:
    if is_graph_config(cfg):
        raise NotImplementedError(
            f"{cfg.name}: LUT-graph (DAG) models are not ported; the port "
            "serves chain geometries")


def model_widths(cfg: NeuraLUTConfig) -> List[int]:
    return [cfg.in_features] + list(cfg.layer_widths)


def model_static(cfg: NeuraLUTConfig) -> List[Dict]:
    _chain_only(cfg)
    w = model_widths(cfg)
    return [L.layer_static(cfg, i, w[i], w[i + 1])
            for i in range(cfg.num_layers)]


def model_spec(cfg: NeuraLUTConfig) -> Tuple[Params, Params]:
    """(params, state) shape trees: tuples at the leaves, the
    reference's keys above them."""
    _chain_only(cfg)
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


def model_init(cfg: NeuraLUTConfig, generator: torch.Generator, *,
               device: DeviceLike = None) -> Tuple[Params, Params]:
    """Random parameters and BN state, drawn on the CPU from
    ``generator`` and moved to ``device`` (``None`` = CUDA).  Quantizer
    scales start at 0.25 (inputs) and 2/c (layer outputs, c the largest
    positive code), BN at identity."""
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


def calibrate_in_quant(cfg: NeuraLUTConfig, params: Params,
                       x_train) -> Params:
    """+-2.5 sigma per feature spans the signed input code range.
    Returns ``params`` with ``in_quant.log_s`` replaced."""
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
    """``statics`` with every ``conn`` as an int64 tensor on ``device``,
    so a training step moves no connectivity to the device."""
    return [{k: torch.as_tensor(np.asarray(v)).to(device, torch.long)
             for k, v in st.items()} for st in statics]


def model_apply(cfg: NeuraLUTConfig, params: Params, state: Params,
                statics: List[Dict], x: torch.Tensor, *,
                train: bool = False, exec_plan: Optional[SubnetExec] = None):
    """x: (B, in_features) raw features -> (logits (B, classes)
    pre-quant, quantized class values, new_state).  ``train=True``
    normalizes with batch statistics and threads the BN state;
    ``exec_plan`` routes every layer's hidden function (None: the
    planner default for the purpose on ``x``'s device)."""
    _chain_only(cfg)
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
