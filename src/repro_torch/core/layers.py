"""Circuit-level NeuraLUT layer: sparse gather -> hidden function -> BN
-> quantize (port of ``repro.core.layers``)."""
from __future__ import annotations

from typing import Any, Dict, Tuple

import numpy as np
import torch

from repro_torch.core import quant, subnet
from repro_torch.core.exec_plan import SubnetExec
from repro_torch.core.nl_config import NeuraLUTConfig
from repro_torch.core.sparsity import random_connectivity

Params = Dict[str, Any]


def layer_static(cfg: NeuraLUTConfig, idx: int, in_width: int,
                 out_width: int) -> Dict[str, np.ndarray]:
    """Non-trainable per-layer constants: the connectivity, and the
    monomial exponents of the poly kind (a host array).

    Seeded by ``hash((cfg.name, idx))`` as in the reference.  Python
    salts string hashes per process, so the connectivity differs between
    processes (in both packages): carry ``conn`` with the model (the
    bridge and the serving bundle do), never recompute it.
    """
    conn = random_connectivity(in_width, out_width, cfg.layer_fan_in(idx),
                               seed=hash((cfg.name, idx)) % (2 ** 31))
    st = {"conn": conn}
    if cfg.kind == "poly":
        st["exps"] = subnet.monomial_exponents(cfg.layer_fan_in(idx),
                                               cfg.degree)
    return st


def fn_spec(cfg, fan_in: int, out_width: int) -> Params:
    """Shape tree of ``out_width`` hidden functions of ``cfg``'s kind over
    ``fan_in`` inputs (a layer's, or one branch of a graph node's)."""
    if cfg.kind == "linear":
        return subnet.linear_spec(out_width, fan_in)
    if cfg.kind == "poly":
        return subnet.poly_spec(out_width, fan_in, cfg.degree)
    return subnet.subnet_spec(out_width, fan_in, cfg.depth, cfg.width,
                              cfg.skip)


def layer_spec(cfg: NeuraLUTConfig, idx: int, out_width: int
               ) -> Tuple[Params, Params]:
    """(params, state) shape trees for one circuit layer."""
    fn = fn_spec(cfg, cfg.layer_fan_in(idx), out_width)
    bn_p, bn_s = quant.bn_spec(out_width)
    return ({"fn": fn, "bn": bn_p, "quant": quant.quant_spec(out_width)},
            {"bn": bn_s})


def layer_apply(cfg: NeuraLUTConfig, idx: int, p: Params, state: Params,
                static: Dict[str, np.ndarray], x: torch.Tensor, *,
                train: bool, exec_plan: SubnetExec
                ) -> Tuple[torch.Tensor, torch.Tensor, Params]:
    """x: (B, in_width) dequantized values.  Returns (values (B, O)
    after fake-quant, pre-quant BN output (B, O), new_state).  Training
    normalizes with the batch statistics and moves the running ones by
    ``cfg.bn_momentum``.  ``exec_plan`` picks the hidden-function
    route."""
    conn = static["conn"]
    if not isinstance(conn, torch.Tensor):
        conn = torch.as_tensor(np.asarray(conn))
    conn = conn.to(device=x.device, dtype=torch.long)  # no-op if resident
    xg = x[:, conn]                                   # (B, O, F)
    f = exec_plan.apply(p["fn"], xg, exps=static.get("exps"))
    pre, new_bn = quant.bn_apply(p["bn"], state["bn"], f, train=train,
                                 momentum=cfg.bn_momentum)
    return quant.quant_apply(p["quant"], pre, cfg.beta), pre, {"bn": new_bn}


def layer_codes(cfg: NeuraLUTConfig, p: Params,
                pre: torch.Tensor) -> torch.Tensor:
    return quant.quant_codes(p["quant"], pre, cfg.beta)
