"""Bridge from the JAX package's model trees to the port's.

The JAX package draws its parameters from ``jax.random``, which the
port cannot reproduce, and seeds its connectivity with the per-process
salted ``hash`` (``core/layers.layer_static``).  To hold the port to the
reference on the same model, a caller converts the reference's trees to
nested numpy arrays (``jax.tree.map(np.asarray, tree)``) and hands them
here.  This module imports no jax; the keys are the reference's:

    params: in_quant.log_s,
            layers[i].fn.layers[j].{w,b}, layers[i].fn.skips[c].{w,b},
            layers[i].bn.{g,b}, layers[i].quant.log_s
    state:  layers[i].bn.{mean,var}
    statics: layers[i].conn (and layers[i].exps for the poly kind)
    opt:    m, v (trees like params), count; the reference's ``master``
            tree is all None for float32 params and has no counterpart

A LUT graph (``LUTGraphConfig``) has the same trees per node, except
that an arity-A node (A > 1) holds per-branch lists ``fn[a]``, ``bn[a]``
and, in the state, ``bn[a]`` (one shared ``quant``), and its statics are
``{"conns": [conn_0, ..., conn_{A-1}]}``.

With ``seeds=S`` every leaf carries a leading seed axis S (the seed
ensemble's stacked trees; the optimizer's ``count`` is then (S,)).
``params_to_numpy`` goes the other way, so a test can start both
packages from one state and compare the trees leaf by leaf.
"""
from __future__ import annotations

from typing import Any, Dict, List, Optional, Tuple

import numpy as np
import torch

from repro_torch.core.model import model_spec, node_static_conns
from repro_torch.core.nl_config import NeuraLUTConfig, is_graph_config
from repro_torch.core.subnet import monomial_exponents
from repro_torch.device import DeviceLike, resolve_device


def _lead(seeds: Optional[int]) -> Tuple[int, ...]:
    if seeds is None:
        return ()
    if seeds < 1:
        raise ValueError(f"seeds={seeds} must be >= 1")
    return (int(seeds),)


def _convert(spec, tree, path: str, device: torch.device,
             lead: Tuple[int, ...] = ()):
    if isinstance(spec, dict):
        if not isinstance(tree, dict) or set(tree) != set(spec):
            got = sorted(tree) if isinstance(tree, dict) else type(tree)
            raise ValueError(f"{path or 'tree'}: keys {got} != "
                             f"{sorted(spec)}")
        return {k: _convert(spec[k], tree[k], f"{path}.{k}".lstrip("."),
                            device, lead) for k in spec}
    if isinstance(spec, list):
        if not isinstance(tree, (list, tuple)) or len(tree) != len(spec):
            raise ValueError(f"{path}: expected a list of {len(spec)}")
        return [_convert(s, t, f"{path}[{i}]", device, lead)
                for i, (s, t) in enumerate(zip(spec, tree))]
    a = np.asarray(tree, np.float32)
    if a.shape != lead + tuple(spec):
        raise ValueError(f"{path}: shape {a.shape} != "
                         f"{lead + tuple(spec)}")
    return torch.as_tensor(a.copy(), device=device)


def params_from_numpy(cfg, params: Dict[str, Any],
                      state: Dict[str, Any], *,
                      device: DeviceLike = None,
                      seeds: Optional[int] = None
                      ) -> Tuple[Dict[str, Any], Dict[str, Any]]:
    """Reference (params, state) as nested numpy arrays -> the port's
    float32 tensor trees on ``device`` (``None`` = CUDA), checked
    against the port's shape trees key by key (with a leading seed axis
    when ``seeds`` is given)."""
    dev = resolve_device(device)
    spec_p, spec_s = model_spec(cfg)
    lead = _lead(seeds)
    return (_convert(spec_p, params, "", dev, lead),
            _convert(spec_s, state, "", dev, lead))


def _check_conn(where: str, conn, shape, width: int) -> np.ndarray:
    conn = np.asarray(conn).astype(np.int32)
    if conn.shape != shape:
        raise ValueError(f"{where}: conn {conn.shape} != {shape}")
    if conn.size and (conn.min() < 0 or conn.max() >= width):
        raise ValueError(f"{where}: conn outside [0, {width})")
    return conn


def statics_from_numpy(cfg, statics: List[Dict[str, Any]]
                       ) -> List[Dict[str, Any]]:
    """Reference statics -> the port's, as int32 numpy checked against
    each layer's (O, F) and source width: ``{"conn"}`` per chain layer,
    ``{"conns": [...]}`` (one per branch, over the node's concatenated
    source pool of ``node_in_width(i)`` channels) per graph node; for
    the poly kind also ``exps``, which must equal
    ``subnet.monomial_exponents(F, degree)``."""
    if len(statics) != cfg.num_layers:
        raise ValueError(f"{len(statics)} statics for "
                         f"{cfg.num_layers} layers")
    out = []
    for i, st in enumerate(statics):
        f, where = cfg.layer_fan_in(i), f"layer {i}"
        if is_graph_config(cfg):
            nd = cfg.nodes[i]
            conns = node_static_conns(st)
            if len(conns) != nd.arity:
                raise ValueError(f"node {i}: {len(conns)} conns for "
                                 f"arity {nd.arity}")
            d = {"conns": [
                _check_conn(f"node {i} branch {a}", c,
                            (nd.width, f), cfg.node_in_width(i))
                for a, c in enumerate(conns)]}
        else:
            w_prev = cfg.in_features if i == 0 else cfg.layer_widths[i - 1]
            d = {"conn": _check_conn(where, st["conn"],
                                     (cfg.layer_widths[i], f), w_prev)}
        if cfg.kind == "poly":
            want = monomial_exponents(f, cfg.degree)
            if "exps" not in st or not np.array_equal(st["exps"], want):
                raise ValueError(f"{where}: exps missing or not the "
                                 f"monomials of degree <= {cfg.degree} in "
                                 f"{f} inputs")
            d["exps"] = want
        out.append(d)
    return out


def opt_from_numpy(cfg: NeuraLUTConfig, opt: Dict[str, Any], *,
                   device: DeviceLike = None,
                   seeds: Optional[int] = None) -> Dict[str, Any]:
    """Reference AdamW state (``m``, ``v``, ``count``, ``master``) as
    numpy -> the port's (``m``, ``v``, ``count``), with a leading seed
    axis when ``seeds`` is given.  ``master`` must be all None:
    NeuraLUT's parameters are float32, so the reference keeps no master
    copy."""
    dev = resolve_device(device)
    masters = opt.get("master")
    stack = [masters]
    while stack:
        t = stack.pop()
        if isinstance(t, dict):
            stack.extend(t.values())
        elif isinstance(t, (list, tuple)):
            stack.extend(t)
        elif t is not None:
            raise ValueError("the reference opt state holds a master copy; "
                             "the port trains float32 parameters only")
    spec_p, _ = model_spec(cfg)
    lead = _lead(seeds)
    count = np.asarray(opt["count"])
    if count.shape != lead:
        raise ValueError(f"count: shape {count.shape} != {lead}")
    return {"m": _convert(spec_p, opt["m"], "m", dev, lead),
            "v": _convert(spec_p, opt["v"], "v", dev, lead),
            "count": torch.as_tensor(count.astype(np.int32), device=dev)}


def params_to_numpy(tree) -> Any:
    """A port tree (params, state, grads or opt state) -> the same nested
    dicts and lists of numpy arrays, in the reference's layout."""
    if isinstance(tree, dict):
        return {k: params_to_numpy(v) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return [params_to_numpy(v) for v in tree]
    return tree.detach().cpu().numpy()
