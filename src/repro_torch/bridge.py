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

The LMs (``ModelConfig``): ``lm_params_from_numpy`` takes the
reference's LM parameter tree (``models.api.param_spec``'s layout:
``embed``, ``lm_head`` when untied, ``final_norm``, ``prefix_blocks``,
``blocks[j]`` stacked over the pattern's repeats) and
``lm_opt_from_numpy`` its AdamW state, whose ``master`` holds a float32
copy of each bfloat16 parameter.  Leaves are cast to the config's
dtype; a bfloat16 reference array converts exactly.
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


def _convert_lm(spec, tree, path: str, device: torch.device):
    """A reference LM tree (numpy) -> tensors of the spec's dtypes,
    checked key by key and shape by shape; ``None`` where the spec
    leaf is ``None``."""
    if spec is None:
        if tree is not None:
            raise ValueError(f"{path}: expected None")
        return None
    if isinstance(spec, dict):
        if not isinstance(tree, dict) or set(tree) != set(spec):
            got = sorted(tree) if isinstance(tree, dict) else type(tree)
            raise ValueError(f"{path or 'tree'}: keys {got} != "
                             f"{sorted(spec)}")
        return {k: _convert_lm(spec[k], tree[k], f"{path}.{k}".lstrip("."),
                               device) for k in spec}
    if isinstance(spec, list):
        if not isinstance(tree, (list, tuple)) or len(tree) != len(spec):
            raise ValueError(f"{path}: expected a list of {len(spec)}")
        return [_convert_lm(sp, t, f"{path}[{i}]", device)
                for i, (sp, t) in enumerate(zip(spec, tree))]
    if tree is None:
        raise ValueError(f"{path}: missing leaf")
    a = np.asarray(tree, np.float32)
    if a.shape != tuple(spec.shape):
        raise ValueError(f"{path}: shape {a.shape} != {tuple(spec.shape)}")
    return torch.as_tensor(a.copy()).to(spec.dtype).to(device)


def lm_params_from_numpy(cfg, tree: Dict[str, Any], *,
                         device: DeviceLike = None) -> Dict[str, Any]:
    """The reference's LM parameters as nested numpy arrays -> the
    port's tensor tree on ``device`` (``None`` = CUDA), in the
    config's dtype."""
    from repro_torch.models import api
    return _convert_lm(api.param_spec(cfg), tree, "", resolve_device(device))


def lm_opt_from_numpy(cfg, opt: Dict[str, Any], *,
                      device: DeviceLike = None) -> Dict[str, Any]:
    """The reference's AdamW state of an LM (``m``, ``v``, ``count``,
    ``master``) as numpy -> the port's: float32 moments, an int32
    count and, for a bfloat16 config, the float32 ``master`` tree
    (``None`` at float32 leaves); a float32 config's ``master`` must be
    all None and is dropped, as ``adamw_init`` drops it."""
    from repro_torch.models import api
    from repro_torch.models.layers.common import TensorSpec
    from repro_torch.tree import tree_leaves, tree_map
    dev = resolve_device(device)
    spec = api.param_spec(cfg)
    f32 = tree_map(lambda s: TensorSpec(s.shape, torch.float32), spec)
    out = {"m": _convert_lm(f32, opt["m"], "m", dev),
           "v": _convert_lm(f32, opt["v"], "v", dev),
           "count": torch.as_tensor(
               np.asarray(opt["count"]).astype(np.int32), device=dev)}
    masters = tree_map(lambda s: TensorSpec(s.shape, torch.float32)
                       if s.dtype == torch.bfloat16 else None, spec)
    got = opt.get("master")
    if any(m is not None for m in tree_leaves(masters)):
        out["master"] = _convert_lm(masters, got, "master", dev)
    elif got is not None:
        _convert_lm(masters, got, "master", dev)  # must be all None
    return out


def params_to_numpy(tree) -> Any:
    """A port tree (params, state, grads or opt state) -> the same nested
    dicts and lists of numpy arrays, in the reference's layout
    (bfloat16 leaves as float32, ``None`` kept)."""
    if tree is None:
        return None
    if isinstance(tree, dict):
        return {k: params_to_numpy(v) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return [params_to_numpy(v) for v in tree]
    t = tree.detach().cpu()
    return (t.float() if t.dtype == torch.bfloat16 else t).numpy()
