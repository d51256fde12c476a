"""The deployable serving artifact, in memory (port of
``repro.serve.registry``: ``ServeBundle``, ``bundle_from_training``,
``prepack``, ``topology``).

A bundle holds what the bit-exact LUT path needs and nothing else: the
per-layer truth tables, the connectivity (which is not re-derivable
across processes, see ``core.layers.layer_static``) and the learned
quantizer scales of the input encoder and the output decoder.  A LUT
graph's bundle holds per-node lists of branch tables and ``{"conns":
[...]}`` statics; its packed tables are flat in (node, branch) order,
the kernel's operand order, as in the reference.  The on-disk
``TableRegistry`` is not ported yet.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Any, Dict, List, Optional, Union

import numpy as np
import torch

from repro_torch.core.nl_config import (LUTGraphConfig, NeuraLUTConfig,
                                        is_graph_config)
from repro_torch.core.subnet import monomial_exponents


@dataclass
class ServeBundle:
    """In-memory form of a converted model, chain or LUT graph.  Arrays
    live on the host; the engine uploads them to its device once."""

    cfg: Union[NeuraLUTConfig, LUTGraphConfig]
    tables: List              # chain [(O_i, T_i) uint16]; graph per node
    #                           [[(O_i, T_i) uint16] per branch]
    statics: List[Dict[str, Any]]  # [{"conn"}] / [{"conns": [...]}],
    #                                 and "exps" for the poly kind
    in_log_s: np.ndarray                     # (in_features,) f32
    layer_log_s: List[np.ndarray]            # [(O_i,) f32]
    # Cascade operands, filled by prepack(): bit-packed tables, flat in
    # (node, branch) order, and the kernel geometry
    # (kernels/lut_cascade.cascade_meta / graph_cascade_meta).
    packed_tables: Optional[List[np.ndarray]] = None  # [(O, T/P) int32]
    cascade_geom: Optional[tuple] = None

    def prepack(self) -> "ServeBundle":
        """Bit-pack every table and derive the cascade geometry;
        idempotent, returns self.  Bundles built from
        ``truth_table.convert_packed`` arrive packed already."""
        from repro_torch.kernels.lut_cascade import (cascade_meta,
                                                     cascade_tables,
                                                     graph_cascade_meta,
                                                     graph_cascade_tables)
        graph = is_graph_config(self.cfg)
        if self.packed_tables is None:
            self.packed_tables = (graph_cascade_tables if graph
                                  else cascade_tables)(self.cfg, self.tables)
        if self.cascade_geom is None:
            self.cascade_geom = (graph_cascade_meta if graph
                                 else cascade_meta)(self.cfg)
        return self

    @property
    def topology(self) -> tuple:
        """Structural descriptor of the LUT network: ``("chain",
        layer_widths)`` for a chain, ``("dag", per-node (name, width,
        fan_in, inputs, arity))`` for a graph, as the reference's."""
        if not is_graph_config(self.cfg):
            return ("chain", tuple(self.cfg.layer_widths))
        return ("dag", tuple((n.name, n.width, n.fan_in, tuple(n.inputs),
                              n.arity) for n in self.cfg.nodes))

    def serve_params(self, device: torch.device) -> Dict[str, Any]:
        """The params subset ``core.lut_infer`` (input_codes /
        class_values) reads, as tensors on ``device``."""
        def t(a):
            return torch.as_tensor(np.asarray(a, np.float32), device=device)
        return {"in_quant": {"log_s": t(self.in_log_s)},
                "layers": [{"quant": {"log_s": t(s)}}
                           for s in self.layer_log_s]}


def _host(a) -> np.ndarray:
    return a.detach().cpu().numpy() if isinstance(a, torch.Tensor) \
        else np.asarray(a)


def _host_tree(v):
    """Arrays (and lists of them, as a node's branches) on the host."""
    if isinstance(v, (list, tuple)):
        return [_host(a) for a in v]
    return _host(v)


def bundle_from_training(cfg, params: Dict, tables: List,
                         statics: List[Dict], *,
                         packed_tables: Optional[List] = None
                         ) -> ServeBundle:
    """Extract the deployable subset of a (params, tables, statics)
    triple, chain or LUT graph (per-node table lists from
    ``truth_table.convert_graph``).  Pass the packed tables of
    ``truth_table.convert_packed`` (per-node lists for a graph) and the
    bundle is serving-ready on the spot.  A poly model's statics carry
    its monomial exponents, as the reference's registry restores them."""
    if is_graph_config(cfg):
        tables = [node if isinstance(node, (list, tuple)) else [node]
                  for node in tables]
    statics = [{k: _host_tree(v) for k, v in s.items()} for s in statics]
    if cfg.kind == "poly":
        for i, s in enumerate(statics):
            s["exps"] = monomial_exponents(cfg.layer_fan_in(i), cfg.degree)
    bundle = ServeBundle(
        cfg=cfg,
        tables=[_host_tree(t) for t in tables],
        statics=statics,
        in_log_s=_host(params["in_quant"]["log_s"]).astype(np.float32),
        layer_log_s=[_host(lp["quant"]["log_s"]).astype(np.float32)
                     for lp in params["layers"]],
    )
    if packed_tables is not None:
        flat = [p for node in packed_tables
                for p in (node if isinstance(node, (list, tuple))
                          else [node])]
        bundle.packed_tables = [_host(p).astype(np.int32) for p in flat]
        bundle.prepack()  # fills only cascade_geom
    return bundle
