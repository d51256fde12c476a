"""The deployable serving artifact, in memory (port of
``repro.serve.registry``: ``ServeBundle``, ``bundle_from_training``,
``prepack``; chain geometries).

A bundle holds what the bit-exact LUT path needs and nothing else: the
per-layer truth tables, the connectivity (which is not re-derivable
across processes, see ``core.layers.layer_static``) and the learned
quantizer scales of the input encoder and the output decoder.  The
on-disk ``TableRegistry`` is not ported yet.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Any, Dict, List, Optional

import numpy as np
import torch

from repro_torch.core.nl_config import NeuraLUTConfig, is_graph_config


@dataclass
class ServeBundle:
    """In-memory form of a converted chain model.  Arrays live on the
    host; the engine uploads them to its device once."""

    cfg: NeuraLUTConfig
    tables: List[np.ndarray]                 # [(O_i, T_i) uint16]
    statics: List[Dict[str, Any]]            # [{"conn": (O_i, F_i)}]
    in_log_s: np.ndarray                     # (in_features,) f32
    layer_log_s: List[np.ndarray]            # [(O_i,) f32]
    # Cascade operands, filled by prepack(): bit-packed tables and the
    # kernel geometry (kernels/lut_cascade.cascade_meta).
    packed_tables: Optional[List[np.ndarray]] = None  # [(O_i, T_i/P) i32]
    cascade_geom: Optional[tuple] = None

    def prepack(self) -> "ServeBundle":
        """Bit-pack every layer's table and derive the cascade geometry;
        idempotent, returns self.  Bundles built from
        ``truth_table.convert_packed`` arrive packed already."""
        from repro_torch.kernels.lut_cascade import (cascade_meta,
                                                     cascade_tables)
        if self.packed_tables is None:
            self.packed_tables = cascade_tables(self.cfg, self.tables)
        if self.cascade_geom is None:
            self.cascade_geom = cascade_meta(self.cfg)
        return self

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


def bundle_from_training(cfg: NeuraLUTConfig, params: Dict, tables: List,
                         statics: List[Dict], *,
                         packed_tables: Optional[List] = None
                         ) -> ServeBundle:
    """Extract the deployable subset of a (params, tables, statics)
    triple.  Pass the packed tables of ``truth_table.convert_packed``
    and the bundle is serving-ready on the spot."""
    if is_graph_config(cfg):
        raise NotImplementedError(
            f"{cfg.name}: LUT-graph (DAG) bundles are not ported")
    bundle = ServeBundle(
        cfg=cfg,
        tables=[_host(t) for t in tables],
        statics=[{k: _host(v) for k, v in s.items()} for s in statics],
        in_log_s=_host(params["in_quant"]["log_s"]).astype(np.float32),
        layer_log_s=[_host(lp["quant"]["log_s"]).astype(np.float32)
                     for lp in params["layers"]],
    )
    if packed_tables is not None:
        bundle.packed_tables = [_host(p).astype(np.int32)
                                for p in packed_tables]
        bundle.prepack()  # fills only cascade_geom
    return bundle
