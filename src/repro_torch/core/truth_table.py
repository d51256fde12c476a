"""Sub-network -> L-LUT conversion (port of ``repro.core.truth_table``,
chain geometries).

For every layer all 2^{beta_in * F} input code combinations are
enumerated on the device of the parameters, dequantized with the
*source* channel's learned scale, run through the hidden function (the
route of a ``SubnetExec``: the CUDA kernel on the card, the canonical
grouped product on the CPU), batch-normed in eval mode, quantized back
to codes and bit-packed on the device.  The sweep runs a layer in
chunks of ``SWEEP_BATCH`` codes; the chunking bounds memory and does not
change the result.
"""
from __future__ import annotations

from typing import Dict, List, Optional, Tuple

import numpy as np
import torch

from repro_torch.core import quant
from repro_torch.core.exec_plan import SubnetExec, plan_subnet_exec
from repro_torch.core.lut_infer import pack_tables_torch, packed_slots
from repro_torch.core.nl_config import NeuraLUTConfig, is_graph_config

Params = Dict

# Codes per hidden-function call: every jsc-5l layer (at most 2^14
# codes) converts in one launch.
SWEEP_BATCH = 1 << 16


def enumerate_codes(beta: int, fan_in: int) -> np.ndarray:
    """(2^{beta*F}, F) all code combinations; slot 0 is the MSB of the LUT
    address (matches lut_infer.pack_index)."""
    t = 2 ** (beta * fan_in)
    idx = np.arange(t, dtype=np.int64)
    cols = []
    for j in range(fan_in):
        shift = beta * (fan_in - 1 - j)
        cols.append((idx >> shift) & (2 ** beta - 1))
    return np.stack(cols, axis=1).astype(np.int32)


def _guard_size(cfg: NeuraLUTConfig, layer_idx: int) -> None:
    beta_in = cfg.layer_in_bits(layer_idx)
    fan_in = cfg.layer_fan_in(layer_idx)
    if beta_in * fan_in > 20:
        raise ValueError(
            f"layer {layer_idx}: truth table would have "
            f"2^{beta_in * fan_in} entries (beta_in={beta_in} x "
            f"fan_in={fan_in} > 20 address bits); reduce beta/fan-in "
            f"instead of enumerating it")


def _input_scales(params: Params, layer_idx: int) -> torch.Tensor:
    """Per-source-channel scale of the inputs feeding ``layer_idx``."""
    if layer_idx == 0:
        return torch.exp(params["in_quant"]["log_s"])
    return torch.exp(params["layers"][layer_idx - 1]["quant"]["log_s"])


def _layer_sweep(cfg: NeuraLUTConfig, params: Params, state: Params,
                 statics: List[Dict], layer_idx: int, *,
                 exec_plan: SubnetExec
                 ) -> Tuple[torch.Tensor, Optional[torch.Tensor]]:
    """One layer -> ((O, T) int32 codes, (O, T // P) int32 packed words
    or None when T < P), both on the parameters' device."""
    _guard_size(cfg, layer_idx)
    beta_in = cfg.layer_in_bits(layer_idx)
    fan_in = cfg.layer_fan_in(layer_idx)
    t = cfg.table_size(layer_idx)
    scales = _input_scales(params, layer_idx)
    dev = scales.device
    conn = torch.as_tensor(np.asarray(statics[layer_idx]["conn"]),
                           device=dev).long()
    slot_scale = scales[conn]                                  # (O, F)
    shifts = torch.tensor([beta_in * (fan_in - 1 - j)
                           for j in range(fan_in)], device=dev)
    offs = 2 ** (beta_in - 1)
    lp = params["layers"][layer_idx]
    bn_s = state["layers"][layer_idx]["bn"]
    chunks = []
    for start in range(0, t, SWEEP_BATCH):
        idx = torch.arange(start, min(start + SWEEP_BATCH, t), device=dev)
        codes = (idx[:, None] >> shifts[None, :]) & (2 ** beta_in - 1)
        # (chunk, O, F) dequantized values: scale of the SOURCE channel.
        vals = (codes[:, None, :].to(torch.float32) - offs) * slot_scale[None]
        f = exec_plan.apply(lp["fn"], vals)
        pre, _ = quant.bn_apply(lp["bn"], bn_s, f, train=False)
        chunks.append(quant.quant_codes(lp["quant"], pre, cfg.beta))
    table = torch.cat(chunks).T.contiguous()                   # (O, T)
    packed = (pack_tables_torch(table, cfg.beta)
              if t % packed_slots(cfg.beta) == 0 else None)
    return table, packed


def _convert_plan(cfg: NeuraLUTConfig, params: Params,
                  use_subnet_kernel: Optional[bool]) -> SubnetExec:
    """The convert-purpose plan on the parameters' device (kernel on
    CUDA, canonical on the CPU); ``use_subnet_kernel`` forces a side."""
    route = None
    if use_subnet_kernel is not None:
        route = "kernel_infer" if use_subnet_kernel else "canonical"
    return plan_subnet_exec(cfg, purpose="convert", route=route,
                            device=params["in_quant"]["log_s"].device)


def _chain_only(cfg) -> None:
    if is_graph_config(cfg):
        raise NotImplementedError(
            f"{cfg.name}: LUT-graph (DAG) conversion is not ported")


def convert(cfg: NeuraLUTConfig, params: Params, state: Params,
            statics: List[Dict], *,
            use_subnet_kernel: Optional[bool] = None) -> List[np.ndarray]:
    """All layers' truth tables: [(O_i, T_i) uint16] on the host."""
    _chain_only(cfg)
    plan = _convert_plan(cfg, params, use_subnet_kernel)
    return [_layer_sweep(cfg, params, state, statics, i, exec_plan=plan)[0]
            .cpu().numpy().astype(np.uint16)
            for i in range(cfg.num_layers)]


def convert_packed(cfg: NeuraLUTConfig, params: Params, state: Params,
                   statics: List[Dict], *,
                   use_subnet_kernel: Optional[bool] = None
                   ) -> Tuple[List[np.ndarray], List[np.ndarray]]:
    """All layers' tables in both forms on the host: ([(O, T) uint16],
    [(O, T // P) int32 bit-packed words]), packed on the device."""
    _chain_only(cfg)
    plan = _convert_plan(cfg, params, use_subnet_kernel)
    tables, packeds = [], []
    for i in range(cfg.num_layers):
        table, packed = _layer_sweep(cfg, params, state, statics, i,
                                     exec_plan=plan)
        if packed is None:
            raise ValueError(
                f"layer {i}: table size {cfg.table_size(i)} smaller than "
                f"the packed word capacity {packed_slots(cfg.beta)} "
                f"(beta={cfg.beta}); geometry not servable bit-packed")
        tables.append(table.cpu().numpy().astype(np.uint16))
        packeds.append(packed.cpu().numpy())
    return tables, packeds
