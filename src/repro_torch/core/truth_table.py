"""Sub-network -> L-LUT conversion (port of ``repro.core.truth_table``).

For every layer (every branch of every node of a LUT graph) all
2^{beta_in * F} input code combinations are enumerated on the device of
the parameters, dequantized with the *source* channel's learned scale,
run through the hidden function (the route of a ``SubnetExec``: for the
subnet kind the CUDA kernel on the card and the canonical grouped
product on the CPU; the linear and poly kinds' plain product anywhere),
batch-normed in eval mode, quantized back to codes and bit-packed on
the device.  The sweep runs a layer in
chunks of ``SWEEP_BATCH`` codes; the chunking bounds memory and does not
change the result.  A graph node converts once per branch, each branch
with its own connectivity, hidden function and BN and the node's one
shared quantizer; a node that reads an adder node dequantizes its
``beta + log2 A``-bit summed codes with offset 2^(beta + log2 A - 1) and
that node's shared scale, the formula of a plain code at more bits.
"""
from __future__ import annotations

from typing import Dict, List, Optional, Tuple

import numpy as np
import torch

from repro_torch.core import quant
from repro_torch.core.exec_plan import SubnetExec, plan_subnet_exec
from repro_torch.core.lut_infer import pack_tables_torch, packed_slots
from repro_torch.core.model import node_branch_params, node_static_conns
from repro_torch.core.nl_config import LUTGraphConfig, is_graph_config
from repro_torch.core.subnet import monomial_exponents

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


def _guard_size(cfg, layer_idx: int) -> None:
    beta_in = cfg.layer_in_bits(layer_idx)
    fan_in = cfg.layer_fan_in(layer_idx)
    if beta_in * fan_in > 20:
        raise ValueError(
            f"layer {layer_idx}: truth table would have "
            f"2^{beta_in * fan_in} entries (beta_in={beta_in} x "
            f"fan_in={fan_in} > 20 address bits); reduce beta/fan-in "
            f"instead of enumerating it")


def _sweep(cfg, idx: int, slot_scale: torch.Tensor, fn: Params,
           bn_p: Params, bn_s: Params, quant_p: Params, *,
           exec_plan: SubnetExec
           ) -> Tuple[torch.Tensor, Optional[torch.Tensor]]:
    """One table of layer (or node) ``idx`` -> ((O, T) int32 codes,
    (O, T // P) int32 packed words or None when T < P), both on the
    device of ``slot_scale``, the (O, F) scale of each fan-in slot's
    source channel."""
    _guard_size(cfg, idx)
    beta_in = cfg.layer_in_bits(idx)
    fan_in = cfg.layer_fan_in(idx)
    t = cfg.table_size(idx)
    dev = slot_scale.device
    shifts = torch.tensor([beta_in * (fan_in - 1 - j)
                           for j in range(fan_in)], device=dev)
    offs = 2 ** (beta_in - 1)
    exps = (monomial_exponents(fan_in, exec_plan.degree)
            if exec_plan.kind == "poly" else None)
    chunks = []
    for start in range(0, t, SWEEP_BATCH):
        codes_i = torch.arange(start, min(start + SWEEP_BATCH, t), device=dev)
        codes = (codes_i[:, None] >> shifts[None, :]) & (2 ** beta_in - 1)
        # (chunk, O, F) dequantized values: scale of the SOURCE channel.
        vals = (codes[:, None, :].to(torch.float32) - offs) * slot_scale[None]
        f = exec_plan.apply(fn, vals, exps=exps)
        pre, _ = quant.bn_apply(bn_p, bn_s, f, train=False)
        chunks.append(quant.quant_codes(quant_p, pre, cfg.beta))
    table = torch.cat(chunks).T.contiguous()                   # (O, T)
    packed = (pack_tables_torch(table, cfg.beta)
              if t % packed_slots(cfg.beta) == 0 else None)
    return table, packed


def _graph_pool_scales(cfg: LUTGraphConfig, params: Params, idx: int
                       ) -> torch.Tensor:
    """Per-channel scale of node ``idx``'s concatenated source pool.  An
    adder-tree source's summed code dequantizes with its one shared
    quantizer scale."""
    parts = [torch.exp(params["in_quant"]["log_s"]) if b == 0
             else torch.exp(params["layers"][b - 1]["quant"]["log_s"])
             for b in cfg.node_sources(idx)]
    return parts[0] if len(parts) == 1 else torch.cat(parts)


def _graph_node_sweep(cfg: LUTGraphConfig, params: Params, state: Params,
                      statics: List[Dict], idx: int, *,
                      exec_plan: SubnetExec
                      ) -> Tuple[List[torch.Tensor],
                                 List[Optional[torch.Tensor]]]:
    """One node -> (per-branch tables, per-branch packed words or None),
    one hidden-function sweep per branch (statics ``{"conns"}`` or a
    chain layer's ``{"conn"}``)."""
    scales = _graph_pool_scales(cfg, params, idx)
    lp, ls = params["layers"][idx], state["layers"][idx]
    tables, packeds = [], []
    for conn, (fn, bn_p, bn_s) in zip(
            node_static_conns(statics[idx]),
            node_branch_params(cfg.nodes[idx], lp, ls)):
        conn = torch.as_tensor(np.asarray(conn), device=scales.device).long()
        table, packed = _sweep(cfg, idx, scales[conn], fn, bn_p, bn_s,
                               lp["quant"], exec_plan=exec_plan)
        tables.append(table)
        packeds.append(packed)
    return tables, packeds


def _convert_plan(cfg, params: Params,
                  use_subnet_kernel: Optional[bool]) -> SubnetExec:
    """The convert-purpose plan on the parameters' device (kernel on
    CUDA, canonical on the CPU); ``use_subnet_kernel`` forces a side."""
    route = None
    if use_subnet_kernel is not None:
        route = "kernel_infer" if use_subnet_kernel else "canonical"
    return plan_subnet_exec(cfg, purpose="convert", route=route,
                            device=params["in_quant"]["log_s"].device)


def _host_u16(t: torch.Tensor) -> np.ndarray:
    return t.cpu().numpy().astype(np.uint16)


def _require_packed(cfg, idx: int, packed) -> None:
    if packed is None:
        raise ValueError(
            f"layer {idx}: table size {cfg.table_size(idx)} smaller than "
            f"the packed word capacity {packed_slots(cfg.beta)} "
            f"(beta={cfg.beta}); geometry not servable bit-packed")


def layer_truth_table(cfg, params: Params, state: Params,
                      statics: List[Dict], layer_idx: int, *,
                      use_subnet_kernel: Optional[bool] = None
                      ) -> np.ndarray:
    """uint16 (out_width, 2^{beta_in*F}) output codes for one layer of
    a chain."""
    plan = _convert_plan(cfg, params, use_subnet_kernel)
    tables, _ = _graph_node_sweep(cfg.graph(), params, state, statics,
                                  layer_idx, exec_plan=plan)
    return _host_u16(tables[0])


def convert(cfg, params: Params, state: Params,
            statics: List[Dict], *,
            use_subnet_kernel: Optional[bool] = None) -> List:
    """All layers' truth tables on the host: [(O_i, T_i) uint16] for a
    chain; for a ``LUTGraphConfig`` :func:`convert_graph` (per-node
    lists of branch tables).  A chain converts as its one-branch
    graph."""
    if is_graph_config(cfg):
        return convert_graph(cfg, params, state, statics,
                             use_subnet_kernel=use_subnet_kernel)
    return [node[0] for node in convert_graph(
        cfg.graph(), params, state, statics,
        use_subnet_kernel=use_subnet_kernel)]


def convert_packed(cfg, params: Params, state: Params,
                   statics: List[Dict], *,
                   use_subnet_kernel: Optional[bool] = None
                   ) -> Tuple[List, List]:
    """All layers' tables in both forms on the host: ([(O, T) uint16],
    [(O, T // P) int32 bit-packed words]), packed on the device.  For a
    ``LUTGraphConfig`` :func:`convert_graph_packed` (per-node lists in
    both slots)."""
    if is_graph_config(cfg):
        return convert_graph_packed(cfg, params, state, statics,
                                    use_subnet_kernel=use_subnet_kernel)
    tables, packed = convert_graph_packed(
        cfg.graph(), params, state, statics,
        use_subnet_kernel=use_subnet_kernel)
    return [node[0] for node in tables], [node[0] for node in packed]


def convert_graph(cfg: LUTGraphConfig, params: Params, state: Params,
                  statics: List[Dict], *,
                  use_subnet_kernel: Optional[bool] = None
                  ) -> List[List[np.ndarray]]:
    """Per-node truth tables: ``out[i]`` is node i's list of (O, T)
    uint16 branch tables."""
    plan = _convert_plan(cfg, params, use_subnet_kernel)
    return [[_host_u16(t) for t in _graph_node_sweep(
        cfg, params, state, statics, i, exec_plan=plan)[0]]
        for i in range(cfg.num_layers)]


def convert_graph_packed(cfg: LUTGraphConfig, params: Params, state: Params,
                         statics: List[Dict], *,
                         use_subnet_kernel: Optional[bool] = None
                         ) -> Tuple[List[List[np.ndarray]],
                                    List[List[np.ndarray]]]:
    """Graph twin of :func:`convert_packed`: per-node lists of
    ([unpacked uint16], [bit-packed int32]) branch tables; the hidden
    function runs once per branch."""
    plan = _convert_plan(cfg, params, use_subnet_kernel)
    all_tables, all_packed = [], []
    for i in range(cfg.num_layers):
        tables, packeds = _graph_node_sweep(cfg, params, state, statics, i,
                                            exec_plan=plan)
        for p in packeds:
            _require_packed(cfg, i, p)
        all_tables.append([_host_u16(t) for t in tables])
        all_packed.append([p.cpu().numpy() for p in packeds])
    return all_tables, all_packed
