"""Bit-exact LUT-network inference on integer codes (port of
``repro.core.lut_infer``).

``lut_forward`` (chains) and ``graph_lut_forward`` (LUT graphs) are the
integer oracles: what the generated ROMs compute, and what every
cascade route — the plain gather cascade of ``kernels/ref.py`` and the
CUDA kernel of ``kernels/lut_cascade.py`` — must equal bit for bit.
The packed-word format is the JAX package's: ``pack_tables`` here emits
the same int32 words.
"""
from __future__ import annotations

import functools
from typing import Dict, List, Optional, Sequence

import numpy as np
import torch

from repro_torch.core import quant
from repro_torch.core.nl_config import (LUTGraphConfig, NeuraLUTConfig,
                                        is_graph_config)

Params = Dict


def shift_weights(beta: int, fan_in: int) -> np.ndarray:
    """(F,) int32 place values of each fan-in slot; slot 0 = MSB."""
    return np.asarray([1 << (beta * (fan_in - 1 - j))
                       for j in range(fan_in)], np.int32)


@functools.lru_cache(maxsize=None)
def _shift_tensor(beta: int, fan_in: int, device: torch.device
                  ) -> torch.Tensor:
    return torch.as_tensor(shift_weights(beta, fan_in), device=device)


def pack_index(codes: torch.Tensor, beta: int) -> torch.Tensor:
    """codes: (..., F) -> int32 LUT addresses,
    ``addr = sum_j codes[..., j] << (beta * (F-1-j))``.  The place
    values are uploaded once per (beta, F, device), so a call on the
    card copies nothing from the host."""
    w = _shift_tensor(beta, codes.shape[-1], codes.device)
    return (codes.to(torch.int32) * w).sum(-1, dtype=torch.int32)


def packed_slots(beta: int) -> int:
    """Codes per int32 word when bit-packing ``beta``-bit codes: the
    largest power of two <= 32 // beta."""
    if not 1 <= beta <= 16:
        raise ValueError(f"beta={beta} not packable into int32 words")
    return 1 << ((32 // beta).bit_length() - 1)


def pack_tables(table: np.ndarray, beta: int) -> np.ndarray:
    """(O, T) beta-bit codes -> (O, T // P) int32 bit-packed words.

    Word ``w`` holds table entries ``w*P + p`` for p in [0, P); entry p
    occupies bits [beta*p, beta*(p+1))."""
    p = packed_slots(beta)
    t = np.asarray(table)
    if t.ndim != 2:
        raise ValueError(f"table must be (O, T), got {t.shape}")
    o, n = t.shape
    if n % p:
        raise ValueError(f"table size {n} not a multiple of P={p} "
                         f"(beta={beta})")
    if t.size and (t.min() < 0 or t.max() >= (1 << beta)):
        raise ValueError(f"table values outside [0, 2^{beta})")
    grouped = t.astype(np.uint32).reshape(o, n // p, p)
    words = np.zeros((o, n // p), np.uint32)
    for j in range(p):
        words |= grouped[:, :, j] << np.uint32(beta * j)
    return words.view(np.int32)


def pack_tables_torch(table: torch.Tensor, beta: int) -> torch.Tensor:
    """Device-side twin of :func:`pack_tables` (used inside the
    conversion sweep): (O, T) codes -> (O, T // P) int32 words,
    bit-identical to the numpy packer.  The words are assembled in int64
    and wrapped to int32 explicitly, so no shift overflows."""
    p = packed_slots(beta)
    o, n = table.shape
    if n % p:
        raise ValueError(f"table size {n} not a multiple of P={p} "
                         f"(beta={beta})")
    grouped = table.to(torch.int64).reshape(o, n // p, p)
    shifts = torch.arange(p, device=table.device, dtype=torch.int64) * beta
    words = (grouped << shifts).sum(-1)
    words = torch.where(words >= 2 ** 31, words - 2 ** 32, words)
    return words.to(torch.int32)


def unpack_tables(packed: np.ndarray, beta: int, *,
                  table_size: Optional[int] = None) -> np.ndarray:
    """Inverse of ``pack_tables``: (O, Tw) int32 -> (O, Tw * P) uint16."""
    p = packed_slots(beta)
    w = np.asarray(packed).view(np.uint32)
    o, nw = w.shape
    mask = np.uint32((1 << beta) - 1)
    cols = [(w >> np.uint32(beta * j)) & mask for j in range(p)]
    out = np.stack(cols, axis=-1).reshape(o, nw * p).astype(np.uint16)
    if table_size is not None:
        out = out[:, :table_size]
    return out


def input_codes(cfg: NeuraLUTConfig, params: Params,
                x: torch.Tensor) -> torch.Tensor:
    beta_in = cfg.beta_in or cfg.beta
    return quant.quant_codes(params["in_quant"], x, beta_in)


def lut_forward(cfg: NeuraLUTConfig, tables: Sequence,
                statics: List[Dict], codes: torch.Tensor) -> torch.Tensor:
    """codes: (B, in_features) int -> (B, classes) int32 output codes,
    by per-layer gather over the unpacked (O, T) tables: the chain's
    one-branch graph through :func:`graph_lut_forward`."""
    return graph_lut_forward(cfg.graph(), tables, statics, codes)


def graph_lut_forward(cfg: LUTGraphConfig, tables: Sequence,
                      statics: List[Dict], codes: torch.Tensor
                      ) -> torch.Tensor:
    """Per-node LUT-DAG oracle: codes (B, in_features) int -> (B,
    classes) int32 output codes.

    ``tables[i]`` is node i's per-branch table list (a bare array is
    taken for an arity-1 node); ``statics[i]`` holds ``"conns"`` (or
    ``"conn"``).  Each branch looks its code up in its own table over
    the node's concatenated source pool; an adder-tree node sums the
    branch codes, which by the shared-quantizer contract is the node's
    (beta + log2 A)-bit output code."""
    dev = codes.device
    bufs = [codes.to(torch.int32)]
    for i, nd in enumerate(cfg.nodes):
        srcs = cfg.node_sources(i)
        pool = (bufs[srcs[0]] if len(srcs) == 1
                else torch.cat([bufs[s] for s in srcs], dim=1))
        conns = (statics[i]["conns"] if "conns" in statics[i]
                 else [statics[i]["conn"]])
        tbls = (tables[i] if isinstance(tables[i], (list, tuple))
                else [tables[i]])
        out = None
        for a in range(nd.arity):
            conn = torch.as_tensor(np.asarray(conns[a]), device=dev).long()
            addr = pack_index(pool[:, conn], cfg.node_in_bits(i))  # (B, O)
            tbl = torch.as_tensor(np.asarray(tbls[a]).astype(np.int32),
                                  device=dev)                      # (O, T)
            rows = torch.arange(tbl.shape[0], device=dev)[None, :]
            c = tbl[rows, addr.long()]
            out = c if out is None else out + c
        bufs.append(out)
    return bufs[-1]


def class_values(cfg: NeuraLUTConfig, params: Params,
                 out_codes: torch.Tensor) -> torch.Tensor:
    """Dequantize final-layer codes -> comparable class scores."""
    s = torch.exp(params["layers"][-1]["quant"]["log_s"])
    return (out_codes.to(torch.float32) - 2 ** (cfg.beta - 1)) * s


def predict(cfg, params: Params, tables, statics,
            x: torch.Tensor) -> torch.Tensor:
    """(B, in_features) features -> (B,) int64 class predictions through
    the oracle cascade, chain or graph (ties go to the first class, as
    ``jnp.argmax``)."""
    codes = input_codes(cfg, params, x)
    fwd = graph_lut_forward if is_graph_config(cfg) else lut_forward
    out = fwd(cfg, tables, statics, codes)
    return torch.argmax(class_values(cfg, params, out), dim=-1)
