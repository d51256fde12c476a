"""Fused LUT cascade: the wrapper of the CUDA kernel
``csrc/lut_cascade.cu`` (port of ``repro.kernels.lut_cascade``, chain
schedules, gather form).

The kernel runs the whole converted network for a tile of batch rows in
one launch: per layer it gathers the connected codes, packs the address,
loads one bit-packed word and shifts out the code, with the tile's
inter-layer codes kept in shared memory.  It is bit-identical to
``core.lut_infer.lut_forward`` and to the plain gather cascade
``kernels.ref.lut_cascade_ref``, which the wrapper runs for tensors on
the CPU.
"""
from __future__ import annotations

import ctypes
from typing import List, Sequence, Tuple

import numpy as np
import torch

from repro_torch.core.lut_infer import pack_tables, packed_slots
from repro_torch.kernels import build
from repro_torch.kernels.ref import LayerMeta, lut_cascade_ref

MAX_LAYERS = 16  # REPRO_MAX_LAYERS in csrc/lut_cascade.cu
MAX_SHARED_BYTES = 227 * 1024  # dynamic shared memory of one H100 block

# Batch rows per block.  A thread walks its (row, neuron) items of a
# layer one after another, each a chain of dependent loads, so a block's
# time grows with its rows, and the engine's batches (at most 256 rows)
# do not fill the card even at one row per block.  Chosen from
# chip_smoke.py's tile sweep at the engine's bucket sizes (PERF.md).
DEFAULT_BLOCK_B = 1


def cascade_meta(cfg) -> Tuple[LayerMeta, ...]:
    """Static kernel geometry per layer: (in_bits, word_bits, slot_bits,
    beta).  Unlike the JAX package's (word_bits, slot_bits, beta) it
    carries the input code width, which the gather form shifts by where
    the TPU kernel baked it into f32 shift matrices."""
    meta = []
    p = packed_slots(cfg.beta)
    for i in range(cfg.num_layers):
        t = cfg.table_size(i)
        if t % p:
            raise ValueError(f"layer {i}: table size {t} not a multiple "
                             f"of packed word capacity {p}")
        meta.append((cfg.layer_in_bits(i), (t // p).bit_length() - 1,
                     p.bit_length() - 1, cfg.beta))
    return tuple(meta)


def cascade_tables(cfg, tables: Sequence[np.ndarray]) -> List[np.ndarray]:
    """Bit-pack every layer's table with its output code width."""
    return [pack_tables(np.asarray(t), cfg.beta) for t in tables]


class CascadeOperands:
    """The per-layer operands of one converted chain, checked once and
    laid out for the launch: ``conns[i]`` (O_i, F_i) int32 and
    ``packed[i]`` (O_i, T_i / P) int32 on one device, ``meta`` =
    :func:`cascade_meta`.  Holding the tensors keeps the pointers the
    kernel reads alive; the serving forward builds this once and passes
    it with every batch."""

    def __init__(self, conns: Sequence[torch.Tensor],
                 packed_tables: Sequence[torch.Tensor],
                 meta: Sequence[LayerMeta], in_width: int):
        self.conns = tuple(conns)
        self.packed = tuple(packed_tables)
        self.meta = tuple(tuple(int(v) for v in m) for m in meta)
        self.in_width = int(in_width)
        n = len(self.meta)
        if not len(self.conns) == len(self.packed) == n >= 1:
            raise ValueError(f"{len(self.conns)} conns, {len(self.packed)} "
                             f"tables and {n} layers of geometry disagree")
        if n > MAX_LAYERS:
            raise ValueError(f"{n} layers > kernel maximum {MAX_LAYERS}")
        self.device = self.conns[0].device
        w_prev = self.in_width
        for i, (conn, pt, m) in enumerate(zip(self.conns, self.packed,
                                              self.meta)):
            _check_layer(i, conn, pt, m, self.device, w_prev,
                         self.meta[i - 1][3] if i else None)
            w_prev = conn.shape[0]
        self.out_width = self.conns[-1].shape[0]
        # Shared-memory row pitch: the widest layer whose codes stay in
        # the block (every layer but the last).
        self.stride = max([c.shape[0] for c in self.conns[:-1]], default=1)
        geom = []
        for conn, (in_bits, wb, sb, beta) in zip(self.conns, self.meta):
            geom += [conn.shape[0], conn.shape[1], in_bits, 1 << wb, sb,
                     beta]
        self._geom = (ctypes.c_int * len(geom))(*geom)
        self._conn_ptrs = (ctypes.c_void_p * n)(
            *[c.data_ptr() for c in self.conns])
        self._packed_ptrs = (ctypes.c_void_p * n)(
            *[p.data_ptr() for p in self.packed])


def _check_layer(i: int, conn: torch.Tensor, pt: torch.Tensor,
                 m: LayerMeta, device: torch.device, w_prev: int,
                 prev_bits) -> None:
    in_bits, wb, sb, beta = m
    for name, t in (("conn", conn), ("packed table", pt)):
        if t.device != device or t.dtype != torch.int32 \
                or not t.is_contiguous() or t.dim() != 2:
            raise ValueError(
                f"layer {i}: {name} must be a contiguous 2-D int32 tensor "
                f"on {device}, got {tuple(t.shape)} {t.dtype} on {t.device}")
    o, f = conn.shape
    if tuple(pt.shape) != (o, 1 << wb):
        raise ValueError(f"layer {i}: packed table {tuple(pt.shape)} != "
                         f"({o}, {1 << wb})")
    if (1 << sb) * beta > 32 or not 1 <= beta <= 16:
        raise ValueError(f"layer {i}: {1 << sb} slots of {beta} bits do "
                         "not fit an int32 word")
    if in_bits * f != wb + sb:
        raise ValueError(f"layer {i}: {f} slots of {in_bits} bits address "
                         f"{in_bits * f} bits, the table {wb + sb}")
    if prev_bits is not None and in_bits != prev_bits:
        raise ValueError(f"layer {i} reads {in_bits}-bit codes, layer "
                         f"{i - 1} writes {prev_bits}-bit codes")
    if conn.numel():
        lo, hi = (int(v) for v in torch.aminmax(conn))
        if lo < 0 or hi >= w_prev:
            raise ValueError(f"layer {i}: conn indexes [{lo}, {hi}] "
                             f"outside the {w_prev} source codes")


def lut_cascade(codes: torch.Tensor, ops: CascadeOperands, *,
                block_b: int = DEFAULT_BLOCK_B) -> torch.Tensor:
    """(B, W_0) int32 input codes -> (B, O_last) int32 output codes of
    the whole chain, in one launch on a CUDA tensor.

    Codes must lie in [0, 2^in_bits).  On a CPU tensor this runs the
    plain version; on a CUDA tensor it launches the kernel or raises.
    """
    if codes.device.type == "cpu":
        return lut_cascade_ref(codes, list(ops.conns), list(ops.packed),
                               ops.meta)
    if codes.device != ops.device:
        raise ValueError(f"codes lie on {codes.device}, the operands on "
                         f"{ops.device}")
    if codes.dim() != 2 or codes.dtype != torch.int32 \
            or codes.shape[1] != ops.in_width:
        raise ValueError(f"codes must be (B, {ops.in_width}) int32, got "
                         f"{tuple(codes.shape)} {codes.dtype}")
    codes = codes.contiguous()
    b = codes.shape[0]
    out = torch.empty((b, ops.out_width), dtype=torch.int32,
                      device=codes.device)
    if b == 0:
        return out
    rows = max(1, min(int(block_b), b))
    if 2 * rows * ops.stride * 2 > MAX_SHARED_BYTES:
        raise ValueError(f"block_b={rows} rows of {ops.stride} codes "
                         "exceed the block's shared memory")
    rc = build.load_library().repro_lut_cascade(
        codes.device.index, codes.data_ptr(), b, ops.in_width,
        len(ops.meta), ops._conn_ptrs, ops._packed_ptrs, ops._geom, rows,
        ops.stride, out.data_ptr(),
        torch.cuda.current_stream(codes.device).cuda_stream)
    build.check(rc, "lut_cascade launch")
    lut_cascade.launches += 1
    return out


lut_cascade.launches = 0
