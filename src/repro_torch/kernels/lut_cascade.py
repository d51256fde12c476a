"""Fused LUT cascade: the wrapper of the CUDA kernel
``csrc/lut_cascade.cu`` (port of ``repro.kernels.lut_cascade``, gather
form, chain and DAG schedules).

The kernel runs the whole converted network for a tile of batch rows in
one launch: per node and branch it gathers the connected codes, packs
the address, loads one bit-packed word and shifts out the code, sums the
branch codes of an adder-tree node, and keeps the tile's inter-node
codes in shared memory.  It is bit-identical to
``core.lut_infer.lut_forward`` / ``graph_lut_forward`` and to the plain
gather cascade ``kernels.ref.lut_cascade_ref``, which the wrapper runs
for tensors on the CPU.

The schedule is the node schedule of ``kernels.ref`` (``NodeSched``:
srcs, arity, in_bits, word_bits, slot_bits, beta per node); a chain's
per-layer ``cascade_meta`` is the degenerate case and ``as_schedule``
turns it into nodes.  Per-branch operands are flat, in (node, branch)
order.
"""
from __future__ import annotations

from typing import Dict, List, Sequence, Tuple

import numpy as np
import torch

from repro_torch.core.lut_infer import pack_tables, packed_slots
from repro_torch.kernels import build
from repro_torch.kernels.ref import (LayerMeta, NodeSched, as_schedule,
                                     lut_cascade_ref)

# As csrc/lut_cascade.cu: REPRO_MAX_NODES, REPRO_MAX_ARITY and the node
# descriptor of REPRO_DESC_WORDS int64 words (9 geometry fields, then
# MAX_ARITY column offsets and MAX_ARITY table pointers, then a pad word).
MAX_NODES = 16
MAX_ARITY = 4
DESC_WORDS = 9 + 2 * MAX_ARITY + 1
# Shared memory of one H100 block.
MAX_SHARED_BYTES = 227 * 1024
CODE_BITS = 16  # the kernel keeps codes, and column positions, as uint16

# Batch rows per block.  A thread walks its (row, neuron) items of a
# node one after another, each a chain of dependent loads, so a block's
# time grows with its rows, and the engine's batches (at most 256 rows)
# do not fill the card even at one row per block; a block's prologue
# (the program into shared memory) is the same for any rows.  Chosen
# from chip_smoke.py's tile sweeps at the engine's bucket sizes, on the
# chain and on the DAG (PERF.md); 2-8 rows win only at thousands of rows,
# which no serving batch reaches.
DEFAULT_BLOCK_B = 1


def _table_geom(cfg, i: int) -> Tuple[int, int]:
    """(word_bits, slot_bits) of layer or node ``i``'s packed tables."""
    t = cfg.table_size(i)
    p = packed_slots(cfg.beta)
    if t % p:
        raise ValueError(f"layer {i}: table size {t} not a multiple "
                         f"of packed word capacity {p}")
    return (t // p).bit_length() - 1, p.bit_length() - 1


def cascade_meta(cfg) -> Tuple[LayerMeta, ...]:
    """Static kernel geometry per chain layer: (in_bits, word_bits,
    slot_bits, beta).  Unlike the JAX package's (word_bits, slot_bits,
    beta) it carries the input code width, which the gather form shifts
    by where the TPU kernel baked it into f32 shift matrices."""
    return tuple((cfg.layer_in_bits(i),) + _table_geom(cfg, i) + (cfg.beta,)
                 for i in range(cfg.num_layers))


def graph_cascade_meta(cfg) -> Tuple[NodeSched, ...]:
    """The node schedule of a ``LUTGraphConfig``, from the config alone:
    (srcs, arity, in_bits, word_bits, slot_bits, beta) per node.  For a
    chain graph it equals ``as_schedule(cascade_meta(chain))``."""
    return tuple((cfg.node_sources(i), nd.arity, cfg.node_in_bits(i))
                 + _table_geom(cfg, i) + (cfg.beta,)
                 for i, nd in enumerate(cfg.nodes))


def cascade_tables(cfg, tables: Sequence[np.ndarray]) -> List[np.ndarray]:
    """Bit-pack every layer's table with its output code width."""
    return [pack_tables(np.asarray(t), cfg.beta) for t in tables]


def graph_cascade_tables(cfg, tables: Sequence) -> List[np.ndarray]:
    """Bit-pack a graph's per-node branch tables into the flat (node,
    branch) operand order.  ``tables[i]`` is the branch list (a bare
    array for an arity-1 node)."""
    return [pack_tables(np.asarray(t), cfg.beta)
            for node in tables
            for t in (node if isinstance(node, (list, tuple)) else [node])]


def _plan_code_columns(schedule: Sequence[NodeSched], widths: Sequence[int]
                      ) -> Tuple[List[int], int]:
    """Shared-memory columns of every buffer a later node reads.

    ``widths[b]`` is buffer b's channel count (b = 0 the input).
    Returns (first column of each node's output, -1 for the last node,
    which writes to global memory; the row pitch in codes).  Nodes run
    in order; before node n allocates its output, every buffer whose
    last reader ran before n is freed, and the output takes the lowest
    free run of columns that fits (first fit).  A node's sources stay
    allocated while it writes, so no code is overwritten before its last
    reader.  A chain alternates between two slices."""
    n = len(schedule)
    last_use = {}
    for i, (srcs, *_r) in enumerate(schedule):
        for s in srcs:
            last_use[s] = i
    live: Dict[int, Tuple[int, int]] = {}  # buffer -> (first col, width)
    cols, stride = [], 0
    for i in range(n):
        for b in [b for b in live if last_use.get(b, b - 1) < i]:
            del live[b]
        if i == n - 1:
            cols.append(-1)
            break
        w, start = widths[i + 1], 0
        for lo, bw in sorted(live.values()):
            if start + w <= lo:
                break
            start = max(start, lo + bw)
        live[i + 1] = (start, w)
        cols.append(start)
        stride = max(stride, start + w)
    return cols, stride


class CascadeOperands:
    """The operands of one converted network, checked once and laid out
    for the launch.

    ``conns`` and ``packed_tables`` are flat in (node, branch) order:
    ``conns[k]`` (O, F) int32 indexes the node's pool (its source
    buffers concatenated in ``srcs`` order), ``packed[k]`` (O, T / P)
    int32, all on one device; ``schedule`` is a node schedule or a
    chain's ``cascade_meta``; ``in_width`` is the input code count.
    Every shape, source index, bit width and the block's shared memory
    are checked here, and the kernel's program is built here, once: a
    row's code array holds the W_0 input codes, then each buffer that a
    later node reads in its own columns (``out_cols``, ``stride``
    columns in all), so ``cols[k]`` (O, F) int32 is branch k's
    connectivity rewritten into positions in that array (input column j
    at j, buffer column c at W_0 + c), and ``prog`` holds the node
    descriptors (``desc``) and every branch's positions, 16-bit, each
    neuron's padded to a multiple of 4.  Holding the tensors keeps the
    pointers the kernel reads alive; the serving forward builds this
    once and passes it with every batch."""

    def __init__(self, conns: Sequence[torch.Tensor],
                 packed_tables: Sequence[torch.Tensor], schedule,
                 in_width: int):
        self.conns = tuple(conns)
        self.packed = tuple(packed_tables)
        self.schedule = as_schedule(schedule)
        self.in_width = int(in_width)
        n = len(self.schedule)
        nb = sum(arity for _s, arity, *_r in self.schedule)
        if not len(self.conns) == len(self.packed) == nb or n < 1:
            raise ValueError(f"{len(self.conns)} conns, {len(self.packed)} "
                             f"tables and {n} nodes of {nb} branches of "
                             "geometry disagree")
        if n > MAX_NODES:
            raise ValueError(f"{n} nodes > kernel maximum {MAX_NODES}")
        self.device = self.conns[0].device
        widths, bits = [self.in_width], {}
        k = 0
        for i, node in enumerate(self.schedule):
            srcs, arity, in_bits, _wb, _sb, beta = node
            _check_sources(i, srcs, in_bits, bits)
            pool_w = sum(widths[s] for s in srcs)
            shape = None
            for a in range(arity):
                shape = _check_branch(f"node {i} branch {a}", self.conns[k],
                                      self.packed[k], node, self.device,
                                      pool_w, shape)
                k += 1
            if arity & (arity - 1) or arity > MAX_ARITY:
                raise ValueError(f"node {i}: arity {arity} is not a power "
                                 f"of two up to {MAX_ARITY}")
            bits[i + 1] = beta + arity.bit_length() - 1
            if bits[i + 1] > CODE_BITS:
                raise ValueError(f"node {i}: {arity} branches of {beta}-bit "
                                 f"codes sum to {bits[i + 1]} bits > "
                                 f"{CODE_BITS}")
            widths.append(shape[0])
        if bits.get(0, 0) > CODE_BITS:
            raise ValueError(f"{bits[0]}-bit input codes > {CODE_BITS}")
        self.out_width = widths[-1]
        self.max_width = max(widths[1:])
        self.max_arity = max(arity for _s, arity, *_r in self.schedule)
        self.out_cols, self.stride = _plan_code_columns(self.schedule,
                                                       widths)
        self.pitch = self.in_width + self.stride
        if 2 * self.pitch > MAX_SHARED_BYTES or self.pitch >= 1 << CODE_BITS:
            raise ValueError(f"a row of {self.pitch} codes exceeds the "
                             "block's shared memory or 16-bit positions")
        self.cols = self._code_columns(widths)
        self.desc, self.prog = self._program()
        if self.prog.numel() * 8 + 2 * self.pitch > MAX_SHARED_BYTES:
            raise ValueError(f"the program's {self.prog.numel() * 8} bytes "
                             "(node descriptors and code columns) and a row "
                             "exceed the block's shared memory")

    def _code_columns(self, widths) -> Tuple[torch.Tensor, ...]:
        """Each branch's conn rewritten into positions in a row's code
        array: input column j at j, buffer column c at W_0 + c."""
        cols, k = [], 0
        for srcs, arity, *_r in self.schedule:
            parts = []
            for s in srcs:
                j = torch.arange(widths[s], dtype=torch.int32,
                                 device=self.device)
                parts.append(j if s == 0
                             else self.in_width + self.out_cols[s - 1] + j)
            colmap = torch.cat(parts)
            for _a in range(arity):
                cols.append(colmap[self.conns[k].long()].contiguous())
                k += 1
        return tuple(cols)

    def _program(self) -> Tuple[torch.Tensor, torch.Tensor]:
        """(desc, prog): the (nodes, DESC_WORDS) int64 node descriptors,
        and the kernel's program, int64 words on the operands' device:
        the descriptors, then the column area (every branch's positions
        as uint16, (O, round4(F)) each, pad entries 0), 16-byte padded."""
        areas, off, desc, k = [], 0, [], 0
        for node, col in zip(self.schedule, self.out_cols):
            srcs, arity, in_bits, wb, sb, beta = node
            o, f = self.conns[k].shape
            offs = []
            for _a in range(arity):
                c = torch.zeros((o, -(-f // 4) * 4), dtype=torch.int32,
                                device=self.device)
                c[:, :f] = self.cols[k]
                areas.append(c.flatten())
                offs.append(off)
                off += c.numel()
                k += 1
            pad = [0] * (MAX_ARITY - arity)   # unused branches
            ptrs = [self.packed[b].data_ptr() for b in range(k - arity, k)]
            desc.append([o, f, in_bits, 1 << wb, sb, beta, arity,
                         col if col < 0 else self.in_width + col,
                         _udiv_magic(o)] + offs + pad + ptrs + pad + [0])
        desc = torch.tensor(desc, dtype=torch.int64, device=self.device)
        area = torch.cat(areas)
        area = torch.cat([area, area.new_zeros(-area.numel() % 8)])
        return desc, torch.cat([desc.flatten(), _pack_u16(area)])


def _udiv_magic(d: int) -> int:
    """The kernel's divisor for d (csrc/subnet_geom.h udiv_magic):
    ceil(2^32 / d), or 0 for d = 1."""
    return 0 if d == 1 else -(-(1 << 32) // d)


def _pack_u16(area: torch.Tensor) -> torch.Tensor:
    """int32 values < 2^16, a multiple of 4 of them -> int64 words of 4
    little-endian uint16 each."""
    v = area.to(torch.int64).reshape(-1, 4)
    return v[:, 0] | (v[:, 1] << 16) | (v[:, 2] << 32) | (v[:, 3] << 48)


def _check_sources(i: int, srcs, in_bits: int, bits: Dict[int, int]) -> None:
    if not srcs:
        raise ValueError(f"node {i} reads no buffer")
    for s in srcs:
        if not 0 <= s <= i:
            raise ValueError(f"node {i} reads buffer {s}: not the input or "
                             "an earlier node's output")
        have = bits.setdefault(s, in_bits)  # buffer 0: its first reader's
        if have != in_bits:
            raise ValueError(f"node {i} reads {in_bits}-bit codes, buffer "
                             f"{s} holds {have}-bit codes")


def _check_branch(where: str, conn: torch.Tensor, pt: torch.Tensor,
                  node: NodeSched, device: torch.device, pool_w: int,
                  shape) -> Tuple[int, int]:
    _srcs, _arity, in_bits, wb, sb, beta = node
    for name, t in (("conn", conn), ("packed table", pt)):
        if t.device != device or t.dtype != torch.int32 \
                or not t.is_contiguous() or t.dim() != 2:
            raise ValueError(
                f"{where}: {name} must be a contiguous 2-D int32 tensor "
                f"on {device}, got {tuple(t.shape)} {t.dtype} on {t.device}")
    o, f = conn.shape
    if shape is not None and (o, f) != shape:
        raise ValueError(f"{where}: conn {(o, f)} != branch 0's {shape}")
    if tuple(pt.shape) != (o, 1 << wb):
        raise ValueError(f"{where}: packed table {tuple(pt.shape)} != "
                         f"({o}, {1 << wb})")
    if (1 << sb) * beta > 32 or not 1 <= beta <= 16:
        raise ValueError(f"{where}: {1 << sb} slots of {beta} bits do "
                         "not fit an int32 word")
    if in_bits * f != wb + sb:
        raise ValueError(f"{where}: {f} slots of {in_bits} bits address "
                         f"{in_bits * f} bits, the table {wb + sb}")
    if conn.numel():
        lo, hi = (int(v) for v in torch.aminmax(conn))
        if lo < 0 or hi >= pool_w:
            raise ValueError(f"{where}: conn indexes [{lo}, {hi}] "
                             f"outside the {pool_w} source codes")
    return o, f


def lut_cascade(codes: torch.Tensor, ops: CascadeOperands, *,
                block_b: int = DEFAULT_BLOCK_B) -> torch.Tensor:
    """(B, W_0) int32 input codes -> (B, O_last) int32 output codes of
    the whole network, chain or DAG, in one launch on a CUDA tensor.

    Codes must lie in [0, 2^in_bits).  On a CPU tensor this runs the
    plain version; on a CUDA tensor it launches the kernel or raises.
    """
    if codes.device.type == "cpu":
        return lut_cascade_ref(codes, ops.conns, ops.packed, ops.schedule)
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
    if ops.prog.numel() * 8 + rows * ops.pitch * 2 > MAX_SHARED_BYTES:
        raise ValueError(f"block_b={rows} rows of {ops.pitch} codes and the "
                         f"{ops.prog.numel() * 8}-byte program exceed the "
                         "block's shared memory")
    if rows * ops.max_width ** 2 > 1 << 32:
        raise ValueError(f"block_b={rows} rows of {ops.max_width} codes: "
                         "more items than the kernel's divisor is exact for")
    rc = build.load_library().repro_lut_cascade(
        codes.device.index, codes.data_ptr(), b, ops.in_width,
        len(ops.schedule), ops.prog.data_ptr(), ops.prog.numel() // 2,
        ops.max_arity, ops.max_width, rows, ops.pitch, out.data_ptr(),
        torch.cuda.current_stream(codes.device).cuda_stream)
    build.check(rc, "lut_cascade launch")
    build.count_launch(lut_cascade)
    return out


lut_cascade.launches = 0
