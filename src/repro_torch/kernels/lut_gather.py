"""Per-layer truth-table lookup: the wrappers of the CUDA kernel
``csrc/lut_gather.cu`` (port of ``repro.kernels.lut_gather.lut_lookup``).

Two entries share the kernel's body:

* :func:`lut_layer` — one chain layer's whole step in one launch: gather
  each neuron's input codes, pack them into an address and look the
  address up, ``out[b, o] = tables[o, clamp(sum_j codes[b, conn[o, j]]
  << (in_bits (F-1-j)), 0, T-1)]``.  The per-layer serving route
  (``core.exec_plan.CascadeExec`` with ``route="layer"``) runs it once
  per layer.
* :func:`lut_lookup` — the lookup alone, addresses given, ``out[b, o] =
  tables[o, addr[b, o]]``: the reference's ``lut_lookup``.

On CPU tensors each wrapper runs its plain version
(``kernels.ref.lut_layer_ref`` / ``lut_gather_ref``); on CUDA tensors it
launches the kernel or raises.  Kernel and plain version are
bit-identical.
"""
from __future__ import annotations

import torch

from repro_torch.kernels import build
from repro_torch.kernels.ref import lut_gather_ref, lut_layer_ref

MAX_ADDRESS_BITS = 30
_INT32_ELEMS = 1 << 31


def _pow2(t: int) -> bool:
    return t >= 1 and not t & (t - 1)


def lut_lookup(tables: torch.Tensor, addr: torch.Tensor) -> torch.Tensor:
    """(O, T) int32 tables, (B, O) int32 addresses in [0, T) -> (B, O)
    int32 codes.  T must be a power of two (as the reference's kernel
    requires); B and O are arbitrary, B = 0 gives an empty (0, O)."""
    if tables.dim() != 2 or addr.dim() != 2 \
            or addr.shape[1] != tables.shape[0]:
        raise ValueError(f"tables (O, T) and addr (B, O) disagree: "
                         f"{tuple(tables.shape)}, {tuple(addr.shape)}")
    o, t = tables.shape
    if not _pow2(t):
        raise ValueError(f"table size {t} not a power of two")
    b = addr.shape[0]
    if tables.device.type == "cpu" and addr.device.type == "cpu":
        return lut_gather_ref(tables, addr)
    if tables.device != addr.device or tables.device.type != "cuda":
        raise ValueError(f"tables on {tables.device}, addr on "
                         f"{addr.device}: both on one CUDA device or both "
                         "on the CPU")
    if tables.dtype != torch.int32 or addr.dtype != torch.int32:
        raise ValueError(f"tables and addr must be int32, got "
                         f"{tables.dtype} and {addr.dtype}")
    if b * o >= _INT32_ELEMS:
        raise ValueError(f"B x O = {b} x {o} exceeds 32-bit indexing")
    tables, addr = tables.contiguous(), addr.contiguous()
    out = torch.empty((b, o), dtype=torch.int32, device=addr.device)
    if b == 0 or o == 0:
        return out
    rc = build.load_library().repro_lut_gather(
        addr.device.index, tables.data_ptr(), addr.data_ptr(),
        out.data_ptr(), b, o, t,
        torch.cuda.current_stream(addr.device).cuda_stream)
    build.check(rc, "lut_lookup launch")
    build.count_launch(lut_lookup)
    return out


lut_lookup.launches = 0


def lut_layer(tables: torch.Tensor, codes: torch.Tensor,
              conn: torch.Tensor, in_bits: int) -> torch.Tensor:
    """One chain layer: (O, T) int32 tables, (B, I) int32 input codes,
    (O, F) int32 connections into [0, I) and the input code width
    ``in_bits`` -> (B, O) int32 output codes.  T must be 2^(in_bits F)
    with in_bits F <= 30.  Addresses are the int32 sum of
    ``lut_infer.pack_index`` (wrapping as it wraps) and are clamped into
    [0, T) as ``lut_gather_ref`` clamps them, so codes outside
    [0, 2^in_bits) give the plain route's answer.  B = 0 gives an empty
    (0, O)."""
    if tables.dim() != 2 or codes.dim() != 2 or conn.dim() != 2 \
            or conn.shape[0] != tables.shape[0]:
        raise ValueError(f"tables (O, T), codes (B, I) and conn (O, F) "
                         f"disagree: {tuple(tables.shape)}, "
                         f"{tuple(codes.shape)}, {tuple(conn.shape)}")
    (o, t), (b, i), f = tables.shape, codes.shape, conn.shape[1]
    in_bits = int(in_bits)
    if in_bits < 1 or f < 1 or in_bits * f > MAX_ADDRESS_BITS:
        raise ValueError(f"in_bits x F = {in_bits} x {f}: want both >= 1 "
                         f"and at most {MAX_ADDRESS_BITS} address bits")
    if not _pow2(t):
        raise ValueError(f"table size {t} not a power of two")
    if t != 1 << (in_bits * f):
        raise ValueError(f"table size {t} != 2^(in_bits x F) = "
                         f"2^{in_bits * f}")
    if i < 1:
        raise ValueError("codes (B, I) with I = 0: nothing to connect")
    if any(x.dtype != torch.int32 for x in (tables, codes, conn)):
        raise ValueError(f"tables, codes and conn must be int32, got "
                         f"{tables.dtype}, {codes.dtype} and {conn.dtype}")
    devices = {tables.device, codes.device, conn.device}
    if all(d.type == "cpu" for d in devices):
        return lut_layer_ref(tables, codes, conn, in_bits)
    if len(devices) != 1 or tables.device.type != "cuda":
        raise ValueError(f"tables on {tables.device}, codes on "
                         f"{codes.device}, conn on {conn.device}: all on one "
                         "CUDA device or all on the CPU")
    if b * i >= _INT32_ELEMS or b * o >= _INT32_ELEMS:
        raise ValueError(f"B x I = {b} x {i} or B x O = {b} x {o} exceeds "
                         "32-bit indexing")
    tables, codes, conn = (x.contiguous() for x in (tables, codes, conn))
    out = torch.empty((b, o), dtype=torch.int32, device=codes.device)
    if b == 0 or o == 0:
        return out
    rc = build.load_library().repro_lut_layer(
        codes.device.index, tables.data_ptr(), codes.data_ptr(),
        conn.data_ptr(), out.data_ptr(), b, i, o, f, in_bits,
        torch.cuda.current_stream(codes.device).cuda_stream)
    build.check(rc, "lut_layer launch")
    build.count_launch(lut_layer)
    return out


lut_layer.launches = 0
