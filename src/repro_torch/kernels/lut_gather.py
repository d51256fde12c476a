"""Per-layer truth-table lookup: the wrapper of the CUDA kernel
``csrc/lut_gather.cu`` (port of ``repro.kernels.lut_gather.lut_lookup``).

``out[b, o] = tables[o, addr[b, o]]`` for (O, T) int32 tables and
(B, O) int32 addresses, one thread per lookup.  The per-layer serving
route (``core.exec_plan.CascadeExec`` with ``route="layer"``) runs it
once per layer.  On a CPU tensor the wrapper runs the plain version
``kernels.ref.lut_gather_ref``; on a CUDA tensor it launches the kernel
or raises.  The two are bit-identical.
"""
from __future__ import annotations

import torch

from repro_torch.kernels import build
from repro_torch.kernels.ref import lut_gather_ref


def lut_lookup(tables: torch.Tensor, addr: torch.Tensor) -> torch.Tensor:
    """(O, T) int32 tables, (B, O) int32 addresses in [0, T) -> (B, O)
    int32 codes.  T must be a power of two (as the reference's kernel
    requires); B and O are arbitrary, B = 0 gives an empty (0, O)."""
    if tables.dim() != 2 or addr.dim() != 2 \
            or addr.shape[1] != tables.shape[0]:
        raise ValueError(f"tables (O, T) and addr (B, O) disagree: "
                         f"{tuple(tables.shape)}, {tuple(addr.shape)}")
    o, t = tables.shape
    if t < 1 or t & (t - 1):
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
