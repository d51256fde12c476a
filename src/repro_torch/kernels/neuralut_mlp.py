"""Grouped sub-network evaluation: the wrapper of the CUDA kernel
``csrc/neuralut_mlp.cu`` (port of ``repro.kernels.neuralut_mlp`` and of
``repro.kernels.ops.subnet_kernel_apply``).

Every (row, neuron) pair of a (T, O, F) input runs through its neuron's
L-layer ReLU MLP with skip chunks in one launch: a block holds up to 8
neurons (a warp each, its weights spread in shared memory) x a tile of
rows, each thread carries R rows through the walk at a time, and the
block's inputs and outputs pass through shared memory in whole rows.
The launch plan (R, the block's neurons and rows) is made by the C
entry from the card's SM count and the kernels' register counts
(``csrc/mlp_plan.h``; :func:`plan_subnet_launch` reads it).  Widths,
depth and skip period are runtime arguments; rows and neurons need not
divide any tile (the JAX kernel raises on shapes that do not divide,
this one masks the ragged edge).  The plain version is
``kernels.ref.grouped_subnet_ref``, which the wrapper runs for tensors
on the CPU; on the card the two agree to atol/rtol 1e-5 (fp32 summation
order and FMA contraction).
"""
from __future__ import annotations

import ctypes
from collections import namedtuple
from typing import Dict, Optional, Sequence

import torch

from repro_torch.device import check_exact_fp32
from repro_torch.kernels import build
from repro_torch.kernels.ref import grouped_subnet_ref

MAX_WIDTH = 32        # largest NMAX instantiation in csrc/neuralut_mlp.cu
MAX_DEPTH = 16        # REPRO_MAX_DEPTH
MAX_ROWS = 65535 * 256  # grid.y limit x 256 rows per block
MAX_SHARED_BYTES = 227 * 1024

# The numbers of ``repro_grouped_subnet_launch_plan``, in the order of
# its MP_* words (csrc/mlp_plan.h), then the chosen kernel's registers.
SubnetPlan = namedtuple("SubnetPlan", (
    "rows_per_thread", "neurons", "rows", "flags", "smem", "grid_x",
    "grid_y", "pstride", "ppad", "regs"))


def pack_subnet_weights(layer_ws: Sequence[torch.Tensor],
                        layer_bs: Sequence[torch.Tensor],
                        skip_ws: Sequence[torch.Tensor] = (),
                        skip_bs: Sequence[torch.Tensor] = ()
                        ) -> torch.Tensor:
    """(O, P) float32: per neuron every layer's w (row-major) then b,
    then every skip chunk's w then b — the offsets the kernel walks.
    Stacked weights (a leading seed axis S) give (S, O, P)."""
    parts = []
    for w, b in list(zip(layer_ws, layer_bs)) + list(zip(skip_ws, skip_bs)):
        parts += [w.flatten(-2), b]
    return torch.cat(parts, dim=-1).to(torch.float32).contiguous()


def check_operands(xg: torch.Tensor,
                   layer_ws: Sequence[torch.Tensor],
                   layer_bs: Sequence[torch.Tensor],
                   skip_ws: Optional[Sequence[torch.Tensor]],
                   skip_bs: Optional[Sequence[torch.Tensor]],
                   skip: int, *, seeds: Optional[int] = None):
    """Check a CUDA launch's operands: float32 (T, O, F) input, weights
    of the shapes the widths imply on the same device, depth, skip
    period and widths within the kernels' limits.  With ``seeds=S``
    every operand carries a leading seed axis S.  Returns (widths
    [F, n_1, ..., 1], skip_ws, skip_bs as lists); raises ValueError."""
    if xg.device.type != "cuda":
        raise ValueError(f"xg lies on {xg.device}; cpu or cuda only")
    check_exact_fp32()
    lead = () if seeds is None else (seeds,)
    if xg.dim() != 3 + len(lead) or tuple(xg.shape[:len(lead)]) != lead \
            or xg.dtype != torch.float32:
        raise ValueError(f"xg must be {lead + ('T', 'O', 'F')} float32, "
                         f"got {tuple(xg.shape)} {xg.dtype}")
    t, o, f = xg.shape[-3:]
    nl = len(layer_ws)
    skip_ws, skip_bs = list(skip_ws or ()), list(skip_bs or ())
    if not 1 <= nl <= MAX_DEPTH or len(layer_bs) != nl:
        raise ValueError(f"{nl} layer weights / {len(layer_bs)} biases; "
                         f"1..{MAX_DEPTH} layers")
    if skip < 0 or (skip and (nl % skip or len(skip_ws) != nl // skip
                              or len(skip_bs) != nl // skip)):
        raise ValueError(f"skip={skip} does not divide {nl} layers into "
                         f"{len(skip_ws)} chunks")
    widths = [f] + [int(w.shape[-1]) for w in layer_ws]
    if widths[-1] != 1:
        raise ValueError(f"last layer width {widths[-1]} != 1")
    if max(widths) > MAX_WIDTH:
        raise ValueError(f"widths {widths} exceed the kernel maximum "
                         f"{MAX_WIDTH}")
    want = [(lead + (o, widths[i], widths[i + 1]), lead + (o, widths[i + 1]))
            for i in range(nl)]
    want += [(lead + (o, widths[c * skip], widths[(c + 1) * skip]),
              lead + (o, widths[(c + 1) * skip]))
             for c in range(len(skip_ws))]
    for (ws, bs), (w, b) in zip(want, list(zip(layer_ws, layer_bs))
                                + list(zip(skip_ws, skip_bs))):
        for name, a, shape in (("w", w, ws), ("b", b, bs)):
            if tuple(a.shape) != shape or a.device != xg.device \
                    or a.dtype != torch.float32:
                raise ValueError(f"{name} {tuple(a.shape)} {a.dtype} on "
                                 f"{a.device} != {shape} float32 on "
                                 f"{xg.device}")
    if t > MAX_ROWS:
        raise ValueError(f"{t} rows > kernel maximum {MAX_ROWS}")
    return widths, skip_ws, skip_bs


def grouped_subnet(xg: torch.Tensor,
                   layer_ws: Sequence[torch.Tensor],
                   layer_bs: Sequence[torch.Tensor],
                   skip_ws: Optional[Sequence[torch.Tensor]] = None,
                   skip_bs: Optional[Sequence[torch.Tensor]] = None,
                   *, skip: int = 0) -> torch.Tensor:
    """(T, O, F) float32 -> (T, O) float32.  Layer i: w (O, n_i,
    n_{i+1}), b (O, n_{i+1}); skip chunk c: w (O, n_{cS}, n_{(c+1)S}),
    b (O, n_{(c+1)S}).  On a CPU tensor this runs the plain version; on
    a CUDA tensor it launches the kernel or raises."""
    if xg.device.type == "cpu":
        return grouped_subnet_ref(xg, layer_ws, layer_bs, skip_ws, skip_bs,
                                  skip=skip)
    widths, skip_ws, skip_bs = check_operands(xg, layer_ws, layer_bs,
                                              skip_ws, skip_bs, skip)
    t, o, _ = xg.shape
    wpack = pack_subnet_weights(layer_ws, layer_bs, skip_ws, skip_bs)
    xg = xg.contiguous()
    out = torch.empty((t, o), dtype=torch.float32, device=xg.device)
    if t == 0 or o == 0:
        return out
    _launch(xg, wpack, out, widths, skip)
    grouped_subnet.launches += 1
    return out


grouped_subnet.launches = 0


def _force(force: Optional[Sequence[int]]):
    return None if force is None else (ctypes.c_int * 3)(*force)


def _launch(xg: torch.Tensor, wpack: torch.Tensor, out: torch.Tensor,
            widths: Sequence[int], skip: int,
            force: Optional[Sequence[int]] = None) -> None:
    """One launch of the kernel on checked operands (``force``: (R,
    neurons per block, rows per block) instead of the plan's, 0 = the
    plan's; for a tile sweep)."""
    t, o, _ = xg.shape
    rc = build.load_library().repro_grouped_subnet(
        xg.device.index, xg.data_ptr(), wpack.data_ptr(), out.data_ptr(),
        t, o, wpack.shape[1], len(widths) - 1,
        (ctypes.c_int * len(widths))(*widths), skip, _force(force),
        torch.cuda.current_stream(xg.device).cuda_stream)
    build.check(rc, "grouped_subnet launch")


def plan_subnet_launch(device: torch.device, t: int, o: int,
                       widths: Sequence[int], skip: int,
                       force: Optional[Sequence[int]] = None) -> SubnetPlan:
    """The plan the C entry makes for a launch of ``t`` rows x ``o``
    neurons at ``widths`` / ``skip`` on the CUDA ``device`` (``force`` as
    for :func:`_launch`); raises ValueError for a launch that it
    refuses."""
    words = (ctypes.c_longlong * len(SubnetPlan._fields))()
    rc = build.load_library().repro_grouped_subnet_launch_plan(
        torch.device(device).index or 0, t, o, len(widths) - 1,
        (ctypes.c_int * len(widths))(*widths), skip, _force(force), words)
    if rc:
        raise ValueError(f"the grouped sub-network kernel takes no launch of "
                         f"{t} x {o} at widths {widths}, skip {skip}, tile "
                         f"{force or 'planned'}")
    return SubnetPlan(*words)


def subnet_kernel_apply(fn_params: Dict, xg: torch.Tensor,
                        skip: int) -> torch.Tensor:
    """Run a (B, O, F) grouped sub-network of a ``core.subnet`` param
    dict through :func:`grouped_subnet` (the converter's
    ``kernel_infer`` route)."""
    return grouped_subnet(
        xg, [lp["w"] for lp in fn_params["layers"]],
        [lp["b"] for lp in fn_params["layers"]],
        [sp["w"] for sp in fn_params.get("skips", [])],
        [sp["b"] for sp in fn_params.get("skips", [])], skip=skip)
