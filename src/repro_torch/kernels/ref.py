"""Plain PyTorch versions of the two CUDA kernels: the correctness
reference the kernels are held against, and what their wrappers run for
tensors that lie on the CPU."""
from __future__ import annotations

from typing import List, Optional, Sequence, Tuple

import torch

from repro_torch.core.lut_infer import pack_index


def grouped_subnet_ref(xg: torch.Tensor,
                       layer_ws: Sequence[torch.Tensor],
                       layer_bs: Sequence[torch.Tensor],
                       skip_ws: Optional[Sequence[torch.Tensor]] = None,
                       skip_bs: Optional[Sequence[torch.Tensor]] = None,
                       skip: int = 0) -> torch.Tensor:
    """Reference for the grouped sub-network kernel (the same function
    as ``repro.kernels.ref.grouped_subnet_ref``).

    xg: (B, O, F); layer i: w (O, n_i, n_{i+1}), b (O, n_{i+1}); skip
    chunk c: w (O, n_{cS}, n_{(c+1)S}), b (O, n_{(c+1)S}).  Returns
    (B, O): the last layer has n_out == 1 and is squeezed.  phi = ReLU
    between layers and between chunks.
    """
    def mm(h, w, b):
        return torch.einsum("boi,oij->boj", h, w) + b[None]

    L = len(layer_ws)
    h = xg
    if skip == 0:
        for i in range(L):
            h = mm(h, layer_ws[i], layer_bs[i])
            if i < L - 1:
                h = torch.relu(h)
        return h[..., 0]
    nch = L // skip
    for c in range(nch):
        res = mm(h, skip_ws[c], skip_bs[c])
        hh = h
        for j in range(skip):
            i = c * skip + j
            hh = mm(hh, layer_ws[i], layer_bs[i])
            if j < skip - 1:
                hh = torch.relu(hh)
        h = hh + res
        if c < nch - 1:
            h = torch.relu(h)
    return h[..., 0]


# (in_bits, word_bits, slot_bits, beta_out) of one chain layer; see
# kernels/lut_cascade.cascade_meta.
LayerMeta = Tuple[int, int, int, int]


def lut_cascade_ref(codes: torch.Tensor,
                    conns: List[torch.Tensor],
                    packed_tables: List[torch.Tensor],
                    meta: Sequence[LayerMeta]) -> torch.Tensor:
    """Plain cascade over bit-packed tables, in gather form.

    Per layer: gather the connected codes by ``conn`` (O, F), form the
    address with ``pack_index`` (slot 0 = MSB), load word
    ``addr >> slot_bits`` of the neuron's packed row and shift out slot
    ``addr & (P - 1)``.  The same function as
    ``repro.kernels.ref.lut_cascade_packed_ref`` without its f32
    shift-matrix product, and bit-identical to ``lut_infer.lut_forward``
    on the unpacked tables.  Codes must lie in [0, 2^in_bits).
    codes: (B, W_0) int -> (B, O_last) int32.
    """
    c = codes.to(torch.int32)
    for conn, packed, (in_bits, _wb, slot_bits, beta) in zip(
            conns, packed_tables, meta):
        o, words = packed.shape
        addr = pack_index(c[:, conn.long()], in_bits)          # (B, O)
        wsel = (addr >> slot_bits).clamp(max=words - 1).long()
        slot = addr & ((1 << slot_bits) - 1)
        rows = torch.arange(o, device=packed.device)[None, :]
        word = packed[rows, wsel]                              # (B, O)
        c = (word >> (beta * slot)) & ((1 << beta) - 1)
    return c.to(torch.int32)
