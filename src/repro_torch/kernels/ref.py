"""Plain PyTorch versions of the CUDA kernels: the correctness
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


# The training references take an optional leading seed axis S on every
# operand (the seed ensemble), as the kernels do: "..." below is () or
# (S,).

def _mm(h, w, b=None):
    """(..., B, O, ni) x (..., O, ni, no) -> (..., B, O, no),
    neuron-batched."""
    out = torch.einsum("...boi,...oij->...boj", h, w)
    return out if b is None else out + b.unsqueeze(-3)


def _mm_t(g, w):
    """Cotangent through the product: (..., B, O, no) x (..., O, ni, no)
    -> (..., B, O, ni)."""
    return torch.einsum("...boj,...oij->...boi", g, w)


def _dw(a, g):
    """Per-neuron weight gradient summed over rows: (..., B, O, ni) x
    (..., B, O, no) -> (..., O, ni, no)."""
    return torch.einsum("...boi,...boj->...oij", a, g)


def subnet_train_fwd_ref(xg: torch.Tensor,
                         layer_ws: Sequence[torch.Tensor],
                         layer_bs: Sequence[torch.Tensor],
                         skip_ws: Sequence[torch.Tensor] = (),
                         skip_bs: Sequence[torch.Tensor] = (),
                         skip: int = 0
                         ) -> Tuple[torch.Tensor, List[torch.Tensor]]:
    """Reference for the training forward kernel, step by step as the
    Pallas body ``repro.kernels.neuralut_grad._fwd_kernel``: the output
    (B, O) and the input of every sub-layer i >= 1 (the post-ReLU
    activation, (B, O, n_i)), in order i = 1 .. L-1.  Plain tensors, no
    autograd.  Every operand may carry a leading seed axis S."""
    L = len(layer_ws)
    acts: List[torch.Tensor] = [None] * (L - 1)

    def save(i, h):
        acts[i - 1] = h

    h = xg.to(torch.float32)
    if skip == 0:
        for i in range(L):
            if i > 0:
                save(i, h)
            h = _mm(h, layer_ws[i], layer_bs[i])
            if i < L - 1:
                h = torch.relu(h)
        return h[..., 0], acts
    nch = L // skip
    for c in range(nch):
        if c > 0:
            save(c * skip, h)
        res = _mm(h, skip_ws[c], skip_bs[c])
        hh = h
        for j in range(skip):
            i = c * skip + j
            if j > 0:
                save(i, hh)
            hh = _mm(hh, layer_ws[i], layer_bs[i])
            if j < skip - 1:
                hh = torch.relu(hh)
        h = hh + res
        if c < nch - 1:
            h = torch.relu(h)
    return h[..., 0], acts


def subnet_train_bwd_ref(g: torch.Tensor, xg: torch.Tensor,
                         acts: Sequence[torch.Tensor],
                         layer_ws: Sequence[torch.Tensor],
                         skip_ws: Sequence[torch.Tensor] = (),
                         skip: int = 0):
    """Reference for the training backward kernel, step by step as the
    Pallas body ``repro.kernels.neuralut_grad._bwd_kernel``.

    g: (B, O) cotangent of the output; ``acts`` from
    :func:`subnet_train_fwd_ref`.  Returns (dx (B, O, F), [dW_i],
    [db_i], [dR_c], [dRb_c]), the weight gradients summed over B.  ReLU
    masks are recovered from the saved post-ReLU values (``a > 0``), so
    the gradient at 0 is 0, as ``jax.nn.relu``'s and ``torch.relu``'s.
    Every operand may carry a leading seed axis S.  Float64 operands
    stay float64 (an exact oracle for the float32 kernel).
    """
    L = len(layer_ws)
    dt = torch.float64 if xg.dtype == torch.float64 else torch.float32
    x = xg.to(dt)
    dws: List[torch.Tensor] = [None] * L
    dbs: List[torch.Tensor] = [None] * L

    def a_in(i):
        return x if i == 0 else acts[i - 1]

    def through_layer(i, gm):
        a = a_in(i)
        dws[i] = _dw(a, gm)
        dbs[i] = gm.sum(dim=-3)
        return _mm_t(gm, layer_ws[i]), a

    gh = g.to(dt)[..., None]                             # (B, O, 1)
    if skip == 0:
        gm = gh
        for i in range(L - 1, -1, -1):
            gm, a = through_layer(i, gm)
            if i > 0:
                gm = gm * (a > 0)
        return gm, dws, dbs, [], []
    nch = L // skip
    drs: List[torch.Tensor] = [None] * nch
    drbs: List[torch.Tensor] = [None] * nch
    gout = gh
    dx = None
    for c in range(nch - 1, -1, -1):
        hc = a_in(c * skip)
        drs[c] = _dw(hc, gout)
        drbs[c] = gout.sum(dim=-3)
        ghc = _mm_t(gout, skip_ws[c])
        gm = gout
        for i in range((c + 1) * skip - 1, c * skip - 1, -1):
            gm, a = through_layer(i, gm)
            if i > c * skip:
                gm = gm * (a > 0)
        ghc = ghc + gm
        if c > 0:
            gout = ghc * (hc > 0)          # inter-chunk ReLU boundary
        else:
            dx = ghc
    return dx, dws, dbs, drs, drbs


def lut_gather_ref(tables: torch.Tensor, addr: torch.Tensor) -> torch.Tensor:
    """Plain per-layer lookup (the same function as
    ``repro.kernels.ref.lut_gather_ref``): tables (O, T) int32, addr
    (B, O) int -> (B, O) int32 with ``out[b, o] = tables[o, addr[b, o]]``.
    Addresses are clamped into [0, T), as the CUDA kernel clamps them."""
    o, t = tables.shape
    rows = torch.arange(o, device=tables.device)[None, :]
    return tables[rows, addr.long().clamp(0, t - 1)].to(torch.int32)


def lut_layer_ref(tables: torch.Tensor, codes: torch.Tensor,
                  conn: torch.Tensor, in_bits: int) -> torch.Tensor:
    """Plain per-layer step of a chain (the reference's ``layer_kernel``
    body: gather, ``pack_index``, lookup): tables (O, T), codes (B, I)
    int, conn (O, F) int -> (B, O) int32 with ``out[b, o] = tables[o,
    clamp(sum_j codes[b, conn[o, j]] << (in_bits (F-1-j)), 0, T-1)]``."""
    return lut_gather_ref(tables, pack_index(codes[:, conn.long()], in_bits))


# (in_bits, word_bits, slot_bits, beta_out) of one chain layer; see
# kernels/lut_cascade.cascade_meta.
LayerMeta = Tuple[int, int, int, int]

# (srcs, arity, in_bits, word_bits, slot_bits, beta_out) of one DAG node;
# see kernels/lut_cascade.graph_cascade_meta.  ``srcs`` are buffer
# indices (0 = the input codes, j + 1 = node j's output), concatenated in
# that order into the pool every branch's connectivity indexes; the
# node's ``arity`` branches each look up a ``beta_out``-bit code and the
# node stores their sum.  Chain layer i is the node ((i,), 1, ...).
NodeSched = Tuple[Tuple[int, ...], int, int, int, int, int]


def as_schedule(meta) -> Tuple[NodeSched, ...]:
    """Chain ``LayerMeta`` 4-tuples or a node schedule -> the node
    schedule, with plain ints (hashable)."""
    out = []
    for i, m in enumerate(meta):
        if len(m) == 4:
            out.append(((i,), 1) + tuple(int(v) for v in m))
        elif len(m) == 6:
            out.append((tuple(int(b) for b in m[0]),)
                       + tuple(int(v) for v in m[1:]))
        else:
            raise ValueError(f"node {i}: {m!r} is neither a chain layer "
                             "(4 fields) nor a DAG node (6 fields)")
    return tuple(out)


def lut_cascade_ref(codes: torch.Tensor,
                    conns: Sequence[torch.Tensor],
                    packed_tables: Sequence[torch.Tensor],
                    schedule) -> torch.Tensor:
    """Plain cascade over bit-packed tables, in gather form, walking a
    node schedule (anything :func:`as_schedule` takes; a chain is the
    degenerate DAG).

    ``conns`` and ``packed_tables`` are flat in (node, branch) order.
    Per node: concatenate the source buffers into the pool; per branch
    gather the connected codes by ``conn`` (O, F), form the address
    with ``pack_index`` (slot 0 = MSB), load word ``addr >> slot_bits``
    of the neuron's packed row and shift out slot ``addr & (P - 1)``;
    sum the branch codes.  A buffer is dropped after its last reader.
    The same function as ``repro.kernels.ref.lut_cascade_packed_ref``
    (its DAG walk) without its f32 shift-matrix product, and
    bit-identical to ``lut_infer.lut_forward`` / ``graph_lut_forward``
    on the unpacked tables.  Input codes must lie in [0, 2^in_bits).
    codes: (B, W_0) int -> (B, O_last) int32.
    """
    sched = as_schedule(schedule)
    branches = sum(arity for _s, arity, *_r in sched)
    if not len(conns) == len(packed_tables) == branches:
        raise ValueError(f"the schedule has {branches} branches, got "
                         f"{len(conns)} conns and {len(packed_tables)} "
                         "tables")
    last_use = {}
    for n, (srcs, *_r) in enumerate(sched):
        for s in srcs:
            last_use[s] = n
    bufs: List[Optional[torch.Tensor]] = [codes.to(torch.int32)]
    k = 0
    for n, (srcs, arity, in_bits, _wb, slot_bits, beta) in enumerate(sched):
        pool = (bufs[srcs[0]] if len(srcs) == 1
                else torch.cat([bufs[s] for s in srcs], dim=1))
        out = None
        for _a in range(arity):
            conn, packed = conns[k], packed_tables[k]
            k += 1
            o, words = packed.shape
            addr = pack_index(pool[:, conn.long()], in_bits)    # (B, O)
            wsel = (addr >> slot_bits).clamp(max=words - 1).long()
            slot = addr & ((1 << slot_bits) - 1)
            rows = torch.arange(o, device=packed.device)[None, :]
            word = packed[rows, wsel]                           # (B, O)
            code = (word >> (beta * slot)) & ((1 << beta) - 1)
            out = code if out is None else out + code
        for s in set(srcs):
            if last_use[s] == n:
                bufs[s] = None
        bufs.append(out)
    return bufs[-1].to(torch.int32)


def _blocked_carrier(sched) -> torch.dtype:
    """The narrowest safe integer dtype of the blocked walk's buffers
    and addresses: int16 when every address (word and slot bits) and
    every node's branch sum fits 15 bits, else int32."""
    bits = max(max(wb + sb, int(arity * ((1 << beta) - 1)).bit_length())
               for _s, arity, _ib, wb, sb, beta in sched)
    return torch.int16 if bits <= 15 else torch.int32


def lut_cascade_blocked(codes: torch.Tensor,
                        conns: Sequence[torch.Tensor],
                        packed_tables: Sequence[torch.Tensor],
                        schedule, block_b: int = 512) -> torch.Tensor:
    """Cache-blocked gather cascade (port of
    ``repro.kernels.ref.lut_cascade_blocked``, the reference's compiled
    CPU serving route): the function of :func:`lut_cascade_ref`, walked
    neuron-major over tiles of ``block_b`` rows.

    Codes ride as (W, Bt) tiles in the narrowest safe integer dtype
    (``_blocked_carrier``: int16 for every paper geometry).  Per node
    the source tiles concatenate as rows into the pool; per branch and
    fan-in slot j one row gather ``pool[conn[:, j]]`` shifted by
    ``in_bits (F - 1 - j)`` adds into the address (slot 0 = MSB, as
    ``pack_index``); the packed word ``packed[o, addr >> slot_bits]``
    is gathered per neuron row and the slot's code shifted out; branch
    codes sum.  The reference derives the per-slot gathers from its
    shift matrices; the port holds the connectivity itself.
    codes: (B, W_0) int -> (B, O_last) int32, bit-identical to
    :func:`lut_cascade_ref`."""
    sched = as_schedule(schedule)
    branches = sum(arity for _s, arity, *_r in sched)
    if not len(conns) == len(packed_tables) == branches:
        raise ValueError(f"the schedule has {branches} branches, got "
                         f"{len(conns)} conns and {len(packed_tables)} "
                         "tables")
    carrier = _blocked_carrier(sched)
    pts = [p.to(torch.int32) for p in packed_tables]
    cols = [[c[:, j].long() for j in range(c.shape[1])] for c in conns]

    def tile(h0: torch.Tensor) -> torch.Tensor:
        bufs = [h0]
        k = 0
        for srcs, arity, in_bits, _wb, slot_bits, beta in sched:
            pool = (bufs[srcs[0]] if len(srcs) == 1
                    else torch.cat([bufs[s] for s in srcs], dim=0))
            node = None
            for _a in range(arity):
                f = len(cols[k])
                addr = None
                for j, rows in enumerate(cols[k]):
                    g = pool[rows]                              # (O, Bt)
                    s = in_bits * (f - 1 - j)
                    g = (g << s) if s else g
                    addr = g if addr is None else addr + g
                packed = pts[k]
                k += 1
                o, words = packed.shape
                wsel = (addr >> slot_bits).long().clamp(max=words - 1)
                slot = (addr & ((1 << slot_bits) - 1)).to(torch.int32)
                word = packed[torch.arange(o, device=packed.device)[:, None],
                              wsel]
                code = (word >> (beta * slot)) & ((1 << beta) - 1)
                node = code if node is None else node + code
            bufs.append(node.to(carrier))
        return bufs[-1].to(torch.int32)

    h_all = codes.t().to(carrier)                               # (W_0, B)
    b = codes.shape[0]
    bb = max(1, min(int(block_b), b))
    outs = [tile(h_all[:, s:s + bb]) for s in range(0, b, bb)]
    return torch.cat(outs, dim=1).t()
