"""A-priori random sparsity (paper §III-A, inherited from LogicNets).

A verbatim copy of ``repro.core.sparsity``; the port keeps
its own copy of every jax-free module it needs and imports nothing of
the JAX package.

Each L-LUT neuron receives exactly F inputs drawn from the previous layer's
outputs.  LogicNets justifies uniform random connectivity via expander-graph
theory; we reproduce it and add a "balanced" variant that additionally
guarantees near-uniform out-degree of the source neurons (round-robin over a
shuffled multiset) — used as a beyond-paper ablation.
"""
from __future__ import annotations

import numpy as np


def random_connectivity(in_width: int, out_width: int, fan_in: int, *,
                        seed: int, mode: str = "random") -> np.ndarray:
    """Returns int32 (out_width, fan_in) indices into [0, in_width).

    Each row has distinct entries (sampling without replacement) when
    in_width >= fan_in.
    """
    if fan_in > in_width:
        raise ValueError(f"fan_in {fan_in} > in_width {in_width}")
    rng = np.random.default_rng(seed)
    if mode == "random":
        conn = np.stack([
            rng.choice(in_width, size=fan_in, replace=False)
            for _ in range(out_width)
        ])
    elif mode == "balanced":
        # Round-robin over shuffled copies of range(in_width): every source
        # feeds ceil(out*F/in) +-1 destinations; rows deduplicated by reroll.
        need = out_width * fan_in
        reps = -(-need // in_width)
        pool = np.concatenate([rng.permutation(in_width) for _ in range(reps)])
        conn = pool[:need].reshape(out_width, fan_in)
        for i in range(out_width):
            tries = 0
            while len(set(conn[i])) < fan_in and tries < 100:
                dup = fan_in - len(set(conn[i]))
                fresh = rng.choice(in_width, size=fan_in, replace=False)
                conn[i] = np.concatenate(
                    [np.array(sorted(set(conn[i]))), fresh])[:fan_in]
                tries += 1
    else:
        raise ValueError(mode)
    return conn.astype(np.int32)
