"""Synthetic JSC data: a numpy copy of ``repro.data.synthetic
.jsc_synthetic``, so the port and the JAX package see the same data
for the same seed."""
from __future__ import annotations

from typing import Tuple

import numpy as np


def jsc_synthetic(n: int, *, seed: int = 0) -> Tuple[np.ndarray, np.ndarray]:
    """16 jet-substructure-like features, 5 classes.

    Class-conditional gaussian mixture pushed through a fixed random
    nonlinearity so classes are not linearly separable (mirrors the ~75%
    ceiling structure of the real task: overlapping classes)."""
    rng = np.random.default_rng(seed)
    gen = np.random.default_rng(1234)  # fixed task geometry across splits
    centers = gen.normal(0, 1.0, (5, 16))
    mix = gen.normal(0, 0.6, (16, 16))
    y = rng.integers(0, 5, n).astype(np.int32)
    x = centers[y] + rng.normal(0, 1.1, (n, 16))
    x = np.tanh(x @ mix) + 0.3 * x
    x = (x - x.mean(0)) / (x.std(0) + 1e-6)
    return x.astype(np.float32), y
