"""Synthetic datasets: numpy copies of ``repro.data.synthetic``'s
``two_semicircles``, ``jsc_synthetic``, ``mnist_synthetic`` and
``mnist_pooled`` and the LM data ``token_stream``, so the port and the
JAX package see the same arrays for the same seed.

The paper's datasets (MNIST, CERN jet substructure tagging) are
replaced by statistically similar stand-ins with the same shapes and
class counts; every generator is deterministic given a seed.
"""
from __future__ import annotations

from typing import Tuple

import numpy as np


def two_semicircles(n: int, *, seed: int = 0, noise: float = 0.12
                    ) -> Tuple[np.ndarray, np.ndarray]:
    """The Fig. 3 toy task (two interleaved semicircles, a la make_moons)."""
    rng = np.random.default_rng(seed)
    n2 = n // 2
    t = rng.uniform(0, np.pi, n2)
    x0 = np.stack([np.cos(t), np.sin(t)], 1)
    x1 = np.stack([1 - np.cos(t), 0.5 - np.sin(t)], 1)
    x = np.concatenate([x0, x1]) + rng.normal(0, noise, (2 * n2, 2))
    y = np.concatenate([np.zeros(n2, np.int32), np.ones(n2, np.int32)])
    p = rng.permutation(2 * n2)
    return x[p].astype(np.float32), y[p]


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


def mnist_synthetic(n: int, *, seed: int = 0
                    ) -> Tuple[np.ndarray, np.ndarray]:
    """784-dim digit-like task, 10 classes.

    Ten fixed smooth prototype 28x28 images; samples = prototype shifted by
    +-2px + pixel noise + random per-sample contrast.  Hard enough that
    expressivity differences show, easy enough to train in seconds."""
    rng = np.random.default_rng(seed)
    gen = np.random.default_rng(4321)
    # smooth prototypes: superpositions of low-frequency 2D cosines
    xs = np.linspace(0, 1, 28)
    xx, yy = np.meshgrid(xs, xs)
    protos = []
    for c in range(10):
        img = np.zeros((28, 28))
        for _ in range(4):
            fx, fy = gen.uniform(1, 4, 2)
            px, py = gen.uniform(0, np.pi, 2)
            img += gen.uniform(0.4, 1.0) * np.cos(
                2 * np.pi * fx * xx + px) * np.cos(2 * np.pi * fy * yy + py)
        img = (img - img.min()) / (img.max() - img.min())
        protos.append(img)
    protos = np.stack(protos)

    y = rng.integers(0, 10, n).astype(np.int32)
    imgs = protos[y]
    sx = rng.integers(-2, 3, n)
    sy = rng.integers(-2, 3, n)
    out = np.empty((n, 28, 28), np.float32)
    for i in range(n):
        out[i] = np.roll(np.roll(imgs[i], sx[i], 0), sy[i], 1)
    out *= rng.uniform(0.8, 1.2, (n, 1, 1))
    out += rng.normal(0, 0.15, out.shape)
    return out.reshape(n, 784).astype(np.float32), y


def mnist_pooled(n: int, *, seed: int = 0) -> Tuple[np.ndarray, np.ndarray]:
    """``mnist_synthetic`` 28x28 -> 14x14 average pool => 196 standardized
    features — the input the circuit-level Pareto sweeps train on
    (``repro_torch.launch.sweep``).  Standardization is
    per split, matching the historical benchmark pooling helper."""
    x, y = mnist_synthetic(n, seed=seed)
    img = x.reshape(-1, 28, 28)
    out = img.reshape(-1, 14, 2, 14, 2).mean((2, 4)).reshape(-1, 196)
    out = (out - out.mean(0)) / (out.std(0) + 1e-6)
    return out.astype(np.float32), y


def token_stream(n_tokens: int, vocab: int, *, seed: int = 0,
                 order: int = 2) -> np.ndarray:
    """Zipf-distributed token stream with short-range structure (a cheap
    markov flavor): t_i depends on t_{i-order} via a fixed permutation mix."""
    rng = np.random.default_rng(seed)
    ranks = np.arange(1, vocab + 1)
    p = 1.0 / ranks ** 1.1
    p /= p.sum()
    base = rng.choice(vocab, size=n_tokens, p=p).astype(np.int32)
    perm = np.random.default_rng(99).permutation(vocab)
    out = base.copy()
    for i in range(order, n_tokens):
        if out[i] % 3 == 0:  # a third of positions are "predictable"
            out[i] = perm[out[i - order]]
    return out
