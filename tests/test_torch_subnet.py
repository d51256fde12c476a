"""Port parity: the grouped sub-network (the plain version the CUDA
kernel's wrapper runs for CPU tensors) against the JAX package's Pallas
kernel in interpret mode and its jnp reference, to atol/rtol 1e-5
(float32 summation order differs between XLA:CPU and torch).
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels.neuralut_mlp import grouped_subnet as j_grouped_subnet
from repro.kernels.ref import grouped_subnet_ref as j_grouped_subnet_ref
from repro_torch.kernels.neuralut_mlp import (grouped_subnet,
                                              pack_subnet_weights)

# Small shapes: one intra-op thread keeps these tests from loading the
# CPU that the other test workers share.
torch.set_num_threads(1)

TOL = dict(atol=1e-5, rtol=1e-5)


def _weights(rng, o, widths, skip):
    def w(*shape):
        return (rng.normal(0, 1, shape) / np.sqrt(shape[-2])
                ).astype(np.float32)
    L = len(widths) - 1
    lw = [w(o, widths[i], widths[i + 1]) for i in range(L)]
    lb = [w(o, 4, widths[i + 1])[:, 0] for i in range(L)]
    sw = [w(o, widths[c * skip], widths[(c + 1) * skip])
          for c in range(L // skip)] if skip else []
    sb = [w(o, 4, widths[(c + 1) * skip])[:, 0]
          for c in range(L // skip)] if skip else []
    return lw, lb, sw, sb


@pytest.mark.parametrize("b,o,f,depth,width,skip", [
    (16, 8, 3, 4, 16, 2),    # jsc-5l's sub-network at a narrow O
    (16, 8, 2, 4, 16, 0),    # no skips
    (24, 12, 6, 4, 8, 4),    # one skip chunk over the whole depth
    (8, 4, 3, 3, 8, 3),      # jsc-5l reduced geometry
])
def test_grouped_subnet_matches_jax(b, o, f, depth, width, skip):
    rng = np.random.default_rng(b * o + skip)
    widths = [f] + [width] * (depth - 1) + [1]
    lw, lb, sw, sb = _weights(rng, o, widths, skip)
    xg = rng.normal(0, 1, (b, o, f)).astype(np.float32)
    j = [jnp.asarray(a) for a in (xg,)]
    jw = [[jnp.asarray(a) for a in group] for group in (lw, lb, sw, sb)]
    want_kernel = np.asarray(j_grouped_subnet(
        j[0], jw[0], jw[1], jw[2] or None, jw[3] or None, skip=skip,
        block_b=8, block_o=4, interpret=True))
    want_ref = np.asarray(j_grouped_subnet_ref(
        j[0], jw[0], jw[1], jw[2] or None, jw[3] or None, skip=skip))
    t = [[torch.as_tensor(a) for a in group] for group in (lw, lb, sw, sb)]
    got = grouped_subnet(torch.as_tensor(xg), t[0], t[1], t[2], t[3],
                         skip=skip).numpy()
    assert got.shape == (b, o) and got.dtype == np.float32
    np.testing.assert_allclose(got, want_kernel, **TOL)
    np.testing.assert_allclose(got, want_ref, **TOL)


def test_pack_subnet_weights_layout():
    """Per neuron: every layer's w (row-major) then b, then every skip
    chunk's w then b — the offsets csrc/neuralut_mlp.cu walks."""
    rng = np.random.default_rng(0)
    widths = [3, 16, 16, 16, 1]
    lw, lb, sw, sb = _weights(rng, 5, widths, 2)
    packed = pack_subnet_weights(*[[torch.as_tensor(a) for a in g]
                                   for g in (lw, lb, sw, sb)]).numpy()
    # 1280 FLOP per (code, neuron) at jsc-5l: 640 multiply-adds + biases
    assert packed.shape == (5, 640 + 16 + 16 + 16 + 1 + 16 + 1)
    want = np.concatenate(
        [np.concatenate([w.reshape(5, -1), b], axis=1)
         for w, b in zip(lw + sw, lb + sb)], axis=1)
    assert np.array_equal(packed, want)
