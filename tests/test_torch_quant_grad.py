"""Port parity: the quantizer's gradients with respect to its input and
its learned scale, against ``jax.grad`` of the JAX package's
``quant_apply``.

The inputs include values whose straight-through rounding lands exactly
on the lowest or highest code, where ``jnp.clip`` (a maximum/minimum
pair) splits the gradient in half between the value and the bound.
Tolerances: atol/rtol 1e-6 for the values and the input gradient
(one or two float32 products each); rtol 1e-5 for the scale gradient, a
sum over 30 rows of terms up to 2^(beta-1) whose order differs between
XLA:CPU and torch.  A tie taken whole instead of halved is off by 50 %.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import quant as JQ
from repro_torch.core import quant as Q

# Small shapes: one intra-op thread keeps these tests from loading the
# CPU that the other test workers share.
torch.set_num_threads(1)

TOL = dict(atol=1e-6, rtol=1e-6)
SUM_TOL = dict(atol=1e-5, rtol=1e-5)


def _inputs(beta, seed):
    """(B, C) values and per-channel log scales; a third of the values
    sit on the clip ties, the rest spread over and past the code range."""
    rng = np.random.default_rng(seed)
    c = 6
    log_s = np.log(rng.uniform(0.2, 0.6, c)).astype(np.float32)
    s = np.exp(log_s)
    lo, hi = -(2 ** (beta - 1)), 2 ** (beta - 1) - 1
    q = rng.uniform(lo - 2.5, hi + 2.5, (30, c))
    q[:10] = rng.choice([lo, hi], (10, c)) + rng.uniform(-0.4, 0.4, (10, c))
    return (q * s).astype(np.float32), log_s


@pytest.mark.parametrize("beta", [3, 4, 7])
def test_quant_apply_grads_match_jax(beta):
    x, log_s = _inputs(beta, seed=beta)
    w = np.random.default_rng(1).normal(0, 1, x.shape).astype(np.float32)

    def jloss(ls, xx):
        return jnp.sum(JQ.quant_apply({"log_s": ls}, xx, beta) * w)
    jg_ls, jg_x = jax.grad(jloss, argnums=(0, 1))(jnp.asarray(log_s),
                                                  jnp.asarray(x))

    tls = torch.tensor(log_s, requires_grad=True)
    tx = torch.tensor(x, requires_grad=True)
    y = Q.quant_apply({"log_s": tls}, tx, beta)
    (y * torch.as_tensor(w)).sum().backward()

    np.testing.assert_allclose(
        y.detach().numpy(),
        np.asarray(JQ.quant_apply({"log_s": jnp.asarray(log_s)},
                                  jnp.asarray(x), beta)), **TOL)
    np.testing.assert_allclose(tx.grad.numpy(), np.asarray(jg_x), **TOL)
    np.testing.assert_allclose(tls.grad.numpy(), np.asarray(jg_ls),
                               **SUM_TOL)
    # the ties are really there: a half gradient on some inputs
    assert np.isclose(np.abs(np.asarray(jg_x) / w), 0.5).any()


def test_batch_row_sums_are_float64():
    """BN's batch statistics and the row sums of the scale, gain and bias
    gradients are float64 sums rounded once to float32, so their value
    does not depend on the order a float32 reduction would take (on
    CUDA, the tensor's shape, the unit count of a vmapped ensemble
    included).  The column [1e8, 1, -1e8, 1] sums to 2 exactly; in
    float32 the ones are lost to the 1e8 in any order."""
    col = torch.tensor([1e8, 1.0, -1e8, 1.0])
    x = torch.stack([col, torch.ones(4)], dim=1)
    p = {"g": torch.ones(2, requires_grad=True),
         "b": torch.zeros(2, requires_grad=True)}
    state = {"mean": torch.zeros(2), "var": torch.zeros(2)}
    y, new = Q.bn_apply(p, state, x, train=True, momentum=1.0)
    assert new["mean"].tolist() == [0.5, 1.0]
    (y * x).sum().backward()
    assert p["b"].grad[0].item() == 2.0      # sum of the column, float64
    log_s = torch.zeros(2, requires_grad=True)
    Q.quant_apply({"log_s": log_s}, torch.full((4, 2), 0.25), 4).mul(
        x).sum().backward()
    # at s = 1 each row's d(round(v / s) * s)/dlog_s is round(v) - v
    # (straight-through) = -0.25, weighted by the column
    assert log_s.grad[0].item() == -0.25 * 2.0
