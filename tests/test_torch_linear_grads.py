"""The LogicNets (``linear``) and PolyLUT (``poly``) products in an
order no shape changes (``core.subnet._NeuronDot``: the forward's
products added one by one, the weight gradient's rows summed in
float64): the forward and the gradients match the reference's
``linear_apply`` and ``poly_apply``, and a sweep group's vmapped
gradients at init equal each unit's computed alone, bit for bit,
whatever the unit count.

Tolerances: the forward against the reference to 1e-6, gradients at
the reference's own rtol 2e-4 / atol 3e-5; the order of the sums and
the unit-count checks exactly.  The unit
count checks run with one intra-op thread (the CPU's threaded
reductions round otherwise from call to call); on the card
``probes/linear_grads.py`` makes the same check.
"""
import importlib.util
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import subnet as JS
from repro_torch.core import subnet as S

torch.set_num_threads(1)

ROOT = Path(__file__).resolve().parents[1]
GRAD = dict(rtol=2e-4, atol=3e-5)


def _data(seed=0, b=256, o=8, f=6):
    rng = np.random.default_rng(seed)
    return (rng.normal(0, 1, (b, o, f)).astype(np.float32),
            rng.normal(0, 1, (o, f)).astype(np.float32),
            rng.normal(0, 1, (o,)).astype(np.float32),
            rng.normal(0, 1, (b, o)).astype(np.float32))


def test_forward_sums_in_order_and_matches_reference():
    """The forward adds the products in order k = 0..K-1, so a unit's
    output is the same bit for bit whatever else is batched with it; it
    equals the reference's einsum to float32 rounding."""
    x, w, b, _ = _data()
    tx, tw, tb = (torch.as_tensor(a) for a in (x, w, b))
    got = S.linear_apply({"w": tw, "b": tb}, tx)
    want = tx[..., 0] * tw[:, 0]
    for k in range(1, 6):
        want = want + tx[..., k] * tw[:, k]
    assert torch.equal(got, want + tb)
    np.testing.assert_allclose(got.numpy(), np.asarray(JS.linear_apply(
        {"w": jnp.asarray(w), "b": jnp.asarray(b)}, jnp.asarray(x))),
        rtol=1e-6, atol=1e-6)
    batched = torch.func.vmap(lambda x, w: S._NeuronDot.apply(x, w))(
        torch.stack([tx, tx.flip(0)]), torch.stack([tw, tw * 2]))
    assert torch.equal(batched[0], S._NeuronDot.apply(tx, tw))


@pytest.mark.parametrize("kind", ["linear", "poly"])
def test_grads_match_reference(kind):
    """The gradients of x, w (and b) of a weighted sum of the output
    against the reference's."""
    x, w, b, g = _data(3)
    exps = S.monomial_exponents(6, 2)
    if kind == "poly":
        x = np.tanh(x)     # quantized-activation-like range
        w = np.random.default_rng(4).normal(0, 1, (8, len(exps))).astype(
            np.float32)
        p = {"w": w}
        jf = lambda p, x: jnp.sum(JS.poly_apply(p, x, exps) * g)  # noqa: E731
    else:
        p = {"w": w, "b": b}
        jf = lambda p, x: jnp.sum(JS.linear_apply(p, x) * g)  # noqa: E731
    jg = jax.grad(jf, argnums=(0, 1))({k: jnp.asarray(v) for k, v in
                                       p.items()}, jnp.asarray(x))
    tp = {k: torch.as_tensor(v).requires_grad_(True) for k, v in p.items()}
    tx = torch.as_tensor(x).requires_grad_(True)
    out = (S.poly_apply(tp, tx, exps) if kind == "poly"
           else S.linear_apply(tp, tx))
    (out * torch.as_tensor(g)).sum().backward()
    for k in tp:
        assert tp[k].grad.dtype == torch.float32
        np.testing.assert_allclose(tp[k].grad.numpy(), np.asarray(jg[0][k]),
                                   **GRAD)
    np.testing.assert_allclose(tx.grad.numpy(), np.asarray(jg[1]), **GRAD)


def test_vmapped_grads_equal_the_unbatched_ones():
    """Under ``torch.func.vmap`` (the ensemble's and the sweep's unit
    axis) each unit's weight and bias gradients equal its own
    unbatched ones bit for bit."""
    units = [_data(10 + u) for u in range(3)]
    stack = [torch.as_tensor(np.stack(a)) for a in zip(*units)]

    def loss(x, w, b, g):
        return (S.linear_apply({"w": w, "b": b}, x) * g).sum()

    grad = torch.func.grad(loss, argnums=(1, 2))
    gw, gb = torch.func.vmap(grad)(*stack)
    for u, data in enumerate(units):
        ow, ob = grad(*(torch.as_tensor(a) for a in data))
        assert torch.equal(gw[u], ow) and torch.equal(gb[u], ob)


def test_group_grads_at_init_equal_one_units():
    """The paper grid's first LogicNets group (U = 6): each unit's loss
    gradient at init, vmapped over the first U = 1, 3 and 6 units as the
    group step takes it, equals the unit's own computed alone, leaf by
    leaf and bit for bit (``probes/linear_grads.py``'s check)."""
    spec = importlib.util.spec_from_file_location(
        "linear_grads", ROOT / "probes" / "linear_grads.py")
    probe = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(probe)
    C = probe._chip_smoke()
    from repro_torch.data import device_dataset, mnist_pooled
    from repro_torch.sweep import paper_sweep_points, plan_sweep

    dev = torch.device("cpu")
    x, y = device_dataset(mnist_pooled, 512, seed=0, device=dev)
    groups = plan_sweep(paper_sweep_points(), seeds=C.SWEEP_SEEDS)
    group = next(g for g in groups if g.padded_cfg.kind == "linear"
                 and g.num_units >= max(probe.UNITS))
    r = probe.readings(dev, group, x, y)     # the port's linear_apply
    assert set(r) == {f"U={u}" for u in probe.UNITS}
    for u, v in r.items():
        assert v["of"] > 10 and v["elements"] == 0, (u, v)
