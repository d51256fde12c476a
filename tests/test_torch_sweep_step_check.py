"""The sweep's one-step check (``chip_smoke.first_step_split``) on the
CPU, on planted data.

``chip_smoke.py`` holds one step of the paper grid's padded sweep group
against ``train_neuralut_ensemble``, split by the ensemble's gradient at
init: elements with |g| >= STEP_GRAD_T are held across the runs;
below it each run is held to its own AdamW step and the two gradients at
init to STEP_GRAD_ATOL.  Here two runs of one member are made up from
the port's own AdamW (``optim.adamw_update``) on seeded trees, with
rounding-size gradient noise, and the split must pass them and fail
each planted fault: a sign-flipped step of an element above the split,
a step that disagrees with its own AdamW formula, and a gradient at init
off by 1e-6.
"""
import importlib.util
from pathlib import Path

import numpy as np
import pytest
import torch

from repro_torch.optim import adamw_init, adamw_update, sgdr_schedule
from repro_torch.tree import tree_map

torch.set_num_threads(1)

_spec = importlib.util.spec_from_file_location(
    "chip_smoke", Path(__file__).resolve().parents[1] / "chip_smoke.py")
C = importlib.util.module_from_spec(_spec)
_spec.loader.exec_module(C)

LR = sgdr_schedule(0, lr_max=C.SWEEP_LR, lr_min=C.SWEEP_LR * 1e-2, t0=1)
SCALE = 0.8   # a clip that binds, in both runs


def _step(p0, g):
    g = tree_map(lambda t: t * SCALE, g)
    return adamw_update(g, adamw_init(p0), p0, lr=LR,
                        weight_decay=C.SWEEP_WD)[0]


def _runs(seed, noise=5e-8):
    """Two runs of one member: the same init; gradients at init that
    differ by uniform noise of amplitude ``noise`` (3 of 4 elements far
    above the split, 1 of 4 within 5e-8 of 0); each run's params after
    the step from its own gradient."""
    rng = np.random.default_rng(seed)

    def t(a):
        return torch.as_tensor(np.asarray(a, np.float32))
    shapes = {"w": (48, 16), "b": (48,), "layers": [(7, 3)]}
    p0 = {"w": t(rng.normal(0.5, 0.2, shapes["w"])),
          "b": t(rng.normal(-0.5, 0.2, shapes["b"])),
          "layers": [t(rng.normal(0.5, 0.2, shapes["layers"][0]))]}

    def grad(shape):
        big = rng.choice([-1, 1], shape) * 10 ** rng.uniform(-5, -2, shape)
        small = rng.uniform(-5e-8, 5e-8, shape)
        return np.where(rng.random(shape) < 0.75, big, small)
    g_ref = {"w": grad(shapes["w"]), "b": grad(shapes["b"]),
             "layers": [grad(shapes["layers"][0])]}
    g_got = tree_map(lambda a: t(a + rng.uniform(-noise, noise, a.shape)),
                     g_ref)
    g_ref = tree_map(t, g_ref)
    ref = {"p0": p0, "g": g_ref, "p1": _step(p0, g_ref), "scale": SCALE}
    got = {"p0": p0, "g": g_got, "p1": _step(p0, g_got), "scale": SCALE}
    return ref, got


def _split(ref, got):
    return C.first_step_split(ref, got, lr=LR, weight_decay=C.SWEEP_WD)


def test_split_limits():
    assert C.STEP_GRAD_T == 1e-6 and C.STEP_GRAD_ATOL <= 5e-7
    assert (C.STEP_RTOL, C.STEP_ATOL) == (1e-3, 1e-6)


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_split_passes_rounding_noise(seed):
    ref, got = _runs(seed)
    out = _split(ref, got)
    assert out["ok"], out["failures"]
    assert out["big"] + out["small"] == 48 * 16 + 48 + 21
    assert out["small"] > 100 and out["big"] > 500
    # below the split the steps' signs are the noise's: the runs differ
    # by up to 2 lr there, which no cross-run bound could hold
    diff = max(float((a - b).abs().max()) for (_, a), (_, b) in zip(
        C._paths(ref["p1"]), C._paths(got["p1"])))
    assert diff > float(LR)


def _small_index(ref):
    flat = ref["g"]["w"].flatten()
    return int(torch.nonzero(flat.abs() < C.STEP_GRAD_T)[0])


def _big_index(ref):
    flat = ref["g"]["w"].flatten()
    return int(torch.nonzero(flat.abs() >= 1e-4)[0])


@pytest.mark.parametrize("fault", ["sign-flip", "own-step", "grad-1e-6"])
def test_split_fails_planted_fault(fault):
    ref, got = _runs(5)
    assert _split(ref, got)["ok"]
    w0, w1 = got["p0"]["w"].flatten(), got["p1"]["w"].flatten().clone()
    if fault == "sign-flip":        # a step the wrong way, |g_init| >= T
        i = _big_index(ref)
        w1[i] = 2 * w0[i] - w1[i]
        want = "cross-run"
    elif fault == "own-step":       # below T: not its own AdamW step
        i = _small_index(ref)
        w1[i] = 2 * w0[i] - w1[i]
        want = "own AdamW step"
    else:                           # below T: g_init off by 1e-6, its own
        i = _small_index(ref)       # step taken from it (so only (i) fails)
        g = got["g"]["w"].flatten().clone()
        g[i] += 1e-6
        got["g"] = dict(got["g"], w=g.view_as(got["g"]["w"]))
        got["p1"] = _step(got["p0"], got["g"])
        w1 = got["p1"]["w"].flatten()
        want = "gradient at init"
    got["p1"] = dict(got["p1"], w=w1.view_as(got["p1"]["w"]))
    out = _split(ref, got)
    assert not out["ok"]
    assert {(f[0], f[1], f[2]) for f in out["failures"]} == {(want, "/w", i)}
