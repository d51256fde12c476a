"""Port parity: the Pareto sweep (``repro_torch.sweep``) against the JAX
package's ``repro.sweep`` and against the port's own per-geometry
ensemble.

* planning: ``plan_sweep`` groups, padded widths and configs, units,
  padding and offsets equal the reference's on the paper grid and on
  ``tests/test_sweep.py``'s grid, at 1 and 8 devices;
* fingerprints: ``group_fingerprint`` and ``_data_digest`` give the
  reference's hex digests;
* stacking: ``_pad_stack`` equals the reference's bit for bit;
* the group step: one step of ``make_ensemble_step_fn`` (per-unit
  statics) against ``jax.vmap(make_step_fn_dynamic(...))`` with the
  statics on axis 0, from one bridged state (a padded member, a unit
  axis of 4, the subnet and the linear kinds).  Tolerances as
  ``tests/test_torch_ensemble.py``: loss rtol 1e-5, BN state 1e-5,
  parameters where the unit's gradient carries signal (|g| > 1e-5) at
  rtol 1e-3 / atol 1e-6;
* the port's contract: ``run_pareto_sweep`` against
  ``train_neuralut_ensemble`` per point (histories atol 2e-3, members
  atol 2e-5: ``tests/test_sweep.py``'s tolerances), packed tables,
  records and timing.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import model as JM
from repro.core.exec_plan import plan_subnet_exec as j_plan
from repro.core.nl_config import NeuraLUTConfig as JConfig
from repro.core.train import make_step_fn_dynamic
from repro.optim import adamw as JA
from repro.sweep import plan as JP
from repro.sweep import runner as JR
from repro_torch import bridge
from repro_torch.config import config_fingerprint
from repro_torch.core import model as M
from repro_torch.core import train as TR
from repro_torch.core import truth_table as TT
from repro_torch.core.exec_plan import plan_subnet_exec
from repro_torch.core.nl_config import NeuraLUTConfig
from repro_torch.core.sparsity import random_connectivity
from repro_torch.runtime.tracker import CallbackTracker
from repro_torch.sweep import (SweepPoint, geometry_group_key,
                               member_params_state, paper_sweep_points,
                               plan_sweep, run_pareto_sweep,
                               stack_group_operands)
from repro_torch.sweep import runner as R
from repro_torch.tree import tree_leaves
from test_torch_model import numpy_model

# Small shapes: one intra-op thread keeps these tests from loading the
# CPU that the other test workers share.
torch.set_num_threads(1)

LR, WD, T0 = 2e-3, 1e-4, 50
RECORD_KEYS = ["point", "tag", "group", "err", "err_mean", "seeds",
               "latency_ns", "luts", "area_delay", "cold_s", "warm_s",
               "status", "diverged_seeds", "retries", "replayed",
               "straggler", "straggler_persistent"]


def _kw(kind):
    return (dict(depth=2, width=4, skip=2) if kind == "subnet"
            else dict(depth=1, width=1, skip=0))


def _cfg(name, widths, *, kind="subnet", fan_in=3, in_features=16,
         cls=NeuraLUTConfig):
    """tests/test_sweep.py's small configs (either package's class)."""
    return cls(name=name, in_features=in_features, layer_widths=widths,
               num_classes=4, beta=2, fan_in=fan_in, kind=kind, **_kw(kind))


def _grid(cls=NeuraLUTConfig):
    return [(_cfg("eq-a", (8, 4), cls=cls), "t"),
            (_cfg("eq-b", (6, 4), cls=cls), "t"),
            (_cfg("eq-c", (6, 4), kind="linear", cls=cls), "u"),
            (_cfg("eq-d", (8, 6, 4), cls=cls), "t"),
            (_cfg("eq-e", (10, 5, 4), cls=cls), "t")]


def _data(n, d=16, classes=4, seed=0):
    rng = np.random.default_rng(seed)
    x = rng.normal(0, 1, (n, d)).astype(np.float32)
    y = rng.integers(0, classes, n).astype(np.int32)
    return x, y


# ---------------------------------------------------------------------------
# planning


def _plans(grid, num_devices, seeds=(0, 1, 2)):
    port = plan_sweep([SweepPoint(c, t) for c, t in grid[0]], seeds=seeds,
                      num_devices=num_devices)
    ref = JP.plan_sweep([JP.SweepPoint(c, t) for c, t in grid[1]],
                        seeds=seeds, num_devices=num_devices)
    return port, ref


def _paper_grids():
    port = [(p.cfg, p.tag) for p in paper_sweep_points()]
    ref = [(p.cfg, p.tag) for p in JP.paper_sweep_points()]
    return port, ref


@pytest.mark.parametrize("num_devices", [1, 8])
@pytest.mark.parametrize("grid", ["paper", "test_sweep"])
def test_plan_matches_reference(grid, num_devices):
    grids = (_paper_grids() if grid == "paper"
             else ([(c, t) for c, t in _grid()],
                   [(c, t) for c, t in _grid(JConfig)]))
    port, ref = _plans(grids, num_devices)
    assert len(port) == len(ref) == (4 if grid == "paper" else 3)
    for a, b in zip(port, ref):
        assert a.key == b.key
        assert a.padded_cfg.layer_widths == b.padded_cfg.layer_widths
        assert a.padded_cfg.name == b.padded_cfg.name
        assert config_fingerprint(a.padded_cfg) == \
            JR.config_fingerprint(b.padded_cfg)
        assert a.units == b.units and a.pad_units == b.pad_units
        assert a.point_offset == b.point_offset and a.index == b.index
        assert a.stacked_units == b.stacked_units
        assert a.describe() == b.describe()
        assert [p.name for p in a.points] == [p.name for p in b.points]
        assert a.unit_index(len(a.points) - 1, 2) == \
            b.unit_index(len(b.points) - 1, 2)


def test_paper_points_and_group_keys_match_reference():
    port, ref = paper_sweep_points(), JP.paper_sweep_points()
    assert [p.tag for p in port] == [p.tag for p in ref]
    for a, b in zip(port, ref):
        assert dataclasses.asdict(a.cfg) == dataclasses.asdict(b.cfg)
        assert config_fingerprint(a.cfg) == JR.config_fingerprint(b.cfg)
        assert geometry_group_key(a.cfg) == JP.geometry_group_key(b.cfg)
    with pytest.raises(ValueError):
        plan_sweep([], seeds=(0,))
    with pytest.raises(ValueError):
        plan_sweep([SweepPoint(port[0].cfg)], seeds=())
    with pytest.raises(ValueError):
        plan_sweep([SweepPoint(port[0].cfg)], seeds=(0,), num_devices=0)


# ---------------------------------------------------------------------------
# fingerprints and stacking


def test_fingerprints_match_reference():
    port, ref = _plans(([(c, t) for c, t in _grid()],
                        [(c, t) for c, t in _grid(JConfig)]), 1)
    arrays = [*_data(48, seed=3), *_data(16, seed=4)]
    assert R._data_digest(*arrays) == JR._data_digest(*arrays)
    # tensors digest as their host arrays
    assert R._data_digest(*(torch.as_tensor(a) for a in arrays)) == \
        JR._data_digest(*arrays)
    ddig = JR._data_digest(*arrays)
    for kw in (dict(epochs=2, batch=64, lr=2e-3, weight_decay=1e-4,
                    sgdr_t0=0, subnet_route=None),
               dict(epochs=3, batch=32, lr=1e-3, weight_decay=0.0,
                    sgdr_t0=7, subnet_route="canonical")):
        for a, b in zip(port, ref):
            assert R.group_fingerprint(a, data_digest=ddig, **kw) == \
                JR.group_fingerprint(b, data_digest=ddig, **kw)
    fps = {R.group_fingerprint(a, data_digest=ddig, epochs=2, batch=64,
                               lr=2e-3, weight_decay=1e-4, sgdr_t0=0,
                               subnet_route=None) for a in port}
    assert len(fps) == len(port)


def _members(cfgs, seeds, conn_seed):
    """Per point: S numpy members in the JAX layout, stacked (S, ...),
    and its connectivity from a fixed rng."""
    trees, conns = [], []
    for i, c in enumerate(cfgs):
        ms = [numpy_model(c, 100 * i + s) for s in seeds]
        trees.append(tuple(jax.tree.map(lambda *a: np.stack(a),
                                        *[m[k] for m in ms])
                           for k in (0, 1)))
        rng = np.random.default_rng(conn_seed + i)
        w = [c.in_features] + list(c.layer_widths)
        conns.append([random_connectivity(
            w[li], w[li + 1], c.layer_fan_in(li),
            seed=int(rng.integers(2 ** 31))) for li in range(c.num_layers)])
    return trees, conns


def test_pad_stack_equals_reference_bitwise():
    cfgs = [_cfg("pa", (8, 6, 4), cls=JConfig),
            _cfg("pb", (5, 7, 4), cls=JConfig)]
    trees, _ = _members(cfgs, (0, 1), conn_seed=0)
    for k in (0, 1):
        for pad in (0, 3):
            want = JR._pad_stack([t[k] for t in trees], pad)
            got = R._pad_stack([t[k] for t in trees], pad)
            w, g = jax.tree.leaves(want), tree_leaves(got)
            assert len(w) == len(g)
            for a, b in zip(w, g):
                assert a.shape == tuple(b.shape) and a.dtype == np.float32
                np.testing.assert_array_equal(a, b.numpy())


def test_stacked_operands_slice_back_to_true_shapes():
    xtr, _ = _data(64)
    pts = [SweepPoint(_cfg("sl-a", (8, 4)), "t"),
           SweepPoint(_cfg("sl-b", (5, 4)), "t")]
    g = plan_sweep(pts, seeds=(0, 1), num_devices=1)[0]
    params, state, opt, statics, seeds = stack_group_operands(
        g, xtr, device="cpu")
    assert seeds == [0, 1, 0, 1] and opt["count"].shape == (4,)
    assert statics[0]["conn"].shape == (4, 8, 3)
    conn_b = np.asarray(M.model_static(pts[1].cfg)[0]["conn"])
    np.testing.assert_array_equal(statics[0]["conn"][2, :5].numpy(), conn_b)
    assert not statics[0]["conn"][2, 5:].any()     # padded rows read lane 0
    for pi, pt in enumerate(pts):
        p0, s0, _ = TR.init_ensemble(pt.cfg, (0, 1), xtr, device="cpu")
        for si in range(2):
            p1, s1 = member_params_state(g, params, state, pi, si)
            want = tree_leaves(TR.ensemble_member(p0, s0, si))
            got = tree_leaves((p1, s1))
            assert len(got) == len(want)
            for a, b in zip(got, want):
                assert torch.equal(a, b)
    spec_p, _ = M.model_spec(pts[1].cfg)
    p1, _ = member_params_state(g, params, state, 1, 0)
    assert p1["layers"][0]["fn"]["layers"][0]["w"].shape == \
        spec_p["layers"][0]["fn"]["layers"][0]["w"]


# ---------------------------------------------------------------------------
# one group step against jax.vmap(make_step_fn_dynamic) with the statics
# on axis 0


@pytest.mark.parametrize("kind,route", [("subnet", "neuron_leading"),
                                        ("subnet", "kernel_train"),
                                        ("linear", None)])
def test_group_step_matches_jax_vmap(kind, route):
    widths = ((8, 6, 4), (5, 7, 4))     # the second member is padded
    seeds = (0, 1)
    jcfgs = [_cfg(f"gs-{i}", w, kind=kind, cls=JConfig)
             for i, w in enumerate(widths)]
    pcfgs = [_cfg(f"gs-{i}", w, kind=kind) for i, w in enumerate(widths)]
    jgroup = JP.plan_sweep([JP.SweepPoint(c) for c in jcfgs], seeds=seeds)[0]
    group = plan_sweep([SweepPoint(c) for c in pcfgs], seeds=seeds)[0]
    assert jgroup.padded_cfg.layer_widths == (8, 7, 4)
    u = jgroup.num_units
    assert u == 4

    trees, conns = _members(jcfgs, seeds, conn_seed=5)
    params_np = JR._pad_stack([t[0] for t in trees], 0)
    state_np = JR._pad_stack([t[1] for t in trees], 0)
    jstatics = []
    for li in range(jgroup.padded_cfg.num_layers):
        rows = []
        for c in conns:
            conn = np.zeros((jgroup.padded_cfg.layer_widths[li],
                             jgroup.padded_cfg.layer_fan_in(li)), np.int32)
            conn[:c[li].shape[0]] = c[li]
            rows += [conn] * len(seeds)
        jstatics.append({"conn": np.stack(rows)})
    x = np.random.default_rng(9).normal(0, 1, (u, 64, 16)).astype(np.float32)
    y = np.random.default_rng(10).integers(0, 4, (u, 64)).astype(np.int32)

    jp = jax.tree.map(jnp.asarray, params_np)
    js = jax.tree.map(jnp.asarray, state_np)
    jo = jax.vmap(JA.adamw_init)(jp)
    jstep = jax.jit(jax.vmap(make_step_fn_dynamic(
        jgroup.padded_cfg, lr=LR, weight_decay=WD, t0=T0,
        exec_plan=j_plan(jgroup.padded_cfg, purpose="train",
                         route="neuron_leading" if route else None))))
    jp1, js1, jo1, jl = jstep(jp, js, jo, jax.tree.map(jnp.asarray, jstatics),
                              jnp.asarray(x), jnp.asarray(y))

    pcfg = group.padded_cfg
    p, s = bridge.params_from_numpy(pcfg, params_np, state_np, device="cpu",
                                    seeds=u)
    o = bridge.opt_from_numpy(pcfg, jax.tree.map(
        lambda a: None if a is None else np.asarray(a), jo,
        is_leaf=lambda a: a is None), device="cpu", seeds=u)
    sd = [{"conn": torch.as_tensor(st["conn"]).long()} for st in jstatics]
    step = TR.make_ensemble_step_fn(
        pcfg, lr=LR, weight_decay=WD, t0=T0,
        exec_plan=plan_subnet_exec(pcfg, purpose="train", route=route,
                                   device="cpu"))
    p1, s1, o1, loss = step(p, s, o, sd, torch.as_tensor(x),
                            torch.as_tensor(y))

    assert loss.shape == (u,)
    np.testing.assert_allclose(loss.numpy(), np.asarray(jl), rtol=1e-5)
    for a, b in zip(tree_leaves(s1), jax.tree.leaves(js1)):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), rtol=1e-5,
                                   atol=1e-5)
    masks, grads = [], []
    for k in range(u):
        _, g, _ = TR.loss_and_grads(
            pcfg, jax.tree.map(lambda a: a[k], p),
            jax.tree.map(lambda a: a[k], s),
            [{"conn": c["conn"][k]} for c in sd], torch.as_tensor(x[k]),
            torch.as_tensor(y[k]),
            exec_plan=plan_subnet_exec(pcfg, purpose="train", device="cpu"))
        grads.append(g)
        masks.append([np.abs(a.numpy()) > 1e-5 for a in tree_leaves(g)])
    compared = 0
    for i, (a, b) in enumerate(zip(tree_leaves(p1), jax.tree.leaves(jp1))):
        m = np.stack([masks[k][i] for k in range(u)])
        compared += int(m.sum())
        np.testing.assert_allclose(a.numpy()[m], np.asarray(b)[m],
                                   rtol=1e-3, atol=1e-6)
    assert compared > (200 if kind == "subnet" else 60)
    # the padded member's padded lanes (layer 0, lanes 5-7) get exactly
    # zero gradient; its real lanes do not
    for k in (2, 3):
        lanes = tree_leaves(grads[k]["layers"][0])
        assert all(a.shape[0] == 8 for a in lanes)
        assert all(not a[5:].any() for a in lanes)
        assert any(a[:5].abs().max() > 1e-5 for a in lanes)


def test_group_step_one_kernel_call_per_layer(monkeypatch):
    """On the kernel_train route the group step reaches the training
    kernels' vmap rules: one forward and one backward call per layer,
    with the unit axis in front (the plain versions run them here)."""
    from repro_torch.kernels import neuralut_grad as NG
    calls = []
    fwd, bwd = NG.subnet_train_fwd_ref, NG.subnet_train_bwd_ref
    monkeypatch.setattr(NG, "subnet_train_fwd_ref", lambda *a, **k: (
        calls.append(("fwd", tuple(a[0].shape))), fwd(*a, **k))[1])
    monkeypatch.setattr(NG, "subnet_train_bwd_ref", lambda *a, **k: (
        calls.append(("bwd", tuple(a[1].shape))), bwd(*a, **k))[1])
    pts = [SweepPoint(_cfg("k-a", (8, 6, 4))), SweepPoint(_cfg("k-b",
                                                              (5, 6, 4)))]
    xtr, ytr = _data(128)
    g = plan_sweep(pts, seeds=(0, 1, 2))[0]
    ops = stack_group_operands(g, xtr, device="cpu")
    fn = R.make_group_train_fn(g.padded_cfg, n=128, batch=64, epochs=1,
                               lr=LR, weight_decay=WD, device="cpu",
                               subnet_route="kernel_train")
    x, y = torch.as_tensor(xtr), torch.as_tensor(ytr)
    _, _, hist, cold = fn(*ops, x, y, x, y)
    assert cold > 0 and hist["loss"].shape == (6, 1)
    per_step = [("fwd", (6, 64, 8, 3)), ("fwd", (6, 64, 6, 3)),
                ("fwd", (6, 64, 4, 3)), ("bwd", (6, 64, 4, 3)),
                ("bwd", (6, 64, 6, 3)), ("bwd", (6, 64, 8, 3))]
    assert calls == per_step * 2


# ---------------------------------------------------------------------------
# the port's contract: the sweep against the per-geometry ensemble


# Padded lanes change the order of a unit's float32 reductions: at some
# connectivities a padded member's first gradients of its per-lane
# quantizer scales (sums over the batch) differ from the ensemble's in
# the last bits.  Adam turns that on the leaves whose exact gradient is
# 0 (the biases feeding BN, which BN subtracts again) into lr-sized
# steps; the BN means follow them.  Readings over 16 PYTHONHASHSEEDs and
# 40 fixed connectivities of this grid: those leaves up to 1.2e-3, the
# BN means up to 5.6e-4, the signal up to 6e-8, histories up to 2.4e-7.
ZERO_GRAD_ATOL = 5e-3


def _assert_member_close(cfg, got_p, got_s, ref_p, ref_s, x, y):
    """Params where the reference's gradient on (x, y) carries signal
    (|g| > 1e-5) and the BN variances at atol 2e-5; the other params and
    the BN means at ZERO_GRAD_ATOL."""
    _, grads, _ = TR.loss_and_grads(
        cfg, ref_p, ref_s, M.device_statics(M.model_static(cfg), "cpu"),
        torch.as_tensor(x), torch.as_tensor(y),
        exec_plan=plan_subnet_exec(cfg, purpose="train", device="cpu"))
    signal = 0
    for a, b, g in zip(tree_leaves(got_p), tree_leaves(ref_p),
                       tree_leaves(grads)):
        assert a.shape == b.shape
        m = (g.abs() > 1e-5).numpy()
        signal += int(m.sum())
        np.testing.assert_allclose(a.numpy()[m], b.numpy()[m], atol=2e-5)
        np.testing.assert_allclose(a.numpy()[~m], b.numpy()[~m],
                                   atol=ZERO_GRAD_ATOL)
    assert signal > 50
    for layer, ref in zip(got_s["layers"], ref_s["layers"]):
        np.testing.assert_allclose(layer["bn"]["var"], ref["bn"]["var"],
                                   atol=2e-5)
        np.testing.assert_allclose(layer["bn"]["mean"], ref["bn"]["mean"],
                                   atol=ZERO_GRAD_ATOL)


def test_sweep_matches_ensemble_and_streams():
    xtr, ytr = _data(192, seed=0)
    xte, yte = _data(96, seed=1)
    pts = [SweepPoint(c, t) for c, t in _grid()[:3]]
    records = []
    tracker = CallbackTracker(
        lambda m, step, summary: records.append((step, m)))
    res = run_pareto_sweep(pts, xtr, ytr, xte, yte, seeds=(0, 1),
                           epochs=2, batch=64, lr=2e-3, tracker=tracker,
                           convert=True, device="cpu")
    assert [g.group.num_units for g in res.groups] == [4, 2]
    assert [r.name for r in res.points] == ["eq-a", "eq-b", "eq-c"]
    for pt, r in zip(pts, res.points):
        params, state, hist = TR.train_neuralut_ensemble(
            pt.cfg, xtr, ytr, xte, yte, seeds=(0, 1), epochs=2, batch=64,
            lr=2e-3, device="cpu")
        for k in ("loss", "test_acc", "test_acc_q"):
            assert r.history[k].shape == (2, 2)
            np.testing.assert_allclose(r.history[k], hist[k], atol=2e-3,
                                       err_msg=f"{pt.name}/{k}")
        _assert_member_close(
            pt.cfg, r.params, r.state,
            *TR.ensemble_member(params, state, r.best_seed), xtr, ytr)
        tables, packed = r.packed
        assert len(tables) == len(packed) == pt.cfg.num_layers
        assert all(t.dtype == np.uint16 for t in tables)
        want_t, want_p = TT.convert_packed(pt.cfg, r.params, r.state,
                                           M.model_static(pt.cfg))
        for a, b in zip(tables + packed, want_t + want_p):
            np.testing.assert_array_equal(a, b)
        assert r.status == "ok" and r.diverged_seeds == 0
        assert r.err == pytest.approx(1 - r.history["test_acc_q"][-1].max())

    assert [m["point"] for _, m in records] == ["eq-a", "eq-b", "eq-c"]
    assert [s for s, _ in records] == [0, 1, 2]
    for _, m in records:
        assert list(m) == RECORD_KEYS
        assert 0.0 <= m["err"] <= 1.0 and m["cold_s"] > 0
        assert m["warm_s"] > 0 and m["seeds"] == 2
    assert res.total_s == pytest.approx(res.cold_s + res.warm_s)
    assert res.cold_s == pytest.approx(sum(g.cold_s for g in res.groups))
    assert res.frontier("t") == res.points[:2]
    assert res.frontier("u") == res.points[2:] and res.devices == 1


@pytest.mark.parametrize("name", ["eq-a", "eq-b", "eq-d"])
def test_one_point_group_is_the_ensemble_bit_for_bit(name):
    """A point alone in its group trains on the ensemble's own path (its
    connectivity expanded over the seed axis): histories and the best
    member equal bit for bit."""
    cfg = next(c for c, _ in _grid() if c.name == name)
    xtr, ytr = _data(128, seed=4)
    xte, yte = _data(64, seed=5)
    kw = dict(seeds=(0, 1), epochs=2, batch=32, lr=2e-3, device="cpu")
    r, = run_pareto_sweep([SweepPoint(cfg)], xtr, ytr, xte, yte,
                          convert=True, **kw).points
    params, state, hist = TR.train_neuralut_ensemble(cfg, xtr, ytr, xte,
                                                     yte, **kw)
    for k in hist:
        np.testing.assert_array_equal(r.history[k], hist[k])
    ref_p, ref_s = TR.ensemble_member(params, state, r.best_seed)
    for a, b in zip(tree_leaves(r.params) + tree_leaves(r.state),
                    tree_leaves(ref_p) + tree_leaves(ref_s)):
        assert torch.equal(a, b)


def test_sweep_reruns_bit_identically_and_sgdr_t0_changes_it():
    xtr, ytr = _data(128, seed=2)
    xte, yte = _data(64, seed=3)
    pts = [SweepPoint(_cfg("rr-a", (8, 4)), "t"),
           SweepPoint(_cfg("rr-b", (6, 4)), "t")]
    kw = dict(seeds=(0, 1), epochs=2, batch=32, lr=2e-3, device="cpu")
    a = run_pareto_sweep(pts, xtr, ytr, xte, yte, **kw)
    b = run_pareto_sweep(pts, xtr, ytr, xte, yte, **kw)
    c = run_pareto_sweep(pts, xtr, ytr, xte, yte, sgdr_t0=3, **kw)
    for ra, rb, rc in zip(a.points, b.points, c.points):
        np.testing.assert_array_equal(ra.history["loss"], rb.history["loss"])
        assert not np.array_equal(ra.history["loss"], rc.history["loss"])
    # sgdr_t0 reaches the trainers too: the ensemble matches the group
    _, _, hist = TR.train_neuralut_ensemble(
        pts[1].cfg, xtr, ytr, xte, yte, seeds=(0, 1), epochs=2, batch=32,
        lr=2e-3, sgdr_t0=3, device="cpu")
    np.testing.assert_allclose(c.points[1].history["loss"], hist["loss"],
                               atol=2e-3)


def test_devices_above_one_raise_naming_the_roadmap_item():
    xtr, ytr = _data(64)
    with pytest.raises(NotImplementedError, match="Queue A item 3"):
        run_pareto_sweep([SweepPoint(_cfg("d", (8, 4)))], xtr, ytr, xtr,
                         ytr, seeds=(0,), epochs=1, devices=2, device="cpu")
