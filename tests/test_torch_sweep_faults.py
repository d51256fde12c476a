"""The port's sweep under faults, mirroring the reference's
``tests/test_chaos.py`` (resumable sweeps, retries, the journal) and
``tests/test_fault.py`` (the straggler watchdog, backup producers) on
``repro_torch``: a killed sweep resumed bit-identically, a transient
``"sweep.group"`` failure retried, the journal invalidated by a changed
hyperparameter, NaN quarantine, negative retries refused, a corrupt
journal entry trained live.  All on the CPU at the paper grid's
LogicNets geometries over 196 random features (the cheapest group)."""
import time

import numpy as np
import pytest
import torch

from repro_torch.runtime.chaos import ChaosHarness
from repro_torch.runtime.straggler import StepWatchdog, run_with_backup
from repro_torch.sweep import (SweepGroupFailed, SweepJournal,
                               paper_sweep_points, run_pareto_sweep)

# Small shapes: one intra-op thread keeps these tests from loading the
# CPU that the other test workers share.
torch.set_num_threads(1)

KW = dict(seeds=(0,), epochs=1, batch=32, device="cpu")


def _sweep_data(n_train=64, n_test=32, f=196, seed=0):
    rng = np.random.default_rng(seed)
    return (rng.standard_normal((n_train, f)).astype(np.float32),
            rng.integers(0, 10, n_train).astype(np.int32),
            rng.standard_normal((n_test, f)).astype(np.float32),
            rng.integers(0, 10, n_test).astype(np.int32))


def _same(a, b):
    assert len(a.points) == len(b.points)
    for x, y in zip(a.points, b.points):
        assert x.name == y.name and x.status == y.status == "ok"
        assert x.err == y.err and x.err_mean == y.err_mean
        for k in x.history:
            np.testing.assert_array_equal(x.history[k], y.history[k])


def test_sweep_killed_then_resumed_bit_identical(tmp_path):
    """An injected group failure kills the sweep mid-run; the rerun
    replays finished groups from the journal and trains the rest,
    matching the uninterrupted run bit for bit; a second resume replays
    every group."""
    pts = paper_sweep_points()[:3]          # two groups
    data = _sweep_data()
    clean = run_pareto_sweep(pts, *data, **KW)
    jdir = tmp_path / "journal"
    # group 0 trains; group 1's attempt and its one retry are injected
    chaos = ChaosHarness(schedule={"sweep.group": [1, 2]})
    with pytest.raises(SweepGroupFailed, match="group 1 failed after 2"):
        run_pareto_sweep(pts, *data, resume=str(jdir), max_group_retries=1,
                         retry_backoff_s=0.0, chaos=chaos, **KW)
    resumed = run_pareto_sweep(pts, *data, resume=str(jdir), **KW)
    assert [g.replayed for g in resumed.groups] == [True, False]
    _same(clean, resumed)
    replay = run_pareto_sweep(pts, *data, resume=str(jdir), convert=True,
                              **KW)
    assert all(g.replayed for g in replay.groups)
    assert replay.cold_s == 0.0
    _same(clean, replay)
    assert all(p.packed is not None for p in replay.points)


def test_sweep_retry_recovers_from_transient_failure():
    pts = paper_sweep_points()[:1]
    data = _sweep_data()
    clean = run_pareto_sweep(pts, *data, **KW)
    chaos = ChaosHarness(schedule={"sweep.group": [0]})
    records = []

    class Cap:
        def log_metrics(self, m, step=None):
            records.append(dict(m))

    retried = run_pareto_sweep(pts, *data, chaos=chaos, max_group_retries=2,
                               retry_backoff_s=0.01, tracker=Cap(), **KW)
    assert [g.retries for g in retried.groups] == [1]
    assert chaos.fired("sweep.group") == [0]
    assert all(r["retries"] == 1 and r["status"] == "ok" for r in records)
    _same(clean, retried)


def test_sweep_journal_invalidated_by_hyperparam_change(tmp_path):
    pts = paper_sweep_points()[:1]
    data = _sweep_data()
    jdir = str(tmp_path / "j")
    run_pareto_sweep(pts, *data, resume=jdir, **KW)
    assert all(g.replayed for g in run_pareto_sweep(
        pts, *data, resume=jdir, **KW).groups)
    # a different lr -> fingerprint mismatch -> trains live
    r2 = run_pareto_sweep(pts, *data, lr=1e-3, resume=jdir, **KW)
    assert not any(g.replayed for g in r2.groups)
    # so does different data
    r3 = run_pareto_sweep(pts, *_sweep_data(seed=1), resume=jdir, **KW)
    assert not any(g.replayed for g in r3.groups)


def test_sweep_nan_quarantine_marks_point_failed():
    pts = paper_sweep_points()[:1]
    r = run_pareto_sweep(pts, *_sweep_data(), seeds=(0, 1), epochs=2,
                         batch=32, lr=1e12, convert=True,
                         device="cpu")   # guaranteed divergence
    for p in r.points:
        assert p.status == "failed" and p.diverged_seeds == 2
        assert np.isnan(p.err) and np.isnan(p.err_mean)
        assert p.packed is None and p.params is None
    assert r.frontier(pts[0].tag) == []       # never enters the frontier


def test_sweep_rejects_negative_retries():
    with pytest.raises(ValueError):
        run_pareto_sweep(paper_sweep_points()[:1], *_sweep_data(),
                         max_group_retries=-1, **KW)


def test_sweep_journal_survives_corrupt_entry(tmp_path):
    jr = SweepJournal(tmp_path / "j")
    tree = {"params": {"a": np.ones(3, np.float32)},
            "state": {"b": np.zeros(2, np.float32)},
            "hist": {"loss": np.ones((1, 2), np.float32)}}
    jr.save(0, "fp", tree["params"], tree["state"], tree["hist"])
    assert jr.lookup(0, "fp") and not jr.lookup(0, "other")
    assert not jr.lookup(1, "fp")
    np.testing.assert_array_equal(jr.load(0, tree)["hist"]["loss"],
                                  tree["hist"]["loss"])
    shard = tmp_path / "j" / "step_0000000000" / "shard_0.npz"
    shard.write_bytes(b"garbage")
    with pytest.raises(Exception):
        jr.load(0, tree)


def test_sweep_trains_a_corrupt_journal_entry_live(tmp_path):
    pts = paper_sweep_points()[:1]
    data = _sweep_data()
    jdir = tmp_path / "j"
    clean = run_pareto_sweep(pts, *data, resume=str(jdir), **KW)
    (jdir / "step_0000000000" / "shard_0.npz").write_bytes(b"garbage")
    again = run_pareto_sweep(pts, *data, resume=str(jdir), **KW)
    assert not any(g.replayed for g in again.groups)
    _same(clean, again)
    # the live run rewrote the entry: the next resume replays it
    assert all(g.replayed for g in run_pareto_sweep(
        pts, *data, resume=str(jdir), **KW).groups)


def test_sweep_streams_watchdog_flags():
    pts = paper_sweep_points()[:3]
    wd = StepWatchdog(min_steps=1, k_mad=0.0)
    wd.times = [1e-6] * 5                   # every live group is "slow"
    records = []

    class Cap:
        def log_metrics(self, m, step=None):
            records.append(dict(m))

    res = run_pareto_sweep(pts, *_sweep_data(), watchdog=wd, tracker=Cap(),
                           **KW)
    assert [g.straggler for g in res.groups] == [True, True]
    assert [r["straggler"] for r in records] == [True] * 3
    assert records[-1]["straggler_persistent"] is False   # two flags < 3


def test_watchdog_flags_outliers():
    wd = StepWatchdog(min_steps=5, k_mad=4.0)
    for _ in range(20):
        assert not wd.record(0.1 + np.random.default_rng(0).uniform(0, .001))
    assert wd.record(1.0)
    assert wd.record(1.0)
    assert not wd.persistent
    assert wd.record(1.0)
    assert wd.persistent


def test_run_with_backup_prefers_fast_result():
    calls = []

    def slow_then_fast():
        calls.append(time.time())
        if len(calls) == 1:
            time.sleep(1.0)
            return "slow"
        return "fast"

    assert run_with_backup(slow_then_fast, timeout_s=0.1) == "fast"
    assert len(calls) >= 2
    with pytest.raises(ZeroDivisionError):
        run_with_backup(lambda: 1 / 0, timeout_s=0.5)
