"""Port parity: the replica-routed ``LUTServeEngine`` and its runtime.
Routing decisions, chaos decision streams and health-tracker states
equal the reference's on the same inputs; replicas on ``devices=["cpu",
"cpu"]`` serve predictions equal to JAX ``lut_infer.predict``; and the
self-healing paths — eviction, redispatch, ``DispatchFailed``,
``DeadlineExceeded``, ``NoHealthyReplicas`` and ``revive_probe`` —
behave as in ``tests/test_chaos.py`` and ``tests/test_serve_sharded.py``;
a failing kernel fails its batch, with no fallback to its plain
version.  The
kernel wrappers' launch counters lose no count under threads."""
import sys
import threading

import numpy as np
import pytest
import torch

from repro.runtime.chaos import ChaosHarness as JChaosHarness
from repro.runtime.fault import ReplicaHealthTracker as JHealth
from repro.serve.engine import route_least_loaded as j_route
from repro_torch.core import exec_plan
from repro_torch.kernels import build
from repro_torch.kernels.lut_cascade import CascadeOperands, lut_cascade
from repro_torch.kernels.ref import lut_cascade_ref
from repro_torch import serve
from repro_torch.runtime import (ChaosHarness, ChaosInjected,
                                 FailureInjector, NodeFailure,
                                 ReplicaHealthTracker)
from repro_torch.serve import (DeadlineExceeded, DispatchFailed,
                               LUTServeEngine, NoHealthyReplicas,
                               pick_bucket, route_least_loaded)
from repro_torch.serve.engine import _Request

from test_torch_registry import CASES, bundles, configs, jax_predict

torch.set_num_threads(1)

X = np.random.default_rng(3).normal(0, 1, (64, 16)).astype(np.float32)


@pytest.fixture(scope="module")
def chain():
    pcfg, jcfg = configs(*CASES[0])
    return bundles(pcfg, jcfg, 21)


@pytest.fixture(scope="module")
def graph():
    pcfg, jcfg = configs(*CASES[1])
    return bundles(pcfg, jcfg, 22)


def engine(bundle, **kw):
    kw.setdefault("device", "cpu")
    return LUTServeEngine(bundle, **kw)


# ---------------------------------------------------------------------------
# routing, chaos and health: the same decisions as the reference


class _Ex:
    def __init__(self, rid, depth):
        self.rid, self._depth = rid, depth

    def depth(self):
        return self._depth


ROUTES = [  # (depths, evicted, rr, exclude)
    ((0, 0), (), 0, None), ((0, 0), (), 1, None), ((1, 0), (), 0, None),
    ((2, 1, 1), (), 2, None), ((0, 0, 0), (0,), 0, None),
    ((3, 3, 3), (), 1, 1), ((0, 5), (), 0, 0), ((0, 0), (1,), 0, 0),
    ((1, 1, 0, 2), (2,), 3, None), ((0, 0), (0, 1), 0, None),
    ((4, 2, 2, 4), (), 2, 2), ((1,), (), 0, 0)]


@pytest.mark.parametrize("depths,evicted,rr,exclude", ROUTES)
def test_route_least_loaded_equals_reference(depths, evicted, rr, exclude):
    exs = [_Ex(i, d) for i, d in enumerate(depths)]
    ph, jh = ReplicaHealthTracker(len(depths)), JHealth(len(depths))
    for rid in evicted:
        ph.evict(rid)
        jh.evict(rid)
    got = route_least_loaded(exs, ph, rr, exclude=exclude)
    want = j_route(exs, jh, rr, exclude=exclude)
    assert (got and got.rid) == (want and want.rid)


CHAOS = [dict(seed=0, rates={"serve.replica": 0.3}),
         dict(seed=7, rates={"serve.replica": 0.35, "serve.kernel": 0.1}),
         dict(seed=42, schedule={"serve.replica": [1, 3]},
              rates={"registry.load": 0.5}),
         dict(seed=3, schedule={"serve.kernel": [0], "registry.load": [2]})]


@pytest.mark.parametrize("kw", CHAOS)
def test_chaos_harness_events_equal_reference(kw):
    ph, jh = ChaosHarness(**kw), JChaosHarness(**kw)
    sites = ["serve.replica", "serve.kernel", "registry.load"]
    for i in range(120):
        site = sites[i % 3 if i % 5 else 0]
        assert ph.should_fire(site) == jh.should_fire(site)
    assert ph.events == jh.events
    for site in sites:
        assert ph.fired(site) == jh.fired(site)
        assert ph.count(site) == jh.count(site)


def test_chaos_schedule_keyed_and_injector():
    ch = ChaosHarness(schedule={"s": [1, 3], "train.step": [7]})
    fired = []
    for i in range(5):
        try:
            ch.check("s")
            fired.append(False)
        except ChaosInjected as e:
            fired.append(True)
            assert e.site == "s" and e.index == i
    assert fired == [False, True, False, True, False]
    ch.check("train.step", index=3)
    with pytest.raises(ChaosInjected):
        ch.check("train.step", index=7)
    ch.check("train.step", index=7)          # one shot per key
    inj = FailureInjector(fail_at=(2,))
    inj.check(1)
    with pytest.raises(NodeFailure, match="at step 2"):
        inj.check(2)
    with pytest.raises(ValueError):
        ChaosHarness(rates={"s": 1.5})
    calls = []
    wrapped = ChaosHarness(schedule={"w": [0]}).wrap("w", calls.append)
    with pytest.raises(ChaosInjected):
        wrapped(1)
    wrapped(2)
    assert calls == [2]


HEALTH = [  # (replicas, max failures, events)
    (3, 2, [("f", 0), ("f", 0), ("s", 1), ("f", 1), ("s", 1), ("f", 2)]),
    (2, 1, [("f", 1), ("r", 1), ("f", 0), ("e", 1)]),
    (1, 3, [("f", 0), ("s", 0), ("f", 0), ("f", 0), ("f", 0), ("r", 0)])]


@pytest.mark.parametrize("n,maxf,events", HEALTH)
def test_health_tracker_equals_reference(n, maxf, events):
    evicted = {"p": [], "j": []}
    ph = ReplicaHealthTracker(n, max_consecutive_failures=maxf,
                              on_evict=lambda r, e: evicted["p"].append(r))
    jh = JHealth(n, max_consecutive_failures=maxf,
                 on_evict=lambda r, e: evicted["j"].append(r))
    for op, rid in events:
        for h in (ph, jh):
            {"f": h.record_failure, "s": h.record_success,
             "r": h.revive, "e": h.evict}[op](rid)
        assert ph.status() == jh.status()
    assert evicted["p"] == evicted["j"]
    assert ph.healthy_ids() == jh.healthy_ids()
    assert ph.failure_counts() == jh.failure_counts()
    with pytest.raises(IndexError):
        ph.record_failure(n)
    with pytest.raises(ValueError):
        ReplicaHealthTracker(0)


# ---------------------------------------------------------------------------
# serving on replicas


@pytest.mark.parametrize("net", ["chain", "graph"])
def test_two_cpu_replicas_equal_jax_predict(net, chain, graph):
    pb, jb = chain if net == "chain" else graph
    want = jax_predict(jb, X)
    sizes = [1, 3, 8, 9, 20, 1, 17, 5]
    offs = np.cumsum([0] + sizes)
    with engine(pb, replicas=2, devices=["cpu", "cpu"], max_wait_ms=0.0,
                buckets=(1, 8, 16)) as eng:
        eng.warmup()
        futs = [eng.submit(X[a:b]) for a, b in zip(offs[:-1], offs[1:])]
        got = [f.result(timeout=60) for f in futs]
    for (a, b), g in zip(zip(offs[:-1], offs[1:]), got):
        assert g.dtype == np.int32 and np.array_equal(g, want[a:b])
    assert eng.replicas == 2
    assert sum(m.report()["batches"] for m in eng.replica_metrics) == \
        eng.metrics.report()["batches"]
    assert eng.forwards >= len(sizes) // 8


def test_replicas_cycle_over_the_device_pool(chain):
    pb, _ = chain
    eng = LUTServeEngine(pb, replicas=3, devices=["cpu"])
    assert [ex.device.type for ex in eng._executors] == ["cpu"] * 3
    eng.close()
    with pytest.raises(ValueError, match="health tracker covers"):
        engine(pb, replicas=2, health=ReplicaHealthTracker(3))
    with pytest.raises(ValueError):
        engine(pb, replicas=0)
    with pytest.raises(ValueError):
        engine(pb, max_dispatch_retries=-1)
    with pytest.raises(ValueError, match="replicas=1"):
        engine(pb, sharded=True, replicas=2)


def test_evicted_replica_stops_receiving_batches(chain):
    """Evict the replica sticky routing favors: every later batch flows
    to replica 1 and replica 0's batch count freezes."""
    pb, jb = chain
    health = ReplicaHealthTracker(2)
    with engine(pb, replicas=2, devices=["cpu", "cpu"], health=health,
                buckets=(1, 8)) as eng:
        eng.predict(X[:8])
        eng.predict(X[:8])
        frozen = eng.replica_metrics[0].report()["batches"]
        assert frozen > 0           # sequential load sticks to replica 0
        health.evict(0)
        for i in range(6):
            np.testing.assert_array_equal(eng.predict(X[i:i + 8]),
                                          jax_predict(jb, X[i:i + 8]))
        assert eng.replica_metrics[0].report()["batches"] == frozen
        assert eng.replica_metrics[1].report()["batches"] >= 6
    assert health.healthy_ids() == [1]


def _boom(_):
    raise RuntimeError("injected replica failure")


def test_failing_replica_auto_evicts_and_serving_recovers(chain):
    """Break replica 0: its failed dispatch evicts it (firing on_evict)
    and the batch is redispatched to replica 1, so no client sees the
    error, and every later request routes to the survivor."""
    pb, jb = chain
    evicted = []
    health = ReplicaHealthTracker(
        2, max_consecutive_failures=1,
        on_evict=lambda rid, exc: evicted.append((rid, str(exc))))
    with engine(pb, replicas=2, devices=["cpu", "cpu"], health=health,
                buckets=(4,)) as eng:
        eng._executors[0]._forward = _boom
        for i in range(12):
            np.testing.assert_array_equal(eng.predict(X[i:i + 4]),
                                          jax_predict(jb, X[i:i + 4]))
        assert not health.is_healthy(0)
        assert evicted and evicted[0][0] == 0
        assert "injected replica failure" in evicted[0][1]
        rep = eng.metrics.report()
        assert rep["redispatches"] == 1.0 and rep["requests"] == 12.0


def test_raising_on_evict_hook_never_strands_clients(chain):
    pb, jb = chain

    def bad_hook(rid, exc):
        raise ValueError("hook exploded")
    health = ReplicaHealthTracker(2, max_consecutive_failures=1,
                                  on_evict=bad_hook)
    with engine(pb, replicas=2, devices=["cpu", "cpu"], health=health,
                buckets=(4,), max_dispatch_retries=0) as eng:
        eng._executors[0]._forward = _boom
        with pytest.raises(RuntimeError, match="injected replica failure"):
            eng.predict(X[:4])
        assert not health.is_healthy(0)
        for _ in range(3):
            np.testing.assert_array_equal(eng.predict(X[:4]),
                                          jax_predict(jb, X[:4]))


def test_all_replicas_unhealthy_fails_fast(chain):
    pb, _ = chain
    health = ReplicaHealthTracker(1)
    health.evict(0)
    eng = engine(pb, health=health)
    try:
        with pytest.raises(NoHealthyReplicas, match="no healthy replicas"):
            eng.predict(X[:1])
    finally:
        eng.close()


def test_redispatch_heals_single_replica_failure(chain):
    pb, jb = chain
    chaos = ChaosHarness(schedule={"serve.replica": [0]})
    with engine(pb, replicas=2, devices=["cpu", "cpu"], chaos=chaos) as eng:
        preds = eng.predict(X[:8])
    np.testing.assert_array_equal(preds, jax_predict(jb, X[:8]))
    assert eng.metrics.redispatches == 1
    assert eng.metrics.report()["redispatches"] == 1
    assert eng.replica_metrics[0].report()["batches"] == 0
    assert eng.replica_metrics[1].report()["batches"] == 1


@pytest.mark.parametrize("retries", [0, 1, 2])
def test_dispatch_failed_after_retry_budget(chain, retries):
    pb, _ = chain
    chaos = ChaosHarness(schedule={"serve.replica": range(retries + 1)})
    health = ReplicaHealthTracker(1, max_consecutive_failures=10)
    with engine(pb, health=health, max_dispatch_retries=retries,
                chaos=chaos) as eng:
        with pytest.raises(DispatchFailed) as ei:
            eng.submit(X[:4]).result(timeout=30)
    assert ei.value.attempts == retries + 1
    assert isinstance(ei.value.cause, ChaosInjected)
    assert eng.metrics.redispatches == retries


def test_kernel_failure_fails_the_batch_with_the_error(chain, monkeypatch):
    """Nothing falls back by default: the cascade's error reaches the
    futures (chained in DispatchFailed) and no downgrade is recorded."""
    pb, _ = chain

    def boom(codes, ops, **kw):
        raise RuntimeError("lut_cascade launch: CUDA error 700")
    monkeypatch.setattr(exec_plan, "lut_cascade", boom)
    with engine(pb, max_dispatch_retries=0) as eng:
        with pytest.raises(DispatchFailed, match="CUDA error 700"):
            eng.predict(X[:4])
    assert eng.metrics.downgrades == 0


def test_deadline_exceeded_is_typed_and_counted(chain):
    pb, jb = chain
    with engine(pb) as eng:
        fut = eng.submit(X[:2], timeout_s=1e-9)   # expires before routing
        with pytest.raises(DeadlineExceeded):
            fut.result(timeout=30)
        np.testing.assert_array_equal(eng.predict(X[:2]),
                                      jax_predict(jb, X[:2]))
        with pytest.raises(ValueError):
            eng.submit(X[:2], timeout_s=0.0)
    assert eng.metrics.deadline_exceeded == 1
    assert eng.metrics.report()["deadline_exceeded"] == 1


def test_drop_expired_resolves_only_the_late():
    from repro_torch.serve.engine import _drop_expired
    from repro_torch.serve.metrics import ServeMetrics
    m = ServeMetrics()
    late, live = _Request(X[:1], 1e-9), _Request(X[:1], 60.0)
    plain = _Request(X[:1])
    assert _drop_expired([late, live, plain], m) == [live, plain]
    assert isinstance(late.future.exception(timeout=1), DeadlineExceeded)
    assert m.deadline_exceeded == 1 and not live.future.done()


def test_no_healthy_replicas_shed_and_auto_revive(chain):
    pb, jb = chain
    chaos = ChaosHarness(schedule={"serve.replica": [0]})
    health = ReplicaHealthTracker(1, max_consecutive_failures=1)
    with engine(pb, health=health, max_dispatch_retries=0,
                chaos=chaos) as eng:
        with pytest.raises(DispatchFailed):
            eng.submit(X[:2]).result(timeout=30)
        with pytest.raises(NoHealthyReplicas):
            eng.submit(X[:2]).result(timeout=30)
    assert eng.metrics.shed == 1

    chaos = ChaosHarness(schedule={"serve.replica": [0]})
    health = ReplicaHealthTracker(1, max_consecutive_failures=1)
    probed = []
    with engine(pb, health=health, max_dispatch_retries=0, chaos=chaos,
                revive_probe=lambda rid: probed.append(rid) or True) as eng:
        with pytest.raises(DispatchFailed):
            eng.submit(X[:2]).result(timeout=30)
        preds = eng.predict(X[:2])             # the probe revives it
    np.testing.assert_array_equal(preds, jax_predict(jb, X[:2]))
    assert probed == [0] and eng.metrics.shed == 0


def test_raising_revive_probe_counts_as_down(chain):
    pb, _ = chain
    health = ReplicaHealthTracker(1)
    health.evict(0)

    def probe(rid):
        raise RuntimeError("probe crashed")
    with engine(pb, health=health, revive_probe=probe) as eng:
        with pytest.raises(NoHealthyReplicas):
            eng.predict(X[:2])
        assert eng._thread.is_alive()


@pytest.mark.parametrize("net", ["chain", "graph"])
def test_kernel_failure_on_one_replica_redispatches(net, chain, graph,
                                                    monkeypatch):
    """K1 raising on replica 0 (its worker thread) evicts it and the
    batch is served by replica 1's K1 route: nothing takes the plain
    cascade in the kernel's place."""
    pb, jb = chain if net == "chain" else graph
    real, calls = exec_plan.lut_cascade, []

    def flaky(codes, ops, **kw):
        name = threading.current_thread().name
        calls.append(name)
        if name == "lut-serve-replica-0":
            raise RuntimeError("lut_cascade launch: CUDA error 700")
        return real(codes, ops, **kw)
    monkeypatch.setattr(exec_plan, "lut_cascade", flaky)
    health = ReplicaHealthTracker(2, max_consecutive_failures=1)
    with engine(pb, replicas=2, devices=["cpu", "cpu"], health=health,
                buckets=(8,)) as eng:
        for i in range(4):
            np.testing.assert_array_equal(eng.predict(X[i:i + 8]),
                                          jax_predict(jb, X[i:i + 8]))
    assert health.healthy_ids() == [1] and eng.metrics.redispatches == 1
    assert calls == ["lut-serve-replica-0"] + ["lut-serve-replica-1"] * 4
    assert eng.metrics.downgrades == 0


def test_engine_has_no_degradable_route(chain):
    """The reference's kernel-to-jnp degradation wrapper is not ported:
    the engine takes no such option and the package exports none."""
    pb, _ = chain
    with pytest.raises(TypeError, match="degradable"):
        engine(pb, degradable=True)
    assert not hasattr(serve, "make_degradable_forward_fn")
    assert "make_degradable_forward_fn" not in serve.__all__


# ---------------------------------------------------------------------------
# batcher and lifecycle (tests/test_serve_engine.py's cases)


def test_pick_bucket_rounds_up():
    assert [pick_bucket(n, (1, 8, 64, 256)) for n in
            (1, 2, 8, 9, 65, 1000)] == [1, 8, 8, 64, 256, 256]
    with pytest.raises(ValueError):
        pick_bucket(0, (1, 8))


def test_oversized_request_chunks_through_max_bucket(chain):
    pb, jb = chain
    with engine(pb, buckets=(1, 4)) as eng:
        got = eng.predict(X[:11])          # 4 + 4 + pad(3 -> 4)
    np.testing.assert_array_equal(got, jax_predict(jb, X[:11]))
    rep = eng.metrics.report()
    assert rep["batches"] == 1 and eng.forwards == 3
    assert rep["batch_occupancy"] == pytest.approx(11 / 12)


def test_single_sample_ordering_under_many_submits(chain):
    pb, jb = chain
    want = jax_predict(jb, X[:40])
    with engine(pb, replicas=2, devices=["cpu", "cpu"], max_wait_ms=1.0,
                buckets=(1, 8)) as eng:
        futs = [eng.submit(X[i]) for i in range(40)]
        got = np.array([f.result(timeout=60)[0] for f in futs])
    np.testing.assert_array_equal(got, want)


def test_cancelled_future_does_not_kill_dispatcher(chain):
    pb, jb = chain
    with engine(pb, max_wait_ms=1.0) as eng:
        doomed = eng.submit(X[0])
        doomed.cancel()
        np.testing.assert_array_equal(eng.predict(X[:4]),
                                      jax_predict(jb, X[:4]))


def test_close_resolves_every_inflight_future(chain):
    pb, _ = chain
    eng = engine(pb, replicas=2, devices=["cpu", "cpu"], buckets=(1, 8),
                 max_wait_ms=10.0)
    eng.start()
    futs = [eng.submit(X[:3]) for _ in range(30)]
    eng.close()
    assert eng._thread is None
    assert all(ex._thread is None for ex in eng._executors)
    for f in futs:
        assert f.done() and f.result().shape == (3,)
    eng.close()
    with pytest.raises(RuntimeError, match="closed"):
        eng.submit(X[:1])
    never = engine(pb)
    never.close()
    never.close()
    with pytest.raises(RuntimeError, match="closed"):
        never.submit(X[:1])


# ---------------------------------------------------------------------------
# launch counters under threads


def test_launch_counter_loses_no_count_under_threads():
    """Executors launch from several threads; ``build.count_launch``
    adds under a lock, so N threads x M adds give exactly N x M even
    with the interpreter switching threads as often as it can."""
    class Wrapper:
        launches = 0
    old = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        threads = [threading.Thread(target=lambda: [
            build.count_launch(Wrapper) for _ in range(2000)])
            for _ in range(8)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=60)
    finally:
        sys.setswitchinterval(old)
    assert not any(t.is_alive() for t in threads)
    assert Wrapper.launches == 8 * 2000


def test_plain_route_from_threads_counts_nothing_and_stays_exact(chain):
    """Threads calling K1's wrapper on CPU tensors run its plain version,
    which launches nothing: the count does not move, every result is
    right."""
    pb, _ = chain
    pb.prepack()
    conns = [torch.as_tensor(s["conn"]) for s in pb.statics]
    ops = CascadeOperands(conns, [torch.as_tensor(p)
                                  for p in pb.packed_tables],
                          pb.cascade_geom, pb.cfg.in_features)
    codes = torch.randint(0, 2 ** (pb.cfg.beta_in or pb.cfg.beta),
                          (33, pb.cfg.in_features),
                          generator=torch.Generator().manual_seed(0),
                          dtype=torch.int32)
    want = lut_cascade_ref(codes, ops.conns, ops.packed, ops.schedule)
    before, bad = lut_cascade.launches, []

    def work():
        for _ in range(20):
            if not torch.equal(lut_cascade(codes, ops), want):
                bad.append(1)
    threads = [threading.Thread(target=work) for _ in range(6)]
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=60)
    assert not any(t.is_alive() for t in threads)
    assert not bad and lut_cascade.launches == before
