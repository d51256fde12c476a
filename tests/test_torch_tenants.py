"""Port parity: ``MultiTenantEngine``.  The port's cross-tenant forward
(plain PyTorch over stacked per-tenant connectivity and packed tables)
equals the reference's ``make_tenant_forward_fn`` (a one-hot
shift-matmul over stacked shift matrices) bit for bit on the same
tenants, for chain and LUT-graph groups, and packed serving equals
per-tenant serial serving.  Admission (``queue_full`` and
``rate_limited`` shedding), strict priority and the hot-swap state
machine (committed, rolled back, atomic cutover) hold as in
``tests/test_serve_tenants.py`` and ``tests/test_serve_swap.py``."""
import threading

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.serve.tenants import make_tenant_forward_fn as j_tenant_forward
from repro_torch.core.model import node_static_conns
from repro_torch.serve import (MultiTenantEngine, TableRegistry, Tenant,
                               TenantOverloaded, make_tenant_forward_fn)
from repro_torch.serve.tenants import _TokenBucket
from repro_torch.launch.serve import _repacked

from test_torch_registry import (bundles, configs, jax_predict,
                                 port_predict)

torch.set_num_threads(1)

GROUPS = [("neuralut-jsc-2l", "neuralut_jsc_2l"),
          ("neuralut-jsc-5l", "neuralut_jsc_5l"),
          ("polylut-add-jsc-2l", "polylut_add_jsc_2l"),
          ("polylut-add-jsc-5l", "polylut_add_jsc_5l")]
GROUP_IDS = ["jsc-2l", "jsc-5l", "add-2l", "add-5l"]

X = np.random.default_rng(5).normal(0, 1, (48, 16)).astype(np.float32)


def tenant_pairs(arch, mod, seeds=(1, 2, 3)):
    pcfg, jcfg = configs(arch, mod)
    return [bundles(pcfg, jcfg, s) for s in seeds]


def port_operands(pbs):
    for b in pbs:
        b.prepack()
    conns = [[c for s in b.statics for c in node_static_conns(s)]
             for b in pbs]
    return (torch.as_tensor(np.stack([b.in_log_s for b in pbs])),
            [torch.as_tensor(np.stack([np.asarray(c[i], np.int64)
                                       for c in conns]))
             for i in range(len(conns[0]))],
            [torch.as_tensor(np.stack([b.packed_tables[i] for b in pbs]))
             for i in range(len(pbs[0].packed_tables))],
            torch.as_tensor(np.stack([b.layer_log_s[-1] for b in pbs])))


def jax_operands(jbs):
    for b in jbs:
        b.prepack()
    return (jnp.asarray(np.stack([b.in_log_s for b in jbs])),
            [jnp.asarray(np.stack([np.asarray(b.shift_mats[i], np.float32)
                                   for b in jbs]))
             for i in range(len(jbs[0].shift_mats))],
            [jnp.asarray(np.stack([np.asarray(b.packed_tables[i], np.int32)
                                   for b in jbs]))
             for i in range(len(jbs[0].packed_tables))],
            jnp.asarray(np.stack([b.layer_log_s[-1] for b in jbs])))


@pytest.mark.parametrize("arch,mod", GROUPS, ids=GROUP_IDS)
def test_cross_tenant_forward_equals_jax(arch, mod):
    """The same three tenants, the same rows, the same per-row tenant
    ids: the port's forward and the reference's give identical
    predictions, and each row equals its tenant served alone."""
    pairs = tenant_pairs(arch, mod)
    pbs, jbs = [p for p, _ in pairs], [j for _, j in pairs]
    tid = np.random.default_rng(9).integers(0, 3, len(X))
    got = make_tenant_forward_fn(pbs[0].cfg)(
        torch.as_tensor(X), torch.as_tensor(tid), *port_operands(pbs))
    want = np.asarray(j_tenant_forward(jbs[0].cfg)(
        jnp.asarray(X), jnp.asarray(tid.astype(np.int32)),
        *jax_operands(jbs)))
    assert got.dtype == torch.int32
    np.testing.assert_array_equal(got.numpy(), want)
    for t, jb in enumerate(jbs):
        sel = tid == t
        np.testing.assert_array_equal(got.numpy()[sel],
                                      jax_predict(jb, X[sel]))


@pytest.mark.parametrize("arch,mod", GROUPS[::2], ids=GROUP_IDS[::2])
def test_packed_serving_equals_per_tenant_serial(arch, mod):
    """Two tenants' rows ride one coalesced dispatch and reproduce each
    tenant's own predict; one forward serves the whole group."""
    (pa, ja), (pb, jb) = tenant_pairs(arch, mod, seeds=(4, 5))
    with MultiTenantEngine([Tenant("a", pa), Tenant("b", pb)],
                           buckets=(32,), max_wait_ms=20.0,
                           device="cpu") as eng:
        assert eng.num_groups == 1
        fa, fb = eng.submit("a", X[:11]), eng.submit("b", X[11:16])
        got_a, got_b = fa.result(timeout=60), fb.result(timeout=60)
        group = eng.group_of("a")
        assert group is eng.group_of("b")
        assert eng.forwards == 1         # one padded forward, both tenants
    np.testing.assert_array_equal(got_a, jax_predict(ja, X[:11]))
    np.testing.assert_array_equal(got_b, jax_predict(jb, X[11:16]))


def test_different_geometries_get_separate_groups():
    (pa, _), = tenant_pairs(*GROUPS[0], seeds=(1,))
    (pg, jg), = tenant_pairs(*GROUPS[2], seeds=(2,))
    with MultiTenantEngine([Tenant("a", pa), Tenant("g", pg)],
                           device="cpu") as eng:
        assert eng.num_groups == 2
        np.testing.assert_array_equal(eng.predict("g", X[:9]),
                                      jax_predict(jg, X[:9]))
    assert sorted(eng.tenant_names) == ["a", "g"]


def test_duplicate_and_unknown_tenants_rejected():
    (pa, _), = tenant_pairs(*GROUPS[0], seeds=(1,))
    with pytest.raises(ValueError, match="duplicate"):
        MultiTenantEngine([Tenant("a", pa), Tenant("a", pa)], device="cpu")
    eng = MultiTenantEngine([Tenant("a", pa)], device="cpu")
    with pytest.raises(ValueError, match="unknown tenant"):
        eng.submit("zz", X[:1])
    with pytest.raises(ValueError, match="request shape"):
        eng.submit("a", np.zeros((2, 17), np.float32))
    eng.close()
    with pytest.raises(ValueError):
        MultiTenantEngine([], device="cpu")


def test_queue_bound_sheds_only_the_offender():
    (pa, _), (pb, _) = tenant_pairs(*GROUPS[0], seeds=(1, 2))
    eng = MultiTenantEngine([Tenant("bulk", pa, max_queue_depth=2),
                             Tenant("prime", pb, max_queue_depth=64)],
                            device="cpu")
    admitted, shed = [], 0
    for _ in range(8):
        try:
            admitted.append(eng.submit("bulk", X[:1]))
        except TenantOverloaded as e:
            assert e.tenant == "bulk" and e.reason == "queue_full"
            shed += 1
    prime = [eng.submit("prime", X[:1]) for _ in range(5)]
    assert shed == 6 and len(admitted) == 2
    bm, pm = eng.tenant_metrics("bulk"), eng.tenant_metrics("prime")
    assert bm.shed == 6 and bm.shed_rate == pytest.approx(6 / 8)
    assert pm.shed == 0 and eng.metrics.shed == 6
    with eng:
        for f in admitted + prime:
            assert f.result(timeout=30).shape == (1,)


def test_rate_limit_sheds():
    (pa, _), = tenant_pairs(*GROUPS[0], seeds=(1,))
    eng = MultiTenantEngine([Tenant("a", pa, rate_limit=1.0, burst=2)],
                            device="cpu")
    outcomes = []
    for _ in range(5):
        try:
            eng.submit("a", X[:1])
            outcomes.append("ok")
        except TenantOverloaded as e:
            assert e.reason == "rate_limited"
            outcomes.append("shed")
    assert outcomes == ["ok", "ok", "shed", "shed", "shed"]
    assert eng.tenant_metrics("a").shed == 3
    eng.close()


def test_token_bucket_refill_math():
    b = _TokenBucket(rate=2.0, burst=2)
    t0 = b.t_last
    assert b.try_take(t0) and b.try_take(t0)
    assert not b.try_take(t0)
    assert b.try_take(t0 + 0.5)
    assert not b.try_take(t0 + 0.5)
    assert b.try_take(t0 + 10.0) and b.try_take(t0 + 10.0)
    assert not b.try_take(t0 + 10.0)
    with pytest.raises(ValueError):
        _TokenBucket(rate=0.0, burst=1)


def test_priority_strictly_ordered_under_saturation():
    """Queued before start(): the dispatcher drains strictly by
    priority, one request per dispatch."""
    (pa, _), (pb, _) = tenant_pairs(*GROUPS[0], seeds=(1, 2))
    eng = MultiTenantEngine([Tenant("lo", pa, priority=0),
                             Tenant("hi", pb, priority=5)],
                            buckets=(4,), device="cpu")
    order, lock, done = [], threading.Lock(), threading.Event()

    def track(name, fut):
        def cb(f):
            f.result()
            with lock:
                order.append(name)
                if len(order) == 10:
                    done.set()
        fut.add_done_callback(cb)

    for _ in range(5):
        track("lo", eng.submit("lo", X[:4]))
    for _ in range(5):
        track("hi", eng.submit("hi", X[:4]))
    with eng:
        assert done.wait(timeout=60)
    assert order == ["hi"] * 5 + ["lo"] * 5


def test_close_serves_backlog_and_fails_unstarted():
    (pa, _), (pb, _) = tenant_pairs(*GROUPS[0], seeds=(1, 2))
    eng = MultiTenantEngine([Tenant("a", pa), Tenant("b", pb)],
                            device="cpu")
    futs = [eng.submit("a" if i % 2 else "b", X[i:i + 3]) for i in range(6)]
    eng.start()
    eng.close()
    for f in futs:
        assert f.result(timeout=5).shape == (3,)
    eng.close()
    with pytest.raises(RuntimeError, match="closed"):
        eng.submit("a", X[:1])
    never = MultiTenantEngine([Tenant("a", pa)], device="cpu")
    f = never.submit("a", X[:1])
    never.close()
    with pytest.raises(RuntimeError, match="closed"):
        f.result(timeout=5)


# ---------------------------------------------------------------------------
# hot swap


class _Traffic:
    """A client hammering one tenant with a fixed probe batch (what the
    shadow phase mirrors)."""

    def __init__(self, eng, tenant, x):
        self.results, self.errors = [], []
        self._stop = threading.Event()

        def loop():
            while not self._stop.is_set():
                try:
                    self.results.append(
                        eng.submit(tenant, x).result(timeout=30))
                except Exception as e:
                    self.errors.append(e)
                    return
        self._thread = threading.Thread(target=loop, daemon=True)

    def __enter__(self):
        self._thread.start()
        return self

    def __exit__(self, *exc):
        self._stop.set()
        self._thread.join(timeout=60)
        assert not self._thread.is_alive()


def _doctored(src, x):
    """A copy whose last table forces one class the incumbent does not
    always predict: shadow mismatches on any probe set."""
    bad = _repacked(src)
    k = (int(port_predict(src, x[:1])[0]) + 1) % src.cfg.num_classes
    last = bad.tables[-1]
    last = last[0] if isinstance(last, list) else last
    last[:, :] = 0
    last[k, :] = 2 ** src.cfg.beta - 1
    return bad


@pytest.mark.parametrize("arch,mod", GROUPS[::2], ids=GROUP_IDS[::2])
def test_clean_swap_commits_with_zero_mismatches(arch, mod):
    (inc, jinc), = tenant_pairs(arch, mod, seeds=(1,))
    with MultiTenantEngine([Tenant("a", inc)], max_wait_ms=0.5,
                           device="cpu") as eng:
        with _Traffic(eng, "a", X[:8]) as traffic:
            rep = eng.swap("a", _repacked(inc), shadow_samples=16,
                           timeout_s=60.0)
        assert rep.status == "committed" and rep.mismatches == 0
        assert rep.states == ("validate", "shadow", "cutover", "committed")
        assert rep.shadow_samples >= 16 and rep.canary[0]["healthy"]
        assert not traffic.errors
        np.testing.assert_array_equal(eng.predict("a", X[:8]),
                                      jax_predict(jinc, X[:8]))


@pytest.mark.parametrize("arch,mod", GROUPS[::2], ids=GROUP_IDS[::2])
def test_doctored_candidate_rolls_back(arch, mod):
    (inc, jinc), = tenant_pairs(arch, mod, seeds=(1,))
    bad = _doctored(inc, X)
    with MultiTenantEngine([Tenant("a", inc)], max_wait_ms=0.5,
                           device="cpu") as eng:
        with _Traffic(eng, "a", X[:8]):
            rep = eng.swap("a", bad, shadow_samples=16, timeout_s=60.0)
        assert rep.status == "rolled_back" and rep.mismatches > 0
        assert rep.states[-1] == "rolled_back"
        assert rep.canary[0]["healthy"] is False and "mismatch" in rep.error
        np.testing.assert_array_equal(eng.predict("a", X[:8]),
                                      jax_predict(jinc, X[:8]))


def test_failing_candidate_forward_rolls_back():
    """A candidate whose operands cannot even build its forward trips
    the canary on the first mirrored batch and rolls back."""
    (inc, jinc), = tenant_pairs(*GROUPS[0], seeds=(1,))
    bad = _repacked(inc).prepack()
    bad.packed_tables = [np.zeros((2, 2), np.int32)
                         for _ in bad.packed_tables]  # key still matches
    with MultiTenantEngine([Tenant("a", inc)], max_wait_ms=0.5,
                           device="cpu") as eng:
        with _Traffic(eng, "a", X[:4]):
            rep = eng.swap("a", bad, shadow_samples=8, timeout_s=60.0)
        assert rep.status == "rolled_back"
        assert rep.canary[0]["healthy"] is False
        np.testing.assert_array_equal(eng.predict("a", X[:4]),
                                      jax_predict(jinc, X[:4]))


def test_cutover_is_atomic_no_torn_responses():
    (old, jold), (new, jnew) = tenant_pairs(*GROUPS[0], seeds=(1, 9))
    x = X[:16]
    ref_old, ref_new = jax_predict(jold, x), jax_predict(jnew, x)
    assert not np.array_equal(ref_old, ref_new)
    with MultiTenantEngine([Tenant("a", old)], max_wait_ms=0.2,
                           device="cpu") as eng:
        with _Traffic(eng, "a", x) as traffic:
            for _ in range(3):
                assert eng.swap("a", new, shadow_samples=0
                                ).status == "committed"
                assert eng.swap("a", old, shadow_samples=0
                                ).status == "committed"
        assert traffic.results and not traffic.errors
        for got in traffic.results:
            assert (np.array_equal(got, ref_old)
                    or np.array_equal(got, ref_new)), "torn response"
        assert eng.group_of("a").version == 7


def test_geometry_mismatch_refused_and_shadow_timeout():
    (inc, _), = tenant_pairs(*GROUPS[0], seeds=(1,))
    (other, _), = tenant_pairs(*GROUPS[1], seeds=(2,))
    with MultiTenantEngine([Tenant("a", inc)], device="cpu") as eng:
        with pytest.raises(ValueError, match="geometry"):
            eng.swap("a", other)
        rep = eng.swap("a", _repacked(inc), shadow_samples=4,
                       timeout_s=0.3)
    assert rep.status == "timeout" and rep.shadow_samples == 0
    assert "0/4" in rep.error and rep.states[-1] == "rolled_back"


def test_registry_versions_feed_the_swap_path(tmp_path):
    (v0, jv0), = tenant_pairs(*GROUPS[2], seeds=(1,))
    reg = TableRegistry(tmp_path)
    reg.save("m", v0, version=0)
    reg.save("m", _repacked(v0), version=1)
    assert reg.versions("m") == [0, 1]
    inc, cand = reg.load("m", version=0), reg.load("m", version=1)
    with MultiTenantEngine([Tenant("m", inc)], max_wait_ms=0.5,
                           device="cpu") as eng:
        with _Traffic(eng, "m", X[:8]):
            rep = eng.swap("m", cand, shadow_samples=8, timeout_s=60.0)
        np.testing.assert_array_equal(eng.predict("m", X[:8]),
                                      jax_predict(jv0, X[:8]))
    assert rep.status == "committed" and rep.mismatches == 0


def test_concurrent_swap_on_same_lane_refused():
    (inc, _), = tenant_pairs(*GROUPS[0], seeds=(1,))
    with MultiTenantEngine([Tenant("a", inc)], device="cpu") as eng:
        reports, errors = [], []
        started = threading.Barrier(2)

        def swapper():
            started.wait(timeout=30)
            try:
                reports.append(eng.swap("a", _repacked(inc),
                                        shadow_samples=4, timeout_s=1.0))
            except RuntimeError as e:
                errors.append(e)

        threads = [threading.Thread(target=swapper) for _ in range(2)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=60)
    assert len(errors) == 1 and "already in flight" in str(errors[0])
    assert len(reports) == 1 and reports[0].status == "timeout"


def test_tenants_inherit_redispatch_and_deadlines():
    from repro_torch.runtime import ChaosHarness
    from repro_torch.serve import DeadlineExceeded
    (pa, ja), (pb, _) = tenant_pairs(*GROUPS[0], seeds=(1, 2))
    chaos = ChaosHarness(schedule={"serve.replica": [0]})
    with MultiTenantEngine([Tenant("a", pa), Tenant("b", pb)], replicas=2,
                           chaos=chaos, device="cpu") as eng:
        np.testing.assert_array_equal(eng.predict("a", X[:4]),
                                      jax_predict(ja, X[:4]))
        fut = eng.submit("b", X[:4], timeout_s=1e-9)
        with pytest.raises(DeadlineExceeded):
            fut.result(timeout=30)
    assert eng.metrics.redispatches == 1
    assert eng.metrics.deadline_exceeded == 1
    assert eng.tenant_metrics("b").deadline_exceeded == 1


@pytest.mark.parametrize("retries", [0, 1])
def test_tenant_dispatch_failed_after_retry_budget(retries):
    """A group's replica failures go through the single-bundle
    executor's fail-or-redispatch path: the budget spent, every tenant's
    futures in the dispatch get DispatchFailed chaining the cause, and
    the group serves again once the injections stop."""
    from repro_torch.runtime import ChaosHarness, ChaosInjected
    from repro_torch.serve import DispatchFailed
    (pa, ja), (pb, jb) = tenant_pairs(*GROUPS[0], seeds=(1, 2))
    chaos = ChaosHarness(schedule={"serve.replica": range(retries + 1)})
    with MultiTenantEngine([Tenant("a", pa), Tenant("b", pb)], replicas=1,
                           max_dispatch_retries=retries, chaos=chaos,
                           device="cpu") as eng:
        with pytest.raises(DispatchFailed) as ei:
            eng.predict("a", X[:4])
        assert ei.value.attempts == retries + 1
        assert isinstance(ei.value.cause, ChaosInjected)
        np.testing.assert_array_equal(eng.predict("b", X[:4]),
                                      jax_predict(jb, X[:4]))
    assert eng.metrics.redispatches == retries
    assert eng.tenant_metrics("b").report()["requests"] == 1
    assert eng.tenant_metrics("a").report()["requests"] == 0
