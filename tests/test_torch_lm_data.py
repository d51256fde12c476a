"""The LM data of the port (``repro_torch.data``): ``token_stream`` and
``lm_batch_fn`` equal the reference's arrays exactly, and the prefetching
``ShardedLoader`` keeps the order of the steps, is deterministic, gives
disjoint host slices (as ``tests/test_data.py``), surfaces a producer's
error, races a backup producer and stops its thread on ``close``."""
import threading
import time

import numpy as np
import pytest

from repro.data.pipeline import lm_batch_fn as j_lm_batch_fn
from repro.data.synthetic import token_stream as j_token_stream
from repro_torch.data import ShardedLoader, lm_batch_fn, token_stream


@pytest.mark.parametrize("n,vocab,seed,order", [
    (1000, 64, 0, 2), (4097, 512, 7, 2), (300, 32000, 3, 3), (5, 17, 1, 2)])
def test_token_stream_equals_reference(n, vocab, seed, order):
    a = token_stream(n, vocab, seed=seed, order=order)
    b = j_token_stream(n, vocab, seed=seed, order=order)
    assert a.dtype == b.dtype and np.array_equal(a, b)


@pytest.mark.parametrize("host", [0, 1])
def test_lm_batch_fn_equals_reference(host):
    kw = dict(vocab=512, global_batch=8, seq_len=16, seed=3,
              host_index=host, num_hosts=2)
    ours, theirs = lm_batch_fn(**kw), j_lm_batch_fn(**kw)
    for step in (0, 1, 41):
        a, b = ours(step), theirs(step)
        assert set(a) == set(b) == {"tokens", "labels"}
        for k in a:
            assert a[k].dtype == np.int32 and np.array_equal(a[k], b[k])


def test_sharded_loader_order_and_determinism():
    make = lm_batch_fn(vocab=64, global_batch=4, seq_len=16, seed=7)
    loader = ShardedLoader(make, start_step=0, prefetch=2)
    b0, b1 = next(loader), next(loader)
    assert loader.step == 2
    loader.close()
    np.testing.assert_array_equal(b0["tokens"], make(0)["tokens"])
    np.testing.assert_array_equal(b1["labels"], make(1)["labels"])
    assert b0["tokens"].shape == (4, 16)
    # labels are next-token shifted
    np.testing.assert_array_equal(b0["tokens"][:, 1:], b0["labels"][:, :-1])
    # a loader started at a later step hands that step first
    later = ShardedLoader(make, start_step=5)
    np.testing.assert_array_equal(next(later)["tokens"], make(5)["tokens"])
    later.close()


def test_loader_host_sharding_disjoint():
    m0 = lm_batch_fn(vocab=64, global_batch=8, seq_len=8, seed=1,
                     host_index=0, num_hosts=2)
    m1 = lm_batch_fn(vocab=64, global_batch=8, seq_len=8, seed=1,
                     host_index=1, num_hosts=2)
    b0, b1 = m0(0), m1(0)
    assert b0["tokens"].shape == (4, 8)
    assert not np.array_equal(b0["tokens"], b1["tokens"])


def test_loader_surfaces_errors_and_stops():
    def make(step):
        if step == 2:
            raise ValueError("bad shard")
        return {"x": np.full(3, step)}

    loader = ShardedLoader(make, prefetch=1)
    assert next(loader)["x"][0] == 0 and next(loader)["x"][0] == 1
    with pytest.raises(ValueError, match="bad shard"):
        next(loader)
    loader.close()
    assert not loader._thread.is_alive()


def test_loader_close_stops_a_blocked_producer():
    loader = ShardedLoader(lambda s: {"x": np.full(2, s)}, prefetch=1)
    time.sleep(0.05)   # the worker fills the queue and blocks on put
    loader.close()
    assert not loader._thread.is_alive()


def test_loader_backup_producer_wins_over_a_straggler():
    calls = []
    lock = threading.Lock()

    def make(step):
        with lock:
            calls.append(step)
            first = calls.count(step) == 1
        if first and step == 0:
            time.sleep(1.0)   # the primary straggles on step 0
        return {"x": np.full(2, step)}

    loader = ShardedLoader(make, prefetch=1, backup_after_s=0.05)
    t0 = time.perf_counter()
    assert next(loader)["x"][0] == 0
    assert time.perf_counter() - t0 < 0.9
    assert calls.count(0) >= 2
    loader.close()
