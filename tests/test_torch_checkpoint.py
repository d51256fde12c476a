"""Port parity: ``repro_torch.checkpoint.CheckpointStore`` writes the
reference's layout (``step_<n>/{manifest.json, shard_0.npz}``, npz keys
by tree path) so either package restores what the other saved; plus the
store's own guarantees, as ``tests/test_checkpoint.py`` holds the
reference to them: keep-last-k, uncommitted steps ignored, async save,
a save after a partial write, corrupt steps skipped with a warning."""
import json
import warnings

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.checkpoint import CheckpointStore as JStore
from repro.checkpoint.store import _flatten as j_flatten
from repro_torch.checkpoint import CheckpointStore
from repro_torch.checkpoint.store import _flatten, _treedef

torch.set_num_threads(1)


def _tree(seed=0):
    rng = np.random.default_rng(seed)
    return {
        "params": {"w": rng.normal(0, 1, (4, 4)).astype(np.float32),
                   "blocks": [{"a": np.arange(3, dtype=np.int32)},
                              {"a": np.arange(3, dtype=np.int32) + 1}]},
        "opt": {"count": np.int32(7)},
        "none": None,
        "pair": (np.float32(1.5), np.zeros(2, np.uint16)),
    }


def _leaves(tree):
    return [np.asarray(x) for x in jax.tree.leaves(tree)]


def _equal(a, b):
    la, lb = _leaves(a), _leaves(b)
    assert len(la) == len(lb)
    for x, y in zip(la, lb):
        assert x.dtype == y.dtype and np.array_equal(x, y)


@pytest.mark.parametrize("seed", [0, 1])
def test_flatten_keys_and_structure_equal_the_reference(seed):
    t = _tree(seed)
    flat, dtypes = _flatten(t)
    jflat, jdtypes = j_flatten(t)
    assert list(flat) == list(jflat) and dtypes == jdtypes == {}
    assert "params/blocks/#1/a" in flat and "pair/#0" in flat
    for k in flat:
        assert np.array_equal(flat[k], jflat[k])
    assert _treedef(t) == str(jax.tree_util.tree_structure(t))


@pytest.mark.parametrize("writer,reader", [("port", "jax"), ("jax", "port"),
                                           ("port", "port")])
def test_save_and_restore_across_packages(tmp_path, writer, reader):
    t = _tree(3)
    (CheckpointStore if writer == "port" else JStore)(str(tmp_path)).save(
        10, t, meta={"fingerprint": "abc"})
    store = (CheckpointStore if reader == "port" else JStore)(str(tmp_path))
    step, got = store.restore(t)
    assert step == 10 and store.meta(10) == {"fingerprint": "abc"}
    _equal(t, got)


def test_manifests_of_both_packages_match(tmp_path):
    t = _tree(4)
    CheckpointStore(str(tmp_path / "p")).save(2, t, meta={"n": 1})
    JStore(str(tmp_path / "j")).save(2, t, meta={"n": 1})
    mp, mj = (json.loads((tmp_path / d / "step_0000000002" /
                          "manifest.json").read_text()) for d in "pj")
    assert mp == mj


def test_restore_returns_tensors_on_a_named_device(tmp_path):
    t = _tree(5)
    store = CheckpointStore(str(tmp_path))
    store.save(1, {"x": torch.arange(4.0), "y": [torch.ones(2, 2)]})
    _, got = store.restore({"x": 0, "y": [0]}, device="cpu")
    assert isinstance(got["x"], torch.Tensor)
    assert torch.equal(got["x"], torch.arange(4.0))
    _, np_got = store.restore({"x": 0, "y": [0]})
    assert isinstance(np_got["y"][0], np.ndarray)
    del t


def test_bfloat16_tensors_round_trip_through_the_reference(tmp_path):
    """A dtype numpy lacks is stored as a uint view with its name, as
    the reference stores ml_dtypes leaves."""
    x = torch.tensor([1.5, -2.0, 3.25], dtype=torch.bfloat16)
    CheckpointStore(str(tmp_path)).save(1, {"x": x})
    _, got = JStore(str(tmp_path)).restore({"x": jnp.zeros(3, jnp.bfloat16)})
    assert got["x"].dtype == jnp.bfloat16
    np.testing.assert_array_equal(np.asarray(got["x"], np.float32),
                                  x.float().numpy())
    _, back = CheckpointStore(str(tmp_path)).restore({"x": 0}, device="cpu")
    assert back["x"].dtype == torch.bfloat16 and torch.equal(back["x"], x)


@pytest.mark.parametrize("keep,steps,want", [(2, (1, 2, 3, 4), [3, 4]),
                                             (1, (5, 6), [6]),
                                             (0, (1, 2, 3), [1, 2, 3])])
def test_latest_and_keep_k(tmp_path, keep, steps, want):
    store = CheckpointStore(str(tmp_path), keep=keep)
    for s in steps:
        store.save(s, _tree())
    assert store.list_steps() == want
    assert store.latest_step() == want[-1]
    assert JStore(str(tmp_path)).list_steps() == want


def test_uncommitted_ignored(tmp_path):
    store = CheckpointStore(str(tmp_path))
    t = _tree()
    store.save(5, t)
    (tmp_path / "step_0000000009").mkdir()           # no manifest
    bad = tmp_path / "step_0000000011"
    bad.mkdir()
    (bad / "manifest.json").write_text(json.dumps({"committed": False}))
    assert store.latest_step() == 5
    assert store.restore(t)[0] == 5


def test_async_save(tmp_path):
    store = CheckpointStore(str(tmp_path))
    t = _tree(6)
    snapshot = {"w": t["params"]["w"]}
    fut = store.save_async(42, snapshot)
    t["params"]["w"][:] = 0        # the snapshot was taken at submit
    path = fut.result(timeout=30)
    assert path.name == "step_0000000042"
    _, got = store.restore({"w": 0})
    assert np.array_equal(got["w"], _tree(6)["params"]["w"])


def test_save_after_a_partial_write(tmp_path):
    """A crash mid-write leaves a temporary directory and a step
    directory without a manifest; the next save commits cleanly, the
    leftovers are never listed, and the temporary one is removed."""
    store = CheckpointStore(str(tmp_path))
    stale = tmp_path / ".tmp-999-3"
    stale.mkdir()
    (stale / "shard_0.npz").write_bytes(b"half a file")
    (tmp_path / "step_0000000003").mkdir()
    store.save(3, _tree(7))
    assert store.list_steps() == [3] and not stale.exists()
    _equal(_tree(7), store.restore(_tree())[1])
    assert JStore(str(tmp_path)).restore(_tree())[0] == 3


def test_restore_skips_truncated_checkpoint_with_warning(tmp_path):
    store = CheckpointStore(str(tmp_path), keep=0)
    store.save(1, _tree())
    store.save(2, _tree(seed=2))
    shard = tmp_path / "step_0000000002" / "shard_0.npz"
    shard.write_bytes(shard.read_bytes()[: shard.stat().st_size // 2])
    assert store.list_steps() == [1, 2]
    with warnings.catch_warnings(record=True) as caught:
        warnings.simplefilter("always")
        step, restored = store.restore(_tree())
    assert step == 1
    _equal(_tree(), restored)
    assert any(issubclass(w.category, RuntimeWarning) for w in caught)
    with pytest.raises(Exception):
        store.restore(_tree(), step=2)


def test_restore_corrupted_member_falls_back(tmp_path):
    store = CheckpointStore(str(tmp_path), keep=0)
    store.save(1, _tree())
    store.save(2, _tree(seed=3))
    shard = tmp_path / "step_0000000002" / "shard_0.npz"
    raw = bytearray(shard.read_bytes())
    mid = len(raw) // 2
    for i in range(mid, min(mid + 32, len(raw))):
        raw[i] ^= 0xFF
    shard.write_bytes(bytes(raw))
    with warnings.catch_warnings(record=True) as caught:
        warnings.simplefilter("always")
        step, _ = store.restore(_tree())
    assert step == 1
    assert any(issubclass(w.category, RuntimeWarning) for w in caught)


def test_no_checkpoint_raises(tmp_path):
    with pytest.raises(FileNotFoundError):
        CheckpointStore(str(tmp_path)).restore(_tree())
