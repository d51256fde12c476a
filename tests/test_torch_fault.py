"""The port's TrainSupervisor (``repro_torch.runtime.fault``), as
``tests/test_fault.py`` holds the reference's: a restart from the latest
checkpoint that finishes, a resume equal to an uninterrupted run bit
for bit, and giving up after ``max_restarts``; then the same resume on
the LM step (reduced lm-100m in bfloat16, with its float32 master)."""
import numpy as np
import pytest
import torch

from repro_torch.checkpoint import CheckpointStore
from repro_torch.config import TrainConfig, get_config
from repro_torch.data import lm_batch_fn
from repro_torch.models import api
from repro_torch.optim import adamw_init
from repro_torch.runtime.fault import (FailureInjector, NodeFailure,
                                       TrainSupervisor)
from repro_torch.train.step import make_train_step
from repro_torch.tree import tree_leaves

torch.set_num_threads(1)


def _toy_problem():
    """Quadratic fit; step = one SGD update. Deterministic in the step
    index."""

    def make_batch(step):
        rng = np.random.default_rng(step)
        return torch.as_tensor(rng.normal(0, 1, (8, 4)), dtype=torch.float32)

    def step_fn(w, x):
        w = w.detach().requires_grad_(True)
        loss = torch.mean((x @ w) ** 2) + 0.01 * torch.sum(w ** 2)
        (g,) = torch.autograd.grad(loss, [w])
        w = (w - 0.05 * g).detach()
        return w, {"loss": torch.mean((x @ w) ** 2)
                   + 0.01 * torch.sum(w ** 2)}

    return make_batch, step_fn


def test_supervisor_restarts_and_finishes(tmp_path):
    make_batch, step_fn = _toy_problem()
    store = CheckpointStore(str(tmp_path), keep=2)
    restarts = []
    sup = TrainSupervisor(store=store, make_step=lambda: step_fn,
                          make_batch=make_batch, ckpt_every=5)
    out = sup.run(torch.ones(4), num_steps=20,
                  injector=FailureInjector(fail_at=(7, 13)),
                  on_restart=restarts.append)
    assert out["step"] == 20
    assert out["restarts"] == 2
    assert restarts == [5, 10]  # resumed from the latest checkpoints
    assert out["carry"].shape == (4,)  # a tensor, as the carry was


def test_resume_bitwise_deterministic(tmp_path):
    """train(20) == train(10) + resume(10..20): the batches are a
    function of the step and the checkpoint captures the carry."""
    make_batch, step_fn = _toy_problem()
    w = torch.ones(4)
    for s in range(20):
        w, _ = step_fn(w, make_batch(s))
    store = CheckpointStore(str(tmp_path))
    sup = TrainSupervisor(store=store, make_step=lambda: step_fn,
                          make_batch=make_batch, ckpt_every=10)
    out = sup.run(torch.ones(4), num_steps=10)
    # "process restart": a new supervisor restores from disk
    sup2 = TrainSupervisor(store=store, make_step=lambda: step_fn,
                           make_batch=make_batch, ckpt_every=10)
    start, carry = store.restore(out["carry"], device="cpu")
    assert start == 10
    out2 = sup2.run(carry, start_step=start, num_steps=20)
    assert torch.equal(out2["carry"], w)


def test_supervisor_gives_up_after_max_restarts(tmp_path):
    make_batch, step_fn = _toy_problem()
    sup = TrainSupervisor(store=CheckpointStore(str(tmp_path)),
                          make_step=lambda: step_fn, make_batch=make_batch,
                          ckpt_every=100, max_restarts=2)

    class AlwaysFail(FailureInjector):
        def check(self, step):
            if step == 1:
                raise NodeFailure("always")

    with pytest.raises(NodeFailure):
        sup.run(torch.ones(4), num_steps=5, injector=AlwaysFail())


def test_lm_resume_after_failure_is_bitwise(tmp_path):
    """The LM step under the supervisor, a failure at step 5 of 8 and a
    checkpoint every 2 steps (params bfloat16, master, moments and the
    count float32 / int32 on disk), equals 8 steps uninterrupted bit
    for bit: the step writes nothing into the carry it is given."""
    cfg = get_config("lm-100m", reduced=True)
    assert cfg.dtype == "bfloat16"
    params = api.init_params(cfg, torch.Generator().manual_seed(0))
    raw = make_train_step(cfg, TrainConfig(lr=3e-3, sgdr_t0=4), q_chunk=32)
    make_np = lm_batch_fn(cfg.vocab_size, 2, 32, seed=0)

    def make_batch(s):
        return {k: torch.as_tensor(v) for k, v in make_np(s).items()}

    def make_step():
        def step(carry, batch):
            p, o, m = raw(carry[0], carry[1], batch)
            return (p, o), m
        return step

    ref, step = (params, adamw_init(params)), make_step()
    for s in range(8):
        ref, _ = step(ref, make_batch(s))
    sup = TrainSupervisor(store=CheckpointStore(str(tmp_path), keep=2),
                          make_step=make_step, make_batch=make_batch,
                          ckpt_every=2)
    restarts = []
    out = sup.run((params, adamw_init(params)), num_steps=8,
                  injector=FailureInjector(fail_at=(5,)),
                  on_restart=restarts.append)
    assert out["restarts"] == 1 and restarts == [4]
    got, want = tree_leaves(out["carry"]), tree_leaves(ref)
    assert len(got) == len(want)
    for a, b in zip(got, want):
        assert a.dtype == b.dtype and a.shape == b.shape
        assert torch.equal(a, b)
    assert out["carry"][1]["master"]["embed"].dtype == torch.float32
    assert out["carry"][0]["embed"].dtype == torch.bfloat16


def test_checkpoint_keeps_a_scalar_leaf_0d(tmp_path):
    """A 0-d tensor (the optimizer's count) comes back 0-d."""
    store = CheckpointStore(str(tmp_path))
    tree = {"count": torch.tensor(7, dtype=torch.int32),
            "w": torch.ones(3, dtype=torch.bfloat16)}
    store.save(1, tree)
    _, back = store.restore(tree, device="cpu")
    assert back["count"].shape == () and int(back["count"]) == 7
    assert back["count"].dtype == torch.int32
    assert torch.equal(back["w"], tree["w"])
