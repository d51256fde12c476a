"""The LM training path over a mesh of gloo processes on the CPU equals
one process at the same global batch (``repro_torch.launch.train``
through ``sharding.spmd``'s ZeRO-3 step).

The one-process reference is ``train.step.make_train_step`` on the same
seeded init and ``lm_batch_fn`` batches (the launcher at one process
equals it bit for bit).  Runs of ``launch.train`` over 2 processes at
``--mesh-shape 2x1`` and ``1x2`` and over 4 at ``2x2``, float32, 3
steps at ``--lr 3e-3``, are held at ``tests/test_torch_lm_train.py``'s
STEP limits: the loss to rtol 1e-5; params and AdamW moments to atol
1e-5 + rtol 1e-5 where the one-process gradient at each step so far is
at least 1e-5 of its leaf's largest element, the params within the
steps' reach (2 lr per step) elsewhere (Adam's update takes the size of
the gradient away, so rounding moves an element of cancelling gradient
by up to lr).  Cases: reduced ``llama3-8b`` (dense; also ``--mesh
host`` with no shape over 4 processes, the reference's (2, 2));
reduced ``qwen2-moe-a2.7b`` (the aux loss's global statistics; also at
``2x2x1``, pod x data x model, whose data axes are two); ``--grad-accum
2``; ``--compress-grads``, where one ulp of difference in an averaged
gradient can flip an int8 code, moving that element by one quantum q
(its leaf's max / 127): the first step's compressed gradient is held to
one quantum of the one process's; at a later step the error-feedback
residual carries the previous step's flips (each residual lies within
q / 2 of zero, so two runs' residuals differ by at most q_prev), so
step s is held to q_s + q_(s-1) + the difference of the averaged
gradients; the number of flipped codes is reported, and the elements of
a flipped code are held within reach.

Resume onto another mesh: a checkpoint saved at 2x1 restores at 1x2 and
at one process bit-identical to the saved arrays, and the next step's
loss equals an uninterrupted run's (rtol 1e-5).  ``TrainSupervisor``
over 2 ranks: a failure injected on one rank restarts both from the
checkpoint, ending where an uninterrupted run ends, bit for bit; a rank
whose step raises exits non-zero and the run ends (no hang).
"""
import dataclasses
import json
import os
import shutil
import time

import numpy as np
import pytest
import torch

torch.set_num_threads(1)

TIMEOUT_S = 240
LR = 3e-3
STEPS = 3
B, S = 4, 32
STEP = dict(rtol=1e-5, atol=1e-5)
GRAD_T = 1e-5
DENSE, MOE = "llama3-8b", "qwen2-moe-a2.7b"


def _argv(arch, shape=None, *extra):
    out = ["--arch", arch, "--reduced", "--device", "cpu", "--steps",
           str(STEPS), "--lr", str(LR), "--global-batch", str(B),
           "--seq-len", str(S), "--log-every", "0"]
    return out + (["--mesh-shape", shape] if shape else []) + list(extra)


def _launch(argv, dtype="float32"):
    """launch.train's LM branch on the command line ``argv``, the arch's
    reduced config in ``dtype`` (float32: the step tests' arithmetic;
    bfloat16: the configs' own)."""
    from repro_torch.config import get_config
    from repro_torch.launch import train as launch_train
    args = launch_train.parse_args(argv)
    cfg = get_config(args.arch, reduced=args.reduced)
    return launch_train.train_lm_arch(
        args, dataclasses.replace(cfg, dtype=dtype))


CASES = {   # name: (world, arch, mesh shape, extra flags, dtype)
    "dense_2x1": (2, DENSE, "2x1", (), "float32"),
    "dense_1x2": (2, DENSE, "1x2", (), "float32"),
    "moe_2x1": (2, MOE, "2x1", (), "float32"),
    "accum_2x1": (2, DENSE, "2x1", ("--grad-accum", "2"), "float32"),
    "compress_2x1": (2, DENSE, "2x1", ("--compress-grads",), "float32"),
    "bf16_2x1": (2, DENSE, "2x1", (), "bfloat16"),
    "bf16_1x2": (2, DENSE, "1x2", (), "bfloat16"),
    "dense_2x2": (4, DENSE, "2x2", (), "float32"),
    "pod_2x2x1": (4, MOE, "2x2x1", (), "float32"),
    "host_default": (4, DENSE, None, (), "float32"),
}


def _spawn(fn, world, tmp_path):
    """Run ``fn(rank, world, init_method, out_dir)`` in ``world``
    processes; a failure raises, the timeout fails the test."""
    import torch.multiprocessing as mp
    pctx = mp.start_processes(
        fn, args=(world, f"file://{tmp_path}/rdzv", str(tmp_path)),
        nprocs=world, join=False, start_method="spawn")
    deadline = time.time() + TIMEOUT_S
    while not pctx.join(timeout=max(1.0, deadline - time.time())):
        if time.time() > deadline:
            for p in pctx.processes:
                p.kill()
            pytest.fail(f"{world} ranks did not finish in {TIMEOUT_S} s")


class _Recorder:
    """A ``make_ef_int8_compressor`` that records the gradient it gets
    and the one it hands on, step by step."""

    def __init__(self, real):
        self.real, self.seen, self.sent = real, [], []

    def __call__(self):
        init, compress = self.real()

        def rec(grads, ef):
            from repro_torch.tree import tree_leaves
            g2, ef2 = compress(grads, ef)
            self.seen.append([g.clone() for g in tree_leaves(grads)])
            self.sent.append([g.clone() for g in tree_leaves(g2)])
            return g2, ef2
        return init, rec


def _save(path, whole, losses, rec=None):
    from repro_torch.tree import tree_leaves
    params, opt = whole
    arrays = {f"p/{i}": t.float().numpy()
              for i, t in enumerate(tree_leaves(params))}
    for k in ("m", "v"):
        arrays.update({f"{k}/{i}": t.numpy()
                       for i, t in enumerate(tree_leaves(opt[k]))})
    arrays["losses"] = np.asarray(losses, np.float64)
    if rec is not None:
        for s, (seen, sent) in enumerate(zip(rec.seen, rec.sent)):
            arrays.update({f"seen/{s}/{i}": g.numpy()
                           for i, g in enumerate(seen)})
            arrays.update({f"sent/{s}/{i}": g.numpy()
                           for i, g in enumerate(sent)})
    np.savez(path, **arrays)


def _run_case(out_dir, name, argv, rank, compress, dtype="float32"):
    import repro_torch.optim as optim
    from repro_torch.sharding.spmd import gather_tree
    rec = _Recorder(optim.make_ef_int8_compressor) if compress else None
    if rec is not None:
        optim.make_ef_int8_compressor = rec
    try:
        out = _launch(argv, dtype)
    finally:
        if rec is not None:
            optim.make_ef_int8_compressor = rec.real
    whole = gather_tree(out["carry"], out["shardings"])
    if rank == 0:
        _save(os.path.join(out_dir, f"{name}.npz"), whole, out["losses"],
              rec)
    return out


def _worker(rank, world, init, out_dir):
    import torch.distributed as dist
    torch.set_num_threads(1)
    dist.init_process_group("gloo", init_method=init, world_size=world,
                            rank=rank)
    info = {}
    try:
        for name, (w, arch, shape, extra, dtype) in CASES.items():
            if w == world:
                out = _run_case(out_dir, name, _argv(arch, shape, *extra),
                                rank, "--compress-grads" in extra, dtype)
                info[name] = dict(out["rank"], mesh=out["mesh"])
        if world == 2:
            _resume_and_supervise(rank, out_dir, info)
    finally:
        dist.destroy_process_group()
    with open(os.path.join(out_dir, f"rank{rank}.json"), "w") as f:
        json.dump(info, f)


def _resume_and_supervise(rank, out_dir, info):
    import torch.distributed as dist
    ck = os.path.join(out_dir, "ckpt")
    flags = ("--ckpt-dir", ck, "--ckpt-every", "2")
    # save at 2x1 after step 2; one rank writes whole arrays
    _run_case(out_dir, "saved_2x1",
              _argv(DENSE, "2x1", *flags) + ["--steps", "2"], rank, False)
    dist.barrier()
    if rank == 0:
        shutil.copytree(ck, os.path.join(out_dir, "ckpt_one"))
    dist.barrier()
    # restore at 1x2: no step left to run, the carry as restored
    _run_case(out_dir, "restored_1x2",
              _argv(DENSE, "1x2", *flags) + ["--steps", "2"], rank, False)
    _run_case(out_dir, "resumed_1x2", _argv(DENSE, "1x2", *flags), rank,
              False)
    info["supervised"] = _supervised(rank, out_dir)


def _supervised(rank, out_dir):
    """TrainSupervisor over 2 ranks, 5 steps with a checkpoint every 2,
    uninterrupted and with a failure on rank 1 before step 3."""
    from repro_torch.checkpoint import CheckpointStore
    from repro_torch.config import ShapeConfig, TrainConfig, get_config
    from repro_torch.data import lm_batch_fn
    from repro_torch.launch.mesh import make_host_mesh
    from repro_torch.models import api
    from repro_torch.optim import adamw_init
    from repro_torch.runtime.fault import FailureInjector, TrainSupervisor
    from repro_torch.sharding.spmd import (gather_tree, local_batch,
                                           make_mesh_train_step,
                                           opt_shardings, param_shardings,
                                           shard_tree)
    from repro_torch.tree import tree_leaves
    cfg = dataclasses.replace(get_config(DENSE, reduced=True),
                              dtype="float32")
    tcfg = TrainConfig(lr=LR, sgdr_t0=50)
    shape = ShapeConfig("t", "train", S, B)
    mesh = make_host_mesh((2, 1))
    make = lm_batch_fn(cfg.vocab_size, B, S, seed=0)
    finals, restarts = [], []
    for tag, fail_at in (("whole", ()), ("failed", (3,) if rank == 1 else ())):
        params = api.init_params(cfg, torch.Generator().manual_seed(0),
                                 device=torch.device("cpu"))
        psh = param_shardings(cfg, params, mesh)
        params = shard_tree(params, psh)
        opt = adamw_init(params)
        step = make_mesh_train_step(cfg, tcfg, mesh, psh, shape)

        def make_step():
            def one(carry, batch):
                p, o, m = step(carry[0], carry[1], batch)
                return (p, o), m
            return one

        sup = TrainSupervisor(
            store=CheckpointStore(os.path.join(out_dir, f"sup_{tag}")),
            make_step=make_step, ckpt_every=2, mesh=mesh,
            shardings=(psh, opt_shardings(opt, psh)),
            make_batch=lambda s: local_batch(
                {k: torch.as_tensor(v) for k, v in make(s).items()},
                mesh, cfg, shape))
        out = sup.run((params, opt), num_steps=5,
                      injector=FailureInjector(fail_at))
        whole = gather_tree(out["carry"], sup.shardings)
        finals.append([t.numpy() for t in tree_leaves(whole)])
        restarts.append(out["restarts"])
    same = all(np.array_equal(a, b) for a, b in zip(*finals))
    return {"restarts": restarts, "bitwise": same}


def _step_fails_worker(rank, world, init, out_dir):
    """Rank 1's step raises; the run must end (the spawner reports the
    error), not hang in rank 0's collectives."""
    import torch.distributed as dist
    from repro_torch.sharding import spmd
    torch.set_num_threads(1)
    dist.init_process_group("gloo", init_method=init, world_size=world,
                            rank=rank)
    if rank == 1:
        def broken(*a, **k):
            raise RuntimeError("step failed on rank 1")
        spmd.make_mesh_train_step = lambda *a, **k: broken
    _launch(_argv(DENSE, "2x1", "--ckpt-dir",
                            os.path.join(out_dir, "ck"), "--ckpt-every",
                            "1"))


# ---------------------------------------------------------------------------


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    out = {}
    for world in (2, 4):
        d = tmp_path_factory.mktemp(f"ranks{world}")
        _spawn(_worker, world, d)
        for name in list(CASES) + ["saved_2x1", "restored_1x2",
                                   "resumed_1x2"]:
            if (d / f"{name}.npz").exists():
                out[name] = dict(np.load(d / f"{name}.npz"))
        out[f"info{world}"] = [json.loads((d / f"rank{r}.json").read_text())
                               for r in range(world)]
        out[f"dir{world}"] = d
    return out


def _plain(arch, *, accum=1, compress=False, steps=STEPS):
    """The one-process reference: make_train_step from the launcher's
    init on its batches; also each step's gradient (and, compressed,
    the one handed on)."""
    from repro_torch.config import TrainConfig, get_config
    from repro_torch.data import lm_batch_fn
    from repro_torch.models import api
    from repro_torch.optim import adamw_init, make_ef_int8_compressor
    from repro_torch.train.step import make_train_step
    from repro_torch.tree import tree_leaves
    cfg = dataclasses.replace(get_config(arch, reduced=True),
                              dtype="float32")
    tcfg = TrainConfig(lr=LR, grad_accum=accum, sgdr_t0=max(50, steps // 4))
    params = api.init_params(cfg, torch.Generator().manual_seed(0),
                             device=torch.device("cpu"))
    opt = adamw_init(params)
    seen, sent = [], []
    ef_init, ef_compress = make_ef_int8_compressor()
    cell = {"ef": ef_init(params)}

    def hook(grads):
        seen.append([g.clone() for g in tree_leaves(grads)])
        if compress:
            grads, cell["ef"] = ef_compress(grads, cell["ef"])
            sent.append([g.clone() for g in tree_leaves(grads)])
        return grads

    step = make_train_step(cfg, tcfg, compress_grads=hook)
    make = lm_batch_fn(cfg.vocab_size, B, S, seed=0)
    losses = []
    for s in range(steps):
        batch = {k: torch.as_tensor(v) for k, v in make(s).items()}
        params, opt, m = step(params, opt, batch)
        losses.append(float(m["loss"]))
    return {"params": [t.numpy() for t in tree_leaves(params)],
            "m": [t.numpy() for t in tree_leaves(opt["m"])],
            "v": [t.numpy() for t in tree_leaves(opt["v"])],
            "losses": losses, "seen": seen, "sent": sent}


def _small(seen):
    """Per leaf: elements whose gradient was below GRAD_T of the leaf's
    largest at some step so far."""
    out = None
    for grads in seen:
        m = [np.abs(g.numpy()) < GRAD_T * np.abs(g.numpy()).max()
             for g in grads]
        out = m if out is None else [a | b for a, b in zip(out, m)]
    return out


def _hold(got, ref, loose, steps=STEPS):
    np.testing.assert_allclose(got["losses"], ref["losses"], rtol=1e-5)
    reach = 2 * LR * steps + STEP["atol"]
    for i, (w, mask) in enumerate(zip(ref["params"], loose)):
        a = got[f"p/{i}"]
        np.testing.assert_allclose(a[~mask], w[~mask], **STEP,
                                   err_msg=f"param {i}")
        assert np.all(np.abs(a[mask] - w[mask]) <= reach), f"param {i}"
    for k in ("m", "v"):
        for i, (w, mask) in enumerate(zip(ref[k], loose)):
            a = got[f"{k}/{i}"]
            np.testing.assert_allclose(a[~mask], w[~mask], **STEP,
                                       err_msg=f"{k} {i}")


def test_one_process_launcher_is_the_plain_step(capsys):
    from repro_torch.sharding.spmd import gather_tree
    from repro_torch.tree import tree_leaves
    out = _launch(_argv(DENSE, "1x1"))
    assert "mesh (1, 1) devices=1 (cpu) backend=none" in capsys.readouterr(
        ).out
    ref = _plain(DENSE)
    assert out["losses"] == ref["losses"]
    params, opt = gather_tree(out["carry"], out["shardings"])
    for a, b in zip(tree_leaves(params), ref["params"]):
        np.testing.assert_array_equal(a.numpy(), b)
    for a, b in zip(tree_leaves(opt["m"]), ref["m"]):
        np.testing.assert_array_equal(a.numpy(), b)


@pytest.mark.parametrize("name", ["dense_2x1", "dense_1x2", "dense_2x2",
                                  "moe_2x1", "accum_2x1", "pod_2x2x1",
                                  "host_default"])
def test_mesh_step_equals_one_process(name, runs):
    world, arch, shape, extra, _ = CASES[name]
    ref = _plain(arch, accum=2 if "--grad-accum" in extra else 1)
    _hold(runs[name], ref, _small(ref["seen"]))


def test_compressed_mesh_step_within_one_quantum(runs):
    ref = _plain(DENSE, compress=True)
    got = runs["compress_2x1"]
    flips, loose, prev = [], _small(ref["seen"]), None
    for s, sent in enumerate(ref["sent"]):
        flips.append(0)
        quanta = []
        for i, w in enumerate(sent):
            w, seen = w.numpy(), ref["seen"][s][i].numpy()
            quantum = np.abs(w).max() / 127.0
            quanta.append(quantum)
            d = np.abs(got[f"sent/{s}/{i}"] - w)
            bound = quantum if prev is None else (
                quantum + prev[i] + np.abs(got[f"seen/{s}/{i}"] - seen))
            assert np.all(d <= bound * (1 + 1e-5) + 1e-12), (s, i, d.max())
            if prev is None:
                np.testing.assert_allclose(got[f"seen/{s}/{i}"], seen,
                                           **STEP)
            flipped = d > quantum / 2
            flips[-1] += int(flipped.sum())
            loose[i] |= flipped
        prev = quanta
    print(f"--compress-grads at 2x1: int8 codes flipped by step {flips}")
    _hold(got, ref, loose)


def test_bfloat16_over_the_mesh(runs):
    """The configs' own bfloat16 (shards gathered as bytes: gloo takes
    no bfloat16).  1x2 is one process's arithmetic, so it is held bit
    for bit.  At 2x1 each rank rounds its half's gradient to bfloat16
    and the float32 average is rounded once more, where one process
    rounds once, so only the first loss (equal params, float32 CE over
    the rows) is held at rtol 1e-5 and the params within the steps'
    reach."""
    from repro_torch.sharding.spmd import gather_tree
    from repro_torch.tree import tree_leaves
    one = _launch(_argv(DENSE), "bfloat16")
    params, _ = gather_tree(one["carry"], one["shardings"])
    want = [t.float().numpy() for t in tree_leaves(params)]
    assert str(tree_leaves(params)[0].dtype) == "torch.bfloat16"
    same = runs["bf16_1x2"]
    np.testing.assert_array_equal(same["losses"], one["losses"])
    for i, w in enumerate(want):
        np.testing.assert_array_equal(same[f"p/{i}"], w)
    split = runs["bf16_2x1"]
    np.testing.assert_allclose(split["losses"][0], one["losses"][0],
                               rtol=1e-5)
    assert np.all(np.isfinite(split["losses"]))
    for i, w in enumerate(want):
        assert np.all(np.abs(split[f"p/{i}"] - w)
                      <= 2 * LR * STEPS + STEP["atol"]), i


def test_shard_bytes_per_rank(runs):
    """At 2x1 and 1x2 a rank holds about half of the params and AdamW
    state (leaves too small or indivisible stay whole)."""
    for r in runs["info2"]:
        for name in ("dense_2x1", "dense_1x2"):
            line = r[name]
            assert line["world"] == 2
            assert 0.45 <= line["param_bytes"] / line[
                "param_bytes_whole"] <= 0.7
            assert 0.45 <= line["opt_bytes"] / line["opt_bytes_whole"] <= 0.7
    for r in runs["info4"]:
        line = r["dense_2x2"]
        assert line["param_bytes"] / line["param_bytes_whole"] <= 0.45
        # --mesh host without a shape: the reference's (n / 2, 2)
        assert r["host_default"]["mesh"] == [2, 2]
        assert r["pod_2x2x1"]["mesh"] == [2, 2, 1]


def test_checkpoint_saved_at_2x1_restores_at_1x2_bit_for_bit(runs):
    """The checkpoint holds the 2x1 run's gathered carry; restored at
    1x2 (no step left to run) and gathered again it is the same arrays,
    bit for bit."""
    from repro_torch.checkpoint import CheckpointStore
    from repro_torch.checkpoint.store import _leaves_with_path
    from repro_torch.config import get_config
    from repro_torch.models import api
    from repro_torch.optim import adamw_init
    d = runs["dir2"] / "ckpt_one"
    assert CheckpointStore(str(d)).latest_step() == 2
    with np.load(d / "step_0000000002" / "shard_0.npz") as data:
        saved = {k: data[k] for k in data.files}
    cfg = dataclasses.replace(get_config(DENSE, reduced=True),
                              dtype="float32")
    params = api.init_params(cfg, torch.Generator().manual_seed(0),
                             device=torch.device("cpu"))
    keys = ["/".join(p) for p, _ in _leaves_with_path(
        (params, adamw_init(params)))]
    got, at_save = runs["restored_1x2"], runs["saved_2x1"]
    assert len(got["losses"]) == 0 and len(at_save["losses"]) == 2
    n = sum(k.startswith("p/") for k in got)
    for i in range(n):
        np.testing.assert_array_equal(saved[keys[i]], at_save[f"p/{i}"])
        np.testing.assert_array_equal(got[f"p/{i}"], saved[keys[i]])
    for k in ("m", "v"):
        want = [saved[x] for x in keys if x.startswith(f"#1/{k}/")]
        assert len(want) == n
        for i, w in enumerate(want):
            np.testing.assert_array_equal(got[f"{k}/{i}"], w)


def test_resumed_step_equals_an_uninterrupted_run(runs, capsys):
    whole = _plain(DENSE, steps=STEPS)
    # at 1x2 (two ranks), from the 2x1 checkpoint of step 2
    np.testing.assert_allclose(runs["resumed_1x2"]["losses"],
                               whole["losses"][2:], rtol=1e-5)
    # at one process, from a copy of the same checkpoint
    one = _launch(_argv(DENSE, None, "--ckpt-dir",
                                  str(runs["dir2"] / "ckpt_one")))
    assert "resumed from step 2" in capsys.readouterr().out
    np.testing.assert_allclose(one["losses"], whole["losses"][2:],
                               rtol=1e-5)


def test_supervisor_over_ranks_restarts_together(runs):
    for r in runs["info2"]:
        assert r["supervised"] == {"restarts": [0, 1], "bitwise": True}


def test_a_rank_whose_step_fails_ends_the_run(tmp_path):
    t0 = time.time()
    with pytest.raises(Exception, match="step failed on rank 1"):
        _spawn(_step_fails_worker, 2, tmp_path)
    assert time.time() - t0 < TIMEOUT_S
