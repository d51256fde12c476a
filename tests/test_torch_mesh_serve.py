"""One decode step over a mesh of processes
(``sharding.spmd.make_mesh_serve_step``) against the one-process serve
step (``train.step.make_serve_step``), on reduced ``lm-100m`` in
float32, 4 rows, a 16-token context, from a state that 5 plain decode
steps filled.

* 1x1, in this process with no process group: logits and new state bit
  for bit;
* over two gloo processes: at 1x2 (the model axis; both ranks decode
  all rows, the caches split over heads) bit for bit, each rank's logits
  and its shard of the new state against the same rows and shard of
  the one-process step; at 2x1 (each rank decodes its 2 rows, a smaller
  matmul) within 1e-6 of the largest element, relative.
"""
import json
import os
import time

import numpy as np
import pytest
import torch

torch.set_num_threads(1)

ARCH = "lm-100m"
B, CTX, WARM = 4, 16, 5
REL = 1e-6
TIMEOUT_S = 180


def _setup():
    """(cfg, params, state after WARM plain steps, next token)."""
    import dataclasses
    from repro_torch.config import get_config
    from repro_torch.models import api
    from repro_torch.models.layers.common import zeros_from_spec
    from repro_torch.train.step import make_serve_step
    cfg = dataclasses.replace(get_config(ARCH, reduced=True),
                              dtype="float32")
    params = api.init_params(cfg, torch.Generator().manual_seed(0))
    toks = torch.as_tensor(np.random.default_rng(1).integers(
        0, cfg.vocab_size, (WARM + 1, B, 1)).astype(np.int32))
    state = zeros_from_spec(api.decode_state_spec(cfg, B, CTX))
    step = make_serve_step(cfg)
    for t in toks[:WARM]:
        _, state = step(params, state, t)
    return cfg, params, state, toks[WARM]


def _mesh_step(mesh, cfg, params, state, token):
    """(local logits, this rank's new state shards, the plain step's
    logits and new state cut the same way)."""
    from repro_torch.config import ShapeConfig
    from repro_torch.sharding.partition import cache_partition, named
    from repro_torch.sharding.spmd import (local_batch, make_mesh_serve_step,
                                           param_shardings, shard_tree)
    from repro_torch.train.step import make_serve_step
    shape = ShapeConfig("decode", "decode", CTX, B)
    psh = param_shardings(cfg, params, mesh)
    csh = named(mesh, cache_partition(cfg, shape, mesh.config, state))
    step = make_mesh_serve_step(cfg, mesh, psh, csh, shape)
    tok = local_batch({"token": token}, mesh, cfg, shape)["token"]
    logits, new = step(shard_tree(params, psh), shard_tree(state, csh), tok)
    want_logits, want_new = make_serve_step(cfg)(params, state, token)
    want_logits = local_batch({"token": want_logits}, mesh, cfg,
                              shape)["token"]
    return logits, new, want_logits, shard_tree(want_new, csh)


def _diffs(got, want):
    """(max |got - want| / max |want| over the leaves, all equal)."""
    from repro_torch.tree import tree_leaves
    rel, same = 0.0, True
    for a, b in zip(tree_leaves(got), tree_leaves(want)):
        same = same and torch.equal(a, b)
        scale = float(b.abs().max()) or 1.0
        rel = max(rel, float((a - b).abs().max()) / scale)
    return rel, same


def test_one_process_mesh_equals_the_serve_step_bit_for_bit():
    from repro_torch.config import MeshConfig
    from repro_torch.sharding.spmd import ProcessMesh
    cfg, params, state, token = _setup()
    mesh = ProcessMesh(MeshConfig((1, 1), ("data", "model")), device="cpu")
    logits, new, want_logits, want_new = _mesh_step(mesh, cfg, params,
                                                    state, token)
    assert torch.equal(logits, want_logits)
    assert _diffs(new, want_new) == (0.0, True)


def _worker(rank, world, init, out_dir):
    import torch.distributed as dist
    from repro_torch.config import MeshConfig
    from repro_torch.sharding.spmd import ProcessMesh
    torch.set_num_threads(1)
    dist.init_process_group("gloo", init_method=init, world_size=world,
                            rank=rank)
    out = {}
    try:
        cfg, params, state, token = _setup()
        for shape in ((1, 2), (2, 1)):
            mesh = ProcessMesh(MeshConfig(shape, ("data", "model")),
                               device="cpu")
            logits, new, wl, wn = _mesh_step(mesh, cfg, params, state, token)
            lrel, lsame = _diffs(logits, wl)
            srel, ssame = _diffs(new, wn)
            out["x".join(map(str, shape))] = dict(
                logits_rel=lrel, logits_same=lsame, state_rel=srel,
                state_same=ssame, rows=int(logits.shape[0]))
    finally:
        dist.destroy_process_group()
    with open(os.path.join(out_dir, f"rank{rank}.json"), "w") as f:
        json.dump(out, f)


def test_two_ranks_equal_the_serve_step(tmp_path):
    import torch.multiprocessing as mp
    pctx = mp.start_processes(
        _worker, args=(2, f"file://{tmp_path}/rdzv", str(tmp_path)),
        nprocs=2, join=False, start_method="spawn")
    deadline = time.time() + TIMEOUT_S
    while not pctx.join(timeout=max(1.0, deadline - time.time())):
        if time.time() > deadline:
            for p in pctx.processes:
                p.kill()
            pytest.fail(f"2 ranks did not finish in {TIMEOUT_S} s")
    for rank in range(2):
        res = json.loads((tmp_path / f"rank{rank}.json").read_text())
        one = res["1x2"]
        assert one["rows"] == B and one["logits_same"] and one["state_same"]
        two = res["2x1"]
        assert two["rows"] == B // 2
        assert two["logits_rel"] <= REL and two["state_rel"] <= REL, two
