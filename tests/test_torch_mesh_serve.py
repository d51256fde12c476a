"""Decode over a mesh of processes (``sharding.spmd.make_mesh_serve_step``)
against the one-process serve step (``train.step.make_serve_step``), on
reduced configs in float32, 4 rows, a 16-token context, from a state
that WARM plain decode steps filled, then STEPS teacher-forced steps
through both (each carrying its own state).

* 1x1, in this process with no process group: logits and new state bit
  for bit at every step;
* over gloo processes: at 1x2 (the model axis; both ranks decode all
  rows, the layers split: attention heads, the caches by kv heads or by
  head_dim, MLA's heads, MoE experts, Mamba's channels and states,
  whisper's self and cross attention, the FFNs and the vocabulary), at
  2x1 (lm-100m: each rank decodes its 2 rows, a smaller matmul) and at
  2x2, each rank's logits and its shard of the new state against the
  same rows and shard of the one-process step, within REL of the
  largest element: the split sums its parts in another order than one
  process.

Cases: lm-100m (4 heads over 2 kv heads: the caches by kv heads);
granite-34b (one kv head: the caches by head_dim, rope on the whole
head; a tied head); gemma3-12b (one kv head of 24 dims, windowed rings
of 32 slots, so its WARM steps take it past position 32 and the rings
wrap); qwen2-moe-a2.7b (experts); deepseek-v2-lite-16b (MLA: its latent
cache off the model axis); jamba-v0.1-52b (Mamba's ``h`` and ``conv``
by channel beside attention); whisper-small (self and cross caches,
the cross K/V projected from encoded frames); xlstm-350m (its layers
gathered whole over the model axis; the mLSTM's conv state, which
``cache_partition`` splits by channel, gathered for the layer and cut
back).  At 1x2 a rank holds half the bytes of each cache leaf that
``cache_partition`` puts on the model axis, and the per-layer gathers
move no param over the model axis but jamba's ``w_in``, which each Mamba
layer regathers whole, and xLSTM's.
"""
import json
import os
import time

import numpy as np
import pytest
import torch

torch.set_num_threads(1)

ARCH = "lm-100m"
ARCHS = ("lm-100m", "granite-34b", "gemma3-12b", "qwen2-moe-a2.7b",
         "deepseek-v2-lite-16b", "jamba-v0.1-52b", "whisper-small",
         "xlstm-350m")
WHOLE = "xlstm-350m"    # its layers decode whole over the model axis
B, CTX, WARM, STEPS = 4, 16, 5, 8
# gemma3-12b's rings hold 32 slots: its steps run from position 30 to 37
WARM_OF = {"gemma3-12b": 30}
REL = 1e-6
TIMEOUT_S = 180


def _setup(arch=ARCH):
    """(cfg, params, state after the WARM plain steps, the STEPS next
    tokens)."""
    import dataclasses
    from repro_torch.config import get_config
    from repro_torch.models import api
    from repro_torch.models.layers.common import zeros_from_spec
    from repro_torch.train.step import make_serve_step
    cfg = dataclasses.replace(get_config(arch, reduced=True),
                              dtype="float32")
    params = api.init_params(cfg, torch.Generator().manual_seed(0))
    warm = WARM_OF.get(arch, WARM)
    rng = np.random.default_rng(1)
    toks = torch.as_tensor(rng.integers(
        0, cfg.vocab_size, (warm + STEPS, B, 1)).astype(np.int32))
    state = zeros_from_spec(api.decode_state_spec(cfg, B, CTX))
    if cfg.encoder is not None:
        from repro_torch.models import encdec
        frames = torch.as_tensor(rng.normal(0, 1, (
            B, cfg.encoder.seq_len, cfg.encoder.feature_dim)).astype(
                np.float32))
        with torch.no_grad():
            state["cross"] = encdec.prefill_cross(
                cfg, params, encdec.encode(cfg, params, frames))
    step = make_serve_step(cfg)
    for t in toks[:warm]:
        _, state = step(params, state, t)
    return cfg, params, state, toks[warm:]


def _mesh_steps(mesh, cfg, params, state, toks):
    """Per step: (local logits, this rank's new state shards, the plain
    step's logits and new state cut the same way)."""
    from repro_torch.config import ShapeConfig
    from repro_torch.sharding.partition import cache_partition, named
    from repro_torch.sharding.spmd import (local_batch, make_mesh_serve_step,
                                           param_shardings, shard_tree)
    from repro_torch.train.step import make_serve_step
    shape = ShapeConfig("decode", "decode", CTX, B)
    psh = param_shardings(cfg, params, mesh)
    csh = named(mesh, cache_partition(cfg, shape, mesh.config, state))
    step = make_mesh_serve_step(cfg, mesh, psh, csh, shape)
    plain = make_serve_step(cfg)
    ps, ss, want = shard_tree(params, psh), shard_tree(state, csh), state
    out = []
    for token in toks:
        tok = local_batch({"token": token}, mesh, cfg, shape)["token"]
        logits, ss = step(ps, ss, tok)
        wl, want = plain(params, want, token)
        wl = local_batch({"token": wl}, mesh, cfg, shape)["token"]
        out.append((logits, ss, wl, shard_tree(want, csh)))
    return out


def _diffs(got, want):
    """(max |got - want| / max |want| over the leaves, all equal)."""
    from repro_torch.tree import tree_leaves
    rel, same = 0.0, True
    for a, b in zip(tree_leaves(got), tree_leaves(want)):
        same = same and torch.equal(a, b)
        scale = float(b.abs().max()) or 1.0
        rel = max(rel, float((a - b).abs().max()) / scale)
    return rel, same


def _one_process(arch):
    from repro_torch.config import MeshConfig
    from repro_torch.sharding.spmd import ProcessMesh
    cfg, params, state, toks = _setup(arch)
    mesh = ProcessMesh(MeshConfig((1, 1), ("data", "model")), device="cpu")
    for logits, new, want_logits, want_new in _mesh_steps(
            mesh, cfg, params, state, toks):
        assert torch.equal(logits, want_logits)
        assert _diffs(new, want_new) == (0.0, True)


def test_one_process_mesh_equals_the_serve_step_bit_for_bit():
    _one_process(ARCH)


@pytest.mark.parametrize("arch", [a for a in ARCHS if a != ARCH])
def test_one_process_split_decode_is_the_serve_step_bit_for_bit(arch):
    _one_process(arch)


class _ModelGathers:
    """Counts the bytes that ``ProcessMesh.all_gather`` returns over the
    model axis: the params' (the per-layer gathers move them as one
    uint8 buffer), those gathered inside a Mamba layer's regather of its
    ``w_in`` (``mamba._split_in_proj``) and the rest (activations)."""

    def __init__(self):
        from repro_torch.models.layers import mamba
        from repro_torch.sharding.spmd import ProcessMesh
        self.cls, self.real = ProcessMesh, ProcessMesh.all_gather
        self.mamba, self.real_in = mamba, mamba._split_in_proj
        self.params = self.other = self.weights = 0
        self.in_proj = False
        me = self

        def counted(mesh, t, axes):
            out = me.real(mesh, t, axes)
            if "model" in mesh._live(axes):
                n = sum(o.numel() * o.element_size() for o in out)
                if t.dtype == torch.uint8 and t.ndim == 1:
                    me.params += n
                elif me.in_proj:
                    me.weights += n
                else:
                    me.other += n
            return out

        def in_proj(*args):
            me.in_proj = True
            try:
                return me.real_in(*args)
            finally:
                me.in_proj = False
        self.cls.all_gather = counted
        mamba._split_in_proj = in_proj

    def close(self):
        self.cls.all_gather = self.real
        self.mamba._split_in_proj = self.real_in
        return {"params": self.params, "weights": self.weights,
                "other": self.other}


def _cache_bytes(state, shardings):
    """Bytes of the state leaves whose spec names the model axis."""
    from repro_torch.tree import tree_leaves
    return sum(t.numel() * t.element_size()
               for t, s in zip(tree_leaves(state), tree_leaves(shardings))
               if any("model" in ((p,) if isinstance(p, str) else (p or ()))
                      for p in s.spec))


def _case(mesh, arch):
    from repro_torch.config import ShapeConfig
    from repro_torch.sharding.partition import cache_partition, named
    cfg, params, state, toks = _setup(arch)
    count = _ModelGathers()
    try:
        steps = _mesh_steps(mesh, cfg, params, state, toks)
    finally:
        gathered = count.close()
    line = {"logits_rel": [], "logits_same": [], "state_rel": [],
            "state_same": [], "rows": int(steps[0][0].shape[0]),
            "model_gathers": gathered}
    for logits, new, wl, wn in steps:
        lrel, lsame = _diffs(logits, wl)
        srel, ssame = _diffs(new, wn)
        line["logits_rel"].append(lrel)
        line["logits_same"].append(lsame)
        line["state_rel"].append(srel)
        line["state_same"].append(ssame)
    csh = named(mesh, cache_partition(cfg, ShapeConfig(
        "decode", "decode", CTX, B), mesh.config, state))
    line["cache_bytes"] = _cache_bytes(steps[-1][1], csh)
    line["cache_bytes_whole"] = _cache_bytes(state, csh)
    return line


def _worker(rank, world, init, out_dir):
    import torch.distributed as dist
    from repro_torch.config import MeshConfig
    from repro_torch.sharding.spmd import ProcessMesh
    torch.set_num_threads(1)
    dist.init_process_group("gloo", init_method=init, world_size=world,
                            rank=rank)
    out = {}
    try:
        shapes = ((1, 2), (2, 1)) if world == 2 else ((2, 2),)
        for shape in shapes:
            mesh = ProcessMesh(MeshConfig(shape, ("data", "model")),
                               device="cpu")
            name = "x".join(map(str, shape))
            for arch in (ARCHS if shape != (2, 1) else (ARCH,)):
                out[f"{arch}/{name}"] = _case(mesh, arch)
    finally:
        dist.destroy_process_group()
    with open(os.path.join(out_dir, f"rank{rank}.json"), "w") as f:
        json.dump(out, f)


def _spawn(world, tmp_path):
    import torch.multiprocessing as mp
    pctx = mp.start_processes(
        _worker, args=(world, f"file://{tmp_path}/rdzv", str(tmp_path)),
        nprocs=world, join=False, start_method="spawn")
    deadline = time.time() + TIMEOUT_S
    while not pctx.join(timeout=max(1.0, deadline - time.time())):
        if time.time() > deadline:
            for p in pctx.processes:
                p.kill()
            pytest.fail(f"{world} ranks did not finish in {TIMEOUT_S} s")
    return [json.loads((tmp_path / f"rank{r}.json").read_text())
            for r in range(world)]


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    return {w: _spawn(w, tmp_path_factory.mktemp(f"serve{w}"))
            for w in (2, 4)}


def _held(line, what):
    assert len(line["logits_rel"]) == STEPS, what
    assert max(line["logits_rel"]) <= REL, (what, line["logits_rel"])
    assert max(line["state_rel"]) <= REL, (what, line["state_rel"])


def test_two_ranks_equal_the_serve_step(runs):
    """lm-100m at 1x2 and 2x1 over STEPS steps within REL; at 2x1 each
    rank decodes its 2 rows."""
    for res in runs[2]:
        one = res[f"{ARCH}/1x2"]
        assert one["rows"] == B
        _held(one, "1x2")
        two = res[f"{ARCH}/2x1"]
        assert two["rows"] == B // 2
        _held(two, "2x1")


@pytest.mark.parametrize("mesh", ["1x2", "2x2"])
@pytest.mark.parametrize("arch", ARCHS)
def test_split_decode_equals_the_serve_step(arch, mesh, runs):
    world, rows = (2, B) if mesh == "1x2" else (4, B // 2)
    lines = [res[f"{arch}/{mesh}"] for res in runs[world]]
    for rank, line in enumerate(lines):
        assert line["rows"] == rows, (rank, line["rows"])
        _held(line, f"{arch} {mesh} rank {rank}")


@pytest.mark.parametrize("arch", ARCHS)
def test_a_rank_holds_half_of_each_cache_leaf_on_the_model_axis(arch, runs):
    """At 1x2 a rank's shard of every state leaf that ``cache_partition``
    puts on the model axis is half of the leaf (the K/V caches by kv
    heads or by head_dim, Mamba's states by channel); MLA's latent
    cache and whisper's stacked caches are off the axis, so those archs
    hold none there."""
    for res in runs[2]:
        line = res[f"{arch}/1x2"]
        if arch in ("deepseek-v2-lite-16b", "whisper-small"):
            assert line["cache_bytes_whole"] == 0, line
        else:
            assert line["cache_bytes_whole"] > 0, line
            assert 2 * line["cache_bytes"] == line["cache_bytes_whole"], line


def test_no_param_is_gathered_over_the_model_axis_in_decode(runs):
    """At 1x2 the per-layer gathers move no param over the model axis:
    every part that ``param_partition`` puts on it is kept as the rank's
    block (attention and MLA heads, the FFNs, the experts, Mamba's
    channels, whisper's self and cross attention, the vocabulary).  The
    bytes that all-gathers over "model" return are activations (the new
    token's q, k and v and p @ v's head_dim blocks where the caches
    split by head_dim, the logits' vocabulary blocks) and, in jamba,
    each Mamba layer's ``w_in``, whose joined [x | z] columns the layer
    regathers whole at every step: those bytes are held to that
    count.  xLSTM's layers are gathered whole over the axis."""
    from repro_torch.config import get_config
    jamba = get_config("jamba-v0.1-52b", reduced=True)
    n_mamba = sum(s.mixer == "mamba" for s in jamba.layer_specs())
    w_in = jamba.d_model * 2 * jamba.ssm.expand * jamba.d_model * 4
    for res in runs[2]:
        assert res[f"{WHOLE}/1x2"]["model_gathers"]["params"] > 0
        for arch in (a for a in ARCHS if a != WHOLE):
            got = res[f"{arch}/1x2"]["model_gathers"]
            assert got["params"] == 0, (arch, got)
            assert got["other"] > 0, (arch, got)
            want = STEPS * n_mamba * w_in if arch.startswith("jamba") else 0
            assert got["weights"] == want, (arch, got, want)
        assert res[f"{ARCH}/2x1"]["model_gathers"] == {
            "params": 0, "weights": 0, "other": 0}
