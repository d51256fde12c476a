"""The port's mesh and collectives over gloo processes on the CPU
(``repro_torch.sharding``, ``repro_torch.launch.mesh``,
``repro_torch.optim.grad_compress.psum_int8``).

* ``psum_int8`` over 2 and 4 processes equals the reference's under
  ``jax.vmap(..., axis_name=)`` on the same numpy inputs bit for bit
  (a MAX and an int32 SUM are exact), for float32 and bfloat16 leaves
  and an all-zero one; on a 2 x 2 mesh over both axes and over the
  model axis alone;
* a leaf cut by its PartitionSpec and gathered back is the leaf;
* ``constrain`` is the identity and checks its arity;
* the mesh builders and their refusals (a shape whose device count is
  not the world size);
* the MoE layer over 2 data ranks holding half the tokens each equals
  one process on all of them: outputs, aux loss and averaged gradients
  (rtol 1e-5, atol 1e-6: float32 sums split in two), for the dense and
  the capacity dispatch, whose per-rank answer without the mesh
  differs (so the global statistics are what the test holds).

Each spawned run rendezvous through a file under ``tmp_path`` and has a
timeout.
"""
import json
import os
import time

import numpy as np
import pytest
import torch

torch.set_num_threads(1)

TIMEOUT_S = 150
D_MODEL, B, S = 64, 4, 16


def _spawn(fn, world, tmp_path):
    """Run ``fn(rank, world, init_method, out_dir)`` in ``world``
    processes; a failure or the timeout fails the test."""
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


def _inputs(world):
    """Per rank: float32 leaves of different scales, a wide-range one,
    an all-zero one, a bfloat16 one (as float32 values to cast)."""
    rng = np.random.default_rng(7)
    out = []
    for r in range(world):
        out.append({
            "a": (rng.normal(0, 1 + r, (3, 5))).astype(np.float32),
            "b": (rng.normal(0, 1, (7,)) * 10.0 ** rng.integers(
                -3, 3, (7,))).astype(np.float32),
            "h": rng.normal(0, 0.1, (4, 4)).astype(np.float32),
            "z": np.zeros((2, 3), np.float32),
        })
    return out


def _torch_leaves(d):
    t = {k: torch.as_tensor(v) for k, v in d.items()}
    t["h"] = t["h"].to(torch.bfloat16)
    return t


def _np_out(tree):
    return {k: v.to(torch.float32).numpy() for k, v in tree.items()}


def _moe_setup():
    from repro_torch.config import get_config
    from repro_torch.models.layers.common import init_from_spec
    from repro_torch.models.layers.moe import moe_spec
    mcfg = get_config("qwen2-moe-a2.7b", reduced=True).moe
    p = init_from_spec(moe_spec(mcfg, D_MODEL, torch.float32, model_axis=1),
                       torch.Generator().manual_seed(0))
    rng = np.random.default_rng(3)
    x = torch.as_tensor(rng.normal(0, 1, (B, S, D_MODEL)).astype(np.float32))
    c = torch.as_tensor(rng.normal(0, 1, (B, S, D_MODEL)).astype(np.float32))
    return mcfg, p, x, c


def _moe_run(p, mcfg, x, c, dispatch):
    """(out, aux, grads) of mean(out * c) + aux over the rows in hand."""
    from repro_torch.models.layers.moe import apply_moe
    q = {k: v.detach().requires_grad_(True) for k, v in p.items()}
    out, aux = apply_moe(q, mcfg, x, torch.nn.functional.silu,
                         dispatch=dispatch)
    loss = torch.mean(out * c) + aux
    names = sorted(q)
    grads = torch.autograd.grad(loss, [q[k] for k in names],
                                allow_unused=True)
    return out.detach(), aux.detach(), {
        k: (torch.zeros_like(q[k]) if g is None else g)
        for k, g in zip(names, grads)}


def _worker(rank, world, init, out_dir):
    import torch.distributed as dist
    from repro_torch.launch.mesh import make_host_mesh, make_production_mesh
    from repro_torch.optim import psum_int8
    from repro_torch.sharding import PartitionSpec as P
    from repro_torch.sharding import ctx
    from repro_torch.sharding.spmd import gather_leaf, local_shard

    torch.set_num_threads(1)
    dist.init_process_group("gloo", init_method=init, world_size=world,
                            rank=rank)
    res, arrays = {}, {}
    try:
        leaves = _torch_leaves(_inputs(world)[rank])
        mesh = make_host_mesh((world, 1), device="cpu")
        res["device_mesh"] = list(mesh.device_mesh.mesh_dim_names)
        with ctx.active_mesh(mesh):
            for k, v in _np_out(psum_int8(leaves, "data")).items():
                arrays[f"psum_data/{k}"] = v
            x = torch.ones(2, 3)
            res["constrain_same"] = ctx.constrain(x, "batch", None) is x
            try:
                ctx.constrain(x, "batch")
                res["constrain_arity"] = "no error"
            except AssertionError:
                res["constrain_arity"] = "AssertionError"
        for what, build in (
                ("host_2x4", lambda: make_host_mesh(device="cpu")),
                ("single_pod",
                 lambda: make_production_mesh(device="cpu"))):
            try:
                build()
                res[what] = "built"
            except ValueError as e:
                res[what] = str(e)
        if world == 4:
            m22 = make_host_mesh((2, 2), device="cpu")
            res["coords_2x2"] = list(m22.coords)
            with ctx.active_mesh(m22):
                for axes, tag in ((("data", "model"), "both"),
                                  ("model", "model")):
                    for k, v in _np_out(psum_int8(leaves, axes)).items():
                        arrays[f"psum_{tag}/{k}"] = v
            for dtype in (torch.float32, torch.bfloat16, torch.int32):
                whole = torch.arange(4 * 6).reshape(4, 6).to(dtype) - 7
                for spec in (P("data", "model"), P(None, "model"),
                             P(("data", "model"), None), P(None, None)):
                    shard = local_shard(m22, whole, spec)
                    back = gather_leaf(m22, shard, spec)
                    res[f"round_trip {spec} {dtype}"] = (
                        bool(torch.equal(back, whole)), list(shard.shape))
        else:
            mcfg, p, x, c = _moe_setup()
            rows = slice(rank * B // world, (rank + 1) * B // world)
            with ctx.active_mesh(mesh), ctx.batch_split(("data",)):
                for dispatch in ("dense", "sparse_capacity"):
                    out, aux, grads = _moe_run(p, mcfg, x[rows], c[rows],
                                               dispatch)
                    arrays[f"moe_{dispatch}/out"] = out.numpy()
                    arrays[f"moe_{dispatch}/aux"] = aux.numpy()
                    for k, g in grads.items():
                        arrays[f"moe_{dispatch}/grad/{k}"] = (
                            mesh.all_reduce(g, "sum", "data") / world).numpy()
    finally:
        dist.destroy_process_group()
    np.savez(os.path.join(out_dir, f"rank{rank}.npz"), **arrays)
    with open(os.path.join(out_dir, f"rank{rank}.json"), "w") as f:
        json.dump(res, f)


def _results(tmp_path, world):
    return ([dict(np.load(tmp_path / f"rank{r}.npz")) for r in range(world)],
            [json.loads((tmp_path / f"rank{r}.json").read_text())
             for r in range(world)])


@pytest.fixture(scope="module")
def two_ranks(tmp_path_factory):
    d = tmp_path_factory.mktemp("two_ranks")
    _spawn(_worker, 2, d)
    return _results(d, 2)


@pytest.fixture(scope="module")
def four_ranks(tmp_path_factory):
    d = tmp_path_factory.mktemp("four_ranks")
    _spawn(_worker, 4, d)
    return _results(d, 4)


def _ref_psum(per_rank, world):
    """The reference's psum_int8 under jax.vmap over ``world`` ranks."""
    import jax
    import jax.numpy as jnp
    from repro.optim.grad_compress import psum_int8 as j_psum_int8
    stacked = {k: jnp.stack([jnp.asarray(d[k]) for d in per_rank])
               for k in per_rank[0]}
    stacked["h"] = stacked["h"].astype(jnp.bfloat16)
    out = jax.vmap(lambda t: j_psum_int8(t, "dp"), axis_name="dp")(stacked)
    return {k: np.asarray(v.astype(jnp.float32)) for k, v in out.items()}


def _assert_bitwise(got, want, prefix):
    for k, w in want.items():
        for r, arrays in enumerate(got):
            np.testing.assert_array_equal(arrays[f"{prefix}/{k}"], w[r],
                                          err_msg=f"{prefix}/{k} rank {r}")


@pytest.mark.parametrize("world", [2, 4])
def test_psum_int8_matches_reference_bit_for_bit(world, two_ranks,
                                                 four_ranks):
    got = (two_ranks if world == 2 else four_ranks)[0]
    want = _ref_psum(_inputs(world), world)
    assert not want["z"].any()
    _assert_bitwise(got, want, "psum_data")


def test_psum_int8_over_two_axes_and_one(four_ranks):
    got = four_ranks[0]
    per_rank = _inputs(4)
    _assert_bitwise(got, _ref_psum(per_rank, 4), "psum_both")
    # the model axis alone: ranks (0, 1) and (2, 3) of the 2 x 2 mesh
    pairs = [_ref_psum(per_rank[i:i + 2], 2) for i in (0, 2)]
    want = {k: np.concatenate([pairs[0][k], pairs[1][k]]) for k in pairs[0]}
    _assert_bitwise(got, want, "psum_model")


def test_psum_int8_needs_an_active_mesh():
    from repro_torch.optim import psum_int8
    with pytest.raises(NameError, match="unbound axis name: data"):
        psum_int8({"a": torch.ones(2)}, "data")


def test_shard_and_gather_round_trip(four_ranks):
    info = four_ranks[1]
    assert [r["coords_2x2"] for r in info] == [[0, 0], [0, 1], [1, 0],
                                               [1, 1]]
    shapes = {"PartitionSpec('data', 'model')": [2, 3],
              "PartitionSpec(None, 'model')": [4, 3],
              "PartitionSpec(('data', 'model'), None)": [1, 6],
              "PartitionSpec(None, None)": [4, 6]}
    for r in info:
        for spec, shape in shapes.items():
            for dtype in ("torch.float32", "torch.bfloat16", "torch.int32"):
                assert r[f"round_trip {spec} {dtype}"] == [True, shape]


def test_constrain_is_the_identity_and_checks_arity(two_ranks):
    from repro_torch.sharding import ctx
    for r in two_ranks[1]:
        assert r["constrain_same"] and r["constrain_arity"] == (
            "AssertionError")
    x = torch.ones(3)
    assert ctx.constrain(x, "batch", "model") is x   # no mesh: no check


def test_mesh_builders_and_refusals(two_ranks):
    for r in two_ranks[1]:
        assert r["device_mesh"] == ["data", "model"]
        assert "needs 8 processes; the world has 2" in r["host_2x4"]
        assert "needs 256 processes; the world has 2" in r["single_pod"]


def test_mesh_builders_without_a_group():
    from repro_torch.launch.mesh import (make_host_mesh, make_sweep_mesh,
                                         mesh_config)
    from repro_torch.sharding import REPLICA_AXIS, replica_mesh
    m = make_host_mesh((1, 1), device="cpu")
    assert (m.world, m.rank, m.coords, m.device_mesh) == (1, 0, (0, 0),
                                                          None)
    with pytest.raises(ValueError, match=r"needs 2 processes; the world "
                       r"has 1 \(no process group is open\)"):
        make_host_mesh((2, 1), device="cpu")
    assert mesh_config().shape == (16, 16)
    assert mesh_config(multi_pod=True).axes == ("pod", "data", "model")
    assert REPLICA_AXIS == "replica"
    assert replica_mesh(devices=["cpu"] * 4) == [torch.device("cpu")] * 4
    assert replica_mesh(2, devices=["cpu"] * 4) == [torch.device("cpu")] * 2
    with pytest.raises(ValueError, match="not in"):
        replica_mesh(5, devices=["cpu"] * 4)
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="no CUDA"):
            make_sweep_mesh()


def test_mesh_helpers_default_to_the_card(monkeypatch):
    """``device=None`` is the card, as at every entry point: with none
    visible the mesh builders and the sharded-serving budget raise
    ``resolve_device``'s error; the CPU runs when named."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    from repro_torch.config import MeshConfig
    from repro_torch.launch.mesh import (make_host_mesh,
                                         make_mesh_from_config,
                                         make_production_mesh)
    from repro_torch.serve.sharded import CPU_BUDGET_BYTES, device_budget
    from repro_torch.sharding.spmd import ProcessMesh
    one = MeshConfig((1, 1), ("data", "model"))
    for build in (lambda: make_host_mesh((1, 1)),
                  lambda: make_mesh_from_config(one),
                  lambda: ProcessMesh(one), make_production_mesh,
                  device_budget):
        with pytest.raises(RuntimeError, match="no CUDA device is "
                           "available.*pass device='cpu'"):
            build()
    assert make_host_mesh((1, 1), device="cpu").device == torch.device("cpu")
    assert device_budget("cpu") == CPU_BUDGET_BYTES


@pytest.mark.parametrize("dispatch", ["dense", "sparse_capacity"])
def test_moe_over_two_data_ranks_equals_one_process(dispatch, two_ranks):
    got = two_ranks[0]
    mcfg, p, x, c = _moe_setup()
    out, aux, grads = _moe_run(p, mcfg, x, c, dispatch)
    tag = f"moe_{dispatch}"
    np.testing.assert_allclose(
        np.concatenate([got[0][f"{tag}/out"], got[1][f"{tag}/out"]]),
        out.numpy(), rtol=1e-5, atol=1e-6)
    for r in range(2):
        np.testing.assert_allclose(got[r][f"{tag}/aux"], aux.numpy(),
                                   rtol=1e-5)
        for k, g in grads.items():
            np.testing.assert_allclose(got[r][f"{tag}/grad/{k}"], g.numpy(),
                                       rtol=1e-5, atol=1e-6, err_msg=k)
    # without the mesh each half alone answers otherwise: the layer's
    # batch statistics are what the ranks had to share
    alone = [_moe_run(p, mcfg, x[h], c[h], dispatch)
             for h in (slice(0, B // 2), slice(B // 2, B))]
    differs = (not np.allclose(alone[0][1].numpy(), aux.numpy(), rtol=1e-5)
               if dispatch == "dense" else not np.allclose(
                   torch.cat([alone[0][0], alone[1][0]]).numpy(),
                   out.numpy(), rtol=1e-5, atol=1e-6))
    assert differs
