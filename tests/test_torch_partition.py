"""Port parity of the sharding rules (``repro_torch.sharding.partition``)
against the reference's ``repro.sharding.partition``, key for key.

Over the ten LM archs of the reference's dry run (listed here: importing
``repro.launch.dryrun`` would set its 512-device ``XLA_FLAGS``), the
production meshes ``SINGLE_POD`` (16, 16) and ``MULTI_POD`` (2, 16, 16)
and the small meshes (2, 1), (1, 2), (2, 2) and (2, 2, 2), and the four
shapes of its ``SHAPE_ORDER``:

* ``param_partition`` over each package's ``api.param_spec(cfg,
  model_axis=mesh.shape[-1])`` (specs only, nothing drawn), FSDP on and
  off;
* ``batch_partition`` over ``input_specs`` (train / prefill) and over
  the decode token, ``cache_partition`` over ``decode_state_spec``'s
  state (decode).

A reference ``PartitionSpec`` is compared as a tuple with the port's
(both keep a one-name tuple as the name).  Exact: these are names.
"""
import jax
import pytest
from jax.sharding import PartitionSpec as JP

from repro.config import MeshConfig as JMesh
from repro.config import SHAPES as J_SHAPES
from repro.config import get_config as j_get_config
from repro.models import api as JA
from repro.sharding import partition as JPart
from repro_torch.config import SHAPES, MeshConfig, get_config
from repro_torch.models import api
from repro_torch.sharding import (PartitionSpec, batch_partition,
                                  cache_partition, named, param_partition)
from repro_torch.sharding.partition import map_with_path, placements

LM_ARCHS = (
    "deepseek-v2-lite-16b", "qwen2-moe-a2.7b", "xlstm-350m",
    "jamba-v0.1-52b", "whisper-small", "qwen2-vl-72b", "granite-34b",
    "gemma3-12b", "llama3-8b", "yi-9b",
)
SHAPE_ORDER = ("train_4k", "prefill_32k", "decode_32k", "long_500k")
MESHES = {
    "single_pod": ((16, 16), ("data", "model")),
    "multi_pod": ((2, 16, 16), ("pod", "data", "model")),
    "2x1": ((2, 1), ("data", "model")),
    "1x2": ((1, 2), ("data", "model")),
    "2x2": ((2, 2), ("data", "model")),
    "2x2x2": ((2, 2, 2), ("pod", "data", "model")),
}


def _meshes(name):
    shape, axes = MESHES[name]
    return MeshConfig(shape, axes), JMesh(shape, axes)


def _ref_flat(tree):
    out = {}
    for path, spec in jax.tree_util.tree_flatten_with_path(
            tree, is_leaf=lambda x: isinstance(x, JP))[0]:
        key = "/".join(str(p.key) if hasattr(p, "key") else f"[{p.idx}]"
                       for p in path)
        out[key] = tuple(spec)
    return out


def _port_flat(tree):
    out = {}

    def put(path, spec):
        assert isinstance(spec, PartitionSpec), (path, spec)
        out["/".join(path)] = tuple(spec)
    map_with_path(put, tree)
    return out


def _same(got, want, what):
    assert got.keys() == want.keys(), what
    bad = {k: (got[k], want[k]) for k in want if got[k] != want[k]}
    assert not bad, (what, list(bad.items())[:5])
    return len(want)


def _param_specs(arch, mesh_name, fsdp=True):
    mcfg, jmcfg = _meshes(mesh_name)
    cfg, jcfg = get_config(arch), j_get_config(arch)
    got = param_partition(cfg, api.param_spec(cfg, model_axis=mcfg.shape[-1]),
                          mcfg, fsdp=fsdp)
    want = JPart.param_partition(
        jcfg, JA.param_spec(jcfg, model_axis=jmcfg.shape[-1]), jmcfg,
        fsdp=fsdp)
    return _same(_port_flat(got), _ref_flat(want), (arch, mesh_name, fsdp))


@pytest.mark.parametrize("mesh_name", list(MESHES))
def test_param_partition_matches_reference(mesh_name):
    n = sum(_param_specs(a, mesh_name) for a in LM_ARCHS)
    print(f"{mesh_name}: {n} param specs equal over {len(LM_ARCHS)} archs")
    assert n > 0


def test_production_meshes_hold_all_804_param_specs():
    n = sum(_param_specs(a, m) for m in ("single_pod", "multi_pod")
            for a in LM_ARCHS)
    print(f"production meshes: {n} param specs equal")
    assert n == 804


@pytest.mark.parametrize("mesh_name", ["single_pod", "2x2x2"])
def test_param_partition_without_fsdp(mesh_name):
    n = sum(_param_specs(a, mesh_name, fsdp=False) for a in LM_ARCHS)
    print(f"{mesh_name} without FSDP: {n} param specs equal")
    # no leaf is split over a data axis
    mcfg = _meshes(mesh_name)[0]
    for arch in LM_ARCHS:
        cfg = get_config(arch)
        specs = _port_flat(param_partition(
            cfg, api.param_spec(cfg, model_axis=mcfg.shape[-1]), mcfg,
            fsdp=False))
        assert all(e in (None, "model") for s in specs.values() for e in s)


@pytest.mark.parametrize("mesh_name", list(MESHES))
def test_batch_and_cache_partition_match_reference(mesh_name):
    mcfg, jmcfg = _meshes(mesh_name)
    counts = {"batch": 0, "cache": 0}
    for arch in LM_ARCHS:
        cfg, jcfg = get_config(arch), j_get_config(arch)
        for sh in SHAPE_ORDER:
            shape, jshape = SHAPES[sh], J_SHAPES[sh]
            ins, jins = api.input_specs(cfg, shape), JA.input_specs(jcfg,
                                                                    jshape)
            what = (arch, sh, mesh_name)
            if shape.kind == "decode":
                counts["cache"] += _same(
                    _port_flat(cache_partition(cfg, shape, mcfg,
                                               ins["state"])),
                    _ref_flat(JPart.cache_partition(jcfg, jshape, jmcfg,
                                                    jins["state"])), what)
                ins, jins = {"token": ins["token"]}, {"token": jins["token"]}
            counts["batch"] += _same(
                _port_flat(batch_partition(cfg, shape, mcfg, ins)),
                _ref_flat(JPart.batch_partition(jcfg, jshape, jmcfg, jins)),
                what)
    print(f"{mesh_name}: {counts['batch']} batch and {counts['cache']} "
          "decode-cache specs equal")
    assert counts["batch"] > 0 and counts["cache"] > 0


def test_partition_spec_and_named_placements():
    from torch.distributed.tensor import Replicate, Shard
    assert PartitionSpec(("data",), None) == ("data", None)
    assert PartitionSpec(("pod", "data"), "model") == (("pod", "data"),
                                                       "model")
    assert tuple(JP(("data",), None)) == ("data", None)
    axes = ("pod", "data", "model")
    assert placements(axes, PartitionSpec(("pod", "data"), "model")) == (
        Shard(0), Shard(0), Shard(1))
    assert placements(axes, PartitionSpec(None, None)) == (
        Replicate(), Replicate(), Replicate())

    class Mesh:
        axes = ("data", "model")
    tree = {"a": PartitionSpec("model", None), "b": [PartitionSpec()]}
    sh = named(Mesh(), tree)
    assert sh["a"].spec == ("model", None) and sh["a"].mesh.axes == (
        "data", "model")
    assert sh["a"].placements == (Replicate(), Shard(0))
    assert sh["b"][0].placements == (Replicate(), Replicate())
