"""The launch plan of the training kernels K4 and K5, as their C entries
make it (``csrc/train_plan.h``, read through ``repro_subnet_train_plan``
and ``kernels.neuralut_grad.plan_train_launch``): which rows and neurons
each block takes, the order in which K5 sums its row tiles, each block's
shared memory and K5's global scratch.  The header is plain C++, so these
checks build it with the host's C++ compiler and need no card; the
kernels themselves run only on the card (``chip_smoke.py`` holds them
against their plain versions)."""
import ctypes
import shutil
import subprocess

import numpy as np
import pytest
import torch

from repro_torch.config import get_config
from repro_torch.kernels import build
from repro_torch.kernels.neuralut_grad import (ACC_GLOBAL, STAGED,
                                               plan_train_launch)
from repro_torch.kernels.neuralut_mlp import (MAX_SHARED_BYTES,
                                              pack_subnet_weights)

ROWS = 32          # rows per block (REPRO_TRAIN_ROWS)
MAX_CLUSTER = 8    # the portable cluster size
JSC = [3, 16, 16, 16, 1]


@pytest.fixture(scope="module")
def lib(tmp_path_factory):
    """``csrc/train_plan.h`` alone, built into a shared library."""
    cxx = shutil.which("g++") or shutil.which("c++")
    assert cxx, "a host C++ compiler (g++ or c++) is needed"
    out = tmp_path_factory.mktemp("train_plan") / "libtrain_plan.so"
    subprocess.run([cxx, "-std=c++17", "-O1", "-shared", "-fPIC", "-x", "c++",
                    str(build.CSRC / "train_plan.h"), "-o", str(out)],
                   check=True, capture_output=True)
    return ctypes.CDLL(str(out))


def _widths(cfg, i):
    return [cfg.layer_fan_in(i)] + [cfg.width] * (cfg.depth - 1) + [1]


def _pstride(widths, skip):
    """The packed row's length, from pack_subnet_weights itself."""
    nl = len(widths) - 1
    lw = [torch.zeros(1, widths[i], widths[i + 1]) for i in range(nl)]
    lb = [torch.zeros(1, widths[i + 1]) for i in range(nl)]
    chunks = range(nl // skip) if skip else ()
    sw = [torch.zeros(1, widths[c * skip], widths[(c + 1) * skip])
          for c in chunks]
    sb = [torch.zeros(1, widths[(c + 1) * skip]) for c in chunks]
    return pack_subnet_weights(lw, lb, sw, sb).shape[-1]


@pytest.mark.parametrize("t", [1, 31, 32, 37, 256, 257, 1000, 2049])
@pytest.mark.parametrize("o", [1, 5, 128])
@pytest.mark.parametrize("seeds", [1, 3])
def test_blocks_cover_every_row_neuron_and_seed_once(lib, t, o, seeds):
    """The blocks of both launches, mapped as neuralut_grad.cu maps them
    (K4: grid (ceil(O / G), tiles, S); K5: grid (ceil(O / G), cluster,
    S), rank c walking row tiles c, c + C, ...), cover every (s, t, o)
    once, and every K5 rank has a tile (its sum starts at its first)."""
    plan = plan_train_launch(seeds, t, o, JSC, 2, lib=lib)
    assert plan.tiles == -(-t // ROWS)
    assert 1 <= plan.cluster <= min(MAX_CLUSTER, plan.tiles)
    for g in (plan.fwd_group, plan.bwd_group):
        assert 1 <= g and g * ROWS <= 256
    k4 = np.zeros((seeds, t, o), dtype=int)
    for s in range(seeds):
        for x in range(-(-o // plan.fwd_group)):
            for y in range(plan.tiles):
                k4[s, y * ROWS:(y + 1) * ROWS,
                   x * plan.fwd_group:(x + 1) * plan.fwd_group] += 1
    assert (k4 == 1).all()
    k5 = np.zeros((seeds, t, o), dtype=int)
    for s in range(seeds):
        for x in range(-(-o // plan.bwd_group)):
            for rank in range(plan.cluster):
                tiles = list(range(rank, plan.tiles, plan.cluster))
                assert tiles
                for y in tiles:
                    k5[s, y * ROWS:(y + 1) * ROWS,
                       x * plan.bwd_group:(x + 1) * plan.bwd_group] += 1
    assert (k5 == 1).all()


@pytest.mark.parametrize("t", [1, 37, 256, 1000])
def test_summation_order_depends_on_rows_alone(lib, t):
    """The row tiles and K5's cluster, which fix the order of every sum
    over rows, are the same for every S, O and geometry at one T, the
    geometries whose block sums live in global scratch included."""
    geoms = [(JSC, 2), (JSC, 0), ([6, 16, 16, 16, 1], 2),
             ([3, 32, 32, 32, 1], 2), ([2, 8, 1], 1),
             ([32] + [32] * 15 + [1], 1), ([32] * 9, 1)]
    plans = [plan_train_launch(s, t, o, w, sk, lib=lib)
             for w, sk in geoms for s in (1, 3) for o in (1, 5, 128)]
    assert len({(p.tiles, p.cluster) for p in plans}) == 1
    assert {p.bwd_flags & ACC_GLOBAL for p in plans} == {0, ACC_GLOBAL}


@pytest.mark.parametrize("arch,reduced", [
    ("neuralut-jsc-5l", False), ("neuralut-jsc-5l", True),
    ("neuralut-jsc-2l", False), ("neuralut-jsc-2l", True),
    ("neuralut-hdr-5l", False), ("neuralut-hdr-5l", True)])
def test_shipped_geometries_fit_in_shared_memory(lib, arch, reduced):
    """Every shipped layer takes the preferred tiles: 4 neurons per K4
    block, 2 per K5 block, rows staged, K5's sum in shared memory."""
    cfg = get_config(arch, reduced=reduced)
    for i in range(cfg.num_layers):
        w = _widths(cfg, i)
        plan = plan_train_launch(1, 256, cfg.layer_widths[i], w, cfg.skip,
                                 lib=lib)
        assert (plan.fwd_group, plan.fwd_flags) == (4, STAGED)
        assert (plan.bwd_group, plan.bwd_flags) == (2, STAGED)
        assert plan.scratch == 0
        assert plan.smem_fwd <= MAX_SHARED_BYTES
        assert plan.smem_bwd <= MAX_SHARED_BYTES
        assert plan.pstride == _pstride(w, cfg.skip)


@pytest.mark.parametrize("depth", range(1, 17))
def test_every_geometry_the_entries_take_fits(lib, depth):
    """Width 32 everywhere (F and the output too), every skip period the
    entries take: a plan within the card's shared memory; where not even
    one staged neuron fits, the rows are spread from global memory, and
    where K5's sum does not fit either, it goes to global scratch of S x
    ceil(O / G) x C slices of G x pstride floats and a spare word per
    warp, padded to 4."""
    for skip in [0] + [k for k in range(1, depth + 1) if depth % k == 0]:
        w = [32] * (depth + 1)
        plan = plan_train_launch(3, 1000, 5, w, skip, lib=lib)
        assert plan.smem_fwd <= MAX_SHARED_BYTES
        assert plan.smem_bwd <= MAX_SHARED_BYTES
        assert plan.pstride == _pstride(w, skip)
        g = plan.bwd_group
        if plan.bwd_flags & ACC_GLOBAL:
            assert g == 1 and not plan.bwd_flags & STAGED
            assert plan.scratch == 3 * 5 * plan.cluster * (
                g * plan.pstride + 4)
        else:
            assert plan.scratch == 0
        if not plan.fwd_flags & STAGED:
            assert plan.fwd_group == 1
    # the deepest geometry takes every fallback
    deep = plan_train_launch(1, 256, 128, [32] * 17, 1, lib=lib)
    assert (deep.fwd_group, deep.fwd_flags) == (1, 0)
    assert (deep.bwd_group, deep.bwd_flags) == (1, ACC_GLOBAL)


@pytest.mark.parametrize("seeds,t,o,widths,skip", [
    (1, 256, 128, [33, 16, 1], 0),          # a width past 32
    (1, 256, 128, [3] + [16] * 16 + [1], 0),  # depth 17
    (1, 256, 128, JSC, 3),                  # skip not a divisor of 4
    (1, 256, 128, [3, 0, 1], 0),            # an empty layer
    (0, 256, 128, JSC, 2), (1, 0, 128, JSC, 2), (1, 256, 0, JSC, 2)])
def test_what_the_entries_refuse(lib, seeds, t, o, widths, skip):
    with pytest.raises(ValueError, match="take no launch"):
        plan_train_launch(seeds, t, o, widths, skip, lib=lib)
