"""The launch plan of the grouped sub-network kernel K2, as its C entry
makes it (``csrc/mlp_plan.h``, exported as ``repro_grouped_subnet_plan``):
rows per thread R, the neurons and rows of each block, whether the
packed weights are staged, and each block's shared memory.  The header
is plain C++, so these checks build it with the host's C++ compiler and
need no card; on the card the entry feeds the plan the SM count and the
register counts of its kernels, here the tests feed it plausible ones.
The kernel itself runs only on the card (``chip_smoke.py`` holds it
against its plain version)."""
import ctypes
import shutil
import subprocess
from collections import namedtuple

import numpy as np
import pytest

from repro_torch.config import get_config
from repro_torch.kernels import build
from repro_torch.kernels.neuralut_mlp import (MAX_DEPTH, MAX_ROWS,
                                              MAX_SHARED_BYTES, MAX_WIDTH)

# The MP_* words of csrc/mlp_plan.h.
Plan = namedtuple("Plan", ("r", "g", "rows", "flags", "smem", "grid_x",
                           "grid_y", "pstride", "ppad"))
STAGED = 1
SMS = 132
# registers per thread at R = 1, 2, 4 (0: no kernel), as a card might
# report them for NMAX = 16 and 32, and the most a kernel may take
REGS = {"nmax16": (72, 120, 230), "nmax32": (130, 250, 0),
        "max": (255, 255, 255)}
JSC = [3, 16, 16, 16, 1]


@pytest.fixture(scope="module")
def lib(tmp_path_factory):
    """``csrc/mlp_plan.h`` alone, built into a shared library."""
    cxx = shutil.which("g++") or shutil.which("c++")
    assert cxx, "a host C++ compiler (g++ or c++) is needed"
    out = tmp_path_factory.mktemp("mlp_plan") / "libmlp_plan.so"
    subprocess.run([cxx, "-std=c++17", "-O1", "-shared", "-fPIC", "-x", "c++",
                    str(build.CSRC / "mlp_plan.h"), "-o", str(out)],
                   check=True, capture_output=True)
    so = ctypes.CDLL(str(out))
    so.repro_grouped_subnet_plan.argtypes = [
        ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_void_p,
        ctypes.c_int, ctypes.c_int, ctypes.c_void_p, ctypes.c_void_p,
        ctypes.c_void_p]
    so.repro_grouped_subnet_plan.restype = ctypes.c_int
    return so


def plan(lib, t, o, widths, skip, regs=REGS["nmax16"], force_r=0,
         force_g=0, force_rows=0, sms=SMS):
    """The plan, or None where the entry refuses the launch."""
    out = (ctypes.c_longlong * len(Plan._fields))()
    force = (ctypes.c_int * 3)(force_r, force_g, force_rows)
    rc = lib.repro_grouped_subnet_plan(
        t, o, len(widths) - 1, (ctypes.c_int * len(widths))(*widths), skip,
        sms, (ctypes.c_int * 3)(*regs), force, out)
    return None if rc else Plan(*out)


def _geometries():
    """Every (F, width, depth) corner the wrapper takes, each skip period
    (0 or a divisor of the depth)."""
    for depth in range(1, MAX_DEPTH + 1):
        for width in (1, 8, 16, MAX_WIDTH):
            for f in (1, 3, MAX_WIDTH):
                widths = [f] + [width] * (depth - 1) + [1]
                for skip in [0] + [s for s in range(1, depth + 1)
                                   if depth % s == 0]:
                    yield widths, skip


@pytest.mark.parametrize("regs", sorted(REGS))
def test_every_geometry_has_a_plan_within_shared_memory(lib, regs):
    n = 0
    for widths, skip in _geometries():
        for t, o in ((1, 1), (4096, 128), (16384, 128), (37, 5)):
            p = plan(lib, t, o, widths, skip, REGS[regs])
            assert p is not None, (widths, skip, t, o)
            assert p.smem <= MAX_SHARED_BYTES
            assert 1 <= p.g <= min(8, o) and p.rows % (32 * p.r) == 0
            assert p.r in (1, 2, 4) and REGS[regs][p.r.bit_length() - 1]
            n += 1
    assert n > 2000


def _kernel_coverage(p, t, o):
    """How often the kernel (csrc/neuralut_mlp.cu) computes and stores
    each (row, neuron), block by block as it maps them."""
    computed = np.zeros((t, o), int)
    stored = np.zeros((t, o), int)
    glog = max(0, (p.g - 1).bit_length())
    for bx in range(p.grid_x):
        for by in range(p.grid_y):
            o0, t0 = bx * p.g, by * p.rows
            gv, rv = min(p.g, o - o0), min(p.rows, t - t0)
            for k in range(p.g):
                for lane in range(32):
                    if k < gv:
                        for r0 in range(lane, rv, 32 * p.r):
                            for m in range(p.r):
                                if r0 + 32 * m < rv:
                                    computed[t0 + r0 + 32 * m, o0 + k] += 1
                    c, dr = lane & ((1 << glog) - 1), lane >> glog
                    if c < gv:
                        for r in range((k << (5 - glog)) + dr, rv,
                                       p.g << (5 - glog)):
                            stored[t0 + r, o0 + c] += 1
    return computed, stored


@pytest.mark.parametrize("t", [1, 31, 33, 100, 257, 1000])
@pytest.mark.parametrize("o", [1, 3, 5, 8, 13, 64])
def test_blocks_compute_and_store_every_row_and_neuron_once(lib, t, o):
    for force_r in (0, 1, 2, 4):
        p = plan(lib, t, o, JSC, 2, force_r=force_r)
        assert p.grid_x * p.g >= o > (p.grid_x - 1) * p.g
        assert p.grid_y * p.rows >= t > (p.grid_y - 1) * p.rows
        computed, stored = _kernel_coverage(p, t, o)
        assert (computed == 1).all() and (stored == 1).all()


def test_rows_per_thread_follow_the_work_and_the_registers(lib):
    cfg = get_config("neuralut-jsc-5l")
    shapes = [(cfg.table_size(i), o, [cfg.layer_fan_in(i)] + [16] * 3 + [1])
              for i, o in enumerate(cfg.layer_widths)]
    rs = []
    for t, o, widths in sorted(shapes, key=lambda s: -s[0] * s[1]):
        p = plan(lib, t, o, widths, 2)
        assert p.flags == STAGED and p.g == min(8, o)
        rs.append(p.r)
    # fewer (row, neuron) items, fewer rows per thread: layer 0's 2.1 M
    # fill every resident slot over at R = 4, the classifier layer's
    # 20 K not even at R = 2
    assert rs == sorted(rs, reverse=True) and rs[0] == 4 and rs[-1] == 1
    # more registers per thread, fewer resident slots: R stays high
    assert plan(lib, 4096, 128, JSC, 2, REGS["max"]).r == 4
    # no R = 4 kernel (NMAX = 32): never chosen, never forced
    wide = [3, 32, 32, 32, 1]
    assert plan(lib, 16384, 128, wide, 2, REGS["nmax32"]).r == 2
    assert plan(lib, 16384, 128, wide, 2, REGS["nmax32"], force_r=4) is None
    # a small grid takes smaller row tiles: one wave of blocks or more
    small, big = plan(lib, 4096, 5, JSC, 2), plan(lib, 16384, 128, JSC, 2)
    assert small.rows <= big.rows


def test_forced_tiles_and_refusals(lib):
    p = plan(lib, 4096, 128, JSC, 2, force_r=2, force_rows=192)
    assert (p.r, p.rows, p.grid_y) == (2, 192, 22)
    assert plan(lib, 4096, 128, JSC, 2, force_r=2, force_rows=96) is None
    assert plan(lib, 4096, 128, JSC, 2, force_r=3) is None
    assert plan(lib, 0, 128, JSC, 2) is None
    assert plan(lib, 4096, 0, JSC, 2) is None
    assert plan(lib, 4096, 128, [3, 16, 16, 16, 1], 3) is None  # 3 !| 4
    assert plan(lib, 4096, 128, [3] + [16] * MAX_DEPTH + [1], 0) is None
    assert plan(lib, 4096, 128, JSC, 2, regs=(0, 120, 230)) is None


def test_the_row_grid_stays_within_its_limit(lib):
    for t in (65535 * 32, 65535 * 32 + 1, MAX_ROWS):
        p = plan(lib, t, 5, JSC, 2, regs=(72, 0, 0))
        assert p.grid_y <= 65535 and p.grid_y * p.rows >= t


def test_deep_wide_geometries_spread_from_global_memory(lib):
    """The widest, deepest geometry does not fit staged at any G: one
    neuron per block, its packed row spread straight from global memory;
    the shipped geometry stays staged at 8 neurons."""
    deep = [MAX_WIDTH] * (MAX_DEPTH + 1)
    deep[-1] = 1
    p = plan(lib, 4096, 128, deep, 1, REGS["nmax32"])
    assert (p.g, p.flags) == (1, 0) and p.smem <= MAX_SHARED_BYTES
    p = plan(lib, 4096, 128, JSC, 2)
    assert (p.g, p.flags) == (8, STAGED)
    # the padded row: every sub-layer's rows (inputs + the bias row) at
    # a stride of round4(outputs)
    subs = [(3, 16), (16, 16), (16, 16), (16, 1), (3, 16), (16, 1)]
    assert p.ppad == sum((i + 1) * -(-n // 4) * 4 for i, n in subs)
    assert p.pstride == sum(i * n + n for i, n in subs)
