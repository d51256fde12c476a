"""The launch plan of the per-layer lookup kernel K3, as its C entries
make it (``csrc/gather_plan.h``, exported as ``repro_lut_layer_plan``):
neurons and rows per block, one lookup per thread.  The header is
plain C++, so these checks build it with the host's C++ compiler and
need no card; the kernel itself runs only on the card
(``chip_smoke.py`` holds it against its plain version).

Beside the plan, a numpy walk of the kernel's tiles: every (row,
neuron) pair is looked up by exactly one (block, thread), and
the kernel's address arithmetic (Horner steps wrapping modulo 2^32,
then the clamp) gives ``lut_layer_ref``'s codes bit for bit.  The
kernel uses no shared memory, so no plan can exceed a block's.
"""
import ctypes
import shutil
import subprocess
from collections import namedtuple

import numpy as np
import pytest
import torch

from repro_torch.kernels import build
from repro_torch.kernels.ref import lut_layer_ref

# The GP_* words of csrc/gather_plan.h.
Plan = namedtuple("Plan", ("g", "ng", "grid_x", "grid_y"))
THREADS = 256
BATCHES = (1, 2, 7, 33, 51, 256, 1000, 4096, 65537)
WIDTHS = (1, 5, 64, 128, 255, 256, 257, 600)


@pytest.fixture(scope="module")
def lib(tmp_path_factory):
    """``csrc/gather_plan.h`` alone, built into a shared library."""
    cxx = shutil.which("g++") or shutil.which("c++")
    assert cxx, "a host C++ compiler (g++ or c++) is needed"
    out = tmp_path_factory.mktemp("gather_plan") / "libgather_plan.so"
    subprocess.run([cxx, "-std=c++17", "-O1", "-shared", "-fPIC", "-x", "c++",
                    str(build.CSRC / "gather_plan.h"), "-o", str(out)],
                   check=True, capture_output=True)
    so = ctypes.CDLL(str(out))
    so.repro_lut_layer_plan.argtypes = [ctypes.c_int] * 3 + [ctypes.c_void_p]
    so.repro_lut_layer_plan.restype = ctypes.c_int
    return so


def plan(lib, b, o, f):
    """The plan, or None where the entries refuse the launch."""
    out = (ctypes.c_longlong * len(Plan._fields))()
    rc = lib.repro_lut_layer_plan(b, o, f, out)
    return None if rc else Plan(*out)


@pytest.mark.parametrize("f", [0, 1, 2, 3, 6, 8])
def test_every_shape_has_a_plan_of_one_row_per_thread(lib, f):
    """F 0 (addresses given) to 8, every batch and width."""
    for o in WIDTHS:
        for b in BATCHES:
            p = plan(lib, b, o, f)
            assert p is not None, (b, o)
            assert p.g == min(o, THREADS) and p.ng == min(THREADS // p.g, b)
            assert 1 <= p.g * p.ng <= THREADS
            assert p.grid_x == -(-b // p.ng) and p.grid_y == -(-o // p.g)
            assert p.grid_y <= 65535


def test_the_plan_refuses_what_the_kernel_does_not_take(lib):
    assert plan(lib, 0, 128, 2) is None
    assert plan(lib, 4, 0, 2) is None
    assert plan(lib, 4, 8, -1) is None
    assert plan(lib, 4, 8, 31) is None
    assert plan(lib, 4, 8, 30) is not None
    assert plan(lib, 4096, 600, 3).grid_y == 3


def kernel_walk(p, tables, codes, conn, in_bits):
    """The kernel's tiles in numpy: block (bx, by), thread (x, y) takes row
    bx * ng + y and neuron by * G + x.  Returns the (B, O) codes and how
    often each (row, neuron) was looked up."""
    b, n_in = codes.shape
    o, t = tables.shape
    f = conn.shape[1]
    bx, by, x, y = np.meshgrid(np.arange(p.grid_x), np.arange(p.grid_y),
                               np.arange(p.g), np.arange(p.ng),
                               indexing="ij")
    row = bx * p.ng + y
    nrn = by * p.g + x
    ok = (row < b) & (nrn < o)
    row, nrn = row[ok], nrn[ok]
    hits = np.zeros((b, o), np.int64)
    np.add.at(hits, (row, nrn), 1)
    c = np.clip(conn, 0, n_in - 1)
    acc = np.zeros(row.shape, np.uint32)
    for j in range(f):                     # Horner, modulo 2^32
        acc = (acc << np.uint32(in_bits)) + codes[row, c[nrn, j]].astype(
            np.uint32)
    addr = np.clip(acc.view(np.int32), 0, t - 1)
    out = np.full((b, o), -1, np.int32)
    out[row, nrn] = tables[nrn, addr]
    return out, hits


@pytest.mark.parametrize("n_in,o,f,in_bits", [
    (16, 128, 2, 7), (128, 128, 3, 4), (16, 64, 4, 2), (128, 64, 3, 4),
    (64, 5, 3, 4), (196, 64, 6, 2),
    (40, 300, 3, 3),         # two neuron groups, the second ragged
    (30, 9, 10, 1),          # F > 8
])
@pytest.mark.parametrize("b", [1, 7, 33, 256, 1000])
def test_the_kernel_walk_covers_every_lookup_once_and_is_lut_layer_ref(
        lib, b, n_in, o, f, in_bits):
    rng = np.random.default_rng(b + o)
    t = 1 << (in_bits * f)
    tables = rng.integers(0, 16, (o, t)).astype(np.int32)
    conn = rng.integers(0, n_in, (o, f)).astype(np.int32)
    codes = rng.integers(-2, 2 ** in_bits + 2, (b, n_in)).astype(np.int32)
    got, hits = kernel_walk(plan(lib, b, o, f), tables, codes, conn, in_bits)
    assert (hits == 1).all()
    want = lut_layer_ref(torch.as_tensor(tables), torch.as_tensor(codes),
                         torch.as_tensor(conn), in_bits)
    assert np.array_equal(got, want.numpy())
