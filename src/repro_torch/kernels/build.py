"""Build and load the port's CUDA kernels.

Every ``csrc/*.cu`` is compiled for ``sm_90a`` by ``nvcc`` — one
process per source, all started together — and linked into one shared
library with a plain C interface, loaded with ``ctypes``.  The build
happens at first use, into ``build/repro_torch/`` at the root of the
checkout, under a name that hashes the sources and flags, so an edited
source rebuilds and an unchanged one loads at once.  Nothing is built
when the module is imported.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import tempfile
import threading
from pathlib import Path
from typing import Optional

CSRC = Path(__file__).resolve().parent.parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[3] / "build" / "repro_torch"
ARCH_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a")
COMPILE_FLAGS = ARCH_FLAGS + ("-std=c++17", "-O3", "-Xcompiler", "-fPIC",
                              "-Xptxas", "-v")

_lock = threading.Lock()
_count_lock = threading.Lock()
_lib: Optional[ctypes.CDLL] = None
# ptxas's per-kernel register / shared-memory / spill report of the
# last build in this process ("" when the library was already built).
build_log = ""

_P = ctypes.c_void_p
_I = ctypes.c_int


def _nvcc() -> str:
    from torch.utils.cpp_extension import CUDA_HOME
    cand = [os.path.join(CUDA_HOME, "bin", "nvcc")] if CUDA_HOME else []
    cand.append(shutil.which("nvcc") or "")
    for c in cand:
        if c and os.path.exists(c):
            return c
    raise RuntimeError("nvcc not found (set CUDA_HOME or put nvcc on "
                       "PATH); the CUDA kernels are compiled at first use")


def _sources():
    return sorted(CSRC.glob("*.cu"))


def library_path() -> Path:
    """Where the library for the current sources and flags lives."""
    h = hashlib.sha256(" ".join(COMPILE_FLAGS).encode())
    for src in _sources() + sorted(CSRC.glob("*.cuh")) + sorted(
            CSRC.glob("*.h")):
        h.update(src.name.encode())
        h.update(src.read_bytes())
    return BUILD_DIR / f"librepro_torch_kernels-{h.hexdigest()[:16]}.so"


def _build(out: Path) -> str:
    nvcc = _nvcc()
    out.parent.mkdir(parents=True, exist_ok=True)
    with tempfile.TemporaryDirectory(dir=out.parent) as tmp:
        procs = []
        for src in _sources():
            obj = os.path.join(tmp, src.stem + ".o")
            procs.append((src, obj, subprocess.Popen(
                [nvcc, *COMPILE_FLAGS, "-I", str(CSRC), "-c", str(src),
                 "-o", obj],
                stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
                text=True)))
        logs, failed = [], []
        for src, _obj, p in procs:
            text, _ = p.communicate()
            logs.append(f"--- {src.name}\n{text}")
            if p.returncode:
                failed.append(src.name)
        if failed:
            raise RuntimeError(f"nvcc failed on {failed}:\n"
                               + "\n".join(logs))
        tmp_lib = os.path.join(tmp, out.name)
        link = subprocess.run(
            [nvcc, *ARCH_FLAGS, "-shared", "-o", tmp_lib,
             *[obj for _s, obj, _p in procs]],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
        if link.returncode:
            raise RuntimeError(f"nvcc link failed:\n{link.stdout}")
        os.replace(tmp_lib, out)  # atomic: a reader never sees half a file
    return "\n".join(logs)


def _bind(lib: ctypes.CDLL) -> ctypes.CDLL:
    lib.repro_lut_cascade.argtypes = [
        _I, _P, _I, _I,        # device, codes, batch, in_width
        _I, _P, _I,            # nodes, program, its 16-byte chunks
        _I, _I,                # largest arity, widest node
        _I, _I, _P, _P]        # rows per block, row pitch, out, stream
    lib.repro_lut_cascade.restype = _I
    lib.repro_lut_gather.argtypes = [
        _I, _P, _P, _P,        # device, tables, addr, out
        _I, _I, _I, _P]        # B, O, T, stream
    lib.repro_lut_gather.restype = _I
    lib.repro_lut_layer.argtypes = [
        _I, _P, _P, _P, _P,    # device, tables, codes, conn, out
        _I, _I, _I, _I, _I,    # B, I, O, F, in_bits
        _P]                    # stream
    lib.repro_lut_layer.restype = _I
    lib.repro_lut_layer_plan.argtypes = [
        _I, _I, _I, _P]        # B, O, F, out (long long[])
    lib.repro_lut_layer_plan.restype = _I
    lib.repro_grouped_subnet.argtypes = [
        _I, _P, _P, _P,        # device, xg, packed weights, out
        _I, _I, _I,            # T, O, params per neuron
        _I, _P, _I,            # nlayers, widths, skip
        _P, _P]                # forced tile (int[3] or NULL), stream
    lib.repro_grouped_subnet.restype = _I
    lib.repro_grouped_subnet_launch_plan.argtypes = [
        _I, _I, _I,            # device, T, O
        _I, _P, _I,            # nlayers, widths, skip
        _P, _P]                # forced tile, out (long long[])
    lib.repro_grouped_subnet_launch_plan.restype = _I
    lib.repro_grouped_subnet_plan.argtypes = [
        _I, _I, _I, _P, _I,    # T, O, nlayers, widths, skip
        _I, _P,                # SMs, registers at R = 1, 2, 4
        _P, _P]                # forced tile, out (long long[])
    lib.repro_grouped_subnet_plan.restype = _I
    lib.repro_subnet_train_fwd.argtypes = [
        _I, _P, _P, _P, _P,    # device, xg, packed weights, out, acts
        _I, _I, _I, _I,        # seeds, T, O, params per neuron
        _I, _P, _I, _P]        # nlayers, widths, skip, stream
    lib.repro_subnet_train_fwd.restype = _I
    lib.repro_subnet_train_bwd.argtypes = [
        _I, _P, _P, _P, _P,    # device, g, xg, acts, packed weights
        _P, _P,                # dx, grads
        _P, ctypes.c_longlong,  # scratch, its floats
        _I, _I, _I, _I,        # seeds, T, O, params per neuron
        _I, _P, _I, _P]        # nlayers, widths, skip, stream
    lib.repro_subnet_train_bwd.restype = _I
    lib.repro_subnet_train_plan.argtypes = [
        _I, _I, _I,            # seeds, T, O
        _I, _P, _I, _P]        # nlayers, widths, skip, out (long long[])
    lib.repro_subnet_train_plan.restype = _I
    lib.repro_launch_floor.argtypes = [_I, _P]   # device, stream
    lib.repro_launch_floor.restype = _I
    lib.repro_cuda_error_string.argtypes = [_I]
    lib.repro_cuda_error_string.restype = ctypes.c_char_p
    return lib


def load_library() -> ctypes.CDLL:
    """The kernels' shared library, built on first use."""
    global _lib, build_log
    with _lock:
        if _lib is None:
            path = library_path()
            if not path.exists():
                build_log = _build(path)
            _lib = _bind(ctypes.CDLL(str(path)))
        return _lib


def count_launch(wrapper) -> None:
    """Add one to ``wrapper.launches``, the launch count of a kernel
    wrapper.  Serving executors launch from several threads at once, and
    ``+= 1`` on an attribute is a read, an add and a write that two
    threads can interleave, so the add holds a lock."""
    with _count_lock:
        wrapper.launches += 1


def check(rc: int, what: str) -> None:
    """Raise when a launcher returned a CUDA error code."""
    if rc:
        msg = load_library().repro_cuda_error_string(rc).decode()
        raise RuntimeError(f"{what}: CUDA error {rc} ({msg})")
