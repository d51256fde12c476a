"""Time a staged variant of K3's layer entry against the shipped one.

K3's ``lut_layer`` (``src/repro_torch/csrc/lut_gather.cu``) has each
thread load its connections, then its codes straight from global memory
(through L1), then its table entry.  ``probes/k3_staged.cu`` is the
other design: each block first copies its neurons' connections and its
tile's code rows into shared memory, waits at one barrier, and then each
thread looks up 1, 2, 4 or 8 rows of its neuron from there.  This script
builds that source with ``nvcc``, checks every variant bit for bit
against ``kernels.ref.lut_layer_ref`` at the five jsc-5l layer shapes and
the sweep's first NeuraLUT layer (``chip_smoke.layer_shapes``), and
times both designs in one process (profiler device ms, as
``chip_smoke._trace_ms``), direct before and after the staged variants.

    python3 probes/k3_staged.py [--batches 1,256,4096]

Needs one CUDA GPU.  Writes ``chiprun_out/k3_staged_probe.json``; the
last line of its output is the card's name and power limit.
"""
from __future__ import annotations

import argparse
import ctypes
import hashlib
import json
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
RPTS = (1, 2, 4, 8)


def build_probe():
    """``probes/k3_staged.cu`` built into a shared library (cached under
    ``build/probes`` by a hash of the source)."""
    from repro_torch.kernels import build
    src = Path(__file__).with_suffix(".cu")
    h = hashlib.sha256(src.read_bytes()).hexdigest()[:16]
    out = ROOT / "build" / "probes" / f"libk3_staged-{h}.so"
    if not out.exists():
        out.parent.mkdir(parents=True, exist_ok=True)
        subprocess.run([build._nvcc(), *build.COMPILE_FLAGS, "-shared",
                        str(src), "-o", str(out)], check=True)
    lib = ctypes.CDLL(str(out))
    lib.k3_staged_layer.argtypes = [ctypes.c_void_p] * 4 + \
        [ctypes.c_int] * 6 + [ctypes.c_void_p]
    lib.k3_staged_layer.restype = ctypes.c_int
    return lib


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--batches", default="1,256,4096")
    args = ap.parse_args()
    import torch
    if not torch.cuda.is_available():
        print("k3_staged: needs a CUDA GPU", file=sys.stderr)
        return 2
    sys.path[:0] = [str(ROOT), str(ROOT / "src")]
    import chip_smoke as cs
    from repro_torch.config import get_config
    from repro_torch.kernels import build
    from repro_torch.kernels.lut_gather import lut_layer
    from repro_torch.kernels.ref import lut_layer_ref

    card = cs.phase_environment()
    lib = build_probe()
    dev = torch.device("cuda")
    gen = torch.Generator().manual_seed(23)
    rows = []
    for name, n_in, o, f, in_bits, beta in cs.layer_shapes(
            get_config("neuralut-jsc-5l")):
        t = 1 << (in_bits * f)
        tables = torch.randint(0, 2 ** beta, (o, t), generator=gen,
                               dtype=torch.int32).to(dev)
        conn = torch.randint(0, n_in, (o, f), generator=gen,
                             dtype=torch.int32).to(dev)
        for b in (int(x) for x in args.batches.split(",")):
            codes = torch.randint(0, 2 ** in_bits, (b, n_in), generator=gen,
                                  dtype=torch.int32).to(dev)
            want = lut_layer_ref(tables, codes, conn, in_bits)

            def staged(rpt, out=torch.empty((b, o), dtype=torch.int32,
                                            device=dev)):
                rc = lib.k3_staged_layer(
                    tables.data_ptr(), codes.data_ptr(), conn.data_ptr(),
                    out.data_ptr(), b, n_in, o, f, in_bits, rpt,
                    torch.cuda.current_stream().cuda_stream)
                build.check(rc, f"k3_staged rpt {rpt}")
                return out

            def direct():
                return lut_layer(tables, codes, conn, in_bits)
            cs.require(torch.equal(direct(), want), f"{name} B={b}: "
                       "lut_layer differs from lut_layer_ref")
            row = dict(shape=name, I=n_in, O=o, F=f, in_bits=in_bits, B=b,
                       direct_ms=[cs._trace_ms(direct, 50,
                                               "lut_gather_kernel")],
                       staged_ms={})
            for rpt in RPTS:
                got = staged(rpt)
                torch.cuda.synchronize()
                cs.require(torch.equal(got, want), f"{name} B={b}: staged "
                           f"rpt {rpt} differs from lut_layer_ref")
                row["staged_ms"][rpt] = cs._trace_ms(
                    lambda: staged(rpt), 50, "k3_staged_kernel")
            row["direct_ms"].append(cs._trace_ms(direct, 50,
                                                 "lut_gather_kernel"))
            rows.append(row)
            cs.log(f"{name} (I={n_in}, O={o}, F={f}) B={b}: bit-identical; "
                   "direct " + " / ".join(cs._fmt(v) for v in
                                          row["direct_ms"])
                   + " ms; staged rows per thread " + ", ".join(
                       f"{r}: {cs._fmt(v)}" for r, v in
                       row["staged_ms"].items()) + " ms")
    out = ROOT / "chiprun_out"
    out.mkdir(exist_ok=True)
    (out / "k3_staged_probe.json").write_text(json.dumps(
        {"card": card, "rows": rows}, indent=1))
    cs.log(card)
    return 0


if __name__ == "__main__":
    sys.exit(main())
