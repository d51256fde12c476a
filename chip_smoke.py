#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (``src/repro_torch``) on one GPU.

    python3 chip_smoke.py

Builds the CUDA kernels from ``src/repro_torch/csrc``, holds each kernel
against its plain PyTorch version at the shapes of ``neuralut-jsc-5l``,
then drives the port's paths at full width:

* serving: seeded init and input calibration, truth-table conversion
  through the grouped sub-network kernel, a serving bundle, and
  ``LUTServeEngine`` answering mixed-size requests through the
  LUT-cascade kernel;
* per-layer serving: the same bundle and requests through
  ``LUTServeEngine(fused=False)``, one per-layer lookup kernel launch
  per layer and batch, against the fused route (latencies in turns);
* training: ``train_neuralut`` for a few epochs with every step's
  grouped sub-network through the training forward and backward
  kernels, then conversion, bundle and engine as above; plus the first
  step's gradients against the plain autograd route, a bit-identical
  rerun of ten steps, and the device's busy share of an epoch; before
  it the training kernels beyond the training batch (B 1 / 37 / 256 /
  1000 x O 1 / 5 / 128 x S 1 / 3 on six sub-network geometries, two of
  them deep enough to take every fallback of the launch plan; reruns
  and seed-axis members bit for bit);
* the seed ensemble: ``train_neuralut_ensemble`` of 4 seeds, one
  seed-axis launch of each training kernel per layer per step, the
  best member converted and served; the seed-axis kernels against
  separate single-seed launches, a bit-identical rerun of ten ensemble
  steps, and steps/s and the busy share at S = 4 beside S = 1;
* graph serving: the PolyLUT-Add LUT graph ``polylut-add-jsc-5l`` (adder
  trees of two branches) seeded, calibrated, converted through the
  grouped sub-network kernel once per branch, bundled and served through
  the LUT-cascade kernel's DAG schedule, one launch per batch; that
  schedule is first held against the plain DAG cascade at the model's
  operands, on a diamond and on seeded random DAGs;
* graph training: ``train_neuralut`` on ``polylut-add-jsc-5l``, one call
  of each training kernel per branch per step (7), each one kernel,
  converted once per branch and served on the DAG schedule; one step's
  gradients against the plain autograd route; then 4 seeds together,
  still 7 seed-axis calls of each per step, the best member served;
  steps/s, the busy share and K4/K5 device ms per step; before it the
  training kernels at the graph's branch widths (O 64, 32 and 5);
* the LogicNets (``linear``) and PolyLUT (``poly``) neuron kinds on the
  ``neuralut-jsc-5l`` chain: trained on the plain route (they launch no
  sub-network kernel), converted and served through the LUT-cascade
  kernel;
* the Pareto sweep (``repro_torch.sweep``) at the paper grid's full
  widths (three LogicNets and three NeuraLUT geometries, 196 pooled
  synthetic-MNIST inputs, F 6, beta 2; 3 seeds, 3 epochs where the
  launcher's default is 10): four stacked group runs, one K4 and one K5
  launch per NeuraLUT layer per step for all units of a group (none for
  LogicNets), every point's best member converted (K2), saved to a
  registry, loaded back and served through the LUT-cascade kernel with
  0 mismatches; each NeuraLUT point of the padded group alone in a
  group equal to the per-point ensemble bit for bit, the padded group's
  first gradients, one step and whole run against it, a rerun and a
  resume bit for bit, the launcher once; before
  it K4/K5 over the sweep's unit axes (U = 3 and 6) against single-unit
  launches, and K2 at the sweep's conversion shapes;
* the serving stack, right after graph serving, over the bundles of
  the two serving paths: a ``TableRegistry`` round trip (verified,
  bit-identical), a corrupted version refused and quarantined by the
  ``IntegrityProbe``, ``LUTServeEngine`` with two replicas on the card,
  chaos (eviction and redispatch, ``DispatchFailed``,
  ``DeadlineExceeded``), ``MultiTenantEngine`` (shedding, a committed
  and a rolled-back hot swap) and ``launch.serve`` against the registry;
  latency at replicas 1 and 2 and the registry's seconds, in turns.
  Before and after it, a probe of the profiler: how many traces of a
  training kernel's calls come back with records missing.

The launch counts are set to 0 just before each path and read just
after it.  Every phase that fails stops the run with a non-zero exit;
there is no CPU fallback.  Output, one line per finding, then:

    {"kernels": [...]}         per kernel: launches on the main path,
                               max error, kernel / plain / bound ms
    {"ok": true, "device": {"platform": "gpu", "kind": ..., "count": 1}}

Before the paths: an empty kernel's device time (the launch floor), and
where a warm conversion spends its time, stage by stage.  A narrower run
for working on the kernels:

    python3 chip_smoke.py --turns PARENT    K2's, K1's, K3's, K4's and K5's
                                            device ms and the per-layer
                                            route's latency in turns with
                                            the checkout at PARENT

Imports nothing of JAX and nothing of the JAX package.
"""
from __future__ import annotations

import itertools
import json
import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent
SRC = ROOT / "src"

# NVIDIA H100 SXM data-sheet peaks (dense): HBM3 bandwidth and fp32
# outside the tensor cores.  The cascade's integer ops are counted at
# the same 32-bit rate.
PEAK_BYTES_S = 3.35e12
PEAK_FP32_S = 67e12

K2_ATOL = K2_RTOL = 1e-5   # fp32 summation order / FMA contraction
K4_ATOL = K4_RTOL = 1e-5   # the same function as K2, plus stores
# fp32 gradients summed in another order: the reference's own gradient
# tolerance (tests/test_train_kernel.py).
K5_RTOL, K5_ATOL = 2e-4, 3e-5
TRAIN_B = 256              # the trainer's batch
TRAIN_EPOCHS = 3           # 3 x 78 = 234 steps on 20,000 rows
RERUN_STEPS = 10
CASCADE_BATCHES = (1, 8, 64, 256, 1000, 4096)
GATHER_BATCHES = CASCADE_BATCHES    # K3; 1000 fills no 256-thread block
GRAPH_ARCH = "polylut-add-jsc-5l"   # PolyLUT-Add, arXiv:2406.04910
DAG_SEEDS = (0, 1, 2, 3)            # random DAGs of each generator
DAG_CASE_BATCHES = (1, 37, 300)
ENSEMBLE_SEEDS = (0, 1, 2, 3)
ENSEMBLE_EPOCHS = 2                 # 2 x 78 = 156 steps of 4 seeds
GRAPH_TRAIN_EPOCHS = 2              # polylut-add-jsc-5l, 156 steps
GRAPH_ENSEMBLE_SEEDS = (0, 1, 2, 3)
GRAPH_ENSEMBLE_EPOCHS = 1           # 78 steps of 4 seeds
GRAPH_BRANCH_O = (64, 32, 5)        # the widths of its branches
GRAPH_BRANCH_S = (1, 4)
KIND_EPOCHS = 1                     # linear and poly on the jsc-5l chain
TILE_SWEEP = (1, 2, 4, 8, 16, 32)   # K1 rows per block
# The Pareto sweep (paper Figs. 6-7 grid, repro_torch.sweep) on
# mnist_pooled 6000 / 2000 rows (launch.sweep's defaults), seeds 0-2,
# batch 256: 23 steps per epoch.  Depth cut: 3 epochs where the
# launcher's default is 10.
SWEEP_SEEDS = (0, 1, 2)
SWEEP_EPOCHS = 3
SWEEP_ROWS = (6000, 2000)
SWEEP_LR = 3e-3                     # run_pareto_sweep's default
# The padded NeuraLUT group (U = 6) against train_neuralut_ensemble per
# point (S = 3).  A one-point group and the ensemble run one code path
# and must agree bit for bit.  Across unit counts (on the card) and
# padded lanes a unit's float32 reductions (BN's sums over the batch, a
# per-lane quantizer scale's gradient) round in another order; Adam
# turns that rounding on the leaves whose exact gradient is 0 (the
# biases feeding BN) into lr-sized steps, which BN then subtracts, and
# the signal drifts slowly after them.  So the whole run is held
# at limits set from PR 19's card readings over 69 steps (four runs):
# histories up to 6.0e-3, params where |grad| > 1e-5 and BN variances up
# to 2.3e-3, the other params up to 2.3e-2 and the BN means up to 4.7e-2.
SWEEP_HIST_ATOL = 1.5e-2            # loss, test_acc, test_acc_q
SWEEP_SIGNAL_ATOL = 1e-2            # params where |grad| > 1e-5, BN var
SWEEP_ZERO_ATOL = 2e-1              # the other params and the BN means
# K4/K5 at the sweep's shapes (F 6, sub-network 16/16/16/16, skip 2):
# the NeuraLUT groups' unit axes and layer widths
SWEEP_UNIT_SHAPES = ((3, (64, 32, 10)), (6, (48, 10)))
SWEEP_K2_O = (64, 48, 32, 10)       # conversion widths, 4096 rows each
K2_SWEEP_R = (1, 2, 4)              # K2 rows per thread
K2_SWEEP_G = (4, 8)                 # K2 neurons per block
K2_SWEEP_ROWS = (32, 64, 128, 256, 512, 1024)   # K2 rows per block
SWEEP_BATCHES = (8, 64, 256, 4096)  # the engine's buckets > 1, bench size
SECTOR_BYTES = 32          # the smallest global-memory access of the card
HEADLINE_B = 256           # the engine's largest bucket


def log(msg: str) -> None:
    print(msg, flush=True)


def require(cond: bool, msg: str) -> None:
    if not cond:
        raise RuntimeError(f"FAILED: {msg}")


def call_ms(fn, reps: int) -> float:
    """Mean ms of one call over ``reps`` back-to-back calls, from CUDA
    events after one warm-up call: what a caller waits, host work
    between launches included."""
    import torch
    fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / reps


def _trace(fn, reps: int, kernel=""):
    """One ``torch.profiler`` trace of ``reps`` calls of ``fn`` after a
    warm-up call: the device us of the CUDA kernels whose name holds
    ``kernel`` (a name or a tuple of names; "" = every kernel the call
    launches), and the trace's device activities (kernels, memsets,
    copies) of such names, {name: count}."""
    import collections
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    names = (kernel,) if isinstance(kernel, str) else kernel
    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(reps):
            fn()
        torch.cuda.synchronize()
    us = sum(e.self_device_time_total for e in prof.key_averages()
             if any(k in e.key for k in names))
    return us, collections.Counter(
        e.name for e in prof.events() if e.device_type == DeviceType.CUDA
        and any(k in e.name for k in names))


def device_ms(fn, reps: int, kernel=""):
    """Mean device ms per call of the CUDA kernels whose name holds
    ``kernel`` (as for ``_trace``), from one trace of ``reps`` calls;
    None when the trace shows no device time."""
    us, _ = _trace(fn, reps, kernel)
    return us / reps / 1e3 if us > 0 else None


def _whole(records, reps: int) -> bool:
    """Whether a trace's {name: count} can be whole: every call launches
    the same device activities, so each count is a multiple of reps."""
    return bool(records) and all(v % reps == 0 for v in records.values())


def _trace_ms(fn, reps, kernel="", traces: int = 4):
    """Mean device ms per call of the CUDA kernels whose name holds
    ``kernel`` (as for ``_trace``).  A trace now and then loses records
    (once all of them), never adds one: the fullest whole trace
    (``_whole``) of two, and of up to ``traces`` while none was whole;
    None when none was.  Never a call time in place of a device time."""
    best = (0, 0.0)
    for n in range(traces):
        us, records = _trace(fn, reps, kernel)
        if _whole(records, reps):
            best = max(best, (sum(records.values()), us))
        if n >= 1 and best[0]:
            break
    return best[1] / reps / 1e3 if best[0] else None


def activities_per_call(fn, reps: int = 5, traces: int = 4):
    """Device activities (kernels, memsets, copies) per call of ``fn`` by
    name, {name: count per call}: of two traces of ``reps`` calls, and of
    up to ``traces`` while the fuller one is not whole (``_whole``), the
    fuller one."""
    best = {}
    for n in range(traces):
        _, records = _trace(fn, reps)
        if sum(records.values()) > sum(best.values()):
            best = records
        if n >= 1 and _whole(best, reps):
            break
    return {k: v / reps for k, v in best.items()}


def kernels_per_call(fn, reps: int = 5, traces: int = 4) -> float:
    """Device activities per call of ``fn``, whatever their names
    (``activities_per_call``)."""
    return sum(activities_per_call(fn, reps, traces).values())


def timings(kern, plain, kernel: str, reps: int, plain_reps: int):
    """Kernel and plain-version times: device time from the profiler
    (``_trace_ms``) where its traces have it, CUDA-event call time
    always."""
    out = {"call_ms": call_ms(kern, reps),
           "plain_call_ms": call_ms(plain, plain_reps),
           "ms": _trace_ms(kern, reps, kernel),
           "plain_ms": _trace_ms(plain, plain_reps)}
    out["timing"] = "profiler" if out["ms"] and out["plain_ms"] \
        else "events"
    if out["timing"] == "events":
        out["ms"], out["plain_ms"] = out["call_ms"], out["plain_call_ms"]
    return out


def bound_ms(nbytes: float, ops: float):
    """Least time for the work: bytes over HBM rate vs ops over fp32
    rate, whichever is larger, and which one it was."""
    tb, to = nbytes / PEAK_BYTES_S * 1e3, ops / PEAK_FP32_S * 1e3
    return (tb, "bytes") if tb >= to else (to, "operations")


def phase_environment():
    import torch
    from repro_torch.device import set_exact_fp32
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60)
    require(torch.cuda.is_available(), "torch.cuda.is_available()")
    card = smi.stdout.strip().splitlines()[0] if smi.stdout.strip() \
        else "nvidia-smi: " + smi.stderr.strip()
    log(f"card: {card}")
    set_exact_fp32()
    log(f"torch {torch.__version__} cuda {torch.version.cuda} python "
        f"{sys.version.split()[0]} device {torch.cuda.get_device_name(0)} "
        f"count {torch.cuda.device_count()}")
    log(f"tf32: matmul.allow_tf32={torch.backends.cuda.matmul.allow_tf32} "
        f"cudnn.allow_tf32={torch.backends.cudnn.allow_tf32} "
        f"float32_matmul_precision={torch.get_float32_matmul_precision()}")
    return card


def phase_build():
    from repro_torch.kernels import build
    t0 = time.perf_counter()
    build.load_library()
    secs = time.perf_counter() - t0
    log(f"build: {secs:.2f} s ({'compiled' if build.build_log else 'cached'}"
        f" {build.library_path().name})")
    heavy, func = [], ""
    for line in build.build_log.splitlines():
        if "registers" in line or "spill" in line or "Compiling" in line \
                or line.startswith("---"):
            log(f"  ptxas {line.strip()}")
        if "Function properties for" in line:
            func = line.split("for")[-1].strip()
        if "stack frame" in line and line.strip() != (
                "0 bytes stack frame, 0 bytes spill stores, 0 bytes spill "
                "loads"):
            heavy.append(f"{func}: {line.strip()}")
    require(not heavy, f"ptxas reports a stack frame or spills: {heavy}")


def phase_launch_floor(dev):
    """Device ms of an empty kernel (csrc/launch_floor.cu): the floor
    under any launch, beside which K1's and K3's times are read."""
    import torch
    from repro_torch.kernels import build
    lib = build.load_library()

    def empty():
        build.check(lib.repro_launch_floor(
            dev.index or 0, torch.cuda.current_stream(dev).cuda_stream),
            "launch_floor launch")
    ms = device_ms(empty, 200, "launch_floor_kernel")
    require(ms is not None, "the profiler shows no device time of the "
            "empty kernel")
    log(f"launch floor: an empty kernel (1 block of 32 threads) takes "
        f"{ms:.5f} ms of device time")
    return ms


def _rand_subnet(gen, o, f, depth, width, skip, dev):
    import torch
    from repro_torch.core.subnet import subnet_spec
    spec = subnet_spec(o, f, depth, width, skip)

    def draw(shape):
        return (torch.randn(shape, generator=gen)
                / (shape[-2] ** 0.5)).to(dev)
    return {k: [{"w": draw(s["w"]), "b": draw(s["b"])} for s in v]
            for k, v in spec.items()}


def out_hash(x) -> str:
    """sha256 of a float32 tensor's bytes after ``+ 0.0`` (signed zeros
    compare equal): whether two kernels gave the same bits."""
    import hashlib
    return hashlib.sha256((x + 0.0).cpu().numpy().tobytes()).hexdigest()


def phase_subnet_kernel(cfg, dev):
    """K2 against the plain grouped sub-network at every jsc-5l layer's
    conversion shape, with the launch plan it took; then every rows per
    thread R and rows per block of K2_SWEEP, each bit-identical to the
    plan's launch, timed."""
    import torch
    from repro_torch.kernels.neuralut_mlp import (_launch, pack_subnet_weights,
                                                  plan_subnet_launch,
                                                  subnet_kernel_apply)
    from repro_torch.kernels.ref import grouped_subnet_ref
    gen = torch.Generator().manual_seed(11)
    rows = []
    for i, o in enumerate(cfg.layer_widths):
        t, f = cfg.table_size(i), cfg.layer_fan_in(i)
        widths = widths_of(cfg, i)
        p = _rand_subnet(gen, o, f, cfg.depth, cfg.width, cfg.skip, dev)
        codes = torch.randint(0, 2 ** cfg.layer_in_bits(i), (t, o, f),
                              generator=gen)
        xg = ((codes - 2 ** (cfg.layer_in_bits(i) - 1)).float()
              * 0.3).to(dev)
        lw, lb, sw, sb = _weights(p)

        def kern():
            return subnet_kernel_apply(p, xg, cfg.skip)

        def plain():
            return grouped_subnet_ref(xg, lw, lb, sw, sb, skip=cfg.skip)
        got, want = kern(), plain()
        torch.cuda.synchronize()
        require(got.shape == (t, o) and bool(torch.isfinite(got).all()),
                f"K2 layer {i}: shape {tuple(got.shape)} / non-finite")
        err = (got - want).abs()
        ok = bool((err <= K2_ATOL + K2_RTOL * want.abs()).all())
        require(ok, f"K2 layer {i}: max err {float(err.max()):.3e} beyond "
                f"atol/rtol {K2_ATOL}")
        macs = sum(int(w.shape[1] * w.shape[2]) for w in lw + sw)
        flops = 2.0 * macs * t * o
        nbytes = 4.0 * (xg.numel() + t * o + sum(
            a.numel() for a in lw + lb + sw + sb))
        tm = timings(kern, plain, "grouped_subnet_kernel", 20, 5)
        bms, by = bound_ms(nbytes, flops)
        plan = plan_subnet_launch(dev, t, o, widths, cfg.skip)
        # the tile sweep: the same bits whatever the tile, and its time
        wpack = pack_subnet_weights(lw, lb, sw, sb)
        sweep = {}
        for force in itertools.product(K2_SWEEP_R, K2_SWEEP_G,
                                       K2_SWEEP_ROWS):
            try:
                sp = plan_subnet_launch(dev, t, o, widths, cfg.skip, force)
            except ValueError:
                continue    # no such tile (rows not a multiple of 32 R)
            y = torch.empty_like(got)

            def tile():
                _launch(xg, wpack, y, widths, cfg.skip, force)
            tile()
            torch.cuda.synchronize()
            require(torch.equal(y, got), f"K2 layer {i} tile {force}: "
                    f"differs from the plan's launch ({plan})")
            sweep["/".join(map(str, force))] = dict(
                ms=device_ms(tile, 20, "grouped_subnet_kernel"),
                regs=sp.regs)
        rows.append(dict(err=float(err.max()), bound_ms=bms, by=by,
                         flops=flops, plan=plan._asdict(), hash=out_hash(got),
                         sweep_ms=sweep, **tm))
        log(f"K2 layer {i}: T={t} O={o} F={f} max_abs_err="
            f"{float(err.max()):.3e} kernel {tm['ms']:.4f} ms (call "
            f"{tm['call_ms']:.4f}) plain {tm['plain_ms']:.4f} ms (call "
            f"{tm['plain_call_ms']:.4f}) [{tm['timing']}] bound "
            f"{bms:.4f} ms ({by}, {flops / 1e9:.3f} GFLOP, "
            f"{flops / (tm['ms'] * 1e-3) / 1e12:.2f} TFLOP/s); plan {plan}; "
            f"sha256 {rows[-1]['hash'][:16]}")
        log(f"K2 layer {i} tile sweep (R/neurons/rows: ms): " + ", ".join(
            f"{k} {v['ms'] or float('nan'):.4f}" for k, v in sweep.items()))
    return rows


def _close(got, want, rtol, atol) -> float:
    """Max abs error; raises when any element is beyond atol + rtol*|want|."""
    err = (got - want).abs()
    if not bool((err <= atol + rtol * want.abs()).all()):
        raise RuntimeError(f"FAILED: max err {float(err.max()):.3e} beyond "
                           f"rtol {rtol} / atol {atol}")
    return float(err.max()) if err.numel() else 0.0


def widths_of(cfg, i):
    """Layer i's sub-network widths: F, N, ..., N, 1."""
    return [cfg.layer_fan_in(i)] + [cfg.width] * (cfg.depth - 1) + [1]


def phase_train_kernels(cfg, dev):
    """K4 and K5 against their plain versions (and K5 against torch
    autograd of the plain grouped sub-network) at every jsc-5l layer's
    training shape; K5 rerun bit for bit."""
    import torch
    from repro_torch.kernels.neuralut_grad import (plan_train_launch,
                                                   subnet_train_bwd,
                                                   subnet_train_fwd)
    from repro_torch.kernels.neuralut_mlp import pack_subnet_weights
    from repro_torch.kernels.ref import (grouped_subnet_ref,
                                         subnet_train_bwd_ref,
                                         subnet_train_fwd_ref)
    gen = torch.Generator().manual_seed(13)
    S = cfg.skip
    fwd_rows, bwd_rows = [], []
    for i, o in enumerate(cfg.layer_widths):
        f = cfg.layer_fan_in(i)
        p = _rand_subnet(gen, o, f, cfg.depth, cfg.width, S, dev)
        lw = [lp["w"] for lp in p["layers"]]
        lb = [lp["b"] for lp in p["layers"]]
        sw = [sp["w"] for sp in p.get("skips", [])]
        sb = [sp["b"] for sp in p.get("skips", [])]
        xg = torch.randn((TRAIN_B, o, f), generator=gen).to(dev)
        g = torch.randn((TRAIN_B, o), generator=gen).to(dev)
        wpack = pack_subnet_weights(lw, lb, sw, sb)

        out, acts = subnet_train_fwd(xg, lw, lb, sw, sb, skip=S,
                                     wpack=wpack)
        r_out, r_acts = subnet_train_fwd_ref(xg, lw, lb, sw, sb, skip=S)
        torch.cuda.synchronize()
        require(out.shape == (TRAIN_B, o) and len(acts) == cfg.depth - 1
                and bool(torch.isfinite(out).all()),
                f"K4 layer {i}: shape / non-finite")
        e4 = max([_close(out, r_out, K4_RTOL, K4_ATOL)]
                 + [_close(a, r, K4_RTOL, K4_ATOL)
                    for a, r in zip(acts, r_acts)])

        got = subnet_train_bwd(g, xg, acts, lw, lb, sw, sb, skip=S,
                               wpack=wpack)
        want = subnet_train_bwd_ref(g, xg, r_acts, lw, sw, skip=S)
        leaves = [xg] + lw + lb + sw + sb
        req = [a.detach().clone().requires_grad_(True) for a in leaves]
        nl, nch = len(lw), len(sw)
        y = grouped_subnet_ref(req[0], req[1:1 + nl], req[1 + nl:1 + 2 * nl],
                               req[1 + 2 * nl:1 + 2 * nl + nch],
                               req[1 + 2 * nl + nch:], skip=S)
        auto = torch.autograd.grad(y, req, grad_outputs=g)
        flat_got = [got[0]] + got[1] + got[2] + got[3] + got[4]
        flat_want = [want[0]] + want[1] + want[2] + want[3] + want[4]
        torch.cuda.synchronize()
        e5 = max(_close(a, b, K5_RTOL, K5_ATOL)
                 for a, b in zip(flat_got, flat_want))
        e5a = max(_close(a, b, K5_RTOL, K5_ATOL)
                  for a, b in zip(flat_got, auto))
        again = subnet_train_bwd(g, xg, acts, lw, lb, sw, sb, skip=S,
                                 wpack=wpack)
        flat_again = [again[0]] + again[1] + again[2] + again[3] + again[4]
        require(all(torch.equal(a, b) for a, b in zip(flat_got, flat_again)),
                f"K5 layer {i}: a rerun on the same inputs differs")

        macs = sum(int(w.shape[1] * w.shape[2]) for w in lw + sw)
        wbytes = 4.0 * sum(a.numel() for a in lw + lb + sw + sb)
        abytes = 4.0 * sum(a.numel() for a in acts)
        fwd_flops = 2.0 * macs * TRAIN_B * o
        fwd_bytes = 4.0 * (xg.numel() + out.numel()) + wbytes + abytes
        # backward: dW and the input cotangent per product, twice the
        # forward's work; reads g, xg, acts, weights, writes dx and grads
        bwd_flops = 2.0 * fwd_flops
        bwd_bytes = 4.0 * (g.numel() + 2 * xg.numel()) + abytes + 2 * wbytes

        # device time of every kernel a wrapper call launches, by no
        # name: each must launch one (K5 sums its row tiles on chip)
        k4_call = lambda: subnet_train_fwd(xg, lw, lb, sw, sb, skip=S,
                                           wpack=wpack)
        k5_call = lambda: subnet_train_bwd(g, xg, acts, lw, lb, sw, sb,
                                           skip=S, wpack=wpack)
        tm4 = timings(k4_call,
                      lambda: subnet_train_fwd_ref(xg, lw, lb, sw, sb,
                                                   skip=S), "", 20, 5)
        tm5 = timings(k5_call,
                      lambda: subnet_train_bwd_ref(g, xg, r_acts, lw, sw,
                                                   skip=S), "", 20, 5)
        plan = plan_train_launch(1, TRAIN_B, o, widths_of(cfg, i), S)
        for rows, name, err, tm, nbytes, flops, call in (
                (fwd_rows, "K4", e4, tm4, fwd_bytes, fwd_flops, k4_call),
                (bwd_rows, "K5", max(e5, e5a), tm5, bwd_bytes, bwd_flops,
                 k5_call)):
            bms, by = bound_ms(nbytes, flops)
            per_call = kernels_per_call(call)
            require(per_call == 1, f"{name} layer {i}: {per_call} device "
                    "activities per wrapper call, want 1")
            rows.append(dict(err=err, bound_ms=bms, by=by, flops=flops,
                             bytes=nbytes, kernels_per_call=per_call,
                             plan=plan._asdict(), **tm))
            log(f"{name} layer {i}: B={TRAIN_B} O={o} F={f} max_abs_err="
                f"{err:.3e} kernel {tm['ms']:.4f} ms (call "
                f"{tm['call_ms']:.4f}) plain {tm['plain_ms']:.4f} ms (call "
                f"{tm['plain_call_ms']:.4f}) [{tm['timing']}] bound "
                f"{bms:.5f} ms ({by}; {nbytes / 1e6:.3f} MB, "
                f"{flops / 1e9:.4f} GFLOP); {per_call:g} kernel per call")
        log(f"K5 layer {i}: max err vs plain {e5:.3e}, vs autograd "
            f"{e5a:.3e}; rerun bit-identical; plan {plan}")
    return fwd_rows, bwd_rows


def _random_chain(cfg, rng):
    """Random uniform tables and connectivity at ``cfg``'s geometry."""
    import numpy as np
    statics, tables = [], []
    w_prev = cfg.in_features
    for i, o in enumerate(cfg.layer_widths):
        statics.append({"conn": rng.integers(
            0, w_prev, (o, cfg.layer_fan_in(i))).astype(np.int32)})
        tables.append(rng.integers(0, 2 ** cfg.beta, (o, cfg.table_size(i))
                                   ).astype(np.uint16))
        w_prev = o
    return tables, statics


def _cascade_table_bytes(codes, conns, packed, schedule) -> int:
    """Table bytes this batch's lookups need: per branch table, the
    distinct 32-B sectors that its addresses touch (never more than the
    table), walking the plain cascade over the node schedule (a chain's
    layer meta is taken too)."""
    import torch
    from repro_torch.core.lut_infer import pack_index
    from repro_torch.kernels.ref import as_schedule
    bufs, total, k = [codes], 0, 0
    for srcs, arity, in_bits, _wb, slot_bits, beta in as_schedule(schedule):
        pool = torch.cat([bufs[s] for s in srcs], dim=1)
        out = 0
        for _a in range(arity):
            pt = packed[k]
            o, words = pt.shape
            addr = pack_index(pool[:, conns[k].long()], in_bits)
            k += 1
            wsel = (addr >> slot_bits).clamp(max=words - 1).long()
            rows = torch.arange(o, device=pt.device)[None, :]
            flat = rows * words + wsel              # word index in the table
            sectors = torch.unique(flat // (SECTOR_BYTES
                                            // pt.element_size()))
            total += sectors.numel() * SECTOR_BYTES
            out = out + ((pt[rows, wsel] >> (beta * (addr & (
                (1 << slot_bits) - 1)))) & ((1 << beta) - 1))
        bufs.append(out)
    return total


def phase_cascade_kernel(cfg, dev):
    """K1 against the plain gather cascade (and the lut_forward oracle)
    with random tables at full jsc-5l widths."""
    import numpy as np
    import torch
    from repro_torch.core import lut_infer as LI
    from repro_torch.kernels.lut_cascade import (CascadeOperands,
                                                 cascade_meta,
                                                 cascade_tables,
                                                 lut_cascade)
    from repro_torch.kernels.ref import lut_cascade_ref
    rng = np.random.default_rng(7)
    tables, statics = _random_chain(cfg, rng)
    meta = cascade_meta(cfg)
    packed = [torch.as_tensor(p, device=dev)
              for p in cascade_tables(cfg, tables)]
    conns = [torch.as_tensor(s["conn"], device=dev) for s in statics]
    ops = CascadeOperands(conns, packed, meta, cfg.in_features)
    prog_bytes = ops.prog.numel() * 8   # descriptors and code columns
    log(f"K1 chain: node columns {ops.out_cols}, row pitch {ops.pitch} "
        f"codes, program {prog_bytes} bytes")
    per_b = {}
    for b in CASCADE_BATCHES:
        codes = torch.as_tensor(rng.integers(
            0, 2 ** cfg.layer_in_bits(0), (b, cfg.in_features)
        ).astype(np.int32), device=dev)

        def kern():
            return lut_cascade(codes, ops)

        def plain():
            return lut_cascade_ref(codes, conns, packed, meta)
        got, want = kern(), plain()
        oracle = LI.lut_forward(cfg, tables, statics, codes)
        torch.cuda.synchronize()
        require(got.shape == (b, cfg.num_classes), f"K1 B={b}: shape")
        require(torch.equal(got, want), f"K1 B={b}: differs from the plain "
                f"gather cascade in {int((got != want).sum())} codes")
        require(torch.equal(got, oracle), f"K1 B={b}: differs from "
                "lut_forward")
        lookups = b * sum(cfg.layer_widths)
        int_ops = float(b * sum(o * (2 * cfg.layer_fan_in(i) + 4)
                            for i, o in enumerate(cfg.layer_widths)))
        table_bytes = _cascade_table_bytes(codes, conns, packed, meta)
        nbytes = 4.0 * (codes.numel() + got.numel()) + table_bytes \
            + prog_bytes
        tm = timings(kern, plain, "lut_cascade_kernel", 50, 10)
        bms, by = bound_ms(nbytes, int_ops)
        per_b[b] = dict(bound_ms=bms, by=by, bytes=nbytes,
                        table_bytes=table_bytes, lookups=lookups,
                        err=float((got - want).abs().max()), **tm)
        log(f"K1 B={b}: bit-identical to plain and lut_forward; kernel "
            f"{tm['ms']:.4f} ms (call {tm['call_ms']:.4f}) plain "
            f"{tm['plain_ms']:.4f} ms (call {tm['plain_call_ms']:.4f}) "
            f"[{tm['timing']}] bound {bms:.6f} ms ({by}); "
            f"{nbytes / 1e6:.4f} MB ({table_bytes} B of table sectors), "
            f"{lookups} lookups, "
            f"{lookups / (tm['ms'] * 1e-3):.3e} lookups/s")
    sweep = {}
    for b in SWEEP_BATCHES:
        codes = torch.as_tensor(rng.integers(
            0, 2 ** cfg.layer_in_bits(0), (b, cfg.in_features)
        ).astype(np.int32), device=dev)
        want = lut_cascade_ref(codes, conns, packed, meta)
        for rows in TILE_SWEEP:
            got = lut_cascade(codes, ops, block_b=rows)
            require(torch.equal(got, want), f"K1 B={b} block_b={rows}: "
                    "differs from the plain gather cascade")
            sweep[f"{b}/{rows}"] = device_ms(
                lambda: lut_cascade(codes, ops, block_b=rows), 20,
                "lut_cascade_kernel")
        log(f"K1 tile sweep B={b}: " + ", ".join(
            f"block_b={r} {sweep[f'{b}/{r}'] or float('nan'):.4f} ms"
            for r in TILE_SWEEP))
    return per_b, sweep


def phase_main_path(cfg, dev):
    """The port's serving path at full neuralut-jsc-5l: init, calibrate,
    convert through K2, bundle, serve through K1."""
    import numpy as np
    import torch
    from repro_torch.core import lut_infer as LI
    from repro_torch.core import model as M
    from repro_torch.core import truth_table as TT
    from repro_torch.data import jsc_synthetic
    from repro_torch.kernels.lut_cascade import lut_cascade
    from repro_torch.kernels.neuralut_mlp import grouped_subnet
    from repro_torch.serve import LUTServeEngine, bundle_from_training

    x_tr, _ = jsc_synthetic(20000, seed=0)
    x_te, y_te = jsc_synthetic(4000, seed=1)
    sizes, starts = _requests(x_te)

    lut_cascade.launches = 0
    grouped_subnet.launches = 0
    t0 = time.perf_counter()
    params, state = M.model_init(cfg, torch.Generator().manual_seed(0),
                                 device=dev)
    params = M.calibrate_in_quant(cfg, params, x_tr)
    statics = M.model_static(cfg)
    torch.cuda.synchronize()
    t1 = time.perf_counter()
    tables, packed = TT.convert_packed(cfg, params, state, statics)
    t2 = time.perf_counter()
    bundle = bundle_from_training(cfg, params, tables, statics,
                                  packed_tables=packed)
    with LUTServeEngine(bundle, device=dev) as eng:
        eng.warmup()
        t3 = time.perf_counter()
        futs = [eng.submit(x_te[s:s + n]) for s, n in zip(starts, sizes)]
        preds = [f.result(timeout=300) for f in futs]
        t4 = time.perf_counter()
    launches = {"lut_cascade": lut_cascade.launches,
                "grouped_subnet": grouped_subnet.launches}
    log(f"main path: init+calibrate {t1 - t0:.3f} s, convert "
        f"{t2 - t1:.3f} s ({sum(t.size for t in tables)} entries, "
        f"{sum(p.nbytes for p in packed)} packed bytes), serve "
        f"{len(sizes)} requests / {sum(sizes)} samples in {t4 - t3:.3f} s")
    log(f"main path launches: {launches}")
    log(f"engine metrics: {eng.metrics.render()}")
    require(launches["grouped_subnet"] > 0, "conversion never launched K2")
    require(launches["lut_cascade"] > 0, "serving never launched K1")

    # Checks against the plain versions on the card (outside the count).
    plain_tables, plain_packed = TT.convert_packed(
        cfg, params, state, statics, use_subnet_kernel=False)
    flips = 0
    for i, (a, b) in enumerate(zip(tables, plain_tables)):
        d = np.abs(a.astype(np.int32) - b.astype(np.int32))
        require(int(d.max()) <= 1, f"layer {i}: kernel and plain "
                f"conversion differ by {int(d.max())} codes")
        flips += int((d != 0).sum())
    for i, (t, p) in enumerate(zip(tables, packed)):
        require(np.array_equal(LI.pack_tables(t, cfg.beta), p),
                f"layer {i}: device packing differs from pack_tables")
    log(f"convert: kernel tables within +-1 of the plain conversion, "
        f"{flips} flips of {sum(t.size for t in tables)} entries")
    mismatched = 0
    correct = 0
    for s, n, got in zip(starts, sizes, preds):
        xb = torch.as_tensor(x_te[s:s + n], device=dev)
        want = LI.predict(cfg, params, tables, statics, xb).cpu().numpy()
        require(got.shape == (n,), f"prediction shape {got.shape} != {n}")
        mismatched += int((got != want).sum())
        correct += int((got == y_te[s:s + n]).sum())
    require(mismatched == 0, f"{mismatched} served predictions differ "
            "from the plain lut_infer.predict")
    log(f"serve: all {sum(sizes)} predictions equal the plain predict; "
        f"accuracy of the random-init model {correct / sum(sizes):.4f}")
    requests = [x_te[s:s + n] for s, n in zip(starts, sizes)]
    return launches, dict(bundle=bundle, requests=requests, preds=preds,
                          params=params, tables=tables, statics=statics)


CONVERT_STAGES = ("enumerate+dequantize", "K2", "BN+quantize",
                  "transpose+pack", "device-to-host")


def phase_convert_stages(cfg, dev):
    """Where a warm conversion of full neuralut-jsc-5l spends its time:
    a cold ``convert_packed`` (first launches, module loading), a warm
    one timed whole, then the warm work of ``truth_table._sweep`` stage
    by stage, each stage synchronized at its end and timed on the host
    clock (what a caller waits for it), summed over the five layers; the
    staged tables must equal the warm call's."""
    import numpy as np
    import torch
    from repro_torch.core import model as M
    from repro_torch.core import quant
    from repro_torch.core import truth_table as TT
    from repro_torch.core.exec_plan import plan_subnet_exec
    from repro_torch.core.lut_infer import pack_tables_torch
    from repro_torch.data import jsc_synthetic

    params, state = M.model_init(cfg, torch.Generator().manual_seed(0),
                                 device=dev)
    params = M.calibrate_in_quant(cfg, params, jsc_synthetic(20000, seed=0)[0])
    statics = M.model_static(cfg)
    t0 = time.perf_counter()
    TT.convert_packed(cfg, params, state, statics)
    cold = time.perf_counter() - t0
    walls = []
    for _ in range(3):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        tables, packed = TT.convert_packed(cfg, params, state, statics)
        walls.append(time.perf_counter() - t0)
    g = cfg.graph()
    plan = plan_subnet_exec(g, purpose="convert", device=dev)

    def staged():
        ms = dict.fromkeys(CONVERT_STAGES, 0.0)
        out = []

        def stage(name, fn):
            t = time.perf_counter()
            r = fn()
            torch.cuda.synchronize()
            ms[name] += (time.perf_counter() - t) * 1e3
            return r
        for i in range(g.num_layers):
            scales = TT._graph_pool_scales(g, params, i)
            lp, ls = params["layers"][i], state["layers"][i]
            (fn, bn_p, bn_s), = M.node_branch_params(g.nodes[i], lp, ls)
            conn = torch.as_tensor(statics[i]["conn"], device=dev).long()
            slot_scale = scales[conn]
            beta_in, fan_in = g.layer_in_bits(i), g.layer_fan_in(i)
            t = g.table_size(i)
            require(t <= TT.SWEEP_BATCH, f"layer {i}: {t} codes > one sweep")

            def dequant():
                shifts = torch.tensor([beta_in * (fan_in - 1 - j)
                                       for j in range(fan_in)], device=dev)
                codes = (torch.arange(t, device=dev)[:, None] >> shifts[None]
                         ) & (2 ** beta_in - 1)
                return (codes[:, None, :].to(torch.float32)
                        - 2 ** (beta_in - 1)) * slot_scale[None]
            vals = stage("enumerate+dequantize", dequant)
            f = stage("K2", lambda: plan.apply(fn, vals))
            q = stage("BN+quantize", lambda: quant.quant_codes(
                lp["quant"], quant.bn_apply(bn_p, bn_s, f, train=False)[0],
                g.beta))

            def pack():
                table = q.T.contiguous()
                return table, pack_tables_torch(table, g.beta)
            table, pk = stage("transpose+pack", pack)
            out.append(stage("device-to-host", lambda: (
                table.cpu().numpy().astype(np.uint16), pk.cpu().numpy())))
        return ms, out
    staged()
    ms, out = staged()
    for i, ((tb, pk), t, p) in enumerate(zip(out, tables, packed)):
        require(np.array_equal(tb, t) and np.array_equal(pk, p),
                f"layer {i}: the staged conversion differs from "
                "convert_packed")
    total = sum(ms.values())
    log(f"convert stages (warm, synchronized per stage, ms over the 5 "
        f"layers): " + ", ".join(f"{k} {v:.3f}" for k, v in ms.items())
        + f"; sum {total:.3f}; convert_packed cold {cold * 1e3:.3f} ms, "
        f"warm {', '.join(f'{w * 1e3:.3f}' for w in walls)} ms")
    return dict(stage_ms=ms, stage_sum_ms=total, cold_ms=cold * 1e3,
                warm_ms=[w * 1e3 for w in walls])


def _flat(tree):
    from repro_torch.tree import tree_leaves
    return tree_leaves(tree)


def phase_train_path(cfg, dev):
    """The port's training path at full neuralut-jsc-5l: device-resident
    data, seeded init and calibration, train_neuralut on kernel_train
    (K4/K5), conversion through K2, a bundle, the engine through K1."""
    import numpy as np
    import torch
    from torch.profiler import ProfilerActivity, profile
    from repro_torch.core import lut_infer as LI
    from repro_torch.core import model as M
    from repro_torch.core import train as TR
    from repro_torch.core import truth_table as TT
    from repro_torch.core.exec_plan import plan_subnet_exec
    from repro_torch.data import device_dataset, jsc_synthetic
    from repro_torch.kernels.lut_cascade import lut_cascade
    from repro_torch.kernels.neuralut_grad import (subnet_train_bwd,
                                                   subnet_train_fwd)
    from repro_torch.kernels.neuralut_mlp import grouped_subnet
    from repro_torch.optim import adamw_init
    from repro_torch.serve import LUTServeEngine, bundle_from_training

    xtr, ytr = device_dataset(jsc_synthetic, 20000, seed=0, device=dev)
    xte, yte = device_dataset(jsc_synthetic, 4000, seed=1, device=dev)
    steps_per_epoch = len(xtr) // TRAIN_B
    steps = TRAIN_EPOCHS * steps_per_epoch
    kernels = {"lut_cascade": lut_cascade, "grouped_subnet": grouped_subnet,
               "subnet_train_fwd": subnet_train_fwd,
               "subnet_train_bwd": subnet_train_bwd}
    for fn in kernels.values():
        fn.launches = 0
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    params, state, hist = TR.train_neuralut(
        cfg, xtr, ytr, xte, yte, epochs=TRAIN_EPOCHS, batch=TRAIN_B,
        lr=2e-3, weight_decay=1e-4, seed=0, device=dev)
    t1 = time.perf_counter()   # the history's fetch synchronized
    train_launches = {k: fn.launches for k, fn in kernels.items()}
    statics = M.model_static(cfg)
    tables, packed = TT.convert_packed(cfg, params, state, statics)
    t2 = time.perf_counter()
    bundle = bundle_from_training(cfg, params, tables, statics,
                                  packed_tables=packed)
    x_np = xte.cpu().numpy()
    with LUTServeEngine(bundle, device=dev) as eng:
        served = eng.predict(x_np)
    t3 = time.perf_counter()
    launches = {k: fn.launches for k, fn in kernels.items()}
    log(f"train path: {steps} steps in {t1 - t0:.3f} s "
        f"({steps / (t1 - t0):.2f} steps/s, {(t1 - t0) / TRAIN_EPOCHS:.3f}"
        f" s/epoch incl. eval), convert {t2 - t1:.3f} s, serve "
        f"{len(x_np)} rows {t3 - t2:.3f} s")
    log(f"train path history: {json.dumps(hist)}")
    log(f"train path launches: {launches} (training alone "
        f"{train_launches})")
    for k in ("subnet_train_fwd", "subnet_train_bwd"):
        require(train_launches[k] == cfg.num_layers * steps,
                f"{k}: {train_launches[k]} launches in {steps} steps, "
                f"want {cfg.num_layers} per step")
    require(launches["grouped_subnet"] > 0, "conversion never launched K2")
    require(launches["lut_cascade"] > 0, "serving never launched K1")
    require(all(np.isfinite(v) for vs in hist.values() for v in vs),
            "non-finite training history")
    require(hist["loss"][-1] < hist["loss"][0],
            f"loss did not fall: {hist['loss']}")

    # Checks against the plain versions, outside the counted run.
    plain_tables, _ = TT.convert_packed(cfg, params, state, statics,
                                        use_subnet_kernel=False)
    flips = 0
    for i, (a, b) in enumerate(zip(tables, plain_tables)):
        d = np.abs(a.astype(np.int32) - b.astype(np.int32))
        require(int(d.max()) <= 1, f"layer {i}: kernel and plain "
                f"conversion differ by {int(d.max())} codes")
        flips += int((d != 0).sum())
    want = LI.predict(cfg, params, tables, statics, xte).cpu().numpy()
    mismatched = int((served != want).sum())
    require(mismatched == 0, f"{mismatched} served predictions differ "
            "from the plain lut_infer.predict")
    served_acc = float((served == yte.cpu().numpy()).mean())
    log(f"train path convert: {flips} flips of "
        f"{sum(t.size for t in tables)} entries against the plain "
        f"conversion; serve: all {len(x_np)} predictions equal the plain "
        f"predict, served accuracy {served_acc:.4f}, test acc_q "
        f"{hist['test_acc_q'][-1]:.4f}")

    # Step 1 from the same init: kernel_train against canonical autograd.
    sd = M.device_statics(statics, dev)
    p0, s0 = M.model_init(cfg, torch.Generator().manual_seed(0), device=dev)
    p0 = M.calibrate_in_quant(cfg, p0, xtr)
    ib = TR.epoch_batches(len(xtr), steps_per_epoch, TRAIN_B, seed=0,
                          epoch=0, device=dev)
    plan_k = plan_subnet_exec(cfg, purpose="train", device=dev)
    plan_c = plan_subnet_exec(cfg, purpose="train", device=dev,
                              route="canonical")
    require(plan_k.route == "kernel_train", f"train plan {plan_k.route}")
    lk, gk, sk = TR.loss_and_grads(cfg, p0, s0, sd, xtr[ib[0]], ytr[ib[0]],
                                   exec_plan=plan_k)
    lc, gc, sc = TR.loss_and_grads(cfg, p0, s0, sd, xtr[ib[0]], ytr[ib[0]],
                                   exec_plan=plan_c)
    torch.cuda.synchronize()
    gerr = max(_close(a, b, K5_RTOL, K5_ATOL)
               for a, b in zip(_flat(gk), _flat(gc)))
    serr = max(_close(a, b, K4_RTOL, K4_ATOL)
               for a, b in zip(_flat(sk), _flat(sc)))
    log(f"step 1: loss kernel_train {float(lk):.7f} canonical "
        f"{float(lc):.7f}; {len(_flat(gk))} gradient leaves within rtol "
        f"{K5_RTOL} / atol {K5_ATOL} (max err {gerr:.3e}), BN state max "
        f"err {serr:.3e}")

    # Rerun: the same steps from the same init, bit for bit.
    step = TR.make_step_fn(cfg, lr=2e-3, weight_decay=1e-4, t0=steps,
                           exec_plan=plan_k)

    def run(n):
        p, s, o = p0, s0, adamw_init(p0)
        for k in range(n):
            p, s, o, _ = step(p, s, o, sd, xtr[ib[k]], ytr[ib[k]])
        return _flat(p) + _flat(s) + _flat(o)
    a, b = run(RERUN_STEPS), run(RERUN_STEPS)
    require(all(torch.equal(x, y) for x, y in zip(a, b)),
            f"{RERUN_STEPS} steps rerun from the same init differ")
    log(f"rerun: {RERUN_STEPS} steps twice from the same init give "
        f"bit-identical params, BN state and opt state ({len(a)} tensors)")

    # Busy share of one training epoch: device kernel time (profiler)
    # over the epoch's wall time without the profiler.
    def epoch():
        p, s, o = p0, s0, adamw_init(p0)
        for k in range(steps_per_epoch):
            p, s, o, _ = step(p, s, o, sd, xtr[ib[k]], ytr[ib[k]])
        torch.cuda.synchronize()
    epoch()
    te = time.perf_counter()
    epoch()
    wall = time.perf_counter() - te
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        epoch()
    by_kernel = sorted(((e.self_device_time_total, e.key)
                        for e in prof.key_averages()
                        if e.self_device_time_total > 0), reverse=True)
    busy = sum(u for u, _ in by_kernel) / 1e6
    log(f"training epoch ({steps_per_epoch} steps, no eval): {wall:.3f} s "
        f"wall, {steps_per_epoch / wall:.2f} steps/s, device busy "
        f"{busy:.4f} s = {busy / wall:.4f} of the wall time")
    log("training epoch device time by kernel (ms): " + ", ".join(
        f"{k[:48]} {u / 1e3:.2f}" for u, k in by_kernel[:12]))
    return dict(launches=launches, steps=steps, train_s=t1 - t0,
                epoch_s=wall, busy_share=busy / wall,
                acc_q=hist["test_acc_q"][-1], loss=hist["loss"],
                grad_err=gerr, flips=flips)


def _table_sectors(tables, addr) -> int:
    """Bytes of the distinct 32-B table sectors that these lookups touch
    (never more than the table)."""
    import torch
    o, t = tables.shape
    flat = torch.arange(o, device=addr.device)[None, :] * t + addr.long()
    sectors = torch.unique(flat // (SECTOR_BYTES // tables.element_size()))
    return sectors.numel() * SECTOR_BYTES


def k3_timings(kern, plain, reps: int, plain_reps: int):
    """K3's device ms (``_trace_ms``, None where every trace lost the
    kernel's records), its plain version's device ms, and both call
    times from CUDA events, which stay apart from the device times."""
    return {"ms": _trace_ms(kern, reps, "lut_gather_kernel"),
            "plain_ms": _trace_ms(plain, plain_reps),
            "call_ms": call_ms(kern, reps),
            "plain_call_ms": call_ms(plain, plain_reps)}


def k3_summary(rows, what):
    """Device ms of K3 summed over the layers at one batch, or the layers
    whose traces all lost the kernel's records (then no sum)."""
    lost = [i for i, r in enumerate(rows) if r["ms"] is None]
    return {"ms": None if lost else sum(r["ms"] for r in rows),
            "lost_layers": lost,
            "timing": f"profiler device time, {what}" if not lost else
            f"profiler lost the records of layers {lost}: no sum"}


def _sum_or_none(values):
    values = list(values)
    return None if any(v is None for v in values) else sum(values)


def _fmt(ms):
    return "lost" if ms is None else f"{ms:.4f}"


def phase_gather_kernel(cfg, dev):
    """K3's address entry ``lut_lookup`` against its plain version at the
    five jsc-5l layer shapes and every batch size, edge addresses
    included; the one PyTorch call that computes the same function
    (advanced indexing ``tables[o_idx, addr]``, int32 indices, ``o_idx``
    precomputed) timed beside it."""
    import torch
    from repro_torch.kernels.lut_gather import lut_lookup
    from repro_torch.kernels.ref import lut_gather_ref
    gen = torch.Generator().manual_seed(17)
    rows = {}
    for i, o in enumerate(cfg.layer_widths):
        t = cfg.table_size(i)
        tables = torch.randint(0, 2 ** cfg.beta, (o, t), generator=gen,
                               dtype=torch.int32).to(dev)
        o_idx = torch.arange(o, dtype=torch.int32, device=dev)[None, :]
        for b in GATHER_BATCHES:
            addr = torch.randint(0, t, (b, o), generator=gen,
                                 dtype=torch.int32)
            addr[0, 0::2] = 0          # the edge addresses
            addr[0, 1::2] = t - 1
            addr = addr.to(dev)

            def kern():
                return lut_lookup(tables, addr)

            def plain():
                return lut_gather_ref(tables, addr)

            def library():
                return tables[o_idx, addr]
            got, want, lib = kern(), plain(), library()
            torch.cuda.synchronize()
            require(got.shape == (b, o) and got.dtype == torch.int32,
                    f"K3 layer {i} B={b}: shape {tuple(got.shape)}")
            require(torch.equal(got, want), f"K3 layer {i} B={b}: differs "
                    f"from the plain version in {int((got != want).sum())}")
            require(torch.equal(lib, want), f"K3 layer {i} B={b}: the "
                    "library call differs from the plain version")
            tm = k3_timings(kern, plain, 50, 10)
            lib_ms = _trace_ms(library, 50)
            lookups = b * o
            nbytes = 4.0 * 2 * lookups + _table_sectors(tables, addr)
            bms, by = bound_ms(nbytes, 4.0 * lookups)
            rows[(i, b)] = dict(err=0.0, bound_ms=bms, by=by, bytes=nbytes,
                                library_ms=lib_ms, **tm)
            log(f"K3 lookup layer {i} (O={o}, T={t}) B={b}: bit-identical "
                f"to plain; kernel {_fmt(tm['ms'])} ms (call "
                f"{tm['call_ms']:.4f}) plain {_fmt(tm['plain_ms'])} ms (call "
                f"{tm['plain_call_ms']:.4f}) library tables[o_idx, addr] "
                f"{_fmt(lib_ms)} ms bound {bms:.6f} ms ({by}; "
                f"{nbytes / 1e6:.4f} MB)")
    return rows


def layer_shapes(cfg):
    """(name, I, O, F, in_bits, beta_out) of the five jsc-5l layers and of
    the sweep's first NeuraLUT layer (196 pooled inputs, F 6, 2 bits)."""
    from repro_torch.sweep.plan import paper_sweep_points
    shapes = [(f"jsc-5l layer {i}", cfg.in_features if i == 0
               else cfg.layer_widths[i - 1], o, cfg.layer_fan_in(i),
               cfg.layer_in_bits(i), cfg.beta)
              for i, o in enumerate(cfg.layer_widths)]
    sw = next(p.cfg for p in paper_sweep_points() if p.cfg.kind == "subnet")
    shapes.append((f"sweep {sw.name} layer 0", sw.in_features,
                   sw.layer_widths[0], sw.layer_fan_in(0),
                   sw.layer_in_bits(0), sw.beta))
    return shapes


def phase_layer_kernel(cfg, dev):
    """K3's layer entry ``lut_layer`` (gather, pack and look up in one
    launch) against its plain version ``lut_layer_ref``, bit for bit, at
    the five jsc-5l layer shapes and the sweep's first NeuraLUT layer, at
    every batch size (1000 fills no tile), with the edge codes 0 and
    2^in_bits - 1 and out-of-range codes (-1, 2^in_bits) in the first
    rows.  Timed beside it: the sequence the per-layer route ran before
    (index, multiply, sum, then ``lut_lookup``) on the same inputs."""
    import ctypes

    import torch
    from repro_torch.core.lut_infer import pack_index
    from repro_torch.kernels import build
    from repro_torch.kernels.lut_gather import lut_layer, lut_lookup
    from repro_torch.kernels.ref import lut_layer_ref
    gen = torch.Generator().manual_seed(19)
    lib = build.load_library()
    rows = {}
    for s, (name, n_in, o, f, in_bits, beta) in enumerate(layer_shapes(cfg)):
        t = 1 << (in_bits * f)
        tables = torch.randint(0, 2 ** beta, (o, t), generator=gen,
                               dtype=torch.int32).to(dev)
        conn = torch.randint(0, n_in, (o, f), generator=gen,
                             dtype=torch.int32).to(dev)
        conn_long = conn.long()
        for b in GATHER_BATCHES:
            codes = torch.randint(0, 2 ** in_bits, (b, n_in), generator=gen,
                                  dtype=torch.int32)
            codes[0] = 0
            if b > 1:
                codes[1] = 2 ** in_bits - 1
            if b > 2:
                codes[2, 0::2] = -1
                codes[2, 1::2] = 2 ** in_bits
            codes = codes.to(dev)

            def kern():
                return lut_layer(tables, codes, conn, in_bits)

            def plain():
                return lut_layer_ref(tables, codes, conn, in_bits)

            def sequence():
                return lut_lookup(tables, pack_index(codes[:, conn_long],
                                                     in_bits))
            got, want, seq = kern(), plain(), sequence()
            torch.cuda.synchronize()
            require(got.shape == (b, o) and got.dtype == torch.int32,
                    f"K3 {name} B={b}: shape {tuple(got.shape)}")
            for what, x in (("lut_layer", got), ("the old sequence", seq)):
                require(torch.equal(x, want), f"K3 {name} B={b}: {what} "
                        f"differs from lut_layer_ref in "
                        f"{int((x != want).sum())}")
            tm = k3_timings(kern, plain, 50, 10)
            seq_ms = _trace_ms(sequence, 50)
            addr = pack_index(codes[:, conn_long], in_bits).clamp(0, t - 1)
            nbytes = 4.0 * (b * n_in + o * f + b * o) + _table_sectors(
                tables, addr)
            bms, by = bound_ms(nbytes, float(b * o * (2 * f + 2)))
            plan = (ctypes.c_longlong * 4)()
            build.check(lib.repro_lut_layer_plan(b, o, f, plan),
                        "lut_layer plan")
            rows[(s, b)] = dict(err=0.0, bound_ms=bms, by=by, bytes=nbytes,
                                sequence_ms=seq_ms, **tm,
                                plan=dict(zip(("G", "ng", "grid_x",
                                               "grid_y"), list(plan))))
            log(f"K3 layer {name} (I={n_in}, O={o}, F={f}, in_bits="
                f"{in_bits}, T={t}) B={b}: bit-identical to lut_layer_ref "
                f"(and the old sequence); kernel {_fmt(tm['ms'])} ms (call "
                f"{tm['call_ms']:.4f}), old sequence {_fmt(seq_ms)} ms, plain "
                f"{_fmt(tm['plain_ms'])} ms; bound {bms:.6f} ms ({by}; "
                f"{nbytes / 1e6:.4f} MB); plan {rows[(s, b)]['plan']}")
    return rows


def phase_layer_serving(cfg, dev, served):
    """The per-layer route: the slice-1 bundle and requests through
    ``LUTServeEngine(fused=False)`` (one K3 ``lut_layer`` launch per
    layer and batch), against the fused route (K1) and the plain
    predict.  One request at a time with no admission window, so each
    request is its own batch and its latency is the route's; the routes
    run in turns fused, layer, layer, fused.  Then the device activities
    of one forward of each route at B = 256 from the profiler: the
    per-layer route must make ``num_layers`` K3 launches and otherwise
    exactly the fused route's activities (quantizer, argmax, copies), so
    no separate index, multiply or sum kernel."""
    import numpy as np
    import torch
    from repro_torch.core import lut_infer as LI
    from repro_torch.kernels.lut_cascade import lut_cascade
    from repro_torch.kernels.lut_gather import lut_layer, lut_lookup
    from repro_torch.serve import LUTServeEngine
    from repro_torch.serve.engine import DEFAULT_BUCKETS, make_forward_fn

    requests = served["requests"]
    forwards = sum(-(-len(x) // DEFAULT_BUCKETS[-1]) for x in requests)
    want = [LI.predict(cfg, served["params"], served["tables"],
                       served["statics"], torch.as_tensor(x, device=dev))
            .cpu().numpy() for x in requests]
    kernels = {"lut_cascade": lut_cascade, "lut_layer": lut_layer,
               "lut_lookup": lut_lookup}
    runs = []
    for fused in (True, False, False, True):
        with LUTServeEngine(served["bundle"], fused=fused, max_wait_ms=0.0,
                            device=dev) as eng:
            eng.warmup()
            torch.cuda.synchronize()
            for fn in kernels.values():
                fn.launches = 0
            preds = [eng.predict(x) for x in requests]
            launches = {k: fn.launches for k, fn in kernels.items()}
        rep = eng.metrics.report()
        route = "fused" if fused else "layer"
        runs.append(dict(route=route, launches=launches, p50_ms=rep["p50_ms"],
                         p99_ms=rep["p99_ms"]))
        log(f"{route} route: {len(requests)} requests one at a time, "
            f"{forwards} batches; p50 {rep['p50_ms']:.3f} ms p99 "
            f"{rep['p99_ms']:.3f} ms; launches {launches}")
        for k, (got, w, f) in enumerate(zip(preds, want, served["preds"])):
            require(np.array_equal(got, w), f"{route} route request {k}: "
                    f"{int((got != w).sum())} predictions differ from "
                    "predict")
            require(np.array_equal(got, f), f"{route} route request {k}: "
                    "differs from the fused route's slice-1 predictions")
        if fused:
            require(launches == {"lut_cascade": forwards, "lut_layer": 0,
                                 "lut_lookup": 0},
                    f"fused route launches {launches}, want {forwards} K1")
        else:
            require(launches == {"lut_cascade": 0,
                                 "lut_layer": cfg.num_layers * forwards,
                                 "lut_lookup": 0},
                    f"layer route launches {launches}, want "
                    f"{cfg.num_layers} x {forwards} lut_layer and no K1")
    log(f"per-layer serving: predictions equal the fused route and "
        f"predict on all {sum(len(x) for x in requests)} samples; latency "
        "(ms) p50/p99 fused vs layer: " + ", ".join(
            f"{r['route']} {r['p50_ms']:.3f}/{r['p99_ms']:.3f}" for r in runs))

    # Device activities of one forward per route, from the profiler.
    x = np.concatenate(requests)[:HEADLINE_B]
    acts = {}
    for route, fused in (("fused", True), ("layer", False)):
        fwd = make_forward_fn(served["bundle"], fused=fused, device=dev)
        acts[route] = activities_per_call(lambda: fwd(x))
        log(f"layer route: profiler, one {route} forward at B={len(x)}: "
            f"{sum(acts[route].values()):g} device activities "
            f"{json.dumps(acts[route], sort_keys=True)}")
    k3 = sum(v for k, v in acts["layer"].items() if "lut_gather_kernel" in k)
    k1 = sum(v for k, v in acts["fused"].items() if "lut_cascade_kernel" in k)
    rest = {r: {k: v for k, v in a.items() if "lut_gather_kernel" not in k
                and "lut_cascade_kernel" not in k} for r, a in acts.items()}
    require(k1 == 1, f"the fused forward made {k1} K1 launches, want 1")
    require(k3 == cfg.num_layers, f"the layer forward made {k3} K3 launches "
            f"by the profiler, want {cfg.num_layers}")
    require(rest["layer"] == rest["fused"], f"the layer forward's other "
            f"device activities {rest['layer']} differ from the fused "
            f"forward's {rest['fused']} (a separate gather or pack kernel?)")
    log(f"layer route: profiler, per forward: {k3:g} lut_layer launches and "
        f"the fused route's {sum(rest['fused'].values()):g} other activities "
        f"({sum(acts['layer'].values()):g} against "
        f"{sum(acts['fused'].values()):g})")
    return dict(launches=runs[1]["launches"]["lut_layer"],
                launches_by_name=runs[1]["launches"], runs=runs,
                forwards=forwards, activities=acts)


def _graph_random_net(cfg, rng):
    """Random uniform per-node branch tables and connectivity at a
    ``LUTGraphConfig``'s geometry."""
    import numpy as np
    statics, tables = [], []
    for i, nd in enumerate(cfg.nodes):
        statics.append({"conns": [
            rng.integers(0, cfg.node_in_width(i), (nd.width, nd.fan_in)
                         ).astype(np.int32) for _ in range(nd.arity)]})
        tables.append([rng.integers(0, 2 ** cfg.beta,
                                    (nd.width, cfg.table_size(i))
                                    ).astype(np.uint16)
                       for _ in range(nd.arity)])
    return tables, statics


def _dag_cases():
    """(name, LUTGraphConfig) of the DAGs whose buffer liveness the
    shipped PolyLUT-Add geometries (every node reads the one before it)
    cannot show: a diamond; the reference's random DAGs
    (tests/test_lut_graph.py: a rank of nodes over the input, a
    classifier over a subset); deeper random DAGs whose nodes read one
    to three earlier buffers, the input among them."""
    import numpy as np
    from repro_torch.core.nl_config import INPUT, LUTGraphConfig, LUTNodeSpec

    def node(name, width=4, inputs=(INPUT,), arity=1):
        return LUTNodeSpec(name=name, width=width, fan_in=2, inputs=inputs,
                           arity=arity)
    cases = [("diamond", LUTGraphConfig(
        name="diamond", in_features=16, num_classes=5, beta=4,
        nodes=(node("a", 64, arity=2), node("b", 48, arity=2),
               node("c", 5, inputs=("a", "b"))), kind="linear"))]
    for seed in DAG_SEEDS:
        rng = np.random.default_rng(seed)
        beta, arity = int(rng.integers(2, 4)), int(rng.choice([1, 2, 4]))
        n_mid = int(rng.integers(1, 3))
        mids = [node(f"m{j}", int(rng.integers(2, 5)), arity=arity)
                for j in range(n_mid)]
        picked = sorted(rng.choice(n_mid, int(rng.integers(1, n_mid + 1)),
                                   replace=False).tolist())
        cases.append((f"rank{seed}", LUTGraphConfig(
            name="dag-prop", in_features=5, num_classes=3, beta=beta,
            nodes=tuple(mids) + (node("cls", 3, tuple(
                f"m{j}" for j in picked)),), kind="linear")))
    for seed in DAG_SEEDS:
        rng = np.random.default_rng(100 + seed)
        beta = int(rng.integers(2, 4))
        bits, names, nodes = {INPUT: beta}, [INPUT], []
        n = int(rng.integers(3, 8))
        for j in range(n):
            last = j == n - 1
            arity = 1 if last else int(rng.choice([1, 2]))
            first = names[int(rng.integers(len(names)))]
            same = [m for m in names if bits[m] == bits[first] and m != first]
            extra = rng.choice(same, int(rng.integers(0, min(2, len(same))
                                                      + 1)),
                               replace=False).tolist() if same else []
            nodes.append(node(f"n{j}", 3 if last else int(rng.integers(2, 70)),
                              (first,) + tuple(extra), arity))
            bits[f"n{j}"] = beta + arity.bit_length() - 1
            names.append(f"n{j}")
        cases.append((f"deep{seed}", LUTGraphConfig(
            name="dag-deep", in_features=5, num_classes=3, beta=beta,
            nodes=tuple(nodes), kind="linear")))
    return cases


def _graph_operands(cfg, tables, statics, dev):
    import torch
    from repro_torch.kernels.lut_cascade import (CascadeOperands,
                                                 graph_cascade_meta,
                                                 graph_cascade_tables)
    conns = [torch.as_tensor(c, device=dev)
             for st in statics for c in st["conns"]]
    packed = [torch.as_tensor(p, device=dev)
              for p in graph_cascade_tables(cfg, tables)]
    return CascadeOperands(conns, packed, graph_cascade_meta(cfg),
                           cfg.in_features)


def phase_dag_cascade_kernel(dev):
    """K1 on the DAG schedule against the plain DAG cascade (and the
    graph_lut_forward oracle), bit for bit: random tables at full
    polylut-add-jsc-5l operands at every batch size, timed, with its
    bound and a tile sweep; then a diamond and seeded random DAGs."""
    import numpy as np
    import torch
    from repro_torch.config import get_config
    from repro_torch.core import lut_infer as LI
    from repro_torch.kernels.lut_cascade import lut_cascade
    from repro_torch.kernels.ref import lut_cascade_ref
    cfg = get_config(GRAPH_ARCH)
    rng = np.random.default_rng(23)
    tables, statics = _graph_random_net(cfg, rng)
    ops = _graph_operands(cfg, tables, statics, dev)
    conns, packed, sched = list(ops.conns), list(ops.packed), ops.schedule
    log(f"K1 DAG {GRAPH_ARCH}: schedule {sched}; {len(conns)} branch tables,"
        f" {sum(p.numel() * 4 for p in packed)} packed bytes; node columns"
        f" {ops.out_cols}, row pitch {ops.pitch} codes, program "
        f"{ops.prog.numel() * 8} bytes")
    prog_bytes = ops.prog.numel() * 8   # descriptors and code columns
    per_b = {}
    for b in CASCADE_BATCHES:
        codes = torch.as_tensor(rng.integers(
            0, 2 ** cfg.node_in_bits(0), (b, cfg.in_features)
        ).astype(np.int32), device=dev)

        def kern():
            return lut_cascade(codes, ops)

        def plain():
            return lut_cascade_ref(codes, conns, packed, sched)
        got, want = kern(), plain()
        oracle = LI.graph_lut_forward(cfg, tables, statics, codes)
        torch.cuda.synchronize()
        require(got.shape == (b, cfg.num_classes), f"K1 DAG B={b}: shape")
        require(torch.equal(got, want), f"K1 DAG B={b}: differs from the "
                f"plain DAG cascade in {int((got != want).sum())} codes")
        require(torch.equal(got, oracle), f"K1 DAG B={b}: differs from "
                "graph_lut_forward")
        lookups = b * sum(nd.width * nd.arity for nd in cfg.nodes)
        int_ops = float(b * sum(nd.width * (nd.arity * (2 * nd.fan_in + 4)
                                            + nd.arity - 1)
                                for nd in cfg.nodes))
        table_bytes = _cascade_table_bytes(codes, conns, packed, sched)
        nbytes = 4.0 * (codes.numel() + got.numel()) + table_bytes \
            + prog_bytes
        tm = timings(kern, plain, "lut_cascade_kernel", 50, 10)
        bms, by = bound_ms(nbytes, int_ops)
        per_b[b] = dict(bound_ms=bms, by=by, bytes=nbytes,
                        table_bytes=table_bytes, lookups=lookups,
                        err=float((got - want).abs().max()), **tm)
        log(f"K1 DAG B={b}: bit-identical to plain and graph_lut_forward; "
            f"kernel {tm['ms']:.4f} ms (call {tm['call_ms']:.4f}) plain "
            f"{tm['plain_ms']:.4f} ms (call {tm['plain_call_ms']:.4f}) "
            f"[{tm['timing']}] bound {bms:.6f} ms ({by}); "
            f"{nbytes / 1e6:.4f} MB ({table_bytes} B of table sectors), "
            f"{lookups} lookups, "
            f"{lookups / (tm['ms'] * 1e-3):.3e} lookups/s")
    sweep = {}
    for b in SWEEP_BATCHES:
        codes = torch.as_tensor(rng.integers(
            0, 2 ** cfg.node_in_bits(0), (b, cfg.in_features)
        ).astype(np.int32), device=dev)
        want = lut_cascade_ref(codes, conns, packed, sched)
        for rows in TILE_SWEEP:
            got = lut_cascade(codes, ops, block_b=rows)
            require(torch.equal(got, want), f"K1 DAG B={b} block_b={rows}: "
                    "differs from the plain DAG cascade")
            sweep[f"{b}/{rows}"] = device_ms(
                lambda: lut_cascade(codes, ops, block_b=rows), 20,
                "lut_cascade_kernel")
        log(f"K1 DAG tile sweep B={b}: " + ", ".join(
            f"block_b={r} {sweep[f'{b}/{r}'] or float('nan'):.4f} ms"
            for r in TILE_SWEEP))
    cases = []
    for name, dcfg in _dag_cases():
        dt, ds = _graph_random_net(dcfg, rng)
        dops = _graph_operands(dcfg, dt, ds, dev)
        late = any(0 in srcs for srcs, *_r in dops.schedule[1:])
        widths = sum(nd.width for nd in dcfg.nodes[:-1])
        for b in DAG_CASE_BATCHES:
            codes = torch.as_tensor(rng.integers(
                0, 2 ** dcfg.node_in_bits(0), (b, dcfg.in_features)
            ).astype(np.int32), device=dev)
            got = lut_cascade(codes, dops)
            want = lut_cascade_ref(codes, list(dops.conns), list(dops.packed),
                                   dops.schedule)
            oracle = LI.graph_lut_forward(dcfg, dt, ds, codes)
            torch.cuda.synchronize()
            require(torch.equal(got, want) and torch.equal(got, oracle),
                    f"K1 DAG case {name} B={b}: differs from the plain DAG "
                    f"cascade in {int((got != want).sum())} codes")
        cases.append(dict(name=name, nodes=len(dcfg.nodes),
                          input_read_late=late,
                          columns_reused=dops.stride < widths))
        nodes = [(n.name, n.width, n.inputs, n.arity) for n in dcfg.nodes]
        log(f"K1 DAG case {name}: {nodes} beta={dcfg.beta}; columns "
            f"{dops.out_cols} of {dops.stride}; bit-identical at "
            f"B={DAG_CASE_BATCHES}")
    require(any(c["input_read_late"] for c in cases),
            "no DAG case reads the input after another node ran")
    require(any(c["columns_reused"] for c in cases),
            "no DAG case reuses the columns of a dead buffer")
    return per_b, sweep, cases


def _requests(x_te):
    """The serving paths' 72 mixed-size requests (seeded)."""
    import numpy as np
    rng = np.random.default_rng(3)
    sizes = [int(s) for s in rng.choice([1, 2, 5, 8, 13, 31, 64, 100, 256],
                                        70)] + [300, 1000]
    starts = [int(rng.integers(0, len(x_te) - n)) for n in sizes]
    return sizes, starts


def phase_graph_serving(dev):
    """The port's serving path on a LUT graph at full polylut-add-jsc-5l:
    seeded graph init and calibration, conversion through K2 once per
    branch, a graph bundle, LUTServeEngine through K1's DAG schedule (one
    launch per batch, no K3); predictions against predict
    (graph_lut_forward) and the quantized float forward; the per-layer
    route refused; p50/p99 one request at a time."""
    import numpy as np
    import torch
    from repro_torch.config import get_config
    from repro_torch.core import lut_infer as LI
    from repro_torch.core import model as M
    from repro_torch.core import truth_table as TT
    from repro_torch.core.exec_plan import plan_subnet_exec
    from repro_torch.core.nl_config import UnsupportedTopology
    from repro_torch.data import jsc_synthetic
    from repro_torch.kernels.lut_cascade import lut_cascade
    from repro_torch.kernels.lut_gather import lut_layer, lut_lookup
    from repro_torch.kernels.neuralut_mlp import grouped_subnet
    from repro_torch.serve import LUTServeEngine, bundle_from_training
    from repro_torch.serve.engine import DEFAULT_BUCKETS

    cfg = get_config(GRAPH_ARCH)
    branches = sum(nd.arity for nd in cfg.nodes)
    x_tr, _ = jsc_synthetic(20000, seed=0)
    x_te, y_te = jsc_synthetic(4000, seed=1)
    sizes, starts = _requests(x_te)
    requests = [x_te[s:s + n] for s, n in zip(starts, sizes)]
    kernels = {"lut_cascade": lut_cascade, "grouped_subnet": grouped_subnet,
               "lut_lookup": lut_lookup, "lut_layer": lut_layer}
    for fn in kernels.values():
        fn.launches = 0
    t0 = time.perf_counter()
    params, state = M.model_init(cfg, torch.Generator().manual_seed(0),
                                 device=dev)
    params = M.calibrate_in_quant(cfg, params, x_tr)
    statics = M.model_static(cfg)
    torch.cuda.synchronize()
    t1 = time.perf_counter()
    tables, packed = TT.convert_packed(cfg, params, state, statics)
    t2 = time.perf_counter()
    bundle = bundle_from_training(cfg, params, tables, statics,
                                  packed_tables=packed)
    with LUTServeEngine(bundle, device=dev) as eng:
        eng.warmup()
        t3 = time.perf_counter()
        futs = [eng.submit(x) for x in requests]
        preds = [f.result(timeout=300) for f in futs]
        t4 = time.perf_counter()
    launches = {k: fn.launches for k, fn in kernels.items()}
    entries = sum(t.size for node in tables for t in node)
    log(f"graph path ({GRAPH_ARCH}, {bundle.topology}): init+calibrate "
        f"{t1 - t0:.3f} s, convert {t2 - t1:.3f} s ({entries} entries in "
        f"{branches} branch tables, "
        f"{sum(p.nbytes for p in bundle.packed_tables)} packed bytes), serve "
        f"{len(sizes)} requests / {sum(sizes)} samples in {t4 - t3:.3f} s")
    log(f"graph path launches: {launches}")
    log(f"graph engine metrics: {eng.metrics.render()}")
    require(launches["grouped_subnet"] == branches,
            f"conversion launched K2 {launches['grouped_subnet']} times, want "
            f"one per branch ({branches})")
    require(launches["lut_cascade"] > 0, "graph serving never launched K1")
    require(launches["lut_lookup"] == launches["lut_layer"] == 0,
            "graph serving launched K3")

    # Checks against the plain versions on the card (outside the count).
    plain_tables, _ = TT.convert_packed(cfg, params, state, statics,
                                        use_subnet_kernel=False)
    flips = 0
    for i, (node, pnode) in enumerate(zip(tables, plain_tables)):
        for a, (t, pt) in enumerate(zip(node, pnode)):
            d = np.abs(t.astype(np.int32) - pt.astype(np.int32))
            require(int(d.max()) <= 1, f"node {i} branch {a}: kernel and "
                    f"plain conversion differ by {int(d.max())} codes")
            flips += int((d != 0).sum())
            require(np.array_equal(LI.pack_tables(t, cfg.beta), packed[i][a]),
                    f"node {i} branch {a}: device packing differs")
    log(f"graph convert: kernel tables within +-1 of the plain conversion, "
        f"{flips} flips of {entries} entries")
    mismatched = correct = 0
    lut_preds = []
    for x, got in zip(requests, preds):
        want = LI.predict(cfg, params, tables, statics,
                          torch.as_tensor(x, device=dev)).cpu().numpy()
        require(got.shape == (len(x),), f"prediction shape {got.shape}")
        mismatched += int((got != want).sum())
        lut_preds.append(want)
    for (s, n), got in zip(zip(starts, sizes), preds):
        correct += int((got == y_te[s:s + n]).sum())
    require(mismatched == 0, f"{mismatched} served graph predictions differ "
            "from the plain lut_infer.predict")
    # The quantized float forward agrees with its LUT twin, the
    # conversion invariant (tests/test_lut_graph.py): through the
    # conversion's hidden-function route (K2), and, logged, through the
    # eval default (the plain grouped product).
    xs = torch.as_tensor(np.concatenate(requests), device=dev)
    lut = np.concatenate(lut_preds)
    agree = {}
    for route, plan in (("convert", plan_subnet_exec(
            cfg, purpose="convert", device=dev)), ("eval", None)):
        _, vals, _ = M.model_apply(cfg, params, state, statics, xs,
                                   exec_plan=plan)
        agree[route] = int((torch.argmax(vals, -1).cpu().numpy()
                            == lut).sum())
    require(agree["convert"] == len(lut), f"the quantized float forward's "
            f"argmax agrees with the LUT twin on {agree['convert']} of "
            f"{len(lut)} samples")
    log(f"graph serve: all {len(lut)} predictions equal the plain predict "
        f"(graph_lut_forward); the float forward's argmax agrees on "
        f"{agree['convert']} (K2 route) / {agree['eval']} (eval route) of "
        f"{len(lut)}; accuracy of the random-init model "
        f"{correct / len(lut):.4f}")
    try:
        LUTServeEngine(bundle, fused=False, device=dev)
    except UnsupportedTopology as e:
        log(f"graph per-layer route refused: {e}")
    else:
        require(False, "LUTServeEngine(fused=False) accepted a DAG")

    # Latency one request at a time (no admission window).
    forwards = sum(-(-len(x) // DEFAULT_BUCKETS[-1]) for x in requests)
    with LUTServeEngine(bundle, max_wait_ms=0.0, device=dev) as eng:
        eng.warmup()
        torch.cuda.synchronize()
        lut_cascade.launches = lut_lookup.launches = lut_layer.launches = 0
        one = [eng.predict(x) for x in requests]
        seq = {"lut_cascade": lut_cascade.launches,
               "lut_lookup": lut_lookup.launches,
               "lut_layer": lut_layer.launches}
    rep = eng.metrics.report()
    require(all(np.array_equal(a, b) for a, b in zip(one, preds)),
            "one-at-a-time graph predictions differ from the batched run")
    require(seq == {"lut_cascade": forwards, "lut_lookup": 0,
                    "lut_layer": 0},
            f"one-at-a-time graph launches {seq}, want {forwards} K1")
    log(f"graph route: {len(requests)} requests one at a time, {forwards} "
        f"batches; p50 {rep['p50_ms']:.3f} ms p99 {rep['p99_ms']:.3f} ms; "
        f"launches {seq}")
    return launches, dict(p50_ms=rep["p50_ms"], p99_ms=rep["p99_ms"],
                          forwards=forwards, flips=flips,
                          convert_s=t2 - t1, serve_s=t4 - t3), dict(
        bundle=bundle, requests=requests, preds=preds)


SERVING_TIMING_TURNS = (1, 2, 2, 1)   # replicas, in turns
PROBE_TRACES = 40                     # traces per profiler_probe
REGISTRY_REPS = 3


def _flip_table_byte(reg, name, version, key="tables/#0"):
    """Flip the last data byte of one stored table (an npz member) in a
    registry version: the bundle's bytes change, its files stay whole."""
    import zipfile
    shard = reg.root / name / f"step_{version:010d}" / "shard_0.npz"
    with zipfile.ZipFile(shard) as z:
        info = z.getinfo(key + ".npy")
    raw = bytearray(shard.read_bytes())
    h = info.header_offset
    name_len = int.from_bytes(raw[h + 26:h + 28], "little")
    extra_len = int.from_bytes(raw[h + 28:h + 30], "little")
    raw[h + 30 + name_len + extra_len + info.compress_size - 1] ^= 0x01
    shard.write_bytes(bytes(raw))


def _last_lookups(bundle, x):
    """(class, address) per row of x: the last layer's table entry that
    the row's predicted class reads."""
    import numpy as np
    import torch
    from repro_torch.core import lut_infer as LI
    from repro_torch.core.model import node_static_conns
    from repro_torch.kernels.ref import lut_cascade_ref
    cfg, dev = bundle.prepack().cfg, torch.device("cpu")
    params = bundle.serve_params(dev)
    codes = LI.input_codes(cfg, params, torch.as_tensor(x))
    conns = [torch.as_tensor(np.asarray(c, np.int64)) for s in bundle.statics
             for c in node_static_conns(s)]
    packed = [torch.as_tensor(p) for p in bundle.packed_tables]
    sched = bundle.cascade_geom
    prev = lut_cascade_ref(codes, conns[:-1], packed[:-1], sched[:-1])
    out = lut_cascade_ref(codes, conns, packed, sched)
    cls = torch.argmax(LI.class_values(cfg, params, out), -1)
    in_bits = cfg.layer_in_bits(cfg.num_layers - 1)
    rows = torch.arange(len(x))[:, None]
    addr = LI.pack_index(prev[rows, conns[-1][cls]], in_bits)
    return cls.tolist(), addr.tolist()


def profiler_probe(dev, traces: int = PROBE_TRACES):
    """Whether ``torch.profiler`` drops device records, and whether that
    depends on what ran before: ``traces`` traces, each of 5 calls of K4
    at the first graph branch shape (O = 64, S = 1) and 5 of a PyTorch
    elementwise kernel (the control).  The K4 wrapper counts every
    launch, so a trace with fewer than 5 K4 records lost them in the
    profiler, not in the launch.  Returns the short traces of each."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    from repro_torch.kernels.neuralut_grad import subnet_train_fwd
    from repro_torch.kernels.neuralut_mlp import pack_subnet_weights
    gen = torch.Generator().manual_seed(11)
    f, depth, width, sk, reps = 3, 4, 16, 2, 5
    lw, lb, sw, sb = _weights(_stacked_subnet(
        gen, 1, GRAPH_BRANCH_O[0], f, depth, width, sk, dev))
    xg = torch.randn((1, TRAIN_B, GRAPH_BRANCH_O[0], f),
                     generator=gen).to(dev)
    wpack = pack_subnet_weights(lw, lb, sw, sb)
    y = torch.zeros(1 << 16, device=dev)
    subnet_train_fwd(xg, lw, lb, sw, sb, skip=sk, wpack=wpack)
    y.add_(1.0)
    torch.cuda.synchronize()
    short = {"traces": traces, "k4": 0, "control": 0}
    before = subnet_train_fwd.launches
    for _ in range(traces):
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            for _ in range(reps):
                subnet_train_fwd(xg, lw, lb, sw, sb, skip=sk, wpack=wpack)
                y.add_(1.0)
            torch.cuda.synchronize()
        names = [e.name for e in prof.events()
                 if e.device_type == DeviceType.CUDA]
        k4 = sum("subnet_train_fwd" in n for n in names)
        short["k4"] += k4 < reps
        short["control"] += len(names) - k4 < reps
    launched = subnet_train_fwd.launches - before
    require(launched == traces * reps,
            f"profiler probe: K4 launched {launched} of {traces * reps}")
    return short


def phase_serving_stack(dev, card, served, graph_served):
    """The port's serving stack over the bundles phase_main_path
    (neuralut-jsc-5l) and phase_graph_serving (polylut-add-jsc-5l) built
    (nothing is trained here): (a) both saved to a TableRegistry and
    loaded back verified, bit-identical, and served; (b) a corrupted
    version refused, quarantined by the IntegrityProbe, the intact one
    served; (c) LUTServeEngine with 2 replicas on one card, a burst of
    the 72 requests; (d) chaos: eviction and redispatch, DispatchFailed,
    DeadlineExceeded; (e) MultiTenantEngine
    (3 jsc-5l tenants and the graph), shedding, a committed and a rolled
    back hot swap; (f) the launch.serve CLI against the registry.  Every
    served prediction is held to lut_infer.predict (the requests'
    predictions of the earlier phases, which equal it).  Times, in turns
    in this call: one request at a time at replicas 1 vs 2, and the
    registry's save / load / verify seconds.  Fails if a thread it
    started outlives it or the host thread is left on another stream."""
    import contextlib
    import io
    import tempfile
    import threading
    import numpy as np
    import torch
    from repro_torch.checkpoint import CheckpointStore
    from repro_torch.config import config_fingerprint
    from repro_torch.core import lut_infer as LI
    from repro_torch.core.model import node_static_conns
    from repro_torch.data import jsc_synthetic
    from repro_torch.kernels.lut_cascade import lut_cascade
    from repro_torch.launch import serve as launch_serve
    from repro_torch.runtime import ChaosHarness, ReplicaHealthTracker
    from repro_torch.serve import (BundleIntegrityError, DeadlineExceeded,
                                   DispatchFailed, IntegrityProbe,
                                   LUTServeEngine, MultiTenantEngine,
                                   NoHealthyReplicas, TableRegistry, Tenant,
                                   TenantOverloaded)

    t_phase = time.perf_counter()
    threads0 = set(threading.enumerate())
    chain, graph = served["bundle"], graph_served["bundle"]
    requests = served["requests"]
    want = {chain.cfg.name: served["preds"],
            graph.cfg.name: graph_served["preds"]}
    reqs = {chain.cfg.name: requests,
            graph.cfg.name: graph_served["requests"]}

    def burst(eng, xs):
        futs = [eng.submit(x) for x in xs]
        return [f.result(timeout=300) for f in futs]

    def exact(got, exp, what):
        bad = sum(int((g != w).sum()) for g, w in zip(got, exp))
        require(bad == 0 and len(got) == len(exp),
                f"{what}: {bad} predictions differ from lut_infer.predict")

    def arrays(b):
        return ([t for n in b.tables
                 for t in (n if isinstance(n, list) else [n])],
                [c for s in b.statics for c in node_static_conns(s)],
                [b.in_log_s] + list(b.layer_log_s), b.packed_tables)

    lut_cascade.launches = 0
    tmp = tempfile.TemporaryDirectory(prefix="chip_smoke_registry_")
    root = tmp.name
    try:
        # (a) save, load verified, bit-identical, served.
        reg = TableRegistry(root)
        reg_s = {"save": [], "load": [], "verify": []}
        for b in (chain, graph):
            name = b.cfg.name
            before = lut_cascade.launches
            for _ in range(REGISTRY_REPS if b is chain else 1):
                t0 = time.perf_counter()
                reg.save(name, b, version=0)
                t1 = time.perf_counter()
                loaded = reg.load(name, verify=True)
                t2 = time.perf_counter()
                report = reg.verify(name)
                t3 = time.perf_counter()
                if b is chain:
                    reg_s["save"].append(t1 - t0)
                    reg_s["load"].append(t2 - t1)
                    reg_s["verify"].append(t3 - t2)
            require(report["ok"] and report["checked"] > 0,
                    f"{name}: verify {report}")
            for part, (xs, ys) in zip(("tables", "conns", "scales",
                                       "packed tables"),
                                      zip(arrays(b), arrays(loaded))):
                require(len(xs) == len(ys) and all(
                    np.asarray(x).dtype == np.asarray(y).dtype
                    and np.array_equal(x, y) for x, y in zip(xs, ys)),
                    f"{name}: loaded {part} differ from the saved ones")
            fp = config_fingerprint(b.cfg)
            require(config_fingerprint(loaded.cfg) == fp
                    and CheckpointStore(str(reg.root / name)).meta(0)[
                        "fingerprint"] == fp,
                    f"{name}: fingerprint changed")
            with LUTServeEngine(loaded, device=dev) as eng:
                eng.warmup()
                got = burst(eng, reqs[name])
            if b is graph:
                # the only DAG launches of the phase: the tenants' graph
                # group runs the plain cross-tenant forward
                dag = lut_cascade.launches - before
            exact(got, want[name], f"registry-loaded {name}")
            log(f"serving stack (a): {name} saved and loaded verified "
                f"({report['checked']} arrays checked, "
                f"{b.num_table_bytes} table bytes, fingerprint {fp}); "
                f"tables, conns, scales and packed tables bit-identical; "
                f"{len(got)} requests served exactly")

        # (b) a corrupted version: refused, quarantined, fallen back.
        name = chain.cfg.name
        reg.save(name, chain, version=1)
        _flip_table_byte(reg, name, 1)
        try:
            reg.load(name)
        except BundleIntegrityError as e:
            log(f"serving stack (b): corrupted v1 refused: {e}")
        else:
            require(False, "a corrupted bundle loaded")
        found = IntegrityProbe(reg).run_once()
        require([(r["name"], r["version"]) for r in found] == [(name, 1)]
                and reg.versions(name) == [0],
                f"the probe found {found}, versions {reg.versions(name)}")
        fallback = reg.load(name)
        with LUTServeEngine(fallback, device=dev) as eng:
            got = eng.predict(requests[0])
        exact([got], want[name][:1], "the intact version after quarantine")
        log(f"serving stack (b): IntegrityProbe quarantined v1; load "
            f"serves v{reg.versions(name)[-1]} exactly")

        # (c) two replicas on one card, the 72 requests as a burst.
        with LUTServeEngine(chain, replicas=2, device=dev) as eng:
            eng.warmup()
            before = lut_cascade.launches
            got = burst(eng, requests)
            launched = lut_cascade.launches - before
        exact(got, want[name], "replicas=2 burst")
        batches = [int(m.report()["batches"]) for m in eng.replica_metrics]
        require(all(n > 0 for n in batches),
                f"batches per replica {batches}: a replica served nothing")
        require(dev.type == "cpu" or launched == eng.forwards,
                f"K1 launched {launched} times for {eng.forwards} "
                "dispatched forwards")
        log(f"serving stack (c): replicas=2 on {eng.device}: batches per "
            f"replica {batches}, {eng.forwards} forwards, K1 launches "
            f"{launched}; every prediction exact")

        # (d) chaos: eviction + redispatch, DispatchFailed, deadlines.
        chaos = ChaosHarness(schedule={"serve.replica": [0]})
        health = ReplicaHealthTracker(2, max_consecutive_failures=1)
        with LUTServeEngine(chain, replicas=2, device=dev, health=health,
                            chaos=chaos) as eng:
            eng.warmup()
            got = [eng.predict(requests[0])] + burst(eng, requests[1:])
        exact(got, want[name], "after replica 0's eviction")
        served0 = int(eng.replica_metrics[0].report()["batches"])
        require(health.healthy_ids() == [1] and served0 == 0
                and eng.metrics.redispatches == 1,
                f"healthy {health.healthy_ids()}, replica 0 served "
                f"{served0} batches, {eng.metrics.redispatches} "
                "redispatches")
        chaos = ChaosHarness(rates={"serve.replica": 1.0})
        outcomes = []
        with LUTServeEngine(chain, replicas=2, device=dev,
                            max_dispatch_retries=0, chaos=chaos) as eng:
            for x in requests[:7]:
                try:
                    eng.predict(x)
                    outcomes.append("served")
                except (DispatchFailed, NoHealthyReplicas) as e:
                    outcomes.append(type(e).__name__)
        require(outcomes == ["DispatchFailed"] * 6 + ["NoHealthyReplicas"]
                and eng.health.healthy_ids() == [],
                f"both replicas failing, no retries: {outcomes}")
        with LUTServeEngine(chain, device=dev) as eng:
            fut = eng.submit(requests[0], timeout_s=1e-9)
            try:
                fut.result(timeout=60)
            except DeadlineExceeded:
                pass
            else:
                require(False, "an expired request was served")
            got = eng.predict(requests[1])
        exact([got], want[name][1:2], "after a deadline")
        require(eng.metrics.deadline_exceeded == 1,
                f"deadline_exceeded {eng.metrics.deadline_exceeded}")
        log(f"serving stack (d): replica 0 evicted after an injected "
            f"failure, its batch redispatched, the survivor served all "
            f"{len(requests)} requests exactly; both replicas failing with "
            f"no retries: {outcomes}; an expired request got "
            f"DeadlineExceeded")

        # (e) tenants: 3 jsc-5l (as launch.serve builds them) + the graph.
        rng = np.random.default_rng(7)
        tenants = [Tenant("primary", chain, priority=1),
                   Tenant("tenant1", launch_serve._variant(chain, rng)),
                   Tenant("tenant2", launch_serve._variant(chain, rng),
                          rate_limit=2.0, burst=2),
                   Tenant("graph", graph)]
        x_all = np.concatenate(requests)
        tenant_want = {t.name: LI.predict(
            t.bundle.cfg, t.bundle.serve_params(dev), t.bundle.tables,
            t.bundle.statics, torch.as_tensor(x_all, device=dev)
        ).cpu().numpy() for t in tenants if t.name != "graph"}
        offs = np.cumsum([0] + [len(x) for x in requests])
        probe = jsc_synthetic(4000, seed=1)[0][:64]

        def predict(b, x):
            return LI.predict(b.cfg, b.serve_params(dev), b.tables,
                              b.statics, torch.as_tensor(x, device=dev)
                              ).cpu().numpy()
        # The changed candidate: one last-layer entry that a probe row's
        # predicted class reads, set to the lowest code.
        old_probe = predict(chain, probe)
        for cls, addr in zip(*_last_lookups(chain, probe)):
            bad = launch_serve._repacked(chain)
            if bad.tables[-1][cls, addr] == 0:
                continue
            bad.tables[-1][cls, addr] = 0
            if (predict(bad, probe) != old_probe).any():
                break
        else:
            require(False, "no single table entry changes a probe "
                    "prediction")
        shed = 0
        with MultiTenantEngine(tenants, device=dev) as mt:
            mt.warmup()
            futs = {t.name: [] for t in tenants}
            for i, x in enumerate(requests):
                for t in ("primary", "tenant1"):
                    futs[t].append((i, mt.submit(t, x)))
                futs["graph"].append((i, mt.submit(
                    "graph", graph_served["requests"][i])))
            for i, x in enumerate(requests[:6]):
                try:
                    futs["tenant2"].append((i, mt.submit("tenant2", x)))
                except TenantOverloaded as e:
                    require(e.reason == "rate_limited", str(e))
                    shed += 1
            for t, fs in futs.items():
                got = [f.result(timeout=300) for _, f in fs]
                exp = ([graph_served["preds"][i] for i, _ in fs]
                       if t == "graph" else
                       [tenant_want[t][offs[i]:offs[i + 1]] for i, _ in fs])
                exact(got, exp, f"tenant {t}")
            stop = threading.Event()
            traffic_err = []

            def traffic():
                while not stop.is_set():
                    try:
                        got = mt.predict("primary", probe)
                    except Exception as e:
                        traffic_err.append(e)
                        return
                    if not (np.array_equal(got, old_probe)):
                        traffic_err.append("a probe prediction changed")

            th = threading.Thread(target=traffic, daemon=True)
            th.start()
            try:
                good = mt.swap("primary", launch_serve._repacked(chain),
                               shadow_samples=256, timeout_s=120.0)
                rolled = mt.swap("primary", bad, shadow_samples=256,
                                 timeout_s=120.0)
            finally:
                stop.set()
                th.join(timeout=120)
            still = mt.predict("primary", probe)
        require(not th.is_alive() and not traffic_err,
                f"live traffic during the swaps: {traffic_err[:3]}")
        require(mt.num_groups == 2, f"{mt.num_groups} geometry groups")
        require(shed >= 3 and mt.tenant_metrics("tenant2").shed == shed,
                f"the rate-limited tenant shed {shed} of 6")
        require(good.status == "committed" and good.mismatches == 0
                and good.shadow_samples >= 256,
                f"the re-packed swap: {good}")
        require(rolled.status == "rolled_back" and rolled.mismatches > 0
                and np.array_equal(still, old_probe),
                f"the changed candidate: {rolled}")
        log(f"serving stack (e): 4 tenants in {mt.num_groups} geometry "
            f"groups, every tenant's predictions equal its own predict; "
            f"tenant2 (2 req/s, burst 2) shed {shed} of 6; swap onto a "
            f"re-packed copy {good.status} ({good.shadow_samples} rows "
            f"mirrored, {good.mismatches} mismatches, cutover "
            f"{good.cutover_latency_s * 1e3:.3f} ms); one entry changed "
            f"(class {cls}, address {addr}): {rolled.status} "
            f"({rolled.mismatches} mismatches), the incumbent still serves")

        # (f) the CLI against the registry: no retraining.
        cli = {}
        arch = name.removesuffix("-reduced")
        common = ["--arch", arch, "--registry", root, "--requests", "40",
                  "--replicas", "2", "--device", dev.type] + (
                      ["--reduced"] if arch != name else [])
        for argv in ([], ["--tenants", "3", "--swap"]):
            out = io.StringIO()
            with contextlib.redirect_stdout(out):
                res = launch_serve.main(common + argv)
            text = out.getvalue()
            for line in text.splitlines():
                log(f"  launch.serve {' '.join(argv)}| {line}")
            require("no retraining" in text and res["mismatches"] == 0,
                    f"launch.serve {argv}: retrained or mismatched")
            cli[" ".join(argv) or "lut"] = res
        require(cli["--tenants 3 --swap"]["swap"].status == "committed",
                "the CLI's swap did not commit")

        # Replicas 1 vs 2 in turns: one request at a time (no admission
        # window), then the 72 requests as a burst, each its own batch
        # (no window) and coalesced (the default 2 ms window): whether
        # two executors on one card serve a burst faster than one.
        timing = {1: [], 2: []}
        for r in SERVING_TIMING_TURNS:
            turn = {}
            for wait_ms in (0.0, 2.0):
                with LUTServeEngine(chain, replicas=r, max_wait_ms=wait_ms,
                                    device=dev) as eng:
                    eng.warmup()
                    if wait_ms == 0.0:
                        got = [eng.predict(x) for x in requests]
                        rep = eng.metrics.report()
                        exact(got, want[name], f"replicas={r} one at a time")
                        turn.update(p50_ms=rep["p50_ms"], p99_ms=rep["p99_ms"])
                    t0 = time.perf_counter()
                    got = burst(eng, requests)
                    turn[f"burst_ms_wait{wait_ms:g}"] = \
                        (time.perf_counter() - t0) * 1e3
                    turn[f"forwards_wait{wait_ms:g}"] = eng.forwards
                exact(got, want[name], f"replicas={r} burst")
            timing[r].append(turn)
    finally:
        tmp.cleanup()
    # Nothing of the phase outlives it: every engine joined its
    # dispatcher and executor threads, the traffic thread ended, and the
    # host thread is back on the default stream with nothing pending.
    torch.cuda.synchronize(dev) if dev.type == "cuda" else None
    left = [t.name for t in threading.enumerate() if t not in threads0]
    require(not left, f"threads alive after the serving stack: {left}")
    require(dev.type == "cpu" or torch.cuda.current_stream(dev)
            == torch.cuda.default_stream(dev),
            "the host thread left on an executor's stream")
    k1 = {"chain": lut_cascade.launches - dag, "dag": dag}
    require(dev.type == "cpu" or (k1["chain"] > 0 and k1["dag"] > 0),
            f"the serving stack's K1 launches {k1}")
    secs = {k: sorted(v) for k, v in reg_s.items()}
    for r, turns in timing.items():
        log(f"serving stack timing, replicas={r} ({card}): one at a time "
            "p50 / p99 ms " + ", ".join(
                f"{t['p50_ms']:.3f} / {t['p99_ms']:.3f}" for t in turns)
            + "; burst of 72 requests, no window " + ", ".join(
                f"{t['burst_ms_wait0']:.2f}" for t in turns)
            + " ms, 2 ms window " + ", ".join(
                f"{t['burst_ms_wait2']:.2f} ({t['forwards_wait2']} forwards)"
                for t in turns) + " ms")
    log(f"serving stack timing, registry ({card}), {name} "
        f"({chain.num_table_bytes} table bytes), sorted over "
        f"{REGISTRY_REPS} reps: save {secs['save']} s, load (verified, "
        f"packed) {secs['load']} s, verify {secs['verify']} s")
    total = time.perf_counter() - t_phase
    log(f"serving stack: K1 launches chain {k1['chain']}, DAG {k1['dag']}; "
        f"{total:.2f} s")
    return {"k1": k1, "timing": timing, "registry_s": secs,
            "seconds": total, "swap_cutover_ms":
            good.cutover_latency_s * 1e3, "shed": shed}


def _stacked_subnet(gen, seeds, o, f, depth, width, skip, dev):
    import torch
    ps = [_rand_subnet(gen, o, f, depth, width, skip, dev)
          for _ in range(seeds)]
    return {k: [{n: torch.stack([p[k][j][n] for p in ps])
                 for n in ("w", "b")} for j in range(len(ps[0][k]))]
            for k in ps[0]}


def _weights(p):
    return ([lp["w"] for lp in p["layers"]], [lp["b"] for lp in p["layers"]],
            [sp["w"] for sp in p.get("skips", [])],
            [sp["b"] for sp in p.get("skips", [])])


def _unit_axis_layer(gen, ns, o, f, depth, width, sk, dev):
    """K4 and K5 over a leading seed (or sweep unit) axis of ``ns`` at
    B = TRAIN_B, O = ``o``, F = ``f``: one launch against the plain
    versions over the same axis and against ``ns`` separate single-unit
    launches, at the K4/K5 tolerances, and a rerun of the ``ns``-wide
    launches bit for bit.  Returns (errors and whether the single-unit
    launches gave the same bits, the operands)."""
    import torch
    from repro_torch.kernels.neuralut_grad import (subnet_train_bwd,
                                                   subnet_train_fwd)
    from repro_torch.kernels.neuralut_mlp import pack_subnet_weights
    from repro_torch.kernels.ref import (subnet_train_bwd_ref,
                                         subnet_train_fwd_ref)
    lw, lb, sw, sb = _weights(_stacked_subnet(
        gen, ns, o, f, depth, width, sk, dev))
    xg = torch.randn((ns, TRAIN_B, o, f), generator=gen).to(dev)
    g = torch.randn((ns, TRAIN_B, o), generator=gen).to(dev)
    wpack = pack_subnet_weights(lw, lb, sw, sb)
    out, acts = subnet_train_fwd(xg, lw, lb, sw, sb, skip=sk, wpack=wpack)
    grads = subnet_train_bwd(g, xg, acts, lw, lb, sw, sb, skip=sk,
                             wpack=wpack)
    r_out, r_acts = subnet_train_fwd_ref(xg, lw, lb, sw, sb, skip=sk)
    r_grads = subnet_train_bwd_ref(g, xg, r_acts, lw, sw, skip=sk)
    flat = [grads[0]] + [a for grp in grads[1:] for a in grp]
    e4 = max([_close(out, r_out, K4_RTOL, K4_ATOL)]
             + [_close(a, r, K4_RTOL, K4_ATOL)
                for a, r in zip(acts, r_acts)])
    e5 = max(_close(a, r, K5_RTOL, K5_ATOL) for a, r in
             zip(flat, [r_grads[0]] + [a for grp in r_grads[1:]
                                       for a in grp]))
    same4 = same5 = True
    for s in range(ns):
        one = [[a[s] for a in grp] for grp in (lw, lb, sw, sb)]
        o1, a1 = subnet_train_fwd(xg[s], *one, skip=sk, wpack=wpack[s])
        g1 = subnet_train_bwd(g[s], xg[s], a1, *one, skip=sk,
                              wpack=wpack[s])
        flat1 = [g1[0]] + [a for grp in g1[1:] for a in grp]
        e4 = max([e4, _close(out[s], o1, K4_RTOL, K4_ATOL)]
                 + [_close(a[s], b, K4_RTOL, K4_ATOL)
                    for a, b in zip(acts, a1)])
        e5 = max([e5] + [_close(a[s], b, K5_RTOL, K5_ATOL)
                         for a, b in zip(flat, flat1)])
        same4 &= torch.equal(out[s], o1) and all(
            torch.equal(a[s], b) for a, b in zip(acts, a1))
        same5 &= all(torch.equal(a[s], b) for a, b in zip(flat, flat1))
    o2, a2 = subnet_train_fwd(xg, lw, lb, sw, sb, skip=sk, wpack=wpack)
    g2 = subnet_train_bwd(g, xg, a2, lw, lb, sw, sb, skip=sk, wpack=wpack)
    flat2 = [g2[0]] + [a for grp in g2[1:] for a in grp]
    require(torch.equal(o2, out) and all(torch.equal(a, b) for a, b in
                                         zip(a2 + flat2, acts + flat)),
            f"K4/K5 at {ns} x O={o}: a rerun on the same inputs differs")
    torch.cuda.synchronize()
    return (dict(err4=e4, err5=e5, same4=same4, same5=same5),
            (xg, g, lw, lb, sw, sb, wpack, acts))


def phase_seed_kernels(cfg, dev):
    """K4 and K5 over a leading seed axis (S = 4, one launch) against S
    separate single-seed launches and against the plain versions over
    the same axis, at every jsc-5l training shape; device ms of one
    S = 4 launch beside one S = 1 launch."""
    import torch
    from repro_torch.kernels.neuralut_grad import (subnet_train_bwd,
                                                   subnet_train_fwd)
    gen = torch.Generator().manual_seed(19)
    ns, sk = len(ENSEMBLE_SEEDS), cfg.skip
    out_rows = []
    for i, o in enumerate(cfg.layer_widths):
        f = cfg.layer_fan_in(i)
        row, (xg, g, lw, lb, sw, sb, wpack, acts) = _unit_axis_layer(
            gen, ns, o, f, cfg.depth, cfg.width, sk, dev)
        one = [[a[0] for a in grp] for grp in (lw, lb, sw, sb)]
        o1, a1 = subnet_train_fwd(xg[0], *one, skip=sk, wpack=wpack[0])
        ms = {   # every kernel of the call, by no name
            "k4_s4": _trace_ms(lambda: subnet_train_fwd(
                xg, lw, lb, sw, sb, skip=sk, wpack=wpack), 20),
            "k4_s1": _trace_ms(lambda: subnet_train_fwd(
                xg[0], *one, skip=sk, wpack=wpack[0]), 20),
            "k5_s4": _trace_ms(lambda: subnet_train_bwd(
                g, xg, acts, lw, lb, sw, sb, skip=sk, wpack=wpack), 20),
            "k5_s1": _trace_ms(lambda: subnet_train_bwd(
                g[0], xg[0], a1, *one, skip=sk, wpack=wpack[0]), 20)}
        out_rows.append(dict(**row, **ms))
        log(f"seed axis layer {i} (O={o}, F={f}, S={ns}, B={TRAIN_B}): K4 "
            f"vs {ns} single-seed launches and the plain version max err "
            f"{row['err4']:.3e} ("
            f"{'bit-identical' if row['same4'] else 'within tolerance'}"
            f" to the single-seed launches), K5 {row['err5']:.3e} ("
            f"{'bit-identical' if row['same5'] else 'within tolerance'}); "
            "device " + ", ".join(f"{k} {v or float('nan'):.4f} ms"
                                  for k, v in ms.items()))
    return out_rows


TRAIN_SHAPE_B = (1, 37, 256, 1000)
TRAIN_SHAPE_O = (1, 5, 128)
TRAIN_SHAPE_S = (1, 3)
# (name, F, depth, width, skip, exact): jsc-5l's sub-network, the same
# without skips, neuralut-hdr-5l's fan-in, the widest width the kernels
# take, and two deep width-32 geometries whose blocks do not fit in
# shared memory at the preferred tiles: depth 10 (K5: one neuron, its
# packed row spread from global memory) and depth 16 (both kernels so,
# and K5's block sums in global scratch).  exact: K5 is held against the
# plain backward in float64 on the kernel's own activations (the same
# ReLU masks) instead of the float32 plain version and autograd: at
# depth 16 and B = 1000 the float32 plain version is itself further from
# the exact gradient than K5's tolerance.
TRAIN_GEOMETRIES = (("jsc-5l", 3, 4, 16, 2, False),
                    ("skip 0", 3, 4, 16, 0, False),
                    ("F=6", 6, 4, 16, 2, False),
                    ("width 32", 3, 4, 32, 2, False),
                    ("depth 10", 32, 10, 32, 1, True),
                    ("depth 16", 32, 16, 32, 1, True))


def _flat_grads(r):
    return [r[0]] + [a for grp in r[1:] for a in grp]


def phase_train_shapes(dev):
    """K4 and K5 beyond the training batch: every B x O x S of
    TRAIN_SHAPE_* for each of TRAIN_GEOMETRIES (ragged rows and neurons,
    one row, several row tiles per cluster rank) against the plain
    versions, K5 also against torch autograd of the plain grouped
    sub-network; a rerun bit for bit, and every seed of a seed-axis
    launch bit for bit against a single-seed launch on its operands."""
    import torch
    from repro_torch.kernels.neuralut_grad import (ACC_GLOBAL, STAGED,
                                                   plan_train_launch,
                                                   subnet_train_bwd,
                                                   subnet_train_fwd)
    from repro_torch.kernels.neuralut_mlp import pack_subnet_weights
    from repro_torch.kernels.ref import (grouped_subnet_ref,
                                         subnet_train_bwd_ref,
                                         subnet_train_fwd_ref)
    gen = torch.Generator().manual_seed(23)
    e4max = e5max = 0.0
    cases, plans = 0, []
    for name, f, depth, width, sk, exact in TRAIN_GEOMETRIES:
        for o in TRAIN_SHAPE_O:
            for b in TRAIN_SHAPE_B:
                for ns in TRAIN_SHAPE_S:
                    where = f"{name} B={b} O={o} S={ns}"
                    lw, lb, sw, sb = _weights(_stacked_subnet(
                        gen, ns, o, f, depth, width, sk, dev))
                    xg = torch.randn((ns, b, o, f), generator=gen).to(dev)
                    g = torch.randn((ns, b, o), generator=gen).to(dev)
                    wpack = pack_subnet_weights(lw, lb, sw, sb)
                    try:
                        out, acts = subnet_train_fwd(xg, lw, lb, sw, sb,
                                                     skip=sk, wpack=wpack)
                        grads = _flat_grads(subnet_train_bwd(
                            g, xg, acts, lw, lb, sw, sb, skip=sk,
                            wpack=wpack))
                        r_out, r_acts = subnet_train_fwd_ref(
                            xg, lw, lb, sw, sb, skip=sk)
                        if exact:
                            r_grads = _flat_grads(subnet_train_bwd_ref(
                                *[[a.double() for a in grp] if isinstance(
                                    grp, list) else grp.double()
                                  for grp in (g, xg, acts, lw, sw)],
                                skip=sk))
                        else:
                            r_grads = _flat_grads(subnet_train_bwd_ref(
                                g, xg, r_acts, lw, sw, skip=sk))
                        e4 = max([_close(out, r_out, K4_RTOL, K4_ATOL)]
                                 + [_close(a, r, K4_RTOL, K4_ATOL)
                                    for a, r in zip(acts, r_acts)])
                        e5 = max(_close(a, r, K5_RTOL, K5_ATOL)
                                 for a, r in zip(grads, r_grads))
                        out2, acts2 = subnet_train_fwd(
                            xg, lw, lb, sw, sb, skip=sk, wpack=wpack)
                        grads2 = _flat_grads(subnet_train_bwd(
                            g, xg, acts, lw, lb, sw, sb, skip=sk,
                            wpack=wpack))
                        require(torch.equal(out, out2) and all(
                            torch.equal(a, c) for a, c in zip(acts, acts2)),
                            "K4 rerun differs")
                        require(all(torch.equal(a, c)
                                    for a, c in zip(grads, grads2)),
                                "K5 rerun differs")
                        for s in range(ns):
                            one = [[a[s] for a in grp]
                                   for grp in (lw, lb, sw, sb)]
                            o1, a1 = subnet_train_fwd(
                                xg[s], *one, skip=sk, wpack=wpack[s])
                            g1 = _flat_grads(subnet_train_bwd(
                                g[s], xg[s], a1, *one, skip=sk,
                                wpack=wpack[s]))
                            require(torch.equal(out[s], o1) and all(
                                torch.equal(a[s], c)
                                for a, c in zip(acts, a1)),
                                f"K4 seed {s} differs from its single-seed "
                                "launch")
                            require(all(torch.equal(a[s], c)
                                        for a, c in zip(grads, g1)),
                                    f"K5 seed {s} differs from its "
                                    "single-seed launch")
                            if exact:
                                continue
                            req = [a.detach().clone().requires_grad_(True)
                                   for a in [xg[s]] + [x for grp in one
                                                       for x in grp]]
                            nl, nch = len(lw), len(sw)
                            y = grouped_subnet_ref(
                                req[0], req[1:1 + nl], req[1 + nl:1 + 2 * nl],
                                req[1 + 2 * nl:1 + 2 * nl + nch],
                                req[1 + 2 * nl + nch:], skip=sk)
                            auto = torch.autograd.grad(y, req,
                                                       grad_outputs=g[s])
                            e5 = max([e5] + [_close(a, c, K5_RTOL, K5_ATOL)
                                             for a, c in zip(g1, auto)])
                        torch.cuda.synchronize()
                    except RuntimeError as err:
                        raise RuntimeError(f"{where}: {err}") from err
                    e4max, e5max = max(e4max, e4), max(e5max, e5)
                    cases += 1
        plan = plan_train_launch(max(TRAIN_SHAPE_S), max(TRAIN_SHAPE_B),
                                 max(TRAIN_SHAPE_O),
                                 [f] + [width] * (depth - 1) + [1], sk)
        plans.append(plan)
        log(f"train shapes {name} (F={f}, depth {depth}, width {width}, "
            f"skip {sk}): B {TRAIN_SHAPE_B} x O {TRAIN_SHAPE_O} x S "
            f"{TRAIN_SHAPE_S} within tolerance (K5 against "
            f"{'the float64 plain version' if exact else 'plain and autograd'}"
            f"), reruns and seed members bit-identical; plan at B=1000, "
            f"O=128, S=3: {plan}")
    branch_rows = _branch_shapes(dev, gen)
    taken = {("K4", p.fwd_group, p.fwd_flags) for p in plans} | {
        ("K5", p.bwd_group, p.bwd_flags) for p in plans}
    want = {("K4", 4, STAGED), ("K4", 1, 0), ("K5", 2, STAGED),
            ("K5", 1, 0), ("K5", 1, ACC_GLOBAL)}
    require(want <= taken, f"the geometries took the plans {taken}, not "
            f"every one of {want}")
    log(f"train shapes: {cases} cases, K4 max err {e4max:.3e}, K5 max err "
        f"{e5max:.3e}")
    return dict(cases=cases, err4=e4max, err5=e5max, branches=branch_rows)


def _branch_shapes(dev, gen):
    """K4 and K5 at the branch widths of polylut-add-jsc-5l (O =
    GRAPH_BRANCH_O; F 3, L 4, N 16, S 2) at the training batch, for S =
    GRAPH_BRANCH_S: against the plain versions (K5 also against
    autograd), one kernel per call by the profiler's count, device ms
    beside the bound."""
    import torch
    from repro_torch.kernels.neuralut_grad import (subnet_train_bwd,
                                                   subnet_train_fwd)
    from repro_torch.kernels.neuralut_mlp import pack_subnet_weights
    from repro_torch.kernels.ref import (grouped_subnet_ref,
                                         subnet_train_bwd_ref,
                                         subnet_train_fwd_ref)
    f, depth, width, sk = 3, 4, 16, 2
    rows = []
    for o in GRAPH_BRANCH_O:
        for ns in GRAPH_BRANCH_S:
            lw, lb, sw, sb = _weights(_stacked_subnet(
                gen, ns, o, f, depth, width, sk, dev))
            xg = torch.randn((ns, TRAIN_B, o, f), generator=gen).to(dev)
            g = torch.randn((ns, TRAIN_B, o), generator=gen).to(dev)
            wpack = pack_subnet_weights(lw, lb, sw, sb)
            out, acts = subnet_train_fwd(xg, lw, lb, sw, sb, skip=sk,
                                         wpack=wpack)
            grads = _flat_grads(subnet_train_bwd(g, xg, acts, lw, lb, sw, sb,
                                                 skip=sk, wpack=wpack))
            r_out, r_acts = subnet_train_fwd_ref(xg, lw, lb, sw, sb, skip=sk)
            r_grads = _flat_grads(subnet_train_bwd_ref(g, xg, r_acts, lw, sw,
                                                       skip=sk))
            e4 = max([_close(out, r_out, K4_RTOL, K4_ATOL)]
                     + [_close(a, r, K4_RTOL, K4_ATOL)
                        for a, r in zip(acts, r_acts)])
            e5 = max(_close(a, r, K5_RTOL, K5_ATOL)
                     for a, r in zip(grads, r_grads))
            req = [a.detach().clone().requires_grad_(True)
                   for a in [xg] + lw + lb + sw + sb]
            nl, nch = len(lw), len(sw)
            y = torch.stack([grouped_subnet_ref(
                req[0][s], [a[s] for a in req[1:1 + nl]],
                [a[s] for a in req[1 + nl:1 + 2 * nl]],
                [a[s] for a in req[1 + 2 * nl:1 + 2 * nl + nch]],
                [a[s] for a in req[1 + 2 * nl + nch:]], skip=sk)
                for s in range(ns)])
            auto = torch.autograd.grad(y, req, grad_outputs=g)
            e5 = max([e5] + [_close(a, c, K5_RTOL, K5_ATOL)
                             for a, c in zip(grads, auto)])
            torch.cuda.synchronize()
            k4 = lambda: subnet_train_fwd(xg, lw, lb, sw, sb, skip=sk,
                                          wpack=wpack)
            k5 = lambda: subnet_train_bwd(g, xg, acts, lw, lb, sw, sb,
                                          skip=sk, wpack=wpack)
            tm4 = timings(k4, lambda: subnet_train_fwd_ref(
                xg, lw, lb, sw, sb, skip=sk), "", 20, 5)
            tm5 = timings(k5, lambda: subnet_train_bwd_ref(
                g, xg, r_acts, lw, sw, skip=sk), "", 20, 5)
            macs = sum(int(w.shape[-2] * w.shape[-1]) for w in lw + sw)
            wbytes = 4.0 * sum(a.numel() for a in lw + lb + sw + sb)
            abytes = 4.0 * sum(a.numel() for a in acts)
            fwd_flops = 2.0 * macs * ns * TRAIN_B * o
            b4 = bound_ms(4.0 * (xg.numel() + out.numel()) + wbytes + abytes,
                          fwd_flops)
            b5 = bound_ms(4.0 * (g.numel() + 2 * xg.numel()) + abytes
                          + 2 * wbytes, 2.0 * fwd_flops)
            per = (kernels_per_call(k4), kernels_per_call(k5))
            require(per == (1, 1), f"branch O={o} S={ns}: {per} device "
                    "activities per K4 / K5 call, want 1")
            rows.append(dict(o=o, seeds=ns, err4=e4, err5=e5,
                             k4_ms=tm4["ms"], k4_plain_ms=tm4["plain_ms"],
                             k4_bound_ms=b4[0], k5_ms=tm5["ms"],
                             k5_plain_ms=tm5["plain_ms"], k5_bound_ms=b5[0],
                             timing=tm4["timing"]))
            log(f"graph branch shape O={o} F={f} S={ns} B={TRAIN_B}: K4 max "
                f"err {e4:.3e}, {tm4['ms']:.4f} ms (plain {tm4['plain_ms']:.4f}"
                f", bound {b4[0]:.5f} {b4[1]}); K5 max err {e5:.3e} (vs plain "
                f"and autograd), {tm5['ms']:.4f} ms (plain "
                f"{tm5['plain_ms']:.4f}, bound {b5[0]:.5f} {b5[1]}); "
                f"[{tm4['timing']}/{tm5['timing']}] 1 kernel per call")
    return rows


def phase_ensemble_path(cfg, dev):
    """The seed ensemble at full neuralut-jsc-5l: 4 seeds trained
    together (one seed-axis K4 and K5 call per layer per step), the best
    member converted through K2 and served through K1; a bit-identical
    rerun of ten ensemble steps; steps/s and the busy share of an epoch
    at S = 4 beside S = 1."""
    import numpy as np
    import torch
    from torch.profiler import ProfilerActivity, profile
    from repro_torch.core import lut_infer as LI
    from repro_torch.core import model as M
    from repro_torch.core import train as TR
    from repro_torch.core import truth_table as TT
    from repro_torch.core.exec_plan import plan_subnet_exec
    from repro_torch.data import device_dataset, jsc_synthetic
    from repro_torch.kernels.lut_cascade import lut_cascade
    from repro_torch.kernels.neuralut_grad import (subnet_train_bwd,
                                                   subnet_train_fwd)
    from repro_torch.kernels.neuralut_mlp import grouped_subnet
    from repro_torch.serve import LUTServeEngine, bundle_from_training

    xtr, ytr = device_dataset(jsc_synthetic, 20000, seed=0, device=dev)
    xte, yte = device_dataset(jsc_synthetic, 4000, seed=1, device=dev)
    steps_per_epoch = len(xtr) // TRAIN_B
    steps = ENSEMBLE_EPOCHS * steps_per_epoch
    ns = len(ENSEMBLE_SEEDS)
    kernels = {"lut_cascade": lut_cascade, "grouped_subnet": grouped_subnet,
               "subnet_train_fwd": subnet_train_fwd,
               "subnet_train_bwd": subnet_train_bwd}
    for fn in kernels.values():
        fn.launches = 0
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    params, state, hist = TR.train_neuralut_ensemble(
        cfg, xtr, ytr, xte, yte, seeds=ENSEMBLE_SEEDS,
        epochs=ENSEMBLE_EPOCHS, batch=TRAIN_B, lr=2e-3, weight_decay=1e-4,
        device=dev)
    t1 = time.perf_counter()   # the history's fetch synchronized
    train_launches = {k: fn.launches for k, fn in kernels.items()}
    final_q = hist["test_acc_q"][-1]
    best = int(final_q.argmax())
    p_best, s_best = TR.ensemble_member(params, state, best)
    statics = M.model_static(cfg)
    tables, packed = TT.convert_packed(cfg, p_best, s_best, statics)
    bundle = bundle_from_training(cfg, p_best, tables, statics,
                                  packed_tables=packed)
    with LUTServeEngine(bundle, device=dev) as eng:
        served = eng.predict(xte.cpu().numpy())
    launches = {k: fn.launches for k, fn in kernels.items()}
    log(f"ensemble path: {ns} seeds x {steps} steps in {t1 - t0:.3f} s "
        f"({steps / (t1 - t0):.2f} ensemble steps/s, "
        f"{ns * steps / (t1 - t0):.2f} seed-steps/s, incl. eval)")
    log(f"ensemble history: " + json.dumps(
        {k: v.tolist() for k, v in hist.items()}))
    log(f"ensemble launches: {launches} (training alone {train_launches})")
    for k in ("subnet_train_fwd", "subnet_train_bwd"):
        require(train_launches[k] == cfg.num_layers * steps,
                f"{k}: {train_launches[k]} calls in {steps} ensemble steps, "
                f"want {cfg.num_layers} per step whatever S")
    require(launches["grouped_subnet"] > 0, "conversion never launched K2")
    require(launches["lut_cascade"] > 0, "serving never launched K1")
    require(all(np.isfinite(v).all() for v in hist.values()),
            "non-finite ensemble history")
    require(bool((hist["loss"][-1] < hist["loss"][0]).all()),
            f"the loss of some seed did not fall: {hist['loss'].tolist()}")
    w = params["layers"][0]["fn"]["layers"][0]["w"]
    require(all(not torch.equal(w[a], w[b]) for a in range(ns)
                for b in range(a + 1, ns)), "two members are equal")
    want = LI.predict(cfg, p_best, tables, statics, xte).cpu().numpy()
    mismatched = int((served != want).sum())
    require(mismatched == 0, f"{mismatched} served predictions of the best "
            "member differ from the plain lut_infer.predict")
    log(f"ensemble: acc_q per seed {[round(float(a), 4) for a in final_q]}"
        f", best seed {best}; all {len(served)} served predictions of the "
        "best member equal the plain predict")

    # Rerun: ten ensemble steps from the same init, bit for bit.
    sd = M.device_statics(statics, dev)
    plan = plan_subnet_exec(cfg, purpose="train", device=dev)
    require(plan.route == "kernel_train", f"train plan {plan.route}")
    step = TR.make_ensemble_step_fn(cfg, lr=2e-3, weight_decay=1e-4,
                                    t0=steps, exec_plan=plan)

    def batches(seeds):
        return torch.stack([TR.epoch_batches(len(xtr), steps_per_epoch,
                                             TRAIN_B, seed=s, epoch=0,
                                             device=dev) for s in seeds],
                           dim=1)

    def run(init, idx):     # idx: (steps, S, batch)
        p, s, o = init
        st = TR.unit_statics(sd, idx.shape[1])
        for ib in idx:
            p, s, o, _ = step(p, s, o, st, xtr[ib], ytr[ib])
        torch.cuda.synchronize()
        return _flat(p) + _flat(s) + _flat(o)
    init = TR.init_ensemble(cfg, ENSEMBLE_SEEDS, xtr, device=dev)
    idx = batches(ENSEMBLE_SEEDS)[:RERUN_STEPS]
    a, b = run(init, idx), run(init, idx)
    require(all(torch.equal(x, y) for x, y in zip(a, b)),
            f"{RERUN_STEPS} ensemble steps rerun from the same init differ")
    log(f"ensemble rerun: {RERUN_STEPS} steps of {ns} seeds twice give "
        f"bit-identical params, BN state and opt state ({len(a)} tensors)")

    # steps/s, busy share and K4/K5 device time per step at S = 4 and 1:
    # one warm-up epoch each, then timed epochs in turns (4, 1, 1, 4),
    # since host time varies between epochs on a shared machine, then
    # one profiled epoch each.
    runs = {len(seeds): (TR.init_ensemble(cfg, seeds, xtr, device=dev),
                         batches(seeds))
            for seeds in (ENSEMBLE_SEEDS, ENSEMBLE_SEEDS[:1])}
    walls = {n: [] for n in runs}
    for n in runs:
        run(*runs[n])
    for n in (ns, 1, 1, ns):
        te = time.perf_counter()
        run(*runs[n])
        walls[n].append(time.perf_counter() - te)
    by_s = {}
    for n, (init, idx) in runs.items():
        wall = sum(walls[n]) / len(walls[n])
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            run(init, idx)
        ev = [(e.self_device_time_total, e.key) for e in prof.key_averages()
              if e.self_device_time_total > 0]
        busy = sum(u for u, _ in ev) / 1e6
        k4 = sum(u for u, k in ev if "subnet_train_fwd_kernel" in k)
        k5 = sum(u for u, k in ev if "subnet_train_bwd_kernel" in k)
        by_s[n] = dict(
            steps_s=steps_per_epoch / wall, epoch_s=wall,
            epoch_s_each=walls[n], busy_share=busy / wall,
            k4_ms_step=k4 / 1e3 / steps_per_epoch,
            k5_ms_step=k5 / 1e3 / steps_per_epoch,
            device_ms_step=busy * 1e3 / steps_per_epoch)
        log(f"ensemble epoch S={n} ({steps_per_epoch} steps, no eval): "
            f"{wall:.3f} s wall (epochs {[round(w, 3) for w in walls[n]]}), "
            f"{steps_per_epoch / wall:.2f} steps/s, device busy "
            f"{busy:.4f} s = {busy / wall:.4f}; per step K4 "
            f"{by_s[n]['k4_ms_step']:.4f} ms, K5 "
            f"{by_s[n]['k5_ms_step']:.4f} ms, all device "
            f"{by_s[n]['device_ms_step']:.4f} ms")
        log("  device time by kernel (ms): " + ", ".join(
            f"{k[:48]} {u / 1e3:.2f}" for u, k in sorted(ev, reverse=True)[:8]))
    return dict(launches=launches, steps=steps, train_s=t1 - t0,
                best=best, acc_q=final_q.tolist(), by_s=by_s)


def _epoch_profile(run, steps):
    """Wall s of one epoch ``run()`` (warmed up, no profiler), then the
    device time of a profiled epoch: (wall, busy s, K4 ms per step, K5
    ms per step, top kernels)."""
    import torch
    from torch.profiler import ProfilerActivity, profile
    run()
    torch.cuda.synchronize()
    te = time.perf_counter()
    run()
    torch.cuda.synchronize()
    wall = time.perf_counter() - te
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        run()
        torch.cuda.synchronize()
    ev = [(e.self_device_time_total, e.key) for e in prof.key_averages()
          if e.self_device_time_total > 0]
    busy = sum(u for u, _ in ev) / 1e6
    k4 = sum(u for u, k in ev if "subnet_train_fwd_kernel" in k) / 1e3
    k5 = sum(u for u, k in ev if "subnet_train_bwd_kernel" in k) / 1e3
    return wall, busy, k4 / steps, k5 / steps, sorted(ev, reverse=True)[:8]


def _step_kernel_count(step_once, traces: int = 5):
    """CUDA kernels named subnet_train_fwd_kernel / _bwd_kernel in a
    profiled trace of one step ``step_once()``, with the wrappers' calls
    in that step: (K4 kernels, K5 kernels, K4 calls, K5 calls).  A trace
    now and then misses a kernel, never adds one: each count is the
    largest of up to ``traces`` traces, stopping once both reach their
    calls."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    from repro_torch.kernels.neuralut_grad import (subnet_train_bwd,
                                                   subnet_train_fwd)
    step_once()
    torch.cuda.synchronize()
    c4 = c5 = 0
    for _ in range(traces):
        l4, l5 = subnet_train_fwd.launches, subnet_train_bwd.launches
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            step_once()
            torch.cuda.synchronize()
        n4 = subnet_train_fwd.launches - l4
        n5 = subnet_train_bwd.launches - l5
        ev = sorted((e.time_range.start, e.name) for e in prof.events()
                    if e.device_type == DeviceType.CUDA)
        c4 = max(c4, sum("subnet_train_fwd_kernel" in n for _, n in ev))
        c5 = max(c5, sum("subnet_train_bwd_kernel" in n for _, n in ev))
        if (c4, c5) == (n4, n5):
            break
        log(f"  a trace of one step: {n4} K4 / {n5} K5 calls, its K4/K5 "
            "kernels in order: " + "".join(
                "F" if "fwd_kernel" in n else "B" for _, n in ev
                if "subnet_train" in n) + f" ({len(ev)} device events)")
    return c4, c5, n4, n5


def _served_check(cfg, params, tables, statics, served, xte, what):
    from repro_torch.core import lut_infer as LI
    want = LI.predict(cfg, params, tables, statics, xte).cpu().numpy()
    mismatched = int((served != want).sum())
    require(mismatched == 0, f"{what}: {mismatched} served predictions "
            "differ from the plain lut_infer.predict")


def _flips(tables, plain_tables, what) -> int:
    """Entries where two conversions differ; fails beyond +-1 code."""
    import numpy as np
    flips = 0
    for i, (node, pnode) in enumerate(zip(tables, plain_tables)):
        node = node if isinstance(node, list) else [node]
        pnode = pnode if isinstance(pnode, list) else [pnode]
        for a, (t, pt) in enumerate(zip(node, pnode)):
            d = np.abs(t.astype(np.int32) - pt.astype(np.int32))
            require(int(d.max()) <= 1, f"{what} node {i} branch {a}: the "
                    f"conversions differ by {int(d.max())} codes")
            flips += int((d != 0).sum())
    return flips


def phase_graph_train_path(cfg, dev):
    """Training a LUT graph at full polylut-add-jsc-5l: train_neuralut on
    kernel_train (one K4 and one K5 call per branch per step, each one
    kernel), conversion through K2 once per branch, a graph bundle, the
    engine on K1's DAG schedule; one step's gradients against the plain
    autograd route; steps/s, busy share and K4/K5 device ms per step;
    then GRAPH_ENSEMBLE_SEEDS seeds together (still one seed-axis call
    per branch per step), the best member served."""
    import numpy as np
    import torch
    from repro_torch.core import model as M
    from repro_torch.core import train as TR
    from repro_torch.core import truth_table as TT
    from repro_torch.core.exec_plan import plan_subnet_exec
    from repro_torch.data import device_dataset, jsc_synthetic
    from repro_torch.kernels.lut_cascade import lut_cascade
    from repro_torch.kernels.lut_gather import lut_layer, lut_lookup
    from repro_torch.kernels.neuralut_grad import (subnet_train_bwd,
                                                   subnet_train_fwd)
    from repro_torch.kernels.neuralut_mlp import grouped_subnet
    from repro_torch.optim import adamw_init
    from repro_torch.serve import LUTServeEngine, bundle_from_training

    branches = sum(nd.arity for nd in cfg.nodes)
    xtr, ytr = device_dataset(jsc_synthetic, 20000, seed=0, device=dev)
    xte, yte = device_dataset(jsc_synthetic, 4000, seed=1, device=dev)
    spe = len(xtr) // TRAIN_B
    kernels = {"lut_cascade": lut_cascade, "grouped_subnet": grouped_subnet,
               "subnet_train_fwd": subnet_train_fwd,
               "subnet_train_bwd": subnet_train_bwd, "lut_lookup": lut_lookup,
               "lut_layer": lut_layer}

    def counts():
        return {k: fn.launches for k, fn in kernels.items()}

    def serve(params, state, what):
        statics = M.model_static(cfg)
        for fn in kernels.values():
            fn.launches = 0
        t0 = time.perf_counter()
        tables, packed = TT.convert_packed(cfg, params, state, statics)
        conv = counts()
        t1 = time.perf_counter()
        bundle = bundle_from_training(cfg, params, tables, statics,
                                      packed_tables=packed)
        with LUTServeEngine(bundle, device=dev) as eng:
            served = eng.predict(xte.cpu().numpy())
        t2 = time.perf_counter()
        launches = counts()
        require(conv["grouped_subnet"] == branches, f"{what}: conversion "
                f"launched K2 {conv['grouped_subnet']} times, want one per "
                f"branch ({branches})")
        require(launches["lut_cascade"] > 0
                and launches["lut_lookup"] == launches["lut_layer"] == 0,
                f"{what}: serving launched {launches}, want K1 and no K3")
        plain, _ = TT.convert_packed(cfg, params, state, statics,
                                     use_subnet_kernel=False)
        flips = _flips(tables, plain, what)
        _served_check(cfg, params, tables, statics, served, xte, what)
        acc = float((served == yte.cpu().numpy()).mean())
        log(f"{what}: convert {t1 - t0:.3f} s ({branches} K2 launches, "
            f"{flips} flips of {sum(t.size for n in tables for t in n)} "
            f"entries against the plain conversion), serve {len(served)} "
            f"rows {t2 - t1:.3f} s; every prediction equals the plain "
            f"predict; served accuracy {acc:.4f}; launches {launches}")
        return launches, flips, acc

    # one seed
    for fn in kernels.values():
        fn.launches = 0
    steps = GRAPH_TRAIN_EPOCHS * spe
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    params, state, hist = TR.train_neuralut(
        cfg, xtr, ytr, xte, yte, epochs=GRAPH_TRAIN_EPOCHS, batch=TRAIN_B,
        lr=2e-3, weight_decay=1e-4, seed=0, device=dev)
    t1 = time.perf_counter()
    train_launches = counts()
    log(f"graph train path ({cfg.name}, {branches} branches): {steps} steps "
        f"in {t1 - t0:.3f} s ({steps / (t1 - t0):.2f} steps/s incl. eval); "
        f"history {json.dumps(hist)}; training launches {train_launches}")
    for k in ("subnet_train_fwd", "subnet_train_bwd"):
        require(train_launches[k] == branches * steps,
                f"graph {k}: {train_launches[k]} calls in {steps} steps, want "
                f"{branches} per step (one per branch)")
    require(train_launches["grouped_subnet"] == 0, "training launched K2")
    require(all(np.isfinite(v) for vs in hist.values() for v in vs),
            "non-finite graph training history")
    require(hist["loss"][-1] < hist["loss"][0],
            f"graph loss did not fall: {hist['loss']}")
    serve_launches, flips, acc = serve(params, state, "graph train path")

    # one step from the same init: kernel_train against plain autograd,
    # and one kernel for each wrapper call in a profiled step
    sd = M.device_statics(M.model_static(cfg), dev)
    p0, s0 = M.model_init(cfg, torch.Generator().manual_seed(0), device=dev)
    p0 = M.calibrate_in_quant(cfg, p0, xtr)
    ib = TR.epoch_batches(len(xtr), spe, TRAIN_B, seed=0, epoch=0,
                          device=dev)
    plan_k = plan_subnet_exec(cfg, purpose="train", device=dev)
    plan_c = plan_subnet_exec(cfg, purpose="train", device=dev,
                              route="canonical")
    require(plan_k.route == "kernel_train", f"train plan {plan_k.route}")
    lk, gk, sk = TR.loss_and_grads(cfg, p0, s0, sd, xtr[ib[0]], ytr[ib[0]],
                                   exec_plan=plan_k)
    lc, gc, sc = TR.loss_and_grads(cfg, p0, s0, sd, xtr[ib[0]], ytr[ib[0]],
                                   exec_plan=plan_c)
    torch.cuda.synchronize()
    gerr = max(_close(a, b, K5_RTOL, K5_ATOL)
               for a, b in zip(_flat(gk), _flat(gc)))
    serr = max(_close(a, b, K4_RTOL, K4_ATOL)
               for a, b in zip(_flat(sk), _flat(sc)))
    step = TR.make_step_fn(cfg, lr=2e-3, weight_decay=1e-4, t0=steps,
                           exec_plan=plan_k)
    c4, c5, n4, n5 = _step_kernel_count(lambda: step(
        p0, s0, adamw_init(p0), sd, xtr[ib[0]], ytr[ib[0]]))
    require((n4, n5) == (branches, branches) and (c4, c5) == (n4, n5),
            f"one graph step: {n4} K4 and {n5} K5 wrapper calls, {c4} K4 and "
            f"{c5} K5 kernels in its trace; want {branches} of each")
    log(f"graph step 1: loss kernel_train {float(lk):.7f} canonical "
        f"{float(lc):.7f}; {len(_flat(gk))} gradient leaves within rtol "
        f"{K5_RTOL} / atol {K5_ATOL} (max err {gerr:.3e}), BN state max err "
        f"{serr:.3e}; a profiled step holds {c4} K4 and {c5} K5 kernels for "
        f"{n4} / {n5} wrapper calls: 1 kernel per call")

    def epoch():
        p, s, o = p0, s0, adamw_init(p0)
        for k in range(spe):
            p, s, o, _ = step(p, s, o, sd, xtr[ib[k]], ytr[ib[k]])
    wall, busy, k4, k5, top = _epoch_profile(epoch, spe)
    one = dict(steps_s=spe / wall, epoch_s=wall, busy_share=busy / wall,
               k4_ms_step=k4, k5_ms_step=k5, device_ms_step=busy * 1e3 / spe)
    log(f"graph training epoch S=1 ({spe} steps, no eval): {wall:.3f} s, "
        f"{spe / wall:.2f} steps/s, device busy {busy:.4f} s = "
        f"{busy / wall:.4f}; per step K4 {k4:.4f} ms + K5 {k5:.4f} ms over "
        f"{branches} branches, all device {busy * 1e3 / spe:.4f} ms")
    log("  device time by kernel (ms): " + ", ".join(
        f"{k[:48]} {u / 1e3:.2f}" for u, k in top))

    # the ensemble
    ns = len(GRAPH_ENSEMBLE_SEEDS)
    esteps = GRAPH_ENSEMBLE_EPOCHS * spe
    for fn in kernels.values():
        fn.launches = 0
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    eparams, estate, ehist = TR.train_neuralut_ensemble(
        cfg, xtr, ytr, xte, yte, seeds=GRAPH_ENSEMBLE_SEEDS,
        epochs=GRAPH_ENSEMBLE_EPOCHS, batch=TRAIN_B, lr=2e-3,
        weight_decay=1e-4, device=dev)
    t1 = time.perf_counter()
    ens_launches = counts()
    for k in ("subnet_train_fwd", "subnet_train_bwd"):
        require(ens_launches[k] == branches * esteps,
                f"graph ensemble {k}: {ens_launches[k]} calls in {esteps} "
                f"steps, want {branches} per step whatever S")
    require(all(np.isfinite(v).all() for v in ehist.values()),
            "non-finite graph ensemble history")
    final_q = ehist["test_acc_q"][-1]
    best = int(final_q.argmax())
    log(f"graph ensemble: {ns} seeds x {esteps} steps in {t1 - t0:.3f} s "
        f"({esteps / (t1 - t0):.2f} ensemble steps/s incl. eval); acc_q per "
        f"seed {[round(float(a), 4) for a in final_q]}, best {best}; "
        f"training launches {ens_launches}")
    pb, sb = TR.ensemble_member(eparams, estate, best)
    ens_serve, ens_flips, _ = serve(pb, sb, "graph ensemble best member")
    estep = TR.make_ensemble_step_fn(cfg, lr=2e-3, weight_decay=1e-4,
                                     t0=esteps, exec_plan=plan_k)
    einit = TR.init_ensemble(cfg, GRAPH_ENSEMBLE_SEEDS, xtr, device=dev)
    esd = TR.unit_statics(sd, ns)
    eidx = torch.stack([TR.epoch_batches(len(xtr), spe, TRAIN_B, seed=s,
                                         epoch=0, device=dev)
                        for s in GRAPH_ENSEMBLE_SEEDS], dim=1)
    # Logged, not required: late in this process a trace of the vmapped
    # step misses one K4 kernel (6 of 7 in every trace of two full runs;
    # 7 of 7 with this phase alone in a fresh process).  One kernel per
    # seed-axis call is required at every branch shape, S = 1 and 4, in
    # phase_train_shapes (GRAPH_BRANCH_O), and 7 calls per step above.
    c4, c5, n4, n5 = _step_kernel_count(lambda: estep(
        *einit, esd, xtr[eidx[0]], ytr[eidx[0]]))
    require((n4, n5) == (branches, branches),
            f"one graph ensemble step: {n4} K4 / {n5} K5 calls; want "
            f"{branches} of each")

    def eepoch():
        p, s, o = einit
        for k in range(spe):
            p, s, o, _ = estep(p, s, o, esd, xtr[eidx[k]], ytr[eidx[k]])
    wall, busy, k4, k5, top = _epoch_profile(eepoch, spe)
    four = dict(steps_s=spe / wall, epoch_s=wall, busy_share=busy / wall,
                k4_ms_step=k4, k5_ms_step=k5,
                device_ms_step=busy * 1e3 / spe)
    log(f"graph ensemble epoch S={ns} ({spe} steps, no eval): {wall:.3f} s, "
        f"{spe / wall:.2f} steps/s, device busy {busy:.4f} s = "
        f"{busy / wall:.4f}; per step K4 {k4:.4f} ms + K5 {k5:.4f} ms over "
        f"{branches} branches (one seed-axis launch each), all device "
        f"{busy * 1e3 / spe:.4f} ms; a profiled step shows {c4} K4 and {c5} "
        f"K5 kernels for {n4} / {n5} calls")
    log("  device time by kernel (ms): " + ", ".join(
        f"{k[:48]} {u / 1e3:.2f}" for u, k in top))
    return dict(
        train=dict(launches={k: train_launches[k] + serve_launches[k]
                             for k in kernels}, steps=steps,
                   train_s=t1 - t0, flips=flips, served_acc=acc,
                   grad_err=gerr, **one),
        ensemble=dict(launches={k: ens_launches[k] + ens_serve[k]
                                for k in kernels}, steps=esteps, seeds=ns,
                      best=best, flips=ens_flips, **four))


def phase_kinds(cfg, dev):
    """The LogicNets (linear) and PolyLUT (poly, degree 2) kinds on the
    JSC chain geometry ``cfg``: trained for KIND_EPOCHS on the plain route
    (no K2, K4 or K5 launch: these kinds have no kernel), converted,
    served through K1's chain; every prediction equals ``predict``, the
    tables equal the same conversion on the CPU but for +-1 flips."""
    import dataclasses
    import numpy as np
    import torch
    from repro_torch.core import model as M
    from repro_torch.core import train as TR
    from repro_torch.core import truth_table as TT
    from repro_torch.data import device_dataset, jsc_synthetic
    from repro_torch.kernels.lut_cascade import lut_cascade
    from repro_torch.kernels.lut_gather import lut_layer, lut_lookup
    from repro_torch.kernels.neuralut_grad import (subnet_train_bwd,
                                                   subnet_train_fwd)
    from repro_torch.kernels.neuralut_mlp import grouped_subnet
    from repro_torch.serve import LUTServeEngine, bundle_from_training
    from repro_torch.tree import tree_map

    xtr, ytr = device_dataset(jsc_synthetic, 20000, seed=0, device=dev)
    xte, yte = device_dataset(jsc_synthetic, 4000, seed=1, device=dev)
    kernels = {"lut_cascade": lut_cascade, "grouped_subnet": grouped_subnet,
               "subnet_train_fwd": subnet_train_fwd,
               "subnet_train_bwd": subnet_train_bwd, "lut_lookup": lut_lookup,
               "lut_layer": lut_layer}
    out = {}
    for kind in ("linear", "poly"):
        kcfg = dataclasses.replace(cfg, kind=kind, degree=2)
        steps = KIND_EPOCHS * (len(xtr) // TRAIN_B)
        for fn in kernels.values():
            fn.launches = 0
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        params, state, hist = TR.train_neuralut(
            kcfg, xtr, ytr, xte, yte, epochs=KIND_EPOCHS, batch=TRAIN_B,
            lr=2e-3, weight_decay=1e-4, seed=0, device=dev)
        t1 = time.perf_counter()
        statics = M.model_static(kcfg)
        tables, packed = TT.convert_packed(kcfg, params, state, statics)
        t2 = time.perf_counter()
        bundle = bundle_from_training(kcfg, params, tables, statics,
                                      packed_tables=packed)
        with LUTServeEngine(bundle, device=dev) as eng:
            served = eng.predict(xte.cpu().numpy())
        launches = {k: fn.launches for k, fn in kernels.items()}
        log(f"kind {kind} ({kcfg.name} geometry): {steps} steps in "
            f"{t1 - t0:.3f} s ({steps / (t1 - t0):.2f} steps/s incl. eval), "
            f"convert {t2 - t1:.3f} s; history {json.dumps(hist)}; launches "
            f"{launches}")
        require(all(launches[k] == 0 for k in ("grouped_subnet",
                                               "subnet_train_fwd",
                                               "subnet_train_bwd")),
                f"kind {kind}: launched a subnet kernel: {launches}")
        require(launches["lut_cascade"] > 0
                and launches["lut_lookup"] == launches["lut_layer"] == 0,
                f"kind {kind}: serving launched {launches}, want K1 only")
        require(all(np.isfinite(v) for vs in hist.values() for v in vs),
                f"kind {kind}: non-finite history")
        _served_check(kcfg, params, tables, statics, served, xte,
                      f"kind {kind}")
        cpu = torch.device("cpu")
        host_tables = TT.convert(kcfg, tree_map(lambda a: a.to(cpu), params),
                                 tree_map(lambda a: a.to(cpu), state),
                                 statics)
        flips = _flips(tables, host_tables, f"kind {kind}")
        acc = float((served == yte.cpu().numpy()).mean())
        log(f"kind {kind}: all {len(served)} served predictions equal the "
            f"plain predict, accuracy {acc:.4f}; tables against the CPU's "
            f"conversion: {flips} flips of {sum(t.size for t in tables)}")
        out[kind] = dict(launches=launches, steps=steps, train_s=t1 - t0,
                         flips=flips, served_acc=acc)
    return out


def _sweep_subnet_geometry():
    """(F, depth, width, skip) of the grid's NeuraLUT points."""
    from repro_torch.sweep import PAPER_SWEEP, paper_point_cfg
    c = paper_point_cfg("neuralut", *PAPER_SWEEP["neuralut"][0])
    return c.fan_in, c.depth, c.width, c.skip, c.layer_in_bits(0)


def phase_sweep_kernels(dev):
    """K4 and K5 over the sweep's unit axes (U = 3 at O = 64/32/10, U = 6
    at O = 48/10; F = 6, sub-network 16/16/16/16, skip 2, B = TRAIN_B)
    against U separate single-unit launches and the plain versions,
    reruns bit for bit; device ms per launch and per group step beside
    the bound.  K2 at the sweep's conversion shapes (4096 rows x O =
    64/48/32/10) against its plain version, with its bound."""
    import torch
    from repro_torch.kernels.neuralut_grad import (subnet_train_bwd,
                                                   subnet_train_fwd)
    from repro_torch.kernels.neuralut_mlp import subnet_kernel_apply
    from repro_torch.kernels.ref import grouped_subnet_ref
    f, depth, width, sk, in_bits = _sweep_subnet_geometry()
    gen = torch.Generator().manual_seed(29)
    out = {"train": {}, "k2": {}}
    for units, widths in SWEEP_UNIT_SHAPES:
        rows = []
        for o in widths:
            row, (xg, g, lw, lb, sw, sb, wpack, acts) = _unit_axis_layer(
                gen, units, o, f, depth, width, sk, dev)
            macs = sum(int(w.shape[-2] * w.shape[-1]) for w in lw + sw)
            wbytes = 4.0 * sum(a.numel() for a in lw + lb + sw + sb)
            abytes = 4.0 * sum(a.numel() for a in acts)
            fwd_flops = 2.0 * macs * TRAIN_B * o * units
            b4 = bound_ms(4.0 * (xg.numel() + g.numel()) + wbytes + abytes,
                          fwd_flops)
            b5 = bound_ms(4.0 * (g.numel() + 2 * xg.numel()) + abytes
                          + 2 * wbytes, 2 * fwd_flops)
            row.update(
                o=o, k4_ms=_trace_ms(lambda: subnet_train_fwd(
                    xg, lw, lb, sw, sb, skip=sk, wpack=wpack), 20),
                k5_ms=_trace_ms(lambda: subnet_train_bwd(
                    g, xg, acts, lw, lb, sw, sb, skip=sk, wpack=wpack), 20),
                k4_bound_ms=b4[0], k4_by=b4[1], k5_bound_ms=b5[0],
                k5_by=b5[1])
            rows.append(row)
            log(f"sweep K4/K5 U={units} O={o} F={f} B={TRAIN_B}: against "
                f"{units} single-unit launches and the plain version max "
                f"err K4 {row['err4']:.3e} ("
                f"{'bit-identical' if row['same4'] else 'within tolerance'}"
                f"), K5 {row['err5']:.3e} ("
                f"{'bit-identical' if row['same5'] else 'within tolerance'}"
                f"); reruns bit-identical; device K4 "
                f"{row['k4_ms'] or float('nan'):.4f} ms (bound "
                f"{b4[0]:.5f}, {b4[1]}), K5 "
                f"{row['k5_ms'] or float('nan'):.4f} ms (bound "
                f"{b5[0]:.5f}, {b5[1]})")
        step = {k: None if any(r[k] is None for r in rows)
                else sum(r[k] for r in rows)
                for k in ("k4_ms", "k5_ms", "k4_bound_ms", "k5_bound_ms")}
        out["train"][f"U={units}"] = dict(layers=rows, per_step=step)
        log(f"sweep K4/K5 per group step at U={units} (O={widths}): K4 "
            f"{step['k4_ms'] or float('nan'):.4f} ms (bound "
            f"{step['k4_bound_ms']:.5f}), K5 "
            f"{step['k5_ms'] or float('nan'):.4f} ms (bound "
            f"{step['k5_bound_ms']:.5f})")
    t = 2 ** (in_bits * f)
    for o in SWEEP_K2_O:
        p = _rand_subnet(gen, o, f, depth, width, sk, dev)
        codes = torch.randint(0, 2 ** in_bits, (t, o, f), generator=gen)
        xg = ((codes - 2 ** (in_bits - 1)).float() * 0.3).to(dev)
        lw, lb, sw, sb = _weights(p)

        def kern():
            return subnet_kernel_apply(p, xg, sk)

        def plain():
            return grouped_subnet_ref(xg, lw, lb, sw, sb, skip=sk)
        err = _close(kern(), plain(), K2_RTOL, K2_ATOL)
        macs = sum(int(w.shape[1] * w.shape[2]) for w in lw + sw)
        flops = 2.0 * macs * t * o
        nbytes = 4.0 * (xg.numel() + t * o + sum(
            a.numel() for a in lw + lb + sw + sb))
        tm = timings(kern, plain, "grouped_subnet_kernel", 20, 5)
        bms, by = bound_ms(nbytes, flops)
        out["k2"][str(o)] = dict(err=err, bound_ms=bms, by=by, **tm)
        log(f"sweep K2 T={t} O={o} F={f}: max_abs_err {err:.3e}, kernel "
            f"{tm['ms']:.4f} ms (call {tm['call_ms']:.4f}) plain "
            f"{tm['plain_ms']:.4f} ms [{tm['timing']}] bound {bms:.4f} ms "
            f"({by})")
    return out


def _paths(tree, prefix=""):
    """[(path, leaf)] of a params / state tree, in sorted-key order."""
    if isinstance(tree, dict):
        return [x for k in sorted(tree)
                for x in _paths(tree[k], f"{prefix}/{k}")]
    if isinstance(tree, (list, tuple)):
        return [x for i, t in enumerate(tree)
                for x in _paths(t, f"{prefix}[{i}]")]
    return [(prefix, tree)]


def _member_diffs(cfg, got, ref, x, y, dev):
    """Largest |got - ref| of a trained member (params, state) against
    its reference, split by the reference's gradient on (x, y): params
    where |g| > 1e-5 ("signal"), the other params ("zero": the biases
    feeding BN, whose exact gradient is 0), BN means and BN variances;
    with the worst paths.  ``signal_tol`` is the signal's largest
    |got - ref| / (1e-6 + 1e-3 |ref|)."""
    from repro_torch.core import model as M
    from repro_torch.core import train as TR
    from repro_torch.core.exec_plan import plan_subnet_exec
    _, grads, _ = TR.loss_and_grads(
        cfg, *ref, M.device_statics(M.model_static(cfg), dev), x, y,
        exec_plan=plan_subnet_exec(cfg, purpose="train", device=dev))
    out = dict(signal=0.0, signal_tol=0.0, zero=0.0, mean=0.0, var=0.0,
               signal_elems=0)
    worst = []
    for (path, a), (_, b), (_, g) in zip(_paths(got[0]), _paths(ref[0]),
                                         _paths(grads)):
        d, m = (a - b).abs(), g.abs() > 1e-5
        out["signal_elems"] += int(m.sum())
        for key, sel in (("signal", m), ("zero", ~m)):
            if bool(sel.any()):
                out[key] = max(out[key], float(d[sel].max()))
        if bool(m.any()):   # in units of the one-step rtol 1e-3 / atol 1e-6
            out["signal_tol"] = max(out["signal_tol"], float(
                (d[m] / (1e-6 + 1e-3 * b[m].abs())).max()))
        worst.append((path, float(d.max())))
    for path, d in _tree_diffs(got[1], ref[1]):
        key = path.rsplit("/", 1)[-1]
        out[key] = max(out[key], d)
        worst.append((path, d))
    out["worst"] = sorted(worst, key=lambda kv: -kv[1])[:4]
    return out


def _first_grads(cfg, params, state, statics, xb, yb, dev):
    """Each unit's loss gradient at (params, state) on its own batch,
    vmapped over the unit axis as the group step takes it (no optimizer
    update)."""
    import torch
    from repro_torch.core import model as M
    from repro_torch.core.exec_plan import plan_subnet_exec
    from torch.utils import _pytree as pytree
    plan = plan_subnet_exec(cfg, purpose="train", device=dev)

    def loss(p, s, st, x, y):
        logits, _, _ = M.model_apply(cfg, p, s, st, x, train=True,
                                     exec_plan=plan)
        return M.ce_loss(logits, y)
    dims = pytree.tree_map(
        lambda v: 0 if isinstance(v, torch.Tensor) else None, statics)
    return torch.func.vmap(torch.func.grad(loss), in_dims=(
        0, 0, dims, 0, 0))(params, state, statics, xb, yb)


def _grad_witness(g, xtr, ytr, dev):
    """The first step's gradients of each point of group ``g`` (U units)
    against its own ensemble's (S = len(g.seeds)), from the same inits
    on the same batches: per point, the leaves whose gradient differs,
    the largest |difference| and the number of elements that differ."""
    import torch
    from repro_torch.core import model as M
    from repro_torch.core import train as TR
    from repro_torch.sweep import member_params_state, stack_group_operands
    from repro_torch.tree import tree_map
    n, spe = len(xtr), len(xtr) // TRAIN_B
    params, state, _, statics, useeds = stack_group_operands(
        g, xtr, device=dev)
    idx = torch.stack([TR.epoch_batches(n, spe, TRAIN_B, seed=s, epoch=0,
                                        device=dev)[0] for s in useeds])
    gg = _first_grads(g.padded_cfg, params, state, statics, xtr[idx],
                      ytr[idx], dev)
    ns, out = len(g.seeds), {}
    for pi, pt in enumerate(g.points):
        p0, s0, _ = TR.init_ensemble(pt.cfg, g.seeds, xtr, device=dev)
        st = TR.unit_statics(M.device_statics(M.model_static(pt.cfg), dev),
                             ns)
        ib = idx[pi * ns:(pi + 1) * ns]
        ge = _first_grads(pt.cfg, p0, s0, st, xtr[ib], ytr[ib], dev)
        rows = []
        for si in range(ns):
            a, _ = member_params_state(g, gg, state, pi, si)
            b = tree_map(lambda t: t[si], ge)
            for (path, x), (_, y) in zip(_paths(a), _paths(b)):
                d = (x - y).abs()
                if bool((d > 0).any()):
                    rows.append((si, path, float(d.max()),
                                 int((d > 0).sum()), x.numel()))
        out[pt.name] = rows
    return out


def _tree_diffs(a, b):
    """[(path, max |a - b|)] over two trees of one structure, largest
    first."""
    out = [(p, float((x - y).abs().max())) for (p, x), (_, y) in
           zip(_paths(a), _paths(b))]
    return sorted(out, key=lambda kv: -kv[1])


def phase_sweep(dev):
    """The Pareto sweep at the paper grid's full widths
    (``paper_sweep_points``: LogicNets 128x64x32x10, 64x32x32x10,
    48x24x10 and NeuraLUT 64x32x10, 48x10, 32x10, 196 inputs, beta 2, F
    6) on mnist_pooled, SWEEP_SEEDS per point, SWEEP_EPOCHS: four group
    runs, one K4 and one K5 launch per NeuraLUT layer per step (none for
    LogicNets), each point's best member converted (K2 for NeuraLUT),
    saved to a TableRegistry, loaded back verified and served through
    LUTServeEngine (K1) with 0 mismatches against lut_infer.predict; the
    padded NeuraLUT group against train_neuralut_ensemble per point (a
    one-point group bit for bit; the group's first gradients, one step
    at float32 tolerance, the whole run at the SWEEP_* limits); a
    rerun of that group and a resume of the whole sweep bit for bit;
    the busy share of one group epoch; launch.sweep through main()."""
    import tempfile
    import numpy as np
    import torch
    from repro_torch.core import lut_infer as LI
    from repro_torch.core import model as M
    from repro_torch.core import train as TR
    from repro_torch.core import truth_table as TT
    from repro_torch.core.exec_plan import plan_cascade_exec
    from repro_torch.data import device_dataset, mnist_pooled
    from repro_torch.kernels.lut_cascade import (CascadeOperands,
                                                 lut_cascade)
    from repro_torch.kernels.lut_gather import lut_layer, lut_lookup
    from repro_torch.kernels.neuralut_grad import (subnet_train_bwd,
                                                   subnet_train_fwd)
    from repro_torch.kernels.neuralut_mlp import grouped_subnet
    from repro_torch.kernels.ref import lut_cascade_ref
    from repro_torch.launch import sweep as launch_sweep
    from repro_torch.runtime.straggler import StepWatchdog
    from repro_torch.runtime.tracker import CallbackTracker
    from repro_torch.serve import (LUTServeEngine, TableRegistry,
                                   bundle_from_training)
    from repro_torch.sweep import (make_group_train_fn, paper_sweep_points,
                                   plan_sweep, run_pareto_sweep,
                                   stack_group_operands)
    from repro_torch.sweep.runner import HIST_KEYS
    from repro_torch.tree import tree_map

    xtr, ytr = device_dataset(mnist_pooled, SWEEP_ROWS[0], seed=0,
                              device=dev)
    xte, yte = device_dataset(mnist_pooled, SWEEP_ROWS[1], seed=1,
                              device=dev)
    points = paper_sweep_points()
    groups = plan_sweep(points, seeds=SWEEP_SEEDS)
    steps_per_epoch = SWEEP_ROWS[0] // TRAIN_B
    steps = SWEEP_EPOCHS * steps_per_epoch
    kernels = {"lut_cascade": lut_cascade, "grouped_subnet": grouped_subnet,
               "subnet_train_fwd": subnet_train_fwd,
               "subnet_train_bwd": subnet_train_bwd, "lut_lookup": lut_lookup,
               "lut_layer": lut_layer}
    kw = dict(seeds=SWEEP_SEEDS, epochs=SWEEP_EPOCHS, batch=TRAIN_B,
              lr=SWEEP_LR, device=dev)
    tmp = tempfile.TemporaryDirectory(prefix="chip_smoke_sweep_")
    jdir, regdir = f"{tmp.name}/journal", f"{tmp.name}/registry"

    def counts():
        return {k: fn.launches for k, fn in kernels.items()}
    records = []
    tracker = CallbackTracker(lambda m, step, summary: records.append(
        (step, dict(m), counts())))
    for fn in kernels.values():
        fn.launches = 0
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    res = run_pareto_sweep(points, xtr, ytr, xte, yte, tracker=tracker,
                           convert=True, resume=jdir,
                           watchdog=StepWatchdog(), **kw)
    t1 = time.perf_counter()
    train_launches = counts()

    # one record per point, in group order; K4/K5 per group from the
    # counts at each group's records (conversion launches neither)
    require([s for s, _, _ in records] == list(range(len(points))),
            f"record steps {[s for s, _, _ in records]}")
    require([m["point"] for _, m, _ in records] == [p.name for p in points],
            "records out of point order")
    require(all(m["status"] == "ok" and np.isfinite(m["err"])
                for _, m, _ in records), "a point failed or diverged: "
            + str([(m["point"], m["status"], m["err"]) for _, m, _ in
                   records]))
    prev = {"subnet_train_fwd": 0, "subnet_train_bwd": 0}
    group_rows = []
    for run in res.groups:
        g = run.group
        _, _, c = records[g.point_offset]
        got = {k: c[k] - prev[k] for k in prev}
        prev = {k: c[k] for k in prev}
        want = (g.padded_cfg.num_layers * steps
                if g.padded_cfg.kind == "subnet" else 0)
        require(got["subnet_train_fwd"] == got["subnet_train_bwd"] == want,
                f"group {g.index} ({g.padded_cfg.kind}, "
                f"{g.padded_cfg.num_layers} layers, {steps} steps): K4/K5 "
                f"launches {got}, want {want} each")
        units = g.num_units
        group_rows.append(dict(
            index=g.index, kind=g.padded_cfg.kind, units=units,
            widths=g.padded_cfg.layer_widths, cold_s=run.cold_s,
            warm_s=run.warm_s, convert_s=run.convert_s,
            seed_steps_s=units * steps / (run.cold_s + run.warm_s),
            k4=got["subnet_train_fwd"], k5=got["subnet_train_bwd"],
            straggler=run.straggler))
        log(f"sweep {g.describe()}: cold {run.cold_s:.3f} s + warm "
            f"{run.warm_s:.3f} s, {units} units x {steps} steps = "
            f"{units * steps / (run.cold_s + run.warm_s):.2f} seed-steps/s "
            f"(incl. eval), convert {run.convert_s:.3f} s; K4/K5 launches "
            f"{got['subnet_train_fwd']}/{got['subnet_train_bwd']}")
    n_k2 = sum(p.cfg.num_layers for p in points if p.cfg.kind == "subnet")
    require(train_launches["grouped_subnet"] == n_k2,
            f"conversion made {train_launches['grouped_subnet']} K2 "
            f"launches, want {n_k2} (one per NeuraLUT layer)")
    log(f"sweep: {len(points)} points / {len(res.groups)} groups in "
        f"{t1 - t0:.3f} s (cold {res.cold_s:.3f} + warm {res.warm_s:.3f}); "
        f"launches {train_launches}")

    # conversion against the plain conversion (+-1 rule), the bundles
    # through a registry and the engine (K1), 0 mismatches
    for fn in kernels.values():
        fn.launches = 0
    reg = TableRegistry(regdir)
    frontier, served_k1 = [], {}
    for r in res.points:
        cfg = r.point.cfg
        statics = M.model_static(cfg)
        tables, packed = r.packed
        reg.save(r.name, bundle_from_training(
            cfg, r.params, tables, statics, packed_tables=packed,
            meta={"sweep_err": r.err, "tag": r.point.tag}))
        bundle = reg.load(r.name)
        k1_before = lut_cascade.launches
        with LUTServeEngine(bundle, device=dev) as eng:
            served = eng.predict(xte.cpu().numpy())
        served_k1[r.name] = lut_cascade.launches - k1_before
        require(served_k1[r.name] > 0, f"{r.name}: serving launched no K1")
        _served_check(cfg, r.params, tables, statics, served, xte,
                      f"sweep {r.name}")
        frontier.append(dict(point=r.name, tag=r.point.tag, err=r.err,
                             err_mean=r.err_mean, best_seed=r.best_seed,
                             luts=r.est.luts, latency_ns=r.est.latency_ns,
                             served_acc=float((served == yte.cpu().numpy())
                                              .mean())))
    serve_launches = counts()
    flips = {}
    cpu = torch.device("cpu")
    for r in res.points:
        plain = TT.convert(r.point.cfg, tree_map(lambda a: a.to(cpu),
                                                 r.params),
                           tree_map(lambda a: a.to(cpu), r.state),
                           M.model_static(r.point.cfg))
        flips[r.name] = _flips(r.packed[0], plain, f"sweep {r.name}")
    log(f"sweep serving: every bundle saved, loaded back verified and "
        f"served ({len(xte)} rows each), 0 mismatches; K1 launches "
        f"{served_k1}; conversion against the plain one on the CPU: flips "
        f"{flips} of {[sum(t.size for t in r.packed[0]) for r in res.points]}")
    for row in frontier:
        log(f"sweep frontier [{row['tag']:>9}] {row['point']:<26} err "
            f"{row['err']:.4f} (mean {row['err_mean']:.4f}) luts "
            f"{row['luts']:.1f} latency {row['latency_ns']:.3f} ns; served "
            f"accuracy {row['served_acc']:.4f}")

    # K1 at each bundle's operands, B = HEADLINE_B, with its bound
    k1 = {}
    for r in res.points:
        bundle = reg.load(r.name)
        conns = [torch.as_tensor(np.asarray(s["conn"], np.int32), device=dev)
                 for s in bundle.statics]
        packed = [torch.as_tensor(p, device=dev)
                  for p in bundle.packed_tables]
        sched = plan_cascade_exec(bundle.cfg).schedule
        ops = CascadeOperands(conns, packed, sched, bundle.cfg.in_features)
        codes = LI.input_codes(bundle.cfg, bundle.serve_params(dev),
                               xte[:HEADLINE_B])
        got = lut_cascade(codes, ops)
        want = lut_cascade_ref(codes, conns, packed, sched)
        require(torch.equal(got, want), f"{r.name}: K1 differs from the "
                "plain cascade")
        int_ops = float(HEADLINE_B * sum(
            o * (2 * bundle.cfg.layer_fan_in(i) + 4)
            for i, o in enumerate(bundle.cfg.layer_widths)))
        nbytes = 4.0 * (codes.numel() + got.numel()) + ops.prog.numel() * 8 \
            + _cascade_table_bytes(codes, conns, packed, sched)
        tm = timings(lambda: lut_cascade(codes, ops),
                     lambda: lut_cascade_ref(codes, conns, packed, sched),
                     "lut_cascade_kernel", 50, 10)
        bms, by = bound_ms(nbytes, int_ops)
        k1[r.name] = dict(bound_ms=bms, by=by, bytes=nbytes, **tm)
        log(f"sweep K1 {r.name} B={HEADLINE_B}: bit-identical to the plain "
            f"cascade; kernel {tm['ms']:.4f} ms (call {tm['call_ms']:.4f}) "
            f"plain {tm['plain_ms']:.4f} ms [{tm['timing']}] bound "
            f"{bms:.6f} ms ({by})")

    # the padded NeuraLUT group (U = 6) against train_neuralut_ensemble
    # (S = 3) per point.  First each point as a group of its own (U = 3):
    # one code path with the ensemble, so bit for bit.  Then one step of
    # the U = 6 group through run_pareto_sweep (one batch of rows, one
    # epoch): the leaves that first differ, and its signal at the
    # one-step tolerances.  Then the whole run at the SWEEP_* limits.
    g_pad = next(g for g in groups if g.padded_cfg.kind == "subnet"
                 and len(g.points) > 1)
    equiv = {}
    gw = _grad_witness(g_pad, xtr, ytr, dev)
    for name, rows in gw.items():
        log(f"sweep first-step gradients of group {g_pad.index} "
            f"(U={g_pad.num_units}) against the ensemble's "
            f"(S={len(SWEEP_SEEDS)}), {name}: {len(rows)} (seed, leaf) "
            "pairs differ; (seed, leaf, max |diff|, elements differing, "
            f"elements): {sorted(rows, key=lambda r: -r[2])[:8]}")
    xb, yb = xtr[:TRAIN_B], ytr[:TRAIN_B]
    one = dict(kw, epochs=1)
    step_group = run_pareto_sweep(g_pad.points, xb, yb, xte, yte,
                                  convert=True, **one)
    for pi, pt in enumerate(g_pad.points):
        ens = TR.train_neuralut_ensemble(
            pt.cfg, xtr, ytr, xte, yte, seeds=SWEEP_SEEDS,
            epochs=SWEEP_EPOCHS, batch=TRAIN_B, lr=SWEEP_LR, device=dev)
        alone = run_pareto_sweep([pt], xtr, ytr, xte, yte, convert=True,
                                 **kw).points[0]
        same = all(np.array_equal(alone.history[k], ens[2][k])
                   for k in HIST_KEYS) and all(
            torch.equal(a, b) for (_, a), (_, b) in zip(
                _paths((alone.params, alone.state)),
                _paths(TR.ensemble_member(ens[0], ens[1],
                                          alone.best_seed))))
        require(same, f"{pt.name}: a one-point group (U={len(SWEEP_SEEDS)})"
                " differs from train_neuralut_ensemble")

        # one step, U = 6 against the ensemble's (= the one-point group's)
        r1 = step_group.points[pi]
        e1 = TR.train_neuralut_ensemble(
            pt.cfg, xb, yb, xte, yte, seeds=SWEEP_SEEDS, epochs=1,
            batch=TRAIN_B, lr=SWEEP_LR, device=dev)
        d1 = _member_diffs(pt.cfg, (r1.params, r1.state),
                           TR.ensemble_member(e1[0], e1[1], r1.best_seed),
                           xb, yb, dev)
        loss1 = float(np.abs(r1.history["loss"] / e1[2]["loss"] - 1).max())
        first = [(p, d) for p, d in _tree_diffs(
            {"params": r1.params, "state": r1.state},
            dict(zip(("params", "state"), TR.ensemble_member(
                e1[0], e1[1], r1.best_seed)))) if d > 0]
        log(f"sweep one step of group {g_pad.index} (U={g_pad.num_units}) "
            f"against the ensemble (S={len(SWEEP_SEEDS)}), {pt.name} seed "
            f"{r1.best_seed}: loss rel. err {loss1:.3e}; signal {d1['signal']:.3e} "
            f"over {d1['signal_elems']} elements, zero-gradient "
            f"{d1['zero']:.3e}, BN mean {d1['mean']:.3e} var "
            f"{d1['var']:.3e}; {len(first)} leaves differ: {first[:6]}")
        require(loss1 <= 1e-5 and d1["signal_tol"] <= 1.0
                and d1["var"] <= 1e-5 and d1["mean"] <= 1e-5,
                f"{pt.name}: one group step disagrees with the ensemble's "
                f"at the one-step tolerances: {d1}")

        # the whole run (the main sweep's results)
        r = res.points[g_pad.point_offset + pi]
        hd = {k: float(np.abs(r.history[k] - ens[2][k]).max())
              for k in HIST_KEYS}
        md = _member_diffs(pt.cfg, (r.params, r.state),
                           TR.ensemble_member(ens[0], ens[1], r.best_seed),
                           xb, yb, dev)
        equiv[pt.name] = dict(one_point_group_bitwise=same,
                              first_grads=gw[pt.name][:8],
                              step=dict(d1, loss_rel=loss1,
                                        leaves_differing=len(first),
                                        first=first[:6]),
                              history=hd, member=md)
        log(f"sweep vs train_neuralut_ensemble, {pt.name} (group "
            f"{g_pad.index}, U={g_pad.num_units}, {SWEEP_EPOCHS} epochs): "
            f"one-point group (U={len(SWEEP_SEEDS)}) bit-identical; history "
            f"max diff {hd}; best member (seed {r.best_seed}) signal "
            f"{md['signal']:.3e} over {md['signal_elems']} elements, "
            f"zero-gradient {md['zero']:.3e}, BN mean {md['mean']:.3e} var "
            f"{md['var']:.3e}; largest at {md['worst']}")
        require(max(hd.values()) <= SWEEP_HIST_ATOL
                and max(md["signal"], md["var"]) <= SWEEP_SIGNAL_ATOL
                and max(md["zero"], md["mean"]) <= SWEEP_ZERO_ATOL,
                f"{pt.name}: the sweep and the ensemble disagree beyond "
                f"the SWEEP_* limits: history {hd}, member {md}")

    # a rerun of that group alone, bit for bit; then a resume of the
    # whole sweep: every group replayed, no training launch
    rerun = run_pareto_sweep(g_pad.points, xtr, ytr, xte, yte, **kw)
    for a in rerun.points:
        b = next(p for p in res.points if p.name == a.name)
        require(all(np.array_equal(a.history[k], b.history[k])
                     for k in a.history), f"rerun of {a.name} differs")
    k4_before = subnet_train_fwd.launches
    resumed = run_pareto_sweep(points, xtr, ytr, xte, yte, resume=jdir, **kw)
    require(all(g.replayed for g in resumed.groups), "resume retrained")
    require(subnet_train_fwd.launches == k4_before,
            f"resume launched K4 {subnet_train_fwd.launches - k4_before} "
            "times")
    for a, b in zip(resumed.points, res.points):
        require(a.err == b.err and all(np.array_equal(
            a.history[k], b.history[k]) for k in a.history),
            f"resume of {a.name} differs")
    log(f"sweep rerun of group {g_pad.index} bit-identical; resume "
        f"replayed {len(resumed.groups)} groups bit-identically with 0 K4 "
        "launches")

    # one group epoch of each NeuraLUT group (U = 3 and 6): wall, busy
    # share and K4/K5 device ms per step, from a profiled epoch
    epoch = {}
    for g in groups:
        if g.padded_cfg.kind != "subnet":
            continue
        ops = stack_group_operands(g, xtr, device=dev)
        fn = make_group_train_fn(g.padded_cfg, n=SWEEP_ROWS[0],
                                 batch=TRAIN_B, epochs=1, lr=SWEEP_LR,
                                 weight_decay=1e-4, device=dev)
        wall, busy, k4, k5, top = _epoch_profile(
            lambda: fn(*ops, xtr, ytr, xte, yte), steps_per_epoch)
        u = g.num_units
        epoch[f"U={u}"] = dict(epoch_s=wall, busy_share=busy / wall,
                               seed_steps_s=u * steps_per_epoch / wall,
                               k4_ms_step=k4, k5_ms_step=k5)
        log(f"sweep group epoch U={u} {g.padded_cfg.layer_widths} "
            f"({steps_per_epoch} steps + eval): {wall:.3f} s wall, "
            f"{u * steps_per_epoch / wall:.2f} seed-steps/s, device busy "
            f"{busy:.4f} s = {busy / wall:.4f}; per step K4 {k4:.4f} ms, "
            f"K5 {k5:.4f} ms")
        log("  device time by kernel (ms): " + ", ".join(
            f"{k[:48]} {us / 1e3:.2f}" for us, k in top))

    # the launcher, once, against a temporary registry
    t2 = time.perf_counter()
    cli = launch_sweep.main(["--seeds", "2", "--epochs", "1", "--registry",
                             f"{tmp.name}/cli_registry", "--quiet",
                             "--device", str(dev)])
    require(len(cli["saved"]) == len(points) and not any(
        cli["mismatches"].values()), f"launch.sweep: {cli['mismatches']}")
    log(f"launch.sweep --seeds 2 --epochs 1: {len(cli['saved'])} bundles "
        f"saved and served with 0 mismatches in "
        f"{time.perf_counter() - t2:.3f} s")
    tmp.cleanup()
    return dict(launches=train_launches, serve_launches=serve_launches,
                groups=group_rows, frontier=frontier, flips=flips, k1=k1,
                equivalence=equiv, epoch=epoch, seconds=t1 - t0)


TURN_BATCHES = (1, 8, 64, 256, 4096)   # K1 in turns

# One turn of ``--turns``: run in its own process from the root of a
# checkout, with that checkout's package and chip_smoke.py, so it uses
# only what both checkouts have.
TURN_CHILD = """
import hashlib, inspect, json, sys, time
root = sys.argv[1]
sys.path[:0] = [root, root + "/src"]
import numpy as np
import torch
import chip_smoke as cs
from repro_torch.config import get_config
from repro_torch.kernels.lut_cascade import (CascadeOperands, cascade_meta,
                                             cascade_tables, lut_cascade)
from repro_torch.kernels.neuralut_mlp import subnet_kernel_apply
cs.phase_environment()
cs.phase_build()
cfg, dev = get_config("neuralut-jsc-5l"), torch.device("cuda")
batches = json.loads(sys.argv[2])


def digest(x):
    return hashlib.sha256((x + 0).cpu().numpy().tobytes()).hexdigest()


# K2 at the conversion shapes (phase_subnet_kernel's operands)
gen = torch.Generator().manual_seed(11)
k2, k2_hash = [], []
for i, o in enumerate(cfg.layer_widths):
    t, f = cfg.table_size(i), cfg.layer_fan_in(i)
    p = cs._rand_subnet(gen, o, f, cfg.depth, cfg.width, cfg.skip, dev)
    codes = torch.randint(0, 2 ** cfg.layer_in_bits(i), (t, o, f),
                          generator=gen)
    xg = ((codes - 2 ** (cfg.layer_in_bits(i) - 1)).float() * 0.3).to(dev)
    fn = lambda: subnet_kernel_apply(p, xg, cfg.skip)
    k2_hash.append(digest(fn() + 0.0))
    k2.append(cs.device_ms(fn, 20, "grouped_subnet_kernel"))
# K1, chain (phase_cascade_kernel's tables) and DAG (phase_dag_...'s)
rng = np.random.default_rng(7)
tables, statics = cs._random_chain(cfg, rng)
ops = CascadeOperands(
    [torch.as_tensor(s["conn"], device=dev) for s in statics],
    [torch.as_tensor(p, device=dev) for p in cascade_tables(cfg, tables)],
    cascade_meta(cfg), cfg.in_features)
gcfg = get_config(cs.GRAPH_ARCH)
gops = cs._graph_operands(gcfg, *cs._graph_random_net(
    gcfg, np.random.default_rng(23)), dev)
k1, k1_dag, k1_hash = [], [], []
for b in batches:
    for o, c, ms in ((ops, cfg, k1), (gops, gcfg, k1_dag)):
        x = torch.as_tensor(rng.integers(0, 2 ** c.layer_in_bits(0), (
            b, c.in_features)).astype(np.int32), device=dev)
        k1_hash.append(digest(lut_cascade(x, o)))
        ms.append(cs.device_ms(lambda: lut_cascade(x, o), 50,
                               "lut_cascade_kernel"))
# K3 and the per-layer route on the chain's random tables: device ms of
# the whole per-layer cascade (every kernel it launches) and its device
# activities per call, outputs hashed; lut_lookup per layer on the same
# layers' addresses; then LUTServeEngine one request at a time (no
# admission window), fused and per-layer, p50 / p99 ms
from repro_torch.core import model as M
from repro_torch.core.exec_plan import LayerOperands, plan_cascade_exec
from repro_torch.core.lut_infer import pack_index
from repro_torch.data import jsc_synthetic
from repro_torch.kernels.lut_gather import lut_lookup
from repro_torch.serve import LUTServeEngine, bundle_from_training
lplan = plan_cascade_exec(cfg, fused=False)
lops = LayerOperands(
    [torch.as_tensor(s["conn"], device=dev) for s in statics],
    [torch.as_tensor(t.astype(np.int32), device=dev) for t in tables],
    lplan.schedule, *([cfg.in_features] if "in_features" in
                      inspect.signature(LayerOperands).parameters else []))
layer_ms, layer_kernels, layer_hash, k3_lookup = [], [], [], []
for b in batches:
    x = torch.as_tensor(rng.integers(0, 2 ** cfg.layer_in_bits(0), (
        b, cfg.in_features)).astype(np.int32), device=dev)
    fn = lambda: lplan.apply(x, lops)
    layer_hash.append(digest(fn()))
    layer_ms.append(cs._trace_ms(fn, 50))
    layer_kernels.append(cs.kernels_per_call(fn))
    c, per = x, []
    for conn, tbl, (_s, _a, bits, *_r) in zip(lops.conns, lops.tables,
                                              lplan.schedule):
        addr = pack_index(c[:, conn.long()], bits)
        per.append(cs._trace_ms(lambda: lut_lookup(tbl, addr), 50,
                                "lut_gather_kernel"))
        c = lut_lookup(tbl, addr)
    k3_lookup.append(per)
xq, _ = jsc_synthetic(4000, seed=1)
sizes, starts = cs._requests(xq)
params, _ = M.model_init(cfg, torch.Generator().manual_seed(0), device=dev)
params = M.calibrate_in_quant(cfg, params, xq)
bundle = bundle_from_training(cfg, params, tables, statics)
serve = {}
for fused in (True, False, False, True):
    with LUTServeEngine(bundle, fused=fused, max_wait_ms=0.0,
                        device=dev) as eng:
        eng.warmup()
        preds = [eng.predict(xq[s:s + n]) for s, n in zip(starts, sizes)]
    rep = eng.metrics.report()
    serve.setdefault("fused" if fused else "layer", []).append(dict(
        p50_ms=rep["p50_ms"], p99_ms=rep["p99_ms"],
        hash=digest(torch.as_tensor(np.concatenate(preds)))))
k4, k5 = cs.phase_train_kernels(cfg, dev)
seed = cs.phase_seed_kernels(cfg, dev)
# the seed ensemble as users call it (train_neuralut_ensemble, 4 seeds,
# one epoch: 78 steps of 256 rows and the test eval) on the jsc-5l chain
# and the PolyLUT-Add graph: wall seconds of two calls after a warm-up
from repro_torch.core import train as TR
from repro_torch.data import device_dataset, jsc_synthetic
xtr, ytr = device_dataset(jsc_synthetic, 20000, seed=0, device=dev)
xte, yte = device_dataset(jsc_synthetic, 4000, seed=1, device=dev)
ensemble = {}
for arch in ("neuralut-jsc-5l", cs.GRAPH_ARCH):
    walls = []
    for _ in range(3):
        t = time.perf_counter()
        _, _, hist = TR.train_neuralut_ensemble(
            get_config(arch), xtr, ytr, xte, yte, seeds=(0, 1, 2, 3),
            epochs=1, batch=cs.TRAIN_B, device=dev)
        walls.append(time.perf_counter() - t)
    ensemble[arch] = dict(epoch_s=walls[1:],
                          loss=hist["loss"].ravel().tolist())
print("TURN " + json.dumps(dict(
    ensemble=ensemble, serve=serve, layer_kernels=layer_kernels,
    lookup_by_layer=k3_lookup, layer_hash=layer_hash,
    k2=k2, k1_chain=k1, k1_dag=k1_dag, k3_layer_route=layer_ms,
    k4_s1=[r["ms"] for r in k4], k5_s1=[r["ms"] for r in k5],
    k4_s4=[r["k4_s4"] for r in seed], k5_s4=[r["k5_s4"] for r in seed],
    k2_hash=k2_hash, k1_hash=k1_hash)))
"""


def turns_main(parent: str) -> int:
    """``--turns PARENT``: the kernels of the checkout at ``PARENT`` (an
    unpacked ``git archive`` of the parent commit) and of this one, in
    turns (parent, this, this, parent), one process each, on one card:
    device ms of K2 at the five jsc-5l conversion shapes (with a sha256
    of its outputs at each), of K1 on the chain and the DAG at
    TURN_BATCHES (outputs hashed too), and of K4 and K5 at every jsc-5l
    training shape, B = TRAIN_B, S = 1 and S = 4 (``phase_train_kernels``
    and ``phase_seed_kernels`` of each checkout); the per-layer route
    (K3) at TURN_BATCHES: device ms of the whole cascade, its device
    activities per call and ``lut_lookup`` per layer, and p50 / p99 of
    ``LUTServeEngine`` one request at a time, fused and per-layer, twice
    each (outputs and predictions hashed); and the wall seconds of a
    4-seed ``train_neuralut_ensemble`` epoch on the jsc-5l chain and the
    PolyLUT-Add graph."""
    card = phase_environment()
    parent = str(Path(parent).resolve())
    turns = []
    for name, root in (("parent", parent), ("this", str(ROOT)),
                       ("this", str(ROOT)), ("parent", parent)):
        run = subprocess.run([sys.executable, "-c", TURN_CHILD, root,
                              json.dumps(TURN_BATCHES)],
                             capture_output=True, text=True, cwd=root,
                             timeout=900)
        out = ROOT / "chiprun_out"
        out.mkdir(exist_ok=True)
        (out / f"turn{len(turns) + 1}_{name}.log").write_text(
            run.stdout + run.stderr)
        line = [x for x in run.stdout.splitlines() if x.startswith("TURN ")]
        require(run.returncode == 0 and line,
                f"{name} turn failed: {run.stdout[-2000:]}{run.stderr[-2000:]}")
        turns.append(dict(checkout=name, **json.loads(line[-1][5:])))
        log(f"turn {len(turns)} ({name}): " + "; ".join(
            f"{k} " + " / ".join(f"{v:.4f}" if v else "nan" for v in vs)
            for k, vs in turns[-1].items() if k.startswith("k")
            and not k.endswith("hash")))
    for t in turns:
        log(f"per-layer route ({t['checkout']}): device activities per call "
            f"at B = {TURN_BATCHES}: {t['layer_kernels']}; lut_lookup per "
            "layer (ms): " + "; ".join(
                f"B={b} " + " / ".join(f"{v:.4f}" if v else "lost" for v in vs)
                for b, vs in zip(TURN_BATCHES, t["lookup_by_layer"])))
    log("serving one request at a time, p50 / p99 ms, in turns: " + "; ".join(
        f"{t['checkout']} " + ", ".join(
            f"{route} " + " ".join(f"{r['p50_ms']:.3f}/{r['p99_ms']:.3f}"
                                   for r in t["serve"][route])
            for route in ("fused", "layer")) for t in turns))
    for t in turns[1:]:
        require(t["layer_hash"] == turns[0]["layer_hash"], "the per-layer "
                f"route's outputs differ between the checkouts "
                f"({t['checkout']})")
    hashes = {r["hash"] for t in turns for rs in t["serve"].values()
              for r in rs}
    require(len(hashes) == 1, "served predictions differ between the "
            "routes or the checkouts")
    for arch in turns[0]["ensemble"]:
        log(f"train_neuralut_ensemble {arch}, 4 seeds, one epoch (s), in "
            "turns: " + "; ".join(
                f"{t['checkout']} " + " / ".join(
                    f"{v:.3f}" for v in t["ensemble"][arch]["epoch_s"])
                for t in turns))
    for t in turns[1:]:
        require(t["k1_hash"] == turns[0]["k1_hash"], f"K1's outputs differ "
                f"between the checkouts ({t['checkout']})")
    same = [a == b for a, b in zip(turns[1]["k2_hash"], turns[0]["k2_hash"])]
    log(f"K1 outputs bit-identical across the checkouts; K2 outputs "
        f"bit-identical to the parent's at layers "
        f"{[i for i, v in enumerate(same) if v]} of {len(same)} (sha256 "
        f"after + 0.0: {turns[1]['k2_hash']} / parent "
        f"{turns[0]['k2_hash']})")
    log(card)
    print(json.dumps({"turns": turns, "card": card, "k2_same": same}))
    return 0


def main() -> int:
    if not (SRC / "repro_torch").is_dir():
        print(f"chip_smoke: {SRC / 'repro_torch'} not found; run from a "
              "checkout of the repository", file=sys.stderr)
        return 2
    import torch
    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is false; this run "
              "needs one CUDA GPU", file=sys.stderr)
        return 2
    sys.path.insert(0, str(SRC))
    if sys.argv[1:2] == ["--turns"] and len(sys.argv) == 3:
        return turns_main(sys.argv[2])
    from repro_torch.config import get_config
    dev = torch.device("cuda")
    cfg = get_config("neuralut-jsc-5l")

    card = phase_environment()
    phase_build()
    floor = phase_launch_floor(dev)
    k2 = phase_subnet_kernel(cfg, dev)
    k1, tile_sweep = phase_cascade_kernel(cfg, dev)
    k1_dag, dag_sweep, dag_cases = phase_dag_cascade_kernel(dev)
    k3 = phase_gather_kernel(cfg, dev)
    k3l = phase_layer_kernel(cfg, dev)
    launches, served = phase_main_path(cfg, dev)
    stages = phase_convert_stages(cfg, dev)
    layer = phase_layer_serving(cfg, dev, served)
    graph_launches, graph, graph_served = phase_graph_serving(dev)
    probe = {"before": profiler_probe(dev)}
    stack = phase_serving_stack(dev, card, served, graph_served)
    probe["after"] = profiler_probe(dev)
    log("profiler probe (K4 at O=64 S=1 and a PyTorch control, 5 calls a "
        "trace), short traces before / after the serving stack: " + "; ".join(
            f"{k} {probe['before'][k]} / {probe['after'][k]} of "
            f"{probe['before']['traces']}" for k in ("k4", "control")))
    k4, k5 = phase_train_kernels(cfg, dev)
    shapes = phase_train_shapes(dev)
    train = phase_train_path(cfg, dev)
    seed_k = phase_seed_kernels(cfg, dev)
    ens = phase_ensemble_path(cfg, dev)
    gtrain = phase_graph_train_path(get_config(GRAPH_ARCH), dev)
    kinds = phase_kinds(cfg, dev)
    sweep_k = phase_sweep_kernels(dev)
    sweep = phase_sweep(dev)

    head, dag_head = k1[HEADLINE_B], k1_dag[HEADLINE_B]
    kernels = [
        {"name": "lut_cascade", "schedule": "chain", "route": "cuda",
         "source": "src/repro_torch/csrc/lut_cascade.cu",
         "replaces": "src/repro/kernels/lut_cascade.py:253",
         "launches": launches["lut_cascade"],
         "max_abs_err": max(r["err"] for r in k1.values()),
         "ms": head["ms"], "plain_ms": head["plain_ms"],
         "bound_ms": head["bound_ms"], "bound_by": head["by"],
         "library_ms": None, "floor_ms": floor, "call_ms": head["call_ms"],
         "plain_call_ms": head["plain_call_ms"], "timing": head["timing"],
         "shape": f"neuralut-jsc-5l B={HEADLINE_B}",
         "by_batch": {str(b): r for b, r in k1.items()},
         "tile_sweep_ms": tile_sweep},
        {"name": "lut_cascade", "schedule": "dag", "route": "cuda",
         "source": "src/repro_torch/csrc/lut_cascade.cu",
         "replaces": "src/repro/kernels/lut_cascade.py:253",
         "launches": graph_launches["lut_cascade"],
         "max_abs_err": max(r["err"] for r in k1_dag.values()),
         "ms": dag_head["ms"], "plain_ms": dag_head["plain_ms"],
         "bound_ms": dag_head["bound_ms"], "bound_by": dag_head["by"],
         "library_ms": None, "floor_ms": floor,
         "call_ms": dag_head["call_ms"],
         "plain_call_ms": dag_head["plain_call_ms"],
         "timing": dag_head["timing"],
         "shape": f"{GRAPH_ARCH} B={HEADLINE_B}",
         "by_batch": {str(b): r for b, r in k1_dag.items()},
         "tile_sweep_ms": dag_sweep, "dag_cases": dag_cases,
         "graph_serving": graph},
        {"name": "grouped_subnet", "route": "cuda",
         "source": "src/repro_torch/csrc/neuralut_mlp.cu",
         "replaces": "src/repro/kernels/neuralut_mlp.py:89",
         "launches": launches["grouped_subnet"],
         "max_abs_err": max(r["err"] for r in k2),
         "ms": sum(r["ms"] for r in k2),
         "plain_ms": sum(r["plain_ms"] for r in k2),
         "bound_ms": sum(r["bound_ms"] for r in k2),
         "bound_by": "operations" if all(r["by"] == "operations"
                                         for r in k2) else "bytes",
         "library_ms": None,
         "call_ms": sum(r["call_ms"] for r in k2),
         "plain_call_ms": sum(r["plain_call_ms"] for r in k2),
         "timing": k2[0]["timing"],
         "shape": "sum of the 5 jsc-5l conversion layers",
         "by_layer": k2, "convert_stages": stages},
    ]
    k3_head = [k3[(i, HEADLINE_B)] for i in range(cfg.num_layers)]
    k3_sum = k3_summary(k3_head, f"summed over the {cfg.num_layers} layers")
    kernels.append({
        "name": "lut_lookup", "route": "cuda",
        "source": "src/repro_torch/csrc/lut_gather.cu",
        "replaces": "src/repro/kernels/lut_gather.py:44",
        "launches": layer["launches_by_name"]["lut_lookup"],
        "main_path": "none since the per-layer route launches lut_layer; "
                     "held here at the jsc-5l layer shapes",
        "max_abs_err": max(r["err"] for r in k3.values()),
        "ms": k3_sum["ms"],
        "plain_ms": _sum_or_none(r["plain_ms"] for r in k3_head),
        "bound_ms": sum(r["bound_ms"] for r in k3_head),
        "bound_by": "bytes" if all(r["by"] == "bytes" for r in k3_head)
        else "operations",
        "library_ms": _sum_or_none(r["library_ms"] for r in k3_head),
        "library_call": "tables[o_idx, addr] (advanced indexing, int32)",
        "floor_ms": floor,
        "call_ms": sum(r["call_ms"] for r in k3_head),
        "plain_call_ms": sum(r["plain_call_ms"] for r in k3_head),
        "timing": k3_sum["timing"], "lost_layers": k3_sum["lost_layers"],
        "shape": f"sum of the 5 jsc-5l layers at B={HEADLINE_B}",
        "by_layer_batch": {f"{i}/{b}": r for (i, b), r in k3.items()}})
    kl_head = [k3l[(i, HEADLINE_B)] for i in range(cfg.num_layers)]
    kl_sum = k3_summary(kl_head, f"summed over the {cfg.num_layers} layers")
    kernels.append({
        "name": "lut_layer", "route": "cuda",
        "source": "src/repro_torch/csrc/lut_gather.cu",
        "replaces": "src/repro/kernels/lut_gather.py:44",
        "replaces_also": "the gather and pack_index of the reference's "
                         "per-layer step, src/repro/serve/engine.py:192-204",
        "launches": layer["launches"],
        "max_abs_err": max(r["err"] for r in k3l.values()),
        "ms": kl_sum["ms"],
        "plain_ms": _sum_or_none(r["plain_ms"] for r in kl_head),
        "bound_ms": sum(r["bound_ms"] for r in kl_head),
        "bound_by": "bytes" if all(r["by"] == "bytes" for r in kl_head)
        else "operations",
        "library_ms": None,
        "sequence_ms": _sum_or_none(r["sequence_ms"] for r in kl_head),
        "sequence": "codes[:, conn], * place values, sum, lut_lookup (the "
                    "per-layer route before lut_layer)",
        "floor_ms": floor,
        "call_ms": sum(r["call_ms"] for r in kl_head),
        "plain_call_ms": sum(r["plain_call_ms"] for r in kl_head),
        "timing": kl_sum["timing"], "lost_layers": kl_sum["lost_layers"],
        "shape": f"sum of the 5 jsc-5l layers at B={HEADLINE_B}",
        "by_shape_batch": {f"{s}/{b}": r for (s, b), r in k3l.items()},
        "layer_route": {k: layer[k] for k in ("runs", "activities",
                                              "forwards")}})
    # kernels per launch: device activities per wrapper call, counted in
    # phase_train_kernels's traces (required to be 1)
    for name, src, line, rows in (
            ("subnet_train_fwd", "neuralut_grad.cu",
             "src/repro/kernels/neuralut_grad.py:148", k4),
            ("subnet_train_bwd", "neuralut_grad.cu",
             "src/repro/kernels/neuralut_grad.py:261", k5)):
        kernels.append({
            "name": name, "route": "cuda",
            "source": f"src/repro_torch/csrc/{src}", "replaces": line,
            "launches": train["launches"][name],
            "kernels_per_launch": max(r["kernels_per_call"] for r in rows),
            "max_abs_err": max(r["err"] for r in rows),
            "ms": sum(r["ms"] for r in rows),
            "plain_ms": sum(r["plain_ms"] for r in rows),
            "bound_ms": sum(r["bound_ms"] for r in rows),
            "bound_by": "bytes" if all(r["by"] == "bytes" for r in rows)
            else "operations",
            "library_ms": None,
            "call_ms": sum(r["call_ms"] for r in rows),
            "plain_call_ms": sum(r["plain_call_ms"] for r in rows),
            "timing": rows[0]["timing"],
            "shape": f"sum of the 5 jsc-5l training layers at B={TRAIN_B}",
            "by_layer": rows,
            "seed_axis_by_layer": [
                {k: r[k] for k in (("err4", "same4", "k4_s4", "k4_s1")
                                   if name.endswith("fwd") else
                                   ("err5", "same5", "k5_s4", "k5_s1"))}
                for r in seed_k],
            "shapes": shapes,
            "graph_branch_shapes": [
                {k: r[k] for k in r if not k.startswith(
                    "k5" if name.endswith("fwd") else "k4")}
                for r in shapes["branches"]],
            "graph_per_step": {
                f"S={n}": {"ms": r["k4_ms_step" if name.endswith("fwd")
                                  else "k5_ms_step"],
                           "steps_s": r["steps_s"],
                           "busy_share": r["busy_share"]}
                for n, r in ((1, gtrain["train"]), (
                    gtrain["ensemble"]["seeds"], gtrain["ensemble"]))}})
    for k in kernels:
        name = k["name"]
        if k.get("schedule") == "dag":  # the graph paths' K1 launches
            k["launches_by_path"] = {
                "graph_serve": k["launches"],
                "graph_train": gtrain["train"]["launches"][name],
                "graph_ensemble": gtrain["ensemble"]["launches"][name],
                "serving_stack": stack["k1"]["dag"]}
            continue
        k["launches_by_path"] = {
            "serve": launches.get(name, 0),
            "layer_serve": layer["launches_by_name"].get(name, 0),
            "train": train["launches"].get(name, 0),
            "ensemble": ens["launches"].get(name, 0),
            **{f"kind_{kind}": r["launches"][name]
               for kind, r in kinds.items()},
            "sweep": (sweep["serve_launches"] if name == "lut_cascade"
                      else sweep["launches"]).get(name, 0)}
        k["sweep_shapes"] = {
            "lut_cascade": sweep["k1"], "grouped_subnet": sweep_k["k2"],
            "subnet_train_fwd": sweep_k["train"],
            "subnet_train_bwd": sweep_k["train"]}.get(name)
        if name == "lut_cascade":
            k["launches_by_path"]["serving_stack"] = stack["k1"]["chain"]
            k["serving_stack"] = {key: stack[key] for key in (
                "timing", "registry_s", "seconds", "swap_cutover_ms")}
            k["serving_stack"]["profiler_probe"] = probe
        else:
            k["launches_by_path"].update(
                graph_serve=graph_launches.get(name, 0),
                graph_train=gtrain["train"]["launches"][name],
                graph_ensemble=gtrain["ensemble"]["launches"][name])
    log(f"training: {train['steps']} steps, {train['train_s']:.3f} s, "
        f"{train['steps'] / train['train_s']:.2f} steps/s; epoch "
        f"{train['epoch_s']:.3f} s, device busy share "
        f"{train['busy_share']:.4f}; test acc_q {train['acc_q']:.4f}; "
        f"loss by epoch {train['loss']}")
    log("ensemble: {} seeds x {} steps, {:.3f} s; epoch without eval: ".format(
        len(ENSEMBLE_SEEDS), ens["steps"], ens["train_s"]) + "; ".join(
        f"S={n}: {r['steps_s']:.2f} steps/s, busy share "
        f"{r['busy_share']:.4f}, K4 {r['k4_ms_step']:.4f} + K5 "
        f"{r['k5_ms_step']:.4f} ms device per step"
        for n, r in ens["by_s"].items()))
    for what, r in (("graph training S=1", gtrain["train"]), (
            f"graph ensemble S={gtrain['ensemble']['seeds']}",
            gtrain["ensemble"])):
        log(f"{what} ({GRAPH_ARCH}): epoch without eval {r['epoch_s']:.3f} s"
            f", {r['steps_s']:.2f} steps/s, device busy share "
            f"{r['busy_share']:.4f}, K4 {r['k4_ms_step']:.4f} + K5 "
            f"{r['k5_ms_step']:.4f} ms device per step over the 7 branches")
    log("kinds: " + "; ".join(
        f"{kind}: {r['steps'] / r['train_s']:.2f} steps/s incl. eval, "
        f"served accuracy {r['served_acc']:.4f}"
        for kind, r in kinds.items()))
    log("sweep: " + "; ".join(
        f"group {r['index']} {r['kind']} U={r['units']}: cold "
        f"{r['cold_s']:.3f} + warm {r['warm_s']:.3f} s, "
        f"{r['seed_steps_s']:.2f} seed-steps/s" for r in sweep["groups"])
        + "; group epochs: " + "; ".join(
            f"{u}: busy share {r['busy_share']:.4f}, K4 {r['k4_ms_step']:.4f}"
            f" + K5 {r['k5_ms_step']:.4f} ms per step"
            for u, r in sweep["epoch"].items()))
    log(card)  # nvidia-smi's "name, power.limit", as it printed them
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
