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
  synthetic-MNIST inputs, F 6, beta 2; 3 seeds, 2 epochs where the
  launcher's default is 10): four stacked group runs, one K4 and one K5
  launch per NeuraLUT layer per step for all units of a group (none for
  LogicNets), every point's best member converted (K2), saved to a
  registry, loaded back and served through the LUT-cascade kernel with
  0 mismatches; each NeuraLUT point of the padded group alone in a
  group equal to the per-point ensemble bit for bit, the padded group's
  one step against it split by each element's gradient at init
  (``first_step_split``), its whole run, a rerun and a
  resume bit for bit, the launcher once; then the sweep's unit axis
  over logical replicas of the card (the grid at R = 2, the padded
  group at R = 2 and 4, every real member bit for bit against R = 1,
  K4/K5 launches R times R = 1's); before
  it K4/K5 over the sweep's unit axes (U = 3 and 6) against single-unit
  launches, and K2 at the sweep's conversion shapes;
* the dense LM (``lm-100m``): a float32 step of the 2-layer cut on the
  card against the CPU, ``launch.train`` at full depth with
  checkpoints, the supervisor's restart bit for bit, a profiled step,
  decode against prefill, the LM example and ``launch.serve --mode lm``
  as processes;
* the MoE LM (``qwen2-moe-a2.7b``) and the MLA + MoE LM
  (``deepseek-v2-lite-16b``) at their published widths, cut to 2
  layers: a float32 step on the card against the CPU (qwen's at its
  first layer), bf16 training
  steps (ms/step, tokens/s, peak memory, busy share, CE and aux loss),
  decode against prefill, ``launch.train`` and ``launch.serve --mode
  lm`` as processes; no LUT kernel on the LM paths (counts 0);
* the hybrid LM (``jamba-v0.1-52b``: Mamba, attention, MoE) and the
  xLSTM LM (``xlstm-350m``) at their published widths: a float32 step
  on the card against the CPU (jamba cut to one Mamba and one attention
  layer, xLSTM at full depth), bf16 training steps, float32 decode
  against prefill (jamba's whole 8-layer superblock), bf16 decode
  timed, the decode state's bytes per sequence, ``launch.train`` (xLSTM
  at full size with a checkpoint) and ``launch.serve --mode lm`` as
  processes;
* the encoder-decoder LM (``whisper-small``, whole: 12 + 12 layers,
  1,500 frames) and the VLM backbone (``qwen2-vl-72b`` at full width,
  cut to 2 layers): float32 gradients on the card against the CPU
  (whisper's first 2 + 2 layers through a step, the VLM with 16 patch
  embeddings on a grid and 3-D M-RoPE positions), whisper's float32
  decode from ``prefill_cross(encode(frames))`` (its first token against
  the forward, every token card against CPU), the VLM's text-only decode
  against prefill, whisper's bf16 steps at 8 x 448, the VLM's bf16
  prefill at 8 x 512 with 256 patches and its value_and_grad at 4 x
  512, bf16 decode against its bytes bound, ``launch.serve --mode lm``
  as processes; no LUT kernel on these paths (counts 0);
* the LM over a mesh of processes (``sharding.spmd``'s ZeRO-3 step
  through ``launch.train``): ``lm-100m`` at full width, float32, at
  ``--mesh-shape 1x1`` in a one-rank NCCL group, bit for bit against
  the plain step with no process group; two ranks sharing the card
  over gloo at 2x1 and 1x2 against it (the step tests' limits), with
  each rank's ms/step, peak memory and the bytes it holds;
  ``psum_int8`` over the two ranks on CUDA tensors bit for bit against
  the formula on one; the MoE LM at 2x1 against one rank (its aux
  loss's global statistics); one card checks ranks sharing it only, not
  several cards; no LUT kernel on these paths (counts 0);
* the dry run (``repro_torch.launch.dryrun``: one rank's step counted
  on the meta device, ``roofline.counter``) against the card, on the LM
  cells timed above (lm-100m's step and decode, the qwen2-moe-a2.7b cut,
  whisper-small): the FLOPs of one real step under ``FlopCounterMode``
  equal the meta count, the meta peak lies within 20 % of
  ``max_memory_allocated``, and the roofline's bound stands beside the
  measured ms/step; no LUT kernel on these paths (counts 0);
* the serving stack, right after graph serving, over the bundles of
  the two serving paths: a ``TableRegistry`` round trip (verified,
  bit-identical), a corrupted version refused and quarantined by the
  ``IntegrityProbe``, ``LUTServeEngine`` with two replicas on the card,
  chaos (eviction and redispatch, ``DispatchFailed``,
  ``DeadlineExceeded``), ``MultiTenantEngine`` (shedding, a committed
  and a rolled-back hot swap) and ``launch.serve`` against the registry;
  latency at replicas 1 and 2 and the registry's seconds, in turns.
  Before and after it, a probe of the profiler: how many traces of a
  training kernel's calls come back with records missing;
* RTL: the serving path's K2-converted tables emitted as Verilog
  (``core.rtl``), sampled ROMs re-simulated against the tables, the
  wiring against the connectivity, the LUT graph refused;
* sharded serving (``serve.sharded``): the serving bundle over 1-4
  logical replicas of the card, replicated through the LUT-cascade
  kernel and o_sharded through the per-layer lookup kernel, against
  ``predict``, with the engine, the registry and ``launch.serve
  --sharded``;
* the three ``examples/*_torch.py`` as processes on the card.

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
import os
import random
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
PROFILE_STEPS = 12         # steps of an epoch in a profiled window
TIMED_STEPS = 26           # steps of an epoch timed (a third of 78)
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
# batch 256: 23 steps per epoch.  Depth cut: 2 epochs where the
# launcher's default is 10.
SWEEP_SEEDS = (0, 1, 2)
SWEEP_EPOCHS = 2
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
SWEEP_WD = 1e-4                     # both trainers' default weight decay
# One step of the padded group against the ensemble's, split by the
# ensemble's gradient at init g (first_step_split).  Adam's first update
# is lr g / (|g| + eps) + lr wd p with eps 1e-8; a gradient error d moves
# it by lr d eps / (|g| + eps)^2, under 9e-4 of the update for |g| >=
# STEP_GRAD_T and d <= 8.9e-8 (the largest difference that
# probes/sweep_step.py read on the card over 8 connectivities), so those
# elements are held across runs; below STEP_GRAD_T the step's sign is
# rounding, so each run is held to its own AdamW step, and the two runs'
# gradients at init to STEP_GRAD_ATOL: ~4x the largest difference read
# below the split (5.9e-8), and 4x below a 1e-6 error.
STEP_GRAD_T = 1e-6
STEP_GRAD_ATOL = 2.5e-7
STEP_RTOL, STEP_ATOL = 1e-3, 1e-6
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


T_START = time.perf_counter()
PHASE_S = {}


def clock(phase, *args):
    """``phase(*args)``, its wall seconds kept in PHASE_S and written to
    both streams with the script's seconds so far (a run stopped at its
    time limit shows on its standard error where it stood)."""
    name = phase.__name__.removeprefix("phase_")
    print(f"phase {name} starts at {time.perf_counter() - T_START:.1f} s",
          file=sys.stderr, flush=True)
    t0 = time.perf_counter()
    out = phase(*args)
    PHASE_S[name] = PHASE_S.get(name, 0.0) + time.perf_counter() - t0
    msg = (f"phase {name}: {time.perf_counter() - t0:.1f} s (the script "
           f"{time.perf_counter() - T_START:.1f} s)")
    log(msg)
    print(msg, file=sys.stderr, flush=True)
    return out


def hash_seed() -> str:
    return os.environ.get("PYTHONHASHSEED", "unset")


def require(cond: bool, msg: str) -> None:
    if not cond:
        raise RuntimeError(f"FAILED (PYTHONHASHSEED={hash_seed()}): {msg}")


def ensure_hash_seed() -> str:
    """The connectivity of every NeuraLUT layer comes from Python's
    salted ``hash`` (``core/layers.py``), so a run is replayable only
    under a fixed ``PYTHONHASHSEED``.  When none is set, choose one,
    set it and re-execute this script once under it (the child sees it
    set and goes on).  Returns the seed."""
    seed = os.environ.get("PYTHONHASHSEED")
    if seed is None or seed == "random":
        seed = str(random.SystemRandom().randint(1, 2 ** 32 - 1))
        os.environ["PYTHONHASHSEED"] = seed
        sys.stdout.flush()
        os.execv(sys.executable, [sys.executable, str(Path(__file__).resolve())]
                 + sys.argv[1:])
    return seed


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


def _trace(fn, reps: int, kernel="", primed: bool = False):
    """One ``torch.profiler`` trace of ``reps`` calls of ``fn`` after a
    warm-up call: the device us of the CUDA kernels whose name holds
    ``kernel`` (a name or a tuple of names; "" = every kernel the call
    launches), and the trace's device activities (kernels, memsets,
    copies) of such names, {name: count}.  ``primed``: the warm-up call
    runs inside the profiler's session as a warm-up step, which its
    schedule discards, so the trace's first calls are not its session's
    first activities."""
    import collections
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile, schedule
    names = (kernel,) if isinstance(kernel, str) else kernel
    fn()
    torch.cuda.synchronize()
    plan = schedule(wait=0, warmup=1, active=1, repeat=1) if primed else None
    with profile(activities=[ProfilerActivity.CUDA], schedule=plan) as prof:
        if primed:
            fn()
            torch.cuda.synchronize()
            prof.step()
        for _ in range(reps):
            fn()
        torch.cuda.synchronize()
        if primed:
            prof.step()
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
        us, records = _trace(fn, reps, kernel, primed=n % 2 == 1)
        if _whole(records, reps):
            best = max(best, (sum(records.values()), us))
        if n >= 1 and best[0]:
            break
    return best[1] / reps / 1e3 if best[0] else None


def activities_per_call(fn, reps: int = 5, traces: int = 12):
    """Device activities (kernels, memsets, copies) per call of ``fn`` by
    name, {name: count per call}: of two traces of ``reps`` calls, and of
    up to ``traces`` while the fuller one is not whole (``_whole``), the
    fuller one.  A trace loses records in bursts (four traces in a row
    have lost one of five kernels), never adds one, so more traces only
    bring the fullest closer to the truth.  Every other trace is
    ``primed`` (one run's twelve plain traces in a row each lost one of
    five records)."""
    best = {}
    for n in range(traces):
        _, records = _trace(fn, reps, primed=n % 2 == 1)
        if sum(records.values()) > sum(best.values()):
            best = records
        if n >= 1 and _whole(best, reps):
            break
    return {k: v / reps for k, v in best.items()}


def kernels_per_call(fn, reps: int = 5, traces: int = 12) -> float:
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


def _close(got, want, rtol, atol, what: str = "") -> float:
    """Max abs error; raises when any element is beyond atol + rtol*|want|,
    naming ``what`` and the worst element."""
    err = (got - want).abs()
    if not bool((err <= atol + rtol * want.abs()).all()):
        i = int((err / (atol + rtol * want.abs())).flatten().argmax())
        raise RuntimeError(
            f"FAILED (PYTHONHASHSEED={hash_seed()}): "
            f"{what + ': ' if what else ''}max err "
            f"{float(err.max()):.3e} beyond rtol {rtol} / atol {atol}; worst "
            f"at flat index {i}: {float(got.flatten()[i]):.9e} against "
            f"{float(want.flatten()[i]):.9e}")
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


def train_step_check(cfg, params, state, sd, xb, yb, plan_k, plan_c):
    """One training step's gradients of a NeuraLUT chain or LUT graph
    through the training kernels (``plan_k``) against plain autograd
    (``plan_c``).

    The two routes compute each hidden function in another float32
    order, so a pre-quantization value within rounding of a ``round()``
    boundary may take neighbouring codes in the two routes, and all that
    lies downstream of that code then differs by far more than rounding
    (the card, over 160 connectivities of jsc-5l: 3 such runs, up to
    2,790x the tolerance).  So the plain route is walked node by node
    (a chain layer is a node of one branch) on the kernel route's
    forward: each node reads the kernel route's codes, each branch's
    pre-quantization values (hidden function, then BN) must agree with
    the kernel route's within rtol K5_RTOL / atol K5_ATOL, and those
    values are then replaced by the kernel route's in the forward only
    (``pre_c + (pre_k - pre_c).detach()``), so that the quantizer rounds
    the same values while the gradient flows through the plain route's
    own graph.  The last node's pre-quantization values are the logits,
    as in ``model_apply``.  Then the gradients (rtol K5_RTOL / atol
    K5_ATOL) and the BN state (K4's) are held as before.  Returns the
    readings, among them the codes that differ between the routes per
    node; raises on a disagreement."""
    import torch
    from repro_torch.core import model as M
    from repro_torch.core import quant
    from repro_torch.core import train as TR
    from repro_torch.core.nl_config import is_graph_config
    from repro_torch.tree import tree_leaves, tree_map, tree_unflatten

    graph = is_graph_config(cfg)
    nodes = len(cfg.nodes) if graph else cfg.num_layers
    lk, gk, sk = TR.loss_and_grads(cfg, params, state, sd, xb, yb,
                                   exec_plan=plan_k)

    def walk(p, plan, forced=None):
        """-> (logits, per node the branches' pre-quant values, the new
        BN state); ``forced``: the values to round in place of each
        branch's own (but at the logits)."""
        bufs = [quant.quant_apply(p["in_quant"], xb, cfg.beta_in or cfg.beta)]
        pres, states = [], []
        for i in range(nodes):
            lp, ls = p["layers"][i], state["layers"][i]
            pool = M.graph_pool(cfg, bufs, i) if graph else bufs[-1]
            br = (M.node_branch_params(cfg.nodes[i], lp, ls) if graph
                  else [(lp["fn"], lp["bn"], ls["bn"])])
            y, pres_i, bns = None, [], []
            for a, ((fnp, bnp, bns_a), conn) in enumerate(zip(
                    br, M.node_static_conns(sd[i]))):
                xg = pool[:, conn.to(device=pool.device, dtype=torch.long)]
                f = plan.apply(fnp, xg, exps=sd[i].get("exps"))
                pre, nbn = quant.bn_apply(bnp, bns_a, f, train=True,
                                          momentum=cfg.bn_momentum)
                pres_i.append(pre)
                bns.append(tree_map(torch.Tensor.detach, nbn))
                if forced is not None and i < nodes - 1:
                    pre = pre + (forced[i][a] - pre).detach()
                qa = quant.quant_apply(lp["quant"], pre, cfg.beta)
                y = qa if y is None else y + qa
            bufs.append(y)
            pres.append(pres_i)
            states.append({"bn": bns[0] if len(bns) == 1 else bns})
        return pre, pres, {"layers": states}

    with torch.no_grad():  # the kernel route's forward (K4 reruns exactly)
        _, pre_k, _ = walk(params, plan_k)
    p = tree_map(lambda a: a.detach().requires_grad_(True), params)
    logits, pre_c, sc = walk(p, plan_c, forced=pre_k)
    flips, pre_err = [], 0.0
    for i in range(nodes):
        lq = p["layers"][i]["quant"]
        flips.append(0)
        for a, (c, k) in enumerate(zip(pre_c[i], pre_k[i])):
            pre_err = max(pre_err, _close(
                c.detach(), k, K5_RTOL, K5_ATOL,
                f"step-1 pre-quant node {i} branch {a}"))
            flips[-1] += int((quant.quant_codes(lq, c.detach(), cfg.beta)
                              != quant.quant_codes(lq, k, cfg.beta)).sum())
    lc = M.ce_loss(logits, yb)
    leaves = tree_leaves(p)
    gc = [torch.zeros_like(a) if g is None else g for a, g in zip(
        leaves, torch.autograd.grad(lc, leaves, allow_unused=True))]
    gc = tree_unflatten(params, gc)
    gerr = max(_close(a, b, K5_RTOL, K5_ATOL, f"step-1 gradient {q}")
               for (q, a), (_, b) in zip(_paths(gk), _paths(gc)))
    bn_err = max(_close(a, b, K4_RTOL, K4_ATOL, f"step-1 BN state {q}")
                 for (q, a), (_, b) in zip(_paths(sk), _paths(sc)))
    return dict(loss_k=float(lk), loss_c=float(lc.detach()), grad_err=gerr,
                pre_err=pre_err, bn_err=bn_err, flips=flips,
                leaves=len(_paths(gk)))


def phase_train_path(cfg, dev):
    """The port's training path at full neuralut-jsc-5l: device-resident
    data, seeded init and calibration, train_neuralut on kernel_train
    (K4/K5), conversion through K2, a bundle, the engine through K1."""
    import numpy as np
    import torch
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
    chk = train_step_check(cfg, p0, s0, sd, xtr[ib[0]], ytr[ib[0]],
                           plan_k, plan_c)
    gerr = chk["grad_err"]
    log(f"step 1: loss kernel_train {chk['loss_k']:.7f} canonical "
        f"{chk['loss_c']:.7f}; each layer's pre-quant values of both routes "
        f"fed the same input within rtol {K5_RTOL} / atol {K5_ATOL} (max "
        f"err {chk['pre_err']:.3e}), codes that differ by layer "
        f"{chk['flips']}; {chk['leaves']} gradient leaves within rtol "
        f"{K5_RTOL} / atol {K5_ATOL} (max err {gerr:.3e}), BN state max "
        f"err {chk['bn_err']:.3e}")

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
    def epoch(n=steps_per_epoch):
        p, s, o = p0, s0, adamw_init(p0)
        for k in range(n):
            p, s, o, _ = step(p, s, o, sd, xtr[ib[k]], ytr[ib[k]])
    wall, busy, _, _, by_kernel = _epoch_profile(epoch, steps_per_epoch,
                                                 epoch)
    log(f"training epoch ({steps_per_epoch} steps, no eval; timed over "
        f"{TIMED_STEPS}, profiled over {PROFILE_STEPS}): {wall:.3f} s "
        f"wall, {steps_per_epoch / wall:.2f} steps/s, device busy "
        f"{busy:.4f} s = {busy / wall:.4f} of the wall time")
    log("training epoch device time by kernel (ms): " + ", ".join(
        f"{k[:48]} {u / 1e3:.2f}" for u, k in by_kernel))
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
    # a timed epoch each, and a profiled window of its first steps
    by_s = {}
    for seeds in (ENSEMBLE_SEEDS, ENSEMBLE_SEEDS[:1]):
        n = len(seeds)
        init, idx = TR.init_ensemble(cfg, seeds, xtr, device=dev), batches(
            seeds)
        wall, busy, k4, k5, top = _epoch_profile(
            lambda: run(init, idx), steps_per_epoch,
            lambda m: run(init, idx[:m]))
        by_s[n] = dict(
            steps_s=steps_per_epoch / wall, epoch_s=wall,
            busy_share=busy / wall, k4_ms_step=k4, k5_ms_step=k5,
            device_ms_step=busy * 1e3 / steps_per_epoch)
        log(f"ensemble epoch S={n} ({steps_per_epoch} steps, no eval; "
            f"timed over {TIMED_STEPS}, profiled over {PROFILE_STEPS}): "
            f"{wall:.3f} s wall, {steps_per_epoch / wall:.2f} steps/s, "
            f"device busy {busy:.4f} s = {busy / wall:.4f}; per step K4 "
            f"{k4:.4f} ms, K5 {k5:.4f} ms, all device "
            f"{by_s[n]['device_ms_step']:.4f} ms")
        log("  device time by kernel (ms): " + ", ".join(
            f"{k[:48]} {u / 1e3:.2f}" for u, k in top))
    return dict(launches=launches, steps=steps, train_s=t1 - t0,
                best=best, acc_q=final_q.tolist(), by_s=by_s)


def _epoch_profile(run, steps, window=None):
    """Wall s of one epoch ``run()`` (warmed up, no profiler), then the
    device time of a profiled epoch: (wall, busy s, K4 ms per step, K5
    ms per step, top kernels).  ``window(n)``, where given, runs the
    epoch's first n steps (every step has the same shapes): the wall is
    then its first TIMED_STEPS steps' scaled to the epoch's ``steps``,
    and the warm-up and the profiled run its first PROFILE_STEPS steps,
    the busy seconds scaled the same way."""
    import torch
    from torch.profiler import ProfilerActivity, profile
    part = (lambda: window(PROFILE_STEPS)) if window else run
    scale = steps / PROFILE_STEPS if window else 1.0
    part()
    torch.cuda.synchronize()
    te = time.perf_counter()
    if window:
        window(TIMED_STEPS)
    else:
        run()
    torch.cuda.synchronize()
    wall = (time.perf_counter() - te) * (steps / TIMED_STEPS if window
                                         else 1.0)
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        part()
        torch.cuda.synchronize()
    ev = [(e.self_device_time_total * scale, e.key)
          for e in prof.key_averages() if e.self_device_time_total > 0]
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
    chk = train_step_check(cfg, p0, s0, sd, xtr[ib[0]], ytr[ib[0]],
                           plan_k, plan_c)
    gerr = chk["grad_err"]
    step = TR.make_step_fn(cfg, lr=2e-3, weight_decay=1e-4, t0=steps,
                           exec_plan=plan_k)
    c4, c5, n4, n5 = _step_kernel_count(lambda: step(
        p0, s0, adamw_init(p0), sd, xtr[ib[0]], ytr[ib[0]]))
    require((n4, n5) == (branches, branches) and (c4, c5) == (n4, n5),
            f"one graph step: {n4} K4 and {n5} K5 wrapper calls, {c4} K4 and "
            f"{c5} K5 kernels in its trace; want {branches} of each")
    log(f"graph step 1: loss kernel_train {chk['loss_k']:.7f} canonical "
        f"{chk['loss_c']:.7f}; every branch's pre-quant values of both "
        f"routes fed the same input within rtol {K5_RTOL} / atol {K5_ATOL} "
        f"(max err {chk['pre_err']:.3e}), codes that differ by node "
        f"{chk['flips']}; {chk['leaves']} gradient leaves within rtol "
        f"{K5_RTOL} / atol {K5_ATOL} (max err {gerr:.3e}), BN state max err "
        f"{chk['bn_err']:.3e}; a profiled step holds {c4} K4 and {c5} K5 "
        f"kernels for {n4} / {n5} wrapper calls: 1 kernel per call")

    def epoch(n=spe):
        p, s, o = p0, s0, adamw_init(p0)
        for k in range(n):
            p, s, o, _ = step(p, s, o, sd, xtr[ib[k]], ytr[ib[k]])
    wall, busy, k4, k5, top = _epoch_profile(epoch, spe, epoch)
    one = dict(steps_s=spe / wall, epoch_s=wall, busy_share=busy / wall,
               k4_ms_step=k4, k5_ms_step=k5, device_ms_step=busy * 1e3 / spe)
    log(f"graph training epoch S=1 ({spe} steps, no eval; timed over "
        f"{TIMED_STEPS}, profiled over {PROFILE_STEPS}): {wall:.3f} s, "
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

    def eepoch(n=spe):
        p, s, o = einit
        for k in range(n):
            p, s, o, _ = estep(p, s, o, esd, xtr[eidx[k]], ytr[eidx[k]])
    wall, busy, k4, k5, top = _epoch_profile(eepoch, spe, eepoch)
    four = dict(steps_s=spe / wall, epoch_s=wall, busy_share=busy / wall,
                k4_ms_step=k4, k5_ms_step=k5,
                device_ms_step=busy * 1e3 / spe)
    log(f"graph ensemble epoch S={ns} ({spe} steps, no eval; timed over "
        f"{TIMED_STEPS}, profiled over {PROFILE_STEPS}): {wall:.3f} s, "
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
    with the worst paths."""
    from repro_torch.core import model as M
    from repro_torch.core import train as TR
    from repro_torch.core.exec_plan import plan_subnet_exec
    _, grads, _ = TR.loss_and_grads(
        cfg, *ref, M.device_statics(M.model_static(cfg), dev), x, y,
        exec_plan=plan_subnet_exec(cfg, purpose="train", device=dev))
    out = dict(signal=0.0, zero=0.0, mean=0.0, var=0.0, signal_elems=0)
    worst = []
    for (path, a), (_, b), (_, g) in zip(_paths(got[0]), _paths(ref[0]),
                                         _paths(grads)):
        d, m = (a - b).abs(), g.abs() > 1e-5
        out["signal_elems"] += int(m.sum())
        for key, sel in (("signal", m), ("zero", ~m)):
            if bool(sel.any()):
                out[key] = max(out[key], float(d[sel].max()))
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


def first_step_split(ref, got, *, lr, weight_decay, grad_t=STEP_GRAD_T,
                     grad_atol=STEP_GRAD_ATOL, rtol=STEP_RTOL,
                     atol=STEP_ATOL):
    """One optimizer step of one member in two runs, held element by
    element and split by the reference run's gradient at init.

    ``ref`` and ``got`` are dicts of CPU tensors and trees of one
    structure: "p0" the params at init, "g" the loss gradient there,
    "p1" the params after the step, "scale" the run's clip scale
    (min(1, 1 / the gradient's global norm)).  Elements with |g_ref| >=
    ``grad_t``: p1 equal across the runs within ``rtol`` / ``atol``.
    The others: the two g within ``grad_atol``, and each run's p1 equal
    to the port's own AdamW first step (``optim.adamw_update`` from zero
    moments) from that run's p0, g and scale, at ``lr``, within ``rtol``
    / ``atol``.  Returns the element counts ("big", "small"), the
    largest |g_got - g_ref| ("grad_diff" over the small elements,
    "grad_diff_all"), the largest errors in units of their tolerance
    ("cross_tol", "own_tol"), "ok", and up to 32 "failures": (check,
    path, index, g_ref, g_got, p1_ref, p1_got, own step of ref, own step
    of got).  Imports no CUDA."""
    import torch
    from repro_torch.optim import adamw_init, adamw_update
    from repro_torch.tree import tree_map

    def own_step(run):
        g = tree_map(lambda t: t * run["scale"], run["g"])
        return adamw_update(g, adamw_init(run["p0"]), run["p0"], lr=lr,
                            weight_decay=weight_decay)[0]

    out = dict(ok=True, big=0, small=0, grad_diff=0.0, grad_diff_all=0.0,
               cross_tol=0.0, own_tol=0.0, failures=[])
    trees = (ref["g"], got["g"], ref["p1"], got["p1"], own_step(ref),
             own_step(got))
    for leaves in zip(*(_paths(t) for t in trees)):
        path = leaves[0][0]
        g_r, g_g, p_r, p_g, w_r, w_g = (t.flatten() for _, t in leaves)
        big = g_r.abs() >= grad_t
        zero = torch.zeros_like(g_r)
        gd = (g_g - g_r).abs()
        cross = torch.where(big, (p_g - p_r).abs()
                            / (atol + rtol * p_r.abs()), zero)
        own = torch.where(big, zero, torch.maximum(
            (p_r - w_r).abs() / (atol + rtol * w_r.abs()),
            (p_g - w_g).abs() / (atol + rtol * w_g.abs())))
        gsmall = torch.where(big, zero, gd)
        out["big"] += int(big.sum())
        out["small"] += int((~big).sum())
        for key, v in (("grad_diff", gsmall), ("grad_diff_all", gd),
                       ("cross_tol", cross), ("own_tol", own)):
            if v.numel():
                out[key] = max(out[key], float(v.max()))
        for check, bad in (("cross-run", cross > 1),
                           ("gradient at init", gsmall > grad_atol),
                           ("own AdamW step", own > 1)):
            for i in torch.nonzero(bad).flatten().tolist():
                out["ok"] = False
                if len(out["failures"]) < 32:
                    out["failures"].append((check, path, i) + tuple(
                        float(t[i]) for t in (g_r, g_g, p_r, p_g, w_r,
                                              w_g)))
    return out


def _old_split_fails(ref, got, g_after):
    """The elements that the split by the gradient after the step fails
    (|g_after| > 1e-5 and |p1_got - p1_ref| > 1e-6 + 1e-3 |p1_ref|):
    (path, index, g_init ref, g_init got, p1 ref, p1 got, g_after)."""
    import torch
    rows = []
    for leaves in zip(*(_paths(t) for t in (ref["g"], got["g"], ref["p1"],
                                            got["p1"], g_after))):
        path = leaves[0][0]
        g_r, g_g, p_r, p_g, g1 = (t.flatten() for _, t in leaves)
        bad = (g1.abs() > 1e-5) & ((p_g - p_r).abs()
                                   > 1e-6 + 1e-3 * p_r.abs())
        rows += [(path, i) + tuple(float(t[i]) for t in (g_r, g_g, p_r, p_g,
                                                        g1))
                 for i in torch.nonzero(bad).flatten().tolist()]
    return rows


def sweep_step_check(g, xb, yb, xte, yte, dev):
    """One step of the padded group ``g`` on the rows (xb, yb), through
    its training function (all U units), against
    train_neuralut_ensemble of each point (S seeds) on the same rows,
    every seed: each unit's gradient at init beside its ensemble
    member's (the same init, the same permuted batch); each element
    that the split by the gradient after the step fails, logged with
    its gradients at init and its values after the step in both runs
    and its gradient after the step; then :func:`first_step_split`.
    Returns ({point: {seed: split summary}}, {(point, seed): the unit's
    (params, state) after the step})."""
    import torch
    from repro_torch.core import model as M
    from repro_torch.core import train as TR
    from repro_torch.core.exec_plan import plan_subnet_exec
    from repro_torch.optim import sgdr_schedule
    from repro_torch.sweep import (make_group_train_fn, member_params_state,
                                   stack_group_operands)
    from repro_torch.tree import tree_leaves, tree_map
    cpu = torch.device("cpu")
    n, ns = len(xb), len(g.seeds)
    params, state, opt, statics, useeds = stack_group_operands(
        g, xb, device=dev)
    idx = torch.stack([TR.epoch_batches(n, 1, n, seed=s, epoch=0,
                                        device=dev)[0] for s in useeds])
    gg = _first_grads(g.padded_cfg, params, state, statics, xb[idx],
                      yb[idx], dev)
    fn = make_group_train_fn(g.padded_cfg, n=n, batch=n, epochs=1,
                             lr=SWEEP_LR, weight_decay=SWEEP_WD, device=dev)
    p1g, s1g, _, _ = fn(params, state, opt, statics, useeds, xb, yb, xte,
                        yte)
    lr0 = sgdr_schedule(0, lr_max=SWEEP_LR, lr_min=SWEEP_LR * 1e-2, t0=1)

    def scales(grads):  # each unit's clip scale, as adamw_update takes it
        gsq = sum(t.square().flatten(1).sum(1) for t in tree_leaves(grads))
        return torch.clamp(1.0 / torch.clamp(gsq.sqrt(), min=1e-12),
                           max=1.0).to(cpu)

    def host(tree):
        return tree_map(lambda t: t.detach().to(cpu), tree)
    k_got = scales(gg)
    report, members = {}, {}
    for pi, pt in enumerate(g.points):
        p0, s0, _ = TR.init_ensemble(pt.cfg, g.seeds, xb, device=dev)
        st1 = M.device_statics(M.model_static(pt.cfg), dev)
        ib = idx[pi * ns:(pi + 1) * ns]
        ge = _first_grads(pt.cfg, p0, s0, TR.unit_statics(st1, ns), xb[ib],
                          yb[ib], dev)
        k_ref = scales(ge)
        e1 = TR.train_neuralut_ensemble(
            pt.cfg, xb, yb, xte, yte, seeds=g.seeds, epochs=1, batch=n,
            lr=SWEEP_LR, weight_decay=SWEEP_WD, device=dev)
        plan = plan_subnet_exec(pt.cfg, purpose="train", device=dev)
        rows = {}
        for si, seed in enumerate(g.seeds):
            u = g.unit_index(pi, si)
            member = TR.ensemble_member(e1[0], e1[1], si)
            ref = {"p0": host(tree_map(lambda t: t[si], p0)),
                   "g": host(tree_map(lambda t: t[si], ge)),
                   "p1": host(member[0]), "scale": k_ref[si]}
            members[(pt.name, seed)] = member_params_state(g, p1g, s1g, pi,
                                                           si)
            got = {"p0": host(member_params_state(g, params, state, pi,
                                                  si)[0]),
                   "g": host(member_params_state(g, gg, state, pi, si)[0]),
                   "p1": host(members[(pt.name, seed)][0]),
                   "scale": k_got[u]}
            _, g1, _ = TR.loss_and_grads(pt.cfg, *member, st1, xb, yb,
                                         exec_plan=plan)
            old = _old_split_fails(ref, got, host(g1))
            for path, i, gr, gu, pr, pu, ga in old:
                log(f"sweep step {pt.name} seed {seed}: {path}[{i}] fails "
                    f"the split by the gradient after the step: g_init "
                    f"ensemble {gr:.6e} group {gu:.6e}; after the step "
                    f"ensemble {pr:.9e} group {pu:.9e}; g_after {ga:.6e}")
            p0d = max(float((a - b).abs().max()) for (_, a), (_, b) in zip(
                _paths(ref["p0"]), _paths(got["p0"])))
            split = first_step_split(ref, got, lr=lr0,
                                     weight_decay=SWEEP_WD)
            for f in split["failures"]:
                log(f"sweep step {pt.name} seed {seed}: FAILS {f[0]} at "
                    f"{f[1]}[{f[2]}]: g_init ensemble {f[3]:.6e} group "
                    f"{f[4]:.6e}; after the step ensemble {f[5]:.9e} group "
                    f"{f[6]:.9e}; own AdamW steps {f[7]:.9e} / {f[8]:.9e}")
            rows[seed] = dict({k: v for k, v in split.items()
                               if k != "failures"}, old_split_fails=len(old),
                              p0_diff=p0d, scale_ref=float(k_ref[si]),
                              scale_got=float(k_got[u]))
            log(f"sweep step {pt.name} seed {seed} (group {g.index}, "
                f"U={g.num_units}, against S={ns}): split at |g_init| "
                f"{STEP_GRAD_T:g}: {split['big']} elements held across "
                f"runs (worst {split['cross_tol']:.3f} of the tolerance), "
                f"{split['small']} to their own AdamW step (worst "
                f"{split['own_tol']:.3f}) with g_init within "
                f"{split['grad_diff']:.3e} (all elements "
                f"{split['grad_diff_all']:.3e}; limit {STEP_GRAD_ATOL:g}); "
                f"ok {split['ok']}; {len(old)} elements fail the split by "
                f"the gradient after the step; p0 diff {p0d:.3e}; clip "
                f"scales {float(k_ref[si]):.6f} / {float(k_got[u]):.6f}")
        report[pt.name] = rows
    return report, members


def _tree_diffs(a, b):
    """[(path, max |a - b|)] over two trees of one structure, largest
    first."""
    out = [(p, float((x - y).abs().max())) for (p, x), (_, y) in
           zip(_paths(a), _paths(b))]
    return sorted(out, key=lambda kv: -kv[1])


SWEEP_REPLICAS = (2, 4)     # logical replicas of the card: grid, group


def _first_diff(a, b):
    """'path[index] a vs b' of the first element where two trees (of
    one structure) differ, or None when they are equal bit for bit."""
    for (path, x), (_, y) in zip(_paths(a), _paths(b)):
        if x.shape != y.shape:
            return f"{path}: shape {tuple(x.shape)} vs {tuple(y.shape)}"
        ne = (x != y) & ~(x.isnan() & y.isnan())
        if bool(ne.any()):
            i = int(ne.flatten().nonzero()[0])
            return (f"{path}[{i}] {float(x.flatten()[i])!r} vs "
                    f"{float(y.flatten()[i])!r}")
    return None


def _sweep_over_replicas(dev, points, res, g_pad, kw, data, counts, jdir):
    """The sweep's unit axis over R logical replicas of the card (R
    blocks of W / R units, each in a thread on its own stream, joined in
    unit order), journaled, against the R = 1 run ``res`` through its
    journal ``jdir``, which holds every group's stacked params, BN state
    and histories: (1) the whole paper grid at R = SWEEP_REPLICAS[0],
    K4/K5 launches per group R times R = 1's; (2) the padded NeuraLUT
    group at R = SWEEP_REPLICAS[1] (its 6 units padded to 8).  Every
    real unit of every group, NeuraLUT and LogicNets, must equal R = 1
    bit for bit (the linear kind's weight and bias gradients sum the
    batch rows in float64, ``core.subnet._NeuronDot``); the first
    differing element is logged."""
    import tempfile
    import torch
    from repro_torch.runtime.tracker import CallbackTracker
    from repro_torch.sweep import (SweepJournal, run_pareto_sweep,
                                   stack_group_operands)
    from repro_torch.sweep.runner import HIST_KEYS
    steps = kw["epochs"] * (data[0].shape[0] // kw["batch"])
    ref = SweepJournal(jdir)
    tmp = tempfile.TemporaryDirectory(prefix="chip_smoke_replicas_")

    def stacked(journal, g, index):
        """A group's journaled (params, state, hist), real units only."""
        p, st = stack_group_operands(g, data[0], device=dev)[:2]
        tree = journal.load(index, {"params": p, "state": st,
                                    "hist": dict.fromkeys(HIST_KEYS, 0)})
        return _tree_slice(tree, g.num_units)

    def run(r, pts):
        records = []
        tracker = CallbackTracker(lambda m, step, summary: records.append(
            (step, counts())))
        before = counts()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        out = run_pareto_sweep(pts, *data, tracker=tracker,
                               resume=f"{tmp.name}/r{r}",
                               devices=[dev] * r, **kw)
        torch.cuda.synchronize()
        secs = time.perf_counter() - t0
        require(out.devices == r, f"sweep at R={r}: devices {out.devices}")
        rows, prev = [], before
        for run_r in out.groups:
            g = run_r.group
            c = records[g.point_offset][1]
            got = {k: c[k] - prev[k] for k in ("subnet_train_fwd",
                                              "subnet_train_bwd")}
            prev = c
            g1 = next(x for x in res.groups
                      if x.group.points[0].name == g.points[0].name)
            want = (r * g.padded_cfg.num_layers * steps
                    if g.padded_cfg.kind == "subnet" else 0)
            require(got["subnet_train_fwd"] == got["subnet_train_bwd"]
                    == want, f"sweep at R={r}, group {g.index}: K4/K5 "
                    f"launches {got}, want {want} each ({r} x R = 1's)")
            mine, theirs = (stacked(SweepJournal(f"{tmp.name}/r{r}"), g,
                                    g.index),
                            stacked(ref, g1.group, g1.group.index))
            diff = _first_diff(*((t["params"], t["state"], t["hist"])
                                 for t in (mine, theirs)))
            hd = max(float((torch.as_tensor(mine["hist"][k])
                            - torch.as_tensor(theirs["hist"][k])).abs().max())
                     for k in HIST_KEYS)
            rows.append(dict(index=g1.group.index, kind=g.padded_cfg.kind,
                             units=g.num_units, stacked=g.stacked_units,
                             k4=got["subnet_train_fwd"],
                             k5=got["subnet_train_bwd"],
                             seconds=run_r.cold_s + run_r.warm_s,
                             seconds_r1=g1.cold_s + g1.warm_s,
                             first_diff=diff, hist_diff=hd))
            log(f"sweep R={r} group {g1.group.index} ({g.padded_cfg.kind}): "
                f"{g.num_units} units padded to {g.stacked_units}, "
                f"{g.stacked_units // r} per replica; K4/K5 launches "
                f"{got['subnet_train_fwd']}/{got['subnet_train_bwd']} (R = "
                f"1: {want // r} each); {run_r.cold_s + run_r.warm_s:.3f} s "
                f"(R = 1: {g1.cold_s + g1.warm_s:.3f} s); every real unit's "
                f"params, BN state and history against R = 1: "
                + ("bit-identical" if diff is None else
                   f"first difference at {diff}, histories within {hd:.3e}"))
            require(diff is None,
                    f"sweep at R={r}, group {g1.group.index} "
                    f"({g.padded_cfg.kind}) differs from R = 1: {diff}; "
                    f"histories {hd:.3e}")
        return dict(replicas=r, seconds=secs, groups=rows)

    out = {"grid": run(SWEEP_REPLICAS[0], points),
           "group": run(SWEEP_REPLICAS[1], g_pad.points)}
    tmp.cleanup()
    return out


def _tree_slice(tree, units):
    """The first ``units`` entries of every leaf's leading axis."""
    import torch
    if isinstance(tree, dict):
        return {k: _tree_slice(v, units) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return [_tree_slice(v, units) for v in tree]
    return torch.as_tensor(tree)[:units]


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
    the unit axis over logical replicas of the card
    (:func:`_sweep_over_replicas`); the busy share of one group epoch;
    launch.sweep through main()."""
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
    # the U = 6 group (one batch of rows, one epoch), every seed split by
    # its ensemble member's gradient at init (sweep_step_check), and
    # through run_pareto_sweep its loss and BN statistics at the one-step
    # tolerances.  Then the whole run at the SWEEP_* limits.
    g_pad = next(g for g in groups if g.padded_cfg.kind == "subnet"
                 and len(g.points) > 1)
    equiv = {}
    xb, yb = xtr[:TRAIN_B], ytr[:TRAIN_B]
    split, step_members = sweep_step_check(g_pad, xb, yb, xte, yte, dev)
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
        require(all(torch.equal(a, b) for (_, a), (_, b) in zip(
            _paths((r1.params, r1.state)),
            _paths(step_members[(pt.name, SWEEP_SEEDS[r1.best_seed])]))),
            f"{pt.name}: run_pareto_sweep's step differs from the group's "
            "training function's")
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
        require(loss1 <= 1e-5 and d1["var"] <= 1e-5 and d1["mean"] <= 1e-5
                and all(s["ok"] for s in split[pt.name].values()),
                f"{pt.name}: one group step disagrees with the ensemble's "
                f"at the one-step tolerances: {d1}, split by the gradient "
                f"at init {split[pt.name]}")

        # the whole run (the main sweep's results)
        r = res.points[g_pad.point_offset + pi]
        hd = {k: float(np.abs(r.history[k] - ens[2][k]).max())
              for k in HIST_KEYS}
        md = _member_diffs(pt.cfg, (r.params, r.state),
                           TR.ensemble_member(ens[0], ens[1], r.best_seed),
                           xb, yb, dev)
        equiv[pt.name] = dict(one_point_group_bitwise=same,
                              step=dict(d1, loss_rel=loss1,
                                        split=split[pt.name],
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
    replicas = _sweep_over_replicas(dev, points, res, g_pad, kw,
                                    (xtr, ytr, xte, yte), counts, jdir)

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
                equivalence=equiv, epoch=epoch, replicas=replicas,
                seconds=t1 - t0)


LM_ARCH = "lm-100m"
LM_REDUCED = False         # True: the reduced config (CPU rehearsals)
LM_CUT_LAYERS = 2          # (a) and (c): full width, depth cut to 2
LM_B, LM_S = 8, 128        # the launcher's default global batch and seq
LM_TRAIN_STEPS, LM_CKPT_EVERY = 20, 10
LM_SUP_STEPS, LM_SUP_EVERY, LM_FAIL_AT = 20, 5, 13
LM_DECODE_B, LM_DECODE_CTX, LM_DECODE_TOKENS = 64, 128, 64
LM_PREFILL = 16            # decoded tokens held against prefill logits
LM_PROFILE_STEPS = 3       # full-depth steps timed, then profiled
LM_CLI_TIMEOUT = 300
# (a) the card's float32 step against the CPU's, TF32 off: the loss to
# rtol 1e-5; each gradient leaf to rtol 1e-4 / atol 1e-5 x its largest
# element; a new param to 1e-6 where the CPU gradient, clipped, is at
# least 1e-5 and 10x the two gradients' difference (its sign, so Adam's
# first step lr g / (|g| + 1e-8), is then the same on both), else
# within the step's reach (2 lr + 1e-6).
LM_LOSS_RTOL = 1e-5
LM_GRAD_RTOL, LM_GRAD_ATOL_REL = 1e-4, 1e-5
LM_STEP_GRAD_T, LM_PARAM_ATOL = 1e-5, 1e-6
# (d) bf16 decode against bf16 prefill: |logit diff| <= 0.03 x the
# largest |prefill logit| (about 8 bf16 ulps there; the CPU reads 0.0087
# at full lm-100m, batch 4).
LM_DECODE_TOL = 0.03


def _lm_step(cfg, tcfg, params, batch_np):
    """One make_train_step step of cfg from ``params`` (on their
    device): loss, the gradients caught before the clip by the step's
    compress_grads hook, the new params, the step's seconds and the
    seconds until the gradients were caught (the rest is AdamW)."""
    import torch
    from repro_torch.optim import adamw_init
    from repro_torch.train.step import make_train_step
    from repro_torch.tree import tree_leaves

    d = tree_leaves(params)[0].device
    caught = []
    step = make_train_step(cfg, tcfg, compress_grads=lambda g: (
        caught.append((g, time.perf_counter())), g)[1])
    batch = {k: torch.as_tensor(v, device=d) for k, v in batch_np.items()}
    t0 = time.perf_counter()
    newp, _, m = step(params, adamw_init(params), batch)
    loss = float(m["loss"])
    if d.type == "cuda":
        torch.cuda.synchronize(d)
    return dict(loss=loss, grads=caught[0][0], params=newp,
                s=time.perf_counter() - t0, grad_s=caught[0][1] - t0)


def _lm_step_compare(cfg, tcfg, card, cpu, batch_np, where,
                     grad_atol_rel=LM_GRAD_ATOL_REL):
    """(a)'s verdict on a card step against a CPU step (``_lm_step``),
    compared on ``where``: the loss to rtol LM_LOSS_RTOL, each gradient
    leaf to rtol LM_GRAD_RTOL / atol ``grad_atol_rel`` x its largest
    element, each new param by its sign-certain split."""
    import torch
    require(abs(card["loss"] - cpu["loss"]) <= LM_LOSS_RTOL * abs(cpu["loss"]),
            f"lm step loss: card {card['loss']!r} cpu {cpu['loss']!r}")
    gerr, strict_n, loose_n, perr = 0.0, 0, 0, 0.0
    reach = 2 * tcfg.lr + LM_PARAM_ATOL
    # Adam steps the clipped gradient: the split reads it at that scale
    gnorm = sum(float(torch.sum(torch.square(g.to(where).double())))
                for _, g in _paths(cpu["grads"])) ** 0.5
    clip = min(1.0, tcfg.grad_clip / max(gnorm, 1e-12))
    for (path, g), (_, gc), (_, pn), (_, pc) in zip(
            _paths(card["grads"]), _paths(cpu["grads"]),
            _paths(card["params"]), _paths(cpu["params"])):
        g, gc, pn, pc = (t.to(where) for t in (g, gc, pn, pc))
        atol = grad_atol_rel * float(gc.abs().max())
        gerr = max(gerr, _close(g, gc, LM_GRAD_RTOL, atol,
                                f"lm step-1 gradient {path}"))
        certain = (clip * gc.abs() >= LM_STEP_GRAD_T) & (
            gc.abs() >= 10 * (g - gc).abs())
        d = (pn - pc).abs()
        bad = torch.where(certain, d > LM_PARAM_ATOL, d > reach)
        require(not bool(bad.any()), f"lm step new param {path}: "
                f"{int(bad.sum())} elements beyond {LM_PARAM_ATOL} (sign "
                f"certain) or {reach} (not); max diff {float(d.max()):.3e}")
        strict_n += int(certain.sum())
        loose_n += int((~certain).sum())
        perr = max(perr, float(torch.where(certain, d, 0.0).max()))
    bsz, seq = batch_np["tokens"].shape
    log(f"lm (a) {cfg.name} x{cfg.num_layers} layers float32, batch "
        f"{bsz} x seq {seq}: one step card {card['s']:.3f} s / cpu "
        f"{cpu['s']:.3f} s (gradients {cpu['grad_s']:.3f} s, AdamW the "
        f"rest); loss card {card['loss']:.7f} cpu "
        f"{cpu['loss']:.7f}; {len(_paths(cpu['grads']))} gradient leaves "
        f"within rtol {LM_GRAD_RTOL} / atol {grad_atol_rel} x max|leaf| "
        f"(max err {gerr:.3e}, clip scale {clip:.4f}); new params: "
        f"{strict_n} elements with a "
        f"certain sign within {LM_PARAM_ATOL} (max {perr:.3e}), {loose_n} "
        f"within the step's reach {reach:.1e}")
    return dict(loss_card=card["loss"], loss_cpu=cpu["loss"], grad_err=gerr,
                param_err=perr, loose=loose_n, card_s=card["s"],
                cpu_s=cpu["s"], cpu_grad_s=cpu["grad_s"])


def _lm_step_check(cfg, dev, tcfg, batch_np):
    """(a): one make_train_step step of cfg (float32) on the card and on
    the CPU from the same params (drawn from seed 0 on the host and
    bridged through numpy) and batch."""
    import torch
    from repro_torch import bridge
    from repro_torch.models import api

    host = torch.device("cpu")
    p_np = bridge.params_to_numpy(api.init_params(
        cfg, torch.Generator().manual_seed(0), device=host))
    card, cpu = (_lm_step(cfg, tcfg, bridge.lm_params_from_numpy(
        cfg, p_np, device=d), batch_np) for d in (dev, host))
    return _lm_step_compare(cfg, tcfg, card, cpu, batch_np, host)


def _gib(x) -> str:
    return "n/a" if x is None else f"{x:.3f} GiB"


def _lm_cli(argv, timeout=LM_CLI_TIMEOUT):
    env = dict(os.environ, PYTHONPATH=str(SRC))
    t0 = time.perf_counter()
    proc = subprocess.run([sys.executable] + argv, cwd=ROOT, env=env,
                          stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
                          text=True, timeout=timeout)
    return proc, time.perf_counter() - t0


def _cli_results(arch, running, r, steps):
    """Wait for the CLI processes ``running`` ({name: future of
    ``_lm_cli``}) of ``arch``: each exits 0, a launch.train prints its
    summary with ``steps`` steps and a falling loss, a launch.serve its
    decode line.  Their seconds go to r["cli"], the summaries to
    r["cli_summary"]."""
    for name, fut in running.items():
        proc, secs = fut.result()
        for line in proc.stdout.splitlines()[-2:]:
            log(f"  {name} {arch}| {line}")
        require(proc.returncode == 0, f"{name} --arch {arch} exited "
                f"{proc.returncode}")
        if name.startswith("launch.train"):
            summ = [ln for ln in proc.stdout.splitlines()
                    if ln.startswith("lm train summary ")]
            require(len(summ) == 1, f"{name} {arch}: no summary")
            tr = json.loads(summ[0][len("lm train summary "):])
            require(tr["steps"] == steps
                    and tr["last_loss"] < tr["first_loss"],
                    f"{name} {arch}: {tr}")
            r.setdefault("cli_summary", {})[name] = tr
        else:
            require("ms/token" in proc.stdout,
                    f"{name} {arch}: no decode line")
        r.setdefault("cli", {})[name] = secs


def _lm_supervised(cfg, dev, tcfg, ckpt_dir):
    """(c): LM_SUP_STEPS steps under TrainSupervisor (a checkpoint every
    LM_SUP_EVERY, a failure injected at LM_FAIL_AT) against the same
    steps uninterrupted; the carries must be equal bit for bit."""
    import torch
    from repro_torch.checkpoint import CheckpointStore
    from repro_torch.data import lm_batch_fn
    from repro_torch.models import api
    from repro_torch.optim import adamw_init
    from repro_torch.runtime.fault import FailureInjector, TrainSupervisor
    from repro_torch.train.step import make_train_step

    params = api.init_params(cfg, torch.Generator().manual_seed(0),
                             device=dev)
    raw = make_train_step(cfg, tcfg)
    make_np = lm_batch_fn(cfg.vocab_size, LM_B, LM_S, seed=0)

    def make_batch(step):
        return {k: torch.as_tensor(v, device=dev)
                for k, v in make_np(step).items()}

    def make_step():
        def step(carry, batch):
            p, o, m = raw(carry[0], carry[1], batch)
            return (p, o), m
        return step

    t0 = time.perf_counter()
    ref, step = (params, adamw_init(params)), make_step()
    for s in range(LM_SUP_STEPS):
        ref, _ = step(ref, make_batch(s))
    torch.cuda.synchronize()
    t1 = time.perf_counter()
    restarts = []
    sup = TrainSupervisor(store=CheckpointStore(ckpt_dir, keep=2),
                          make_step=make_step, make_batch=make_batch,
                          ckpt_every=LM_SUP_EVERY)
    out = sup.run((params, adamw_init(params)), num_steps=LM_SUP_STEPS,
                  injector=FailureInjector(fail_at=(LM_FAIL_AT,)),
                  on_restart=restarts.append)
    torch.cuda.synchronize()
    t2 = time.perf_counter()
    want = LM_FAIL_AT - LM_FAIL_AT % LM_SUP_EVERY
    require(out["restarts"] == 1 and restarts == [want]
            and out["step"] == LM_SUP_STEPS,
            f"lm supervisor: restarts {out['restarts']} from {restarts}, "
            f"step {out['step']}; want one restart from step {want}")
    got, exp = _paths(out["carry"]), _paths(ref)
    require([p for p, _ in got] == [p for p, _ in exp],
            "lm supervisor: carry trees differ")
    differ = [p for (p, a), (_, b) in zip(got, exp)
              if (a is None) != (b is None)
              or (a is not None and not torch.equal(a, b))]
    require(not differ, f"lm supervisor: the resumed run differs from the "
            f"uninterrupted one in {len(differ)} leaves, first {differ[:3]}")
    n = sum(1 for _, a in got if a is not None)
    log(f"lm (c) {cfg.name} x{cfg.num_layers} layers {cfg.dtype}: "
        f"{LM_SUP_STEPS} steps uninterrupted {t1 - t0:.3f} s; under "
        f"TrainSupervisor (checkpoint every {LM_SUP_EVERY}, failure at step "
        f"{LM_FAIL_AT}, restored from step {want}) {t2 - t1:.3f} s; params "
        f"and optimizer state equal bit for bit ({n} tensors)")
    return dict(plain_s=t1 - t0, supervised_s=t2 - t1, tensors=n)


def _lm_decode(cfg, dev):
    """(d): greedy decode at full lm-100m (bf16), LM_DECODE_B sequences
    of context LM_DECODE_CTX: the first LM_PREFILL tokens teacher-forced
    from a prompt and held against the prefill logits, then generated;
    the whole LM_DECODE_TOKENS run timed on its second pass."""
    import torch
    from repro_torch.data import lm_batch_fn
    from repro_torch.models import api, lm
    from repro_torch.models.layers.common import zeros_from_spec
    from repro_torch.train.step import make_serve_step

    params = api.init_params(cfg, torch.Generator().manual_seed(0),
                             device=dev)
    prompt = torch.as_tensor(lm_batch_fn(
        cfg.vocab_size, LM_DECODE_B, LM_PREFILL, seed=1)(0)["tokens"],
        device=dev)
    with torch.no_grad():
        pre = lm.prefill_logits(cfg, params, prompt)
    step = make_serve_step(cfg)
    spec = api.decode_state_spec(cfg, LM_DECODE_B, LM_DECODE_CTX)

    def decode(check):
        state = zeros_from_spec(spec, device=dev)
        tok, err = prompt[:, :1], 0.0
        for i in range(LM_DECODE_TOKENS):
            logits, state = step(params, state, tok)
            if check and i < LM_PREFILL:
                err = max(err, float((logits - pre[:, i]).abs().max()))
            tok = (prompt[:, i + 1:i + 2] if i + 1 < LM_PREFILL else
                   torch.argmax(logits, -1).to(torch.int32)[:, None])
        torch.cuda.synchronize()
        return err, int(state["pos"])

    err, pos = decode(True)
    scale = float(pre.abs().max())
    require(err <= LM_DECODE_TOL * scale, f"lm decode logits differ from "
            f"prefill by {err:.4e} > {LM_DECODE_TOL} x {scale:.4f}")
    require(pos == LM_DECODE_TOKENS, f"decode state pos {pos}")
    t0 = time.perf_counter()
    decode(False)
    dt = time.perf_counter() - t0
    ms = dt / LM_DECODE_TOKENS * 1e3
    tok_s = LM_DECODE_TOKENS * LM_DECODE_B / dt
    log(f"lm (d) {cfg.name} {cfg.dtype} decode, batch {LM_DECODE_B}, "
        f"context {LM_DECODE_CTX}: first {LM_PREFILL} tokens' logits within "
        f"{err:.4e} of prefill (max |logit| {scale:.4f}, tolerance "
        f"{LM_DECODE_TOL} x it); {LM_DECODE_TOKENS} tokens {ms:.3f} ms/token, "
        f"{tok_s:.0f} tok/s")
    return dict(err=err, scale=scale, ms_per_token=ms, tok_s=tok_s)


def _lm_profile(cfg, dev, tcfg):
    """Where a full-depth training step's time goes: wall ms of a warm
    step (synchronized), the device's busy ms in it (``torch.profiler``,
    every kernel) and the kernels that take the most device time."""
    import torch
    from torch.profiler import ProfilerActivity, profile
    from repro_torch.data import lm_batch_fn
    from repro_torch.models import api
    from repro_torch.optim import adamw_init
    from repro_torch.train.step import make_train_step

    params = api.init_params(cfg, torch.Generator().manual_seed(0),
                             device=dev)
    opt = adamw_init(params)
    step = make_train_step(cfg, tcfg)
    make = lm_batch_fn(cfg.vocab_size, LM_B, LM_S, seed=0)
    batches = [{k: torch.as_tensor(v, device=dev)
                for k, v in make(s).items()} for s in range(LM_PROFILE_STEPS)]

    def run():
        nonlocal params, opt
        for b in batches:
            params, opt, m = step(params, opt, b)
        torch.cuda.synchronize()

    run()   # warm: the allocator's pools, cuBLAS's handles and plans
    t0 = time.perf_counter()
    run()
    wall = (time.perf_counter() - t0) / LM_PROFILE_STEPS * 1e3
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        run()
    by_kernel = sorted(((e.self_device_time_total, e.key)
                        for e in prof.key_averages()
                        if e.self_device_time_total > 0), reverse=True)
    busy = sum(u for u, _ in by_kernel) / 1e3 / LM_PROFILE_STEPS
    log(f"lm (b') {cfg.name} ({cfg.num_layers} layers, {cfg.dtype}) train "
        f"step in process, batch {LM_B} x seq {LM_S}: {wall:.3f} ms/step "
        f"wall, device busy {busy:.3f} ms/step = {busy / wall:.4f} of it; "
        "device ms per step by kernel: " + ", ".join(
            f"{k[:40]} {u / 1e3 / LM_PROFILE_STEPS:.3f}"
            for u, k in by_kernel[:8]))
    return dict(wall_ms=wall, busy_ms=busy, busy_share=busy / wall,
                top=[(k, u / 1e3 / LM_PROFILE_STEPS) for u, k in by_kernel[:8]])


def phase_lm(dev, card):
    """The dense-LM path at lm-100m's full width: (a) one float32 step of
    the 2-layer cut on the card against the CPU, (b) launch.train at
    full depth for LM_TRAIN_STEPS steps with two checkpoints, then a
    profiled step in process, (c) the supervisor's restart equal to an
    uninterrupted run bit for bit, (d) decode against prefill, (e) the
    example and launch.serve --mode lm as processes, run while (a) and
    (c), which time nothing, run.  None of K1-K5 is on this path: their
    counts are read and must stay 0."""
    import dataclasses
    import shutil
    import tempfile
    from concurrent.futures import ThreadPoolExecutor
    from repro_torch.config import TrainConfig, get_config
    from repro_torch.data import lm_batch_fn
    from repro_torch.kernels.lut_cascade import lut_cascade
    from repro_torch.kernels.lut_gather import lut_layer, lut_lookup
    from repro_torch.kernels.neuralut_grad import (subnet_train_bwd,
                                                   subnet_train_fwd)
    from repro_torch.kernels.neuralut_mlp import grouped_subnet

    t_start = time.perf_counter()
    wrappers = (lut_cascade, lut_layer, lut_lookup, subnet_train_fwd,
                subnet_train_bwd, grouped_subnet)
    for fn in wrappers:
        fn.launches = 0
    full = get_config(LM_ARCH, reduced=LM_REDUCED)
    red = ["--reduced"] if LM_REDUCED else []
    cut = dataclasses.replace(full, num_layers=LM_CUT_LAYERS)
    tcfg = TrainConfig(lr=3e-4, sgdr_t0=50)   # the launcher's defaults
    tmp = tempfile.mkdtemp(prefix="chip_smoke_lm_")
    clis = {"lm_train_torch": [str(ROOT / "examples" / "lm_train_torch.py"),
                               "--steps", "30", "--ckpt", f"{tmp}/ex",
                               "--device", dev.type],
            "serve --mode lm": ["-m", "repro_torch.launch.serve", "--mode",
                                "lm", "--device", dev.type]}
    wants = {"lm_train_torch": "trained to step 30",
             "serve --mode lm": "ms/token"}
    res = {}
    pool = ThreadPoolExecutor(len(clis))
    try:
        running = {k: pool.submit(_lm_cli, v) for k, v in clis.items()}
        res["step"] = _lm_step_check(
            dataclasses.replace(cut, dtype="float32"), dev, tcfg,
            lm_batch_fn(full.vocab_size, LM_B, LM_S, seed=0)(0))
        res["supervisor"] = _lm_supervised(cut, dev, tcfg, f"{tmp}/sup")
        res["cli"] = {}
        for name, fut in running.items():
            proc, secs = fut.result()
            for line in proc.stdout.splitlines()[-3:]:
                log(f"  {name}| {line}")
            require(proc.returncode == 0 and wants[name] in proc.stdout,
                    f"{name} exited {proc.returncode}")
            res["cli"][name] = secs
        log(f"lm (e) examples/lm_train_torch.py --steps 30 and launch.serve "
            "--mode lm exit 0 (" + ", ".join(
                f"{k} {v:.1f} s" for k, v in res["cli"].items())
            + ", beside (a) and (c))")
        proc, secs = _lm_cli(
            ["-m", "repro_torch.launch.train", "--arch", LM_ARCH, "--steps",
             str(LM_TRAIN_STEPS), "--ckpt-dir", f"{tmp}/launcher",
             "--ckpt-every", str(LM_CKPT_EVERY), "--log-every", "10",
             "--device", dev.type] + red)
        for line in proc.stdout.splitlines()[-8:]:
            log(f"  launch.train| {line}")
        require(proc.returncode == 0, f"launch.train --arch {LM_ARCH} "
                f"exited {proc.returncode}")
        summ = [ln for ln in proc.stdout.splitlines()
                if ln.startswith("lm train summary ")]
        require(len(summ) == 1, "launch.train printed no summary")
        train = json.loads(summ[0][len("lm train summary "):])
        require(train["steps"] == LM_TRAIN_STEPS
                and train["last_loss"] < train["first_loss"],
                f"launch.train: loss did not fall over {train['steps']} "
                f"steps ({train['first_loss']} -> {train['last_loss']})")
        saved = sorted(os.listdir(f"{tmp}/launcher"))
        require(saved == [f"step_{s:010d}" for s in range(
            LM_CKPT_EVERY, LM_TRAIN_STEPS + 1, LM_CKPT_EVERY)],
            f"launch.train checkpoints {saved}")
        shutil.rmtree(f"{tmp}/launcher")
        train["process_s"] = secs
        res["train"] = train
        log(f"lm (b) launch.train {LM_ARCH} full ({full.num_layers} layers, "
            f"{full.dtype}), batch {LM_B} x seq {LM_S}, {LM_TRAIN_STEPS} "
            f"steps, checkpoints at {LM_CKPT_EVERY}-step intervals ({card}): "
            f"{train['ms_per_step']:.3f} ms/step, {train['tokens_per_s']:.0f} "
            f"tokens/s, peak memory {_gib(train['peak_mem_gib'])}; loss "
            f"{train['first_loss']:.4f} -> {train['last_loss']:.4f}; "
            f"process {secs:.1f} s")
        res["profile"] = _lm_profile(full, dev, tcfg)
        res["decode"] = _lm_decode(full, dev)
    finally:
        pool.shutdown(wait=True)
        shutil.rmtree(tmp, ignore_errors=True)
    launches = {fn.__name__: fn.launches for fn in wrappers}
    require(not any(launches.values()), f"the LM path launched a LUT "
            f"kernel: {launches}")
    res["seconds"] = time.perf_counter() - t_start
    log(f"lm: K1-K5 launches on the LM path {launches}; phase "
        f"{res['seconds']:.1f} s")
    return res


MOE_ARCHS = ("qwen2-moe-a2.7b", "deepseek-v2-lite-16b")
MOE_CUT_LAYERS = 2         # qwen: 2 MoE layers; deepseek: the dense prefix + 1
# (a)'s float32 step, card against the CPU, cut further where a layer is
# still an MoE layer: qwen to its first (the CPU's AdamW over 2B params
# took ~50 s); deepseek keeps both (its first is the dense prefix)
MOE_STEP_LAYERS = {"qwen2-moe-a2.7b": 1}
MOE_STEP_B, MOE_STEP_S = 2, 32   # (a): the dense dispatch on the CPU
MOE_WARM_STEPS, MOE_TIMED_STEPS = 2, 3     # (b), then one profiled step
MOE_CLI_STEPS = 6
# (c) float32 decode against float32 prefill: |logit diff| <= 3e-3 x the
# largest |prefill logit| (tests/test_mla.py's decode-vs-prefill 3e-3,
# taken relative to the logits' scale)
MOE_DECODE_TOL = 3e-3


def _lm_train_steps(cfg, dev, tcfg, params, make=None):
    """(b): MOE_WARM_STEPS + MOE_TIMED_STEPS bf16 steps through
    make_train_step at batch LM_B x LM_S (or ``make(step)``'s numpy
    batches) from ``params`` (on the card),
    then one step under the profiler: ms/step and tokens/s of the timed
    steps (synchronized), peak memory, the busy share of the profiled
    step, and the loss, CE and aux loss of every step (the aux loss
    above 0 where the config has MoE layers)."""
    import numpy as np
    import torch
    from torch.profiler import ProfilerActivity, profile
    from repro_torch.data import lm_batch_fn
    from repro_torch.optim import adamw_init
    from repro_torch.train.step import make_train_step

    step = make_train_step(cfg, tcfg)
    if make is None:
        make = lm_batch_fn(cfg.vocab_size, LM_B, LM_S, seed=0)
    n = MOE_WARM_STEPS + MOE_TIMED_STEPS + 1
    batches = [{k: torch.as_tensor(v, device=dev)
                for k, v in make(s).items()} for s in range(n)]
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats(dev)
    opt = adamw_init(params)
    mets, t0 = [], None
    for i, b in enumerate(batches[:-1]):
        if i == MOE_WARM_STEPS:
            torch.cuda.synchronize()
            t0 = time.perf_counter()
        params, opt, m = step(params, opt, b)
        mets.append(m)
    torch.cuda.synchronize()
    ms = (time.perf_counter() - t0) / MOE_TIMED_STEPS * 1e3
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        tp = time.perf_counter()
        params, opt, m = step(params, opt, batches[-1])
        torch.cuda.synchronize()
        wall = (time.perf_counter() - tp) * 1e3
    mets.append(m)
    peak = torch.cuda.max_memory_allocated(dev) / 2 ** 30
    by_kernel = sorted(((e.self_device_time_total, e.key)
                        for e in prof.key_averages()
                        if e.self_device_time_total > 0), reverse=True)
    busy = sum(u for u, _ in by_kernel) / 1e3
    hist = [{k: float(m[k]) for k in ("loss", "ce", "moe_aux")}
            for m in mets]
    moe = any(spec.ffn == "moe" for spec in cfg.pattern)
    require(all(np.isfinite(h["loss"]) for h in hist)
            and hist[-1]["loss"] < hist[0]["loss"]
            and all((h["moe_aux"] > 0) == moe for h in hist),
            f"lm {cfg.name} (b): the loss did not fall or is not finite, "
            f"or the aux loss is 0 with MoE layers (or not without): "
            f"{hist}")
    bsz, seq = batches[0]["tokens"].shape
    tok_s = bsz * seq / ms * 1e3
    log(f"lm (b) {cfg.name} x{cfg.num_layers} layers {cfg.dtype}, batch "
        f"{bsz} x seq {seq}: {ms:.3f} ms/step over {MOE_TIMED_STEPS} "
        f"steps, {tok_s:.0f} tokens/s, peak memory {peak:.3f} GiB; "
        f"profiled step {wall:.3f} ms wall, device busy {busy:.3f} ms = "
        f"{busy / wall:.4f} of it; loss {hist[0]['loss']:.4f} -> "
        f"{hist[-1]['loss']:.4f} (CE {hist[0]['ce']:.4f} -> "
        f"{hist[-1]['ce']:.4f}, aux {hist[0]['moe_aux']:.5f} -> "
        f"{hist[-1]['moe_aux']:.5f}); device ms by kernel: " + ", ".join(
            f"{k[:40]} {u / 1e3:.3f}" for u, k in by_kernel[:6]))
    return dict(ms_per_step=ms, tokens_per_s=tok_s, peak_mem_gib=peak,
                busy_ms=busy, wall_ms=wall, busy_share=busy / wall,
                history=hist)


def _first_layers(cfg, params, n):
    """(cfg, params) cut to the first ``n`` layers of a stacked LM tree
    (a single-position pattern: each leaf of ``blocks`` stacked over the
    layers), the params views of the uncut ones."""
    import dataclasses
    from repro_torch.tree import tree_map
    if n == cfg.num_layers:
        return cfg, params
    if len(cfg.pattern) != 1 or cfg.num_dense_prefix:
        raise ValueError(f"{cfg.name}: cut only a single-position pattern")
    return (dataclasses.replace(cfg, num_layers=n),
            dict(params, blocks=[tree_map(lambda a: a[:n], b)
                                 for b in params["blocks"]]))


def _moe_decode(cfg32, cfg, dev, p32, params):
    """(c): teacher-forced float32 decode of LM_PREFILL tokens at batch
    LM_DECODE_B, context LM_DECODE_CTX, against the float32 prefill
    logits (every token routed by the dense dispatch, as the
    reference's decode is); then LM_DECODE_TOKENS greedy bf16 tokens,
    timed on a second pass; the decode cache's bytes per token per
    layer."""
    import math
    import torch
    from repro_torch.data import lm_batch_fn
    from repro_torch.models import api, lm
    from repro_torch.models.layers.common import dtype_of, zeros_from_spec
    from repro_torch.train.step import make_serve_step
    from repro_torch.tree import tree_leaves

    prompt = torch.as_tensor(lm_batch_fn(
        cfg.vocab_size, LM_DECODE_B, LM_PREFILL, seed=1)(0)["tokens"],
        device=dev)

    def decode(c, p, n, pre=None):
        step = make_serve_step(c)
        state = zeros_from_spec(api.decode_state_spec(
            c, LM_DECODE_B, LM_DECODE_CTX), device=dev)
        tok, err = prompt[:, :1], 0.0
        for i in range(n):
            logits, state = step(p, state, tok)
            if pre is not None and i < LM_PREFILL:
                err = max(err, float((logits - pre[:, i]).abs().max()))
            tok = (prompt[:, i + 1:i + 2] if i + 1 < LM_PREFILL else
                   torch.argmax(logits, -1).to(torch.int32)[:, None])
        torch.cuda.synchronize()
        return err, int(state["pos"])

    with torch.no_grad():
        pre = lm.prefill_logits(cfg32, p32, prompt)
    err, pos = decode(cfg32, p32, LM_PREFILL, pre)
    scale = float(pre.abs().max())
    require(err <= MOE_DECODE_TOL * scale and pos == LM_PREFILL,
            f"lm {cfg.name} decode logits differ from prefill by {err:.4e} "
            f"> {MOE_DECODE_TOL} x {scale:.4f} (pos {pos})")
    decode(cfg, params, LM_DECODE_TOKENS)
    t0 = time.perf_counter()
    _, pos = decode(cfg, params, LM_DECODE_TOKENS)
    dt = time.perf_counter() - t0
    require(pos == LM_DECODE_TOKENS, f"decode state pos {pos}")
    layer = lm._mixer_cache_spec(cfg.pattern[0], cfg, 1, 1,
                                 dtype_of(cfg.dtype))
    cache_b = sum(math.prod(s.shape) * s.dtype.itemsize
                  for s in tree_leaves(layer))
    a = cfg.attention
    expanded = 2 * a.num_heads * (a.nope_head_dim or a.head_dim) * 2
    ms = dt / LM_DECODE_TOKENS * 1e3
    tok_s = LM_DECODE_TOKENS * LM_DECODE_B / dt
    log(f"lm (c) {cfg.name} decode, batch {LM_DECODE_B}, context "
        f"{LM_DECODE_CTX}: float32, the first {LM_PREFILL} tokens' logits "
        f"within {err:.4e} of prefill (max |logit| {scale:.4f}, tolerance "
        f"{MOE_DECODE_TOL} x it); bf16 {LM_DECODE_TOKENS} tokens {ms:.3f} "
        f"ms/token, {tok_s:.0f} tok/s; cache {cache_b:.0f} B per token per "
        f"layer ({a.kind}; the expanded K/V would be {expanded} B)")
    return dict(err=err, scale=scale, ms_per_token=ms, tok_s=tok_s,
                cache_bytes_per_token_layer=cache_b,
                expanded_bytes_per_token_layer=expanded)


def phase_moe_lm(dev, card):
    """The MoE (qwen2-moe-a2.7b) and MLA + MoE (deepseek-v2-lite-16b)
    LMs at their published widths, depth cut to MOE_CUT_LAYERS, params
    drawn once per config from seed 0 (float32, on the card, where 2B
    draws take a fraction of a second against ~18 s on the host) and
    reused: (a) one float32 step on the card against the CPU (qwen's at
    its first layer, MOE_STEP_LAYERS) at batch
    MOE_STEP_B x MOE_STEP_S, the CPU's step (~1 min of host AdamW over
    2B params) run beside the card's step and (c), compared on the
    card; (b) bf16 training steps at LM_B x LM_S with a profiled step;
    (c) decode against prefill; (d) launch.train --reduced and
    launch.serve --mode lm as processes, run beside the rest.  None of
    K1-K5 is on this path: their counts must stay 0."""
    import dataclasses
    import torch
    from concurrent.futures import ThreadPoolExecutor
    from repro_torch.config import TrainConfig, get_config
    from repro_torch.data import lm_batch_fn
    from repro_torch.kernels.lut_cascade import lut_cascade
    from repro_torch.kernels.lut_gather import lut_layer, lut_lookup
    from repro_torch.kernels.neuralut_grad import (subnet_train_bwd,
                                                   subnet_train_fwd)
    from repro_torch.kernels.neuralut_mlp import grouped_subnet
    from repro_torch.models import api
    from repro_torch.tree import tree_leaves, tree_map

    t_start = time.perf_counter()
    wrappers = (lut_cascade, lut_layer, lut_lookup, subnet_train_fwd,
                subnet_train_bwd, grouped_subnet)
    for fn in wrappers:
        fn.launches = 0
    tcfg = TrainConfig(lr=3e-4, sgdr_t0=50)   # the launcher's defaults
    host = torch.device("cpu")
    res = {}
    pool, cpu_pool = ThreadPoolExecutor(2), ThreadPoolExecutor(1)
    try:
        for arch in MOE_ARCHS:
            full = get_config(arch, reduced=LM_REDUCED)
            cut = dataclasses.replace(full, num_layers=MOE_CUT_LAYERS)
            cut32 = dataclasses.replace(cut, dtype="float32")
            red = ["--reduced"] if LM_REDUCED else []
            running = {
                "launch.train": pool.submit(_lm_cli, [
                    "-m", "repro_torch.launch.train", "--arch", arch,
                    "--reduced", "--steps", str(MOE_CLI_STEPS),
                    "--log-every", "0", "--device", dev.type]),
                "launch.serve --mode lm": pool.submit(_lm_cli, [
                    "-m", "repro_torch.launch.serve", "--mode", "lm",
                    "--arch", arch, "--device", dev.type] + red)}
            td = time.perf_counter()
            p32 = api.init_params(cut32, torch.Generator(
                device=dev).manual_seed(0), device=dev)
            step_cfg, step_p = _first_layers(
                cut32, p32, MOE_STEP_LAYERS.get(arch, MOE_CUT_LAYERS))
            host_p = tree_map(lambda a: a.to(host), step_p)
            n_params = sum(a.numel() for a in tree_leaves(p32))
            e_pad = p32["blocks"][0]["ffn"]["w_gate"].shape[1]
            r = {"params": n_params, "padded_experts": e_pad,
                 "draw_s": time.perf_counter() - td}
            log(f"lm {arch}: {cut.num_layers} of {full.num_layers} layers "
                f"at full width (d {cut.d_model}, {cut.moe.num_experts} "
                f"experts of {cut.moe.d_ff_expert} padded to {e_pad}, top-"
                f"{cut.moe.top_k}, {cut.moe.num_shared} shared, vocab "
                f"{cut.vocab_size}), {n_params / 1e9:.3f}B params drawn "
                f"from seed 0 on the card and copied to the host in "
                f"{r['draw_s']:.1f} s")
            # (a)'s CPU step runs beside the card's step and (c)
            batch_np = lm_batch_fn(cut.vocab_size, MOE_STEP_B, MOE_STEP_S,
                                   seed=0)(0)
            cpu_fut = cpu_pool.submit(_lm_step, step_cfg, tcfg, host_p,
                                      batch_np)
            on_card = _lm_step(step_cfg, tcfg, step_p, batch_np)
            spec = api.param_spec(cut)
            pb = tree_map(lambda a, sp: a.to(sp.dtype), p32, spec)
            r["decode"] = _moe_decode(cut32, cut, dev, p32, pb)
            r["step"] = _lm_step_compare(step_cfg, tcfg, on_card,
                                         cpu_fut.result(), batch_np, dev)
            del on_card, cpu_fut, host_p, p32, step_p
            torch.cuda.empty_cache()
            r["train"] = _lm_train_steps(cut, dev, tcfg, pb)
            del pb
            torch.cuda.empty_cache()
            _cli_results(arch, running, r, MOE_CLI_STEPS)
            log(f"lm (d) {arch}: launch.train --reduced --steps "
                f"{MOE_CLI_STEPS} and launch.serve --mode lm exit 0 ("
                + ", ".join(f"{k} {v:.1f} s" for k, v in r["cli"].items())
                + ", beside (a))")
            res[arch] = r
    finally:
        pool.shutdown(wait=True)
        cpu_pool.shutdown(wait=True)
    launches = {fn.__name__: fn.launches for fn in wrappers}
    require(not any(launches.values()), f"the MoE LM path launched a LUT "
            f"kernel: {launches}")
    res["seconds"] = time.perf_counter() - t_start
    log(f"lm MoE ({card}): K1-K5 launches on the MoE and MLA paths "
        f"{launches}; phase {res['seconds']:.1f} s")
    return res


SSM_ARCHS = ("jamba-v0.1-52b", "xlstm-350m")
SSM_DECODE_B32, SSM_PREFILL32 = 4, 32   # (c) float32 decode against prefill
# (c) float32 decode from stabilizers at -inf against float32 prefill:
# |logit diff| <= 3e-3 x the largest |prefill logit| (the reference's
# mLSTM decode-vs-prefill bound, tests/test_mixers.py, taken relative)
SSM_DECODE_TOL = 3e-3
# (a) xLSTM at full depth: each gradient leaf to atol 1e-2 x its largest
# element (the rest of LM_GRAD_*).  Its float32 gradient at init is that
# sensitive to the order of float32 sums: the same step on one CPU with
# 1 and with 6 threads differs by up to 3.6e-3 of a leaf's largest
# element (wq of the second layer), with ~1.2M elements of that leaf
# beyond rtol 1e-4 / atol 1e-5 x max; the loss by 1e-7 relative
XLSTM_GRAD_ATOL_REL = 1e-2
XLSTM_TRAIN_STEPS = 2      # (b) launch.train at full size, one checkpoint
SSM_CLI_STEPS = 6


def _jamba_cut(full):
    """(a), (b): jamba cut to one Mamba and one attention layer, each
    with the dense MLP (the pattern cut with the depth, since the
    pattern's length must divide it)."""
    import dataclasses
    from repro_torch.config import LayerSpec
    return dataclasses.replace(full, num_layers=2, pattern=(
        LayerSpec(mixer="mamba", ffn="dense"),
        LayerSpec(mixer="attn", ffn="dense")))


def _draw(cfg, dev):
    """Params of cfg from seed 0, drawn on the card's generator."""
    import torch
    from repro_torch.models import api
    from repro_torch.tree import tree_leaves
    t0 = time.perf_counter()
    p = api.init_params(cfg, torch.Generator(device=dev).manual_seed(0),
                        device=dev)
    torch.cuda.synchronize()
    return p, sum(a.numel() for a in tree_leaves(p)), time.perf_counter() - t0


def _ssm_decode_check(cfg32, dev, p32):
    """(c) float32: SSM_PREFILL32 tokens teacher-forced through
    decode_step at batch SSM_DECODE_B32, from a zero state with every
    xLSTM stabilizer at -inf (the prefill's start), against the float32
    prefill logits at every position."""
    import torch
    from repro_torch.data import lm_batch_fn
    from repro_torch.models import api, lm
    from repro_torch.models.layers.common import zeros_from_spec
    from repro_torch.train.step import make_serve_step

    prompt = torch.as_tensor(lm_batch_fn(
        cfg32.vocab_size, SSM_DECODE_B32, SSM_PREFILL32, seed=1)(0)["tokens"],
        device=dev)
    step = make_serve_step(cfg32)
    with torch.no_grad():
        pre = lm.prefill_logits(cfg32, p32, prompt)
    state = lm.with_minus_inf_stabilizers(zeros_from_spec(
        api.decode_state_spec(cfg32, SSM_DECODE_B32, SSM_PREFILL32),
        device=dev))
    err = 0.0
    for i in range(SSM_PREFILL32):
        logits, state = step(p32, state, prompt[:, i:i + 1])
        err = max(err, float((logits - pre[:, i]).abs().max()))
    torch.cuda.synchronize()
    scale = float(pre.abs().max())
    finite = bool(torch.isfinite(pre).all())
    require(finite and err <= SSM_DECODE_TOL * scale
            and int(state["pos"]) == SSM_PREFILL32,
            f"lm {cfg32.name} float32 decode differs from prefill by "
            f"{err:.4e} > {SSM_DECODE_TOL} x {scale:.4f} (finite {finite})")
    return err, scale


def _ssm_decode_time(cfg, dev, params, ctx=LM_DECODE_CTX, cross=None):
    """(c) bf16: LM_DECODE_TOKENS greedy tokens at batch LM_DECODE_B,
    context ``ctx``, from the zero state (launch.serve's; an enc-dec's
    cross K/V ``cross`` when given), timed on a second pass; the decode
    state's bytes per sequence by mixer."""
    import math
    import torch
    from repro_torch.data import lm_batch_fn
    from repro_torch.models import api, lm
    from repro_torch.models.layers.common import dtype_of, zeros_from_spec
    from repro_torch.train.step import make_serve_step
    from repro_torch.tree import tree_leaves

    prompt = torch.as_tensor(lm_batch_fn(
        cfg.vocab_size, LM_DECODE_B, 1, seed=1)(0)["tokens"], device=dev)
    step = make_serve_step(cfg)
    spec = api.decode_state_spec(cfg, LM_DECODE_B, ctx)

    def decode():
        state = zeros_from_spec(spec, device=dev)
        if cross is not None:
            state["cross"] = cross
        tok = prompt
        for _ in range(LM_DECODE_TOKENS):
            logits, state = step(params, state, tok)
            tok = torch.argmax(logits, -1).to(torch.int32)[:, None]
        torch.cuda.synchronize()
        return logits, int(state["pos"])

    decode()
    t0 = time.perf_counter()
    logits, pos = decode()
    dt = time.perf_counter() - t0
    require(pos == LM_DECODE_TOKENS and bool(torch.isfinite(logits).all()),
            f"lm {cfg.name} bf16 decode: pos {pos}, finite "
            f"{bool(torch.isfinite(logits).all())}")
    state_b = {}
    for s in cfg.pattern:
        one = lm._mixer_cache_spec(s, cfg, 1, ctx, dtype_of(cfg.dtype))
        state_b[s.mixer] = sum(math.prod(t.shape) * t.dtype.itemsize
                               for t in tree_leaves(one))
    return dict(ms_per_token=dt / LM_DECODE_TOKENS * 1e3,
                tok_s=LM_DECODE_TOKENS * LM_DECODE_B / dt,
                state_bytes_per_seq=state_b)


def _jamba(dev, card, tcfg, pool, cpu_pool):
    """jamba-v0.1-52b: (a) a float32 step of the 2-layer cut (Mamba +
    attention, dense MLPs) on the card against the CPU at MOE_STEP_B x
    MOE_STEP_S; (b) bf16 steps of the cut at
    LM_B x LM_S with a profiled one; (c) the whole published superblock
    (8 layers: 7 Mamba, 1 attention, 4 MoE): float32 decode against
    prefill, then bf16 prefill logits at LM_B x LM_S and bf16 decode
    timed; (d) the CLIs, run beside (a) and (c)'s float32 check.  The
    CPU's step and the CLIs end before anything is timed."""
    import dataclasses
    import torch
    from repro_torch.config import get_config
    from repro_torch.data import lm_batch_fn
    from repro_torch.models import api, lm
    from repro_torch.tree import tree_map

    arch = SSM_ARCHS[0]
    full = get_config(arch, reduced=LM_REDUCED)
    red = ["--reduced"] if LM_REDUCED else []
    running = {
        "launch.train --reduced": pool.submit(_lm_cli, [
            "-m", "repro_torch.launch.train", "--arch", arch, "--reduced",
            "--steps", str(SSM_CLI_STEPS), "--log-every", "0", "--device",
            dev.type]),
        "launch.serve --mode lm": pool.submit(_lm_cli, [
            "-m", "repro_torch.launch.serve", "--mode", "lm", "--arch", arch,
            "--device", dev.type] + red)}
    cut = _jamba_cut(full)
    cut32 = dataclasses.replace(cut, dtype="float32")
    p32, n_cut, draw_s = _draw(cut32, dev)
    r = {"cut_params": n_cut}
    log(f"lm {arch}: the 2-layer cut (mamba + attn, dense MLPs) at full "
        f"width (d {cut.d_model}, d_inner {cut.ssm.expand * cut.d_model}, "
        f"d_state {cut.ssm.d_state}, vocab {cut.vocab_size}), "
        f"{n_cut / 1e9:.3f}B params drawn on the card in {draw_s:.1f} s")
    host_p = tree_map(lambda a: a.to("cpu"), p32)
    batch_np = lm_batch_fn(cut.vocab_size, MOE_STEP_B, MOE_STEP_S, seed=0)(0)
    # (a)'s CPU step runs beside the card's step and the untimed float32
    # superblock check, and is done before anything is timed
    cpu_fut = cpu_pool.submit(_lm_step, cut32, tcfg, host_p, batch_np)
    on_card = _lm_step(cut32, tcfg, p32, batch_np)
    pb = tree_map(lambda a, sp: a.to(sp.dtype), p32, api.param_spec(cut))
    del p32
    torch.cuda.empty_cache()
    sb = dataclasses.replace(full, num_layers=len(full.pattern))
    sb32 = dataclasses.replace(sb, dtype="float32")
    p32, n_sb, draw_s = _draw(sb32, dev)
    r["superblock_params"] = n_sb
    r["decode32"] = _ssm_decode_check(sb32, dev, p32)
    del p32
    torch.cuda.empty_cache()
    r["step"] = _lm_step_compare(cut32, tcfg, on_card, cpu_fut.result(),
                                 batch_np, dev)
    del on_card, cpu_fut, host_p
    torch.cuda.empty_cache()
    _cli_results(arch, running, r, SSM_CLI_STEPS)
    r["train"] = _lm_train_steps(cut, dev, tcfg, pb)
    del pb
    torch.cuda.empty_cache()
    pb, _, _ = _draw(sb, dev)
    prompt = torch.as_tensor(lm_batch_fn(sb.vocab_size, LM_B, LM_S, seed=2)(
        0)["tokens"], device=dev)
    with torch.no_grad():
        lm.prefill_logits(sb, pb, prompt)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        pre = lm.prefill_logits(sb, pb, prompt)
        torch.cuda.synchronize()
    r["prefill_ms"] = (time.perf_counter() - t0) * 1e3
    require(tuple(pre.shape) == (LM_B, LM_S, sb.vocab_size)
            and bool(torch.isfinite(pre).all()),
            f"lm {arch} bf16 prefill logits {tuple(pre.shape)}, finite "
            f"{bool(torch.isfinite(pre).all())}")
    del pre
    r["decode"] = _ssm_decode_time(sb, dev, pb)
    del pb
    torch.cuda.empty_cache()
    sbytes = r["decode"]["state_bytes_per_seq"]
    log(f"lm (c) {arch} superblock ({sb.num_layers} layers: "
        f"{sum(s.mixer == 'mamba' for s in sb.pattern)} mamba, "
        f"{sum(s.mixer == 'attn' for s in sb.pattern)} attn, "
        f"{sum(s.ffn == 'moe' for s in sb.pattern)} MoE of "
        f"{sb.moe.num_experts} experts top-{sb.moe.top_k}; {n_sb / 1e9:.3f}B "
        f"params, drawn in {draw_s:.1f} s): float32 decode of "
        f"{SSM_PREFILL32} tokens at batch {SSM_DECODE_B32} within "
        f"{r['decode32'][0]:.4e} of prefill (max |logit| "
        f"{r['decode32'][1]:.4f}, tolerance {SSM_DECODE_TOL} x it); bf16 "
        f"prefill of {LM_B} x {LM_S} {r['prefill_ms']:.3f} ms, logits "
        f"finite; bf16 decode at batch {LM_DECODE_B}, context "
        f"{LM_DECODE_CTX}: {r['decode']['ms_per_token']:.3f} ms/token, "
        f"{r['decode']['tok_s']:.0f} tok/s; decode state per sequence "
        f"at context {LM_DECODE_CTX}: mamba {sbytes.get('mamba', 0)} B a "
        f"layer against attn (KV) {sbytes.get('attn', 0)} B")
    log(f"lm (d) {arch}: launch.train --reduced --steps {SSM_CLI_STEPS} and "
        "launch.serve --mode lm exit 0 (" + ", ".join(
            f"{k} {v:.1f} s" for k, v in r["cli"].items())
        + ", beside (a) and (c)'s float32 check)")
    return r


def _xlstm(dev, card, tcfg, pool, cpu_pool, tmp):
    """xlstm-350m at full depth (24 layers: 21 mLSTM, 3 sLSTM): (a) a
    float32 step on the card against the CPU at MOE_STEP_B x MOE_STEP_S,
    the CPU's step beside (c)'s float32 check; (c) float32 decode of one
    superblock (8 layers) from stabilizers at -inf against prefill, then
    (the CPU step and the CLIs done) bf16 decode of all 24 layers timed;
    (b)
    launch.train at the launcher's LM_B x LM_S for XLSTM_TRAIN_STEPS
    steps with a checkpoint, alone on the card, then bf16 steps in
    process with a profiled one; (d) launch.train --reduced and
    launch.serve --mode lm, run beside (a) and (c)."""
    import dataclasses
    import torch
    from repro_torch.config import get_config
    from repro_torch.data import lm_batch_fn
    from repro_torch.models import api
    from repro_torch.tree import tree_map

    arch = SSM_ARCHS[1]
    full = get_config(arch, reduced=LM_REDUCED)
    red = ["--reduced"] if LM_REDUCED else []
    running = {
        "launch.train --reduced": pool.submit(_lm_cli, [
            "-m", "repro_torch.launch.train", "--arch", arch, "--reduced",
            "--steps", str(SSM_CLI_STEPS), "--log-every", "0", "--device",
            dev.type]),
        "launch.serve --mode lm": pool.submit(_lm_cli, [
            "-m", "repro_torch.launch.serve", "--mode", "lm", "--arch", arch,
            "--device", dev.type] + red)}
    f32 = dataclasses.replace(full, dtype="float32")
    p32, n, draw_s = _draw(f32, dev)
    r = {"params": n}
    log(f"lm {arch}: {full.num_layers} layers ("
        f"{sum(s.mixer == 'mlstm' for s in full.layer_specs())} mLSTM, "
        f"{sum(s.mixer == 'slstm' for s in full.layer_specs())} sLSTM), d "
        f"{full.d_model}, {full.ssm.num_heads} heads, proj "
        f"{full.ssm.proj_factor}, vocab {full.vocab_size}, tied; "
        f"{n / 1e6:.1f}M params drawn on the card in {draw_s:.1f} s")
    host_p = tree_map(lambda a: a.to("cpu"), p32)
    batch_np = lm_batch_fn(full.vocab_size, MOE_STEP_B, MOE_STEP_S,
                           seed=0)(0)
    cpu_fut = cpu_pool.submit(_lm_step, f32, tcfg, host_p, batch_np)
    on_card = _lm_step(f32, tcfg, p32, batch_np)
    # decode walks the stacked blocks position-major, as the reference's
    # does, and prefill repeat-major: they agree over one superblock
    # (ROADMAP, caveats about the reference)
    sb32 = dataclasses.replace(f32, num_layers=len(f32.pattern))
    r["decode32"] = _ssm_decode_check(sb32, dev, _draw(sb32, dev)[0])
    pb = tree_map(lambda a, sp: a.to(sp.dtype), p32, api.param_spec(full))
    r["step"] = _lm_step_compare(f32, tcfg, on_card, cpu_fut.result(),
                                 batch_np, dev, XLSTM_GRAD_ATOL_REL)
    del on_card, cpu_fut, host_p, p32
    torch.cuda.empty_cache()
    _cli_results(arch, running, r, SSM_CLI_STEPS)
    r["decode"] = _ssm_decode_time(full, dev, pb)
    sbytes = r["decode"]["state_bytes_per_seq"]
    log(f"lm (c) {arch}: float32 decode of one superblock ("
        f"{len(full.pattern)} layers) for {SSM_PREFILL32} tokens at batch "
        f"{SSM_DECODE_B32} from stabilizers at -inf within "
        f"{r['decode32'][0]:.4e} of prefill (max |logit| "
        f"{r['decode32'][1]:.4f}, tolerance {SSM_DECODE_TOL} x it); bf16 "
        f"decode of all {full.num_layers} layers at batch {LM_DECODE_B}: "
        f"{r['decode']['ms_per_token']:.3f} "
        f"ms/token, {r['decode']['tok_s']:.0f} tok/s; decode state per "
        f"sequence: mLSTM {sbytes.get('mlstm', 0)} B, sLSTM "
        f"{sbytes.get('slstm', 0)} B a layer")
    log(f"lm (d) {arch}: launch.train --reduced --steps {SSM_CLI_STEPS} and "
        "launch.serve --mode lm exit 0 (" + ", ".join(
            f"{k} {v:.1f} s" for k, v in r["cli"].items())
        + ", beside (a) and (c)'s float32 check)")
    # (b): the launcher alone on the card, then steps in process
    del pb
    torch.cuda.empty_cache()
    proc, secs = _lm_cli(
        ["-m", "repro_torch.launch.train", "--arch", arch, "--steps",
         str(XLSTM_TRAIN_STEPS), "--ckpt-dir", f"{tmp}/xlstm",
         "--ckpt-every", str(XLSTM_TRAIN_STEPS), "--log-every", "1",
         "--device", dev.type] + red)
    for line in proc.stdout.splitlines()[-4:]:
        log(f"  launch.train {arch}| {line}")
    require(proc.returncode == 0, f"launch.train --arch {arch} exited "
            f"{proc.returncode}")
    summ = [ln for ln in proc.stdout.splitlines()
            if ln.startswith("lm train summary ")]
    require(len(summ) == 1, f"launch.train {arch} printed no summary")
    tr = json.loads(summ[0][len("lm train summary "):])
    saved = sorted(os.listdir(f"{tmp}/xlstm"))
    require(tr["steps"] == XLSTM_TRAIN_STEPS
            and saved == [f"step_{XLSTM_TRAIN_STEPS:010d}"],
            f"launch.train {arch}: {tr['steps']} steps, checkpoints {saved}")
    tr["process_s"] = secs
    r["launcher"] = tr
    log(f"lm (b) launch.train {arch} full ({full.num_layers} layers, "
        f"{full.dtype}), batch {LM_B} x seq {LM_S}, {XLSTM_TRAIN_STEPS} "
        f"steps, a checkpoint at step {XLSTM_TRAIN_STEPS} ({card}): "
        f"{tr['ms_per_step']:.3f} ms/step, {tr['tokens_per_s']:.0f} "
        f"tokens/s, peak memory {_gib(tr['peak_mem_gib'])}; loss "
        f"{tr['first_loss']:.4f} -> {tr['last_loss']:.4f}; process "
        f"{secs:.1f} s")
    pb, _, _ = _draw(full, dev)
    r["train"] = _lm_train_steps(full, dev, tcfg, pb)
    del pb
    torch.cuda.empty_cache()
    return r


def phase_ssm_lm(dev, card):
    """The hybrid LM (jamba-v0.1-52b: Mamba, attention, MoE) and the
    xLSTM LM (xlstm-350m: mLSTM and sLSTM) at their published widths,
    params drawn on the card from seed 0.  None of K1-K5 is on these
    paths: their counts must stay 0."""
    import shutil
    import tempfile
    import torch
    from concurrent.futures import ThreadPoolExecutor
    from repro_torch.config import TrainConfig
    from repro_torch.kernels.lut_cascade import lut_cascade
    from repro_torch.kernels.lut_gather import lut_layer, lut_lookup
    from repro_torch.kernels.neuralut_grad import (subnet_train_bwd,
                                                   subnet_train_fwd)
    from repro_torch.kernels.neuralut_mlp import grouped_subnet

    t_start = time.perf_counter()
    wrappers = (lut_cascade, lut_layer, lut_lookup, subnet_train_fwd,
                subnet_train_bwd, grouped_subnet)
    for fn in wrappers:
        fn.launches = 0
    tcfg = TrainConfig(lr=3e-4, sgdr_t0=50)   # the launcher's defaults
    tmp = tempfile.mkdtemp(prefix="chip_smoke_ssm_")
    res = {}
    pool, cpu_pool = ThreadPoolExecutor(2), ThreadPoolExecutor(1)
    try:
        t0 = time.perf_counter()
        res[SSM_ARCHS[0]] = _jamba(dev, card, tcfg, pool, cpu_pool)
        res[SSM_ARCHS[0]]["seconds"] = time.perf_counter() - t0
        t0 = time.perf_counter()
        res[SSM_ARCHS[1]] = _xlstm(dev, card, tcfg, pool, cpu_pool, tmp)
        res[SSM_ARCHS[1]]["seconds"] = time.perf_counter() - t0
    finally:
        pool.shutdown(wait=True)
        cpu_pool.shutdown(wait=True)
        shutil.rmtree(tmp, ignore_errors=True)
    launches = {fn.__name__: fn.launches for fn in wrappers}
    require(not any(launches.values()), f"the SSM LM paths launched a LUT "
            f"kernel: {launches}")
    res["seconds"] = time.perf_counter() - t_start
    log(f"lm SSM ({card}): K1-K5 launches on the jamba and xLSTM paths "
        f"{launches}; phase {res['seconds']:.1f} s (jamba "
        f"{res[SSM_ARCHS[0]]['seconds']:.1f}, xLSTM "
        f"{res[SSM_ARCHS[1]]['seconds']:.1f})")
    return res


ENCDEC_ARCH, VLM_ARCH = "whisper-small", "qwen2-vl-72b"
ED_STEP_B, ED_STEP_S = 1, 64      # (a) whisper: 1 x 64 tokens, 1 x 1,500 frames
# (a)'s float32 step, card against the CPU, at the first 2 + 2 layers of
# the 12 + 12 (the CPU's step of the whole model took ~27 s)
ED_STEP_LAYERS = 2
ED_TRAIN_B = 8                    # (b) whisper: 8 x max_seq_len tokens
ED_DECODE_B32, ED_DECODE_N32 = 2, 9   # (c) the first token, then 8 more
# (c) float32: decode's first token against the prefill's position-0
# logits, and every decoded token card against CPU, within 1e-5 x the
# largest |logit|; the VLM's text-only decode against prefill too
F32_DECODE_TOL = 1e-5
VLM_CUT_LAYERS = 2
VLM_STEP_B, VLM_STEP_S, VLM_STEP_PATCHES = 2, 32, 16   # (a): a 4 x 4 grid
VLM_PREFILL_B, VLM_GRAD_B, VLM_S = 8, 4, 512   # (b) prefill; value_and_grad
VLM_DECODE_CTX = 512              # (d)
VLM_PREFILL32 = 32                # (c) text-only prompt, batch SSM_DECODE_B32
VLM_TIMED = 3                     # (b) timed calls after one warm call


def _grid_positions(b, s, npatch, dev):
    """M-RoPE ids (b, s, 3): patch i at (0, i // side, i % side) of a
    side x side grid (side = ceil(sqrt(npatch))), then the text at
    (p, p, p) from p = side, as Qwen2-VL numbers one image then text."""
    import math
    import torch
    side = math.isqrt(max(npatch - 1, 0)) + 1
    pos = torch.zeros((s, 3), dtype=torch.int32)
    i = torch.arange(npatch)
    pos[:npatch, 1], pos[:npatch, 2] = i // side, i % side
    pos[npatch:] = (side + torch.arange(s - npatch))[:, None].to(torch.int32)
    return pos.expand(b, s, 3).contiguous().to(dev)


def _grads(cfg, params, batch):
    """Float32 loss and gradients of cfg at ``batch`` (tensors on the
    params' device) and the seconds they took."""
    import torch
    from repro_torch.models import api
    from repro_torch.train.step import value_and_grad
    from repro_torch.tree import tree_leaves

    d = tree_leaves(params)[0].device
    t0 = time.perf_counter()
    (loss, _), grads = value_and_grad(
        lambda p, b: api.loss_fn(cfg, p, b), params,
        {k: v.to(d) for k, v in batch.items()})
    loss = float(loss)
    if d.type == "cuda":
        torch.cuda.synchronize(d)
    return dict(loss=loss, grads=grads, s=time.perf_counter() - t0)


def _grads_compare(cfg, card, cpu, where):
    """(a)'s verdict on float32 gradients alone: the loss to rtol
    LM_LOSS_RTOL, each leaf to rtol LM_GRAD_RTOL / atol LM_GRAD_ATOL_REL
    x its largest element, compared on ``where``."""
    require(abs(card["loss"] - cpu["loss"]) <= LM_LOSS_RTOL * abs(cpu["loss"]),
            f"lm {cfg.name} loss: card {card['loss']!r} cpu {cpu['loss']!r}")
    gerr, n = 0.0, 0
    for (path, g), (_, gc) in zip(_paths(card["grads"]), _paths(cpu["grads"])):
        g, gc = g.to(where), gc.to(where)
        scale = float(gc.abs().max())
        gerr = max(gerr, _close(g, gc, LM_GRAD_RTOL, LM_GRAD_ATOL_REL * scale,
                                f"lm {cfg.name} gradient {path}")
                   / max(scale, 1e-30))
        n += 1
    return gerr, n


def _encdec_decode_check(cfg32, p32, host_p, dev, frames, toks):
    """(c) float32 on the card and on the CPU: encode ``frames``, project
    the cross K/V once (prefill_cross), decode ``toks`` teacher-forced
    from there; the first token against the decoder forward's position-0
    logits on each device, every token card against CPU.  Returns the
    errors and the largest |logit|; the later positions' distance from
    the forward is reported (decode adds position 0's sinusoid at every
    step, as the reference's does)."""
    import torch
    from repro_torch.models import api, encdec
    from repro_torch.models.layers.common import zeros_from_spec

    out = {}
    for where, p in ((dev, p32), (torch.device("cpu"), host_p)):
        f, t = frames.to(where), toks.to(where)
        with torch.no_grad():
            enc = encdec.encode(cfg32, p, f)
            pre = encdec.prefill_logits(cfg32, p, t, enc)
            state = zeros_from_spec(api.decode_state_spec(
                cfg32, t.shape[0], ED_STEP_S), device=where)
            state["cross"] = encdec.prefill_cross(cfg32, p, enc)
            logits = []
            for i in range(t.shape[1]):
                lg, state = api.decode_step(cfg32, p, state, t[:, i:i + 1])
                logits.append(lg)
        out[where.type] = (pre.to(dev), torch.stack(logits, 1).to(dev))
    (pre, dec), (pre_c, dec_c) = out["cuda" if dev.type == "cuda" else
                                     "cpu"], out["cpu"]
    scale = float(pre.abs().max())
    first = max(float((dec[:, 0] - pre[:, 0]).abs().max()),
                float((dec_c[:, 0] - pre_c[:, 0]).abs().max()))
    cross_dev = float((dec - dec_c).abs().max())
    later = float((dec[:, 1:] - pre[:, 1:]).abs().max())
    require(bool(torch.isfinite(dec).all())
            and first <= F32_DECODE_TOL * scale
            and cross_dev <= F32_DECODE_TOL * scale,
            f"lm {cfg32.name} float32 decode: first token {first:.4e} from "
            f"prefill, card against CPU {cross_dev:.4e}, beyond "
            f"{F32_DECODE_TOL} x {scale:.4f}")
    return dict(first_err=first, card_cpu_err=cross_dev, later_err=later,
                scale=scale)


def _whisper(dev, card, tcfg, pool, cpu_pool):
    """whisper-small whole (12 + 12 layers at full width): (a) a float32
    make_train_step step on the card against the CPU at ED_STEP_B x
    ED_STEP_S tokens and the encoder's frames, the first ED_STEP_LAYERS
    layers of each stack, the CPU's step beside (c); (c) float32 decode
    from prefill_cross(encode(frames)); (b) bf16 steps at ED_TRAIN_B x
    max_seq_len with a profiled one; (d) bf16
    decode at batch LM_DECODE_B, context max_seq_len, against the
    encoded frames' cross K/V; launch.serve --mode lm beside (a)."""
    import dataclasses
    import math
    import numpy as np
    import torch
    from repro_torch.config import get_config
    from repro_torch.data import lm_batch_fn
    from repro_torch.models import api, encdec
    from repro_torch.models.layers.common import dtype_of
    from repro_torch.tree import tree_leaves, tree_map

    full = get_config(ENCDEC_ARCH, reduced=LM_REDUCED)
    red = ["--reduced"] if LM_REDUCED else []
    running = {"launch.serve --mode lm": pool.submit(_lm_cli, [
        "-m", "repro_torch.launch.serve", "--mode", "lm", "--arch",
        ENCDEC_ARCH, "--device", dev.type] + red)}
    e = full.encoder
    f32 = dataclasses.replace(full, dtype="float32")
    p32, n, draw_s = _draw(f32, dev)
    r = {"params": n}
    log(f"lm {ENCDEC_ARCH}: encoder {e.num_layers} + decoder "
        f"{full.num_layers} layers, d {full.d_model}, "
        f"{full.attention.num_heads} x {full.attention.head_dim} heads, ff "
        f"{full.d_ff}, vocab {full.vocab_size}, {e.seq_len} frames x "
        f"{e.feature_dim}; {n / 1e6:.1f}M params drawn on the card in "
        f"{draw_s:.1f} s (no cut)")
    host_p = tree_map(lambda a: a.to("cpu"), p32)
    rng = np.random.default_rng(0)
    batch_np = lm_batch_fn(full.vocab_size, ED_STEP_B, ED_STEP_S, seed=0)(0)
    batch_np["frames"] = rng.standard_normal(
        (ED_STEP_B, e.seq_len, e.feature_dim), dtype=np.float32)
    a_cfg = dataclasses.replace(f32, num_layers=ED_STEP_LAYERS,
                                encoder=dataclasses.replace(
                                    e, num_layers=ED_STEP_LAYERS))
    a_p = dict(p32, **{k: tree_map(lambda a: a[:ED_STEP_LAYERS], p32[k])
                       for k in ("enc_blocks", "dec_blocks")})
    cpu_fut = cpu_pool.submit(_lm_step, a_cfg, tcfg, tree_map(
        lambda a: a.to("cpu"), a_p), batch_np)
    on_card = _lm_step(a_cfg, tcfg, a_p, batch_np)
    frames = torch.as_tensor(rng.standard_normal(
        (ED_DECODE_B32, e.seq_len, e.feature_dim), dtype=np.float32))
    toks = torch.as_tensor(lm_batch_fn(full.vocab_size, ED_DECODE_B32,
                                       ED_DECODE_N32, seed=1)(0)["tokens"])
    r["decode32"] = _encdec_decode_check(f32, p32, host_p, dev, frames, toks)
    r["step"] = _lm_step_compare(a_cfg, tcfg, on_card, cpu_fut.result(),
                                 batch_np, dev)
    d32 = r["decode32"]
    log(f"lm (c) {ENCDEC_ARCH} float32 decode from prefill_cross(encode("
        f"frames)), batch {ED_DECODE_B32}, {ED_DECODE_N32} tokens: the first "
        f"token within {d32['first_err']:.4e} of the decoder forward's "
        f"position-0 logits, every token card against CPU within "
        f"{d32['card_cpu_err']:.4e} (max |logit| {d32['scale']:.4f}, "
        f"tolerance {F32_DECODE_TOL} x it); positions 1-"
        f"{ED_DECODE_N32 - 1} {d32['later_err']:.4e} from the forward "
        "(decode adds position 0's sinusoid at every step, as the "
        "reference's)")
    pb = tree_map(lambda a, sp: a.to(sp.dtype), p32, api.param_spec(full))
    del on_card, cpu_fut, host_p, p32, a_p
    torch.cuda.empty_cache()
    _cli_results(ENCDEC_ARCH, running, r, 0)
    tok_make = lm_batch_fn(full.vocab_size, ED_TRAIN_B, full.max_seq_len,
                           seed=0)

    def make(step):
        b = tok_make(step)
        b["frames"] = np.random.default_rng(100 + step).standard_normal(
            (ED_TRAIN_B, e.seq_len, e.feature_dim), dtype=np.float32)
        return b

    r["train"] = _lm_train_steps(full, dev, tcfg, pb, make=make)
    torch.cuda.empty_cache()
    with torch.no_grad():
        enc = encdec.encode(full, pb, torch.as_tensor(
            rng.standard_normal((LM_DECODE_B, e.seq_len, e.feature_dim),
                                dtype=np.float32), device=dev))
        cross = encdec.prefill_cross(full, pb, enc)
    del enc
    r["decode"] = _ssm_decode_time(full, dev, pb, ctx=full.max_seq_len,
                                   cross=cross)
    spec = api.decode_state_spec(full, 1, 1)
    a = full.attention
    self_b = 2 * a.num_kv_heads * a.head_dim * dtype_of(full.dtype).itemsize
    cross_b = sum(math.prod(s.shape) * s.dtype.itemsize
                  for s in tree_leaves(spec["cross"]))
    # the decoder's weights but its cross wk / wv (the cross K/V are
    # projected once), the head, then each sequence's caches
    dec = dict(pb["dec_blocks"], cross={
        k: w for k, w in pb["dec_blocks"]["cross"].items()
        if k in ("wq", "wo")})
    nbytes = (sum(t.numel() * t.element_size() for t in tree_leaves(
        [dec, pb["lm_head"], pb["final_norm"]]))
              + LM_DECODE_B * (cross_b + full.max_seq_len * full.num_layers
                               * self_b))
    bound = nbytes / PEAK_BYTES_S * 1e3
    r["decode"].update(self_bytes_token_layer=self_b,
                       cross_bytes_seq=cross_b, bound_ms=bound)
    del pb, cross
    torch.cuda.empty_cache()
    log(f"lm (d) {ENCDEC_ARCH} bf16 decode at batch {LM_DECODE_B}, context "
        f"{full.max_seq_len}, against the encoded frames' cross K/V: "
        f"{r['decode']['ms_per_token']:.3f} ms/token, "
        f"{r['decode']['tok_s']:.0f} tok/s; bytes read per token (decoder "
        f"and head weights, cross and self caches) {nbytes / 1e9:.3f} GB, "
        f">= {bound:.3f} ms at {PEAK_BYTES_S / 1e12:.2f} TB/s; cache: self "
        f"K/V {self_b} B per token and layer, cross K/V {cross_b} B per "
        f"sequence ({full.num_layers} layers); launch.serve --mode lm exit "
        f"0 ({r['cli']['launch.serve --mode lm']:.1f} s, beside (a))")
    return r


def _vlm(dev, card, tcfg, pool, cpu_pool):
    """qwen2-vl-72b at full width, cut to VLM_CUT_LAYERS: (a) float32
    loss and gradients on the card against the CPU at VLM_STEP_B x
    VLM_STEP_S tokens, the first VLM_STEP_PATCHES patch embeddings on a
    grid, the CPU's gradients beside (c); (c) float32 decode against
    prefill on a text-only prompt; (b) bf16 prefill at VLM_PREFILL_B x
    VLM_S with the published patches, and bf16 value_and_grad at
    VLM_GRAD_B x VLM_S, profiled; (d) bf16 decode at batch LM_DECODE_B,
    context VLM_DECODE_CTX; launch.serve --mode lm beside (a)."""
    import dataclasses
    import torch
    from torch.profiler import ProfilerActivity, profile
    from repro_torch.config import VisionStubConfig, get_config
    from repro_torch.data import lm_batch_fn
    from repro_torch.models import api, lm
    from repro_torch.models.layers.common import zeros_from_spec
    from repro_torch.train.step import value_and_grad
    from repro_torch.tree import tree_leaves, tree_map

    full = get_config(VLM_ARCH, reduced=LM_REDUCED)
    red = ["--reduced"] if LM_REDUCED else []
    running = {"launch.serve --mode lm": pool.submit(_lm_cli, [
        "-m", "repro_torch.launch.serve", "--mode", "lm", "--arch",
        VLM_ARCH, "--device", dev.type] + red)}
    cut = dataclasses.replace(full, num_layers=VLM_CUT_LAYERS)
    v = cut.vision
    npatch_a = min(VLM_STEP_PATCHES, VLM_STEP_S // 2)
    cut32 = dataclasses.replace(cut, dtype="float32", vision=(
        VisionStubConfig(num_patches=npatch_a, patch_dim=v.patch_dim)))
    p32, n, draw_s = _draw(cut32, dev)
    r = {"params": n}
    log(f"lm {VLM_ARCH}: {cut.num_layers} of {full.num_layers} layers at "
        f"full width (d {cut.d_model}, {cut.attention.num_heads} heads / "
        f"{cut.attention.num_kv_heads} KV x {cut.attention.head_dim}, "
        f"M-RoPE sections {cut.attention.mrope_sections}, ff {cut.d_ff}, "
        f"vocab {cut.vocab_size}, patches {v.num_patches} x {v.patch_dim}); "
        f"{n / 1e9:.3f}B params drawn on the card in {draw_s:.1f} s")
    host_p = tree_map(lambda a: a.to("cpu"), p32)
    g = torch.Generator().manual_seed(0)
    b_np = lm_batch_fn(cut.vocab_size, VLM_STEP_B, VLM_STEP_S, seed=0)(0)
    batch = {k: torch.as_tensor(x) for k, x in b_np.items()}
    batch["patch_embeds"] = torch.randn(
        (VLM_STEP_B, npatch_a, v.patch_dim), generator=g) * 0.1
    batch["positions"] = _grid_positions(VLM_STEP_B, VLM_STEP_S, npatch_a,
                                         "cpu")
    cpu_fut = cpu_pool.submit(_grads, cut32, host_p, batch)
    on_card = _grads(cut32, p32, batch)
    # (c) float32: a text-only prompt, decode against prefill
    prompt = torch.as_tensor(lm_batch_fn(
        cut.vocab_size, SSM_DECODE_B32, VLM_PREFILL32, seed=1)(0)["tokens"],
        device=dev)
    with torch.no_grad():
        pre = lm.prefill_logits(cut32, p32, prompt)
        state = zeros_from_spec(api.decode_state_spec(
            cut32, SSM_DECODE_B32, VLM_PREFILL32), device=dev)
        err = 0.0
        for i in range(VLM_PREFILL32):
            logits, state = api.decode_step(cut32, p32, state,
                                            prompt[:, i:i + 1])
            err = max(err, float((logits - pre[:, i]).abs().max()))
    scale = float(pre.abs().max())
    require(bool(torch.isfinite(pre).all())
            and err <= F32_DECODE_TOL * scale,
            f"lm {VLM_ARCH} float32 text-only decode differs from prefill "
            f"by {err:.4e} > {F32_DECODE_TOL} x {scale:.4f}")
    r["decode32"] = (err, scale)
    del pre
    cpu = cpu_fut.result()
    r["grad_err"], leaves = _grads_compare(cut32, on_card, cpu, dev)
    log(f"lm (a) {VLM_ARCH} x{cut.num_layers} layers float32, batch "
        f"{VLM_STEP_B} x seq {VLM_STEP_S} of which {npatch_a} patch "
        f"embeddings at (0, r, c) of a grid, the text after at (p, p, p): "
        f"loss card {on_card['loss']:.7f} cpu {cpu['loss']:.7f} "
        f"(value_and_grad card {on_card['s']:.3f} s, cpu {cpu['s']:.3f} s); "
        f"{leaves} gradient leaves within rtol {LM_GRAD_RTOL} / atol "
        f"{LM_GRAD_ATOL_REL} x max|leaf| (max err {r['grad_err']:.3e} x "
        f"max|leaf|)")
    log(f"lm (c) {VLM_ARCH} float32 decode of a text-only prompt (M-RoPE t "
        f"= h = w), {VLM_PREFILL32} tokens at batch {SSM_DECODE_B32}: within "
        f"{err:.4e} of prefill (max |logit| {scale:.4f}, tolerance "
        f"{F32_DECODE_TOL} x it)")
    r["loss_card"], r["loss_cpu"] = on_card["loss"], cpu["loss"]
    pb = tree_map(lambda a, sp: a.to(sp.dtype), p32, api.param_spec(cut))
    del on_card, cpu, cpu_fut, host_p, p32
    torch.cuda.empty_cache()
    _cli_results(VLM_ARCH, running, r, 0)

    def inputs(bsz, seed):
        b = {k: torch.as_tensor(x, device=dev) for k, x in lm_batch_fn(
            cut.vocab_size, bsz, VLM_S, seed=seed)(0).items()}
        b["patch_embeds"] = (torch.randn(
            (bsz, v.num_patches, v.patch_dim),
            generator=torch.Generator().manual_seed(seed)) * 0.1).to(
            device=dev, dtype=torch.bfloat16)
        b["positions"] = _grid_positions(bsz, VLM_S, v.num_patches, dev)
        return b

    def timed(fn):
        fn()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for _ in range(VLM_TIMED):
            out = fn()
        torch.cuda.synchronize()
        return (time.perf_counter() - t0) / VLM_TIMED * 1e3, out

    pf = inputs(VLM_PREFILL_B, 2)
    with torch.no_grad():
        r["prefill_ms"], logits = timed(lambda: lm.prefill_logits(
            cut, pb, pf["tokens"], patch_embeds=pf["patch_embeds"],
            positions=pf["positions"]))
    require(tuple(logits.shape) == (VLM_PREFILL_B, VLM_S, cut.vocab_size)
            and bool(torch.isfinite(logits).all()),
            f"lm {VLM_ARCH} bf16 prefill logits {tuple(logits.shape)}")
    del logits, pf
    torch.cuda.empty_cache()
    gb = inputs(VLM_GRAD_B, 3)
    torch.cuda.reset_peak_memory_stats(dev)

    def grad_call():
        (loss, _), gr = value_and_grad(lambda p, b: api.loss_fn(cut, p, b),
                                       pb, gb)
        return loss, gr

    r["grad_ms"], (loss, gr) = timed(grad_call)
    del gr
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        tp = time.perf_counter()
        loss, gr = grad_call()
        torch.cuda.synchronize()
        wall = (time.perf_counter() - tp) * 1e3
    del gr
    peak = torch.cuda.max_memory_allocated(dev) / 2 ** 30
    by_kernel = sorted(((ev.self_device_time_total, ev.key)
                        for ev in prof.key_averages()
                        if ev.self_device_time_total > 0), reverse=True)
    busy = sum(u for u, _ in by_kernel) / 1e3
    require(bool(torch.isfinite(loss)), f"lm {VLM_ARCH} bf16 loss {loss}")
    r.update(prefill_tok_s=VLM_PREFILL_B * VLM_S / r["prefill_ms"] * 1e3,
             grad_tok_s=VLM_GRAD_B * VLM_S / r["grad_ms"] * 1e3,
             grad_busy_share=busy / wall, grad_peak_gib=peak,
             grad_wall_ms=wall, grad_busy_ms=busy, bf16_loss=float(loss))
    del gb
    torch.cuda.empty_cache()
    log(f"lm (b) {VLM_ARCH} x{cut.num_layers} layers bf16 with "
        f"{v.num_patches} patches (a {round(v.num_patches ** 0.5)}-wide "
        f"grid at t = 0, then text): prefill at {VLM_PREFILL_B} x {VLM_S} "
        f"{r['prefill_ms']:.3f} ms ({r['prefill_tok_s']:.0f} tokens/s); "
        f"value_and_grad at {VLM_GRAD_B} x {VLM_S} {r['grad_ms']:.3f} ms "
        f"({r['grad_tok_s']:.0f} tokens/s), loss {float(loss):.4f}, peak "
        f"{peak:.3f} GiB; profiled call {wall:.3f} ms wall, device busy "
        f"{busy:.3f} ms = {busy / wall:.4f} of it; device ms by kernel: "
        + ", ".join(f"{k[:40]} {u / 1e3:.3f}" for u, k in by_kernel[:6]))
    r["decode"] = _ssm_decode_time(cut, dev, pb, ctx=VLM_DECODE_CTX)
    wbytes = sum(t.numel() * t.element_size() for t in tree_leaves(
        [sub for k, sub in pb.items() if k not in ("embed", "vision_proj")]))
    kv = LM_DECODE_B * r["decode"]["state_bytes_per_seq"]["attn"] \
        * cut.num_layers
    r["decode"].update(weight_bytes=wbytes, cache_bytes=kv,
                       bound_ms=(wbytes + kv) / PEAK_BYTES_S * 1e3)
    del pb
    torch.cuda.empty_cache()
    log(f"lm (d) {VLM_ARCH} x{cut.num_layers} layers bf16 decode at batch "
        f"{LM_DECODE_B}, context {VLM_DECODE_CTX}: "
        f"{r['decode']['ms_per_token']:.3f} ms/token, "
        f"{r['decode']['tok_s']:.0f} tok/s; reads {wbytes / 1e9:.3f} GB of "
        f"weights (layers and head; the embedding is a gather) and "
        f"{kv / 1e9:.3f} GB of K/V a token, >= "
        f"{r['decode']['bound_ms']:.3f} ms at {PEAK_BYTES_S / 1e12:.2f} "
        f"TB/s; launch.serve --mode lm exit 0 "
        f"({r['cli']['launch.serve --mode lm']:.1f} s, beside (a))")
    return r


MESH_ARCH_STEPS = 10       # (a): lm-100m at 1x1 against the plain step
MESH_SHARED_STEPS = 3      # (b): 2x1 and 1x2, two ranks on one card
MESH_MOE_STEPS = 3         # (d): reduced qwen2-moe-a2.7b, 2x1 vs 1x1
MESH_SPLIT_STEPS = 3       # (f): the MoE cuts at 1x1 and 1x2; (g) too
# (f): a token routed otherwise at 1x2 than at 1x1 is a tie of the split's
# rounding when its k-th and (k+1)-th routing probabilities lie within
# this of each other at 1x1: the split moves a step-0 probability by at
# most 1.6e-6 of the largest (probes/mesh_split_diff.py), a few 1e-7
MESH_TIE_GAP = 1e-6
MESH_LOSS_RTOL = 1e-5      # tests/test_torch_lm_train.py's STEP
MESH_BF16_STEPS = 3        # (b'): the config's bfloat16 at 2x1 vs 1x1
MESH_BF16_RTOL = 2.0 ** -8  # one bfloat16 ulp: a 2x1 gradient rounds twice
# (b'') 1x2 splits the model axis: a row-split product's output is two
# bfloat16 parts summed in float32 and rounded again, where one process
# rounds the whole product once; each loss, a float32 mean of the CE
# over LM_B x LM_S tokens, is held within one bfloat16 ulp of 1x1's
MESH_BF16_SPLIT_RTOL = 2.0 ** -8
MESH_TIMEOUT = 600
MESH_PSUM_SHAPES = ((768, 3072), (32000,), (7, 5))


def _mesh_launch(arch, shape, steps, reduced, device, dtype="float32",
                 cfg=None):
    """launch.train's LM branch at ``--mesh-shape shape`` on the arch's
    config in ``dtype`` (float32: the step tests' arithmetic), or on
    ``cfg`` (a cut of it) when given."""
    import dataclasses
    from repro_torch.config import get_config
    from repro_torch.launch import train as launch_train
    args = launch_train.parse_args(
        ["--arch", arch, "--mesh-shape", shape, "--steps", str(steps),
         "--log-every", "0", "--device", device, "--global-batch",
         str(LM_B), "--seq-len", str(LM_S)]
        + (["--reduced"] if reduced else []))
    if cfg is None:
        cfg = dataclasses.replace(get_config(arch, reduced=reduced),
                                  dtype=dtype)
    return launch_train.train_lm_arch(args, cfg)


class _Routing:
    """Within it every MoE routing call (``moe._top_k`` over a layer's
    routing probabilities: forward and recompute, in order) is recorded:
    the experts it picks per token and the gap between the k-th and the
    (k+1)-th probability.  ``replay``: another run's record, whose picks
    the calls take instead, call by call (the gates are still this run's
    probabilities at those experts).  The dense dispatch calls
    ``_top_k`` only to route."""

    def __init__(self, replay=None):
        self.idx, self.gap, self.replay = [], [], replay

    def __enter__(self):
        import torch
        from repro_torch.models.layers import moe
        self.real = real = moe._top_k

        def top_k(x, k):
            vals, idx = real(x, k)
            srt = torch.sort(x.detach(), dim=-1, descending=True).values
            self.gap.append((srt[:, k - 1] - srt[:, k]).cpu().numpy())
            self.idx.append(idx.cpu().numpy())
            if self.replay is not None:
                idx = torch.as_tensor(self.replay[len(self.idx) - 1],
                                      device=x.device)
                vals = torch.gather(x, -1, idx)
            return vals, idx
        moe._top_k = top_k
        return self

    def __exit__(self, *exc):
        from repro_torch.models.layers import moe
        moe._top_k = self.real

    def save(self, path):
        import numpy as np
        np.savez(path, **{f"idx{i}": a for i, a in enumerate(self.idx)},
                 **{f"gap{i}": a for i, a in enumerate(self.gap)})

    @staticmethod
    def load(path):
        import numpy as np
        with np.load(path) as f:
            n = sum(k.startswith("idx") for k in f.files)
            return ([f[f"idx{i}"] for i in range(n)],
                    [f[f"gap{i}"] for i in range(n)])


class _DrawnOnce:
    """Within it ``api.init_params`` draws each (config, seed) of a host
    generator once in this process and hands every call a copy of those
    values on its device: (f)'s plain step, launch.train and a replay
    take the same params, and a 2B-param cut's host draw takes ~15 s."""

    def __enter__(self):
        from repro_torch.models import api
        from repro_torch.tree import tree_map
        self.real = real = api.init_params
        cache = {}

        def init(cfg, generator, *, device=None):
            if generator.device.type != "cpu":
                return real(cfg, generator, device=device)
            key = (cfg, generator.initial_seed())
            if key not in cache:
                cache[key] = real(cfg, generator)
            return tree_map(lambda t: t.to(device, copy=True), cache[key])
        api.init_params = init
        return self

    def __exit__(self, *exc):
        from repro_torch.models import api
        api.init_params = self.real


def _mesh_moe_cut(arch, reduced):
    """(f)'s config: ``arch`` at its published widths cut to
    MOE_CUT_LAYERS layers as phase_moe_lm cuts it (deepseek: its dense
    prefix layer and one MLA + MoE layer), float32, the dense dispatch
    (the reduced config on a rehearsal)."""
    import dataclasses
    from repro_torch.config import get_config
    return dataclasses.replace(get_config(arch, reduced=reduced),
                               num_layers=MOE_CUT_LAYERS, dtype="float32",
                               moe_dispatch="dense")


def _mesh_psum_inputs(rank):
    """Per rank: float32 leaves at the lm-100m layer's shapes, a wide
    range, and an all-zero one (drawn on the host from the rank)."""
    import numpy as np
    rng = np.random.default_rng(100 + rank)
    out = {}
    for i, shp in enumerate(MESH_PSUM_SHAPES):
        v = rng.normal(0, 1 + rank, shp) * 10.0 ** rng.integers(-3, 3, shp)
        out[f"g{i}"] = v.astype(np.float32)
    out["zero"] = np.zeros((3, 4), np.float32)
    return out


def _mesh_worker(rank, world, init, out_dir, reduced, device, only):
    """One of the ranks sharing the card: (b)-(d) (``_mesh_worker_dense``),
    (f) the MoE cuts at 1x2 and (g) the jamba and whisper cuts at 1x2,
    each with one more 1x2 step's FLOPs, and (h) every decode cut at
    1x2 with one more step's FLOPs; ``only`` "f", "g" or "h": that
    check alone.  Writes its results to ``out_dir``.  ``device`` "cpu"
    rehearses it on the host."""
    sys.path.insert(0, str(SRC))
    import torch
    import torch.distributed as dist
    dev = torch.device(device)
    if dev.type == "cuda":
        torch.cuda.set_device(0)
    dist.init_process_group("gloo", init_method=init, world_size=world,
                            rank=rank)
    res = {}
    try:
        if only is None:
            _mesh_worker_dense(rank, world, out_dir, reduced, dev, res)
        cuts = {}
        if only in (None, "f"):
            cuts.update((a, _mesh_moe_cut(a, reduced)) for a in MOE_ARCHS)
        if only in (None, "g"):
            cuts.update(_mesh_g_cuts(reduced))
        h_cuts = _mesh_h_cuts(reduced) if only in (None, "h") else {}
        for arch in list(cuts) + [a for a in h_cuts if a not in cuts]:
            res[arch] = {}
            # (h) on the draw of (f)'s or (g)'s cut
            with _DrawnOnce():
                if arch in cuts:
                    cut = cuts[arch]
                    if arch in MOE_ARCHS:
                        res[arch] = _mesh_split_rank(arch, cut, reduced,
                                                     dev, out_dir, rank)
                    else:
                        res[arch] = _mesh_g_run(arch, cut, reduced, dev,
                                                "1x2")
                    res[arch]["flops"] = _mesh_step_flops(cut, dev)
                if arch in h_cuts:
                    res[arch]["h"] = _mesh_h_rank(arch, h_cuts[arch], dev,
                                                  out_dir)
                    res[arch]["h_flops"] = _mesh_h_flops(h_cuts[arch], dev)
            if dev.type == "cuda":
                torch.cuda.empty_cache()
        res["k_launches"] = _k_launches()
    finally:
        dist.destroy_process_group()
    with open(os.path.join(out_dir, f"rank{rank}.json"), "w") as f:
        json.dump(res, f)


def _mesh_split_rank(arch, cut, reduced, dev, out_dir, rank):
    """(f) on one rank: launch.train at 1x2 with its routing recorded
    and, where a token routes otherwise than at 1x1, the same steps
    again replaying 1x1's routing."""
    base = _allocated(dev)
    with _Routing() as route:
        out = _mesh_launch(arch, "1x2", MESH_SPLIT_STEPS, reduced,
                           dev.type, cfg=cut)
    route.save(os.path.join(out_dir, f"route_{arch}_{rank}.npz"))
    res = {"losses": out["losses"], "rank": out["rank"], "base": base}
    del out
    one, _ = _Routing.load(os.path.join(out_dir, f"route_{arch}.npz"))
    if len(one) != len(route.idx) or any(
            (a != b).any() for a, b in zip(one, route.idx)):
        with _Routing(replay=one):
            out = _mesh_launch(arch, "1x2", MESH_SPLIT_STEPS, reduced,
                               dev.type, cfg=cut)
        res["replayed"] = out["losses"]
    return res


def _mesh_worker_dense(rank, world, out_dir, reduced, dev, res):
    """(b) launch.train at 2x1 and 1x2 (float32 and bfloat16) and (e)'s
    1x2 step's FLOPs, (c) psum_int8 on the device's tensors, (d) the
    reduced MoE LM at 2x1, on one rank (its process group open)."""
    import numpy as np
    import torch
    from repro_torch.launch.mesh import make_host_mesh
    from repro_torch.optim import psum_int8
    from repro_torch.sharding import ctx
    for shape in ("2x1", "1x2"):
        base = _allocated(dev)
        out = _mesh_launch(LM_ARCH, shape, MESH_SHARED_STEPS, reduced,
                           dev.type)
        res[shape] = {"losses": out["losses"], "rank": out["rank"],
                      "backend": out["backend"], "base": base}
        del out
    for shape, key in (("2x1", "bf16"), ("1x2", "bf16_1x2")):
        out = _mesh_launch(LM_ARCH, shape, MESH_BF16_STEPS, reduced,
                           dev.type, "bfloat16")
        res[key] = {"losses": out["losses"], "rank": out["rank"]}
        del out
    res["flops_1x2"] = _mesh_step_flops(_mesh_lm_cfg(reduced), dev)
    mesh = make_host_mesh((world, 1), device=dev)
    leaves = {k: torch.as_tensor(v).to(dev)
              for k, v in _mesh_psum_inputs(rank).items()}
    with ctx.active_mesh(mesh):
        summed = psum_int8(leaves, "data")
    np.savez(os.path.join(out_dir, f"psum{rank}.npz"),
             **{k: v.cpu().numpy() for k, v in summed.items()})
    res["psum_device"] = str(summed["g0"].device)
    out = _mesh_launch(MOE_ARCHS[0], "2x1", MESH_MOE_STEPS, True, dev.type)
    res["moe"] = {"losses": out["losses"], "rank": out["rank"]}


def _allocated(dev):
    import torch
    if dev.type != "cuda":
        return 0
    torch.cuda.synchronize(dev)
    return torch.cuda.memory_allocated(dev)


def _mesh_lm_cfg(reduced):
    import dataclasses
    from repro_torch.config import get_config
    return dataclasses.replace(get_config(LM_ARCH, reduced=reduced),
                               dtype="float32")


def _mesh_step_flops(cfg, dev):
    """FlopCounterMode's count of one training step of ``cfg`` over the
    open group as a 1 x 2 mesh (after a warm step), at the dry run's
    settings: ``make_mesh_train_step`` on the dry run's param tree (an
    MoE's experts padded to the model axis, 2) drawn from seed 0 on the
    device (the count does not depend on the values), the batch of
    ``api.make_batch``."""
    import torch
    from torch.utils.flop_counter import FlopCounterMode
    from repro_torch.config import ShapeConfig, TrainConfig
    from repro_torch.launch.mesh import make_host_mesh
    from repro_torch.models import api
    from repro_torch.models.layers.common import init_from_spec
    from repro_torch.optim import adamw_init
    from repro_torch.sharding.spmd import (local_batch, make_mesh_train_step,
                                           param_shardings, shard_tree)
    tcfg = TrainConfig(lr=3e-4, sgdr_t0=50)
    shape = ShapeConfig("train", "train", LM_S, LM_B)
    mesh = make_host_mesh((1, 2), device=dev)
    params = init_from_spec(api.param_spec(cfg, model_axis=2),
                            torch.Generator(device=dev).manual_seed(0),
                            device=dev)
    psh = param_shardings(cfg, params, mesh)
    params = shard_tree(params, psh)
    batch = local_batch(api.make_batch(cfg, shape,
                                       torch.Generator().manual_seed(0),
                                       device=dev), mesh, cfg, shape)
    step = make_mesh_train_step(cfg, tcfg, mesh, psh, shape)
    args = (params, adamw_init(params), batch)
    del params
    out = step(*args)
    del out
    with FlopCounterMode(display=False) as fc:
        out = step(*args)
        _allocated(dev)
    return int(fc.get_total_flops())


def _k_launches():
    from repro_torch.kernels.lut_cascade import lut_cascade
    from repro_torch.kernels.lut_gather import lut_layer, lut_lookup
    from repro_torch.kernels.neuralut_grad import (subnet_train_bwd,
                                                   subnet_train_fwd)
    from repro_torch.kernels.neuralut_mlp import grouped_subnet
    return {fn.__name__: fn.launches for fn in (
        lut_cascade, lut_layer, lut_lookup, subnet_train_fwd,
        subnet_train_bwd, grouped_subnet)}


def _k_reset():
    from repro_torch.kernels.lut_cascade import lut_cascade
    from repro_torch.kernels.lut_gather import lut_layer, lut_lookup
    from repro_torch.kernels.neuralut_grad import (subnet_train_bwd,
                                                   subnet_train_fwd)
    from repro_torch.kernels.neuralut_mlp import grouped_subnet
    for fn in (lut_cascade, lut_layer, lut_lookup, subnet_train_fwd,
               subnet_train_bwd, grouped_subnet):
        fn.launches = 0


def _mesh_batch(cfg, s, dev):
    """Step ``s``'s global batch of LM_B x LM_S at the launcher's seed:
    ``lm_batch_fn``'s (launch.train's), or an encoder-decoder's frames,
    tokens and labels from ``api.make_batch`` (seed s), which
    launch.train does not take."""
    import torch
    from repro_torch.config import ShapeConfig, TrainConfig
    from repro_torch.data import lm_batch_fn
    from repro_torch.models import api
    if cfg.encoder is not None:
        return api.make_batch(cfg, ShapeConfig("train", "train", LM_S, LM_B),
                              torch.Generator().manual_seed(s), device=dev)
    make = lm_batch_fn(cfg.vocab_size, LM_B, LM_S, seed=TrainConfig().seed)
    return {k: torch.as_tensor(v).to(dev) for k, v in make(s).items()}


def _mesh_plain_losses(cfg, dev, steps):
    """The plain step (train.step.make_train_step, no process group) at
    the launcher's settings on ``_mesh_batch``'s batches: its losses."""
    import torch
    from repro_torch.config import TrainConfig
    from repro_torch.models import api
    from repro_torch.optim import adamw_init
    from repro_torch.train.step import make_train_step
    tcfg = TrainConfig(lr=3e-4, sgdr_t0=max(50, steps // 4))
    params = api.init_params(cfg, torch.Generator().manual_seed(tcfg.seed),
                             device=dev)
    opt = adamw_init(params)
    step = make_train_step(cfg, tcfg)
    losses = []
    for s in range(steps):
        params, opt, m = step(params, opt, _mesh_batch(cfg, s, dev))
        losses.append(float(m["loss"]))
    return losses


def _mesh_transient(line):
    """A rank line's peak above what was allocated before its run, its
    carry's bytes (param and AdamW shards) and that peak less the carry
    handed in and the one handed back."""
    peak = int(round((line["peak_mem_gib"] or 0.0) * 2 ** 30)) - line["base"]
    resident = line["param_bytes"] + line["opt_bytes"]
    return {"peak": peak, "resident": resident,
            "transient": peak - 2 * resident}


def _mesh_flops_check(cfg, card_flops, card, tag):
    """Rank 0's FLOPs of a 1x2 step of ``cfg`` against the dry run's meta
    counts at (1, 2) (equal) and (1, 1) (above); the (1, 2) cell's meta
    peak too."""
    from repro_torch.config import MeshConfig, ShapeConfig, TrainConfig
    from repro_torch.launch.dryrun import cost_cell
    tcfg = TrainConfig(lr=3e-4, sgdr_t0=50)
    shape = ShapeConfig("train", "train", LM_S, LM_B)
    cells = {m: cost_cell(cfg, shape, MeshConfig(m, ("data", "model")),
                          tcfg)[0] for m in ((1, 2), (1, 1))}
    meta = {m: c.dot_flops for m, c in cells.items()}
    log(f"mesh ({tag}) {cfg.name} float32 step at 1x2 ({card}), rank 0 "
        f"under FlopCounterMode: {card_flops} FLOPs; the dry run's meta "
        f"count at (1, 2) {meta[(1, 2)]:.0f}, at (1, 1) "
        f"{meta[(1, 1)]:.0f} ({meta[(1, 1)] / meta[(1, 2)]:.4f}x)")
    require(card_flops == meta[(1, 2)] and meta[(1, 2)] < meta[(1, 1)],
            f"({tag}) the card's 1x2 step of {cfg.name} counts "
            f"{card_flops} FLOPs against the meta {meta[(1, 2)]:.0f} "
            f"(1x1: {meta[(1, 1)]:.0f})")
    return {"card": card_flops, "meta_1x2": meta[(1, 2)],
            "meta_1x1": meta[(1, 1)],
            "meta_peak_1x2": cells[(1, 2)].peak_bytes}


def _mesh_one_rank(dev, card, cfg, tmp, res):
    """(a): the plain step, then launch.train at 1x1 in a one-rank
    group; returns the plain step's losses."""
    import torch.distributed as dist
    plain = _mesh_plain_losses(cfg, dev, MESH_ARCH_STEPS)
    backend = "nccl" if dev.type == "cuda" else "gloo"
    dist.init_process_group(backend, init_method=f"file://{tmp}/a",
                            world_size=1, rank=0)
    try:
        base = _allocated(dev)
        one = _mesh_launch(LM_ARCH, "1x1", MESH_ARCH_STEPS,
                           LM_REDUCED, dev.type)
    finally:
        dist.destroy_process_group()
    require(one["backend"] == backend and one["world"] == 1,
            f"(a) ran on {one['backend']} over {one['world']} ranks")
    same = [a == b for a, b in zip(one["losses"], plain)]
    log(f"mesh (a) {LM_ARCH} float32 {LM_B} x {LM_S} ({card}), "
        f"launch.train --mesh-shape 1x1 in a 1-rank {backend} group "
        f"against the plain "
        f"step: {sum(same)} of {len(plain)} losses bit-identical; "
        f"{one['ms_per_step']:.3f} ms/step, peak "
        f"{_gib(one['peak_mem_gib'])}; losses {one['losses']}")
    require(len(one["losses"]) == len(plain) and all(same),
            f"(a) 1x1 losses {one['losses']} differ from the plain "
            f"step's {plain}")
    res["one"] = {k: one[k] for k in ("ms_per_step", "peak_mem_gib",
                                      "losses")}
    res["one"]["rank"] = one["rank"]
    res["one"]["transient"] = _mesh_transient(dict(one["rank"],
                                                   base=base))
    del one
    return plain


def _mesh_dense_checks(dev, card, plain, tmp, ranks, res):
    """(b)-(e) and (c), (d) from the ranks' results."""
    import numpy as np
    import torch
    for shape in ("2x1", "1x2"):
        got = ranks[0][shape]["losses"]
        err = max(abs(a - b) / abs(b) for a, b in zip(
            got, plain[:MESH_SHARED_STEPS]))
        for r in ranks:
            line = r[shape]["rank"]
            log(f"mesh (b) {shape}, two ranks sharing one card ({card}) "
                f"over gloo (not a multi-GPU result), rank {line['rank']} "
                f"at {tuple(line['coords'])}: "
                f"{line['ms_per_step']:.3f} ms/step, peak "
                f"{_gib(line['peak_mem_gib'])}; holds params "
                f"{line['param_bytes']} of {line['param_bytes_whole']} "
                f"B ({line['param_bytes'] / line['param_bytes_whole']:.3f}"
                f"), AdamW state {line['opt_bytes']} of "
                f"{line['opt_bytes_whole']} B "
                f"({line['opt_bytes'] / line['opt_bytes_whole']:.3f})")
        log(f"mesh (b) {shape} ({card}) losses {got}: largest relative "
            f"difference from (a)'s {err:.3e} (limit "
            f"{MESH_LOSS_RTOL:g})")
        require(len(got) == MESH_SHARED_STEPS and err <= MESH_LOSS_RTOL,
                f"(b) {shape} losses {got} against {plain}")
        res[shape] = {"losses": got, "rel_err": err,
                      "ranks": [r[shape]["rank"] for r in ranks]}
    # (b) at 1x2 the model axis splits the compute: a rank's peak less
    # the shards it holds stays below one whole copy of the params
    whole = ranks[0]["1x2"]["rank"]["param_bytes_whole"]
    res["1x2"]["transient"] = []
    for r in ranks:
        line = dict(r["1x2"]["rank"], base=r["1x2"]["base"])
        t = _mesh_transient(line)
        res["1x2"]["transient"].append(t)
        log(f"mesh (b) 1x2 rank {line['rank']} ({card}): "
            f"{line['ms_per_step']:.3f} ms/step; max_memory_allocated "
            f"{t['peak']} B above the {line['base']} B allocated "
            f"before the run, of which its carry in and out (param and "
            f"AdamW shards, {t['resident']} B each: the step is pure, "
            f"both live at its end) {2 * t['resident']} B: "
            f"{t['transient']} B beside the whole params' {whole} B "
            f"({t['transient'] / whole:.3f} of a copy; 1x1 in (a): "
            f"{res['one']['transient']['transient']} B, "
            f"{res['one']['transient']['transient'] / whole:.3f})")
        if dev.type == "cuda":
            require(t["transient"] < whole,
                    f"(b) 1x2 rank {line['rank']}: peak less its shards "
                    f"{t['transient']} B is not below one whole copy "
                    f"of the params ({whole} B)")
    # (b') the config's bfloat16: shards gathered as bytes
    bf16 = _mesh_launch(LM_ARCH, "1x1", MESH_BF16_STEPS, LM_REDUCED,
                        dev.type, "bfloat16")
    got = ranks[0]["bf16"]["losses"]
    err = max(abs(a - b) / abs(b) for a, b in zip(got, bf16["losses"]))
    ms2 = ranks[0]["bf16"]["rank"]["ms_per_step"]
    log(f"mesh (b') {LM_ARCH} bfloat16 at 2x1 (two ranks sharing the "
        f"card, {card}) against 1x1: losses {got} / {bf16['losses']}, "
        f"largest relative difference {err:.3e} (limit "
        f"{MESH_BF16_RTOL:.3e}, one bfloat16 ulp); rank 0 {ms2:.3f} "
        f"ms/step against {bf16['ms_per_step']:.3f} at 1x1")
    require(len(got) == MESH_BF16_STEPS and err <= MESH_BF16_RTOL,
            f"(b') bfloat16 losses {got} against {bf16['losses']}")
    res["bf16"] = {"losses": got, "one": bf16["losses"], "rel_err": err}
    # (b'') bfloat16 at 1x2: the model axis's split in the config's
    # dtype, against the same 1x1 run
    got = ranks[0]["bf16_1x2"]["losses"]
    err = max(abs(a - b) / abs(b) for a, b in zip(got, bf16["losses"]))
    log(f"mesh (b'') {LM_ARCH} bfloat16 at 1x2, the model axis split "
        f"(two ranks sharing the card, {card}) against 1x1: losses "
        f"{got} / {bf16['losses']}, largest relative difference "
        f"{err:.3e} (limit {MESH_BF16_SPLIT_RTOL:.3e}, one bfloat16 "
        f"ulp); rank 0 {ranks[0]['bf16_1x2']['rank']['ms_per_step']:.3f}"
        f" ms/step")
    require(len(got) == MESH_BF16_STEPS and err <= MESH_BF16_SPLIT_RTOL,
            f"(b'') bfloat16 1x2 losses {got} against {bf16['losses']}")
    res["bf16_1x2"] = {"losses": got, "rel_err": err}
    del bf16
    # (e) rank 0's FLOPs of one 1x2 step equal the dry run's meta count
    # of the same step, below the one-process count
    res["flops"] = _mesh_flops_check(_mesh_lm_cfg(LM_REDUCED),
                                     ranks[0]["flops_1x2"], card, "e")
    # (c) the formula on one rank, on the card
    ins = [{k: torch.as_tensor(v).to(dev)
            for k, v in _mesh_psum_inputs(r).items()} for r in range(2)]
    flips = 0
    for k in ins[0]:
        g = [x[k] for x in ins]
        scale = torch.maximum(*[torch.clamp(torch.max(torch.abs(t)),
                                            min=1e-12) / 127.0
                                for t in g])
        q = [torch.clamp(torch.round(t / scale), -127, 127).to(
            torch.int8).to(torch.int32) for t in g]
        want = ((q[0] + q[1]).to(torch.float32) * scale).cpu().numpy()
        for r in range(2):
            with np.load(Path(tmp, f"psum{r}.npz")) as data:
                flips += int((data[k] != want).sum())
    log(f"mesh (c) psum_int8 over the 2 ranks on "
        f"{ranks[0]['psum_device']} tensors, shapes "
        f"{list(MESH_PSUM_SHAPES)} and an all-zero leaf: {flips} "
        "elements differ from the formula on one rank")
    require(flips == 0, f"(c) psum_int8: {flips} elements differ")
    # (d) the MoE LM at 2x1 against one rank
    moe_one = _mesh_launch(MOE_ARCHS[0], "1x1", MESH_MOE_STEPS, True,
                           dev.type)
    got = ranks[0]["moe"]["losses"]
    err = max(abs(a - b) / abs(b) for a, b in zip(got,
                                                  moe_one["losses"]))
    log(f"mesh (d) {MOE_ARCHS[0]} reduced at 2x1 (ranks sharing the "
        f"card, {card}) against one rank: losses {got} / "
        f"{moe_one['losses']}, "
        f"largest relative difference {err:.3e}")
    require(len(got) == MESH_MOE_STEPS and err <= MESH_LOSS_RTOL,
            f"(d) MoE losses {got} against {moe_one['losses']}")
    res["moe"] = {"losses": got, "one": moe_one["losses"],
                  "rel_err": err}


def _mesh_split_one(dev, card, tmp, h=None):
    """(f) before the ranks: per MoE cut, the plain step and
    launch.train at 1x1 in a one-rank group, bit for bit; the 1x1 run's
    routing saved for the ranks (``_Routing``).  Returns the losses.
    ``h``: a dict that takes (h)'s 1x1 of each cut, on the same draw."""
    import torch
    import torch.distributed as dist
    out = {}
    for arch in MOE_ARCHS:
        cut = _mesh_moe_cut(arch, LM_REDUCED)
        backend = "nccl" if dev.type == "cuda" else "gloo"
        with _DrawnOnce():
            plain = _mesh_plain_losses(cut, dev, MESH_SPLIT_STEPS)
            dist.init_process_group(
                backend, init_method=f"file://{tmp}/f_{arch}",
                world_size=1, rank=0)
            try:
                with _Routing() as route:
                    one = _mesh_launch(arch, "1x1", MESH_SPLIT_STEPS,
                                       LM_REDUCED, dev.type, cfg=cut)
            finally:
                dist.destroy_process_group()
            if h is not None:
                h[arch] = _mesh_h_one(dev, card, tmp, arch, cut)
        route.save(os.path.join(tmp, f"route_{arch}.npz"))
        same = sum(a == b for a, b in zip(one["losses"], plain))
        log(f"mesh (f) {arch} x{cut.num_layers} layers "
            f"{'reduced' if LM_REDUCED else 'at full width'}, float32, "
            f"dense dispatch, {LM_B} x {LM_S} ({card}): 1x1 in a 1-rank "
            f"{backend} group {same} of {len(plain)} losses bit-identical "
            f"to the plain step ({one['ms_per_step']:.3f} ms/step); "
            f"smallest gap between a token's k-th and (k+1)-th routing "
            f"probability {min(float(g.min()) for g in route.gap):.3e}")
        require(len(one["losses"]) == len(plain) == MESH_SPLIT_STEPS
                and same == len(plain),
                f"(f) {arch} 1x1 losses {one['losses']} differ from the "
                f"plain step's {plain}")
        out[arch] = {"plain": plain, "one": one["losses"],
                     "one_ms": one["ms_per_step"]}
        del one
    if dev.type == "cuda":
        torch.cuda.empty_cache()      # the ranks share the card next
    return out


def _loss_err(got, want):
    return max(abs(a - b) / abs(b) for a, b in zip(got, want))


def _mesh_split_checks(dev, card, tmp, ranks, ones):
    """(f) from the ranks' results: both ranks route every token alike;
    the 1x2 losses (the experts, the shared experts and MLA's heads
    split) against 1x1's at MESH_LOSS_RTOL.  Where a token is routed
    otherwise at 1x2 than at 1x1, it must be a tie of the split's
    rounding (its k-th and (k+1)-th probabilities within MESH_TIE_GAP
    at 1x1): then the losses are held up to the step of that first
    routing call (later steps part, as any run whose one token took
    other experts: Adam's first update moves each element whose
    gradient changes sign by 2 lr), and the ranks' replay of the same
    steps on 1x1's routing is held to 1x1 at MESH_LOSS_RTOL on every
    step.  Each rank's ms/step and its peak less its carry in and out
    below one whole copy of the cut's params; rank 0's FLOPs of a 1x2
    step equal to the dry run's meta count at (1, 2), below (1, 1)'s."""
    import numpy as np
    import torch
    out = {}
    for arch in MOE_ARCHS:
        cut = _mesh_moe_cut(arch, LM_REDUCED)
        r = dict(ones[arch], ranks=[])
        one_idx, one_gap = _Routing.load(os.path.join(tmp,
                                                      f"route_{arch}.npz"))
        routes = [_Routing.load(os.path.join(tmp, f"route_{arch}_{k}.npz"))[0]
                  for k in range(2)]
        require(len(routes[0]) == len(routes[1]) == len(one_idx) and all(
            (a == b).all() for a, b in zip(*routes)),
            f"(f) {arch}: the two model ranks routed the tokens otherwise")
        calls = len(one_idx) // MESH_SPLIT_STEPS     # routing calls a step
        moved = [(i, np.nonzero((a != b).any(-1))[0])
                 for i, (a, b) in enumerate(zip(one_idx, routes[0]))]
        moved = [(i, rows) for i, rows in moved if len(rows)]
        got = ranks[0][arch]["losses"]
        r["losses"] = got
        if not moved:
            r["rel_err"] = err = _loss_err(got, r["one"])
            log(f"mesh (f) {arch} 1x2 (two ranks sharing the card over "
                f"gloo, the experts, shared experts and heads split; every "
                f"token routed as at 1x1) losses {got} against 1x1's "
                f"{r['one']}: largest relative difference {err:.3e} (limit "
                f"{MESH_LOSS_RTOL:g})")
            require(len(got) == MESH_SPLIT_STEPS and err <= MESH_LOSS_RTOL,
                    f"(f) {arch} 1x2 losses {got} against 1x1's {r['one']}")
        else:
            first, rows = moved[0]
            gaps = one_gap[first][rows]
            held = first // calls + 1
            err = _loss_err(got[:held], r["one"][:held])
            rep = ranks[0][arch]["replayed"]
            r.update(rel_err=err, rerouted=[int(x) for x in rows],
                     tie_gaps=[float(g) for g in gaps], held_steps=held,
                     replayed=rep, replay_err=_loss_err(rep, r["one"]))
            log(f"mesh (f) {arch} 1x2 (two ranks sharing the card over "
                f"gloo, the experts, shared experts and heads split): "
                f"routing call {first} (step {first // calls}) routes "
                f"token(s) {r['rerouted']} otherwise than 1x1, whose k-th "
                f"and (k+1)-th probabilities lie {r['tie_gaps']} apart at "
                f"1x1 (a tie of the split's rounding if below "
                f"{MESH_TIE_GAP:g}); losses {got} against "
                f"1x1's {r['one']}: the first {held} within {err:.3e}; the "
                f"same steps replaying 1x1's routing {rep}: largest "
                f"relative difference {r['replay_err']:.3e} (limit "
                f"{MESH_LOSS_RTOL:g})")
            require(all(g < MESH_TIE_GAP for g in gaps),
                    f"(f) {arch}: token(s) {r['rerouted']} routed otherwise "
                    f"at 1x2 with probability gaps {r['tie_gaps']} at 1x1, "
                    f"beyond the split's rounding ({MESH_TIE_GAP:g})")
            require(len(got) == MESH_SPLIT_STEPS and err <= MESH_LOSS_RTOL
                    and len(rep) == MESH_SPLIT_STEPS
                    and r["replay_err"] <= MESH_LOSS_RTOL,
                    f"(f) {arch} 1x2 losses {got} (replaying 1x1's routing "
                    f"{rep}) against 1x1's {r['one']}")
        whole = ranks[0][arch]["rank"]["param_bytes_whole"]
        for rk in ranks:
            line = dict(rk[arch]["rank"], base=rk[arch]["base"])
            t = _mesh_transient(line)
            r["ranks"].append(dict(t, ms_per_step=line["ms_per_step"]))
            log(f"mesh (f) {arch} 1x2 rank {line['rank']} ({card}): "
                f"{line['ms_per_step']:.3f} ms/step; holds params "
                f"{line['param_bytes']} of {whole} B; max_memory_allocated "
                f"{t['peak']} B above the {line['base']} B allocated "
                f"before the run, less its carry in and out "
                f"({2 * t['resident']} B): {t['transient']} B beside the "
                f"whole params' {whole} B ({t['transient'] / whole:.3f} "
                f"of a copy)")
            if dev.type == "cuda":
                require(t["transient"] < whole,
                        f"(f) {arch} 1x2 rank {line['rank']}: peak less its "
                        f"shards {t['transient']} B is not below one whole "
                        f"copy of the params ({whole} B)")
        r["flops"] = _mesh_flops_check(cut, ranks[0][arch]["flops"], card,
                                       "f")
        log(f"mesh (f) {arch}: the dry run's meta peak at (1, 2) "
            f"{r['flops']['meta_peak_1x2']:.0f} B beside the ranks' "
            + ", ".join(f"{t['transient']} B" for t in r["ranks"]))
        if dev.type == "cuda":
            torch.cuda.empty_cache()
        out[arch] = r
    return out


def _mesh_g_cuts(reduced):
    """(g)'s configs at their published widths, float32: jamba cut as
    ``_jamba_cut`` cuts it (one Mamba and one attention layer, each with
    the dense MLP) and whisper-small cut to ED_STEP_LAYERS encoder and
    decoder layers (the reduced configs on a rehearsal)."""
    import dataclasses
    from repro_torch.config import get_config
    jamba = _jamba_cut(get_config(SSM_ARCHS[0], reduced=reduced))
    wh = get_config(ENCDEC_ARCH, reduced=reduced)
    wh = dataclasses.replace(wh, num_layers=ED_STEP_LAYERS,
                             encoder=dataclasses.replace(
                                 wh.encoder, num_layers=ED_STEP_LAYERS))
    return {SSM_ARCHS[0]: dataclasses.replace(jamba, dtype="float32"),
            ENCDEC_ARCH: dataclasses.replace(wh, dtype="float32")}


def _mesh_ed_launch(cfg, shape, steps, device):
    """launch.train's LM branch for an encoder-decoder, which the
    launcher refuses: ``make_mesh_train_step`` over the open group (one
    process without one) laid out as ``shape``, the launcher's init
    (seed 0, drawn on the host) and settings, on ``_mesh_batch``'s
    batches; its losses and launch.train's rank line."""
    import torch
    from repro_torch.config import ShapeConfig, TrainConfig
    from repro_torch.launch.mesh import make_host_mesh
    from repro_torch.models import api
    from repro_torch.optim import adamw_init
    from repro_torch.sharding.spmd import (local_batch, make_mesh_train_step,
                                           param_shardings, shard_tree,
                                           tree_bytes)
    tcfg = TrainConfig(lr=3e-4, sgdr_t0=max(50, steps // 4))
    sh = ShapeConfig("train", "train", LM_S, LM_B)
    mesh = make_host_mesh(tuple(int(n) for n in shape.split("x")),
                          device=device)
    dev = mesh.device
    params = api.init_params(cfg, torch.Generator().manual_seed(tcfg.seed),
                             device=dev)
    whole = tree_bytes(params)
    psh = param_shardings(cfg, params, mesh)
    params = shard_tree(params, psh)
    carry = (params, adamw_init(params))
    del params
    step = make_mesh_train_step(cfg, tcfg, mesh, psh, sh)
    if dev.type == "cuda":
        torch.cuda.reset_peak_memory_stats(dev)
    losses, seconds = [], []
    for s in range(steps):
        batch = local_batch(_mesh_batch(cfg, s, dev), mesh, cfg, sh)
        t0 = time.perf_counter()
        p, o, m = step(carry[0], carry[1], batch)
        losses.append(float(m["loss"]))
        seconds.append(time.perf_counter() - t0)
        carry = (p, o)
        del p, o, m, batch
    steady = seconds[1:] or seconds
    peak = (torch.cuda.max_memory_allocated(dev) / 2 ** 30
            if dev.type == "cuda" else None)
    rank = {"rank": mesh.rank, "world": mesh.world,
            "coords": list(mesh.coords),
            "ms_per_step": 1e3 * sum(steady) / len(steady),
            "peak_mem_gib": peak, "param_bytes": tree_bytes(carry[0]),
            "opt_bytes": tree_bytes(carry[1]), "param_bytes_whole": whole}
    return {"losses": losses, "rank": rank, "ms_per_step":
            rank["ms_per_step"], "world": mesh.world,
            "backend": mesh.backend}


def _mesh_g_run(arch, cut, reduced, dev, shape):
    """(g) at ``shape``: launch.train on the jamba cut, ``_mesh_ed_launch``
    on the whisper cut; its losses, rank line and the bytes allocated
    before it."""
    base = _allocated(dev)
    if cut.encoder is not None:
        out = _mesh_ed_launch(cut, shape, MESH_SPLIT_STEPS, dev.type)
    else:
        out = _mesh_launch(arch, shape, MESH_SPLIT_STEPS, reduced, dev.type,
                           cfg=cut)
    return {"losses": out["losses"], "rank": out["rank"], "base": base,
            "ms_per_step": out["ms_per_step"], "world": out["world"],
            "backend": out["backend"]}


def _mesh_g_one(dev, card, tmp, h=None):
    """(g) before the ranks: per cut, the plain step and the same steps at
    1x1 in a one-rank group (launch.train on jamba's, make_mesh_train_step
    on whisper's), bit for bit.  Returns the losses and the 1x1 runs'
    rank lines.  ``h``: a dict that takes (h)'s 1x1 of each cut, on the
    same draw."""
    import torch
    import torch.distributed as dist
    out = {}
    backend = "nccl" if dev.type == "cuda" else "gloo"
    for arch, cut in _mesh_g_cuts(LM_REDUCED).items():
        with _DrawnOnce():
            plain = _mesh_plain_losses(cut, dev, MESH_SPLIT_STEPS)
            dist.init_process_group(
                backend, init_method=f"file://{tmp}/g_{arch}",
                world_size=1, rank=0)
            try:
                one = _mesh_g_run(arch, cut, LM_REDUCED, dev, "1x1")
            finally:
                dist.destroy_process_group()
            if h is not None:
                h[arch] = _mesh_h_one(dev, card, tmp, arch, cut)
        same = sum(a == b for a, b in zip(one["losses"], plain))
        log(f"mesh (g) {arch} {_cut_name(cut)} "
            f"{'reduced' if LM_REDUCED else 'at full width'}, float32, "
            f"{LM_B} x {LM_S} ({card}): 1x1 in a 1-rank {backend} group "
            f"({one['backend']}, {one['world']} rank) {same} of "
            f"{len(plain)} losses bit-identical to the plain step "
            f"({one['ms_per_step']:.3f} ms/step); losses {one['losses']}")
        require(len(one["losses"]) == len(plain) == MESH_SPLIT_STEPS
                and same == len(plain) and one["world"] == 1,
                f"(g) {arch} 1x1 losses {one['losses']} differ from the "
                f"plain step's {plain}")
        out[arch] = {"plain": plain, "one": one["losses"],
                     "one_ms": one["ms_per_step"],
                     "one_transient": _mesh_transient(
                         dict(one["rank"], base=one["base"]))}
        del one
        if dev.type == "cuda":
            torch.cuda.empty_cache()
    return out


def _cut_name(cut):
    if cut.encoder is not None:
        return (f"x{cut.encoder.num_layers} + {cut.num_layers} layers "
                f"(encoder + decoder)")
    return "x" + " + ".join(f"{s.mixer}/{s.ffn}" for s in cut.pattern)


def _mesh_g_checks(dev, card, tmp, ranks, ones):
    """(g) from the ranks' results: the 1x2 losses (jamba's Mamba channels
    and whisper's encoder, self and cross attention split) against 1x1's
    at MESH_LOSS_RTOL, both ranks' alike; rank 0's FLOPs of a 1x2 step
    equal to the dry run's meta count at (1, 2), below (1, 1)'s.  Each
    rank's peak less its carry in and out beside the dry run's (1, 2)
    figure (meta peak less the carry out), 1x1's and one whole copy of
    the cut's params; held below one copy where the dry run's figure is
    (jamba's), printed where it is not (whisper's: its encoder's
    activations over the 1,500 frames pass a copy at 1x1 and 1x2
    alike)."""
    import torch
    out = {}
    for arch, cut in _mesh_g_cuts(LM_REDUCED).items():
        r = dict(ones[arch], ranks=[])
        got = ranks[0][arch]["losses"]
        r["losses"] = got
        r["rel_err"] = err = _loss_err(got, r["one"])
        what = ("the Mamba channels" if cut.encoder is None
                else "the encoder, self and cross attention")
        log(f"mesh (g) {arch} 1x2 (two ranks sharing the card over gloo; "
            f"{what} and the FFNs split) losses {got} against 1x1's "
            f"{r['one']}: "
            f"largest relative difference {err:.3e} (limit "
            f"{MESH_LOSS_RTOL:g}); rank 1's {ranks[1][arch]['losses']}")
        require(len(got) == MESH_SPLIT_STEPS and err <= MESH_LOSS_RTOL
                and ranks[1][arch]["losses"] == got,
                f"(g) {arch} 1x2 losses {got} (rank 1: "
                f"{ranks[1][arch]['losses']}) against 1x1's {r['one']}")
        r["flops"] = _mesh_flops_check(cut, ranks[0][arch]["flops"], card,
                                       "g")
        whole = ranks[0][arch]["rank"]["param_bytes_whole"]
        one_t = r["one_transient"]["transient"]
        for rk in ranks:
            line = dict(rk[arch]["rank"], base=rk[arch]["base"])
            t = _mesh_transient(line)
            meta = r["flops"]["meta_peak_1x2"] - t["resident"]
            r["ranks"].append(dict(t, ms_per_step=line["ms_per_step"],
                                   meta=meta))
            log(f"mesh (g) {arch} 1x2 rank {line['rank']} ({card}): "
                f"{line['ms_per_step']:.3f} ms/step; holds params "
                f"{line['param_bytes']} of {whole} B; max_memory_allocated "
                f"{t['peak']} B above the {line['base']} B allocated "
                f"before the run, less its carry in and out "
                f"({2 * t['resident']} B): {t['transient']} B, "
                f"{t['transient'] / whole:.3f} of a whole copy of the "
                f"params ({whole} B), {t['transient'] / one_t:.3f} of "
                f"1x1's {one_t} B; the dry run's (1, 2) figure (meta peak "
                f"less the carry out) {meta:.0f} B "
                f"({t['transient'] / meta:.3f}x)")
            if dev.type == "cuda" and meta < whole:
                require(t["transient"] < whole,
                        f"(g) {arch} 1x2 rank {line['rank']}: peak less its "
                        f"shards {t['transient']} B is not below one whole "
                        f"copy of the params ({whole} B)")
        if dev.type == "cuda":
            torch.cuda.empty_cache()
        out[arch] = r
    return out


MESH_H_WARM = 4            # (h): plain decode steps that fill the cache
MESH_H_STEPS = 8           # (h): teacher-forced steps through the mesh step
MESH_H_GATE = 0.25         # (h): a rank's peak less its carry, of a copy
MESH_H_ROWS = 8            # (h): whisper's frames encoded this many rows
H_ARCH = "granite-34b"     # (h): one kv head, its cache across head_dim


def _mesh_h_cuts(reduced):
    """(h)'s configs, float32: lm-100m whole, (f)'s MoE cuts and (g)'s
    jamba and whisper cuts (equal configs, so ``_DrawnOnce`` shares
    their host draws), and granite-34b cut to one layer at its published
    width: its single kv head puts its K/V cache across head_dim at 1x2,
    which no other cut reaches (the reduced configs on a rehearsal)."""
    import dataclasses
    from repro_torch.config import get_config
    out = {LM_ARCH: _mesh_lm_cfg(reduced)}
    out.update((a, _mesh_moe_cut(a, reduced)) for a in MOE_ARCHS)
    out.update(_mesh_g_cuts(reduced))
    out[H_ARCH] = dataclasses.replace(get_config(H_ARCH, reduced=reduced),
                                      num_layers=1, dtype="float32")
    return out


def _mesh_h_warm(cfg, dev):
    """(params on the device, drawn as launch.train draws them: seed 0
    on the host; the decode state of LM_DECODE_B rows of LM_DECODE_CTX
    after MESH_H_WARM plain decode steps; the MESH_H_STEPS tokens that
    follow), tokens drawn from a host seed.  Whisper's cross K/V are
    projected from encoded frames (MESH_H_ROWS rows at a time)."""
    import numpy as np
    import torch
    from repro_torch.config import TrainConfig
    from repro_torch.models import api, encdec
    from repro_torch.models.layers.common import zeros_from_spec
    from repro_torch.train.step import make_serve_step
    params = api.init_params(cfg, torch.Generator().manual_seed(
        TrainConfig().seed), device=dev)
    rng = np.random.default_rng(7)
    toks = torch.as_tensor(rng.integers(
        0, cfg.vocab_size, (MESH_H_WARM + MESH_H_STEPS, LM_DECODE_B, 1)
    ).astype(np.int32)).to(dev)
    state = zeros_from_spec(api.decode_state_spec(
        cfg, LM_DECODE_B, LM_DECODE_CTX), device=dev)
    if cfg.encoder is not None:
        frames = torch.as_tensor(rng.normal(0, 1, (
            LM_DECODE_B, cfg.encoder.seq_len, cfg.encoder.feature_dim)
        ).astype(np.float32)).to(dev)
        with torch.no_grad():
            enc = torch.cat([encdec.encode(cfg, params,
                                           frames[i:i + MESH_H_ROWS])
                             for i in range(0, LM_DECODE_B, MESH_H_ROWS)])
            state["cross"] = encdec.prefill_cross(cfg, params, enc)
        del frames, enc
    step = make_serve_step(cfg)
    for t in toks[:MESH_H_WARM]:
        _, state = step(params, state, t)
    return params, state, toks[MESH_H_WARM:]


def _mesh_h_layout(cfg, mesh, params, state):
    """(param shardings, cache shardings, decode shape) on ``mesh``."""
    from repro_torch.config import ShapeConfig
    from repro_torch.sharding.partition import cache_partition, named
    from repro_torch.sharding.spmd import param_shardings
    shape = ShapeConfig("decode", "decode", LM_DECODE_CTX, LM_DECODE_B)
    return (param_shardings(cfg, params, mesh),
            named(mesh, cache_partition(cfg, shape, mesh.config, state)),
            shape)


def _model_leaf_bytes(cfg, state):
    """Bytes of each decode-state leaf that ``cache_partition`` puts on
    the model axis at (1, 2), in the tree's order."""
    from repro_torch.config import MeshConfig, ShapeConfig
    from repro_torch.sharding.partition import cache_partition, named
    from repro_torch.tree import tree_leaves
    csh = named(None, cache_partition(
        cfg, ShapeConfig("decode", "decode", LM_DECODE_CTX, LM_DECODE_B),
        MeshConfig((1, 2), ("data", "model")), state))
    return [t.numel() * t.element_size()
            for t, s in zip(tree_leaves(state), tree_leaves(csh))
            if any("model" in ((p,) if isinstance(p, str) else (p or ()))
                   for p in s.spec)]


def _mesh_h_one(dev, card, tmp, arch, cut):
    """(h) before the ranks, for one cut: MESH_H_STEPS teacher-forced
    decode steps through ``make_mesh_serve_step`` at 1x1 in a one-rank
    group, each against ``make_serve_step`` bit for bit (logits and the
    whole state); the plain logits saved for the ranks, an MoE cut's
    routing of the mesh steps too."""
    import numpy as np
    import torch
    import torch.distributed as dist
    from repro_torch.launch.mesh import make_host_mesh
    from repro_torch.sharding.spmd import make_mesh_serve_step, tree_bytes
    from repro_torch.train.step import make_serve_step
    from repro_torch.tree import tree_leaves
    params, state, toks = _mesh_h_warm(cut, dev)
    backend = "nccl" if dev.type == "cuda" else "gloo"
    dist.init_process_group(backend, init_method=f"file://{tmp}/h_{arch}",
                            world_size=1, rank=0)
    try:
        mesh = make_host_mesh((1, 1), device=dev)
        psh, csh, shape = _mesh_h_layout(cut, mesh, params, state)
        step = make_mesh_serve_step(cut, mesh, psh, csh, shape)
        plain = make_serve_step(cut)
        got, want, same, logits = state, state, [], []
        route = _Routing()
        t0 = time.perf_counter()
        for t in toks:
            with route:
                gl, got = step(params, got, t)
            wl, want = plain(params, want, t)
            same.append(torch.equal(gl, wl) and all(
                torch.equal(a, b) for a, b in zip(tree_leaves(got),
                                                  tree_leaves(want))))
            logits.append(wl.cpu().numpy())
        ms = 1e3 * (time.perf_counter() - t0) / len(toks)
    finally:
        dist.destroy_process_group()
    np.save(os.path.join(tmp, f"h_{arch}.npy"), np.stack(logits))
    if route.idx:
        route.save(os.path.join(tmp, f"h_route_{arch}.npz"))
    out = {"same": same, "ms_plain_and_1x1": ms,
           "whole": tree_bytes(params),
           "model_leaves": _model_leaf_bytes(cut, want),
           "min_gap": min((float(g.min()) for g in route.gap),
                          default=None)}
    log(f"mesh (h) {arch} {_cut_name(cut)} "
        f"{'reduced' if LM_REDUCED else 'at full width'}, float32, "
        f"decode {LM_DECODE_B} x {LM_DECODE_CTX} after {MESH_H_WARM} plain "
        f"steps ({card}): {MESH_H_STEPS} teacher-forced steps through "
        f"make_mesh_serve_step at 1x1 in a 1-rank {backend} group, "
        f"{sum(same)} of {len(same)} bit-identical to make_serve_step "
        f"(logits and state); {ms:.3f} ms a step of both"
        + ("" if out["min_gap"] is None else
           f"; smallest gap between a token's k-th and (k+1)-th routing "
           f"probability {out['min_gap']:.3e}"))
    require(len(same) == MESH_H_STEPS and all(same),
            f"(h) {arch} 1x1 decode differs from make_serve_step: {same}")
    del params, state, got, want
    if dev.type == "cuda":
        torch.cuda.empty_cache()
    return out


def _mesh_h_steps(cut, mesh, ps, ss, psh, csh, shape, toks, want,
                  route, dev):
    """MESH_H_STEPS mesh decode steps from the state shards ``ss``: each
    step's logits against 1x1's (``want``; the largest difference over
    the largest logit) and their digest, the peak above what was
    allocated before (the carry in), the bytes of the state out that a
    step allocates (whisper's cross K/V are handed on as they are), the
    last state shards."""
    import hashlib
    import numpy as np
    import torch
    from repro_torch.sharding.spmd import make_mesh_serve_step
    from repro_torch.tree import tree_leaves
    step = make_mesh_serve_step(cut, mesh, psh, csh, shape)
    base = _allocated(dev)
    if dev.type == "cuda":
        torch.cuda.reset_peak_memory_stats(dev)
    errs, digests = [], []
    t0 = time.perf_counter()
    for t, w in zip(toks, want):
        old = {a.data_ptr() for a in tree_leaves(ss)}
        with route:
            logits, ss = step(ps, ss, t)
        got = logits.cpu().numpy()
        errs.append(float(np.abs(got - w).max() / np.abs(w).max()))
        digests.append(hashlib.sha256(got.tobytes()).hexdigest())
    ms = 1e3 * (time.perf_counter() - t0) / len(toks)
    peak = (torch.cuda.max_memory_allocated(dev) - base
            if dev.type == "cuda" else 0)
    fresh = sum(a.numel() * a.element_size() for a in tree_leaves(ss)
                if a.data_ptr() not in old)
    return {"errs": errs, "digests": digests, "peak": int(peak),
            "fresh": fresh, "ms_per_step": ms}, ss


def _mesh_h_rank(arch, cut, dev, out_dir):
    """(h) on one rank: the cut's state after the plain steps (on the
    whole params, as 1x1's), then MESH_H_STEPS steps of
    ``make_mesh_serve_step`` at 1x2 on the rank's param and state
    shards, routing recorded; where a token routes otherwise than at
    1x1, the same steps again replaying 1x1's routing.  Its logits'
    differences from 1x1's, the shards' bytes, the peak less the carry
    in (param and state shards) and the state out."""
    import numpy as np
    import torch
    from repro_torch.launch.mesh import make_host_mesh
    from repro_torch.sharding.spmd import shard_tree, tree_bytes
    from repro_torch.tree import tree_map
    mesh = make_host_mesh((1, 2), device=dev)
    params, state, toks = _mesh_h_warm(cut, dev)
    psh, csh, shape = _mesh_h_layout(cut, mesh, params, state)
    ps = shard_tree(params, psh)
    # the state shards kept on the host for a replay: the device holds
    # one carry in
    ss = tree_map(lambda t: t.cpu(), shard_tree(state, csh))
    whole = tree_bytes(params)
    del params, state
    if dev.type == "cuda":
        torch.cuda.empty_cache()
    want = np.load(os.path.join(out_dir, f"h_{arch}.npy"))
    route = _Routing()
    res, new = _mesh_h_steps(cut, mesh, ps, tree_map(
        lambda t: t.to(dev), ss), psh, csh, shape, toks, want, route, dev)
    res.update(whole=whole, param_bytes=tree_bytes(ps),
               state_bytes=tree_bytes(new),
               transient=res["peak"] - res["fresh"],
               model_leaves=_model_leaf_bytes(cut, new))
    del new
    path = os.path.join(out_dir, f"h_route_{arch}.npz")
    if route.idx:
        one, _ = _Routing.load(path)
        res["rerouted"] = len(one) != len(route.idx) or any(
            (a != b).any() for a, b in zip(one, route.idx))
        res["route"] = [a.tolist() for a in route.idx]
        if res["rerouted"]:
            rep, new = _mesh_h_steps(cut, mesh, ps, tree_map(
                lambda t: t.to(dev), ss), psh, csh, shape, toks, want,
                _Routing(replay=one), dev)
            res["replayed"] = rep["errs"]
            del new
    return res


def _mesh_h_flops(cfg, dev):
    """FlopCounterMode's count of one decode step of ``cfg`` through
    ``make_mesh_serve_step`` over the open group as a 1 x 2 mesh (after
    a warm step), at the dry run's settings: its param tree (an MoE's
    experts padded to the model axis, 2) drawn from seed 0 on the
    device and a zero state of LM_DECODE_B x LM_DECODE_CTX (the count
    does not depend on the values)."""
    import torch
    from torch.utils.flop_counter import FlopCounterMode
    from repro_torch.launch.mesh import make_host_mesh
    from repro_torch.models import api
    from repro_torch.models.layers.common import (init_from_spec,
                                                  zeros_from_spec)
    from repro_torch.sharding.spmd import make_mesh_serve_step, shard_tree
    mesh = make_host_mesh((1, 2), device=dev)
    params = init_from_spec(api.param_spec(cfg, model_axis=2),
                            torch.Generator(device=dev).manual_seed(0),
                            device=dev)
    state = zeros_from_spec(api.decode_state_spec(
        cfg, LM_DECODE_B, LM_DECODE_CTX), device=dev)
    psh, csh, shape = _mesh_h_layout(cfg, mesh, params, state)
    step = make_mesh_serve_step(cfg, mesh, psh, csh, shape)
    args = (shard_tree(params, psh), shard_tree(state, csh),
            torch.zeros((LM_DECODE_B, 1), dtype=torch.int32, device=dev))
    del params, state
    out = step(*args)
    del out
    with FlopCounterMode(display=False) as fc:
        out = step(*args)
        _allocated(dev)
    return int(fc.get_total_flops())


def _mesh_h_checks(dev, card, tmp, ranks, ones):
    """(h) from the ranks' results, per cut: the 1x2 logits at every
    step within MESH_LOSS_RTOL of the largest of 1x1's, both ranks'
    alike (where a token routes otherwise than at 1x1 it must be a tie,
    a gap below MESH_TIE_GAP at 1x1, and the replay of 1x1's routing is
    held instead); each rank's shard of every cache leaf on the model
    axis half of 1x1's leaf; a rank's peak less its carry (param and
    state shards in, state out) below MESH_H_GATE of one whole copy of
    the params; rank 0's FLOPs of one 1x2 step equal to ``cost_cell``'s
    meta count at (1, 2), below (1, 1)'s."""
    import numpy as np
    from repro_torch.config import MeshConfig, ShapeConfig, TrainConfig
    from repro_torch.launch.dryrun import cost_cell
    out = {}
    shape = ShapeConfig("decode", "decode", LM_DECODE_CTX, LM_DECODE_B)
    for arch, cut in _mesh_h_cuts(LM_REDUCED).items():
        one = ones[arch]
        got = [rk[arch]["h"] for rk in ranks]
        r = {"one_ms": one["ms_plain_and_1x1"], "errs": got[0]["errs"],
             "ranks": []}
        require(got[0]["digests"] == got[1]["digests"],
                f"(h) {arch}: the two model ranks' logits differ")
        errs = got[0]["errs"]
        if got[0].get("rerouted"):
            one_idx, gaps = _Routing.load(os.path.join(
                tmp, f"h_route_{arch}.npz"))
            mine = [np.asarray(a) for a in got[0]["route"]]
            tie = [float(x) for a, b, g in zip(one_idx, mine, gaps)
                   for x in g[(a != b).any(-1)]]
            r.update(tie_gaps=tie, replayed=got[0]["replayed"])
            log(f"mesh (h) {arch} 1x2: {len(tie)} token(s) routed "
                f"otherwise than at 1x1, their k-th and (k+1)-th "
                f"probabilities {tie} apart at 1x1 (a tie if below "
                f"{MESH_TIE_GAP:g}); logits within {max(errs):.3e} of "
                f"1x1's; replaying 1x1's routing within "
                f"{max(got[0]['replayed']):.3e}")
            require(all(g < MESH_TIE_GAP for g in tie),
                    f"(h) {arch}: tokens rerouted at gaps {tie}")
            errs = got[0]["replayed"]
        err = max(errs)
        r["err"] = err
        halves = [2 * b == w for b, w in zip(got[0]["model_leaves"],
                                             one["model_leaves"])]
        whole = one["whole"]
        log(f"mesh (h) {arch} 1x2 (two ranks sharing the card over gloo, "
            f"decode split over the model axis): {MESH_H_STEPS} "
            f"teacher-forced steps' logits within {err:.3e} of 1x1's "
            f"largest (limit {MESH_LOSS_RTOL:g}; per step "
            + ", ".join(f"{e:.2e}" for e in errs) + "); both ranks' "
            f"logits alike; {sum(halves)} of {len(halves)} cache leaves "
            f"on the model axis at half of 1x1's bytes "
            f"({sum(got[0]['model_leaves'])} of "
            f"{sum(one['model_leaves'])} B)")
        require(len(errs) == MESH_H_STEPS and err <= MESH_LOSS_RTOL,
                f"(h) {arch} 1x2 logits off by {errs} of 1x1's largest")
        require(len(halves) == len(one["model_leaves"]) and all(halves),
                f"(h) {arch}: a rank's cache leaves on the model axis "
                f"{got[0]['model_leaves']} B against 1x1's "
                f"{one['model_leaves']} B")
        for k, g in enumerate(got):
            share = g["transient"] / whole
            r["ranks"].append({"transient": g["transient"], "share": share,
                               "peak": g["peak"], "fresh": g["fresh"],
                               "ms_per_step": g["ms_per_step"],
                               "param_bytes": g["param_bytes"],
                               "state_bytes": g["state_bytes"]})
            log(f"mesh (h) {arch} 1x2 rank {k} ({card}): "
                f"{g['ms_per_step']:.3f} ms a step; holds params "
                f"{g['param_bytes']} of {whole} B and {g['state_bytes']} B "
                f"of state; max_memory_allocated {g['peak']} B above its "
                f"carry in, less the state out that a step allocates "
                f"({g['fresh']} B): {g['transient']} B, "
                f"{share:.4f} of a whole copy of the params (limit "
                f"{MESH_H_GATE:g})")
            if dev.type == "cuda":
                require(share < MESH_H_GATE,
                        f"(h) {arch} 1x2 rank {k}: peak less its carry "
                        f"{g['transient']} B is {share:.3f} of a copy")
        meta = {m: cost_cell(cut, shape, MeshConfig(m, ("data", "model")),
                             TrainConfig())[0].dot_flops
                for m in ((1, 2), (1, 1))}
        card_flops = ranks[0][arch]["h_flops"]
        r["flops"] = {"card": card_flops, "meta_1x2": meta[(1, 2)],
                      "meta_1x1": meta[(1, 1)]}
        log(f"mesh (h) {arch} decode step at 1x2 ({card}), rank 0 under "
            f"FlopCounterMode: {card_flops} FLOPs; the dry run's meta count "
            f"at (1, 2) {meta[(1, 2)]:.0f}, at (1, 1) {meta[(1, 1)]:.0f} "
            f"({meta[(1, 1)] / meta[(1, 2)]:.4f}x)")
        require(card_flops == meta[(1, 2)] and meta[(1, 2)] < meta[(1, 1)],
                f"(h) {arch}: the card's 1x2 decode step counts "
                f"{card_flops} FLOPs against the meta {meta[(1, 2)]:.0f} "
                f"(1x1: {meta[(1, 1)]:.0f})")
        out[arch] = r
    return out


def phase_mesh(dev, card, only=None):
    """The LM over a mesh of processes: (a) lm-100m at full width,
    float32, through launch.train --mesh-shape 1x1 in a one-rank NCCL
    group, MESH_ARCH_STEPS steps bit for bit against the plain step
    with no process group; (b) two ranks sharing the card over gloo,
    at 2x1 and 1x2 (the model axis's compute split), MESH_SHARED_STEPS
    steps against (a)'s first losses at MESH_LOSS_RTOL, each rank's
    ms/step, peak memory and the bytes it holds against the whole; at
    1x2 a rank's peak less its carry in and out falls below one whole
    copy of the params; (b') the config's bfloat16 at 2x1 against 1x1
    at MESH_BF16_RTOL, (b'') at 1x2 at MESH_BF16_SPLIT_RTOL; (c)
    psum_int8 over those ranks on CUDA tensors bit for bit against the
    formula on one rank; (d) the reduced MoE LM at 2x1 against one rank;
    (e) rank 0's FLOPs of a 1x2 step equal the dry run's meta count,
    below the 1x1 count; (f) qwen2-moe-a2.7b and deepseek-v2-lite-16b
    cut to MOE_CUT_LAYERS layers at published widths, float32, the
    dense dispatch: 1x1 bit for bit against the plain step, 1x2 (the
    experts, the shared experts and MLA's heads split) against 1x1, the
    1x2 gate and FLOPs as (b) and (e) hold lm-100m
    (``_mesh_split_checks``); (g) jamba-v0.1-52b cut to one Mamba and one
    attention layer and whisper-small cut to 2 + 2 layers at published
    widths, float32: 1x1 bit for bit against the plain step, 1x2 (the
    Mamba channels; whisper's encoder, self and cross attention split)
    against 1x1, the FLOPs as (e), each rank's peak less its carry
    beside the dry run's (``_mesh_g_checks``); (h) the decode step split
    over the model axis on lm-100m, (f)'s and (g)'s cuts and granite-34b
    cut to one layer (one kv head: the cache across head_dim), float32,
    LM_DECODE_B x LM_DECODE_CTX: MESH_H_STEPS teacher-forced steps at
    1x1 bit for bit against ``make_serve_step``, at 1x2 against 1x1 at
    MESH_LOSS_RTOL, the cache leaves on the model axis halved, the peak
    less the carry below MESH_H_GATE of a copy, the FLOPs as (e)
    (``_mesh_h_checks``).  ``only`` "f", "g" or "h": that check alone.  One card checks ranks that share it, not several
    cards.  None of K1-K5 is on these paths: their counts must stay 0
    in every process."""
    import dataclasses
    import shutil
    import tempfile

    import torch.distributed as dist
    import torch.multiprocessing as mp
    from repro_torch.config import get_config

    t_start = time.perf_counter()
    _k_reset()
    res = {}
    cfg = dataclasses.replace(get_config(LM_ARCH, reduced=LM_REDUCED),
                              dtype="float32")
    tmp = tempfile.mkdtemp(prefix="chip_smoke_mesh_")
    try:
        if only is None:
            plain = _mesh_one_rank(dev, card, cfg, tmp, res)
        h_ones = {} if only in (None, "h") else None
        if only in (None, "f"):
            ones = _mesh_split_one(dev, card, tmp, h_ones)
        if only in (None, "g"):
            g_ones = _mesh_g_one(dev, card, tmp, h_ones)
        if h_ones is not None:
            t0 = time.perf_counter()
            for arch, cut in _mesh_h_cuts(LM_REDUCED).items():
                if arch not in h_ones:
                    with _DrawnOnce():
                        h_ones[arch] = _mesh_h_one(dev, card, tmp, arch,
                                                   cut)
            res["h_one_s"] = time.perf_counter() - t0
        # (b)-(d) and (f)'s and (g)'s 1x2: two ranks sharing the card
        t0 = time.perf_counter()
        pctx = mp.start_processes(
            _mesh_worker, args=(2, f"file://{tmp}/b", tmp, LM_REDUCED,
                                dev.type, only),
            nprocs=2, join=False, start_method="spawn")
        deadline = time.time() + MESH_TIMEOUT
        while not pctx.join(timeout=max(1.0, deadline - time.time())):
            if time.time() > deadline:
                for proc in pctx.processes:
                    proc.kill()
                require(False, f"the 2 ranks did not finish in "
                        f"{MESH_TIMEOUT} s")
        res["ranks_s"] = time.perf_counter() - t0
        ranks = [json.loads(Path(tmp, f"rank{r}.json").read_text())
                 for r in range(2)]
        if only is None:
            _mesh_dense_checks(dev, card, plain, tmp, ranks, res)
        if only in (None, "f"):
            res["split"] = _mesh_split_checks(dev, card, tmp, ranks, ones)
        if only in (None, "g"):
            res["split_g"] = _mesh_g_checks(dev, card, tmp, ranks, g_ones)
        if h_ones is not None:
            res["decode"] = _mesh_h_checks(dev, card, tmp, ranks, h_ones)
        counts = [_k_launches()] + [r["k_launches"] for r in ranks]
        log(f"mesh K1-K5 launches (this process, rank 0, rank 1): {counts}")
        require(all(n == 0 for c in counts for n in c.values()),
                f"a LUT kernel launched on a mesh path: {counts}")
        res["launches"] = counts
    finally:
        if dist.is_initialized():
            dist.destroy_process_group()
        shutil.rmtree(tmp, ignore_errors=True)
    res["seconds"] = time.perf_counter() - t_start
    log(f"mesh phase ({card}) {res['seconds']:.1f} s (the 2 ranks' processes "
        f"{res['ranks_s']:.1f} s)")
    return res


DRY_PEAK_REL = 0.2   # the meta peak within 20 % of the card's


def _dry_cell(cfg, shape, tcfg, dev):
    """One LM cell of the dry run (``launch.dryrun.cost_cell`` on a 1 x 1
    ``CountingMesh``, the meta device) and the same step on the card: the
    dry run's param tree (experts padded to the model axis, 1) drawn on
    the card, ``make_mesh_train_step`` (train) or ``make_mesh_serve_step``
    (decode) over a one-process ``ProcessMesh``, one warm step, then one
    under ``FlopCounterMode`` with the peak memory reset before it.
    Returns the meta analysis and memory, the meta seconds, the card's
    FLOPs, its peak bytes above what was allocated before the cell
    (earlier phases' caches; None off the card), that base, and the
    step's seconds."""
    import gc
    import torch
    from torch.utils.flop_counter import FlopCounterMode
    from repro_torch.config import MeshConfig
    from repro_torch.launch.dryrun import cost_cell
    from repro_torch.models import api
    from repro_torch.models.layers.common import (init_from_spec,
                                                  zeros_from_spec)
    from repro_torch.optim import adamw_init
    from repro_torch.sharding.partition import cache_partition, named
    from repro_torch.sharding.spmd import (ProcessMesh, local_batch,
                                           make_mesh_serve_step,
                                           make_mesh_train_step,
                                           param_shardings)

    mcfg = MeshConfig((1, 1), ("data", "model"))
    t0 = time.perf_counter()
    ana, mem, _, _ = cost_cell(cfg, shape, mcfg, tcfg)
    meta_s = time.perf_counter() - t0
    on_card = dev.type == "cuda"
    base = 0
    if on_card:
        gc.collect()
        torch.cuda.empty_cache()
        base = torch.cuda.memory_allocated(dev)
    mesh = ProcessMesh(mcfg, device=dev)
    gen = torch.Generator(device=dev).manual_seed(0)
    params = init_from_spec(api.param_spec(cfg, model_axis=1), gen,
                            device=dev)
    psh = param_shardings(cfg, params, mesh)
    if shape.kind in ("train", "prefill"):
        batch = api.make_batch(cfg, shape, torch.Generator().manual_seed(0),
                               device=dev)
        step = make_mesh_train_step(cfg, tcfg, mesh, psh, shape)
        args = (params, adamw_init(params),
                local_batch(batch, mesh, cfg, shape))
    else:
        state = zeros_from_spec(api.decode_state_spec(
            cfg, shape.global_batch, shape.seq_len), device=dev)
        csh = named(mesh, cache_partition(cfg, shape, mcfg, state))
        token = torch.zeros((shape.global_batch, 1), dtype=torch.int32,
                            device=dev)
        step = make_mesh_serve_step(cfg, mesh, psh, csh, shape)
        args = (params, state, token)
    del params
    out = step(*args)
    del out
    if on_card:
        torch.cuda.synchronize(dev)
        torch.cuda.reset_peak_memory_stats(dev)
    t1 = time.perf_counter()
    with FlopCounterMode(display=False) as fc:
        out = step(*args)
        if on_card:
            torch.cuda.synchronize(dev)
    step_s = time.perf_counter() - t1
    peak = torch.cuda.max_memory_allocated(dev) - base if on_card else None
    del out, args
    return dict(ana=ana, mem=mem, meta_s=meta_s,
                card_flops=int(fc.get_total_flops()), card_peak=peak,
                base=base, step_s=step_s)


def phase_dryrun(dev, card, lm, moe, edv):
    """The dry run (``repro_torch.launch.dryrun``: one rank's step counted
    on the meta device) against the card, on the LM cells that the LM
    phases timed: lm-100m whole, a bf16 step at LM_B x LM_S and its decode
    at LM_DECODE_B x LM_DECODE_CTX; the qwen2-moe-a2.7b cut at LM_B x
    LM_S; whisper-small whole at ED_TRAIN_B x its max_seq_len with its
    frames.  Per cell on a 1 x 1 mesh: the card's FLOPs
    (``FlopCounterMode`` over one real step) equal the meta count, the
    meta peak (the arguments and the live peak of what the step made) is
    within DRY_PEAK_REL of ``max_memory_allocated``, and the roofline's
    max(t_compute, t_memory) (the H100 figures of ``roofline.analysis``)
    stands beside the ms/step the earlier phase measured.  No LUT kernel
    is on these paths (counts 0)."""
    import dataclasses
    import torch
    from repro_torch.config import ShapeConfig, TrainConfig, get_config
    from repro_torch.roofline.analysis import (HW, model_flops_estimate,
                                               roofline_report)

    t_start = time.perf_counter()
    _k_reset()
    tcfg = TrainConfig(lr=3e-4, sgdr_t0=50)   # the launcher's defaults
    full = get_config(LM_ARCH, reduced=LM_REDUCED)
    moe_full = get_config(MOE_ARCHS[0], reduced=LM_REDUCED)
    wh = get_config(ENCDEC_ARCH, reduced=LM_REDUCED)
    cells = [
        (f"{LM_ARCH} train", full, ShapeConfig("train", "train", LM_S, LM_B),
         lm["profile"]["wall_ms"], "the in-process step, lm (b')"),
        (f"{LM_ARCH} decode", full, ShapeConfig(
            "decode", "decode", LM_DECODE_CTX, LM_DECODE_B),
         lm["decode"]["ms_per_token"], "ms/token, lm (d)"),
        (f"{MOE_ARCHS[0]} x{MOE_CUT_LAYERS} train",
         dataclasses.replace(moe_full, num_layers=MOE_CUT_LAYERS),
         ShapeConfig("train", "train", LM_S, LM_B),
         moe[MOE_ARCHS[0]]["train"]["ms_per_step"],
         "lm (b), over the experts padded to the model axis of 16"),
        (f"{ENCDEC_ARCH} train", wh, ShapeConfig(
            "train", "train", wh.max_seq_len, ED_TRAIN_B),
         edv[ENCDEC_ARCH]["train"]["ms_per_step"], "lm (b)"),
    ]
    res = {"cells": {}}
    for name, cfg, shape, ms_then, what in cells:
        r = _dry_cell(cfg, shape, tcfg, dev)
        ana, mem = r["ana"], r["mem"]
        require(r["card_flops"] == ana.dot_flops,
                f"dryrun {name}: the card's step counts {r['card_flops']} "
                f"FLOPs, the meta count {ana.dot_flops:.0f}")
        meta_peak = mem.peak_memory_in_bytes
        gap = abs(meta_peak - r["card_peak"]) / r["card_peak"]
        require(gap <= DRY_PEAK_REL,
                f"dryrun {name}: meta peak {meta_peak / 2**30:.3f} GiB "
                f"against max_memory_allocated {r['card_peak'] / 2**30:.3f} "
                f"GiB ({gap:.3f} > {DRY_PEAK_REL})")
        rep = roofline_report(
            arch=cfg.name, shape=shape.name, mesh="1x1", num_devices=1,
            analysis=ana, memstats=mem,
            model_flops=model_flops_estimate(cfg, shape),
            bf16_model=cfg.dtype == "bfloat16")
        bound = max(rep.t_compute, rep.t_memory) * 1e3
        res["cells"][name] = dict(
            dot_flops=ana.dot_flops, hbm_bytes=ana.hbm_bytes,
            meta_peak=meta_peak, card_peak=r["card_peak"], peak_gap=gap,
            base=r["base"],
            arguments=mem.argument_size_in_bytes, t_compute_ms=rep.t_compute
            * 1e3, t_memory_ms=rep.t_memory * 1e3, bound_ms=bound,
            measured_ms=ms_then, meta_s=r["meta_s"], step_s=r["step_s"])
        log(f"dryrun {name} ({card}), batch {shape.global_batch} x "
            f"{shape.seq_len}: FLOPs card {r['card_flops']} = meta "
            f"{ana.dot_flops:.0f}; peak meta {meta_peak / 2**30:.3f} GiB "
            f"(arguments {mem.argument_size_in_bytes / 2**30:.3f}) against "
            f"max_memory_allocated {r['card_peak'] / 2**30:.3f} GiB above "
            f"the {r['base'] / 2**30:.3f} GiB allocated before the cell "
            f"({gap:.3f} apart); max(t_compute {rep.t_compute * 1e3:.3f}, "
            f"t_memory {rep.t_memory * 1e3:.3f}) = {bound:.3f} ms against "
            f"{ms_then:.3f} ms measured ({what}); meta count "
            f"{r['meta_s']:.1f} s")
    total = torch.cuda.get_device_properties(dev).total_memory
    launches = _k_launches()
    require(not any(launches.values()), f"the dry run launched a LUT "
            f"kernel: {launches}")
    res["launches"] = launches
    res["seconds"] = time.perf_counter() - t_start
    log(f"dryrun ({card}): Hardware.hbm_bytes {HW.hbm_bytes:.0f} B "
        f"({HW.name}) against the card's total_memory {total} B; K1-K5 "
        f"launches {launches}; phase {res['seconds']:.1f} s")
    return res


def phase_encdec_vlm_lm(dev, card):
    """The encoder-decoder LM (whisper-small, whole) and the VLM
    backbone (qwen2-vl-72b at full width, cut in depth), params drawn on
    the card from seed 0.  None of K1-K5 is on these paths: their counts
    must stay 0."""
    import torch
    from concurrent.futures import ThreadPoolExecutor
    from repro_torch.config import TrainConfig
    from repro_torch.kernels.lut_cascade import lut_cascade
    from repro_torch.kernels.lut_gather import lut_layer, lut_lookup
    from repro_torch.kernels.neuralut_grad import (subnet_train_bwd,
                                                   subnet_train_fwd)
    from repro_torch.kernels.neuralut_mlp import grouped_subnet

    t_start = time.perf_counter()
    wrappers = (lut_cascade, lut_layer, lut_lookup, subnet_train_fwd,
                subnet_train_bwd, grouped_subnet)
    for fn in wrappers:
        fn.launches = 0
    tcfg = TrainConfig(lr=3e-4, sgdr_t0=50)   # the launcher's defaults
    res = {}
    pool, cpu_pool = ThreadPoolExecutor(2), ThreadPoolExecutor(1)
    try:
        for arch, run in ((ENCDEC_ARCH, _whisper), (VLM_ARCH, _vlm)):
            t0 = time.perf_counter()
            res[arch] = run(dev, card, tcfg, pool, cpu_pool)
            res[arch]["seconds"] = time.perf_counter() - t0
            torch.cuda.empty_cache()
    finally:
        pool.shutdown(wait=True)
        cpu_pool.shutdown(wait=True)
    launches = {fn.__name__: fn.launches for fn in wrappers}
    require(not any(launches.values()), f"the enc-dec and VLM paths "
            f"launched a LUT kernel: {launches}")
    res["seconds"] = time.perf_counter() - t_start
    log(f"lm enc-dec/VLM ({card}): K1-K5 launches on the whisper and VLM "
        f"paths {launches}; phase {res['seconds']:.1f} s (whisper "
        f"{res[ENCDEC_ARCH]['seconds']:.1f}, VLM "
        f"{res[VLM_ARCH]['seconds']:.1f})")
    return res


RTL_SAMPLE = 8        # neurons re-simulated per layer (all of the last)


def _rtl_wiring(text: str, idx: int, beta_in: int):
    """Each neuron's source columns, slot 0 first, read back from a
    layer module's address concatenations."""
    import re
    import numpy as np
    rows = {}
    for n, sel in re.findall(rf"rom_l{idx}_n(\d+) u\d+ \(\.clk\(clk\), "
                             r"\.addr\(\{([^}]*)\}\)", text):
        rows[int(n)] = [int(lo) // beta_in for lo in
                        re.findall(r"in_bus\[\d+:(\d+)\]", sel)]
    return np.array([rows[n] for n in range(len(rows))])


def phase_rtl(cfg, served):
    """Verilog of the jsc-5l tables K2 converted on the card in the main
    path, at full width (``core.rtl.generate_top``): every entry of every
    ROM of the last layer and of RTL_SAMPLE neurons of each other layer
    re-simulated (``simulate_verilog_rom``) equals its table; every
    layer's address wiring equals ``conn``; the packed tables unpack to
    the same tables; the LUT graph is refused.  All host time."""
    import shutil
    import tempfile
    import numpy as np
    from repro_torch.config import get_config
    from repro_torch.core import lut_infer as LI
    from repro_torch.core import model as M
    from repro_torch.core import rtl
    from repro_torch.core.nl_config import UnsupportedTopology

    tables, statics, bundle = (served[k] for k in ("tables", "statics",
                                                   "bundle"))
    for i, (t, p) in enumerate(zip(tables, bundle.packed_tables)):
        require(np.array_equal(LI.unpack_tables(p, cfg.beta), t),
                f"layer {i}: the packed tables unpack to other tables")
    out = tempfile.mkdtemp(prefix="chip_smoke_rtl_")
    try:
        t0 = time.perf_counter()
        paths = rtl.generate_top(cfg, tables, statics, out)
        t1 = time.perf_counter()
        mb = sum(Path(p).stat().st_size for p in paths) / 1e6
        checked = 0
        for i, tbl in enumerate(tables):
            text = Path(paths[i]).read_text()
            o, t = tbl.shape
            sample = (range(o) if i == cfg.num_layers - 1 else sorted(
                {int(n) for n in np.linspace(0, o - 1, RTL_SAMPLE)}))
            for n in sample:
                sim = rtl.simulate_verilog_rom(text, f"rom_l{i}_n{n}",
                                               np.arange(t))
                require(np.array_equal(sim, tbl[n]), f"RTL layer {i} ROM "
                        f"{n} differs from its table")
                checked += t
            require(np.array_equal(_rtl_wiring(text, i, cfg.layer_in_bits(i)),
                                   np.asarray(statics[i]["conn"])),
                    f"RTL layer {i}: the address wiring differs from conn")
        t2 = time.perf_counter()
    finally:
        shutil.rmtree(out, ignore_errors=True)
    gcfg = get_config(GRAPH_ARCH)
    gtables = [[np.zeros((nd.width, gcfg.table_size(i)), np.uint16)] *
               nd.arity for i, nd in enumerate(gcfg.nodes)]
    refused = tempfile.mkdtemp(prefix="chip_smoke_rtl_dag_")
    try:
        rtl.generate_top(gcfg, gtables, M.model_static(gcfg), refused)
        require(False, f"{GRAPH_ARCH}: RTL of a LUT DAG was not refused")
    except UnsupportedTopology:
        pass
    finally:
        shutil.rmtree(refused, ignore_errors=True)
    entries = sum(t.size for t in tables)
    log(f"RTL of the K2-converted {cfg.name} tables ({entries} entries): "
        f"{len(paths)} files, {mb:.1f} MB in {t1 - t0:.3f} s of host; "
        f"{checked} entries of {cfg.num_layers} layers' sampled "
        f"ROMs re-simulated equal to the tables and every layer's wiring "
        f"equal to conn in {t2 - t1:.3f} s; {GRAPH_ARCH} refused")
    return dict(files=len(paths), mb=mb, emit_s=t1 - t0, check_s=t2 - t1,
                entries=entries, entries_checked=checked)


EXAMPLE_TIMEOUT = 600


def phase_examples(dev):
    """The port's three examples as a user runs them, each its own
    process on the card: quickstart_torch.py at its defaults,
    jsc_end_to_end_torch.py --epochs 3, and serve_lut_torch.py twice
    against one registry (train and save, then "no retraining").  Each
    must exit 0 with its own checks passed."""
    import shutil
    import tempfile
    from concurrent.futures import ThreadPoolExecutor
    reg = tempfile.mkdtemp(prefix="chip_smoke_examples_")
    serve = ["--device", dev.type, "--epochs", "2", "--requests", "36",
             "--batch", "32", "--registry", reg]
    runs = {"quickstart": ["quickstart_torch.py", "--device", dev.type],
            "jsc_end_to_end": ["jsc_end_to_end_torch.py", "--device",
                               dev.type, "--epochs", "3"],
            "serve_lut (train)": ["serve_lut_torch.py"] + serve}
    checks = {"quickstart": ["exact match: 100.0%", "wrote 3 files"],
              "jsc_end_to_end": ["4000 of 4000 predictions bit-exact",
                                 "cost model:"],
              "serve_lut (train)": ["saved bundle",
                                    "0 of 1152 served predictions differ"],
              "serve_lut (load)": ["no retraining",
                                   "0 of 1152 served predictions differ"]}
    results = {}

    def run(name, argv):
        t0 = time.perf_counter()
        proc = subprocess.run(
            [sys.executable, str(ROOT / "examples" / argv[0])] + argv[1:],
            cwd=ROOT, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
            text=True, timeout=EXAMPLE_TIMEOUT)
        return name, proc, time.perf_counter() - t0

    def check(name, proc, seconds):
        for line in proc.stdout.splitlines()[-8:]:
            log(f"  example {name}| {line}")
        require(proc.returncode == 0, f"example {name} exited "
                f"{proc.returncode}")
        for want in checks[name]:
            require(want in proc.stdout, f"example {name}: no '{want}'")
        results[name] = dict(seconds=seconds)

    def chain(name, argv):   # the second serving run after the first
        done = [run(name, argv)]
        if name == "serve_lut (train)" and done[0][1].returncode == 0:
            done.append(run("serve_lut (load)", ["serve_lut_torch.py"]
                            + serve))
        return done

    try:
        with ThreadPoolExecutor(len(runs)) as pool:
            for done in list(pool.map(lambda kv: chain(*kv), runs.items())):
                for d in done:
                    check(*d)
    finally:
        shutil.rmtree(reg, ignore_errors=True)
    log("examples: " + "; ".join(
        f"{k} exit 0 in {v['seconds']:.1f} s" for k, v in results.items()))
    return results


SHARD_REPLICAS = (1, 2, 3, 4)
SHARD_BATCHES = (1, 7, 256, 4000)


def phase_sharded(cfg, dev, served, graph_served):
    """Sharded serving (``serve.sharded``) of the main path's jsc-5l
    bundle over R = 1-4 logical replicas of the card (more cards where
    the machine has them): both layouts bit-identical to
    ``lut_infer.predict`` at B = 1, 7, 256 and the 4,000 test rows, with
    K1 launches (replicated) and K3 ``lut_layer`` launches (o_sharded)
    counted per call against the plan; ``polylut-add-jsc-5l`` replicated
    bit-identical and o_sharded refused; then the wiring:
    ``LUTServeEngine(sharded=True)`` over the test set,
    ``TableRegistry.load(shard_replicas=4)`` and ``launch.serve
    --sharded`` at its default."""
    import contextlib
    import io
    import tempfile
    import numpy as np
    import torch
    from repro_torch.core import lut_infer as LI
    from repro_torch.core.nl_config import UnsupportedTopology
    from repro_torch.data import jsc_synthetic
    from repro_torch.kernels.lut_cascade import lut_cascade
    from repro_torch.kernels.lut_gather import lut_layer
    from repro_torch.launch import serve as launch_serve
    from repro_torch.serve import LUTServeEngine, TableRegistry
    from repro_torch.serve.sharded import device_budget, make_sharded_forward_fn

    x_te, _ = jsc_synthetic(4000, seed=1)
    cards = torch.cuda.device_count() if dev.type == "cuda" else 1

    def devices(r):
        if dev.type != "cuda":
            return [dev] * r
        return [torch.device("cuda", i % cards) for i in range(r)]

    def want(bundle, x):
        return LI.predict(bundle.cfg, bundle.serve_params(dev), bundle.tables,
                          bundle.statics, torch.as_tensor(x, device=dev)
                          ).cpu().numpy()

    chain, graph = served["bundle"], graph_served["bundle"]
    wants = {b: want(chain, x_te[:b]) for b in SHARD_BATCHES}
    lut_cascade.launches = lut_layer.launches = 0
    t0 = time.perf_counter()
    per_call = {}
    for r in SHARD_REPLICAS:
        for mode in ("replicated", "o_sharded"):
            fwd = make_sharded_forward_fn(chain, devices=devices(r),
                                          mode=mode)
            plan = chain.shard_plan
            for b in SHARD_BATCHES:
                k1, k3 = lut_cascade.launches, lut_layer.launches
                got = fwd(x_te[:b]).cpu().numpy()
                require(np.array_equal(got, wants[b]), f"sharded {mode} "
                        f"R={r} B={b}: predictions differ from predict")
                k1, k3 = lut_cascade.launches - k1, lut_layer.launches - k3
                if dev.type != "cuda":   # the plain versions count none
                    expect = (0, 0)
                elif mode == "replicated":
                    expect = (min(r, b), 0)
                else:
                    expect = (0, sum(hi > lo for blocks in plan.row_blocks
                                     for lo, hi in blocks))
                require((k1, k3) == expect, f"sharded {mode} R={r} B={b}: "
                        f"launches K1 {k1}, K3 {k3}, want {expect}")
                per_call[f"{mode}/R={r}/B={b}"] = dict(k1=k1, k3=k3)
    dag_k1 = lut_cascade.launches
    gwant = want(graph, x_te)
    for r in SHARD_REPLICAS:
        got = make_sharded_forward_fn(graph, devices=devices(r),
                                      mode="replicated")(x_te).cpu().numpy()
        require(np.array_equal(got, gwant), f"{GRAPH_ARCH} replicated R={r}:"
                " predictions differ from predict")
        try:
            make_sharded_forward_fn(graph, devices=devices(r),
                                    mode="o_sharded")
            require(False, f"{GRAPH_ARCH}: o_sharded was not refused")
        except UnsupportedTopology:
            pass
    dag_k1 = lut_cascade.launches - dag_k1

    # the wiring: engine, registry, CLI
    with LUTServeEngine(chain, sharded=True, devices=devices(4)) as eng:
        eng.warmup()
        got = eng.predict(x_te)
        futs = [eng.submit(x) for x in served["requests"]]
        parts = [f.result(timeout=300) for f in futs]
    require(np.array_equal(got, wants[4000]), "LUTServeEngine(sharded=True)"
            " differs from predict")
    require(all(np.array_equal(p, want(chain, x)) for p, x in
                zip(parts, served["requests"])),
            "LUTServeEngine(sharded=True) requests differ from predict")
    with tempfile.TemporaryDirectory(prefix="chip_smoke_sharded_") as root:
        reg = TableRegistry(root)
        reg.save(cfg.name, chain)
        loaded = reg.load(cfg.name, shard_replicas=4)
        arch = cfg.name.removesuffix("-reduced")
        require(loaded.shard_plan is not None
                and loaded.shard_plan.num_replicas == 4
                and loaded.shard_plan.budget_bytes == device_budget(dev),
                f"TableRegistry.load(shard_replicas=4): {loaded.shard_plan}")
        out = io.StringIO()
        with contextlib.redirect_stdout(out):
            res = launch_serve.main([
                "--arch", arch, "--registry", root, "--requests", "40",
                "--device", dev.type, "--sharded"]
                + (["--reduced"] if arch != cfg.name else []))
        text = out.getvalue()
        for line in text.splitlines():
            log(f"  launch.serve --sharded| {line}")
        require("no retraining" in text and res["mismatches"] == 0
                and res["shard_plan"] is not None,
                "launch.serve --sharded: retrained, mismatched or unplanned")
        cli = res["shard_plan"].describe()
    seconds = time.perf_counter() - t0
    launches = {"lut_cascade": lut_cascade.launches - dag_k1,
                "lut_layer": lut_layer.launches}
    require(dev.type != "cuda" or (launches["lut_cascade"] > 0
                                    and launches["lut_layer"] > 0
                                    and dag_k1 > 0),
            f"sharded serving launches {launches}, DAG K1 {dag_k1}")
    log(f"sharded serving: R = {SHARD_REPLICAS} logical replicas over "
        f"{cards} card(s), both layouts bit-identical to predict at B = "
        f"{SHARD_BATCHES}, launches per call as planned; {GRAPH_ARCH} "
        f"replicated bit-identical, o_sharded refused; engine, registry "
        f"(budget {device_budget(dev)} B) and CLI {cli}; launches "
        f"{launches}, DAG K1 {dag_k1}; {seconds:.2f} s")
    return dict(launches=launches, dag_k1=dag_k1, per_call=per_call,
                cards=cards, seconds=seconds, cli=cli)


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
    seed = ensure_hash_seed()
    cmd = " ".join(["python3 chip_smoke.py"] + sys.argv[1:])
    log(f"PYTHONHASHSEED={seed} (replay this run: PYTHONHASHSEED={seed} "
        f"{cmd})")
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

    card = clock(phase_environment)
    clock(phase_build)
    floor = clock(phase_launch_floor, dev)
    k2 = clock(phase_subnet_kernel, cfg, dev)
    k1, tile_sweep = clock(phase_cascade_kernel, cfg, dev)
    k1_dag, dag_sweep, dag_cases = clock(phase_dag_cascade_kernel, dev)
    k3 = clock(phase_gather_kernel, cfg, dev)
    k3l = clock(phase_layer_kernel, cfg, dev)
    launches, served = clock(phase_main_path, cfg, dev)
    stages = clock(phase_convert_stages, cfg, dev)
    layer = clock(phase_layer_serving, cfg, dev, served)
    rtl = clock(phase_rtl, cfg, served)
    graph_launches, graph, graph_served = clock(phase_graph_serving, dev)
    probe = {"before": profiler_probe(dev)}
    stack = clock(phase_serving_stack, dev, card, served, graph_served)
    probe["after"] = clock(profiler_probe, dev)
    log("profiler probe (K4 at O=64 S=1 and a PyTorch control, 5 calls a "
        "trace), short traces before / after the serving stack: " + "; ".join(
            f"{k} {probe['before'][k]} / {probe['after'][k]} of "
            f"{probe['before']['traces']}" for k in ("k4", "control")))
    sharded = clock(phase_sharded, cfg, dev, served, graph_served)
    k4, k5 = clock(phase_train_kernels, cfg, dev)
    shapes = clock(phase_train_shapes, dev)
    train = clock(phase_train_path, cfg, dev)
    seed_k = clock(phase_seed_kernels, cfg, dev)
    ens = clock(phase_ensemble_path, cfg, dev)
    gtrain = clock(phase_graph_train_path, get_config(GRAPH_ARCH), dev)
    kinds = clock(phase_kinds, cfg, dev)
    examples = clock(phase_examples, dev)
    sweep_k = clock(phase_sweep_kernels, dev)
    sweep = clock(phase_sweep, dev)
    lm = clock(phase_lm, dev, card)
    moe = clock(phase_moe_lm, dev, card)
    ssm = clock(phase_ssm_lm, dev, card)
    edv = clock(phase_encdec_vlm_lm, dev, card)
    mesh = clock(phase_mesh, dev, card)
    dry = clock(phase_dryrun, dev, card, lm, moe, edv)

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
                "serving_stack": stack["k1"]["dag"],
                "sharded_serve": sharded["dag_k1"]}
            continue
        k["launches_by_path"] = {
            "serve": launches.get(name, 0),
            "layer_serve": layer["launches_by_name"].get(name, 0),
            "train": train["launches"].get(name, 0),
            "ensemble": ens["launches"].get(name, 0),
            **{f"kind_{kind}": r["launches"][name]
               for kind, r in kinds.items()},
            "sweep": (sweep["serve_launches"] if name == "lut_cascade"
                      else sweep["launches"]).get(name, 0),
            "sharded_serve": sharded["launches"].get(name, 0)}
        k["sweep_shapes"] = {
            "lut_cascade": sweep["k1"], "grouped_subnet": sweep_k["k2"],
            "subnet_train_fwd": sweep_k["train"],
            "subnet_train_bwd": sweep_k["train"]}.get(name)
        if name in ("lut_cascade", "lut_layer"):
            k["sharded_serve"] = {key: sharded[key] for key in (
                "per_call", "cards", "seconds", "cli")}
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
    for k in kernels:   # the dry run's phase: none of K1-K5 is on it
        k["launches_by_path"]["dryrun"] = dry["launches"][k["name"]]
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
    log(f"RTL ({card}): {rtl['mb']:.1f} MB of Verilog emitted in "
        f"{rtl['emit_s']:.3f} s of host, sampled ROMs checked in "
        f"{rtl['check_s']:.3f} s; examples: " + ", ".join(
            f"{k} {v['seconds']:.1f} s" for k, v in examples.items()))
    log(f"lm ({card}): launch.train {lm['train']['ms_per_step']:.3f} ms/step, "
        f"{lm['train']['tokens_per_s']:.0f} tokens/s, peak "
        f"{_gib(lm['train']['peak_mem_gib'])}; in process "
        f"{lm['profile']['wall_ms']:.3f} ms/step, busy share "
        f"{lm['profile']['busy_share']:.4f}; decode "
        f"{lm['decode']['ms_per_token']:.3f} ms/token, "
        f"{lm['decode']['tok_s']:.0f} tok/s; phase {lm['seconds']:.1f} s")
    log("lm MoE: " + "; ".join(
        f"{arch}: train {r['train']['ms_per_step']:.3f} ms/step, "
        f"{r['train']['tokens_per_s']:.0f} tokens/s, peak "
        f"{r['train']['peak_mem_gib']:.3f} GiB, busy share "
        f"{r['train']['busy_share']:.4f}; decode "
        f"{r['decode']['ms_per_token']:.3f} ms/token"
        for arch, r in moe.items() if arch != "seconds")
        + f"; phase {moe['seconds']:.1f} s")
    jam, xl = ssm[SSM_ARCHS[0]], ssm[SSM_ARCHS[1]]
    log(f"lm SSM: {SSM_ARCHS[0]} 2-layer cut train "
        f"{jam['train']['ms_per_step']:.3f} ms/step, "
        f"{jam['train']['tokens_per_s']:.0f} tokens/s, peak "
        f"{jam['train']['peak_mem_gib']:.3f} GiB, busy share "
        f"{jam['train']['busy_share']:.4f}; superblock decode "
        f"{jam['decode']['ms_per_token']:.3f} ms/token; {SSM_ARCHS[1]} "
        f"launch.train {xl['launcher']['ms_per_step']:.3f} ms/step, "
        f"{xl['launcher']['tokens_per_s']:.0f} tokens/s; in process "
        f"{xl['train']['ms_per_step']:.3f} ms/step, busy share "
        f"{xl['train']['busy_share']:.4f}; decode "
        f"{xl['decode']['ms_per_token']:.3f} ms/token; phase "
        f"{ssm['seconds']:.1f} s")
    wh, vl = edv[ENCDEC_ARCH], edv[VLM_ARCH]
    log(f"lm enc-dec/VLM: {ENCDEC_ARCH} train "
        f"{wh['train']['ms_per_step']:.3f} ms/step, "
        f"{wh['train']['tokens_per_s']:.0f} tokens/s, peak "
        f"{wh['train']['peak_mem_gib']:.3f} GiB, busy share "
        f"{wh['train']['busy_share']:.4f}; decode "
        f"{wh['decode']['ms_per_token']:.3f} ms/token (bound "
        f"{wh['decode']['bound_ms']:.3f}); {VLM_ARCH} 2-layer cut prefill "
        f"{vl['prefill_ms']:.3f} ms, {vl['prefill_tok_s']:.0f} tokens/s; "
        f"value_and_grad {vl['grad_ms']:.3f} ms, busy share "
        f"{vl['grad_busy_share']:.4f}, peak {vl['grad_peak_gib']:.3f} GiB; "
        f"decode {vl['decode']['ms_per_token']:.3f} ms/token (bound "
        f"{vl['decode']['bound_ms']:.3f}); phase {edv['seconds']:.1f} s")
    log(f"lm mesh ({card}): 1x1 {mesh['one']['ms_per_step']:.3f} ms/step; "
        + "; ".join(f"{k} (two ranks sharing the card) " + ", ".join(
            f"rank {r['rank']} {r['ms_per_step']:.3f} ms/step"
            for r in mesh[k]["ranks"]) for k in ("2x1", "1x2"))
        + f"; 1x2 peak less the shards "
        + ", ".join(f"{t['transient']} B" for t in mesh["1x2"]["transient"])
        + f"; bfloat16 1x2 {mesh['bf16_1x2']['rel_err']:.3e}; FLOPs at 1x2 "
        f"{mesh['flops']['card']} = meta; (f) " + "; ".join(
            f"{a} 1x2 {r['rel_err']:.3e} from 1x1, ranks "
            + ", ".join(f"{t['ms_per_step']:.3f} ms/step" for t in r["ranks"])
            + f", FLOPs {r['flops']['card']} = meta"
            for a, r in mesh["split"].items())
        + "; (g) " + "; ".join(
            f"{a} 1x2 {r['rel_err']:.3e} from 1x1, ranks "
            + ", ".join(f"{t['ms_per_step']:.3f} ms/step, peak less the "
                        f"shards {t['transient']} B" for t in r["ranks"])
            + f", FLOPs {r['flops']['card']} = meta"
            for a, r in mesh["split_g"].items())
        + f"; phase {mesh['seconds']:.1f} s")
    log(f"dryrun ({card}): " + "; ".join(
        f"{name} bound {c['bound_ms']:.3f} ms against {c['measured_ms']:.3f} "
        f"measured, peak meta {c['meta_peak'] / 2**30:.3f} / card "
        f"{c['card_peak'] / 2**30:.3f} GiB"
        for name, c in dry["cells"].items())
        + f"; phase {dry['seconds']:.1f} s")
    log("sweep over logical replicas of the card: " + "; ".join(
        f"{k} at R = {v['replicas']} {v['seconds']:.3f} s (R = 1: "
        f"{sum(g['seconds_r1'] for g in v['groups']):.3f} s)"
        for k, v in sweep["replicas"].items()))
    log(f"phases ({card}), wall s: " + ", ".join(
        f"{k} {v:.1f}" for k, v in PHASE_S.items())
        + f"; the script {time.perf_counter() - T_START:.1f} s")
    log(card)  # nvidia-smi's "name, power.limit", as it printed them
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
