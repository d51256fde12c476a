"""Serving launcher (port of ``repro.launch.serve``).

    python -m repro_torch.launch.serve --arch neuralut-jsc-5l
    python -m repro_torch.launch.serve --arch polylut-add-jsc-5l \\
        --replicas 2
    python -m repro_torch.launch.serve --arch neuralut-jsc-5l \\
        --tenants 3 --swap
    python -m repro_torch.launch.serve --arch neuralut-jsc-2l --reduced \\
        --epochs 1 --device cpu --retrain
    python -m repro_torch.launch.serve --arch neuralut-jsc-5l --sharded

Converted truth tables are a deployable artifact: if ``--registry``
already holds a bundle for the arch, it is loaded (checksums verified)
and served directly — no retraining.  Otherwise the model is trained
once through the port's trainer, converted, saved to the registry, then
served.  Requests go through ``LUTServeEngine`` (``--replicas``
executors over the CUDA devices, each on its own stream; the LUT-cascade
kernel on the card) with a bounded client window (``--inflight``), and
every served prediction is checked against ``lut_infer.predict``.
Reports p50/p95/p99 request latency, throughput, queue depth and batch
occupancy from the engine's metrics.

With ``--sharded`` one executor serves every batch through the cascade
laid out over the device pool (``serve/sharded.py``): one shard per CUDA
device (the CPU with ``--device cpu``), replicated when the packed
tables fit a device's L2, else each layer's neurons split across them.

With ``--tenants N`` N tenants are served through one admission-
controlled ``MultiTenantEngine`` (tenant 0 is the registry bundle; the
others are same-geometry variants with random tables, rate-limited by
``--rate-limit``); ``--swap`` then hot-swaps tenant 0 onto a re-packed
copy of its bundle under live traffic and prints the ``SwapReport``.

Takes the JSC chains (``neuralut-jsc-*``) and the PolyLUT-Add graphs
(``polylut-add-jsc-*``).  Runs on CUDA unless ``--device cpu``.

``--mode lm`` decodes with an LM (``--arch``, default lm-100m, in
its reduced form as the reference's): seeded init, a zero decode state
of context 128 for ``--batch`` sequences (whisper-small's cross K/V
zeros too, as the reference's), and ``--requests`` greedy
decode steps through ``make_serve_step``; prints ms/token and tok/s.

    python -m repro_torch.launch.serve --mode lm --device cpu
"""
from __future__ import annotations

import argparse
import threading
from collections import deque
from typing import Any, Dict, Optional, Sequence

import numpy as np



def build_lut_bundle(args):
    """Load the serving bundle from the registry, or train, convert and
    save it once if absent (or ``--retrain``)."""
    from repro_torch.config import get_config, list_archs
    from repro_torch.core import model as M
    from repro_torch.core import truth_table as TT
    from repro_torch.core.train import train_neuralut
    from repro_torch.data import device_dataset, jsc_synthetic
    from repro_torch.device import resolve_device
    from repro_torch.serve import TableRegistry, bundle_from_training

    if args.arch not in list_archs():
        raise SystemExit(f"--arch {args.arch}: unknown; the NeuraLUT archs "
                         f"are {', '.join(list_archs())}")
    cfg = get_config(args.arch, reduced=args.reduced)
    if getattr(cfg, "in_features", None) != 16:
        raise SystemExit(f"--mode lut expects a JSC NeuraLUT config, got "
                         f"'{args.arch}'")
    reg = TableRegistry(args.registry) if args.registry else None

    if reg is not None and reg.has(cfg.name) and not args.retrain:
        bundle = reg.load(cfg.name)
        # The integrity block is per-array digests — load() just
        # verified them; print only the human-facing meta.
        meta = {k: v for k, v in bundle.meta.items() if k != "integrity"}
        verified = "integrity verified, " if "integrity" in bundle.meta \
            else ""
        print(f"loaded bundle '{cfg.name}' from {args.registry} "
              f"({verified}tables: {bundle.num_table_bytes / 1024:.1f} KiB, "
              f"meta: {meta}) — no retraining", flush=True)
        return bundle

    dev = resolve_device(args.device)
    xtr, ytr = device_dataset(jsc_synthetic, 20000, seed=0, device=dev)
    xte, yte = device_dataset(jsc_synthetic, 4000, seed=1, device=dev)
    print(f"training {cfg.name} ...", flush=True)
    params, state, hist = train_neuralut(
        cfg, xtr, ytr, xte, yte, epochs=args.epochs, batch=256, lr=2e-3,
        log_every=max(1, args.epochs // 4), device=dev)
    statics = M.model_static(cfg)
    # The conversion emits bit-packed tables: the bundle is serving-ready
    # without a prepack pass.
    tables, packed = TT.convert_packed(cfg, params, state, statics)
    acc_q = float(hist["test_acc_q"][-1])
    print(f"accuracy (quantized): {acc_q:.4f}", flush=True)
    bundle = bundle_from_training(cfg, params, tables, statics,
                                  packed_tables=packed,
                                  meta={"train_acc_q": acc_q})
    if reg is not None:
        path = reg.save(cfg.name, bundle)
        print(f"saved bundle -> {path}", flush=True)
    return bundle


def _want(bundle, x: np.ndarray, device) -> np.ndarray:
    """``lut_infer.predict`` of a bundle: the oracle every served
    prediction is held to."""
    import torch

    from repro_torch.core import lut_infer as LI
    return LI.predict(bundle.cfg, bundle.serve_params(device),
                      bundle.tables, bundle.statics,
                      torch.as_tensor(x, device=device)).cpu().numpy()


def _check(what: str, got: np.ndarray, want: np.ndarray) -> int:
    bad = int((got != want).sum())
    print(f"{what}: {bad} of {len(want)} served predictions differ from "
          f"lut_infer.predict", flush=True)
    if bad:
        raise RuntimeError(f"{what}: {bad} served predictions differ from "
                           "lut_infer.predict")
    return bad


def serve_lut(args) -> Dict[str, Any]:
    from repro_torch.data import jsc_synthetic
    from repro_torch.serve import LUTServeEngine

    bundle = build_lut_bundle(args)
    xte, yte = jsc_synthetic(4000, seed=1)
    with LUTServeEngine(bundle, max_wait_ms=args.max_wait_ms,
                        replicas=args.replicas, device=args.device,
                        sharded=args.sharded) as eng:
        eng.warmup()
        if args.sharded:
            print(f"sharded: {bundle.shard_plan.describe()}", flush=True)
        rng = np.random.default_rng(0)
        # Bounded in-flight window: enough concurrency to exercise the
        # batcher, without an unbounded burst whose latency percentiles
        # would measure the client's own backlog.
        idx_all, preds = [], []
        pending: "deque" = deque()

        def drain_one():
            idx, fut = pending.popleft()
            idx_all.append(idx)
            preds.append(fut.result())

        for _ in range(args.requests):
            idx = rng.integers(0, len(xte), args.batch)
            pending.append((idx, eng.submit(xte[idx])))
            if len(pending) >= args.inflight:
                drain_one()
        while pending:
            drain_one()
    idx, got = np.concatenate(idx_all), np.concatenate(preds)
    acc = float((got == yte[idx]).mean())
    print(f"served {args.requests} requests x batch {args.batch} "
          f"(inflight {args.inflight}): {eng.metrics.render()} "
          f"acc={acc:.4f}", flush=True)
    if eng.replicas > 1:
        for i, m in enumerate(eng.replica_metrics):
            print(f"  replica {i}: {m.render()}", flush=True)
    mismatches = _check("serve", got, _want(bundle, xte[idx], eng.device))
    return {"bundle": bundle, "metrics": eng.metrics.report(),
            "replica_batches": [m.report()["batches"]
                                for m in eng.replica_metrics],
            "forwards": eng.forwards, "acc": acc, "mismatches": mismatches,
            "shard_plan": bundle.shard_plan if args.sharded else None}


def _copy_statics(statics):
    return [{k: ([a.copy() for a in v] if isinstance(v, list) else v.copy())
             for k, v in s.items()} for s in statics]


def _variant(bundle, rng):
    """A same-geometry bundle with fresh random tables: a distinct
    customer's payload that still packs into the primary's group."""
    from repro_torch.serve import ServeBundle

    def rand(t):
        return rng.integers(0, 2 ** bundle.cfg.beta, t.shape).astype(t.dtype)
    return ServeBundle(
        cfg=bundle.cfg,
        tables=[[rand(t) for t in n] if isinstance(n, list) else rand(n)
                for n in bundle.tables],
        statics=_copy_statics(bundle.statics),
        in_log_s=bundle.in_log_s.copy(),
        layer_log_s=[s.copy() for s in bundle.layer_log_s])


def _repacked(bundle):
    """A distinct bundle with byte-identical operands, packed anew: what
    a re-converted redeploy of the same model looks like."""
    from repro_torch.serve import ServeBundle
    return ServeBundle(
        cfg=bundle.cfg,
        tables=[[t.copy() for t in n] if isinstance(n, list) else n.copy()
                for n in bundle.tables],
        statics=_copy_statics(bundle.statics),
        in_log_s=bundle.in_log_s.copy(),
        layer_log_s=[s.copy() for s in bundle.layer_log_s])


def serve_tenants(args) -> Dict[str, Any]:
    """N tenants behind one MultiTenantEngine: tenant 0 serves the
    registry bundle; tenants 1..N-1 get same-geometry variants."""
    from repro_torch.data import jsc_synthetic
    from repro_torch.serve import MultiTenantEngine, Tenant, TenantOverloaded

    bundle = build_lut_bundle(args)
    xte, _ = jsc_synthetic(4000, seed=1)
    rng = np.random.default_rng(7)
    tenants = [Tenant("primary", bundle, priority=1)]
    for i in range(1, args.tenants):
        tenants.append(Tenant(f"tenant{i}", _variant(bundle, rng),
                              rate_limit=args.rate_limit or None))
    served = {t.name: ([], []) for t in tenants}
    shed = 0
    report = None
    with MultiTenantEngine(tenants, max_wait_ms=args.max_wait_ms,
                           device=args.device) as eng:
        eng.warmup()
        print(f"{len(tenants)} tenants -> {eng.num_groups} geometry "
              f"group(s), one forward each", flush=True)
        for r in range(args.requests):
            name = tenants[r % len(tenants)].name
            idx = rng.integers(0, len(xte), args.batch)
            try:
                got = eng.predict(name, xte[idx])
            except TenantOverloaded as e:
                shed += 1
                print(f"  shed: {e}", flush=True)
                continue
            served[name][0].append(idx)
            served[name][1].append(got)
        for t in tenants:
            m = eng.tenant_metrics(t.name)
            print(f"  {t.name}: {m.render()} shed={m.shed} "
                  f"shed_rate={m.shed_rate:.2f}", flush=True)
        if args.swap:
            stop = threading.Event()

            def traffic():
                while not stop.is_set():
                    eng.predict("primary", xte[:args.batch])

            th = threading.Thread(target=traffic, daemon=True)
            th.start()
            try:
                report = eng.swap("primary", _repacked(bundle),
                                  shadow_samples=64, timeout_s=60.0)
            finally:
                stop.set()
                th.join(timeout=60)
            print(f"swap: status={report.status} states={report.states} "
                  f"shadow={report.shadow_samples} "
                  f"mismatches={report.mismatches} "
                  f"swap={report.swap_latency_s * 1e3:.1f}ms "
                  f"cutover={report.cutover_latency_s * 1e3:.2f}ms",
                  flush=True)
    mismatches = 0
    for t in tenants:
        idx, got = served[t.name]
        if idx:
            idx = np.concatenate(idx)
            mismatches += _check(f"tenant {t.name}", np.concatenate(got),
                                 _want(t.bundle, xte[idx], eng.device))
    if report is not None and report.status != "committed":
        raise SystemExit(f"hot swap failed: {report.error}")
    return {"tenants": len(tenants), "groups": eng.num_groups,
            "shed": shed, "mismatches": mismatches, "swap": report,
            "forwards": eng.forwards}


def serve_lm(args) -> Dict[str, Any]:
    """Greedy decode of the reduced LM: ``args.requests`` steps of a
    batch of ``args.batch`` from token 1, context 128, from a zero state
    (the reference's: whisper's decoder attends to zero cross K/V)."""
    import time

    import torch
    from repro_torch.config import get_config, list_lm_archs
    from repro_torch.device import resolve_device
    from repro_torch.models import api
    from repro_torch.models.layers.common import zeros_from_spec
    from repro_torch.train.step import make_serve_step

    if args.arch not in list_lm_archs():
        raise SystemExit(f"--arch {args.arch}: unknown to --mode lm; the "
                         f"LM archs are {', '.join(list_lm_archs())}")
    dev = resolve_device(args.device)
    cfg = get_config(args.arch, reduced=True)
    params = api.init_params(cfg, torch.Generator().manual_seed(0),
                             device=dev)
    bsz, ctx = args.batch, 128
    state = zeros_from_spec(api.decode_state_spec(cfg, bsz, ctx),
                            device=dev)
    step = make_serve_step(cfg)
    tok = torch.ones((bsz, 1), dtype=torch.int32, device=dev)
    n = args.requests
    t0 = time.perf_counter()
    for _ in range(n):
        logits, state = step(params, state, tok)
        tok = (torch.argmax(logits, -1).to(torch.int32)[:, None]
               % cfg.vocab_size)
    tok = tok.cpu()  # waits for the last step
    dt = time.perf_counter() - t0
    print(f"decoded {n} steps x batch {bsz}: {dt / n * 1e3:.2f} ms/token, "
          f"{n * bsz / dt:.0f} tok/s", flush=True)
    return {"steps": n, "batch": bsz, "ms_per_token": dt / n * 1e3,
            "tok_s": n * bsz / dt, "last_tokens": tok}


def parse_args(argv: Optional[Sequence[str]] = None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--mode", default="lut", choices=["lut", "lm"])
    ap.add_argument("--arch", default=None,
                    help="default neuralut-jsc-2l (lut) or lm-100m (lm)")
    ap.add_argument("--reduced", action="store_true")
    ap.add_argument("--batch", type=int, default=64)
    ap.add_argument("--requests", type=int, default=200)
    ap.add_argument("--epochs", type=int, default=20)
    ap.add_argument("--registry", default="results/registry",
                    help="bundle store dir; '' disables persistence")
    ap.add_argument("--retrain", action="store_true",
                    help="retrain even if a registry bundle exists")
    ap.add_argument("--max-wait-ms", type=float, default=2.0,
                    help="dynamic batcher admission window")
    ap.add_argument("--inflight", type=int, default=4,
                    help="max outstanding requests in the client loop")
    ap.add_argument("--kernel", action="store_true",
                    help="not taken: the port always serves through the "
                         "LUT-cascade kernel on the card")
    ap.add_argument("--replicas", type=int, default=1,
                    help="replica executors to route batches across "
                         "(over the CUDA devices, round-robin)")
    ap.add_argument("--sharded", action="store_true",
                    help="serve through the cascade laid out over the "
                         "devices (repro_torch.serve.sharded) instead of "
                         "replica routing")
    ap.add_argument("--tenants", type=int, default=0,
                    help="serve N tenants through one MultiTenantEngine")
    ap.add_argument("--rate-limit", type=float, default=0.0,
                    help="requests/s token-bucket for the secondary "
                         "tenants (0 = unlimited)")
    ap.add_argument("--swap", action="store_true",
                    help="with --tenants: hot-swap tenant 0 onto a "
                         "re-packed redeploy under live traffic")
    ap.add_argument("--device", default=None,
                    help="cuda (default) or cpu")
    return ap.parse_args(argv)


def main(argv: Optional[Sequence[str]] = None) -> Dict[str, Any]:
    args = parse_args(argv)
    if args.mode == "lm":
        args.arch = args.arch or "lm-100m"
        return serve_lm(args)
    args.arch = args.arch or "neuralut-jsc-2l"
    if args.kernel:
        raise SystemExit("--kernel: the port has no route to force; it "
                         "serves through the LUT-cascade kernel (K1) on "
                         "the card and its plain version on the CPU")
    if args.tenants:
        return serve_tenants(args)
    return serve_lut(args)


if __name__ == "__main__":
    main()
