"""The linear kind's group gradients at init against one unit's, leaf by
leaf, with the plain einsum and with the float64 row sums.

    python3 probes/linear_grads.py [--device cuda]

Takes the paper grid's first LogicNets group (two points x 3 seeds, U =
6 units) on the first 256 rows of ``mnist_pooled`` and computes each
unit's loss gradient at init the way the group step does (``torch.func.
vmap`` of ``grad`` over the unit axis), for the first U = 1, 3 and 6
units of the stack, every unit on the same batch.  Each unit's gradient
at U > 1 is compared with the same unit's gradient computed alone (U =
1), leaf by leaf: the number of leaves and elements that differ and the
largest difference.  It does so twice: with ``subnet.linear_apply`` as
the plain einsum (``einsum("bof,of->bo") + b``, whose weight and bias
gradients sum the batch rows in float32) and as the port has it (those
sums in float64, ``subnet._NeuronDot``).  Prints one JSON line per
variant; exits 1 if the port's variant differs anywhere.
"""
from __future__ import annotations

import argparse
import json
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
UNITS = (1, 3, 6)
BATCH = 256


def _chip_smoke():
    """``chip_smoke`` from the checkout's root (its helpers walk the
    trees and take the group's gradients)."""
    if str(ROOT) not in sys.path:
        sys.path.insert(0, str(ROOT))
    import chip_smoke
    return chip_smoke


def plain_linear_apply(p, x):
    import torch
    return torch.einsum("bof,of->bo", x, p["w"]) + p["b"]


def _slice(tree, lo, hi):
    import torch
    if isinstance(tree, dict):
        return {k: _slice(v, lo, hi) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return [_slice(v, lo, hi) for v in tree]
    return tree[lo:hi] if isinstance(tree, torch.Tensor) else tree


def readings(dev, group, x, y):
    import torch
    from repro_torch.sweep import stack_group_operands
    C = _chip_smoke()

    params, state, _, statics, _ = stack_group_operands(group, x, device=dev)
    xb, yb = x[:BATCH], y[:BATCH]

    def grads(lo, hi):
        u = hi - lo
        return C._first_grads(group.padded_cfg, _slice(params, lo, hi),
                              _slice(state, lo, hi), _slice(statics, lo, hi),
                              xb.expand(u, *xb.shape), yb.expand(u, *yb.shape),
                              dev)

    alone = [C._paths(grads(i, i + 1)) for i in range(max(UNITS))]
    out = {}
    for u in UNITS:
        got = C._paths(grads(0, u))
        leaves, elems, worst, first = set(), 0, 0.0, None
        for i in range(u):
            for (path, g), (_, a) in zip(got, alone[i]):
                ne = g[i] != a[0]
                if bool(ne.any()):
                    leaves.add(path)
                    elems += int(ne.sum())
                    worst = max(worst, float((g[i] - a[0]).abs().max()))
                    if first is None:
                        j = int(ne.flatten().nonzero()[0])
                        first = (f"unit {i} {path}[{j}] "
                                 f"{float(g[i].flatten()[j])!r} vs "
                                 f"{float(a[0].flatten()[j])!r}")
        out[f"U={u}"] = dict(leaves=len(leaves), of=len(got),
                             elements=elems, max_abs=worst, first=first,
                             which=sorted(leaves)[:8])
    return out


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args()
    sys.path.insert(0, str(ROOT / "src"))
    import torch
    from repro_torch.core import subnet
    from repro_torch.data import device_dataset, mnist_pooled
    from repro_torch.sweep import paper_sweep_points, plan_sweep

    C = _chip_smoke()
    dev = torch.device(args.device)
    if dev.type == "cpu":
        torch.set_num_threads(1)
    x, y = device_dataset(mnist_pooled, C.SWEEP_ROWS[0], seed=0, device=dev)
    groups = plan_sweep(paper_sweep_points(), seeds=C.SWEEP_SEEDS)
    group = next(g for g in groups if g.padded_cfg.kind == "linear"
                 and g.num_units >= max(UNITS))
    ok = True
    port = subnet.linear_apply
    for name, fn in (("plain einsum", plain_linear_apply),
                     ("float64 row sums", port)):
        subnet.linear_apply = fn
        try:
            r = readings(dev, group, x, y)
        finally:
            subnet.linear_apply = port
        print("READING " + json.dumps({"variant": name, "device": str(dev),
                                       "group": [p.name for p in group.points],
                                       **r}), flush=True)
        if fn is port:
            ok = all(v["elements"] == 0 for v in r.values())
    if dev.type == "cuda":
        print(torch.cuda.get_device_name(0), flush=True)
    return 0 if ok else 1


if __name__ == "__main__":
    sys.exit(main())
