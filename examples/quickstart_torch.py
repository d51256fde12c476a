"""Quickstart on the PyTorch/CUDA port: the whole NeuraLUT toolflow in
one minute on a toy task.

    PYTHONPATH=src python examples/quickstart_torch.py [--device cpu]

Trains a tiny NeuraLUT network on the two-semicircles task (paper Fig. 3)
through ``repro_torch`` (on the card the training kernels run every
step), converts every sub-network into an L-LUT truth table (the
conversion kernel), verifies the LUT network is bit-exact against the
quantized model, and emits Verilog RTL.  Runs on CUDA unless
``--device cpu``.
"""
import argparse
import pathlib
import sys

sys.path.insert(0, str(pathlib.Path(__file__).resolve().parents[1] / "src"))

import torch

from repro_torch.core import lut_infer as LI
from repro_torch.core import model as M
from repro_torch.core import rtl, cost_model
from repro_torch.core import truth_table as TT
from repro_torch.core.nl_config import NeuraLUTConfig
from repro_torch.core.train import train_neuralut
from repro_torch.data import two_semicircles
from repro_torch.device import resolve_device


def main(argv=None, *, epochs: int = 30, out_dir=None) -> dict:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--device", default=None, help="cuda (default) or cpu")
    args = ap.parse_args(argv)
    dev = resolve_device(args.device)
    cfg = NeuraLUTConfig(
        name="quickstart", in_features=2, layer_widths=(8, 2),
        num_classes=2, beta=3, fan_in=2,
        kind="subnet", depth=4, width=8, skip=2,  # N_net: L=4, N=8, S=2
    )
    xtr, ytr = two_semicircles(2000, seed=0)
    xte, yte = two_semicircles(500, seed=1)

    print("1) quantization-aware training (AdamW + SGDR) ...")
    params, state, hist = train_neuralut(cfg, xtr, ytr, xte, yte,
                                         epochs=epochs, batch=128, lr=5e-3,
                                         device=dev)
    print(f"   test accuracy (quantized path): {hist['test_acc_q'][-1]:.3f}")

    print("2) sub-network -> L-LUT conversion ...")
    statics = M.model_static(cfg)
    tables = TT.convert(cfg, params, state, statics)
    for i, t in enumerate(tables):
        print(f"   layer {i}: {t.shape[0]} L-LUTs x {t.shape[1]} entries "
              f"(2^{cfg.layer_in_bits(i)*cfg.layer_fan_in(i)})")

    print("3) bit-exactness check (hardware path == quantized model) ...")
    x = torch.as_tensor(xte, device=dev)
    _, values, _ = M.model_apply(cfg, params, state,
                                 M.device_statics(statics, dev), x,
                                 train=False)
    codes = LI.input_codes(cfg, params, x)
    lut_vals = LI.class_values(cfg, params,
                               LI.lut_forward(cfg, tables, statics, codes))
    exact = float((values == lut_vals).float().mean())
    print(f"   exact match: {exact*100:.1f}%")
    assert exact == 1.0

    print("4) Verilog RTL generation ...")
    out = (pathlib.Path(out_dir) if out_dir is not None else
           pathlib.Path(__file__).parent / "out" / "quickstart_rtl")
    paths = rtl.generate_top(cfg, tables, statics, str(out))
    est = cost_model.estimate(cfg)
    print(f"   wrote {len(paths)} files to {out}")
    print(f"   modeled cost: {est.luts:.0f} LUTs @ {est.fmax_mhz:.0f} MHz, "
          f"latency {est.latency_ns:.1f} ns ({est.layers} cycles)")
    return {"exact": exact, "paths": paths,
            "test_acc_q": hist["test_acc_q"][-1]}


if __name__ == "__main__":
    main()
