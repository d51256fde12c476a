"""Jet substructure tagging end-to-end on the PyTorch/CUDA port: the
paper's JSC-2L model.

    PYTHONPATH=src python examples/jsc_end_to_end_torch.py \
        [--model jsc-5l] [--device cpu]

Full pipeline on the synthetic JSC stand-in through ``repro_torch``: QAT
training (the training kernels on the card) -> truth tables (the
conversion kernel) -> bit-exact check (the LUT-cascade kernel against
``lut_infer.lut_forward``) -> RTL -> cost model vs the paper's reported
numbers.  Runs on CUDA unless ``--device cpu``.
"""
import argparse
import pathlib
import sys

sys.path.insert(0, str(pathlib.Path(__file__).resolve().parents[1] / "src"))

import numpy as np
import torch

from repro_torch.config import get_config
from repro_torch.core import cost_model as CM
from repro_torch.core import lut_infer as LI
from repro_torch.core import model as M
from repro_torch.core import rtl
from repro_torch.core import truth_table as TT
from repro_torch.core.train import train_neuralut
from repro_torch.data import jsc_synthetic
from repro_torch.device import resolve_device
from repro_torch.serve import bundle_from_training, make_forward_fn


def main(argv=None, *, out_dir=None) -> dict:
    ap = argparse.ArgumentParser()
    ap.add_argument("--model", default="jsc-2l", choices=["jsc-2l", "jsc-5l"])
    ap.add_argument("--epochs", type=int, default=25)
    ap.add_argument("--device", default=None, help="cuda (default) or cpu")
    args = ap.parse_args(argv)
    dev = resolve_device(args.device)
    cfg = get_config(f"neuralut-{args.model}")

    xtr, ytr = jsc_synthetic(20000, seed=0)
    xte, yte = jsc_synthetic(4000, seed=1)
    print(f"training {cfg.name}: widths={cfg.layer_widths} beta={cfg.beta} "
          f"F={cfg.fan_in} subnet L={cfg.depth} N={cfg.width} S={cfg.skip}")
    params, state, hist = train_neuralut(cfg, xtr, ytr, xte, yte,
                                         epochs=args.epochs, batch=256,
                                         lr=2e-3, log_every=5, device=dev)

    statics = M.model_static(cfg)
    tables = TT.convert(cfg, params, state, statics)
    codes = LI.input_codes(cfg, params, torch.as_tensor(xte, device=dev))
    out = LI.lut_forward(cfg, tables, statics, codes)
    pred = torch.argmax(LI.class_values(cfg, params, out), -1).cpu().numpy()
    print(f"LUT-path accuracy: {(pred == yte).mean():.4f}")
    # the serving route: the bit-packed tables through the LUT-cascade
    # kernel, held to the lut_forward oracle
    fused = make_forward_fn(bundle_from_training(cfg, params, tables,
                                                 statics), device=dev)
    same = int((fused(xte).cpu().numpy() == pred).sum())
    print(f"LUT cascade == lut_forward: {same} of {len(pred)} predictions "
          f"bit-exact")
    assert same == len(pred)

    outdir = (pathlib.Path(out_dir) if out_dir is not None else
              pathlib.Path(__file__).parent / "out" / f"rtl_{args.model}")
    paths = rtl.generate_top(cfg, tables, statics, str(outdir))
    est = CM.estimate(cfg)
    paper = CM.PAPER_TABLE3[f"neuralut-{args.model}"]
    print(f"cost model: {est.luts:.0f} LUTs (paper {paper['lut']}), "
          f"Fmax {est.fmax_mhz:.0f} MHz (paper {paper['fmax']}), "
          f"latency {est.latency_ns:.1f} ns (paper {paper['latency']}), "
          f"ADP {est.area_delay:.2e} (paper {paper['adp']:.2e})")
    return {"acc": float((pred == yte).mean()), "paths": paths,
            "bit_exact": same == len(pred)}


if __name__ == "__main__":
    main()
