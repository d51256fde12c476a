"""The port's three examples on the CPU at their smallest size:
``examples/quickstart_torch.py`` (train -> convert -> bit-exact -> RTL
-> cost), ``examples/jsc_end_to_end_torch.py --epochs 1`` and
``examples/serve_lut_torch.py`` twice against one registry (the second
run loads the bundle: "no retraining").  Each prints its bit-exact line;
the RTL goes to a temporary directory."""
import runpy
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

from repro_torch.core import rtl

torch.set_num_threads(1)

EXAMPLES = Path(__file__).resolve().parents[1] / "examples"


def _module(name):
    return runpy.run_path(str(EXAMPLES / f"{name}.py"))


def test_quickstart_torch(tmp_path, capsys):
    res = _module("quickstart_torch")["main"](
        ["--device", "cpu"], epochs=2, out_dir=tmp_path)
    out = capsys.readouterr().out
    assert "   exact match: 100.0%" in out and res["exact"] == 1.0
    assert len(res["paths"]) == 3 and "module neuralut_top" in \
        Path(res["paths"][-1]).read_text()
    for step in ("1) quantization-aware training", "2) sub-network -> L-LUT",
                 "3) bit-exactness check", "4) Verilog RTL generation",
                 "modeled cost:"):
        assert step in out


def test_jsc_end_to_end_torch(tmp_path, capsys):
    res = _module("jsc_end_to_end_torch")["main"](
        ["--device", "cpu", "--epochs", "1"], out_dir=tmp_path)
    out = capsys.readouterr().out
    assert "LUT cascade == lut_forward: 4000 of 4000 predictions " \
        "bit-exact" in out and res["bit_exact"]
    assert "LUT-path accuracy:" in out and "cost model:" in out
    assert [Path(p).name for p in res["paths"]] == \
        ["layer0.v", "layer1.v", "top.v"]
    text = Path(res["paths"][1]).read_text()
    assert rtl.simulate_verilog_rom(text, "rom_l1_n0", np.arange(4)).shape \
        == (4,)


@pytest.mark.parametrize("run", ["train_and_save", "load_no_retraining"])
def test_serve_lut_torch(run, tmp_path, capsys, monkeypatch):
    argv = ["serve_lut_torch.py", "--device", "cpu", "--reduced",
            "--epochs", "1", "--requests", "12", "--batch", "16",
            "--registry", str(tmp_path)]
    runs = 2 if run == "load_no_retraining" else 1
    for _ in range(runs):
        monkeypatch.setattr(sys, "argv", list(argv))
        runpy.run_path(str(EXAMPLES / "serve_lut_torch.py"),
                       run_name="__main__")
    out = capsys.readouterr().out
    assert "serve: 0 of 192 served predictions differ from " \
        "lut_infer.predict" in out
    assert ("no retraining" in out) == (run == "load_no_retraining")
    assert "saved bundle" in out
