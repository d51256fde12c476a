"""The port's package rules: it imports neither jax nor the JAX package,
builds nothing at import, and runs on the card unless asked for the
CPU (no quiet CPU fallback)."""
import os
import re
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

# Small shapes: one intra-op thread keeps these tests from loading the
# CPU that the other test workers share.
torch.set_num_threads(1)

ROOT = Path(__file__).resolve().parents[1]
PKG = ROOT / "src" / "repro_torch"
FORBIDDEN = re.compile(r"^\s*(from|import)\s+(jax|repro)(\.|\s|$)", re.M)


def test_imports_with_jax_and_repro_blocked():
    code = (
        "import sys, pkgutil, importlib\n"
        "sys.modules['jax'] = None\n"
        "sys.modules['repro'] = None\n"
        "import repro_torch\n"
        "names = [m.name for m in pkgutil.walk_packages("
        "repro_torch.__path__, 'repro_torch.')]\n"
        "for n in names:\n"
        "    importlib.import_module(n)\n"
        "from repro_torch.kernels import build\n"
        "assert build._lib is None, 'a kernel was built at import'\n"
        "bad = [m for m in sys.modules if m == 'triton'"
        " or m.startswith(('jax.', 'repro.'))]\n"
        "assert not bad, bad\n"
        "print(' '.join(names))\n")
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"))
    out = subprocess.run([sys.executable, "-c", code], env=env, cwd=ROOT,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr
    names = set(out.stdout.split())
    assert len(names) >= 20
    # the training slice's modules are among those imported
    assert {"repro_torch.optim.adamw", "repro_torch.optim.schedule",
            "repro_torch.kernels.neuralut_grad", "repro_torch.core.train",
            "repro_torch.data.pipeline", "repro_torch.launch.train",
            "repro_torch.tree"} <= names
    # and the per-layer serving slice's
    assert "repro_torch.kernels.lut_gather" in names
    # and the serving stack's
    assert {"repro_torch.checkpoint.store", "repro_torch.runtime.chaos",
            "repro_torch.runtime.fault", "repro_torch.serve.registry",
            "repro_torch.serve.engine", "repro_torch.serve.tenants",
            "repro_torch.launch.serve", "repro_torch.config.base"} <= names
    # and the sweep's
    assert {"repro_torch.sweep", "repro_torch.sweep.plan",
            "repro_torch.sweep.runner", "repro_torch.launch.sweep",
            "repro_torch.core.cost_model", "repro_torch.runtime.straggler",
            "repro_torch.runtime.tracker"} <= names


def test_no_source_imports_jax_or_repro():
    files = sorted(PKG.rglob("*.py")) + [ROOT / "chip_smoke.py"]
    assert len(files) > 20
    for f in files:
        assert not FORBIDDEN.search(f.read_text()), f


def test_device_none_means_cuda_and_raises_without_it(monkeypatch):
    from repro_torch.config import get_config
    from repro_torch.core import model as M
    from repro_torch.device import resolve_device
    from repro_torch.serve import LUTServeEngine, bundle_from_training
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    cfg = get_config("neuralut-jsc-2l", reduced=True)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        resolve_device(None)
    with pytest.raises(RuntimeError, match="no CUDA"):
        M.model_init(cfg, torch.Generator().manual_seed(0))
    p, _ = M.model_init(cfg, torch.Generator().manual_seed(0),
                        device="cpu")
    tables = [np.zeros((o, cfg.table_size(i)), np.uint16)
              for i, o in enumerate(cfg.layer_widths)]
    bundle = bundle_from_training(cfg, p, tables, M.model_static(cfg))
    with pytest.raises(RuntimeError, match="no CUDA"):
        LUTServeEngine(bundle)
    assert resolve_device("cpu").type == "cpu"
