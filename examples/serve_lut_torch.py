"""End-to-end serving driver on the PyTorch/CUDA port (the paper's
deployment scenario): serve batched classification requests through the
port's LUT engine (``repro_torch.serve``) with latency percentiles,
throughput, queue depth and batch-occupancy metrics.

    PYTHONPATH=src python examples/serve_lut_torch.py --requests 200 \
        --batch 64 [--device cpu]

First run trains once, converts to truth tables, and saves the bundle to
``--registry`` (default results/registry); subsequent runs load the saved
artifact and serve WITHOUT retraining — the software twin of shipping a
bitstream to the FPGA.  Every request goes through integer LUT lookups
only (the LUT-cascade kernel on the card, its plain version with
``--device cpu``), and every served prediction is checked against
``lut_infer.predict``.
"""
import pathlib
import sys

sys.path.insert(0, str(pathlib.Path(__file__).resolve().parents[1] / "src"))

from repro_torch.launch.serve import main  # the launcher is the implementation

if __name__ == "__main__":
    sys.argv += ["--mode", "lut"]
    main()
