"""FPGA cost/latency model (a copy of ``repro.core.cost_model``; no
Vivado is run).

P-LUT count: a beta_in*F-input, 1-bit ROM on a 6-LUT + F7/F8-mux fabric
(xcvu9p) costs

    rom_cost(n) = 1                          n <= 6
                = 2 (+F7)                    n == 7
                = 4 (+F7/F8)                 n == 8
                = 4*2^{n-8} + mux_tree       n >  8   (4:1 LUT muxes above F8)

Total = sum over neurons * beta output bits * rom_cost * k_simplify, where
k_simplify models synthesis logic optimization.  The paper observes complex
functions simplify *less* (§IV-A.2); we calibrate k per neuron kind against
the paper's own Table III (NeuraLUT 0.70, PolyLUT 0.80, LogicNets 0.45) and
report absolute counts as MODELED, comparisons as ratios.

Fmax model fitted on Table III designs (R^2 ~ 0.97 across the 5 LUT-based
rows): Fmax[MHz] ~= 1745 - 83.5 * log2(LUTs), clipped to [200, 800].
Latency = n_layers / Fmax (one cycle per L-LUT layer — paper §IV-A.2);
area-delay product = LUTs * latency.
"""
from __future__ import annotations

import math
from dataclasses import dataclass

from repro_torch.core.nl_config import is_graph_config

K_SIMPLIFY = {"subnet": 0.70, "poly": 0.80, "linear": 0.45}


def rom_cost(n_inputs: int) -> float:
    n = n_inputs
    if n <= 6:
        return 1.0
    if n == 7:
        return 2.0
    if n == 8:
        return 4.0
    blocks = 2 ** (n - 8)          # 8-input (4xLUT6+F7F8) blocks
    mux = math.ceil((blocks - 1) / 3.0)  # 4:1 mux tree in LUT6s
    return 4.0 * blocks + mux


@dataclass
class HwEstimate:
    luts: float
    fmax_mhz: float
    latency_ns: float
    area_delay: float
    layers: int


def estimate(cfg) -> HwEstimate:
    """Model ``cfg`` — a chain (``NeuraLUTConfig``) or LUT DAG
    (``LUTGraphConfig``).  For a DAG each node costs one ROM per branch
    (PolyLUT-Add arXiv:2406.04910: A ROMs + an A-input adder replace one
    2^{A*beta*F}-entry ROM), the adder tree costs its full output width
    in carry LUTs per neuron (adders do not logic-simplify, so no
    ``k``), and latency counts *pipeline levels on the critical path*
    (longest input->output node chain) rather than node count — parallel
    DAG branches cost area, not cycles."""
    k = K_SIMPLIFY.get(cfg.kind, 0.7)
    luts = 0.0
    if is_graph_config(cfg):
        depth = {0: 0}  # buffer index -> pipeline level
        for i, nd in enumerate(cfg.nodes):
            n_in = cfg.node_in_bits(i) * nd.fan_in
            luts += nd.width * cfg.beta * rom_cost(n_in) * k * nd.arity
            if nd.arity > 1:
                luts += nd.width * (nd.arity - 1) * cfg.node_out_bits(i)
            depth[i + 1] = 1 + max(depth[s] for s in cfg.node_sources(i))
        levels = depth[len(cfg.nodes)]
    else:
        for i, width in enumerate(cfg.layer_widths):
            n_in = cfg.layer_in_bits(i) * cfg.layer_fan_in(i)
            luts += width * cfg.beta * rom_cost(n_in) * k
        levels = cfg.num_layers
    fmax = min(800.0, max(200.0, 1745.0 - 83.5 * math.log2(max(luts, 2.0))))
    latency = levels / fmax * 1e3  # ns
    return HwEstimate(luts=luts, fmax_mhz=fmax, latency_ns=latency,
                      area_delay=luts * latency, layers=levels)


# Paper-reported reference points (Table III) for benchmark comparison.
PAPER_TABLE3 = {
    "neuralut-hdr-5l": dict(accuracy=0.96, lut=54798, fmax=431, latency=12,
                            adp=6.6e5),
    "polylut-hdr": dict(accuracy=0.96, lut=70673, fmax=378, latency=16,
                        adp=11.3e5),
    "finn-mnist": dict(accuracy=0.96, lut=91131, fmax=200, latency=310,
                       adp=282.5e5),
    "hls4ml-mnist": dict(accuracy=0.95, lut=260092, fmax=200, latency=190,
                         adp=494.2e5),
    "neuralut-jsc-2l": dict(accuracy=0.72, lut=4684, fmax=727, latency=3,
                            adp=1.4e4),
    "polylut-jsc-lite": dict(accuracy=0.72, lut=12436, fmax=646, latency=5,
                             adp=6.2e4),
    "logicnets-jsc-m": dict(accuracy=0.72, lut=37931, fmax=427, latency=13,
                            adp=49.3e4),
    "neuralut-jsc-5l": dict(accuracy=0.75, lut=92357, fmax=368, latency=14,
                            adp=1.3e6),
    "polylut-jsc-hdr": dict(accuracy=0.75, lut=236541, fmax=235, latency=21,
                            adp=5e6),
}
