"""Roofline terms of one step as the port runs it on one rank (port of
``repro.roofline.analysis``).

The reference takes its per-device counts from the SPMD-partitioned HLO
of a compiled step; the port counts the step itself on the meta device
(``roofline.counter.count_step``), so the counts are those of the rank
that ran it.  Terms (seconds, one step, one rank):

    compute    = dot_flops / peak_flops
    memory     = hbm_bytes / hbm_bw
    collective = collective_bytes / ici_bw

``Hardware`` holds one NVIDIA H100 SXM5 (80 GB HBM3), each figure with
its source.  The production meshes are 256 and 512 cards; an NVLink
node holds 8, so every data or model group of those meshes spans nodes
and the network between nodes, one 400 Gb/s NDR InfiniBand link per
GPU in a DGX H100, sets the collective term.
"""
from __future__ import annotations

import dataclasses
from dataclasses import dataclass
from typing import Dict, Optional


@dataclass(frozen=True)
class Hardware:
    name: str = "h100-sxm5-80gb"
    # NVIDIA H100 Tensor Core GPU datasheet, SXM5: bf16 tensor core
    # 1,979 TFLOP/s with sparsity, so 989.4 dense
    peak_flops: float = 989.4e12
    # the same datasheet: fp32 (no tensor core) 67 TFLOP/s; the port
    # runs no TF32, so a float32 config is costed at this rate
    peak_flops_fp32: float = 67e12
    # the same datasheet: HBM3, 3.35 TB/s
    hbm_bw: float = 3.35e12
    # DGX H100: one ConnectX-7 400 Gb/s NDR port per GPU, 50 GB/s
    ici_bw: float = 50e9
    # the same datasheet: 80 GB, taken as GiB as the reference takes
    # its chip's 16 GB
    hbm_bytes: float = 80 * 2 ** 30


HW = Hardware()


@dataclass
class RooflineReport:
    arch: str
    shape: str
    mesh: str
    num_devices: int
    # raw per-rank numbers
    cost_flops_raw: float
    cost_bytes_raw: float
    dot_flops: float          # per rank, every step of every loop
    hbm_bytes: float          # traffic estimate, per rank
    collective_bytes: float   # per rank
    collective_breakdown: Dict[str, float]
    peak_memory_bytes: Optional[float]
    argument_bytes: Optional[float]
    # derived terms (seconds)
    t_compute: float = 0.0
    t_memory: float = 0.0
    t_collective: float = 0.0
    bottleneck: str = ""
    model_flops: float = 0.0      # global 6*N*D
    useful_ratio: float = 0.0     # model_flops / (dot_flops * num_devices)
    roofline_fraction: float = 0.0  # model-flops-time / max(term)
    unknown_trip_loops: int = 0

    def finish(self, hw: Hardware = HW):
        self.t_compute = self.dot_flops / hw.peak_flops
        self.t_memory = self.hbm_bytes / hw.hbm_bw
        self.t_collective = self.collective_bytes / hw.ici_bw
        terms = {"compute": self.t_compute, "memory": self.t_memory,
                 "collective": self.t_collective}
        self.bottleneck = max(terms, key=terms.get)
        if self.dot_flops > 0 and self.num_devices:
            self.useful_ratio = self.model_flops / (
                self.dot_flops * self.num_devices)
        t_bound = max(terms.values())
        if t_bound > 0 and self.num_devices:
            t_ideal = self.model_flops / self.num_devices / hw.peak_flops
            self.roofline_fraction = t_ideal / t_bound
        return self

    def to_dict(self):
        return dataclasses.asdict(self)


def roofline_report(*, arch: str, shape: str, mesh: str, num_devices: int,
                    analysis, memstats=None, model_flops: float = 0.0,
                    bf16_model: bool = True,
                    hw: Hardware = HW) -> RooflineReport:
    """The report of one cell from its ``StepAnalysis``.  Every byte is
    counted at its dtype's true size (the meta run sees the step's
    dtypes; the reference halves float32 bytes of bf16 models to undo
    its CPU backend's upcast).  ``cost_*_raw`` are the counter's own
    totals, there being no ``cost_analysis``: FLOPs of every counted op
    and the traffic estimate.  A float32 model is costed at the fp32
    peak."""
    rep = RooflineReport(
        arch=arch, shape=shape, mesh=mesh, num_devices=num_devices,
        cost_flops_raw=float(analysis.dot_flops),
        cost_bytes_raw=float(analysis.hbm_bytes),
        dot_flops=analysis.dot_flops,
        hbm_bytes=analysis.hbm_bytes,
        collective_bytes=analysis.collective_bytes,
        collective_breakdown=dict(analysis.collective_breakdown),
        peak_memory_bytes=_peak_memory(memstats),
        argument_bytes=(float(memstats.argument_size_in_bytes)
                        if memstats is not None else None),
        model_flops=model_flops,
        unknown_trip_loops=analysis.unknown_trip_loops,
    )
    if not bf16_model:
        hw = dataclasses.replace(hw, peak_flops=hw.peak_flops_fp32)
    return rep.finish(hw)


@dataclass(frozen=True)
class MemoryStats:
    """A rank's memory for one step, the fields of the reference's
    ``CompiledMemoryStats`` that its dry run reads: the rank's shards
    (arguments), the step's outputs, and the peak of every tensor the
    step made (temporaries, outputs included) above the arguments."""

    argument_size_in_bytes: float
    output_size_in_bytes: float
    temp_size_in_bytes: float

    @property
    def peak_memory_in_bytes(self) -> float:
        return self.argument_size_in_bytes + self.temp_size_in_bytes


def _peak_memory(memstats) -> Optional[float]:
    """Per-rank peak live bytes: the arguments plus the peak of what the
    step made (``MemoryStats.peak_memory_in_bytes``); for another stats
    object without that field, arguments + outputs + temporaries."""
    if memstats is None:
        return None
    peak = getattr(memstats, "peak_memory_in_bytes", None)
    if peak is not None:
        return float(peak)
    return float(memstats.argument_size_in_bytes
                 + memstats.output_size_in_bytes
                 + memstats.temp_size_in_bytes)


def model_flops_estimate(cfg, shape) -> float:
    """Global MODEL_FLOPS = 6*N_active*D for train, 2*N_active*D for
    inference (D = tokens processed)."""
    n_active = active_param_count(cfg)
    if shape.kind == "train":
        tokens = shape.global_batch * shape.seq_len
        return 6.0 * n_active * tokens
    if shape.kind == "prefill":
        tokens = shape.global_batch * shape.seq_len
        return 2.0 * n_active * tokens
    tokens = shape.global_batch  # one token per sequence
    return 2.0 * n_active * tokens


def _leaves_with_names(tree, names=()):
    """(path names, leaf) over a spec tree; list positions add no name,
    as the reference's ``getattr(key, "key", "")`` gives them none."""
    if isinstance(tree, dict):
        for k in sorted(tree):
            yield from _leaves_with_names(tree[k], names + (str(k),))
    elif isinstance(tree, (list, tuple)):
        for t in tree:
            yield from _leaves_with_names(t, names + ("",))
    elif tree is not None:
        yield names, tree


def _numel(shape) -> int:
    n = 1
    for d in shape:
        n *= d
    return n


def param_count(cfg) -> int:
    """Total parameter count from the spec tree."""
    from repro_torch.models import api
    return sum(_numel(leaf.shape)
               for _, leaf in _leaves_with_names(api.param_spec(cfg)))


def active_param_count(cfg) -> int:
    """Parameters touched per token (MoE: shared + top_k experts only)."""
    from repro_torch.models import api
    if cfg.moe is not None:
        from repro_torch.models.layers.moe import padded_num_experts
        e_pad = padded_num_experts(cfg.moe, 16)
    tot = 0
    for names, leaf in _leaves_with_names(api.param_spec(cfg)):
        n = _numel(leaf.shape)
        if (cfg.moe is not None and "ffn" in names
                and names[-1] in ("w_gate", "w_up", "w_down")
                and leaf.ndim >= 3 and e_pad in leaf.shape):
            # routed experts: only top_k of num_experts active per token
            n = n // e_pad * cfg.moe.top_k
        tot += n
    return tot
