"""PolyLUT-Add JSC-2L — the adder-tree LUT-graph counterpart of
``neuralut_jsc_2l`` (PolyLUT-Add, arXiv:2406.04910).

Each hidden neuron sums A=2 independent L-LUT branches that share one
quantizer: effective fan-in doubles (2F features feed the neuron) while
per-branch ROM size stays 2^{beta*F} — the 2^{beta*2F} monolithic table
is replaced by 2 tables + a beta+1-bit adder.  The classifier node is a
plain arity-1 L-LUT over the 5-bit summed codes.
"""
from repro_torch.config import register
from repro_torch.core.nl_config import INPUT, LUTGraphConfig, LUTNodeSpec


def full() -> LUTGraphConfig:
    return LUTGraphConfig(
        name="polylut-add-jsc-2l",
        in_features=16,
        num_classes=5,
        beta=4,
        nodes=(
            # 2 branches x F=3 over the input codes; 5-bit summed output
            LUTNodeSpec(name="add0", width=32, fan_in=3,
                        inputs=(INPUT,), arity=2),
            # classifier: 3 x 5-bit codes -> 2^15-entry ROMs
            LUTNodeSpec(name="cls", width=5, fan_in=3,
                        inputs=("add0",), arity=1),
        ),
        kind="subnet",
        depth=4,
        width=8,
        skip=2,
    )


def reduced() -> LUTGraphConfig:
    return LUTGraphConfig(
        name="polylut-add-jsc-2l-reduced",
        in_features=16,
        num_classes=5,
        beta=3,
        nodes=(
            LUTNodeSpec(name="add0", width=16, fan_in=3,
                        inputs=(INPUT,), arity=2),
            LUTNodeSpec(name="cls", width=5, fan_in=3,
                        inputs=("add0",), arity=1),
        ),
        kind="subnet",
        depth=2,
        width=4,
        skip=2,
    )


register("polylut-add-jsc-2l", full, reduced)
