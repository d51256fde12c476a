"""PolyLUT-Add JSC-5L — a deeper adder-tree LUT graph in the
high-accuracy JSC segment (PolyLUT-Add, arXiv:2406.04910).

Three stacked arity-2 adder nodes then an arity-1 classifier.  Inner
nodes consume the previous node's 5-bit summed codes (F=3 -> 2^15-entry
branch ROMs, inside the 2^20 conversion-sweep guard); every neuron sees
2F = 6 effective inputs for the ROM cost of two F=3 branches.
"""
from repro_torch.config import register
from repro_torch.core.nl_config import INPUT, LUTGraphConfig, LUTNodeSpec


def full() -> LUTGraphConfig:
    return LUTGraphConfig(
        name="polylut-add-jsc-5l",
        in_features=16,
        num_classes=5,
        beta=4,
        nodes=(
            LUTNodeSpec(name="add0", width=64, fan_in=3,
                        inputs=(INPUT,), arity=2),
            LUTNodeSpec(name="add1", width=64, fan_in=3,
                        inputs=("add0",), arity=2),
            LUTNodeSpec(name="add2", width=32, fan_in=3,
                        inputs=("add1",), arity=2),
            LUTNodeSpec(name="cls", width=5, fan_in=3,
                        inputs=("add2",), arity=1),
        ),
        kind="subnet",
        depth=4,
        width=16,
        skip=2,
    )


def reduced() -> LUTGraphConfig:
    return LUTGraphConfig(
        name="polylut-add-jsc-5l-reduced",
        in_features=16,
        num_classes=5,
        beta=3,
        nodes=(
            LUTNodeSpec(name="add0", width=16, fan_in=3,
                        inputs=(INPUT,), arity=2),
            LUTNodeSpec(name="add1", width=8, fan_in=3,
                        inputs=("add0",), arity=2),
            LUTNodeSpec(name="cls", width=5, fan_in=3,
                        inputs=("add1",), arity=1),
        ),
        kind="subnet",
        depth=2,
        width=4,
        skip=2,
    )


register("polylut-add-jsc-5l", full, reduced)
