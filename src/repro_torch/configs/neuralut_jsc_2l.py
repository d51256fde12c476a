"""NeuraLUT JSC-2L — jet substructure tagging, low-accuracy segment
(Table II).  L-LUTs per layer: 32, 5; beta=4, F=3, L=4, N=8, S=2.
Input: 16 jet substructure features, 5 classes.
"""
from repro_torch.config import register
from repro_torch.core.nl_config import NeuraLUTConfig


def full() -> NeuraLUTConfig:
    return NeuraLUTConfig(
        name="neuralut-jsc-2l",
        in_features=16,
        layer_widths=(32, 5),
        num_classes=5,
        beta=4,
        fan_in=3,
        kind="subnet",
        depth=4,
        width=8,
        skip=2,
    )


def reduced() -> NeuraLUTConfig:
    return NeuraLUTConfig(
        name="neuralut-jsc-2l-reduced",
        in_features=16,
        layer_widths=(16, 5),
        num_classes=5,
        beta=3,
        fan_in=3,
        kind="subnet",
        depth=2,
        width=4,
        skip=2,
    )


register("neuralut-jsc-2l", full, reduced)
