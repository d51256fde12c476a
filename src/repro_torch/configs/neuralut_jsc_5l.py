"""NeuraLUT JSC-5L — jet substructure tagging, high-accuracy segment
(Table II).  L-LUTs per layer: 128, 128, 128, 64, 5; beta=4, F=3, L=4,
N=16, S=2; exceptions beta_0=7, F_0=2.
"""
from repro_torch.config import register
from repro_torch.core.nl_config import NeuraLUTConfig


def full() -> NeuraLUTConfig:
    return NeuraLUTConfig(
        name="neuralut-jsc-5l",
        in_features=16,
        layer_widths=(128, 128, 128, 64, 5),
        num_classes=5,
        beta=4,
        fan_in=3,
        kind="subnet",
        depth=4,
        width=16,
        skip=2,
        beta_in=7,
        fan_in_0=2,
    )


def reduced() -> NeuraLUTConfig:
    return NeuraLUTConfig(
        name="neuralut-jsc-5l-reduced",
        in_features=16,
        layer_widths=(32, 16, 5),
        num_classes=5,
        beta=3,
        fan_in=3,
        kind="subnet",
        depth=3,
        width=8,
        skip=3,
        beta_in=4,
        fan_in_0=2,
    )


register("neuralut-jsc-5l", full, reduced)
