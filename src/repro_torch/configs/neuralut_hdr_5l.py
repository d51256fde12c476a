"""NeuraLUT HDR-5L — the paper's MNIST model (Table II).

L-LUTs per layer: 256, 100, 100, 100, 10; beta=2, F=6, L=4, N=16, S=2.
Input: 784 flattened pixels.
"""
from repro_torch.config import register
from repro_torch.core.nl_config import NeuraLUTConfig


def full() -> NeuraLUTConfig:
    return NeuraLUTConfig(
        name="neuralut-hdr-5l",
        in_features=784,
        layer_widths=(256, 100, 100, 100, 10),
        num_classes=10,
        beta=2,
        fan_in=6,
        kind="subnet",
        depth=4,
        width=16,
        skip=2,
    )


def reduced() -> NeuraLUTConfig:
    return NeuraLUTConfig(
        name="neuralut-hdr-5l-reduced",
        in_features=64,
        layer_widths=(32, 16, 10),
        num_classes=10,
        beta=2,
        fan_in=4,
        kind="subnet",
        depth=4,
        width=8,
        skip=2,
    )


register("neuralut-hdr-5l", full, reduced)
