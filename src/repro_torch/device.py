"""Device resolution and the fp32 contract of the exact paths.

Entry points take ``device=None`` to mean the CUDA device; there is no
quiet fall back to the CPU.  Truth-table addresses reach 2^20
(``core/truth_table._guard_size``) and conversion sits on round()
boundaries, so every float32 product on the card must run in full
IEEE fp32: TF32's 10-bit mantissa would corrupt them.
"""
from __future__ import annotations

from typing import Union

import torch

DeviceLike = Union[str, torch.device, None]


def set_exact_fp32() -> None:
    """Turn TF32 off for matmuls and cuDNN, then check that it is off."""
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    torch.set_float32_matmul_precision("highest")
    check_exact_fp32()


def check_exact_fp32() -> None:
    """Raise if anything in the process turned TF32 back on."""
    if (torch.backends.cuda.matmul.allow_tf32
            or torch.backends.cudnn.allow_tf32
            or torch.get_float32_matmul_precision() != "highest"):
        raise RuntimeError(
            "TF32 is enabled (torch.backends.cuda.matmul.allow_tf32="
            f"{torch.backends.cuda.matmul.allow_tf32}, cudnn.allow_tf32="
            f"{torch.backends.cudnn.allow_tf32}, float32 matmul precision "
            f"{torch.get_float32_matmul_precision()!r}); the exact paths "
            "need full fp32")


def resolve_device(device: DeviceLike = None) -> torch.device:
    """``None`` -> ``cuda``.  A CUDA device without CUDA raises; the
    CPU runs only when the caller names it."""
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda":
        if not torch.cuda.is_available():
            raise RuntimeError(
                "no CUDA device is available; repro_torch runs on the GPU "
                "by default — pass device='cpu' to run on the CPU")
        set_exact_fp32()
    elif dev.type != "cpu":
        raise ValueError(f"unsupported device {dev}; use 'cuda' or 'cpu'")
    return dev

