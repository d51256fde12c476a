"""Device-resident datasets (port of ``repro.data.pipeline
.device_dataset``).

A generator's arrays are made once on the host, copied to the device
once, and the same tensors come back on every later call with the same
generator, arguments and device: epochs, reruns and repeated launches
in one process do no host work and no host-to-device copies.
"""
from __future__ import annotations

from typing import Callable, Dict, Tuple

import numpy as np
import torch

from repro_torch.device import DeviceLike, resolve_device

_DEVICE_DATA: Dict[Tuple, Tuple[torch.Tensor, ...]] = {}


def device_dataset(gen: Callable, *args, device: DeviceLike = None,
                   **kwargs) -> Tuple[torch.Tensor, ...]:
    """``gen(*args, **kwargs)`` (a deterministic generator of an array or
    a tuple of arrays) as tensors on ``device`` (``None`` = CUDA), made
    on the first call and returned as the same tensors afterwards."""
    dev = resolve_device(device)
    key = (getattr(gen, "__module__", ""),
           getattr(gen, "__qualname__", repr(gen)), args,
           tuple(sorted(kwargs.items())), str(dev))
    out = _DEVICE_DATA.get(key)
    if out is None:
        arrs = gen(*args, **kwargs)
        if not isinstance(arrs, tuple):
            arrs = (arrs,)
        out = tuple(torch.as_tensor(np.ascontiguousarray(a), device=dev)
                    for a in arrs)
        _DEVICE_DATA[key] = out
    return out



def device_dataset_stats() -> Dict[str, int]:
    """{cached entries, resident bytes}: tests and memory audits."""
    return {"entries": len(_DEVICE_DATA),
            "bytes": sum(int(a.numel() * a.element_size())
                         for v in _DEVICE_DATA.values() for a in v)}


def clear_device_datasets() -> None:
    _DEVICE_DATA.clear()
