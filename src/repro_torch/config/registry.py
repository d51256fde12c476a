"""Architecture registry: ``get_config(<id>)`` resolution for the
NeuraLUT chain geometries and the PolyLUT-Add LUT graphs the port
serves.

Each module in ``repro_torch.configs`` registers a full-size config (the
published architecture) and a reduced config (same family, tiny dims)
used by the CPU tests — the same ids and values as ``repro.configs``.
"""
from __future__ import annotations

import importlib
from typing import Callable, Dict, Tuple, Union

from repro_torch.core.nl_config import LUTGraphConfig, NeuraLUTConfig

Config = Union[NeuraLUTConfig, LUTGraphConfig]

_FULL: Dict[str, Callable[[], Config]] = {}
_REDUCED: Dict[str, Callable[[], Config]] = {}

_CONFIG_MODULES = (
    "neuralut_hdr_5l",
    "neuralut_jsc_2l",
    "neuralut_jsc_5l",
    "polylut_add_jsc_2l",
    "polylut_add_jsc_5l",
)

_loaded = False


def register(name: str, full: Callable[[], Config],
             reduced: Callable[[], Config]) -> None:
    _FULL[name] = full
    _REDUCED[name] = reduced


def _ensure_loaded() -> None:
    global _loaded
    if _loaded:
        return
    for mod in _CONFIG_MODULES:
        importlib.import_module(f"repro_torch.configs.{mod}")
    _loaded = True


def list_archs() -> Tuple[str, ...]:
    _ensure_loaded()
    return tuple(sorted(_FULL))


def get_config(name: str, reduced: bool = False) -> Config:
    _ensure_loaded()
    table = _REDUCED if reduced else _FULL
    if name not in table:
        raise KeyError(f"unknown arch {name!r}; available: {sorted(table)}")
    return table[name]()
