"""Architecture registry: ``get_config(<id>)`` resolution.

Each module in ``repro_torch.configs`` registers a full-size config (the
published architecture) and a reduced config (same family, tiny dims)
used by the CPU tests — the same ids and values as ``repro.configs``.
Two families are registered: the NeuraLUT chain geometries and
PolyLUT-Add LUT graphs (``list_archs``), and the decoder-only LMs
(``list_lm_archs``): attention (GQA or MLA), Mamba, mLSTM or sLSTM
mixers with a dense FFN, a mixture of experts or none, the
encoder-decoder (whisper-small) and the VLM backbone (qwen2-vl-72b).
"""
from __future__ import annotations

import importlib
from typing import Callable, Dict, Tuple, Union

from repro_torch.config.base import ModelConfig
from repro_torch.core.nl_config import LUTGraphConfig, NeuraLUTConfig

Config = Union[NeuraLUTConfig, LUTGraphConfig, ModelConfig]

_FULL: Dict[str, Callable[[], Config]] = {}
_REDUCED: Dict[str, Callable[[], Config]] = {}

_CONFIG_MODULES = (
    "neuralut_hdr_5l",
    "neuralut_jsc_2l",
    "neuralut_jsc_5l",
    "polylut_add_jsc_2l",
    "polylut_add_jsc_5l",
    "lm_100m",
    "llama3_8b",
    "yi_9b",
    "granite_34b",
    "gemma3_12b",
    "qwen2_moe_a2p7b",
    "deepseek_v2_lite_16b",
    "jamba_v0_1_52b",
    "xlstm_350m",
    "whisper_small",
    "qwen2_vl_72b",
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
    """The NeuraLUT and LUT-graph archs."""
    _ensure_loaded()
    return tuple(sorted(n for n, f in _FULL.items()
                        if not isinstance(f(), ModelConfig)))


def list_lm_archs() -> Tuple[str, ...]:
    """The LM archs (dense, MoE, MLA + MoE, hybrid, xLSTM, enc-dec,
    VLM)."""
    _ensure_loaded()
    return tuple(sorted(n for n, f in _FULL.items()
                        if isinstance(f(), ModelConfig)))


def get_config(name: str, reduced: bool = False) -> Config:
    _ensure_loaded()
    table = _REDUCED if reduced else _FULL
    if name not in table:
        raise KeyError(f"unknown arch {name!r}; available: {sorted(table)}")
    return table[name]()
