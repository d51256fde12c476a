"""Unified model API: config -> (spec, init, loss, decode) (port of
``repro.models.api`` for the decoder-only LMs; enc-dec and the dry
run's ``input_specs`` / ``runnable_cells`` wait for later slices)."""
from __future__ import annotations

from typing import Any, Dict, Optional

import torch

from repro_torch import NOT_PORTED
from repro_torch.config.base import ModelConfig, ShapeConfig
from repro_torch.tree import tree_map
from . import lm
from .layers.common import TensorSpec, init_from_spec, zeros_from_spec

Params = Dict[str, Any]


def is_encdec(cfg: ModelConfig) -> bool:
    return cfg.encoder is not None


def _no_encdec(cfg: ModelConfig) -> None:
    if is_encdec(cfg):
        raise NotImplementedError(
            f"{cfg.name}: enc-dec " + NOT_PORTED.format("Queue A item 7"))


def param_spec(cfg: ModelConfig, *, model_axis: int = 16) -> Params:
    _no_encdec(cfg)
    return lm.param_spec(cfg, model_axis=model_axis)


def init_params(cfg: ModelConfig, generator: torch.Generator, *,
                device: Optional[torch.device] = None) -> Params:
    """Seeded init (``init_from_spec``) of ``param_spec``'s tree, drawn
    from ``generator`` on its device and moved to ``device``.  The
    reference's ``init_params`` takes ``model_axis=1`` (no padded
    experts); the port draws the padded tree that ``param_spec`` and the
    bridge hold, so an MoE layer's inert experts are drawn too (they are
    never routed to)."""
    return init_from_spec(param_spec(cfg), generator, device=device)


def loss_fn(cfg: ModelConfig, params: Params, batch, *, layer_mode="scan",
            remat="full", q_chunk: int = 512):
    _no_encdec(cfg)
    return lm.lm_loss(cfg, params, batch, layer_mode=layer_mode,
                      remat=remat, q_chunk=q_chunk)


def decode_state_spec(cfg: ModelConfig, batch: int, seq: int) -> Params:
    _no_encdec(cfg)
    return lm.decode_state_spec(cfg, batch, seq)


def decode_step(cfg: ModelConfig, params: Params, state: Params, token,
                *, layer_mode="scan"):
    _no_encdec(cfg)
    return lm.decode_step(cfg, params, state, token, layer_mode=layer_mode)


def input_specs(cfg: ModelConfig, shape: ShapeConfig):
    raise NotImplementedError(
        "input_specs (the dry run's) " + NOT_PORTED.format(
            "Queue A item 7"))


def runnable_cells(cfg: ModelConfig, shapes):
    raise NotImplementedError(
        "runnable_cells (the dry run's) " + NOT_PORTED.format(
            "Queue A item 7"))


def _specs(cfg: ModelConfig, shape: ShapeConfig) -> Params:
    """The decoder-only LM's inputs for one shape (``input_specs``
    without its modality stubs)."""
    _no_encdec(cfg)
    if cfg.vision is not None:
        lm.param_spec(cfg)  # raises: the vision stub is not ported
    b, s = shape.global_batch, shape.seq_len
    if shape.kind in ("train", "prefill"):
        return {"tokens": TensorSpec((b, s), torch.int32),
                "labels": TensorSpec((b, s), torch.int32)}
    return {"token": TensorSpec((b, 1), torch.int32),
            "state": decode_state_spec(cfg, b, s)}


def make_batch(cfg: ModelConfig, shape_or_specs, generator: torch.Generator,
               *, device: Optional[torch.device] = None) -> Params:
    """Random data for a shape (or a tree of :class:`TensorSpec`): token
    ids uniform in [0, vocab), other floats N(0, 0.1), a decode
    state's ``pos`` 0 and its caches zeros.  Drawn on the host from
    ``generator`` in tree order."""
    if isinstance(shape_or_specs, ShapeConfig):
        specs = _specs(cfg, shape_or_specs)
    else:
        specs = shape_or_specs

    def gen(sp: TensorSpec):
        if not sp.dtype.is_floating_point:
            if sp.shape == ():
                return torch.zeros((), dtype=sp.dtype, device=device)
            return torch.randint(0, max(2, cfg.vocab_size), sp.shape,
                                 generator=generator,
                                 dtype=sp.dtype).to(device)
        return (torch.randn(sp.shape, generator=generator) * 0.1).to(
            sp.dtype).to(device)

    out = tree_map(gen, {k: v for k, v in specs.items() if k != "state"})
    if "state" in specs:
        out["state"] = zeros_from_spec(specs["state"], device=device)
    return out
