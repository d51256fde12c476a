"""Unified model API: config -> (spec, init, loss, decode) + input specs
(port of ``repro.models.api``).

``input_specs(cfg, shape)`` gives :class:`TensorSpec` stand-ins for every
model input of one (architecture x shape) cell, the modality stubs
included (whisper's ``frames``, the VLM's ``patch_embeds`` and 3-D
``positions``); ``make_batch`` materializes them.
"""
from __future__ import annotations

from typing import Any, Dict, Optional

import torch

from repro_torch.config.base import ModelConfig, ShapeConfig
from repro_torch.tree import tree_map
from . import encdec, lm
from .layers.common import TensorSpec, init_from_spec, zeros_from_spec

Params = Dict[str, Any]


def is_encdec(cfg: ModelConfig) -> bool:
    return cfg.encoder is not None


def param_spec(cfg: ModelConfig, *, model_axis: int = 16) -> Params:
    if is_encdec(cfg):
        return encdec.param_spec(cfg, model_axis=model_axis)
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
    if is_encdec(cfg):
        return encdec.encdec_loss(cfg, params, batch, layer_mode=layer_mode,
                                  remat=remat, q_chunk=q_chunk)
    return lm.lm_loss(cfg, params, batch, layer_mode=layer_mode,
                      remat=remat, q_chunk=q_chunk)


def decode_state_spec(cfg: ModelConfig, batch: int, seq: int) -> Params:
    if is_encdec(cfg):
        return encdec.decode_state_spec(cfg, batch, seq)
    return lm.decode_state_spec(cfg, batch, seq)


def decode_step(cfg: ModelConfig, params: Params, state: Params, token,
                *, layer_mode="scan"):
    if is_encdec(cfg):
        return encdec.decode_step(cfg, params, state, token,
                                  layer_mode=layer_mode)
    return lm.decode_step(cfg, params, state, token, layer_mode=layer_mode)


# ---------------------------------------------------------------------------
# Input specs per (arch x shape) cell


def input_specs(cfg: ModelConfig, shape: ShapeConfig) -> Dict[str, Any]:
    """Model inputs for one cell.  train / prefill: the token batch and
    the modality stubs' embeddings (bfloat16, as the reference's);
    decode: one new token and the decode state holding a
    ``seq_len``-long context."""
    b, s = shape.global_batch, shape.seq_len
    i32 = torch.int32
    if shape.kind in ("train", "prefill"):
        batch: Dict[str, Any] = {"tokens": TensorSpec((b, s), i32),
                                 "labels": TensorSpec((b, s), i32)}
        if cfg.vision is not None:
            v = cfg.vision
            batch["patch_embeds"] = TensorSpec(
                (b, v.num_patches, v.patch_dim), torch.bfloat16)
            batch["positions"] = TensorSpec((b, s, 3), i32)
        if cfg.encoder is not None:
            e = cfg.encoder
            batch["frames"] = TensorSpec((b, e.seq_len, e.feature_dim),
                                         torch.bfloat16)
        return batch
    return {"token": TensorSpec((b, 1), i32),
            "state": decode_state_spec(cfg, b, s)}


def make_batch(cfg: ModelConfig, shape_or_specs, generator: torch.Generator,
               *, device: Optional[torch.device] = None) -> Params:
    """Random data for a shape (or a tree of :class:`TensorSpec`): every
    integer leaf (token ids, labels, M-RoPE positions) uniform in
    [0, vocab) as the reference's, other floats N(0, 0.1), a decode
    state's ``pos`` 0 and its caches zeros.  Drawn on the host from
    ``generator`` in tree order."""
    if isinstance(shape_or_specs, ShapeConfig):
        specs = input_specs(cfg, shape_or_specs)
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


def runnable_cells(cfg: ModelConfig, shapes) -> Dict[str, str]:
    """Which shapes run for this arch: '' runs, else the reason to
    skip."""
    out = {}
    for sh in shapes:
        reason = ""
        if sh.name == "long_500k" and not cfg.sub_quadratic:
            reason = ("pure full-attention stack: 500k-token decode needs "
                      "sub-quadratic sequence mixing (skip per assignment)")
        out[sh.name] = reason
    return out
