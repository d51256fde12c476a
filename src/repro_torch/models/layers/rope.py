"""Rotary position embeddings (port of ``repro.models.layers.rope``:
standard RoPE; qwen2-vl's M-RoPE waits for the VLM)."""
from __future__ import annotations

import torch

from repro_torch import NOT_PORTED


def rope_freqs(head_dim: int, theta: float,
               device=None) -> torch.Tensor:
    """(head_dim//2,) inverse frequencies, float32."""
    half = head_dim // 2
    ar = torch.arange(0, half, dtype=torch.float32, device=device)
    return 1.0 / (theta ** (ar / half))


def apply_rope(x: torch.Tensor, positions: torch.Tensor,
               theta: float) -> torch.Tensor:
    """x: (..., seq, heads, head_dim); positions: broadcastable to
    (..., seq).  Angles in float32."""
    half = x.shape[-1] // 2
    freqs = rope_freqs(x.shape[-1], theta, device=x.device)  # (half,)
    angles = positions[..., None].to(torch.float32) * freqs
    cos = torch.cos(angles)[..., None, :]  # (..., seq, 1, half)
    sin = torch.sin(angles)[..., None, :]
    x1, x2 = x[..., :half], x[..., half:]
    y1 = x1 * cos - x2 * sin
    y2 = x2 * cos + x1 * sin
    return torch.cat([y1, y2], dim=-1).to(x.dtype)


def apply_mrope(x, positions3, theta, sections):
    raise NotImplementedError(
        "M-RoPE (the VLM's rotary embedding) " + NOT_PORTED.format(
            "Queue A item 7"))


def positions_for(attn_cfg, batch: int, seq: int, offset=0,
                  device=None) -> torch.Tensor:
    """Default position ids (batch, seq), int32; an ``offset`` tensor
    is broadcast against (1, seq) instead."""
    if attn_cfg.rope_kind == "mrope":
        apply_mrope(None, None, None, None)
    pos = torch.arange(seq, dtype=torch.int32, device=device)[None, :] \
        + offset
    if not isinstance(offset, torch.Tensor):
        pos = pos.expand(batch, seq)
    return pos
