"""Rotary position embeddings: standard RoPE and qwen2-vl's M-RoPE
(port of ``repro.models.layers.rope``).

M-RoPE splits the rotary frequency pairs into (temporal, height, width)
sections; text tokens carry one position id in all three sections
(standard RoPE), vision patches their 3-D coordinates.  The backbone
takes position ids of shape (batch, seq, 3); the vision stub supplies
the patch coordinates.
"""
from __future__ import annotations

import torch


def rope_freqs(head_dim: int, theta: float,
               device=None) -> torch.Tensor:
    """(head_dim//2,) inverse frequencies, float32."""
    half = head_dim // 2
    ar = torch.arange(0, half, dtype=torch.float32, device=device)
    return 1.0 / (theta ** (ar / half))


def _rotate(x: torch.Tensor, angles: torch.Tensor) -> torch.Tensor:
    """x (..., seq, heads, head_dim) rotated by float32 ``angles``
    broadcastable to (..., seq, heads, head_dim // 2)."""
    half = x.shape[-1] // 2
    cos, sin = torch.cos(angles), torch.sin(angles)
    x1, x2 = x[..., :half], x[..., half:]
    y1 = x1 * cos - x2 * sin
    y2 = x2 * cos + x1 * sin
    return torch.cat([y1, y2], dim=-1).to(x.dtype)


def apply_rope(x: torch.Tensor, positions: torch.Tensor,
               theta: float) -> torch.Tensor:
    """x: (..., seq, heads, head_dim); positions: broadcastable to
    (..., seq).  Angles in float32."""
    freqs = rope_freqs(x.shape[-1], theta, device=x.device)  # (half,)
    angles = positions[..., None].to(torch.float32) * freqs
    return _rotate(x, angles[..., None, :])  # (..., seq, 1, half)


def apply_mrope(x: torch.Tensor, positions3: torch.Tensor, theta: float,
                sections: tuple) -> torch.Tensor:
    """M-RoPE.  x: (..., seq, heads, head_dim); positions3: (..., seq, 3).
    ``sections`` gives the number of rotary frequency pairs of each of
    the 3 axes; sum(sections) == head_dim // 2.  Frequency pair j turns
    by the position of its section; angles in float32."""
    half = x.shape[-1] // 2
    assert sum(sections) == half, (sections, half)
    freqs = rope_freqs(x.shape[-1], theta, device=x.device)  # (half,)
    sec_id = torch.cat([torch.full((s,), i, dtype=torch.long,
                                   device=x.device)
                        for i, s in enumerate(sections)])
    pos = positions3.to(torch.float32).index_select(-1, sec_id)
    return _rotate(x, (pos * freqs)[..., None, :])


def positions_for(attn_cfg, batch: int, seq: int, offset=0,
                  device=None) -> torch.Tensor:
    """Default position ids (batch, seq), int32, or for M-RoPE text-only
    ids (batch, seq, 3) with t = h = w; an ``offset`` tensor is
    broadcast against (1, seq) instead of expanding to ``batch``."""
    pos = torch.arange(seq, dtype=torch.int32, device=device)[None, :] \
        + offset
    if not isinstance(offset, torch.Tensor):
        pos = pos.expand(batch, seq)
    if attn_cfg.rope_kind == "mrope":
        return pos[..., None].expand(batch, seq, 3)
    return pos
