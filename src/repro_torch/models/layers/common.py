"""Shared building blocks: norms, activations, dense MLPs, initializers
(port of ``repro.models.layers.common``).

Functional style: every block is (spec, init, apply) over plain nested
dicts and lists of tensors (``repro_torch.tree``).  A spec's leaves are
:class:`TensorSpec` (shape and dtype, no storage); ``init_from_spec``
and ``zeros_from_spec`` materialize them.
"""
from __future__ import annotations

import contextlib
import math
from dataclasses import dataclass
from typing import Any, Dict, Optional, Tuple

import torch
import torch.nn.functional as F

from repro_torch.sharding import tensor_parallel as tp
from repro_torch.tree import tree_map

Params = Dict[str, Any]


@dataclass(frozen=True)
class TensorSpec:
    """The shape and dtype of one leaf (the reference's
    ``jax.ShapeDtypeStruct``)."""

    shape: Tuple[int, ...]
    dtype: torch.dtype

    @property
    def ndim(self) -> int:
        return len(self.shape)


def dtype_of(name: str) -> torch.dtype:
    return {"bfloat16": torch.bfloat16, "float32": torch.float32}[name]


# ---------------------------------------------------------------------------
# Sequential loops (the sLSTM's steps; the mLSTM's, the Mamba scan's,
# attention's query and the loss's chunks): a hook that a cost counter
# may set to run fewer steps

_LOOP_HOOK = None


class Steps:
    """The steps of a sequential loop of ``n`` identical steps, all of
    them: iterate over it for the step indices, cut the loop's inputs
    into per-step pieces with ``pieces`` and join its per-step outputs
    with ``join``.  A cost counter's subclass runs fewer steps
    (``roofline.counter``)."""

    def __init__(self, n: int):
        self.n = n

    def __len__(self) -> int:
        return self.n

    def __iter__(self):
        return iter(range(self.n))

    def pieces(self, x: torch.Tensor, dim: int, size: Optional[int] = None):
        """``x`` cut along ``dim`` into the steps' pieces: ``unbind``, or
        ``split`` into ``size``-long chunks.  One cut, not a slice per
        step: a slice's backward writes a zero tensor of all of ``x``
        per step, the cut's one stack or cat."""
        return x.unbind(dim) if size is None else x.split(size, dim)

    def join(self, outs, dim: int, stack: bool = True) -> torch.Tensor:
        """The steps' outputs stacked (or concatenated) along ``dim``."""
        return torch.stack(outs, dim) if stack else torch.cat(outs, dim)


def set_loop_hook(hook) -> None:
    """``hook(kind, n)`` is a context manager yielding a loop's
    :class:`Steps` (``roofline.counter`` yields one that runs a few
    steps and extends the counts to ``n``); ``None`` runs every step."""
    global _LOOP_HOOK
    _LOOP_HOOK = hook


@contextlib.contextmanager
def sequential_loop(kind: str, n: int):
    """Yields the :class:`Steps` of the loop's ``n``: all of them unless
    a hook is set."""
    if _LOOP_HOOK is None:
        yield Steps(n)
        return
    with _LOOP_HOOK(kind, n) as steps:
        yield steps


# ---------------------------------------------------------------------------
# Spec/init helpers


def _dense_spec(d_in: int, d_out: int, dtype) -> TensorSpec:
    return TensorSpec((d_in, d_out), dtype)


def _init_leaf(name: str, leaf: TensorSpec,
               generator: torch.Generator) -> torch.Tensor:
    if leaf.ndim >= 2:
        fan_in = leaf.shape[-2]
        w = torch.empty(leaf.shape, dtype=torch.float32,
                        device=generator.device)
        torch.nn.init.trunc_normal_(w, 0.0, 1.0, -2.0, 2.0,
                                    generator=generator)
        w = w * (1.0 / math.sqrt(max(fan_in, 1)))
        return w.to(leaf.dtype)
    if "scale" in name or "norm" in name or name == "g":
        return torch.ones(leaf.shape, dtype=leaf.dtype)
    return torch.zeros(leaf.shape, dtype=leaf.dtype)


def init_from_spec(spec, generator: torch.Generator, *,
                   device: Optional[torch.device] = None):
    """Materialize a spec tree: truncated-normal (+-2 sigma) fan-in init
    for every leaf of two or more dims (fan-in = the second-to-last
    dim, as the reference's, so a stacked norm scale is drawn too),
    ones for vectors named like scales, zeros otherwise.  Drawn from
    ``generator`` leaf by leaf in tree order on the generator's device
    (the host's draws for a CPU generator), then moved to ``device``
    (default the host)."""
    def walk(t, name):
        if isinstance(t, dict):
            return {k: walk(t[k], k) for k in sorted(t)}
        if isinstance(t, (list, tuple)):
            return [walk(x, name) for x in t]
        return _init_leaf(name, t, generator).to(device)
    return walk(spec, "")


def zeros_from_spec(spec, *, device: Optional[torch.device] = None):
    """A spec tree of zero tensors (a fresh decode state)."""
    return tree_map(lambda s: torch.zeros(s.shape, dtype=s.dtype,
                                          device=device), spec)


# ---------------------------------------------------------------------------
# Norms


def norm_spec(d: int, kind: str, dtype) -> Params:
    if kind == "rmsnorm":
        return {"g": TensorSpec((d,), dtype)}
    return {"g": TensorSpec((d,), dtype), "b": TensorSpec((d,), dtype)}


def apply_norm(p: Params, x: torch.Tensor, kind: str,
               eps: float = 1e-6) -> torch.Tensor:
    """RMSNorm or LayerNorm, float32 inside, the input's dtype out."""
    xf = x.float()
    if kind == "rmsnorm":
        ms = torch.mean(xf * xf, dim=-1, keepdim=True)
        y = xf * torch.rsqrt(ms + eps)
        return (y * p["g"].float()).to(x.dtype)
    mu = torch.mean(xf, dim=-1, keepdim=True)
    var = torch.mean(torch.square(xf - mu), dim=-1, keepdim=True)
    y = (xf - mu) * torch.rsqrt(var + eps)
    y = y * p["g"].float() + p["b"].float()
    return y.to(x.dtype)


# ---------------------------------------------------------------------------
# Activations


def _gelu(x: torch.Tensor) -> torch.Tensor:
    # jax.nn.gelu's default is the tanh approximation
    return F.gelu(x, approximate="tanh")


def activation(name: str):
    return {"silu": F.silu, "gelu": _gelu, "relu": F.relu}[name]


# ---------------------------------------------------------------------------
# Gated MLP (llama-style). For act="gelu" this is GeGLU.


def mlp_spec(d_model: int, d_ff: int, dtype) -> Params:
    return {
        "w_gate": _dense_spec(d_model, d_ff, dtype),
        "w_up": _dense_spec(d_model, d_ff, dtype),
        "w_down": _dense_spec(d_ff, d_model, dtype),
    }


def apply_mlp(p: Params, x: torch.Tensor, act: str,
              fused: bool = False, split: bool = False,
              wide: bool = False) -> torch.Tensor:
    """The gated MLP.  ``split``: ``p`` holds this rank's block of the
    hidden units (``w_gate``/``w_up`` columns, ``w_down`` rows) in a
    step that splits the model axis: the input's gradient and the
    output are summed over the model ranks.  ``wide``: the products take
    ``tp.wide`` operands, each rounded to ``x``'s dtype after it (the
    output after the sum over the model ranks), so that a float32
    layer's split rounds as one process does."""
    a = activation(act)
    dt = x.dtype
    if wide:
        x = tp.wide(x)
    if split:
        x = tp.copy_to_model(x)
    w_gate, w_up = p["w_gate"].to(x.dtype), p["w_up"].to(x.dtype)
    if fused:
        # one matmul for gate and up
        gu = (x @ torch.cat([w_gate, w_up], dim=1)).to(dt)
        ff = w_gate.shape[1]
        h = a(gu[..., :ff]) * gu[..., ff:]
    else:
        h = a((x @ w_gate).to(dt)) * (x @ w_up).to(dt)
    out = h.to(x.dtype) @ p["w_down"].to(x.dtype)
    return (tp.reduce_from_model(out) if split else out).to(dt)
