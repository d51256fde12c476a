"""Decoder-only LM assembly: embeds -> repeated block pattern -> head
(port of ``repro.models.lm`` for the dense, MoE, SSM and hybrid
families: every layer is a mixer (attention, GQA or MLA; Mamba; mLSTM
or sLSTM) + a dense gated MLP, a mixture of experts or no FFN).

Layer stacking: per-pattern-position parameter *stacks* with leading
dim ``pattern_repeat``, as in the reference, so a tree bridges leaf for
leaf.  The reference's ``layer_mode`` "scan" and "unroll" are one loop
here over the stacked leaves (each stack is unbound once, so the
backward stacks its gradients once).  ``remat``: "full" recomputes each
block in the backward (``torch.utils.checkpoint``, non-reentrant),
"dots" saves the outputs of the matmuls without batch dims (the
projections, the MLP and the experts' gate and up products) and
recomputes the rest, "none" saves all.

Embeddings: a tied table goes in through a chunked one-hot matmul, as
the reference's; an untied one through a gather whose backward sums the
gradient's rows by token id (``segment_rows``: a sort and a sum per
id, the reference's scatter without float atomics).  Neither backward
uses atomics, so a step is bitwise reproducible on the card.  The loss
is computed in chunks over the tokens, each chunk's (tokens, vocab)
logits recomputed in the backward, so the full logits never
materialize.

The parameter tree pads an MoE layer's experts to a multiple of the
reference's model axis (``model_axis=16``: qwen2's 60 to 64 inert
experts), so a reference tree bridges leaf for leaf.  The VLM's vision
stub (qwen2-vl) projects precomputed patch embeddings through
``vision_proj`` and writes them over the first ``num_patches`` token
embeddings; its 3-D M-RoPE positions come with the batch.  The
encoder-decoder (whisper) lives in ``encdec.py`` and reuses the
embedding, the loss, remat and stacking from here.  The reference's
sharding constraints are dropped: a mesh step (``sharding.spmd``)
gathers each block's params inside its checkpointed function, and a
layer given its model block of the weights computes its part
(``sharding.tensor_parallel``): attention and MLA heads, the dense
FFN's units, an MoE's experts (or their units) and shared experts, the
vocabulary of the embedding and the loss.  The decode step splits the
same parts, its caches as ``cache_partition`` lays them out (by kv
heads or by head_dim, Mamba's states by channel).  xLSTM layers,
attention whose heads do not divide the model axis and Mamba whose
channels do not stay whole over it.
"""
from __future__ import annotations

import functools
from typing import Any, Dict, List, Optional, Tuple

import torch
import torch.nn.functional as F
from torch.utils.checkpoint import (CheckpointPolicy, checkpoint,
                                    create_selective_checkpoint_contexts)

from repro_torch.config.base import LayerSpec, ModelConfig
from repro_torch.sharding import tensor_parallel as tp
from repro_torch.tree import tree_leaves, tree_map, tree_unflatten
from .layers import attention as attn_lib
from .layers import mamba as mamba_lib
from .layers import mla as mla_lib
from .layers import moe as moe_lib
from .layers import xlstm as xlstm_lib
from .layers.common import (TensorSpec, activation, apply_mlp, apply_norm,
                            dtype_of, mlp_spec, norm_spec, sequential_loop)

Params = Dict[str, Any]

LOSS_CHUNK = 512
EMBED_CHUNK = 2048
EMBED_COLS = 1024
# the leaves outside the blocks, gathered once per step over a mesh
TOP_KEYS = ("embed", "lm_head", "final_norm", "vision_proj")


# ---------------------------------------------------------------------------
# Param specs


def _mixer_spec(spec: LayerSpec, cfg: ModelConfig, dtype) -> Params:
    a = cfg.attention
    if spec.mixer == "attn":
        if a.kind == "mla":
            return mla_lib.mla_spec(a, cfg.d_model, dtype)
        return attn_lib.attention_spec(a, cfg.d_model, dtype)
    if spec.mixer == "mamba":
        return mamba_lib.mamba_spec(cfg.ssm, cfg.d_model, dtype)
    if spec.mixer == "mlstm":
        return xlstm_lib.mlstm_spec(cfg.ssm, cfg.d_model, dtype)
    if spec.mixer == "slstm":
        return xlstm_lib.slstm_spec(cfg.ssm, cfg.d_model, dtype)
    raise ValueError(spec.mixer)


def _ffn_spec(spec: LayerSpec, cfg: ModelConfig, dtype,
              model_axis: int) -> Optional[Params]:
    if spec.ffn == "none":
        return None
    if spec.ffn == "dense":
        return mlp_spec(cfg.d_model, cfg.d_ff, dtype)
    return moe_lib.moe_spec(cfg.moe, cfg.d_model, dtype, model_axis)


def block_spec(spec: LayerSpec, cfg: ModelConfig, dtype,
               model_axis: int) -> Params:
    p: Params = {
        "ln1": norm_spec(cfg.d_model, cfg.norm, dtype),
        "mixer": _mixer_spec(spec, cfg, dtype),
    }
    ffn = _ffn_spec(spec, cfg, dtype, model_axis)
    if ffn is not None:
        p["ln2"] = norm_spec(cfg.d_model, cfg.norm, dtype)
        p["ffn"] = ffn
    return p


def _stack(tree: Params, n: int) -> Params:
    return tree_map(lambda s: TensorSpec((n,) + s.shape, s.dtype), tree)


def param_spec(cfg: ModelConfig, *, model_axis: int = 16) -> Params:
    """Full parameter tree of :class:`TensorSpec`.  ``blocks`` is a list
    over pattern positions, each the block tree stacked over
    ``pattern_repeat``; dense-prefix overrides are separate unstacked
    entries in ``prefix_blocks``.  MoE experts are padded to a multiple
    of ``model_axis`` (``moe.padded_num_experts``); a VLM adds the
    vision stub's ``vision_proj`` (patch_dim, d_model)."""
    dtype = dtype_of(cfg.dtype)
    rep = cfg.pattern_repeat
    v, d = cfg.vocab_size, cfg.d_model
    p: Params = {"embed": TensorSpec((v, d), dtype)}
    if not cfg.tie_embeddings:
        p["lm_head"] = TensorSpec((d, v), dtype)
    p["final_norm"] = norm_spec(d, cfg.norm, dtype)
    p["prefix_blocks"] = [
        block_spec(LayerSpec(mixer=s.mixer, ffn="dense", window=s.window),
                   cfg, dtype, model_axis)
        for s in cfg.layer_specs()[:cfg.num_dense_prefix]]
    p["blocks"] = [_stack(block_spec(spec, cfg, dtype, model_axis), rep)
                   for spec in cfg.pattern]
    if cfg.vision is not None:
        p["vision_proj"] = TensorSpec((cfg.vision.patch_dim, d), dtype)
    return p


# ---------------------------------------------------------------------------
# Embedding / head / loss


def _onehot_rows(tk: torch.Tensor, emb: torch.Tensor) -> torch.Tensor:
    return F.one_hot(tk.long(), emb.shape[0]).to(emb.dtype) @ emb


def _onehot_rows_from(tk: torch.Tensor, emb: torch.Tensor,
                      first: int) -> torch.Tensor:
    """``emb``'s rows of the ids ``first`` to ``first + len(emb)`` by a
    one-hot matmul; rows of other ids are zero (a vocabulary block)."""
    ids = torch.arange(first, first + emb.shape[0], device=tk.device)
    return (tk.long()[:, None] == ids[None, :]).to(emb.dtype) @ emb


def segment_rows(g: torch.Tensor, ids: torch.Tensor, n: int) -> torch.Tensor:
    """(n, D): row i the sum of ``g``'s rows whose id is i, in their
    order, in float32, cast back to ``g``'s dtype; zero where no id is i.
    The ids are sorted (stable), ``torch.segment_reduce`` sums each
    distinct id's run of rows on its own, ``EMBED_COLS`` columns at a
    time, and each sum is copied to its id's row: no float atomics, so
    two runs give the same bits, and the work follows the tokens, not
    the table."""
    ids = ids.reshape(-1).long()
    t = ids.shape[0]
    dev = ids.device
    order = torch.argsort(ids, stable=True)
    sid = ids[order]
    rows = g.reshape(t, -1)[order]
    # each sorted row's run, the index of its id among the distinct ids
    start = torch.ones(t, dtype=torch.bool, device=dev)
    start[1:] = sid[1:] != sid[:-1]
    run = torch.cumsum(start.long(), 0) - 1
    counts = torch.zeros(t, dtype=torch.long, device=dev).index_add_(
        0, run, torch.ones_like(run))
    # run k's id (every row of a run writes the same one); the slots
    # past the last run go to rows n + k, beyond the table
    ids_of = torch.zeros(t, dtype=torch.long, device=dev).scatter_(
        0, run, sid)
    dest = torch.where(counts > 0, ids_of,
                       n + torch.arange(t, device=dev))
    d = rows.shape[1]
    out = torch.zeros((n + t, d), dtype=g.dtype, device=g.device)
    for c in range(0, d, EMBED_COLS):
        sums = torch.segment_reduce(
            rows[:, c:c + EMBED_COLS].to(torch.float32), "sum",
            lengths=counts, axis=0, unsafe=True)
        out[:, c:c + EMBED_COLS].index_copy_(0, dest, sums.to(g.dtype))
    return out[:n]


class _GatherRows(torch.autograd.Function):
    """``emb[tokens]`` whose backward sums the output gradient's rows by
    token id (``segment_rows``): a scatter's arithmetic without float
    atomics."""

    @staticmethod
    def forward(ctx, emb, flat):
        ctx.save_for_backward(flat)
        ctx.vocab = emb.shape[0]
        return emb[flat.long()]

    @staticmethod
    def backward(ctx, g):
        (flat,) = ctx.saved_tensors
        return segment_rows(g, flat, ctx.vocab), None


def _maybe_checkpoint(fn, *args):
    if torch.is_grad_enabled():
        return checkpoint(fn, *args, use_reentrant=False)
    return fn(*args)


def embed_tokens(cfg: ModelConfig, params: Params,
                 tokens: torch.Tensor) -> torch.Tensor:
    """(B, S, D) token embeddings.  Given this rank's model block of the
    table (a step that splits the model axis): an untied table's columns
    are looked up and gathered over the model axis; a tied table's
    vocabulary rows are looked up (zeros for other ids) and summed over
    it."""
    emb = params["embed"]
    b, s = tokens.shape
    flat = tokens.reshape(-1)
    if not cfg.tie_embeddings:
        x = _GatherRows.apply(emb, flat)
        if emb.shape[1] != cfg.d_model:
            x = tp.gather_from_model(x, -1)
        return x.reshape(b, s, cfg.d_model)
    # Tied: chunked one-hot matmul, each chunk recomputed in backward.
    n = flat.shape[0]
    chunk = min(EMBED_CHUNK, n)
    if emb.shape[0] != cfg.vocab_size:
        first = tp.model_rank() * emb.shape[0]
        xs = [_maybe_checkpoint(_onehot_rows_from, flat[c:c + chunk], emb,
                                first) for c in range(0, n, chunk)]
        x = tp.reduce_from_model(torch.cat(xs, dim=0))
        return x.reshape(b, s, cfg.d_model)
    xs = [_maybe_checkpoint(_onehot_rows, flat[c:c + chunk], emb)
          for c in range(0, n, chunk)]
    return torch.cat(xs, dim=0).reshape(b, s, cfg.d_model)


def _head_logits(cfg: ModelConfig, params: Params,
                 x: torch.Tensor) -> torch.Tensor:
    """x: (..., D) -> logits (..., V)."""
    if cfg.tie_embeddings:
        return x @ params["embed"].t()
    return x @ params["lm_head"]


def _ce_chunk(cfg, params, xc, lc):
    logits = _head_logits(cfg, params, xc).float()
    lse = torch.logsumexp(logits, dim=-1)
    iota = torch.arange(cfg.vocab_size, device=lc.device)[None, :]
    ll = torch.sum(torch.where(iota == lc[:, None], logits, 0.0), dim=-1)
    return torch.sum(torch.where(lc >= 0, lse - ll, 0.0))


def _ce_stats(cfg, params, xc, lc):
    """Per token of a chunk, over this rank's block of the vocabulary:
    the largest logit (no gradient), the sum of exponentials below it
    and the label's logit (0 where the label is another rank's)."""
    logits = _head_logits(cfg, params, xc).float()
    v = logits.shape[-1]
    mx = torch.amax(logits.detach(), dim=-1)
    se = torch.sum(torch.exp(logits - mx[:, None]), dim=-1)
    iota = torch.arange(v, device=lc.device)[None, :] + tp.model_rank() * v
    ll = torch.sum(torch.where(iota == lc[:, None], logits, 0.0), dim=-1)
    return mx, se, ll


def chunked_ce_loss(cfg: ModelConfig, params: Params, x: torch.Tensor,
                    labels: torch.Tensor) -> torch.Tensor:
    """Mean cross-entropy without materializing (tokens, vocab) logits:
    chunks of ``LOSS_CHUNK * batch`` tokens, each recomputed in the
    backward, summed in order in float32.  Given this rank's block of
    the head's vocabulary, the loss is vocabulary-parallel: each chunk
    gives its tokens' statistics over the block (``_ce_stats``), and
    after the chunks the max, the sum of exponentials and the label's
    logit are reduced over the model axis in float32, once for all the
    tokens."""
    b, s, d = x.shape
    xf = x.reshape(b * s, d)
    lf = labels.reshape(b * s)
    head = params["embed"] if cfg.tie_embeddings else params["lm_head"]
    split = head.shape[0 if cfg.tie_embeddings else 1] != cfg.vocab_size
    if split:
        xf = tp.copy_to_model(xf)
    n = xf.shape[0]
    chunk = min(LOSS_CHUNK * max(1, b), n)
    pad = (-n) % chunk
    if pad:
        xf = F.pad(xf, (0, 0, 0, pad))
        lf = F.pad(lf, (0, pad), value=-1)
    tot = torch.zeros((), dtype=torch.float32, device=x.device)
    stats = []
    with sequential_loop("ce_chunks", xf.shape[0] // chunk) as steps:
        xs, ls = steps.pieces(xf, 0, chunk), steps.pieces(lf, 0, chunk)
        for c in steps:
            if split:
                stats.append(_maybe_checkpoint(
                    functools.partial(_ce_stats, cfg), params, xs[c], ls[c]))
            else:
                tot = tot + _maybe_checkpoint(
                    functools.partial(_ce_chunk, cfg), params, xs[c], ls[c])
        if split:
            mx, se, ll = (steps.join(list(t), 0, stack=False)
                          for t in zip(*stats))
    if split:
        top = tp.max_over_model(mx)
        lse = top + torch.log(tp.reduce_from_model(se * torch.exp(mx - top)))
        ll = tp.reduce_from_model(ll)
        tot = torch.sum(torch.where(lf >= 0, lse - ll, 0.0))
    return tot / n


# ---------------------------------------------------------------------------
# Block application


def _resolve_window(spec: LayerSpec, cfg: ModelConfig) -> int:
    if spec.window is not None:
        return spec.window
    return cfg.attention.window


def apply_block(spec: LayerSpec, cfg: ModelConfig, p: Params,
                x: torch.Tensor, *, positions=None, q_chunk: int = 512
                ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Returns (x, moe_aux_loss) — the aux loss is 0 for a dense FFN."""
    a = cfg.attention
    if cfg.attn_chunk:
        q_chunk = cfg.attn_chunk
    aux = torch.zeros((), dtype=torch.float32, device=x.device)
    h = apply_norm(p["ln1"], x, cfg.norm)
    if spec.mixer == "attn":
        if a.kind == "mla":
            h = mla_lib.apply_mla(p["mixer"], a, h, q_chunk=q_chunk,
                                  impl=cfg.attn_impl)
        else:
            h = attn_lib.apply_attention(
                p["mixer"], a, h, causal=True,
                window=_resolve_window(spec, cfg), positions=positions,
                q_chunk=q_chunk, impl=cfg.attn_impl,
                fused_qkv=cfg.fused_qkv)
    elif spec.mixer == "mamba":
        h = mamba_lib.apply_mamba(p["mixer"], cfg.ssm, h)
    elif spec.mixer == "mlstm":
        h = xlstm_lib.apply_mlstm(p["mixer"], cfg.ssm, h)
    elif spec.mixer == "slstm":
        h = xlstm_lib.apply_slstm(p["mixer"], cfg.ssm, h)
    else:
        raise ValueError(spec.mixer)
    x = x + h
    if spec.ffn != "none":
        h = apply_norm(p["ln2"], x, cfg.norm)
        if spec.ffn == "dense":
            h = apply_mlp(p["ffn"], h, cfg.act, fused=cfg.fused_qkv,
                          split=p["ffn"]["w_down"].shape[-2] != cfg.d_ff)
        else:
            h, aux = moe_lib.apply_moe(p["ffn"], cfg.moe, h,
                                       activation(cfg.act),
                                       dispatch=cfg.moe_dispatch)
        x = x + h
    return x, aux


_MATMULS = (torch.ops.aten.mm.default, torch.ops.aten.addmm.default)


def _save_dots(ctx, op, *args, **kwargs):
    """The reference's ``checkpoint_dots_with_no_batch_dims``: keep the
    2-D matmuls (a (B, S, D) @ (D, F) product folds to one), recompute
    everything else, the batched attention products included."""
    if op in _MATMULS:
        return CheckpointPolicy.MUST_SAVE
    return CheckpointPolicy.PREFER_RECOMPUTE


def _remat(fn, policy: str, keep=None):
    """``fn`` under the remat ``policy``; ``keep``: the selective policy
    that "full" takes instead of recomputing every op (an MoE block's,
    ``moe.keep_policy``)."""
    if policy not in ("none", "full", "dots"):
        raise ValueError(f"remat {policy!r}: 'none', 'full' or 'dots'")
    pick = {"dots": _save_dots, "full": keep}.get(policy)

    def run(p, x, *rest):
        if policy == "none" or not torch.is_grad_enabled():
            return fn(p, x, *rest)
        if pick is not None:
            return checkpoint(fn, p, x, *rest, use_reentrant=False,
                              context_fn=functools.partial(
                                  create_selective_checkpoint_contexts,
                                  pick))
        return checkpoint(fn, p, x, *rest, use_reentrant=False)
    return run


def _unstack(tree, n: int) -> List[Any]:
    """A stacked tree -> n trees, one per repeat (each leaf unbound
    once)."""
    cols = [leaf.unbind(0) for leaf in tree_leaves(tree)]
    return [tree_unflatten(tree, [c[r] for c in cols]) for r in range(n)]


def _check_layer_mode(layer_mode: str) -> None:
    if layer_mode not in ("scan", "unroll"):
        raise ValueError(f"layer_mode {layer_mode!r}: 'scan' or 'unroll'")


def heads_split(a) -> bool:
    """Whether a step splitting the model axis computes attention ``a``
    split: its heads divide the axis, and a grouped-query layer's kv
    columns too."""
    n = tp.model_size()
    return a.num_heads % n == 0 and (a.kind == "mla" or a.kv_dim % n == 0)


def _split_parts(spec: LayerSpec, cfg: ModelConfig) -> Tuple[str, ...]:
    """The parts of a block that a step splitting the model axis
    computes split: attention (grouped-query or MLA) whose heads divide
    the axis (and a grouped-query layer's kv columns), an FFN, dense or
    MoE: ``param_partition`` puts a dim of it on the model axis only
    where the axis divides it, which for an FFN is a block of whole
    units or experts, and the MoE layer splits its routed and shared
    parts each where its weights are blocks; Mamba whose channels
    (``expand * d_model``) divide the axis, every leaf of it then a
    block of whole channels.  xLSTM stays whole."""
    out = []
    if spec.mixer == "attn" and heads_split(cfg.attention):
        out.append("mixer")
    if spec.mixer == "mamba" \
            and cfg.ssm.expand * cfg.d_model % tp.model_size() == 0:
        out.append("mixer")
    if spec.ffn != "none":
        out.append("ffn")
    return tuple(out)


def gathering(fn, sh, split=(), *, stacked: bool = False):
    """``fn(p, x, *rest)`` with the block's params ``p`` gathered first
    (``tensor_parallel.gather_block`` by the block's shardings ``sh``),
    inside whatever checkpoint wraps it; ``fn`` itself without a step
    layout."""
    if sh is None:
        return fn

    def run(p, x, *rest):
        return fn(tp.gather_block(p, sh, split, stacked=stacked), x, *rest)
    return run


def apply_stack(cfg: ModelConfig, params: Params, x: torch.Tensor, *,
                positions=None, layer_mode: str = "scan",
                remat: str = "full", q_chunk: int = 512
                ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Run all layers. Returns (x, total_moe_aux).  Under a mesh step's
    layout each block's params are gathered inside its checkpointed
    function (so the backward gathers them again)."""
    _check_layer_mode(layer_mode)
    aux_total = torch.zeros((), dtype=torch.float32, device=x.device)
    n_prefix = cfg.num_dense_prefix
    specs = cfg.layer_specs()
    sh = tp.shardings_of()

    def block(spec, bsh, stacked):
        fn = functools.partial(apply_block, spec, cfg, positions=positions,
                               q_chunk=q_chunk)
        keep = moe_lib.keep_policy if spec.ffn == "moe" else None
        return _remat(gathering(fn, bsh, _split_parts(spec, cfg),
                                stacked=stacked), remat, keep)

    for i, bp in enumerate(params["prefix_blocks"]):
        s = LayerSpec(mixer=specs[i].mixer, ffn="dense",
                      window=specs[i].window)
        x, aux = block(s, None if sh is None else sh["prefix_blocks"][i],
                       False)(bp, x)
        aux_total = aux_total + aux
    if n_prefix:
        # the prefix layers replace the first repeats of the pattern
        assert len(cfg.pattern) == 1, (
            "num_dense_prefix requires pattern length 1")
    rep = cfg.pattern_repeat
    stacks = [_unstack(params["blocks"][j], rep)
              for j in range(len(cfg.pattern))]
    fns = [block(spec, None if sh is None else sh["blocks"][j], True)
           for j, spec in enumerate(cfg.pattern)]
    for r in range(n_prefix, rep):
        for j, fn in enumerate(fns):
            x, aux = fn(stacks[j][r], x)
            aux_total = aux_total + aux
    return x, aux_total


# ---------------------------------------------------------------------------
# Train-mode forward + loss


def embed_inputs(cfg: ModelConfig, params: Params, tokens: torch.Tensor,
                 patch_embeds: Optional[torch.Tensor] = None
                 ) -> torch.Tensor:
    """Token embeddings (B, S, D); given a VLM's ``patch_embeds``
    (B, P, patch_dim), their projection through ``vision_proj``
    replaces the first P token embeddings (the reference's
    ``dynamic_update_slice`` at 0, whose update must fit: S >= P)."""
    x = embed_tokens(cfg, params, tokens)
    if cfg.vision is None or patch_embeds is None:
        return x
    patches = patch_embeds.to(x.dtype) @ params["vision_proj"]
    npatch, s = patches.shape[1], x.shape[1]
    if s < npatch:
        raise ValueError(
            f"{cfg.name}: {npatch} patch embeddings do not fit in {s} "
            "tokens; they overwrite the first num_patches token "
            "embeddings, so the sequence must hold at least as many")
    return torch.cat([patches, x[:, npatch:]], dim=1)


def lm_loss(cfg: ModelConfig, params: Params, batch: Dict[str, Any], *,
            layer_mode: str = "scan", remat: str = "full",
            q_chunk: int = 512
            ) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
    """Mean CE (+ the MoE aux loss).  A VLM's batch carries
    ``patch_embeds`` and, optionally, ``positions`` (B, S, 3) for
    M-RoPE (text-only ids when absent)."""
    positions = None
    if cfg.vision is not None:
        if "patch_embeds" not in batch:
            raise ValueError(
                f"{cfg.name}: the vision stub needs patch_embeds (B, "
                f"{cfg.vision.num_patches}, {cfg.vision.patch_dim})")
        positions = batch.get("positions")
    params = tp.gather_top(params, TOP_KEYS, split=("embed", "lm_head"))
    x = embed_inputs(cfg, params, batch["tokens"], batch.get("patch_embeds"))
    x, aux = apply_stack(cfg, params, x, positions=positions,
                         layer_mode=layer_mode, remat=remat, q_chunk=q_chunk)
    x = apply_norm(params["final_norm"], x, cfg.norm)
    ce = chunked_ce_loss(cfg, params, x, batch["labels"])
    return ce + aux, {"ce": ce, "moe_aux": aux}


def prefill_logits(cfg: ModelConfig, params: Params, tokens: torch.Tensor,
                   *, patch_embeds: Optional[torch.Tensor] = None,
                   positions: Optional[torch.Tensor] = None,
                   q_chunk: int = 512) -> torch.Tensor:
    """The forward of ``lm_loss`` up to the head: float32 logits
    (B, S, V) at every position (to hold decode against; it
    materializes the full logits).  ``patch_embeds`` and ``positions``
    as in ``lm_loss``'s batch; a VLM without them reads a text-only
    prompt (M-RoPE with t = h = w)."""
    x = embed_inputs(cfg, params, tokens, patch_embeds)
    x, _ = apply_stack(cfg, params, x, positions=positions, remat="none",
                       q_chunk=q_chunk)
    x = apply_norm(params["final_norm"], x, cfg.norm)
    return _head_logits(cfg, params, x).float()


# ---------------------------------------------------------------------------
# Decode: state spec + one step


def _mixer_cache_spec(spec: LayerSpec, cfg: ModelConfig, batch: int,
                      seq: int, dtype) -> Params:
    a = cfg.attention
    if spec.mixer == "attn":
        if a.kind == "mla":
            return mla_lib.mla_cache_spec(a, batch, seq, dtype)
        return attn_lib.cache_spec(a, batch, seq, _resolve_window(spec, cfg),
                                   dtype)
    if spec.mixer == "mamba":
        return mamba_lib.mamba_state_spec(cfg.ssm, cfg.d_model, batch, dtype)
    if spec.mixer == "mlstm":
        return xlstm_lib.mlstm_state_spec(cfg.ssm, cfg.d_model, batch, dtype)
    if spec.mixer == "slstm":
        return xlstm_lib.slstm_state_spec(cfg.ssm, cfg.d_model, batch, dtype)
    raise ValueError(spec.mixer)


def decode_state_spec(cfg: ModelConfig, batch: int, seq: int) -> Params:
    """Tree of :class:`TensorSpec` for the decode cache."""
    dtype = dtype_of(cfg.dtype)
    rep = cfg.pattern_repeat
    st: Params = {"pos": TensorSpec((), torch.int32)}
    st["prefix_blocks"] = [
        _mixer_cache_spec(s, cfg, batch, seq, dtype)
        for s in cfg.layer_specs()[:cfg.num_dense_prefix]]
    st["blocks"] = [_stack(_mixer_cache_spec(spec, cfg, batch, seq, dtype),
                           rep) for spec in cfg.pattern]
    return st


def with_minus_inf_stabilizers(state: Params) -> Params:
    """``state`` with every xLSTM stabilizer ``m`` (the mLSTM's and the
    sLSTM's) at -inf, the start the prefill forward takes, so that
    decode from it follows prefill.  A zero state (``launch.serve``'s,
    as the reference's) starts them at 0, where the sLSTM's output
    differs."""
    def fix(cache):
        if "m" not in cache:
            return cache
        return dict(cache, m=torch.full_like(cache["m"], float("-inf")))
    return dict(state, prefix_blocks=[fix(c) for c in state["prefix_blocks"]],
                blocks=[fix(c) for c in state["blocks"]])


def _decode_mixer(spec: LayerSpec, cfg: ModelConfig, p, h, cache, pos):
    a = cfg.attention
    if spec.mixer == "attn":
        if a.kind == "mla":
            return mla_lib.decode_mla(p["mixer"], a, h, cache, pos)
        return attn_lib.decode_attention(p["mixer"], a, h, cache, pos,
                                         window=_resolve_window(spec, cfg))
    if spec.mixer == "mamba":
        return mamba_lib.decode_mamba(p["mixer"], cfg.ssm, h, cache)
    if spec.mixer == "mlstm":
        return _whole_state(xlstm_lib.decode_mlstm, spec, cfg, p, h, cache)
    if spec.mixer == "slstm":
        return _whole_state(xlstm_lib.decode_slstm, spec, cfg, p, h, cache)
    raise ValueError(spec.mixer)


def _whole_state(fn, spec: LayerSpec, cfg: ModelConfig, p, h, cache):
    """``fn``, an xLSTM layer's decode, which runs whole over the model
    axis: a state leaf that ``cache_partition`` splits over it (narrower
    than ``decode_state_spec``'s: the mLSTM's ``conv`` by channel, the
    sLSTM's ``h`` by head) is gathered whole for the layer, and the
    rank's block of the new leaf kept."""
    whole = _mixer_cache_spec(spec, cfg, h.shape[0], 1, h.dtype)
    dims = {k: next((d for d, (a, b) in enumerate(
        zip(t.shape, whole[k].shape)) if a != b), None)
        for k, t in cache.items()}
    if all(d is None for d in dims.values()):
        return fn(p["mixer"], cfg.ssm, h, cache)
    out, new = fn(p["mixer"], cfg.ssm, h, {
        k: t if dims[k] is None else tp.gather_from_model(t, dims[k])
        for k, t in cache.items()})
    r = tp.model_rank()
    return out, {k: t if dims[k] is None else t.narrow(
        dims[k], r * cache[k].shape[dims[k]],
        cache[k].shape[dims[k]]).contiguous() for k, t in new.items()}


def _decode_block(spec: LayerSpec, cfg: ModelConfig, p, x, cache, pos):
    h = apply_norm(p["ln1"], x, cfg.norm)
    h, new_cache = _decode_mixer(spec, cfg, p, h, cache, pos)
    x = x + h
    if spec.ffn != "none":
        h = apply_norm(p["ln2"], x, cfg.norm)
        if spec.ffn == "dense":
            h = apply_mlp(p["ffn"], h, cfg.act, fused=cfg.fused_qkv,
                          split=p["ffn"]["w_down"].shape[-2] != cfg.d_ff)
        else:
            # decode always takes the dense dispatch, as the reference's
            h, _ = moe_lib.apply_moe(p["ffn"], cfg.moe, h,
                                     activation(cfg.act))
        x = x + h
    return x, new_cache


# the leaves outside the blocks that decode reads, gathered once a step
DECODE_TOP_KEYS = ("embed", "lm_head", "final_norm")


def decode_logits(cfg: ModelConfig, params: Params,
                  x: torch.Tensor) -> torch.Tensor:
    """x: (B, D) -> float32 logits (B, V); given this rank's vocabulary
    block of the head (a step that splits the model axis) the rank's
    (B, V / m) logits are gathered over the model axis."""
    logits = _head_logits(cfg, params, x)
    if logits.shape[-1] != cfg.vocab_size:
        logits = tp.gather_from_model(logits, -1)
    return logits.float()


def decode_step(cfg: ModelConfig, params: Params, state: Params,
                token: torch.Tensor, *, layer_mode: str = "scan"
                ) -> Tuple[torch.Tensor, Params]:
    """One token for the whole batch.  token: (B, 1) int.  Returns
    (logits (B, vocab) float32, new state); ``state`` is left as it
    was.  Under a mesh step's layout each block's params are gathered
    before it, the parts of ``_split_parts`` kept as the rank's model
    block (as ``apply_stack`` does); each layer reads its cache's split
    from the cache's shapes (``cache_partition``'s layout)."""
    _check_layer_mode(layer_mode)
    pos = state["pos"]
    sh = tp.shardings_of()
    params = tp.gather_top(params, DECODE_TOP_KEYS,
                           split=("embed", "lm_head"))
    x = embed_tokens(cfg, params, token)
    new_state: Params = {"pos": pos + 1}
    specs = cfg.layer_specs()

    def block(spec, bsh, stacked):
        return gathering(functools.partial(_decode_block, spec, cfg), bsh,
                         _split_parts(spec, cfg), stacked=stacked)

    new_state["prefix_blocks"] = []
    for i, bp in enumerate(params["prefix_blocks"]):
        s = LayerSpec(mixer=specs[i].mixer, ffn="dense",
                      window=specs[i].window)
        x, c = block(s, None if sh is None else sh["prefix_blocks"][i],
                     False)(bp, x, state["prefix_blocks"][i], pos)
        new_state["prefix_blocks"].append(c)

    n_prefix = cfg.num_dense_prefix
    rep = cfg.pattern_repeat
    new_state["blocks"] = []
    for j, spec in enumerate(cfg.pattern):
        ps = _unstack(params["blocks"][j], rep)
        cs = _unstack(state["blocks"][j], rep)
        fn = block(spec, None if sh is None else sh["blocks"][j], True)
        if n_prefix and j == 0:
            assert len(cfg.pattern) == 1
        # each layer's new cache copied into its slot as it comes, so
        # that no second copy of the stack is ever live
        out = tree_map(torch.empty_like, state["blocks"][j])
        for r in range(rep):
            c = cs[r]
            if r >= (n_prefix if j == 0 else 0):
                x, c = fn(ps[r], x, c, pos)
            tree_map(lambda o, n: o[r].copy_(n), out, c)
        new_state["blocks"].append(out)
    x = apply_norm(params["final_norm"], x, cfg.norm)
    return decode_logits(cfg, params, x[:, 0]), new_state
