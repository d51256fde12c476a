"""Configuration dataclasses (port of ``repro.config.base``: copies of
the reference's jax-free dataclasses, field for field and default for
default, so that ``config_fingerprint`` of an equal config gives the
reference's 16 hex characters).

Every LM architecture in ``repro_torch.configs`` builds a
:class:`ModelConfig`; a launch combines it with a :class:`ShapeConfig`
and a :class:`TrainConfig`.  :class:`MeshConfig` is kept for the
fingerprint and the launcher's flags: the port runs one device.
"""
from __future__ import annotations

import dataclasses
import hashlib
import json
from dataclasses import dataclass, field
from typing import Any, Optional, Tuple

# ---------------------------------------------------------------------------
# Attention


@dataclass(frozen=True)
class AttentionConfig:
    """Configuration of the attention sub-block.

    kind:
      - "gqa":    grouped-query attention (num_kv_heads groups). MQA when
                  num_kv_heads == 1, MHA when num_kv_heads == num_heads.
      - "mla":    DeepSeek-style multi-head latent attention with a low-rank
                  compressed KV cache (kv_lora_rank) and decoupled RoPE keys.
      - "none":   no attention in this block type (SSM-only models).
    """

    kind: str = "gqa"
    num_heads: int = 0
    num_kv_heads: int = 0
    head_dim: int = 0
    rope_kind: str = "rope"  # "rope" | "mrope" | "none"
    rope_theta: float = 10_000.0
    # Sliding-window ("local") attention. 0 = full/global attention.
    window: int = 0
    # MLA-only fields.
    kv_lora_rank: int = 0
    q_lora_rank: int = 0
    rope_head_dim: int = 0
    nope_head_dim: int = 0
    # M-RoPE (qwen2-vl): dims split across (temporal, height, width) sections.
    mrope_sections: Tuple[int, ...] = ()

    @property
    def q_dim(self) -> int:
        return self.num_heads * self.head_dim

    @property
    def kv_dim(self) -> int:
        return self.num_kv_heads * self.head_dim


# ---------------------------------------------------------------------------
# MoE


@dataclass(frozen=True)
class MoEConfig:
    """Mixture-of-experts FFN configuration.

    ``router_type`` selects the routing function:
      - "linear":   standard learned linear router (paper baselines).
      - "neuralut": a NeuraLUT sparse-quantized router — the paper's technique
                    applied beyond-paper to MoE routing (see DESIGN.md).
    """

    num_experts: int = 0
    top_k: int = 0
    num_shared: int = 0
    d_ff_expert: int = 0
    d_ff_shared: int = 0
    router_type: str = "linear"
    # Load-balancing auxiliary loss coefficient.
    aux_loss_coef: float = 0.01
    # Expert parallelism: pad num_experts up to a multiple of the model axis
    # so the expert dim shards evenly ("ep"), or shard each expert's d_ff
    # ("tp"). "auto" picks "ep" when divisible, else pads.
    sharding: str = "auto"


# ---------------------------------------------------------------------------
# Per-layer block specification


@dataclass(frozen=True)
class LayerSpec:
    """One circuit in the repeating layer pattern of a model.

    mixer: "attn" | "mamba" | "mlstm" | "slstm"
    ffn:   "dense" | "moe" | "none"
    attn_override: optional per-layer attention override (e.g. gemma3 uses
      window=0 on every 6th layer, sliding window elsewhere).
    """

    mixer: str = "attn"
    ffn: str = "dense"
    window: Optional[int] = None  # None = use model default


# ---------------------------------------------------------------------------
# SSM blocks


@dataclass(frozen=True)
class SSMConfig:
    """Mamba/xLSTM state-space mixer configuration."""

    d_state: int = 16
    d_conv: int = 4
    expand: int = 2
    dt_rank: int = 0  # 0 => ceil(d_model / 16)
    # xLSTM specifics
    num_heads: int = 4
    proj_factor: float = 2.0


# ---------------------------------------------------------------------------
# Encoder (whisper-style enc-dec)


@dataclass(frozen=True)
class EncoderConfig:
    num_layers: int = 0
    seq_len: int = 1500  # post-conv frame count (conv frontend is a stub)
    feature_dim: int = 0  # dim of precomputed frame/patch embeddings


@dataclass(frozen=True)
class VisionStubConfig:
    """VLM modality frontend stub: input_specs() provides patch embeddings."""

    num_patches: int = 0
    patch_dim: int = 0


# ---------------------------------------------------------------------------
# Model


@dataclass(frozen=True)
class ModelConfig:
    name: str
    family: str  # "dense" | "moe" | "ssm" | "hybrid" | "audio" | "vlm"
    num_layers: int = 0
    d_model: int = 0
    d_ff: int = 0
    vocab_size: int = 0
    attention: AttentionConfig = field(default_factory=AttentionConfig)
    moe: Optional[MoEConfig] = None
    ssm: Optional[SSMConfig] = None
    encoder: Optional[EncoderConfig] = None
    vision: Optional[VisionStubConfig] = None
    # The repeating superblock pattern; len(pattern) * pattern_repeat
    # must equal num_layers.  A pattern of a single LayerSpec covers
    # homogeneous models.
    pattern: Tuple[LayerSpec, ...] = (LayerSpec(),)
    # First `num_dense_prefix` layers force a dense FFN (deepseek-v2 layer 0).
    num_dense_prefix: int = 0
    norm: str = "rmsnorm"  # "rmsnorm" | "layernorm"
    act: str = "silu"  # "silu" | "gelu"
    tie_embeddings: bool = False
    dtype: str = "bfloat16"
    # True if the model can run the long_500k decode shape (sub-quadratic
    # sequence mixing or a bounded attention working set).
    sub_quadratic: bool = False
    # Max position embeddings / rope length (informational).
    max_seq_len: int = 131_072
    # Notes rendered into DESIGN.md §Arch-applicability.
    notes: str = ""
    # --- performance knobs (EXPERIMENTS.md §Perf) -------------------------
    # "chunked": one-level q-chunking, full-row softmax (baseline;
    #            materializes (cq, T) scores).
    # "flash":   two-level online-softmax over KV chunks (beyond-paper opt).
    attn_impl: str = "chunked"
    # "dense": every expert on every token (baseline); "sparse_capacity":
    # GShard-style capacity dispatch.
    moe_dispatch: str = "dense"
    # attention tile size override (0 = launcher default).
    attn_chunk: int = 0
    # Fuse the q/k/v (and gate/up) projections into single matmuls and
    # repeat KV heads *in the weights*.
    fused_qkv: bool = False
    # The reference's sharding layouts (head_dim over the model axis; a
    # sequence-sharded residual stream).  One device has no sharding:
    # kept for the fingerprint, they change nothing in the port.
    head_dim_sharding: bool = False
    seq_shard_residual: bool = False

    @property
    def pattern_repeat(self) -> int:
        assert self.num_layers % len(self.pattern) == 0, (
            f"{self.name}: num_layers={self.num_layers} not divisible by "
            f"pattern of length {len(self.pattern)}"
        )
        return self.num_layers // len(self.pattern)

    def layer_specs(self) -> Tuple[LayerSpec, ...]:
        """The fully unrolled per-layer spec list (len == num_layers)."""
        specs = list(self.pattern) * self.pattern_repeat
        out = []
        for i, s in enumerate(specs):
            if i < self.num_dense_prefix and s.ffn == "moe":
                s = dataclasses.replace(s, ffn="dense")
            out.append(s)
        return tuple(out)


# ---------------------------------------------------------------------------
# Shapes


@dataclass(frozen=True)
class ShapeConfig:
    name: str
    kind: str  # "train" | "prefill" | "decode"
    seq_len: int
    global_batch: int


TRAIN_4K = ShapeConfig("train_4k", "train", 4_096, 256)
PREFILL_32K = ShapeConfig("prefill_32k", "prefill", 32_768, 32)
DECODE_32K = ShapeConfig("decode_32k", "decode", 32_768, 128)
LONG_500K = ShapeConfig("long_500k", "decode", 524_288, 1)

SHAPES = {s.name: s for s in (TRAIN_4K, PREFILL_32K, DECODE_32K, LONG_500K)}


# ---------------------------------------------------------------------------
# Mesh


@dataclass(frozen=True)
class MeshConfig:
    """Logical device mesh. axes are (pod?, data, model)."""

    shape: Tuple[int, ...] = (16, 16)
    axes: Tuple[str, ...] = ("data", "model")

    @property
    def num_devices(self) -> int:
        n = 1
        for s in self.shape:
            n *= s
        return n

    @property
    def data_axes(self) -> Tuple[str, ...]:
        """Axes over which the batch is sharded (pod folds into data)."""
        return tuple(a for a in self.axes if a in ("pod", "data"))

    @property
    def model_axis(self) -> str:
        return "model"


SINGLE_POD = MeshConfig((16, 16), ("data", "model"))
MULTI_POD = MeshConfig((2, 16, 16), ("pod", "data", "model"))


# ---------------------------------------------------------------------------
# Training hyper-parameters (paper: AdamW + SGDR warm restarts)


@dataclass(frozen=True)
class TrainConfig:
    lr: float = 1e-3
    weight_decay: float = 0.0
    beta1: float = 0.9
    beta2: float = 0.999
    eps: float = 1e-8
    # SGDR (Loshchilov & Hutter): cosine annealing with warm restarts.
    sgdr_t0: int = 100
    sgdr_t_mult: int = 2
    lr_min: float = 1e-5
    grad_clip: float = 1.0
    # Microbatching: number of gradient-accumulation steps.
    grad_accum: int = 1
    # Remat policy: "none" | "full" | "dots"
    remat: str = "full"
    # Layer stacking: "scan" (production) | "unroll" (dry-run accounting)
    layer_mode: str = "scan"
    seed: int = 0


# ---------------------------------------------------------------------------
# Utilities


def config_fingerprint(cfg: Any) -> str:
    """Stable short hash of any (nested) dataclass config."""

    def enc(o: Any) -> Any:
        if dataclasses.is_dataclass(o) and not isinstance(o, type):
            return {f.name: enc(getattr(o, f.name)) for f in dataclasses.fields(o)}
        if isinstance(o, (list, tuple)):
            return [enc(x) for x in o]
        if isinstance(o, dict):
            return {k: enc(v) for k, v in o.items()}
        return o

    blob = json.dumps(enc(cfg), sort_keys=True).encode()
    return hashlib.sha256(blob).hexdigest()[:16]
