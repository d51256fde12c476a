"""gemma3-12b [dense] — 48L d_model=3840 16H (GQA kv=8) d_ff=15360
vocab=262144.  5:1 local:global attention interleave, 128k context.
[hf:google/gemma-3-1b-pt pattern, scaled]

The 5 local layers use a 1024-token sliding window; every 6th layer is
global.  Because decode-time attention cost is linear in cache length and
5/6 of the layers have a bounded (1024) working set, gemma3 runs the
long_500k decode shape (see DESIGN.md §Arch-applicability).

(A copy of ``repro.configs.gemma3_12b``.)
"""
from repro_torch.config import AttentionConfig, LayerSpec, ModelConfig, register

_WINDOW = 1024


def full() -> ModelConfig:
    local = LayerSpec(mixer="attn", ffn="dense", window=_WINDOW)
    glob = LayerSpec(mixer="attn", ffn="dense", window=0)
    return ModelConfig(
        name="gemma3-12b",
        family="dense",
        num_layers=48,
        d_model=3840,
        d_ff=15360,
        vocab_size=262144,
        attention=AttentionConfig(
            kind="gqa", num_heads=16, num_kv_heads=8, head_dim=256,
            rope_theta=1_000_000.0,
        ),
        pattern=(local, local, local, local, local, glob),
        act="gelu",
        norm="rmsnorm",
        tie_embeddings=True,
        sub_quadratic=True,  # 5/6 layers have bounded window
        max_seq_len=131_072,
    )


def reduced() -> ModelConfig:
    local = LayerSpec(mixer="attn", ffn="dense", window=32)
    glob = LayerSpec(mixer="attn", ffn="dense", window=0)
    return ModelConfig(
        name="gemma3-12b-reduced",
        family="dense",
        num_layers=6,
        d_model=48,
        d_ff=96,
        vocab_size=256,
        attention=AttentionConfig(
            kind="gqa", num_heads=2, num_kv_heads=1, head_dim=24,
            rope_theta=1_000_000.0,
        ),
        pattern=(local, local, local, local, local, glob),
        act="gelu",
        norm="rmsnorm",
        tie_embeddings=True,
        sub_quadratic=True,
        max_seq_len=512,
    )


register("gemma3-12b", full, reduced)
