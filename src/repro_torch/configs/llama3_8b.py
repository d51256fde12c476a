"""llama3-8b [dense] — 32L d_model=4096 32H (GQA kv=8) d_ff=14336 vocab=128256.

GQA, 128k vocab. [arXiv:2407.21783]
Pure full attention => long_500k decode shape is skipped (see DESIGN.md).

(A copy of ``repro.configs.llama3_8b``.)
"""
from repro_torch.config import AttentionConfig, LayerSpec, ModelConfig, register


def full() -> ModelConfig:
    return ModelConfig(
        name="llama3-8b",
        family="dense",
        num_layers=32,
        d_model=4096,
        d_ff=14336,
        vocab_size=128256,
        attention=AttentionConfig(
            kind="gqa", num_heads=32, num_kv_heads=8, head_dim=128,
            rope_theta=500_000.0,
        ),
        pattern=(LayerSpec(mixer="attn", ffn="dense"),),
        act="silu",
        norm="rmsnorm",
        sub_quadratic=False,
        max_seq_len=131_072,
    )


def reduced() -> ModelConfig:
    return ModelConfig(
        name="llama3-8b-reduced",
        family="dense",
        num_layers=2,
        d_model=64,
        d_ff=128,
        vocab_size=256,
        attention=AttentionConfig(
            kind="gqa", num_heads=4, num_kv_heads=2, head_dim=16,
            rope_theta=500_000.0,
        ),
        pattern=(LayerSpec(mixer="attn", ffn="dense"),),
        act="silu",
        norm="rmsnorm",
        sub_quadratic=False,
        max_seq_len=512,
    )


register("llama3-8b", full, reduced)
