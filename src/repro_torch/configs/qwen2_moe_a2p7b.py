"""qwen2-moe-a2.7b [moe] — 24L d_model=2048 16H (GQA kv=16) d_ff=1408
vocab=151936, MoE 4 shared + 60 routed top-4.
[hf:Qwen/Qwen1.5-MoE-A2.7B]

60 experts do not divide the 16-way model axis; the MoE sharding policy pads
the expert dim to 64 for EP (see repro.models.layers.moe).

(A copy of ``repro.configs.qwen2_moe_a2p7b``.)
"""
from repro_torch.config import (
    AttentionConfig, LayerSpec, ModelConfig, MoEConfig, register,
)


def full() -> ModelConfig:
    return ModelConfig(
        name="qwen2-moe-a2.7b",
        family="moe",
        num_layers=24,
        d_model=2048,
        d_ff=1408,
        vocab_size=151936,
        attention=AttentionConfig(
            kind="gqa", num_heads=16, num_kv_heads=16, head_dim=128,
            rope_theta=1_000_000.0,
        ),
        moe=MoEConfig(
            num_experts=60, top_k=4, num_shared=4,
            d_ff_expert=1408, d_ff_shared=5632,
        ),
        pattern=(LayerSpec(mixer="attn", ffn="moe"),),
        act="silu",
        norm="rmsnorm",
        sub_quadratic=False,
        max_seq_len=32_768,
    )


def reduced() -> ModelConfig:
    return ModelConfig(
        name="qwen2-moe-a2.7b-reduced",
        family="moe",
        num_layers=2,
        d_model=64,
        d_ff=64,
        vocab_size=256,
        attention=AttentionConfig(
            kind="gqa", num_heads=4, num_kv_heads=4, head_dim=16,
        ),
        moe=MoEConfig(
            num_experts=6, top_k=2, num_shared=1,
            d_ff_expert=32, d_ff_shared=64,
        ),
        pattern=(LayerSpec(mixer="attn", ffn="moe"),),
        act="silu",
        norm="rmsnorm",
        sub_quadratic=False,
        max_seq_len=512,
    )


register("qwen2-moe-a2.7b", full, reduced)
