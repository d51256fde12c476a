"""qwen2-vl-72b [vlm] — 80L d_model=8192 64H (GQA kv=8) d_ff=29568
vocab=152064.  M-RoPE, dynamic resolution. [arXiv:2409.12191; hf]

The vision frontend (ViT + merger) is a STUB per the assignment:
``input_specs()`` provides precomputed patch embeddings of shape
(batch, num_patches, d_model) which are prepended to the token embeddings.
The transformer backbone (this config) uses M-RoPE with sections
(temporal, height, width) = (16, 24, 24) summing to head_dim/2 = 64.

(A copy of ``repro.configs.qwen2_vl_72b``.)
"""
from repro_torch.config import (
    AttentionConfig, LayerSpec, ModelConfig, VisionStubConfig, register,
)


def full() -> ModelConfig:
    return ModelConfig(
        name="qwen2-vl-72b",
        family="vlm",
        num_layers=80,
        d_model=8192,
        d_ff=29568,
        vocab_size=152064,
        attention=AttentionConfig(
            kind="gqa", num_heads=64, num_kv_heads=8, head_dim=128,
            rope_kind="mrope", mrope_sections=(16, 24, 24),
            rope_theta=1_000_000.0,
        ),
        vision=VisionStubConfig(num_patches=256, patch_dim=8192),
        pattern=(LayerSpec(mixer="attn", ffn="dense"),),
        act="silu",
        norm="rmsnorm",
        sub_quadratic=False,
        max_seq_len=32_768,
    )


def reduced() -> ModelConfig:
    return ModelConfig(
        name="qwen2-vl-72b-reduced",
        family="vlm",
        num_layers=2,
        d_model=64,
        d_ff=128,
        vocab_size=256,
        attention=AttentionConfig(
            kind="gqa", num_heads=4, num_kv_heads=2, head_dim=16,
            rope_kind="mrope", mrope_sections=(2, 3, 3),
        ),
        vision=VisionStubConfig(num_patches=8, patch_dim=64),
        pattern=(LayerSpec(mixer="attn", ffn="dense"),),
        act="silu",
        norm="rmsnorm",
        sub_quadratic=False,
        max_seq_len=512,
    )


register("qwen2-vl-72b", full, reduced)
