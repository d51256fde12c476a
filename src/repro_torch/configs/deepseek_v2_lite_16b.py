"""deepseek-v2-lite-16b [moe] — 27L d_model=2048 16H d_ff=1408 vocab=102400,
MLA kv_lora=512, MoE 2 shared + 64 routed top-6, first layer dense.
[arXiv:2405.04434; hf]

Note on the assignment line: it lists both "64e top-6" and "2 shared+160
routed"; the published DeepSeek-V2-Lite checkpoint has 64 routed + 2 shared
experts with top-6 routing (160 routed belongs to full V2-236B).  We follow
the Lite checkpoint and record the discrepancy here and in DESIGN.md.

(A copy of ``repro.configs.deepseek_v2_lite_16b``.)
"""
from repro_torch.config import (
    AttentionConfig, LayerSpec, ModelConfig, MoEConfig, register,
)


def full() -> ModelConfig:
    return ModelConfig(
        name="deepseek-v2-lite-16b",
        family="moe",
        num_layers=27,
        d_model=2048,
        d_ff=10944,  # dense FFN of layer 0 (hf: intermediate_size)
        vocab_size=102400,
        attention=AttentionConfig(
            kind="mla",
            num_heads=16,
            num_kv_heads=16,
            head_dim=128,          # nope head dim
            kv_lora_rank=512,
            q_lora_rank=0,         # lite variant has no q compression
            rope_head_dim=64,
            nope_head_dim=128,
            rope_theta=10_000.0,
        ),
        moe=MoEConfig(
            num_experts=64, top_k=6, num_shared=2,
            d_ff_expert=1408, d_ff_shared=1408 * 2,
        ),
        pattern=(LayerSpec(mixer="attn", ffn="moe"),),
        num_dense_prefix=1,
        act="silu",
        norm="rmsnorm",
        sub_quadratic=False,  # MLA is still full attention over sequence
        max_seq_len=32_768,
    )


def reduced() -> ModelConfig:
    return ModelConfig(
        name="deepseek-v2-lite-16b-reduced",
        family="moe",
        num_layers=2,
        d_model=64,
        d_ff=128,
        vocab_size=256,
        attention=AttentionConfig(
            kind="mla",
            num_heads=4,
            num_kv_heads=4,
            head_dim=16,
            kv_lora_rank=32,
            rope_head_dim=8,
            nope_head_dim=16,
        ),
        moe=MoEConfig(
            num_experts=4, top_k=2, num_shared=1,
            d_ff_expert=32, d_ff_shared=64,
        ),
        pattern=(LayerSpec(mixer="attn", ffn="moe"),),
        num_dense_prefix=1,
        act="silu",
        norm="rmsnorm",
        sub_quadratic=False,
        max_seq_len=512,
    )


register("deepseek-v2-lite-16b", full, reduced)
