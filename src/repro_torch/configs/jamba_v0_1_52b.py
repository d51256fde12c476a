"""jamba-v0.1-52b [hybrid] — 32L d_model=4096 32H (GQA kv=8) d_ff=14336
vocab=65536, MoE 16e top-2.  Mamba + attention 1:7 interleave, MoE every
other layer. [arXiv:2403.19887; hf]

Mamba layers give bounded decode state => runs long_500k (the 4 attention
layers keep a KV cache over the 500k prefix; decode cost stays linear).

(A copy of ``repro.configs.jamba_v0_1_52b``.)
"""
from repro_torch.config import (
    AttentionConfig, LayerSpec, ModelConfig, MoEConfig, SSMConfig, register,
)


def full() -> ModelConfig:
    # Jamba block: 8 layers, attention at index 4 (1:7 attn:mamba),
    # MoE on odd layers (every other layer), dense otherwise.
    def spec(i: int) -> LayerSpec:
        mixer = "attn" if i == 4 else "mamba"
        ffn = "moe" if i % 2 == 1 else "dense"
        return LayerSpec(mixer=mixer, ffn=ffn)

    return ModelConfig(
        name="jamba-v0.1-52b",
        family="hybrid",
        num_layers=32,
        d_model=4096,
        d_ff=14336,
        vocab_size=65536,
        attention=AttentionConfig(
            kind="gqa", num_heads=32, num_kv_heads=8, head_dim=128,
            rope_kind="none",  # jamba uses no positional encoding
        ),
        ssm=SSMConfig(d_state=16, d_conv=4, expand=2),
        moe=MoEConfig(num_experts=16, top_k=2, num_shared=0,
                      d_ff_expert=14336),
        pattern=tuple(spec(i) for i in range(8)),
        act="silu",
        norm="rmsnorm",
        sub_quadratic=True,
        max_seq_len=262_144,
    )


def reduced() -> ModelConfig:
    def spec(i: int) -> LayerSpec:
        mixer = "attn" if i == 2 else "mamba"
        ffn = "moe" if i % 2 == 1 else "dense"
        return LayerSpec(mixer=mixer, ffn=ffn)

    return ModelConfig(
        name="jamba-v0.1-52b-reduced",
        family="hybrid",
        num_layers=4,
        d_model=64,
        d_ff=128,
        vocab_size=256,
        attention=AttentionConfig(
            kind="gqa", num_heads=4, num_kv_heads=2, head_dim=16,
            rope_kind="none",
        ),
        ssm=SSMConfig(d_state=8, d_conv=4, expand=2),
        moe=MoEConfig(num_experts=4, top_k=2, num_shared=0, d_ff_expert=64),
        pattern=tuple(spec(i) for i in range(4)),
        act="silu",
        norm="rmsnorm",
        sub_quadratic=True,
        max_seq_len=1_024,
    )


register("jamba-v0.1-52b", full, reduced)
