"""yi-9b [dense] — 48L d_model=4096 32H (GQA kv=4) d_ff=11008 vocab=64000.

llama-arch GQA. [arXiv:2403.04652; hf]

(A copy of ``repro.configs.yi_9b``.)
"""
from repro_torch.config import AttentionConfig, LayerSpec, ModelConfig, register


def full() -> ModelConfig:
    return ModelConfig(
        name="yi-9b",
        family="dense",
        num_layers=48,
        d_model=4096,
        d_ff=11008,
        vocab_size=64000,
        attention=AttentionConfig(
            kind="gqa", num_heads=32, num_kv_heads=4, head_dim=128,
            rope_theta=10_000.0,
        ),
        pattern=(LayerSpec(mixer="attn", ffn="dense"),),
        act="silu",
        norm="rmsnorm",
        sub_quadratic=False,
        max_seq_len=4_096,
    )


def reduced() -> ModelConfig:
    return ModelConfig(
        name="yi-9b-reduced",
        family="dense",
        num_layers=2,
        d_model=64,
        d_ff=96,
        vocab_size=256,
        attention=AttentionConfig(
            kind="gqa", num_heads=4, num_kv_heads=1, head_dim=16,
        ),
        pattern=(LayerSpec(mixer="attn", ffn="dense"),),
        act="silu",
        norm="rmsnorm",
        sub_quadratic=False,
        max_seq_len=512,
    )


register("yi-9b", full, reduced)
