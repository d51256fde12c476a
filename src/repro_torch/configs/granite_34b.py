"""granite-34b [dense] — 88L d_model=6144 48H (GQA kv=1 => MQA) d_ff=24576
vocab=49152.  llama-arch, code model. [arXiv:2405.04324; hf]

kv=1 is multi-query attention: the single KV head is replicated across the
model axis (it cannot be sharded 16 ways), queries shard by head.

(A copy of ``repro.configs.granite_34b``.)
"""
from repro_torch.config import AttentionConfig, LayerSpec, ModelConfig, register


def full() -> ModelConfig:
    return ModelConfig(
        name="granite-34b",
        family="dense",
        num_layers=88,
        d_model=6144,
        d_ff=24576,
        vocab_size=49152,
        attention=AttentionConfig(
            kind="gqa", num_heads=48, num_kv_heads=1, head_dim=128,
            rope_theta=10_000.0,
        ),
        pattern=(LayerSpec(mixer="attn", ffn="dense"),),
        act="gelu",
        norm="layernorm",
        tie_embeddings=True,
        sub_quadratic=False,
        max_seq_len=8_192,
    )


def reduced() -> ModelConfig:
    return ModelConfig(
        name="granite-34b-reduced",
        family="dense",
        num_layers=3,
        d_model=64,
        d_ff=128,
        vocab_size=256,
        attention=AttentionConfig(
            kind="gqa", num_heads=4, num_kv_heads=1, head_dim=16,
        ),
        pattern=(LayerSpec(mixer="attn", ffn="dense"),),
        act="gelu",
        norm="layernorm",
        tie_embeddings=True,
        sub_quadratic=False,
        max_seq_len=512,
    )


register("granite-34b", full, reduced)
