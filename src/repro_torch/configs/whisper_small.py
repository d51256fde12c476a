"""whisper-small [audio] — 12L d_model=768 12H d_ff=3072 vocab=51865.

Encoder-decoder; the conv frontend is a STUB: ``input_specs()`` provides
precomputed frame embeddings (batch, 1500, 768) replacing
log-mel + Conv1d x2.  [arXiv:2212.04356]

Decode shapes run on the decoder (KV cache + cross-attention to the encoded
frames).  long_500k is skipped: both encoder and decoder are pure full
attention.

(A copy of ``repro.configs.whisper_small``.)
"""
from repro_torch.config import (
    AttentionConfig, EncoderConfig, LayerSpec, ModelConfig, register,
)


def full() -> ModelConfig:
    return ModelConfig(
        name="whisper-small",
        family="audio",
        num_layers=12,  # decoder layers
        d_model=768,
        d_ff=3072,
        vocab_size=51865,
        attention=AttentionConfig(
            kind="gqa", num_heads=12, num_kv_heads=12, head_dim=64,
            rope_kind="none",  # whisper uses learned positions
        ),
        encoder=EncoderConfig(num_layers=12, seq_len=1500, feature_dim=768),
        pattern=(LayerSpec(mixer="attn", ffn="dense"),),
        act="gelu",
        norm="layernorm",
        sub_quadratic=False,
        max_seq_len=448,
    )


def reduced() -> ModelConfig:
    return ModelConfig(
        name="whisper-small-reduced",
        family="audio",
        num_layers=2,
        d_model=64,
        d_ff=128,
        vocab_size=256,
        attention=AttentionConfig(
            kind="gqa", num_heads=4, num_kv_heads=4, head_dim=16,
            rope_kind="none",
        ),
        encoder=EncoderConfig(num_layers=2, seq_len=24, feature_dim=64),
        pattern=(LayerSpec(mixer="attn", ffn="dense"),),
        act="gelu",
        norm="layernorm",
        sub_quadratic=False,
        max_seq_len=512,
    )


register("whisper-small", full, reduced)
