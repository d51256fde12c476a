"""xlstm-350m [ssm] — 24L d_model=1024 4H d_ff=0 vocab=50304.

sLSTM + mLSTM blocks (1:1 interleave of mLSTM-heavy stack; the published
xLSTM[7:1] family alternates, here we use the 350M layout: mostly mLSTM
with periodic sLSTM). d_ff=0: xLSTM blocks carry their own up/down
projections instead of a separate FFN.  [arXiv:2405.04517]

Recurrent state decode is O(1) per token => runs long_500k.

(A copy of ``repro.configs.xlstm_350m``.)
"""
from repro_torch.config import (
    AttentionConfig, LayerSpec, ModelConfig, SSMConfig, register,
)


def full() -> ModelConfig:
    # 7:1 mLSTM:sLSTM pattern (xLSTM[7:1]); 24 layers = 3 superblocks of 8.
    m = LayerSpec(mixer="mlstm", ffn="none")
    s = LayerSpec(mixer="slstm", ffn="none")
    return ModelConfig(
        name="xlstm-350m",
        family="ssm",
        num_layers=24,
        d_model=1024,
        d_ff=0,
        vocab_size=50304,
        attention=AttentionConfig(kind="none", num_heads=4, num_kv_heads=4,
                                  head_dim=256, rope_kind="none"),
        ssm=SSMConfig(num_heads=4, proj_factor=2.0, d_conv=4),
        pattern=(m, m, m, m, m, m, m, s),
        act="gelu",
        norm="layernorm",
        tie_embeddings=True,
        sub_quadratic=True,
        max_seq_len=1_048_576,
    )


def reduced() -> ModelConfig:
    m = LayerSpec(mixer="mlstm", ffn="none")
    s = LayerSpec(mixer="slstm", ffn="none")
    return ModelConfig(
        name="xlstm-350m-reduced",
        family="ssm",
        num_layers=2,
        d_model=64,
        d_ff=0,
        vocab_size=256,
        attention=AttentionConfig(kind="none", num_heads=2, num_kv_heads=2,
                                  head_dim=32, rope_kind="none"),
        ssm=SSMConfig(num_heads=2, proj_factor=2.0, d_conv=4),
        pattern=(m, s),
        act="gelu",
        norm="layernorm",
        tie_embeddings=True,
        sub_quadratic=True,
        max_seq_len=4_096,
    )


register("xlstm-350m", full, reduced)
