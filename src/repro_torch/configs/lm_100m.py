"""lm-100m — a ~100M-parameter dense LM used by the end-to-end training
example (examples/lm_train.py).  Not part of the assigned pool; sized so a
few hundred steps are feasible on small hosts.

(A copy of ``repro.configs.lm_100m``.)
"""
from repro_torch.config import AttentionConfig, LayerSpec, ModelConfig, register


def full() -> ModelConfig:
    # ~100M params: 12L, d=768, ff=3072, vocab=32000
    # 12*(4*768^2 + 3*768*3072) + 32000*768*2 ~= 162M total incl. embeddings
    return ModelConfig(
        name="lm-100m",
        family="dense",
        num_layers=12,
        d_model=768,
        d_ff=3072,
        vocab_size=32000,
        attention=AttentionConfig(
            kind="gqa", num_heads=12, num_kv_heads=4, head_dim=64,
        ),
        pattern=(LayerSpec(mixer="attn", ffn="dense"),),
        act="silu",
        norm="rmsnorm",
        tie_embeddings=True,
        sub_quadratic=False,
        max_seq_len=2_048,
    )


def reduced() -> ModelConfig:
    return ModelConfig(
        name="lm-100m-reduced",
        family="dense",
        num_layers=2,
        d_model=64,
        d_ff=256,
        vocab_size=512,
        attention=AttentionConfig(
            kind="gqa", num_heads=4, num_kv_heads=2, head_dim=16,
        ),
        pattern=(LayerSpec(mixer="attn", ffn="dense"),),
        act="silu",
        norm="rmsnorm",
        tie_embeddings=True,
        sub_quadratic=False,
        max_seq_len=512,
    )


register("lm-100m", full, reduced)
