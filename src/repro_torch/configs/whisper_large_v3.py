"""whisper-large-v3 [arXiv:2212.04356]: encoder-decoder audio backbone.
32 enc + 32 dec layers, d_model=1280 20H (MHA kv=20) d_ff=5120
vocab=51866, LayerNorm + GELU, learned decoder positions.
Conv/audio frontend is a STUB (precomputed frame embeddings, 1500
frames).  Whisper's canonical decoder context is 448 tokens; the
decode_32k cell stresses the same backbone with a 32k cache
(max_position raised accordingly) — noted in DESIGN.md §7."""
from .base import ModelConfig, register


def full() -> ModelConfig:
    return ModelConfig(
        name="whisper-large-v3", family="encdec",
        n_layers=32, n_enc_layers=32, d_model=1280, n_heads=20,
        n_kv_heads=20, d_ff=5120, vocab=51866,
        mlp_variant="gelu", norm="layernorm", rope_theta=0.0,
        n_frames=1500, max_position=32_768,
        dtype="bfloat16", param_dtype="bfloat16",
    )


def smoke() -> ModelConfig:
    return ModelConfig(
        name="whisper-large-v3", family="encdec",
        n_layers=2, n_enc_layers=2, d_model=64, n_heads=4, n_kv_heads=4,
        d_ff=128, vocab=128, mlp_variant="gelu", norm="layernorm",
        rope_theta=0.0, n_frames=16, max_position=64, remat=False,
    )


register(full, smoke)
