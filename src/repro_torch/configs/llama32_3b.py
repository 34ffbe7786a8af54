"""llama3.2-3b [hf:meta-llama/Llama-3.2-3B]: small llama3, SwiGLU.
28L d_model=3072 24H (GQA kv=8) d_ff=8192 vocab=128256."""
from .base import ModelConfig, register


def full() -> ModelConfig:
    return ModelConfig(
        name="llama3.2-3b", family="dense",
        n_layers=28, d_model=3072, n_heads=24, n_kv_heads=8,
        d_ff=8192, vocab=128_256, mlp_variant="swiglu",
        rope_theta=500_000.0,
        dtype="bfloat16", param_dtype="bfloat16",
    )


def smoke() -> ModelConfig:
    return ModelConfig(
        name="llama3.2-3b", family="dense",
        n_layers=2, d_model=64, n_heads=4, n_kv_heads=2,
        d_ff=96, vocab=128, mlp_variant="swiglu", remat=False,
    )


register(full, smoke)
