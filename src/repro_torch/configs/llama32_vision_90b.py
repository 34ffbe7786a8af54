"""llama-3.2-vision-90b [hf:meta-llama/Llama-3.2-90B-Vision]: VLM with
cross-attention image layers every 5th layer (100L total = 80 self + 20
cross).  d_model=8192 64H (GQA kv=8) d_ff=28672 vocab=128256.
Vision tower is a STUB: input_specs provides precomputed patch
embeddings (1600 tokens x d_vision=1280)."""
from .base import ModelConfig, register


def full() -> ModelConfig:
    return ModelConfig(
        name="llama-3.2-vision-90b", family="vlm",
        n_layers=100, d_model=8192, n_heads=64, n_kv_heads=8,
        d_ff=28672, vocab=128_256, mlp_variant="swiglu",
        rope_theta=500_000.0,
        cross_attn_every=5, n_image_tokens=1600, d_vision=1280,
        dtype="bfloat16", param_dtype="bfloat16",
    )


def smoke() -> ModelConfig:
    return ModelConfig(
        name="llama-3.2-vision-90b", family="vlm",
        n_layers=4, d_model=64, n_heads=4, n_kv_heads=2,
        d_ff=96, vocab=128, mlp_variant="swiglu",
        cross_attn_every=2, n_image_tokens=8, d_vision=16, remat=False,
    )


register(full, smoke)
