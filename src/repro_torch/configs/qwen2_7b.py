"""qwen2-7b [arXiv:2407.10671; hf]: dense GQA with QKV bias, SwiGLU.
28L d_model=3584 28H (GQA kv=4) d_ff=18944 vocab=152064."""
from .base import ModelConfig, register


def full() -> ModelConfig:
    return ModelConfig(
        name="qwen2-7b", family="dense",
        n_layers=28, d_model=3584, n_heads=28, n_kv_heads=4,
        d_ff=18944, vocab=152_064, mlp_variant="swiglu", qkv_bias=True,
        rope_theta=1_000_000.0,
        dtype="bfloat16", param_dtype="bfloat16",
    )


def smoke() -> ModelConfig:
    return ModelConfig(
        name="qwen2-7b", family="dense",
        n_layers=2, d_model=56, n_heads=4, n_kv_heads=2,
        d_ff=96, vocab=128, mlp_variant="swiglu", qkv_bias=True,
        remat=False,
    )


register(full, smoke)
