"""starcoder2-15b [arXiv:2402.19173; hf]: dense GQA + RoPE code model.
40L d_model=6144 48H (GQA kv=4) d_ff=24576 vocab=49152, GeLU MLP."""
from .base import ModelConfig, register


def full() -> ModelConfig:
    return ModelConfig(
        name="starcoder2-15b", family="dense",
        n_layers=40, d_model=6144, n_heads=48, n_kv_heads=4,
        d_ff=24576, vocab=49152, mlp_variant="gelu",
        rope_theta=100_000.0,
        dtype="bfloat16", param_dtype="bfloat16",
    )


def smoke() -> ModelConfig:
    return ModelConfig(
        name="starcoder2-15b", family="dense",
        n_layers=2, d_model=64, n_heads=4, n_kv_heads=2,
        d_ff=128, vocab=128, mlp_variant="gelu", remat=False,
    )


register(full, smoke)
