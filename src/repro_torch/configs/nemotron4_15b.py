"""nemotron-4-15b [arXiv:2402.16819]: dense GQA, squared-ReLU MLP.
32L d_model=6144 48H (GQA kv=8) d_ff=24576 vocab=256000."""
from .base import ModelConfig, register


def full() -> ModelConfig:
    return ModelConfig(
        name="nemotron-4-15b", family="dense",
        n_layers=32, d_model=6144, n_heads=48, n_kv_heads=8,
        d_ff=24576, vocab=256_000, mlp_variant="relu2",
        dtype="bfloat16", param_dtype="bfloat16",
    )


def smoke() -> ModelConfig:
    return ModelConfig(
        name="nemotron-4-15b", family="dense",
        n_layers=2, d_model=64, n_heads=4, n_kv_heads=2,
        d_ff=128, vocab=256, mlp_variant="relu2", remat=False,
    )


register(full, smoke)
