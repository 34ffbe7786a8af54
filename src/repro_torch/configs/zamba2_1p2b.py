"""zamba2-1.2b [arXiv:2411.15242; hf]: hybrid — 38 Mamba2 blocks with a
SHARED attention+MLP block applied every 6 blocks (parameter reuse;
per-invocation LoRA deltas omitted — simplification noted here and in
DESIGN.md).  d_model=2048, shared block: 32H MHA + d_ff=8192,
ssm_state=64, vocab=32000."""
from .base import ModelConfig, register


def full() -> ModelConfig:
    return ModelConfig(
        name="zamba2-1.2b", family="hybrid",
        n_layers=38, d_model=2048, n_heads=32, n_kv_heads=32,
        d_ff=8192, vocab=32_000, mlp_variant="gelu",
        ssm_state=64, ssm_head_dim=64, ssm_chunk=128, attn_every=6,
        dtype="bfloat16", param_dtype="bfloat16",
    )


def smoke() -> ModelConfig:
    return ModelConfig(
        name="zamba2-1.2b", family="hybrid",
        n_layers=4, d_model=64, n_heads=4, n_kv_heads=4,
        d_ff=128, vocab=128, mlp_variant="gelu",
        ssm_state=16, ssm_head_dim=16, ssm_chunk=16, attn_every=2,
        remat=False,
    )


register(full, smoke)
