"""dbrx-132b [hf:databricks/dbrx-base]: coarse MoE.
40L d_model=6144 48H (GQA kv=8) vocab=100352; 16 experts top-4,
expert d_ff=10752 (SwiGLU)."""
from .base import ModelConfig, register


def full() -> ModelConfig:
    return ModelConfig(
        name="dbrx-132b", family="moe",
        n_layers=40, d_model=6144, n_heads=48, n_kv_heads=8,
        d_ff=10752, vocab=100_352, mlp_variant="swiglu",
        n_experts=16, n_shared_experts=0, top_k=4, expert_d_ff=10752,
        rope_theta=500_000.0,
        dtype="bfloat16", param_dtype="bfloat16",
    )


def smoke() -> ModelConfig:
    return ModelConfig(
        name="dbrx-132b", family="moe",
        n_layers=2, d_model=64, n_heads=4, n_kv_heads=2,
        d_ff=96, vocab=128, mlp_variant="swiglu",
        n_experts=4, n_shared_experts=0, top_k=2, expert_d_ff=96,
        remat=False,
    )


register(full, smoke)
