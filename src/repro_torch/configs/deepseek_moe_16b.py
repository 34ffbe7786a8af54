"""deepseek-moe-16b [arXiv:2401.06066; hf]: fine-grained MoE.
28L d_model=2048 16H (MHA kv=16) vocab=102400; 2 shared + 64 routed
experts top-6, expert d_ff=1408; first layer dense (d_ff=10944)."""
from .base import ModelConfig, register


def full() -> ModelConfig:
    return ModelConfig(
        name="deepseek-moe-16b", family="moe",
        n_layers=28, d_model=2048, n_heads=16, n_kv_heads=16,
        d_ff=10944, vocab=102_400, mlp_variant="swiglu",
        n_experts=64, n_shared_experts=2, top_k=6, expert_d_ff=1408,
        first_k_dense=1,
        dtype="bfloat16", param_dtype="bfloat16",
    )


def smoke() -> ModelConfig:
    return ModelConfig(
        name="deepseek-moe-16b", family="moe",
        n_layers=3, d_model=64, n_heads=4, n_kv_heads=4,
        d_ff=128, vocab=128, mlp_variant="swiglu",
        n_experts=8, n_shared_experts=2, top_k=2, expert_d_ff=32,
        first_k_dense=1, remat=False,
    )


register(full, smoke)
