"""xlstm-350m [arXiv:2405.04517]: 24 blocks, d_model=1024 4H, d_ff=0
(blocks carry their own projections).  mLSTM (matrix memory, chunked)
with sLSTM (sequential scan) every 8th position — the paper's mixed
[m:s] stacking.  Simplification: sigmoid (not exponential) mLSTM gates;
see models/xlstm.py docstring."""
from .base import ModelConfig, register


def full() -> ModelConfig:
    return ModelConfig(
        name="xlstm-350m", family="ssm",
        n_layers=24, d_model=1024, n_heads=4, n_kv_heads=4,
        d_ff=0, vocab=50_304, slstm_every=8, ssm_chunk=128,
        dtype="bfloat16", param_dtype="bfloat16",
    )


def smoke() -> ModelConfig:
    return ModelConfig(
        name="xlstm-350m", family="ssm",
        n_layers=4, d_model=64, n_heads=2, n_kv_heads=2,
        d_ff=0, vocab=128, slstm_every=4, ssm_chunk=16, remat=False,
    )


register(full, smoke)
