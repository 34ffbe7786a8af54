"""The paper's own workload suite config: not an LM — selects the Weld
benchmark battery (crime index, Black-Scholes, TPC-H, PageRank, logreg)
at the dataset scale used by benchmarks/.  Kept in the same registry so
`--arch weld-bench` drives the paper-native pipeline end to end."""
from .base import ModelConfig, register


def full() -> ModelConfig:
    return ModelConfig(
        name="weld-bench", family="dense",
        n_layers=2, d_model=64, n_heads=4, n_kv_heads=2,
        d_ff=128, vocab=128,
    )


def smoke() -> ModelConfig:
    return full()


register(full, smoke)
