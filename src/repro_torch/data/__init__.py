"""Data substrate: deterministic, shard-aware, checkpointable pipeline."""
from .pipeline import TokenPipeline  # noqa: F401
