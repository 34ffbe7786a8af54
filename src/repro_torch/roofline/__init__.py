"""Roofline analysis of the dry run's traced steps against the H100's
published peaks."""
from .analysis import HW_H100, collective_bytes, roofline_terms  # noqa: F401
