"""weldbound: static size & memory-bounds analysis over the Weld IR.

``domain`` carries the symbolic-arithmetic and interval lattice;
``bounds`` is the abstract interpreter that derives per-builder size
intervals and the whole-plan peak-memory certificate the runtime's
admission check, the planner, and the recovery ladder consume.
"""
from . import bounds, domain  # noqa: F401
