"""Top-level alias so ``repro_torch.obs.enable()`` works as documented.

The implementation lives in :mod:`repro_torch.core.obs`.
"""
from .core.obs import *  # noqa: F401,F403
from .core.obs import __all__, ledger  # noqa: F401
