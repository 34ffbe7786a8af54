"""Distribution layer of the port: logical-axis sharding rules on
DTensor (``sharding``), what the models need of a mesh (``mesh_ops``),
elastic re-sharding (``elastic``) and straggler monitoring
(``straggler``); the int8 error-feedback compression is
``optim.compress``."""
from .elastic import remesh  # noqa: F401
from .sharding import (DEFAULT_RULES, distribute, placements,  # noqa: F401
                       replicated, spec_for_leaf, tree_shardings,
                       zero1_moment_shardings)
from .straggler import StepMonitor  # noqa: F401
