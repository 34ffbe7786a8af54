"""The LM stack of the port: the dense decoder family (``transformer``)
on the shared blocks of ``layers``, the uniform ``Model`` interface
(``api``) and the carrier of the JAX package's parameters
(``convert``).  The other families come with later slices."""
from .api import Model, build_model  # noqa: F401
