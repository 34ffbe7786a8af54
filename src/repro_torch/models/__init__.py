"""The LM stack of the port: every family of the JAX package — dense and
MoE decoders (``transformer``, ``moe``), the Mamba2 hybrid (``ssm``),
xLSTM (``xlstm``), encoder-decoder (``encdec``) and vision (``vlm``) — on
the shared blocks of ``layers``, the uniform ``Model`` interface
(``api``) and the carrier of the JAX package's parameters
(``convert``)."""
from .api import Model, build_model  # noqa: F401
