"""Library integrations (paper §6): NumPy-, Pandas-, Spark SQL- and
TensorFlow-shaped libraries whose operators emit Weld IR fragments through
the lazy runtime API.  Operators interoperate across libraries — a welddf
column *is* a weldnp array — so the optimizer sees the whole workflow."""
