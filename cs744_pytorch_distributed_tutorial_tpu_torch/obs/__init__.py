"""Observability: the record sinks ``serve_cli`` writes through
(``sinks.py``) and the MoE router's load entropy (``metrics.py``). The
rest of the JAX package's ``obs/`` is not ported yet."""
