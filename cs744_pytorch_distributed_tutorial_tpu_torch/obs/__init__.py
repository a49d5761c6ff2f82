"""Observability: the record sinks ``serve_cli`` writes through
(``sinks.py``). The rest of the JAX package's ``obs/`` is not ported yet."""
