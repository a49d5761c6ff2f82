"""Observability: the record sinks ``serve_cli`` and ``bench`` write
through (``sinks.py``), the MoE router's load entropy (``metrics.py``)
and the FLOP models and MFU against the card's peak (``flops.py``). The
rest of the JAX package's ``obs/`` is not ported yet."""
