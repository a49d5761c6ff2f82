"""Observability: the record sinks (``sinks.py``), ``Telemetry`` and the
on-device norms (``metrics.py``), the run manifest (``run_manifest.py``),
device memory and kernel builds (``system.py``), the straggler monitor
and flight recorder (``flight.py``), and the FLOP models and MFU against
the card's peak (``flops.py``). The JAX package's phase profiler, fleet
view and serving tracer are not ported yet."""
