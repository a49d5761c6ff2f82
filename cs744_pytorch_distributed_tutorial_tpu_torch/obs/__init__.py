"""Observability: the record sinks (``sinks.py``), ``Telemetry`` and the
on-device norms (``metrics.py``), the run manifest (``run_manifest.py``),
device memory and kernel builds (``system.py``), the straggler monitor
and flight recorder (``flight.py``), the FLOP models and MFU against the
card's peak (``flops.py``), and the phase profiler (``phases.py``: a
training step cut into forward, backward, grad sync and optimizer, each
traced and costed, with ``sync_exposed_ms``), whose records
``python -m cs744_pytorch_distributed_tutorial_tpu_torch.obs report``
renders, and the serving tracer (``serve_trace.py``: spans, SLO windows
and the device attribution of the serving programs; ``obs
serve-report``), and the fleet view of a multi-process run
(``fleet.py``: the ranks' clocks aligned, collective skew, the incident
audit; ``obs fleet-report``).
"""

from cs744_pytorch_distributed_tutorial_tpu_torch.obs import flops
from cs744_pytorch_distributed_tutorial_tpu_torch.obs.flight import (
    FlightRecorder,
    HbmHighWater,
    StragglerMonitor,
)
from cs744_pytorch_distributed_tutorial_tpu_torch.obs.metrics import (
    Telemetry,
    expert_load_entropy,
    tree_l2_norm,
    tree_sq_norm,
)
from cs744_pytorch_distributed_tutorial_tpu_torch.obs.phases import (
    PhaseReport,
    PhaseStat,
    capture_device_profile,
    phase_records_from_stream,
    profile_lm_phases,
    profile_phases,
    render_phase_table,
)
from cs744_pytorch_distributed_tutorial_tpu_torch.obs.run_manifest import (
    build_manifest,
    read_manifest,
    write_manifest,
)
from cs744_pytorch_distributed_tutorial_tpu_torch.obs.serve_trace import (
    ServeTracer,
    check_spans,
    profile_serve_programs,
    reconcile,
)
from cs744_pytorch_distributed_tutorial_tpu_torch.obs.sinks import (
    CsvSink,
    JsonlSink,
    MultiSink,
    NullSink,
    RingSink,
    StreamSink,
    rank_zero,
    sanitize,
)
from cs744_pytorch_distributed_tutorial_tpu_torch.obs.system import (
    CompileCounter,
    SystemMonitor,
    hbm_stats,
)

__all__ = [
    "Telemetry",
    "expert_load_entropy",
    "tree_l2_norm",
    "tree_sq_norm",
    "FlightRecorder",
    "HbmHighWater",
    "StragglerMonitor",
    "PhaseReport",
    "PhaseStat",
    "capture_device_profile",
    "phase_records_from_stream",
    "profile_lm_phases",
    "profile_phases",
    "render_phase_table",
    "build_manifest",
    "read_manifest",
    "write_manifest",
    "ServeTracer",
    "check_spans",
    "profile_serve_programs",
    "reconcile",
    "CsvSink",
    "JsonlSink",
    "MultiSink",
    "NullSink",
    "RingSink",
    "StreamSink",
    "rank_zero",
    "sanitize",
    "CompileCounter",
    "SystemMonitor",
    "hbm_stats",
    "flops",
]
