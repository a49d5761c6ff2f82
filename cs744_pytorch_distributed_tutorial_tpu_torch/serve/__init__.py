"""Request-level serving: continuous batching over a paged KV pool.

``engine.ServingEngine`` runs the in-flight batching loop (a
fixed-shape decode step over B slots; slots retire and refill one by
one; K/V in per-layer page pools), ``pool.PagePool`` owns the page
accounting, and ``loadgen`` replays Poisson arrivals and reports TTFT,
inter-token latency and tokens/s through the ``obs`` sinks. The guard,
the tracer and snapshot/resume are not ported yet.
"""

from cs744_pytorch_distributed_tutorial_tpu_torch.serve.engine import (
    Request,
    ServeConfig,
    ServingEngine,
)
from cs744_pytorch_distributed_tutorial_tpu_torch.serve.loadgen import (
    Workload,
    make_poisson_workload,
    run_batch_baseline,
    run_poisson,
)
from cs744_pytorch_distributed_tutorial_tpu_torch.serve.pool import PagePool

__all__ = ["PagePool", "Request", "ServeConfig", "ServingEngine", "Workload",
           "make_poisson_workload", "run_batch_baseline", "run_poisson"]
