"""Request-level serving: continuous batching over a paged KV pool.

``engine.ServingEngine`` runs the in-flight batching loop (a
fixed-shape decode step over B slots; slots retire and refill one by
one; K/V in per-layer page pools), ``pool.PagePool`` owns the page
accounting, ``loadgen`` replays Poisson arrivals and reports TTFT,
inter-token latency, tokens/s and terminal statuses through the ``obs``
sinks, and ``guard`` adds deadlines, admission control and supervised
recovery (``run_serve_with_recovery``).
"""

from cs744_pytorch_distributed_tutorial_tpu_torch.serve.engine import (
    Request,
    ServeConfig,
    ServeSnapshot,
    ServingEngine,
)
from cs744_pytorch_distributed_tutorial_tpu_torch.serve.guard import (
    GuardConfig,
    ServeGuard,
    run_serve_with_recovery,
)
from cs744_pytorch_distributed_tutorial_tpu_torch.serve.loadgen import (
    Workload,
    make_poisson_workload,
    run_batch_baseline,
    run_poisson,
)
from cs744_pytorch_distributed_tutorial_tpu_torch.serve.pool import PagePool

__all__ = ["GuardConfig", "PagePool", "Request", "ServeConfig", "ServeGuard", "ServeSnapshot",
           "ServingEngine", "Workload", "make_poisson_workload", "run_batch_baseline",
           "run_poisson", "run_serve_with_recovery"]
