"""graftcheck and graftmem for the port: audits of the steps it really runs.

The twin of the JAX package's ``analysis/trace`` subpackage. Where
graftlint (one package up) reads source text, this subpackage records
one REAL eager step of each registered engine under a dispatch mode
(``dispatch.py``) and audits what ran: dtype upcasts (TA001), state
promised in place that was not (TA002), the collective schedule and
bytes on the wire of each sync strategy against JAX's contracts (TA003),
dead computation (TA005), and collective sequences that differ across
ranks or a runtime predicate's variants (TA006). The **graftmem** sibling
(``memory.py``) audits the same recording's memory: the per-rank ledger
against a checked-in budget (TA007), sharded state held whole (TA008),
and the bytes broken in-place updates cost (TA010). TA004 and TA009 have
no object in an eager program and are kept by ID with the reason. The
entry points come from the engine modules (``registry.py``) and the CLIs
run as::

    python -m cs744_pytorch_distributed_tutorial_tpu_torch.analysis trace --device cpu
    python -m cs744_pytorch_distributed_tutorial_tpu_torch.analysis memory --device cpu
"""

from cs744_pytorch_distributed_tutorial_tpu_torch.analysis.trace.registry import (
    TraceEntry,
    TracedStep,
    ensure_process_group,
    get_entrypoints,
    load_builtin_entrypoints,
    register_entrypoint,
)

__all__ = [
    "TraceEntry",
    "TracedStep",
    "ensure_process_group",
    "get_entrypoints",
    "load_builtin_entrypoints",
    "register_entrypoint",
]
