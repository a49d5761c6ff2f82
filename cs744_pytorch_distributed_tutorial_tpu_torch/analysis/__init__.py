"""graftlint for the port — PyTorch/CUDA-aware static analysis of its
sources, and the trace and memory audits of its real steps.

The twin of the JAX package's ``analysis`` package, under the same rule
IDs and names. An AST-based linter (stdlib ``ast`` only, no third-party
deps) for the bug classes that silently cost a GPU its throughput or hang
a process group, and that no generic Python linter sees:

- **GL001 host-sync-in-jit-scope** — ``.item()``/``.tolist()``/
  ``.cpu()``/``.numpy()``, ``float()``/``int()``/``bool()`` of device
  values and ``torch.cuda.synchronize()`` inside a ``torch.compile``/
  ``torch.jit`` or CUDA-graph capture scope.
- **GL002 retrace-hazard** — ``torch.compile``, ``torch.cuda.CUDAGraph()``
  or ``make_graphed_callables`` built inside a loop.
- **GL003 donation-after-use**, **GL004 prng-key-reuse** — not applicable
  to PyTorch (no buffer donation; a ``torch.Generator`` advances on every
  draw); kept by ID with the reason.
- **GL005 collective-axis-drift** — axis-name literals passed to the
  port's collectives on mesh axes that no mesh in the module declares.
- **GL006 mutable-default-arg** — the classic Python footgun.
- **GL007 unguarded-time-in-trace** — ``time.*`` clock reads inside a
  compile or capture scope.
- **GL008 dead-import** — module-level imports never used.
- **GL009 blocking-sync-in-step-loop** — the GL001 calls, not under a
  cadence gate, in a host loop that runs an engine's step.
- **GL010 partition-spec-mismatch** — per-tensor axis specs
  (``param_specs``) naming an axis the mesh lacks, or one axis twice.

The **graftrank** family (``analysis/rank.py``: GR001–GR005) audits the
cross-rank invariants of the multi-process runtime by rank-taint
analysis, as the JAX package's does, over ``torch.distributed`` and the
port's collective helpers.

Usage::

    python -m cs744_pytorch_distributed_tutorial_tpu_torch.analysis [paths...] \\
        [--format=text|json] [--baseline FILE] [--write-baseline]
    python -m cs744_pytorch_distributed_tutorial_tpu_torch.analysis trace --device cpu
    python -m cs744_pytorch_distributed_tutorial_tpu_torch.analysis memory --device cpu

Per-line suppressions: ``# graftlint: disable=GL009 -- reason`` on the
finding's first line (or on a comment line directly above it). The
port's accepted findings live in ``analysis/graftlint_baseline.json``,
each with its reason; the CLI fails on any finding outside it.
"""

from cs744_pytorch_distributed_tutorial_tpu_torch.analysis.core import (
    Baseline,
    Config,
    Finding,
    Suppressions,
)
from cs744_pytorch_distributed_tutorial_tpu_torch.analysis.engine import (
    Report,
    lint_paths,
    lint_source,
)
from cs744_pytorch_distributed_tutorial_tpu_torch.analysis.rules import ALL_RULES, NOT_APPLICABLE

__all__ = [
    "ALL_RULES",
    "NOT_APPLICABLE",
    "Baseline",
    "Config",
    "Finding",
    "Report",
    "Suppressions",
    "lint_paths",
    "lint_source",
]
