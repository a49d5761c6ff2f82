"""The TA-rule audits on one recorded eager step of each engine.

The twin of the JAX package's ``analysis/trace/audits.py``, under the
same rule IDs and names:

========  =============================  =======================================
rule      name                           what it catches
========  =============================  =======================================
TA001     bf16-upcast-matmul             an fp32 mm/addmm/bmm/convolution whose
                                         input derives from a bf16 value, outside
                                         norm/softmax/loss/optimizer code
TA002     dropped-donation               state the step promises to update in
                                         place (parameters, momentum, AdamW
                                         moments, KV pools) not in the same
                                         storage after the step
TA003     collective-schedule-mismatch   gradient-collective counts or bytes-on-
                                         wire disagreeing with the strategy's
                                         contract / the engine's accounting
TA004     large-trace-constant           not applicable (see NOT_APPLICABLE)
TA005     dead-expensive-eqn             a matmul, collective or large op whose
                                         output no later op consumes and the step
                                         neither returns nor keeps
TA006     branch-collective-mismatch     ranks (or the step's variants on a
                                         runtime predicate) issuing different
                                         collective sequences — a hang
========  =============================  =======================================

Each audit reads one :func:`record_step` run: the step runs once under
the recording dispatch mode (``dispatch.py``) with the hand-written
kernels' launch counters and ``ops/_cost.py`` records read around it. A
``ctypes`` kernel is opaque to the recording: TA001 names the kernels it
could not look inside in its report, and TA005 counts as read exactly the
operands each launch names in its ``_cost.add`` report, so a dense gather
left beside the paged kernel, no kernel's operand, is dead work it reports.

Findings are anchored to the entry's ``register_entrypoint`` call site, so
graftlint's inline pragmas (``# graftlint: disable=TA003 -- reason``) and
the shared baseline machinery apply unchanged.
"""

from __future__ import annotations

import dataclasses
import os
import re
import time
from pathlib import Path
from typing import Any, Callable

import torch
import torch.distributed as dist
from torch.utils import _pytree as pytree

from cs744_pytorch_distributed_tutorial_tpu_torch.analysis.core import (
    Finding,
    Suppressions,
)
from cs744_pytorch_distributed_tutorial_tpu_torch.analysis.trace import dispatch
from cs744_pytorch_distributed_tutorial_tpu_torch.analysis.trace.registry import (
    TraceEntry,
    TracedStep,
)

TRACE_RULES: dict[str, str] = {
    "TA001": "bf16-upcast-matmul",
    "TA002": "dropped-donation",
    "TA003": "collective-schedule-mismatch",
    "TA004": "large-trace-constant",
    "TA005": "dead-expensive-eqn",
    "TA006": "branch-collective-mismatch",
}

#: Rules kept by ID with no object in an eager program, and why.
NOT_APPLICABLE = {
    "TA004": "not applicable: an eager step captures nothing into a trace, so no "
             "array can be baked in as a constant; its inputs are its arguments",
}

#: sites where an f32 matmul under mixed precision is deliberate policy:
#: normalization statistics, softmax/loss numerics, optimizer math
_TA001_ALLOWLIST = re.compile(
    r"norm|softmax|cross_entropy|xent|loss|logsumexp|optimi[sz]er"
    r"|update|sgd|adam",
    re.IGNORECASE,
)

#: TA005: a dead op is expensive when it is a matmul or a collective, or
#: materializes at least this many bytes
DEAD_MIN_BYTES = dispatch.KEEP_MIN_BYTES


def _rel(path: str) -> str:
    try:
        return Path(path).resolve().relative_to(Path.cwd()).as_posix()
    except ValueError:
        return Path(path).as_posix()


def _finding(entry: TraceEntry, rule: str, message: str) -> Finding:
    return Finding(
        path=_rel(entry.path),
        line=entry.line,
        col=1,
        rule=rule,
        name=TRACE_RULES[rule],
        message=f"[{entry.name}] {message}",
    )


def _frames_str(frames: list[tuple[str, str, int]]) -> str:
    if not frames:
        return "<no user frames>"
    return "; ".join(f"{Path(f).name}:{ln} in {fn}" for f, fn, ln in frames[-3:])


# ---------------------------------------------------------------- kernels
def _kernel_modules() -> dict[str, Any]:
    from cs744_pytorch_distributed_tutorial_tpu_torch.ops import flash_attention as A
    from cs744_pytorch_distributed_tutorial_tpu_torch.ops import fused_conv as C
    from cs744_pytorch_distributed_tutorial_tpu_torch.ops import fused_sgd as K
    from cs744_pytorch_distributed_tutorial_tpu_torch.ops import fused_xent as FX
    from cs744_pytorch_distributed_tutorial_tpu_torch.ops import gmm as G
    from cs744_pytorch_distributed_tutorial_tpu_torch.ops import paged_attention as PA
    from cs744_pytorch_distributed_tutorial_tpu_torch.ops import quant as QT

    return {"fused_sgd": K, "conv3x3_wgrad": C, "flash": A, "paged_attention": PA,
            "int8_matmul": QT, "fused_xent": FX, "gmm": G}


def kernel_launches() -> dict[str, int]:
    """Every hand-written kernel family's launch counter now."""
    return {name: int(mod.launch_count()) for name, mod in _kernel_modules().items()}


# ---------------------------------------------------------------- recording
@dataclasses.dataclass
class Recording:
    """One recorded step: the recorder, what the step returned, the state
    before and after (``(collection, index, storage id, bytes)``: a
    storage's Python object lives as long as its C++ storage, and the
    recorder keeps the argument storages alive, so equal ids are one
    storage), the kernel launches and costs, and the card's allocator
    peak."""

    rec: dispatch.StepRecorder
    out: Any
    before: list[tuple[str, int, int, int]]
    after: list[tuple[str, int, int, int]]
    launches: dict[str, int]
    kernel_flops: float
    kernel_bytes: float
    seconds: float
    argument_bytes: int
    cuda_peak_bytes: int | None
    alive_after: set[int]  # ids of recorded tensors still alive after the step


def _state_storages(state: dict[str, list[torch.Tensor]]) -> list[tuple[str, int, int, int]]:
    return [(name, i, id(t.untyped_storage()), t.untyped_storage().nbytes())
            for name, ts in state.items() for i, t in enumerate(ts)]


def record_step(step: TracedStep, fn=None) -> Recording:
    """Run ``step.fn`` (or ``fn``, one of its variants) once under the
    recording dispatch mode."""
    from cs744_pytorch_distributed_tutorial_tpu_torch.ops import _cost

    state = step.state()
    tensors = [t for ts in state.values() for t in ts] + step.arg_tensors()
    before = _state_storages(state)
    argument_bytes = dispatch.nbytes_of(tensors)
    on_card = any(t.is_cuda for t in tensors)
    if on_card:
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        base = torch.cuda.memory_allocated()
    launches0 = kernel_launches()
    t0 = time.perf_counter()
    with _cost.counting() as costs, dispatch.recording(tensors) as rec:
        out = (fn or step.fn)()
    if on_card:
        torch.cuda.synchronize()
    seconds = time.perf_counter() - t0
    launches1 = kernel_launches()
    after = _state_storages(step.state())
    alive = {i for i, r in rec.kept_refs.items() if r() is not None}
    del tensors
    return Recording(
        rec=rec, out=out, before=before, after=after,
        launches={k: launches1[k] - launches0[k] for k in launches1 if launches1[k] != launches0[k]},
        kernel_flops=costs.flops, kernel_bytes=costs.bytes_accessed, seconds=seconds,
        argument_bytes=argument_bytes,
        cuda_peak_bytes=(torch.cuda.max_memory_allocated() - base) if on_card else None,
        alive_after=alive,
    )


def world_size() -> int:
    return dist.get_world_size() if dist.is_initialized() else 1


def gather_ranks(value: Any) -> list[Any]:
    """Every rank's ``value`` (a world of one: ``[value]``)."""
    n = world_size()
    if n == 1:
        return [value]
    out: list[Any] = [None] * n
    dist.all_gather_object(out, value)
    return out


# ---------------------------------------------------------------------- TA001
def audit_dtype_upcast(entry: TraceEntry, step: TracedStep, run: Recording) -> list[Finding]:
    out: list[Finding] = []
    for op in run.rec.ops:
        if not (op.upcast_input and op.name in dispatch.MATMUL_OPS
                and torch.float32 in op.out_dtypes):
            continue
        frames = op.frames
        if any(_TA001_ALLOWLIST.search(fn) or _TA001_ALLOWLIST.search(Path(f).name)
               for f, fn, _ in frames):
            continue
        shape = op.out_shapes[0] if op.out_shapes else ()
        out.append(_finding(
            entry, "TA001",
            f"f32 {op.name} (out shape {shape}) takes an input derived from bf16 "
            f"values — a silent 4-byte upcast in a mixed-precision step; "
            f"dispatched at {_frames_str(frames)}",
        ))
    return out


# ---------------------------------------------------------------------- TA002
def audit_donation(
    entry: TraceEntry, step: TracedStep, run: Recording
) -> tuple[list[Finding], dict[str, Any]]:
    """Every state tensor the step promises to update in place must be in
    the same storage after the step. A tensor rebound to a new storage
    means the step allocated a second copy — the in-place contract was
    silently dropped."""
    broken = [(b, a) for b, a in zip(run.before, run.after) if b[2] != a[2]]
    info = {"arg_leaves": len(run.before), "donated": len(run.before),
            "aliased": len(run.before) - len(broken)}
    out = []
    if len(run.before) != len(run.after):
        out.append(_finding(
            entry, "TA002",
            f"the step changed its state's structure ({len(run.before)} tensors before, "
            f"{len(run.after)} after): the in-place audit is unverifiable",
        ))
        return out, info
    for (name, i, _, nbytes), _a in broken:
        out.append(_finding(
            entry, "TA002",
            f"state {name}[{i}] ({nbytes}B) is promised in place but the step left it "
            f"in a new storage — the update was not in place and the buffer is "
            f"double-allocated",
        ))
    return out, info


# ---------------------------------------------------------------------- TA003
def step_schedule(run: Recording) -> tuple[dict[str, int], float]:
    """The step's schedule and per-device wire bytes over every rank
    (``dispatch.combine_ranks``); a collective call on a multi-rank group."""
    colls = run.rec.collectives()
    coll_wire, p2p_sent = dispatch.wire_split(colls)
    per_rank = gather_ranks((dispatch.schedule_counts(colls), coll_wire, p2p_sent))
    return dispatch.combine_ranks(per_rank)


def audit_collective_schedule(
    entry: TraceEntry, step: TracedStep, run: Recording
) -> tuple[list[Finding], dict[str, Any]]:
    counts, wire = step_schedule(run)
    info = {
        "schedule": counts,
        "recorded_wire_bytes": int(wire),
        "expected_wire_bytes": (
            None if step.expected_wire_bytes is None else int(step.expected_wire_bytes)
        ),
    }
    out: list[Finding] = []
    if step.expected_schedule is not None:
        expected = {k: v for k, v in step.expected_schedule.items() if v}
        if counts != expected:
            out.append(_finding(
                entry, "TA003",
                f"gradient-collective schedule {counts} does not match the "
                f"'{step.sync}' contract {expected}",
            ))
    if step.expected_wire_bytes is not None:
        expected_b = float(step.expected_wire_bytes)
        tol = max(0.01 * expected_b, 512.0)
        if abs(wire - expected_b) > tol:
            pct = (100.0 * abs(wire - expected_b) / expected_b if expected_b else float("inf"))
            out.append(_finding(
                entry, "TA003",
                f"bytes-on-wire from the recording ({int(wire)}) disagrees with the "
                f"engine's sync_wire_bytes accounting ({int(expected_b)}) by {pct:.1f}% "
                f"(> 1% tolerance) for sync='{step.sync}'",
            ))
    return out, info


# ---------------------------------------------------------------------- TA005
#: Ops that allocate (and at most fill) a buffer: they compute nothing,
#: and their buffers are often a ``ctypes`` kernel's operands, written
#: and read where the recording cannot see (the wgrad kernel's planes).
ALLOCATING_OPS = {
    "empty", "empty_like", "empty_strided", "new_empty", "new_empty_strided",
    "zeros", "zeros_like", "new_zeros", "ones", "ones_like", "new_ones",
    "full", "full_like", "new_full",
}


def dead_expensive_ops(run: Recording, min_bytes: int = DEAD_MIN_BYTES) -> list[dispatch.OpRecord]:
    """Ops whose outputs no later op read, no hand-written kernel took as
    an operand, the step did not return and nothing kept alive: computed,
    then thrown away. In-place ops and collectives have
    effects and are live, allocations and views compute nothing
    (``ALLOCATING_OPS``; a view allocates no storage); only expensive dead
    work (matmuls, or ``min_bytes`` or more materialized) is reported."""
    consumed: set[int] = set()
    for op in run.rec.ops:
        consumed.update(op.inputs)
    returned = {run.rec.known_id(t) for t in pytree.tree_leaves(run.out)
                if isinstance(t, torch.Tensor)}
    dead = []
    for op in run.rec.ops:
        if op.mutates or not op.outputs or op.name in ALLOCATING_OPS:
            continue
        if not (op.name in dispatch.MATMUL_OPS or op.new_bytes >= min_bytes):
            continue
        if any(o in consumed or o in returned or o in run.alive_after
               or o in run.rec.kernel_reads for o in op.outputs):
            continue
        dead.append(op)
    return dead


def audit_dead_computation(entry: TraceEntry, step: TracedStep, run: Recording) -> list[Finding]:
    return [
        _finding(
            entry, "TA005",
            f"dead {op.name} (out {op.out_shapes}): its outputs are read by no later op, "
            "returned by no one and kept by nothing, so the work is computed and discarded",
        )
        for op in dead_expensive_ops(run)
    ]


# ---------------------------------------------------------------------- TA006
def _branch_sequences(step: TracedStep) -> dict[str, list[tuple]]:
    return {name: dispatch.collective_sequence(record_step(step, fn).rec.collectives())
            for name, fn in step.branches.items()}


def rank_divergence(per_rank: list[tuple[list[tuple], dict]]) -> list[str]:
    """What is wrong across the ranks, from each rank's
    ``(collective_sequence, p2p_edges)``: ranks whose collective sequence
    is not rank 0's, and messages a rank sends that its peer does not
    receive alike."""
    out: list[str] = []
    first = per_rank[0][0]
    differ = [r for r, (seq, _) in enumerate(per_rank) if seq != first]
    if differ:
        out.append(
            f"ranks {differ} issue a collective sequence other than rank 0's "
            f"({per_rank[differ[0]][0][:4]}... vs {first[:4]}...) — a cross-rank "
            "disagreement in what the step runs desynchronizes the collectives and "
            "hangs the job")
    for r, (_, edges) in enumerate(per_rank):
        for (kind, peer), sizes in sorted(edges.items()):
            if kind != "send" or peer >= len(per_rank):
                continue
            got = per_rank[peer][1].get(("recv", r), [])
            if got != sizes:
                out.append(
                    f"rank {r} sends messages of {sizes} bytes to rank {peer}, which "
                    f"receives {got} from it — an unmatched point-to-point message hangs "
                    "both ranks")
    return out


def audit_branch_divergence(
    entry: TraceEntry, step: TracedStep, run: Recording
) -> list[Finding]:
    """The ranks' collective sequences must agree (a rank that skips or
    reorders one hangs its peers), every message a rank sends must meet
    its peer's receive, and the step's variants on a runtime predicate
    (``step.branches``, each run on every rank) must issue one sequence.
    The runtime twin of JAX's cond-branch diff; graftrank's GR001 is the
    static one."""
    colls = run.rec.collectives()
    per_rank = gather_ranks((dispatch.collective_sequence(colls), dispatch.p2p_edges(colls)))
    out = [_finding(entry, "TA006", msg) for msg in rank_divergence(per_rank)]
    if step.branches:
        branch = _branch_sequences(step)
        names = list(branch)
        if any(branch[n] != branch[names[0]] for n in names[1:]):
            desc = " vs ".join(f"{n}: {dispatch.schedule_counts_of(branch[n])}" for n in names)
            out.append(_finding(
                entry, "TA006",
                f"the step's variants lower DIFFERENT collective schedules ({desc}) — any "
                "cross-rank disagreement in the predicate desynchronizes the collective "
                "schedule and hangs the job",
            ))
    return out


# ---------------------------------------------------------------- entry audit
def audit_entry(
    entry: TraceEntry, rules: set[str] | None = None, device: str = "cuda"
) -> tuple[list[Finding], dict[str, Any]]:
    """Run every selected TA rule against one entry. Returns raw
    (unsuppressed) findings plus a summary dict for the JSON report."""
    step = entry.build(device)
    return audit_run(entry, step, record_step(step), rules, device)


def audit_run(
    entry: TraceEntry, step: TracedStep, run: Recording, rules: set[str] | None = None,
    device: str = "cuda",
) -> tuple[list[Finding], dict[str, Any]]:
    """The TA rules on a step already recorded (``record_step``): one run
    can serve the trace and the memory audits."""
    active = set(TRACE_RULES) if rules is None else rules
    findings: list[Finding] = []
    summary: dict[str, Any] = {
        "entry": entry.name,
        "anchor": f"{_rel(entry.path)}:{entry.line}",
        "device": device,
        "sync": step.sync,
        "grad_compress": step.grad_compress,
        "compute_dtype": step.compute_dtype,
        "axis_sizes": dict(step.axis_sizes),
        "ops": len(run.rec.ops),
        "step_seconds": run.seconds,
        "kernel_launches": run.launches,
        "kernel_flops": run.kernel_flops,
        "kernel_bytes": run.kernel_bytes,
        **step.detail,
    }
    if "TA001" in active:
        findings += audit_dtype_upcast(entry, step, run)
        summary["ta001_opaque_kernels"] = sorted(run.launches)
    if "TA002" in active and step.check_donation:
        f, dinfo = audit_donation(entry, step, run)
        findings += f
        summary["donation"] = dinfo
    if "TA003" in active:
        f, sinfo = audit_collective_schedule(entry, step, run)
        findings += f
        summary.update(sinfo)
    if "TA005" in active:
        findings += audit_dead_computation(entry, step, run)
    if "TA006" in active:
        findings += audit_branch_divergence(entry, step, run)
    summary["findings"] = len(findings)
    return findings, summary


def run_audits(
    entries: list[TraceEntry], rules: set[str] | None = None, device: str = "cuda",
    audit: Callable[[TraceEntry], tuple[list[Finding], dict[str, Any]]] | None = None,
) -> tuple[list[Finding], int, list[dict[str, Any]], dict[str, str], list[str]]:
    """Audit all ``entries`` with ``audit(entry)`` (raw findings and a
    summary; by default :func:`audit_entry` under ``rules`` on ``device``).
    Returns (findings, suppressed_count, summaries, sources, errors) —
    ``sources`` maps each anchoring file's relative path to its text, for
    baseline fingerprinting."""
    audit = audit or (lambda entry: audit_entry(entry, rules, device))
    findings: list[Finding] = []
    suppressed = 0
    summaries: list[dict[str, Any]] = []
    sources: dict[str, str] = {}
    errors: list[str] = []
    for entry in entries:
        try:
            raw, summary = audit(entry)
        except Exception as exc:  # surface as an audit error (exit 1)
            errors.append(f"{entry.name}: {type(exc).__name__}: {exc}")
            continue
        rel = _rel(entry.path)
        if rel not in sources and os.path.exists(entry.path):
            sources[rel] = Path(entry.path).read_text()
        supp = Suppressions(sources.get(rel, ""))
        kept = [f for f in raw if not supp.is_suppressed(f)]
        suppressed += len(raw) - len(kept)
        findings += kept
        summaries.append(summary)
    return findings, suppressed, summaries, sources, errors

