"""graftmem for the port: the memory ledger and sharding audits (TA007-TA010).

The twin of the JAX package's ``analysis/trace/memory.py``:

========  ======================  =============================================
rule      name                    what it catches
========  ======================  =============================================
TA007     hbm-budget-regression   an entry's memory ledger (argument/output/
                                  temp/alias bytes a rank) past the checked-in
                                  ``analysis/memory_budget.json`` tolerance for
                                  this device
TA008     unintended-replication  a state leaf the sync strategy declares
                                  SHARDED (zero1 momentum rows, fsdp parameter
                                  rows) that this rank holds whole
TA009     implicit-reshard        not applicable (see NOT_APPLICABLE)
TA010     donation-bytes-ledger   how many bytes each TA002 break costs (TA002
                                  says "an in-place update was dropped"; TA010
                                  prices it)
========  ======================  =============================================

The ledger keeps JAX's fields, counted from one recorded step's storages
(``dispatch.StepRecorder``), the same way on the CPU and on the card:

- ``argument_bytes``: the distinct storages of the step's state and inputs;
- ``output_bytes``: the distinct storages of what the step returns and of
  its state after the step;
- ``alias_bytes``: the output storages that are argument storages (state
  updated in place);
- ``temp_bytes``: the peak of the storages the step allocated, less the
  new outputs it left alive;
- ``total_bytes = argument + output + temp - alias``: the argument bytes
  plus the step's allocation peak, the bytes a rank holds at the step's
  high-water mark.

On the card the ledger also records ``cuda_peak_bytes``, the caching
allocator's ``max_memory_allocated`` over the step less what was
allocated before it (the allocator's view of the same peak, rounded to
its blocks). The budget file has one section a device kind: ``cpu``, and
a card's ``nvidia-smi`` name; TA007 gates ``total_bytes`` against the
section of the device it runs on.

graftmem has NO fingerprint baseline: the budget file IS its accepted
state (``--write-budget`` regenerates this device's section). Findings
anchor to the same ``register_entrypoint`` call sites as graftcheck, so
inline pragmas (``# graftlint: disable=TA008 -- reason``) apply.
"""

from __future__ import annotations

import argparse
import json
import math
import sys
from pathlib import Path
from typing import Any

import torch
from torch.utils import _pytree as pytree

from cs744_pytorch_distributed_tutorial_tpu_torch.analysis.core import Finding
from cs744_pytorch_distributed_tutorial_tpu_torch.analysis.trace import dispatch
from cs744_pytorch_distributed_tutorial_tpu_torch.analysis.trace.audits import (
    Recording,
    _rel,
    record_step,
    run_audits,
    world_size,
)
from cs744_pytorch_distributed_tutorial_tpu_torch.analysis.trace.registry import (
    TraceEntry,
    TracedStep,
)

MEMORY_RULES: dict[str, str] = {
    "TA007": "hbm-budget-regression",
    "TA008": "unintended-replication",
    "TA009": "implicit-reshard",
    "TA010": "donation-bytes-ledger",
}

NOT_APPLICABLE = {
    "TA009": "not applicable: no partitioner inserts collectives into an eager "
             "program; every collective is one the code issues, which TA003 counts",
}

DEFAULT_BUDGET = str(Path(__file__).resolve().parent.parent / "memory_budget.json")
#: relative tolerance band around each budgeted total, and the absolute
#: floor under it (the JAX package's)
DEFAULT_TOLERANCE = 0.05
DEFAULT_FLOOR_BYTES = 64 * 1024
#: TA008 ignores leaves below this full (unsharded) size: biases and norm
#: scales cost nothing replicated
TA008_MIN_BYTES = 2048


def _finding(entry: TraceEntry, rule: str, message: str) -> Finding:
    return Finding(
        path=_rel(entry.path),
        line=entry.line,
        col=1,
        rule=rule,
        name=MEMORY_RULES[rule],
        message=f"[{entry.name}] {message}",
    )


def device_section(device: str) -> str:
    """The budget section of a device: ``cpu``, or the card's name as
    ``nvidia-smi`` prints it (``torch.cuda.get_device_name``)."""
    if torch.device(device).type == "cuda":
        return torch.cuda.get_device_name(torch.device(device))
    return "cpu"


# ------------------------------------------------------------- measurement
def ledger_of(entry: TraceEntry, step: TracedStep, run: Recording) -> dict[str, Any]:
    """The JSON-safe ledger of one recorded step (plus ``_``-prefixed
    live objects for the audits, stripped before reporting)."""
    outs = [t for t in pytree.tree_leaves(run.out) if isinstance(t, torch.Tensor)]
    state = step.state()
    out_storages: dict[int, int] = {}  # id(storage) -> bytes, as run.before keys them
    for t in outs + [t for ts in state.values() for t in ts]:
        st = t.untyped_storage()
        out_storages.setdefault(id(st), st.nbytes())
    arg_ids = {key for _, _, key, _ in run.before}
    arg_ids |= {id(t.untyped_storage()) for t in step.arg_tensors()}
    out_b = sum(out_storages.values())
    alias_b = sum(b for key, b in out_storages.items() if key in arg_ids)
    new_out = out_b - alias_b
    temp_b = max(run.rec.peak_bytes - new_out, 0)
    arg_b = run.argument_bytes
    broken = [(b, a) for b, a in zip(run.before, run.after) if b[2] != a[2]]
    kept = len(run.before) - len(broken)
    ledger: dict[str, Any] = {
        "entry": entry.name,
        "devices": max(1, math.prod(step.axis_sizes.values()) if step.axis_sizes
                       else world_size()),
        "argument_bytes": arg_b,
        "output_bytes": out_b,
        "temp_bytes": temp_b,
        "alias_bytes": alias_b,
        "total_bytes": arg_b + out_b + temp_b - alias_b,
        "argument_breakdown": {
            **{name: dispatch.nbytes_of(ts) for name, ts in state.items() if ts},
            **{name: dispatch.nbytes_of(ts) for name, ts in step.args.items() if ts},
        },
        "donated_leaves": len(run.before),
        "aliased_leaves": kept,
        "alias_saved_bytes": sum(b[3] for b, a in zip(run.before, run.after) if b[2] == a[2]),
        "dropped_donation_bytes": sum(a[3] for _, a in broken),
        "replicated_leaves": 0,  # filled by TA008
        "sharded_leaves": [],  # filled by TA008
        "cuda_peak_bytes": run.cuda_peak_bytes,
        "kernel_launches": run.launches,
        "_broken": broken,
    }
    return ledger


def measure_entry(entry: TraceEntry, step: TracedStep) -> dict[str, Any]:
    """Run ``step`` once under the recorder and return its ledger."""
    return ledger_of(entry, step, record_step(step))


# ---------------------------------------------------------------------- TA007
def audit_budget(
    entry: TraceEntry,
    step: TracedStep,
    ledger: dict[str, Any],
    budget: dict[str, Any],
) -> list[Finding]:
    """Compare the measured ledger against this device's section of the
    budget. Gate on ``total_bytes`` only — the components are recorded
    so a regression message can say WHICH part grew."""
    entries = budget.get("entries", {})
    b = entries.get(entry.name)
    if b is None:
        return [
            _finding(
                entry, "TA007",
                f"no memory budget entry for '{entry.name}' in section "
                f"'{budget.get('_section', 'cpu')}' of {budget.get('_path', DEFAULT_BUDGET)} "
                "— run `analysis memory --write-budget` to record one",
            )
        ]
    if int(b.get("devices", ledger["devices"])) != ledger["devices"]:
        return [
            _finding(
                entry, "TA007",
                f"budget was recorded for {b.get('devices')} rank(s) but this audit ran "
                f"on {ledger['devices']} — the per-rank ledger is not comparable; rerun "
                "`analysis memory --write-budget`",
            )
        ]
    budget_total = int(b["total_bytes"])
    tol = max(
        float(budget.get("tolerance", DEFAULT_TOLERANCE)) * budget_total,
        float(budget.get("floor_bytes", DEFAULT_FLOOR_BYTES)),
    )
    measured = int(ledger["total_bytes"])
    if measured > budget_total + tol:
        deltas = ", ".join(
            f"{k.split('_')[0]} {ledger[k] - int(b.get(k, ledger[k])):+d}B"
            for k in ("argument_bytes", "output_bytes", "temp_bytes", "alias_bytes")
        )
        return [
            _finding(
                entry, "TA007",
                f"per-rank memory total {measured}B exceeds the budget {budget_total}B by "
                f"{measured - budget_total:+d}B (> {int(tol)}B tolerance; components: "
                f"{deltas}) — if the growth is intentional, rerun "
                "`analysis memory --write-budget`",
            )
        ]
    return []


# ---------------------------------------------------------------------- TA008
def audit_replication(
    entry: TraceEntry,
    step: TracedStep,
    ledger: dict[str, Any],
    min_bytes: int = TA008_MIN_BYTES,
) -> list[Finding]:
    """Flag state leaves the engine DECLARES sharded
    (``step.sharded_state``) that this rank holds whole at a world above
    one: a silently replicated shard costs ``(n-1)/n`` of its bytes on
    every rank for nothing. The ledger lists each declared leaf's bytes on
    this rank beside its full bytes."""
    n = ledger["devices"]
    if not step.sharded_state:
        return []
    state = step.state()
    out: list[Finding] = []
    rows = []
    for name, shapes in step.sharded_state.items():
        for i, (t, (shape, dtype)) in enumerate(zip(state.get(name, []), shapes)):
            full = dispatch.leaf_bytes(shape, dtype)
            mine = dispatch.tensor_bytes(t)
            rows.append({"collection": name, "index": i, "bytes": mine, "full_bytes": full})
            if n > 1 and full >= min_bytes and t.numel() >= math.prod(shape):
                out.append(
                    _finding(
                        entry, "TA008",
                        f"state leaf {name}[{i}] ({dtype}{tuple(shape)}, {full}B) is held "
                        f"WHOLE on this rank of {n}, but sync='{step.sync}' declares it "
                        "sharded — every rank silently pays the full buffer",
                    )
                )
    ledger["sharded_leaves"] = rows
    ledger["replicated_leaves"] = len(out)
    return out


# ---------------------------------------------------------------------- TA010
def audit_donation_bytes(
    entry: TraceEntry, step: TracedStep, ledger: dict[str, Any]
) -> list[Finding]:
    """Price the in-place breaks TA002 flags: one finding an entry
    totalling the bytes its rebound state double-allocates, naming the
    worst offenders."""
    broken = ledger["_broken"]
    if not broken or not step.check_donation:
        return []
    worst = sorted(broken, key=lambda ba: -ba[1][3])[:3]
    names = ", ".join(f"{a[0]}[{a[1]}] ({a[3]}B)" for _, a in worst)
    return [
        _finding(
            entry, "TA010",
            f"{len(broken)} dropped donation(s) double-allocate "
            f"{ledger['dropped_donation_bytes']}B on this rank; worst: {names}",
        )
    ]


# ------------------------------------------------------------------ budget IO
def _empty_budget() -> dict[str, Any]:
    return {"version": 1, "tolerance": DEFAULT_TOLERANCE,
            "floor_bytes": DEFAULT_FLOOR_BYTES, "devices": {}}


def load_budget(path: str | Path, section: str = "cpu") -> dict[str, Any]:
    """One device section of the budget file, with the file's tolerance
    and floor: ``{"tolerance", "floor_bytes", "entries", "_path",
    "_section"}``. A missing file or section is an EMPTY budget (every
    entry then raises a TA007 missing-entry finding); a malformed file
    raises ``ValueError``."""
    p = Path(path)
    data = _empty_budget()
    if p.is_file():
        data = json.loads(p.read_text())
        if not isinstance(data, dict) or not isinstance(data.get("devices"), dict):
            raise ValueError(f"budget file {p} has no 'devices' object")
    return {
        "tolerance": data.get("tolerance", DEFAULT_TOLERANCE),
        "floor_bytes": data.get("floor_bytes", DEFAULT_FLOOR_BYTES),
        "entries": dict(data["devices"].get(section, {}).get("entries", {})),
        "_path": p.as_posix(),
        "_section": section,
    }


def _budget_entry(ledger: dict[str, Any]) -> dict[str, Any]:
    keep = ("devices", "argument_bytes", "output_bytes", "temp_bytes", "alias_bytes",
            "total_bytes", "dropped_donation_bytes", "cuda_peak_bytes")
    return {k: ledger[k] for k in keep if ledger.get(k) is not None}


def write_budget(path: str | Path, ledgers: list[dict[str, Any]], section: str = "cpu",
                 note: str | None = None) -> int:
    """Record ``ledgers`` into ``section`` of the budget file, merging over
    its existing entries (auditing a subset must not drop the rest's) and
    keeping the other sections. Returns the section's entry count."""
    p = Path(path)
    data = _empty_budget()
    if p.is_file():
        try:
            data = json.loads(p.read_text())
            data.setdefault("devices", {})
        except ValueError:
            data = _empty_budget()
    sec = data["devices"].setdefault(section, {})
    entries = dict(sec.get("entries", {}))
    for ledger in ledgers:
        entries[ledger["entry"]] = _budget_entry(ledger)
    sec["entries"] = {k: entries[k] for k in sorted(entries)}
    if note is not None:
        sec["note"] = note
    payload = {
        "version": 1,
        "tolerance": data.get("tolerance", DEFAULT_TOLERANCE),
        "floor_bytes": data.get("floor_bytes", DEFAULT_FLOOR_BYTES),
        "devices": {k: data["devices"][k] for k in sorted(data["devices"])},
    }
    p.write_text(json.dumps(payload, indent=2) + "\n")
    return len(entries)


# ---------------------------------------------------------------- entry audit
def audit_memory_entry(
    entry: TraceEntry,
    rules: set[str] | None = None,
    budget: dict[str, Any] | None = None,
    device: str = "cuda",
) -> tuple[list[Finding], dict[str, Any]]:
    """Run every selected graftmem rule against one entry. ``budget``
    None skips TA007 entirely. Returns raw (unsuppressed) findings plus
    the JSON-safe ledger."""
    step = entry.build(device)
    return audit_memory_run(entry, step, record_step(step), rules, budget)


def audit_memory_run(
    entry: TraceEntry, step: TracedStep, run: Recording, rules: set[str] | None = None,
    budget: dict[str, Any] | None = None,
) -> tuple[list[Finding], dict[str, Any]]:
    """The graftmem rules on a step already recorded (``record_step``)."""
    active = set(MEMORY_RULES) if rules is None else rules
    ledger = ledger_of(entry, step, run)
    findings: list[Finding] = []
    if "TA008" in active:
        findings += audit_replication(entry, step, ledger)
    if "TA010" in active:
        findings += audit_donation_bytes(entry, step, ledger)
    if "TA007" in active and budget is not None:
        findings += audit_budget(entry, step, ledger, budget)
    ledger = {k: v for k, v in ledger.items() if not k.startswith("_")}
    ledger["findings"] = len(findings)
    return findings, ledger


def run_memory_audits(
    entries: list[TraceEntry],
    rules: set[str] | None = None,
    budget: dict[str, Any] | None = None,
    device: str = "cuda",
) -> tuple[list[Finding], int, list[dict[str, Any]], dict[str, str], list[str]]:
    """Audit all ``entries``; ``audits.run_audits``'s return and
    suppression semantics, the ledgers as its summaries."""
    return run_audits(entries, audit=lambda entry: audit_memory_entry(entry, rules, budget,
                                                                       device))


def ledger_records(ledgers: list[dict[str, Any]]) -> list[dict[str, Any]]:
    """Flat ``kind: memory_ledger`` rows, the JAX package's record shape."""
    keep = ("entry", "devices", "argument_bytes", "output_bytes", "temp_bytes",
            "alias_bytes", "total_bytes", "alias_saved_bytes", "dropped_donation_bytes",
            "replicated_leaves")
    return [{"kind": "memory_ledger", **{k: lg[k] for k in keep}} for lg in ledgers]


# ------------------------------------------------------------------------ CLI
def build_parser() -> argparse.ArgumentParser:
    from cs744_pytorch_distributed_tutorial_tpu_torch.analysis.trace.cli import add_common

    p = argparse.ArgumentParser(
        prog="graftmem",
        description="memory ledger & sharding audits of the port's recorded steps "
        "(TA007-TA010).",
    )
    add_common(p)
    p.add_argument(
        "--budget", default=None,
        help=f"memory budget file for TA007 (default: {DEFAULT_BUDGET})",
    )
    p.add_argument("--no-budget", action="store_true", help="skip the TA007 budget gate")
    p.add_argument(
        "--write-budget", action="store_true",
        help="record the measured ledgers as this device's budget section and exit 0",
    )
    return p


def main(argv: list[str] | None = None) -> int:
    from cs744_pytorch_distributed_tutorial_tpu_torch.analysis.trace.cli import (
        prepare,
        select_rules,
    )

    args = build_parser().parse_args(argv)
    if args.list_rules:
        for rid, name in sorted(MEMORY_RULES.items()):
            reason = f" — {NOT_APPLICABLE[rid]}" if rid in NOT_APPLICABLE else ""
            print(f"{rid}  {name}{reason}")
        return 0
    rules = select_rules(args, MEMORY_RULES, "graftmem")
    if rules is None:
        return 2
    entries = prepare(args, "graftmem")
    if isinstance(entries, int):
        return entries

    section = device_section(args.device)
    budget_path = args.budget or DEFAULT_BUDGET
    budget: dict[str, Any] | None = None
    if not args.no_budget and not args.write_budget:
        try:
            budget = load_budget(budget_path, section)
        except (ValueError, OSError) as e:
            print(f"graftmem: bad budget {budget_path}: {e}", file=sys.stderr)
            return 2

    findings, suppressed, ledgers, _sources, errors = run_memory_audits(
        entries, rules, budget, args.device
    )

    if args.write_budget:
        if errors:
            for err in errors:
                print(f"error: {err}")
            return 1
        n = write_budget(budget_path, ledgers, section)
        print(f"graftmem: wrote {n} budget entr(ies) to section '{section}' of {budget_path}")
        return 0

    exit_code = 1 if (findings or errors) else 0
    payload = {
        "findings": [f.as_dict() for f in findings],
        "suppressed": suppressed,
        "device": section,
        "entries": ledgers,
        "records": ledger_records(ledgers),
        "errors": errors,
        "exit_code": exit_code,
    }
    if args.report:
        Path(args.report).write_text(json.dumps(payload, indent=2) + "\n")
    if args.format == "json":
        print(json.dumps(payload, indent=2))
        return exit_code

    for f in findings:
        print(f.text())
    for err in errors:
        print(f"error: {err}")
    for lg in ledgers:
        print(f"{lg['entry']}: total {lg['total_bytes']}B (argument {lg['argument_bytes']}, "
              f"output {lg['output_bytes']}, temp {lg['temp_bytes']}, alias "
              f"{lg['alias_bytes']}), launches {lg['kernel_launches']}")
    bits = [f"{len(ledgers)} entrypoint(s) measured", f"{len(findings)} finding(s)"]
    if suppressed:
        bits.append(f"{suppressed} suppressed")
    if errors:
        bits.append(f"{len(errors)} error(s)")
    print("graftmem: " + ", ".join(bits))
    return exit_code


if __name__ == "__main__":  # pragma: no cover
    sys.exit(main())
