"""graftcheck CLI — the ``trace`` subcommand of the port's analysis module.

``python -m cs744_pytorch_distributed_tutorial_tpu_torch.analysis trace [entries] --device cpu``

Exit codes mirror graftlint: 0 clean, 1 findings or audit errors (a
factory that cannot build is a failed audit, not a skipped one), 2 usage
error. ``--report FILE`` additionally writes the full JSON report.

Where the JAX CLI forces an 8-device CPU platform, the port's takes
``--device {cuda,cpu}`` (default ``cuda``): each entry is built on that
device, on the process group that exists or a world of one. Without a
card ``--device cuda`` raises; it never falls back to the CPU.
"""

from __future__ import annotations

import argparse
import json
import sys
from pathlib import Path
from typing import Any

from cs744_pytorch_distributed_tutorial_tpu_torch.analysis.core import DEFAULT_BASELINE as _LINT

#: graftcheck's accepted findings (empty: every entry audits clean)
DEFAULT_BASELINE = str(Path(_LINT).with_name("graftcheck_baseline.json"))


def add_common(p: argparse.ArgumentParser) -> None:
    """The flags ``trace`` and ``memory`` share."""
    p.add_argument("entries", nargs="*",
                   help="entrypoint names to audit (default: all registered)")
    p.add_argument("--device", choices=("cuda", "cpu"), default="cuda",
                   help="device to build and run each step on (default: cuda; raises "
                   "without a card)")
    p.add_argument("--list-entrypoints", action="store_true",
                   help="list registered entrypoints and exit")
    p.add_argument("--list-rules", action="store_true", help="list rules and exit")
    p.add_argument("--select", default=None,
                   help="comma-separated TA rule ids to run (default: all)")
    p.add_argument("--disable", default=None, help="comma-separated TA rule ids to skip")
    p.add_argument("--format", choices=("text", "json"), default="text",
                   help="output format (default: text)")
    p.add_argument("--report", default=None,
                   help="also write the full JSON report to this file")


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(
        prog="graftcheck",
        description="audits of one recorded eager step of each engine (TA001-TA006).",
    )
    add_common(p)
    p.add_argument("--baseline", default=None,
                   help=f"baseline file of accepted findings (default: {DEFAULT_BASELINE})")
    p.add_argument("--no-baseline", action="store_true",
                   help="report every finding, ignoring the baseline file")
    p.add_argument("--write-baseline", action="store_true",
                   help="record current findings as the accepted baseline and exit 0")
    return p


def select_rules(args, known: dict[str, str], prog: str) -> set[str] | None:
    """``--select``/``--disable`` over ``known`` (a bare family prefix
    such as ``TA`` selects the family); None after printing on unknowns."""
    rules = set(known)
    for flag, keep in ((args.select, True), (args.disable, False)):
        if not flag:
            continue
        named: set[str] = set()
        unknown: set[str] = set()
        for token in flag.split(","):
            rid = token.strip().upper()
            if not rid:
                continue
            if rid in known:
                named.add(rid)
            elif any(k.startswith(rid) for k in known):
                named.update(k for k in known if k.startswith(rid))
            else:
                unknown.add(rid)
        if unknown:
            print(f"{prog}: unknown rule(s): {sorted(unknown)}", file=sys.stderr)
            return None
        rules = rules & named if keep else rules - named
    return rules


def prepare(args, prog: str):
    """Check the device (raising without a card for ``cuda``), load the
    builtin entries and pick ``args.entries``: the entries, or an exit
    code (0 after ``--list-entrypoints``, 2 on an unknown name)."""
    from cs744_pytorch_distributed_tutorial_tpu_torch.analysis.trace.registry import (
        get_entrypoints,
        load_builtin_entrypoints,
    )
    from cs744_pytorch_distributed_tutorial_tpu_torch.config import resolve_device

    resolve_device(args.device)
    load_builtin_entrypoints()
    try:
        entries = get_entrypoints(args.entries or None)
    except KeyError as e:
        print(f"{prog}: {e.args[0]}", file=sys.stderr)
        return 2
    if args.list_entrypoints:
        for entry in entries:
            tags = f" [{','.join(entry.tags)}]" if entry.tags else ""
            print(f"{entry.name}  {entry.path}:{entry.line}{tags}")
        return 0
    return entries


def main(argv: list[str] | None = None) -> int:
    from cs744_pytorch_distributed_tutorial_tpu_torch.analysis.core import Baseline
    from cs744_pytorch_distributed_tutorial_tpu_torch.analysis.trace.audits import (
        NOT_APPLICABLE,
        TRACE_RULES,
        run_audits,
    )

    args = build_parser().parse_args(argv)
    if args.list_rules:
        for rid, name in sorted(TRACE_RULES.items()):
            reason = f" — {NOT_APPLICABLE[rid]}" if rid in NOT_APPLICABLE else ""
            print(f"{rid}  {name}{reason}")
        return 0
    rules = select_rules(args, TRACE_RULES, "graftcheck")
    if rules is None:
        return 2
    entries = prepare(args, "graftcheck")
    if isinstance(entries, int):
        return entries

    findings, suppressed, summaries, sources, errors = run_audits(entries, rules, args.device)

    baseline_path = Path(args.baseline or DEFAULT_BASELINE)
    baselined: list[Any] = []
    if args.write_baseline:
        n = Baseline.dump(findings, sources, baseline_path)
        print(f"graftcheck: wrote {n} baseline entr(ies) to {baseline_path}")
        return 0
    if not args.no_baseline and baseline_path.is_file():
        try:
            baseline = Baseline.load(baseline_path)
        except (OSError, ValueError, KeyError) as e:
            print(f"graftcheck: bad baseline {baseline_path}: {e}", file=sys.stderr)
            return 2
        findings, baselined = baseline.split(findings, sources)

    exit_code = 1 if (findings or errors) else 0
    payload = {
        "findings": [f.as_dict() for f in findings],
        "baselined": [f.as_dict() for f in baselined],
        "suppressed": suppressed,
        "device": args.device,
        "entries": summaries,
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
    for s in summaries:
        print(f"{s['entry']}: schedule {s.get('schedule')}, wire {s.get('recorded_wire_bytes')}B "
              f"(expected {s.get('expected_wire_bytes')}), launches {s['kernel_launches']}")
    bits = [f"{len(summaries)} entrypoint(s) audited", f"{len(findings)} finding(s)"]
    if baselined:
        bits.append(f"{len(baselined)} baselined")
    if suppressed:
        bits.append(f"{suppressed} suppressed")
    if errors:
        bits.append(f"{len(errors)} error(s)")
    print("graftcheck: " + ", ".join(bits))
    return exit_code


if __name__ == "__main__":  # pragma: no cover
    sys.exit(main())
