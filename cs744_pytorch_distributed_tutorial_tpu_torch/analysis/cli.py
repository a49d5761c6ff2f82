"""graftlint CLI for the port.

``python -m cs744_pytorch_distributed_tutorial_tpu_torch.analysis [paths...]``

The JAX package's CLI with the port's defaults: with no paths it lints
the port's package, and ``--baseline`` defaults to
``cs744_pytorch_distributed_tutorial_tpu_torch/analysis/graftlint_baseline.json``.

Exit codes: 0 clean, 1 findings (or unreadable/syntax-error files),
2 usage error. ``--write-baseline`` records the current findings as the
accepted residual and exits 0. ``--fix`` applies the safe auto-fixes
(GL008 dead-import removal) before linting and reports what remains.

``python -m ...analysis trace [...]`` dispatches to graftcheck, the
audits of one recorded eager step of each registered engine (TA001-TA006,
``analysis/trace/cli.py``); ``python -m ...analysis memory [...]``
dispatches to graftmem, its memory ledger and sharding audits with the
budget gate (TA007-TA010, ``analysis/trace/memory.py``). Both take
``--device {cuda,cpu}`` (default ``cuda``; without a card they raise).

``--select``/``--disable`` take rule ids or bare family prefixes —
``--select GR`` runs every graftrank rule.
"""

from __future__ import annotations

import argparse
import json
import sys
from pathlib import Path

from cs744_pytorch_distributed_tutorial_tpu_torch.analysis.core import Baseline, Config
from cs744_pytorch_distributed_tutorial_tpu_torch.analysis.engine import lint_paths
from cs744_pytorch_distributed_tutorial_tpu_torch.analysis.rules import (
    ALL_RULES,
    NOT_APPLICABLE,
)


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(
        prog="graftlint",
        description="PyTorch/CUDA-aware static analysis of the port (GL001-GL010, "
        "GR001-GR005).",
    )
    p.add_argument(
        "paths",
        nargs="*",
        help="files or directories to lint (default: the port's package, or "
        "[tool.graftlint_torch] paths from pyproject.toml)",
    )
    p.add_argument(
        "--format",
        choices=("text", "json"),
        default="text",
        help="output format (default: text)",
    )
    p.add_argument(
        "--baseline",
        default=None,
        help="baseline file of accepted findings (default: the port's "
        "analysis/graftlint_baseline.json)",
    )
    p.add_argument(
        "--no-baseline",
        action="store_true",
        help="report every finding, ignoring the baseline file",
    )
    p.add_argument(
        "--write-baseline",
        action="store_true",
        help="record current findings as the accepted baseline and exit 0",
    )
    p.add_argument(
        "--select",
        default=None,
        help="comma-separated rule ids to run (default: all)",
    )
    p.add_argument(
        "--disable",
        default=None,
        help="comma-separated rule ids to skip",
    )
    p.add_argument(
        "--list-rules", action="store_true", help="list rules and exit"
    )
    p.add_argument(
        "--fix",
        action="store_true",
        help="auto-remove GL008 dead imports in the linted files, then lint",
    )
    return p


def _expand_rule_ids(
    raw: list[str], known: dict, strict: bool = True
) -> set[str] | None:
    """Normalize a rule-id list: a bare family prefix (``GL``, ``GR``)
    selects every rule of that family. Returns None (after printing) on
    unknown ids when ``strict``."""
    out: set[str] = set()
    unknown: set[str] = set()
    for token in raw:
        rid = token.strip().upper()
        if not rid:
            continue
        if rid in known:
            out.add(rid)
        elif any(k.startswith(rid) for k in known):
            out.update(k for k in known if k.startswith(rid))
        else:
            unknown.add(rid)
    if unknown and strict:
        print(f"graftlint: unknown rule(s): {sorted(unknown)}", file=sys.stderr)
        return None
    return out


def main(argv: list[str] | None = None) -> int:
    if argv is None:
        argv = sys.argv[1:]
    if argv and argv[0] == "trace":
        # graftcheck: audits of recorded steps. Imported lazily: the
        # linter itself needs no torch.
        from cs744_pytorch_distributed_tutorial_tpu_torch.analysis.trace.cli import (
            main as trace_main,
        )

        return trace_main(argv[1:])
    if argv and argv[0] == "memory":
        # graftmem: the memory ledger, sharding audits and budget gate.
        from cs744_pytorch_distributed_tutorial_tpu_torch.analysis.trace.memory import (
            main as memory_main,
        )

        return memory_main(argv[1:])
    args = build_parser().parse_args(argv)
    if args.list_rules:
        for rid, fn in sorted(ALL_RULES.items()):
            doc = (fn.__doc__ or "").strip().splitlines()[0]
            if rid in NOT_APPLICABLE:
                doc = f"{doc.split(' — ')[0]} — {NOT_APPLICABLE[rid]}"
            print(f"{rid}  {doc}")
        return 0

    config = Config.load()
    paths = args.paths or config.paths
    if not paths:
        print(
            "graftlint: no paths given and no [tool.graftlint_torch] paths "
            "configured",
            file=sys.stderr,
        )
        return 2

    rules = dict(ALL_RULES)
    if args.select:
        wanted = _expand_rule_ids(args.select.split(","), rules)
        if wanted is None:
            return 2
        rules = {rid: fn for rid, fn in rules.items() if rid in wanted}
    disabled = _expand_rule_ids(
        list(args.disable.split(",") if args.disable else [])
        + list(config.disable),
        ALL_RULES,
        strict=False,
    )
    for rid in disabled or ():
        rules.pop(rid, None)

    if args.fix:
        from cs744_pytorch_distributed_tutorial_tpu_torch.analysis.fix import fix_paths

        files_changed, removed = fix_paths(paths, exclude=config.exclude)
        print(
            f"graftlint: --fix removed {removed} dead import(s) in "
            f"{files_changed} file(s)",
            file=sys.stderr,
        )

    baseline_path = Path(args.baseline or config.baseline)
    baseline = None
    if not args.no_baseline and not args.write_baseline and baseline_path.is_file():
        try:
            baseline = Baseline.load(baseline_path)
        except (OSError, ValueError, KeyError) as e:
            print(f"graftlint: bad baseline {baseline_path}: {e}", file=sys.stderr)
            return 2

    report = lint_paths(paths, exclude=config.exclude, rules=rules, baseline=baseline)

    if args.write_baseline:
        n = Baseline.dump(report.findings, report.sources, baseline_path)
        print(f"graftlint: wrote {n} baseline entr(ies) to {baseline_path}")
        return 0

    if args.format == "json":
        print(
            json.dumps(
                {
                    "findings": [f.as_dict() for f in report.findings],
                    "baselined": [f.as_dict() for f in report.baselined],
                    "suppressed": report.suppressed,
                    "files": report.files,
                    "errors": report.errors,
                    "exit_code": report.exit_code,
                },
                indent=2,
            )
        )
    else:
        for f in report.findings:
            print(f.text())
        for err in report.errors:
            print(f"error: {err}")
        print(report.summary())
    return report.exit_code


if __name__ == "__main__":  # pragma: no cover
    sys.exit(main())
