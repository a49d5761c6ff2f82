"""graftlint runner: file discovery, per-file rule execution, report (the
JAX package's ``analysis/engine.py``, verbatim but for the imports).

Kept import-light (stdlib only): the CI lint job runs this on a bare
CPU image before any heavyweight dependency is touched.
"""

from __future__ import annotations

import ast
import fnmatch
from dataclasses import dataclass, field
from pathlib import Path
from typing import Iterable

from cs744_pytorch_distributed_tutorial_tpu_torch.analysis.context import ModuleContext
from cs744_pytorch_distributed_tutorial_tpu_torch.analysis.core import (
    Baseline,
    Finding,
    Suppressions,
)
from cs744_pytorch_distributed_tutorial_tpu_torch.analysis.rules import ALL_RULES, RuleFn

__all__ = ["Report", "lint_paths", "lint_source"]


@dataclass
class Report:
    """Outcome of one lint run."""

    findings: list[Finding] = field(default_factory=list)  # actionable
    baselined: list[Finding] = field(default_factory=list)
    suppressed: int = 0
    files: int = 0
    errors: list[str] = field(default_factory=list)  # unreadable/sources
    sources: dict[str, str] = field(default_factory=dict)

    @property
    def exit_code(self) -> int:
        return 1 if (self.findings or self.errors) else 0

    def summary(self) -> str:
        return (
            f"graftlint: {len(self.findings)} finding(s) "
            f"({len(self.baselined)} baselined, {self.suppressed} suppressed) "
            f"in {self.files} file(s)"
        )


def lint_source(
    src: str,
    path: str = "<string>",
    rules: dict[str, RuleFn] | None = None,
) -> tuple[list[Finding], int]:
    """Lint one source blob; returns (unsuppressed findings, suppressed
    count). Raises SyntaxError on unparsable input."""
    tree = ast.parse(src, filename=path)
    ctx = ModuleContext(path, src, tree)
    sup = Suppressions(src)
    active: list[Finding] = []
    suppressed = 0
    # `is None` — not truthiness — so an empty dict (every rule disabled)
    # means "run nothing", not "run everything".
    for rule_fn in (ALL_RULES if rules is None else rules).values():
        for finding in rule_fn(ctx):
            if sup.is_suppressed(finding):
                suppressed += 1
            else:
                active.append(finding)
    active.sort()
    return active, suppressed


def iter_py_files(paths: Iterable[str], exclude: Iterable[str]) -> list[Path]:
    out: list[Path] = []
    seen: set[Path] = set()
    patterns = list(exclude)

    def excluded(p: Path) -> bool:
        rel = p.as_posix()
        return any(
            fnmatch.fnmatch(rel, pat) or fnmatch.fnmatch(p.name, pat)
            for pat in patterns
        )

    for raw in paths:
        p = Path(raw)
        if p.is_dir():
            candidates = sorted(p.rglob("*.py"))
        else:
            candidates = [p]
        for c in candidates:
            if c in seen or excluded(c):
                continue
            seen.add(c)
            out.append(c)
    return out


def lint_paths(
    paths: Iterable[str],
    *,
    exclude: Iterable[str] = (),
    rules: dict[str, RuleFn] | None = None,
    baseline: Baseline | None = None,
) -> Report:
    report = Report()
    for path in iter_py_files(paths, exclude):
        rel = path.as_posix()
        try:
            src = path.read_text()
        except OSError as e:
            report.errors.append(f"{rel}: unreadable: {e}")
            continue
        report.files += 1
        report.sources[rel] = src
        try:
            active, suppressed = lint_source(src, rel, rules)
        except SyntaxError as e:
            report.errors.append(f"{rel}:{e.lineno}: syntax error: {e.msg}")
            continue
        report.suppressed += suppressed
        report.findings.extend(active)
    if baseline is not None:
        report.findings, report.baselined = baseline.split(
            report.findings, report.sources
        )
    report.findings.sort()
    return report
