"""graftlint plumbing: findings, suppressions, baseline, config.

The port's copy of the JAX package's ``analysis/core.py`` (the pragma
syntax, the fingerprints and the baseline format are the same). Two
differences: a baseline entry may carry a ``reason``, which ``dump``
keeps for the fingerprints it writes again, and ``Config`` reads
``[tool.graftlint_torch]`` with the port's own defaults (its package as
the path, ``analysis/graftlint_baseline.json`` as the baseline).

Everything here is stdlib-only so the lint needs no installed
dependencies beyond the interpreter.
"""

from __future__ import annotations

import ast
import io
import json
import os
import re
import tokenize
from dataclasses import dataclass, field
from pathlib import Path
from typing import Any, Iterable

__all__ = ["Baseline", "Config", "Finding", "Suppressions"]


@dataclass(frozen=True, order=True)
class Finding:
    """One lint finding, anchored to the node's FIRST source line (that
    is also the line an inline suppression must sit on)."""

    path: str  # posix-style, relative to the lint root
    line: int
    col: int
    rule: str  # "GL001"...
    name: str  # "host-sync-in-jit-scope"
    message: str

    def text(self) -> str:
        return (
            f"{self.path}:{self.line}:{self.col}: "
            f"{self.rule} [{self.name}] {self.message}"
        )

    def as_dict(self) -> dict[str, Any]:
        return {
            "path": self.path,
            "line": self.line,
            "col": self.col,
            "rule": self.rule,
            "name": self.name,
            "message": self.message,
        }


# --------------------------------------------------------------- suppressions
# GLxxx are the AST lint rules; GRxxx the graftrank cross-rank rules;
# TAxxx are graftcheck's trace-audit rules, which anchor to
# register_entrypoint() call sites and reuse this machinery.
_SUPPRESS_RE = re.compile(
    r"graftlint:\s*(?P<kind>disable-file|disable)\s*=\s*"
    r"(?P<rules>(?:(?:GL|TA|GR)\d+|all)(?:\s*,\s*(?:(?:GL|TA|GR)\d+|all))*)"
    r"(?:\s+--\s*(?P<reason>.*))?",
)


class Suppressions:
    """Inline ``# graftlint: disable=GL001[,GL002] -- reason`` comments.

    A trailing comment suppresses findings on its own line; a comment
    that is the whole line suppresses the next CODE line below it,
    skipping blank and comment-only lines (so a pragma can live anywhere
    in the comment block above a multi-line statement). A standalone
    pragma with NO code line after it (end of file) applies file-wide —
    silently binding to nothing would be worse than either reading.
    ``disable-file=`` anywhere suppresses the rule(s) file-wide.
    """

    def __init__(self, src: str) -> None:
        self.by_line: dict[int, set[str]] = {}
        self.file_wide: set[str] = set()
        lines = src.splitlines()

        def _is_code(i: int) -> bool:  # 1-based line number
            text = lines[i - 1] if i - 1 < len(lines) else ""
            stripped = text.strip()
            return bool(stripped) and not stripped.startswith("#")

        try:
            tokens = list(tokenize.generate_tokens(io.StringIO(src).readline))
        except (tokenize.TokenError, IndentationError, SyntaxError):
            tokens = []
        for tok in tokens:
            if tok.type != tokenize.COMMENT:
                continue
            m = _SUPPRESS_RE.search(tok.string)
            if not m:
                continue
            rules = {r.strip() for r in m.group("rules").split(",")}
            if m.group("kind") == "disable-file":
                self.file_wide |= rules
                continue
            target = tok.start[0]
            if not _is_code(target):  # standalone pragma: bind forward
                target += 1
                while target <= len(lines) and not _is_code(target):
                    target += 1
                if target > len(lines):
                    # Nothing follows (trailing pragma at end of file):
                    # apply file-wide rather than bind to no line at all.
                    self.file_wide |= rules
                    continue
            self.by_line.setdefault(target, set()).update(rules)

    def is_suppressed(self, finding: Finding) -> bool:
        if finding.rule in self.file_wide or "all" in self.file_wide:
            return True
        rules = self.by_line.get(finding.line)
        return bool(rules) and (finding.rule in rules or "all" in rules)


# ------------------------------------------------------------------- baseline
class Baseline:
    """Checked-in registry of accepted residual findings.

    Entries are line-number-free fingerprints — ``(path, rule, stripped
    source line, index-among-identical)`` — so unrelated edits shifting
    line numbers don't invalidate the baseline, while touching the
    flagged line itself resurfaces the finding.
    """

    def __init__(self, entries: Iterable[tuple[str, str, str, int]] = ()) -> None:
        self.entries: set[tuple[str, str, str, int]] = set(entries)

    @staticmethod
    def fingerprints(
        findings: Iterable[Finding], sources: dict[str, str]
    ) -> list[tuple[str, str, str, int]]:
        seen: dict[tuple[str, str, str], int] = {}
        out = []
        for f in sorted(findings):
            lines = sources.get(f.path, "").splitlines()
            context = (
                lines[f.line - 1].strip() if f.line - 1 < len(lines) else ""
            )
            key = (_repo_path(f.path), f.rule, context)
            idx = seen.get(key, 0)
            seen[key] = idx + 1
            out.append((*key, idx))
        return out

    def split(
        self, findings: list[Finding], sources: dict[str, str]
    ) -> tuple[list[Finding], list[Finding]]:
        """Partition into (new, baselined)."""
        new, old = [], []
        fps = self.fingerprints(findings, sources)
        for f, fp in zip(sorted(findings), fps):
            (old if fp in self.entries else new).append(f)
        return new, old

    @classmethod
    def load(cls, path: Path) -> "Baseline":
        data = json.loads(path.read_text())
        return cls(
            (e["path"], e["rule"], e["context"], int(e.get("index", 0)))
            for e in data.get("entries", ())
        )

    @staticmethod
    def reasons(path: Path) -> dict[tuple[str, str, str, int], str]:
        """The ``reason`` of each entry of a baseline file, by fingerprint
        ({} when the file is missing)."""
        if not path.is_file():
            return {}
        return {
            (e["path"], e["rule"], e["context"], int(e.get("index", 0))): e.get("reason", "")
            for e in json.loads(path.read_text()).get("entries", ())
        }

    @staticmethod
    def dump(
        findings: list[Finding], sources: dict[str, str], path: Path
    ) -> int:
        """Write the findings' fingerprints; an entry already in the file
        keeps its ``reason``."""
        kept = Baseline.reasons(path)
        entries = [
            {"path": p, "rule": r, "context": c, "index": i,
             "reason": kept.get((p, r, c, i), "")}
            for p, r, c, i in Baseline.fingerprints(findings, sources)
        ]
        path.write_text(
            json.dumps({"version": 1, "entries": entries}, indent=2) + "\n"
        )
        return len(entries)


# --------------------------------------------------------------------- config
#: The port's package and its checked-in lint baseline.
PACKAGE_DIR = Path(__file__).resolve().parent.parent
DEFAULT_BASELINE = Path(__file__).resolve().parent / "graftlint_baseline.json"


def _repo_path(path: str) -> str:
    """A file of the port's package as a path from the repository's root,
    whatever the directory the linter ran from (baseline fingerprints are
    keyed so); any other path as it is."""
    p = Path(path)
    try:
        return p.resolve().relative_to(PACKAGE_DIR.parent).as_posix()
    except (ValueError, OSError):
        return p.as_posix()


def _default_paths() -> list[str]:
    return [os.path.relpath(PACKAGE_DIR)]


@dataclass
class Config:
    """``[tool.graftlint_torch]`` from pyproject.toml (all keys optional;
    the JAX package's ``[tool.graftlint]`` is not read)."""

    paths: list[str] = field(default_factory=_default_paths)
    exclude: list[str] = field(default_factory=list)
    baseline: str = str(DEFAULT_BASELINE)
    disable: list[str] = field(default_factory=list)

    @classmethod
    def load(cls, start: Path | None = None) -> "Config":
        root = (start or Path.cwd()).resolve()
        for d in [root, *root.parents]:
            pp = d / "pyproject.toml"
            if pp.is_file():
                return cls.from_table(_read_tool_table(pp))
        return cls()

    @classmethod
    def from_table(cls, table: dict[str, Any]) -> "Config":
        cfg = cls()
        for key in ("paths", "exclude", "disable"):
            val = table.get(key)
            if isinstance(val, list):
                setattr(cfg, key, [str(v) for v in val])
        if isinstance(table.get("baseline"), str):
            cfg.baseline = table["baseline"]
        return cfg


def _read_tool_table(pyproject: Path) -> dict[str, Any]:
    text = pyproject.read_text()
    try:
        import tomllib  # py >= 3.11

        return tomllib.loads(text).get("tool", {}).get("graftlint_torch", {})
    except ModuleNotFoundError:
        return _mini_toml_section(text, "tool.graftlint_torch")


def _mini_toml_section(text: str, section: str) -> dict[str, Any]:
    """Fallback TOML-subset reader for py3.10 (no tomllib): single-line
    ``key = value`` pairs inside ``[section]``, values limited to
    strings, numbers, booleans and flat arrays thereof — which is all
    our own config section uses."""
    out: dict[str, Any] = {}
    in_section = False
    for raw in text.splitlines():
        line = raw.strip()
        if not line or line.startswith("#"):
            continue
        if line.startswith("["):
            in_section = line == f"[{section}]"
            continue
        if not in_section or "=" not in line:
            continue
        key, _, value = line.partition("=")
        value = value.strip()
        value = re.sub(r"\btrue\b", "True", re.sub(r"\bfalse\b", "False", value))
        try:
            out[key.strip()] = ast.literal_eval(value)
        except (ValueError, SyntaxError):
            continue
    return out
