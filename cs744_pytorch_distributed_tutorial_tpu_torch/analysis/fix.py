"""graftlint --fix: safe automatic fixes (the JAX package's
``analysis/fix.py``, verbatim but for the imports).

Only GL008 (dead-import) is auto-fixable today. The fixer re-lints after
every splice and loops to a fixpoint, so removing ``import a.b`` that was
the sole user of ``import a`` removes both. Constraints that keep the
fix safe:

* only imports directly at module top level are touched — an import
  nested in a ``try`` block may be the block's only statement, and
  deleting it would leave invalid syntax (and such imports are usually
  optional-dependency probes anyway);
* suppressed findings (``# graftlint: disable=GL008``) are left alone;
* partially-dead imports (``from x import a, b`` with only ``a`` dead)
  are rebuilt with the surviving aliases rather than deleted.
"""

from __future__ import annotations

import ast
from pathlib import Path

from cs744_pytorch_distributed_tutorial_tpu_torch.analysis.context import ModuleContext
from cs744_pytorch_distributed_tutorial_tpu_torch.analysis.core import Finding, Suppressions
from cs744_pytorch_distributed_tutorial_tpu_torch.analysis.rules import iter_dead_imports

_MAX_PASSES = 10


def _fix_once(src: str, path: str) -> tuple[str, int]:
    """One removal pass. Returns (new_source, aliases_removed)."""
    try:
        tree = ast.parse(src)
    except SyntaxError:
        return src, 0
    ctx = ModuleContext(path=path, src=src, tree=tree)
    suppressions = Suppressions(src)
    top_level = {id(s) for s in tree.body}

    # Group dead aliases per import statement so a statement is spliced
    # exactly once whether one alias or all of them are dead.
    dead_by_stmt: dict[int, tuple[ast.stmt, list[ast.alias]]] = {}
    for stmt, alias, bound in iter_dead_imports(ctx):
        if id(stmt) not in top_level:
            continue
        probe = Finding(
            path=path,
            line=stmt.lineno,
            col=stmt.col_offset + 1,
            rule="GL008",
            name="dead-import",
            message=bound,
        )
        if suppressions.is_suppressed(probe):
            continue
        dead_by_stmt.setdefault(id(stmt), (stmt, []))[1].append(alias)

    if not dead_by_stmt:
        return src, 0

    lines = src.splitlines(keepends=True)
    removed = 0
    # Splice bottom-up so earlier statements' line numbers stay valid.
    for stmt, aliases in sorted(
        dead_by_stmt.values(), key=lambda p: -p[0].lineno
    ):
        end = stmt.end_lineno or stmt.lineno
        if len(aliases) == len(stmt.names):
            lines[stmt.lineno - 1 : end] = []
        else:
            survivors = [a for a in stmt.names if a not in aliases]
            if isinstance(stmt, ast.ImportFrom):
                rebuilt: ast.stmt = ast.ImportFrom(
                    module=stmt.module, names=survivors, level=stmt.level
                )
            else:
                rebuilt = ast.Import(names=survivors)
            first = lines[stmt.lineno - 1]
            indent = first[: len(first) - len(first.lstrip())]
            lines[stmt.lineno - 1 : end] = [indent + ast.unparse(rebuilt) + "\n"]
        removed += len(aliases)
    return "".join(lines), removed


def fix_source(src: str, path: str = "<fix>") -> tuple[str, int]:
    """Remove dead imports from ``src`` until none remain.

    Returns ``(new_source, total_aliases_removed)``. Idempotent: running
    the result through again removes nothing.
    """
    total = 0
    for _ in range(_MAX_PASSES):
        src, removed = _fix_once(src, path)
        if not removed:
            break
        total += removed
    return src, total


def fix_paths(
    paths: list[str | Path], *, exclude: tuple[str, ...] = ()
) -> tuple[int, int]:
    """Fix every Python file under ``paths`` in place.

    Returns ``(files_changed, aliases_removed)``.
    """
    from cs744_pytorch_distributed_tutorial_tpu_torch.analysis.engine import iter_py_files

    files_changed = 0
    total_removed = 0
    for file in iter_py_files(paths, exclude):
        try:
            src = file.read_text()
        except OSError:
            continue
        new_src, removed = fix_source(src, str(file))
        if removed:
            file.write_text(new_src)
            files_changed += 1
            total_removed += removed
    return files_changed, total_removed
