"""Render telemetry artifacts from the command line.

    python -m cs744_pytorch_distributed_tutorial_tpu_torch.obs report <metrics_dir>

``report`` reads a metrics dir (or a metrics.jsonl / phase_report.json
directly), keeps the phase profiler's ``kind="phase"`` and
``"phase_summary"`` records, and prints the per-phase table: the renderer
``bench.py --phase-breakdown`` prints live, usable after the fact on any
machine the records landed on. The JAX package's ``serve-report`` (the
serving tracer) and ``fleet-report`` (the multi-process timeline) exit
"not yet ported".
"""

from __future__ import annotations

import argparse
import json
import os
import sys

from cs744_pytorch_distributed_tutorial_tpu_torch.obs.metrics import METRICS_NAME
from cs744_pytorch_distributed_tutorial_tpu_torch.obs.phases import (
    phase_records_from_stream,
    render_phase_table,
)

_NOT_YET_PORTED = {
    "serve-report": "serve-report needs the serving tracer (obs/serve_trace.py)",
    "fleet-report": "fleet-report needs the fleet view (obs/fleet.py)",
}


def _load_stream(path: str) -> list[dict]:
    """metrics dir, JSONL stream, or a phase_report.json array."""
    if os.path.isdir(path):
        for name in (METRICS_NAME, "phase_report.json"):
            candidate = os.path.join(path, name)
            if os.path.exists(candidate):
                path = candidate
                break
        else:
            raise FileNotFoundError(f"{path}: no {METRICS_NAME} or phase_report.json")
    with open(path, encoding="utf-8") as f:
        text = f.read()
    try:
        obj = json.loads(text)
        if isinstance(obj, list):
            return [r for r in obj if isinstance(r, dict)]
        if isinstance(obj, dict):
            return [obj]
    except json.JSONDecodeError:
        pass
    records = []
    for line in text.splitlines():
        line = line.strip()
        if not line:
            continue
        try:
            rec = json.loads(line)
        except json.JSONDecodeError:
            continue
        if isinstance(rec, dict):
            records.append(rec)
    return records


def main(argv: list[str] | None = None) -> int:
    p = argparse.ArgumentParser(
        prog="python -m cs744_pytorch_distributed_tutorial_tpu_torch.obs",
        description=__doc__,
    )
    sub = p.add_subparsers(dest="cmd", required=True)
    rep = sub.add_parser("report", help="render phase records as a table")
    rep.add_argument("path", help="metrics dir, metrics.jsonl, or phase_report.json")
    for cmd in _NOT_YET_PORTED:
        unported = sub.add_parser(cmd, help="not yet ported")
        unported.add_argument("args", nargs=argparse.REMAINDER)
    args = p.parse_args(argv)
    if args.cmd in _NOT_YET_PORTED:
        raise SystemExit(f"obs: {_NOT_YET_PORTED[args.cmd]}, which is not yet ported")

    records = phase_records_from_stream(_load_stream(args.path))
    if not records:
        print("no phase records found (run bench.py --phase-breakdown with --metrics-dir "
              "first)", file=sys.stderr)
        return 1
    print(render_phase_table(records))
    return 0


if __name__ == "__main__":
    sys.exit(main())
