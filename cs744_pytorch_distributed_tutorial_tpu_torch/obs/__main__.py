"""Render telemetry artifacts from the command line.

    python -m cs744_pytorch_distributed_tutorial_tpu_torch.obs report <metrics_dir>
    python -m cs744_pytorch_distributed_tutorial_tpu_torch.obs serve-report <trace_dir> --check
    python -m cs744_pytorch_distributed_tutorial_tpu_torch.obs fleet-report <store_dir> \
        [--check] [--no-artifacts]

``report`` reads a metrics dir (or a metrics.jsonl / phase_report.json
directly), keeps the phase profiler's ``kind="phase"`` and
``"phase_summary"`` records, and prints the per-phase table: the renderer
``bench.py --phase-breakdown`` prints live, usable after the fact on any
machine the records landed on. ``serve-report`` summarizes a trace dir
that ``serve_cli --trace-dir`` wrote (or a bare ``serve_spans.jsonl``);
with ``--check`` it exits 1 on orphan, unclosed or overlapping spans or
on TTFT drift (``obs/serve_trace.py::check_spans``, ``reconcile``).
``fleet-report`` merges what a multi-process elastic run left in its
rendezvous store (``launch.py --store``: stamp and metrics streams,
``events.jsonl``, heartbeat, death-note and world files) into one
clock-aligned view (``obs/fleet.py``): it prints the report (generations,
incidents, collective skew), writes ``fleet_trace.json`` and
``fleet_report.json`` into the store, and with ``--check`` exits 1 on an
incident-consistency problem.
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
    srv = sub.add_parser("serve-report", help="summarize a serve trace dir")
    srv.add_argument("path", help="trace dir written by serve_cli --trace-dir, or a "
                                  "serve_spans.jsonl")
    srv.add_argument("--check", action="store_true",
                     help="exit 1 on orphan/unclosed/overlapping spans or TTFT "
                          "reconciliation drift")
    flt = sub.add_parser("fleet-report",
                         help="merge a multi-process run dir into one timeline + audit")
    flt.add_argument("path", help="rendezvous store dir (launch.py --store)")
    flt.add_argument("--check", action="store_true",
                     help="exit 1 on incident-consistency problems (unpaired deaths, "
                          "orphan generations, seal-crossing spans)")
    flt.add_argument("--no-artifacts", action="store_true",
                     help="print the report only; skip writing fleet_trace.json / "
                          "fleet_report.json")
    args = p.parse_args(argv)

    if args.cmd == "fleet-report":
        from cs744_pytorch_distributed_tutorial_tpu_torch.obs.fleet import (
            ClockAligner,
            collective_skew,
            fleet_check,
            load_fleet_dir,
            render_fleet_report,
            write_fleet_artifacts,
        )

        if args.no_artifacts:
            data = load_fleet_dir(args.path)
            aligner = ClockAligner(data.barrier_stamps)
            skew = collective_skew(data, aligner)
            problems = fleet_check(data, aligner)
            print(render_fleet_report(data, skew, problems, aligner))
        else:
            result = write_fleet_artifacts(args.path)
            problems = result["problems"]
            print(result["text"])
            print(f"fleet-report: wrote {result['trace']}")
        if args.check:
            if problems:
                for prob in problems:
                    print(f"fleet check: {prob}", file=sys.stderr)
                return 1
            print("fleet check: OK")
        return 0

    if args.cmd == "serve-report":
        from cs744_pytorch_distributed_tutorial_tpu_torch.obs.serve_trace import (
            check_spans,
            load_trace_dir,
            reconcile,
            render_serve_report,
        )

        data = load_trace_dir(args.path)
        print(render_serve_report(data))
        if args.check:
            problems = check_spans(data["spans"]) + reconcile(data["spans"], data["requests"])
            if problems:
                for prob in problems:
                    print(f"serve-trace check: {prob}", file=sys.stderr)
                return 1
            print(f"serve-trace check: OK ({len(data['spans'])} spans, "
                  f"{len(data['requests'])} requests)")
        return 0

    records = phase_records_from_stream(_load_stream(args.path))
    if not records:
        print("no phase records found (run bench.py --phase-breakdown with --metrics-dir "
              "first)", file=sys.stderr)
        return 1
    print(render_phase_table(records))
    return 0


if __name__ == "__main__":
    sys.exit(main())
