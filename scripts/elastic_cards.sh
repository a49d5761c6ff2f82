#!/bin/bash
# The elastic launcher on the 4 cards of one host (one worker a card,
# NCCL: --platform inherit), the demo worker twice: rank 2 SIGKILLed at
# step 4, then the coordinator (rank 0) SIGKILLed at step 4 with rank 1 a
# 200 ms straggler; and an uninterrupted run on 3 cards. For each kill run
# scripts/elastic_report.py prints what ended each survivor (the
# collective watchdog's exit code 17, a SIGABRT from torch's NCCL
# watchdog, an exception, or the supervisor's teardown) and after how many
# seconds, the re-exec to the first resumed step, fleet_check's problems,
# the skew report's straggler, and the stitched losses against the 3-card
# run. Prints the card's name and power limit first.
#
#   bash scripts/elastic_cards.sh [output dir, default elastic_cards_out]
#
# Exits nonzero if a run failed, the fleet audit found a problem, or the
# resumed losses miss the uninterrupted run's at rtol 1e-6.
set -u
nvidia-smi --query-gpu=name,power.limit --format=csv,noheader
OUT=${1:-elastic_cards_out}
HERE=$(dirname "$0")
mkdir -p "$OUT"
python -c 'import sys, torch; print(sys.version.split()[0], torch.__version__, torch.version.cuda, "NCCL", torch.cuda.nccl.version())'
failed=0
run() {
  local name=$1
  shift
  rm -rf "$OUT/$name"
  local t0=$(date +%s.%N)
  timeout 400 python -m cs744_pytorch_distributed_tutorial_tpu_torch.launch --platform inherit \
    --store "$OUT/$name" --steps 8 "$@" > "$OUT/$name.log" 2>&1
  local rc=$?
  [ $rc -eq 0 ] || failed=1
  echo "$name: exit $rc, $(python -c "import time; print(round(time.time() - $t0, 1))") s"
  grep -h "generation .*exit codes\|completed after\|FAILED" "$OUT/$name.log"
}
run clean --nprocs 3
run kill_rank2 --nprocs 4 --kill 4:2
run kill_coordinator --nprocs 4 --kill 4:0 --slow 1:200
OUT="$OUT" FAILED=$failed python - <<'PY'
import importlib.util
import json
import os

out = os.environ["OUT"]
spec = importlib.util.spec_from_file_location("elastic_report", "scripts/elastic_report.py")
report = importlib.util.module_from_spec(spec)
spec.loader.exec_module(report)
ok = os.environ["FAILED"] == "0"
summary = {}
for name, straggler, coordinator in (("kill_rank2", None, 0), ("kill_coordinator", 1, 1)):
    try:
        rep = report.summarize(os.path.join(out, name), os.path.join(out, "clean"))
    except Exception as e:  # a run that left no store
        print(name, "no report:", repr(e))
        ok = False
        continue
    summary[name] = rep
    print(name, json.dumps({k: rep[k] for k in (
        "generations", "worlds", "coordinators", "fleet_check", "stragglers", "straggler",
        "max_skew_ms", "max_rel_gap_vs_clean", "same_steps_as_clean")}))
    for inc in rep["incidents"]:
        print(name, "incident", json.dumps(inc))
    good = (rep["fleet_check"] == [] and rep["same_steps_as_clean"]
            and rep["max_rel_gap_vs_clean"] is not None and rep["max_rel_gap_vs_clean"] <= 1e-6
            and rep["coordinators"].get(1) == coordinator
            and (straggler is None or rep["straggler"] == straggler))
    print(name, "OK" if good else "FAILED")
    ok = ok and good
with open(os.path.join(out, "report.json"), "w") as f:
    json.dump(summary, f, indent=1, default=str)
raise SystemExit(0 if ok else 1)
PY
