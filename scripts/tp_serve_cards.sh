#!/bin/bash
# GPT-2-small served on the 4 cards of one host at tensor 4 (one process a
# card, NCCL), against tensor 1 (decode_model on card 0): the serving
# trace (64 Poisson requests at 64 rps, prompts and outputs 64-256, 16
# slots, 513 pages of 16, bf16) through run_poisson with its warm-up,
# each rank with its own pools of its KV heads (scripts/tp_serve_ranks.py
# --mode cards). Prints the card's name and power limit; for each tensor
# size tokens/s, TTFT p50/p99, ITL p99, a decode step's host wall and
# device ms a rank (NCCL's kernels apart), each rank's paged launches and
# its host collectives apart (the replay's agreements a step and the ms
# of one, the ms of one NCCL sum of a step's activations); the share of
# greedy tokens tensor 4 shares with tensor 1.
#
#   bash scripts/tp_serve_cards.sh [output dir, default tp_serve_out]
#
# Exits nonzero if a run failed, the ranks' streams differ, or a rank's
# paged launches are not 2 x 12 a decode step.
set -u
nvidia-smi --query-gpu=name,power.limit --format=csv,noheader
OUT=${1:-tp_serve_out}
HERE=$(dirname "$0")
mkdir -p "$OUT/tensor4" "$OUT/tensor1"
port=29650
failed=0
pids=()
for r in 0 1 2 3; do
  timeout 600 python "$HERE/tp_serve_ranks.py" --mode cards --rank $r --world 4 --port $port \
    --out "$OUT/tensor4" > "$OUT/tensor4.r$r.log" 2>&1 &
  pids+=($!)
done
for pid in "${pids[@]}"; do
  wait "$pid" || failed=1
done
timeout 600 python "$HERE/tp_serve_ranks.py" --mode cards --out "$OUT/tensor1" \
  > "$OUT/tensor1.r0.log" 2>&1 || failed=1
grep -h -i "error\|Traceback" "$OUT"/tensor*.log | head -5
OUT="$OUT" FAILED=$failed python - <<'PY'
import json
import os
import sys

import torch

out = os.environ["OUT"]
ok = os.environ["FAILED"] == "0"
runs = {}
for name, world in (("tensor4", 4), ("tensor1", 1)):
    paths = [os.path.join(out, name, f"rank{r}.pt") for r in range(world)]
    if not all(os.path.exists(p) for p in paths):
        print(name, "missing rank results")
        ok = False
        continue
    ranks = [torch.load(p, weights_only=False) for p in paths]
    runs[name] = ranks
    s = ranks[0]["summary"]
    print(name, json.dumps({k: s.get(k) for k in (
        "tokens_per_sec", "ttft_p50_ms", "ttft_p99_ms", "itl_p99_ms", "decode_ms_per_step",
        "decode_steps", "completed", "makespan_s")}))
    for r, res in enumerate(ranks):
        want = 2 * 12 * res["decode_steps_all"]
        good = res["launches"] == want
        print(f"{name} rank {r}: paged launches {res['launches']} (expected {want}), "
              f"decode step {json.dumps(res['step'])}, host collectives "
              f"{json.dumps(res['host_collectives'])}, {res['card']}")
        ok = ok and good
        if res["streams"] != ranks[0]["streams"]:
            print(f"{name} rank {r}: streams differ from rank 0's")
            ok = False
if len(runs) == 2:
    a, b = runs["tensor4"][0]["streams"], runs["tensor1"][0]["streams"]
    same = sum(x == y for s, t in zip(a, b) for x, y in zip(s, t))
    total = sum(len(t) for t in b)
    print(f"greedy tokens tensor 4 shares with tensor 1: {same} of {total} "
          f"({100 * same / max(1, total):.2f} %)")
sys.exit(0 if ok else 1)
PY
