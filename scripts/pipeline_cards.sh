#!/bin/bash
# GPT-2-small (12 layers, d 768, T 1024, bf16, flash, AdamW; batch 8 in 4
# microbatches) pipelined over the 4 cards of one host, one process a
# stage, NCCL's P2P between the cards: the one-card pipe-1 run first,
# then 8 steps on each schedule (GPipe, 1F1B with the distributed tail,
# interleaved V 3) from the same weights, then
# scripts/pipeline_cards.py's report: each schedule's losses held
# against the pipe-1 run within the bf16 bound, its median step ms, each
# stage's idle share beside the schedule's bubble fraction, and the NCCL
# and exposed P2P ms a step.
#
#   bash scripts/pipeline_cards.sh [output dir, default pipeline_cards_out]
#
# Exits nonzero if a run failed or a loss is out of bounds.
set -u
nvidia-smi --query-gpu=name,power.limit --format=csv,noheader
OUT=${1:-pipeline_cards_out}
mkdir -p "$OUT"
failed=0
timeout 300 python scripts/pipeline_cards.py reference "$OUT" > "$OUT/reference.log" 2>&1 \
  || { failed=1; tail -5 "$OUT/reference.log"; }
port=29650
for schedule in gpipe 1f1b interleaved; do
  port=$((port + 1))
  pids=()
  for r in 0 1 2 3; do
    timeout 400 python scripts/pipeline_cards.py rank "$schedule" "$r" "$port" "$OUT" \
      > "$OUT/$schedule.r$r.log" 2>&1 &
    pids+=($!)
  done
  for pid in "${pids[@]}"; do
    wait "$pid" || failed=1
  done
  grep -h -i "error\|Traceback" "$OUT"/$schedule.r*.log | head -5
done
python scripts/pipeline_cards.py report "$OUT" || failed=1
exit $failed
