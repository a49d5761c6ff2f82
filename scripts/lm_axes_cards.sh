#!/bin/bash
# GPT-2-small (T 4096, global batch 4, bf16, flash, the fused
# cross-entropy, 8 steps) trained through lm_cli on the 4 cards of one
# host, one process a card (NCCL), on each of six layouts of the data,
# sequence and tensor axes in turn; then each layout's median step time
# (steps 2-8), its losses from the metric stream, and the flash kernels'
# launches by route summed over the ranks, held against what the layout
# must launch: none on FFMA, and on the tensor cores, for each of the
# forward, dq and dk/dv kernels, layers x steps x 10 under ring_flash
# (each rank's unmasked hops, n(n+1)/2 at n = 4, causal) and layers x
# steps x 4 under the other flash layouts (one call a layer a rank).
#
#   bash scripts/lm_axes_cards.sh [output dir, default lm_axes_out]
#
# Each layout writes its ranks' stdout and rank 0's metrics.jsonl under
# the output dir. Exits nonzero if a layout's run failed or a launch
# count differs.
set -u
nvidia-smi --query-gpu=name,power.limit --format=csv,noheader
OUT=${1:-lm_axes_out}
LAYERS=12
STEPS=8
COMMON="--num-layers $LAYERS --d-model 768 --num-heads 12 --d-ff 3072 --vocab-size 50304
  --max-seq-len 4096 --seq-len 4096 --global-batch-size 4 --use-rope --compute-dtype bfloat16
  --fused-xent --steps $STEPS --num-seqs 16 --json --metrics-dir"
# lm_cli's main, then this rank's flash launches by kernel and route.
COUNTED='
import json, sys
from cs744_pytorch_distributed_tutorial_tpu_torch import lm_cli
from cs744_pytorch_distributed_tutorial_tpu_torch.ops import flash_attention as A
rc = lm_cli.main(sys.argv[1:])
print("flash launches " + json.dumps({f"{k}_{r}": A.launch_count(k, route=r)
                                      for k in ("fwd", "dq", "dkv") for r in ("tc", "ffma")}))
sys.exit(rc)'
mkdir -p "$OUT"
port=29600
failed=0
run() {
  name=$1; shift
  port=$((port + 1))
  pids=()
  for r in 0 1 2 3; do
    timeout 400 python -c "$COUNTED" $COMMON "$OUT/$name" \
      "$@" --coordinator localhost:$port --num-processes 4 --process-id $r \
      > "$OUT/$name.r$r.log" 2>&1 &
    pids+=($!)
  done
  for pid in "${pids[@]}"; do
    wait "$pid" || failed=1
  done
  echo "== $name"; grep -h '^{' "$OUT/$name.r0.log" | tail -n 1 | cut -c1-400
  grep -h -i "error\|Traceback" "$OUT"/$name.r*.log | head -5
}
run data4_flash --data-parallel 4 --attention-impl flash
run seq4_ring_flash --seq-parallel 4 --attention-impl ring_flash
run seq4_ulysses_flash --seq-parallel 4 --attention-impl ulysses_flash
run seq4_ring --seq-parallel 4 --attention-impl ring
run tensor4_flash --tensor-parallel 4 --attention-impl flash
run data2_tensor2_flash_zero1 --data-parallel 2 --tensor-parallel 2 --attention-impl flash --zero1
OUT="$OUT" LAYERS=$LAYERS STEPS=$STEPS FAILED=$failed python - <<'PY'
import glob
import json
import os
import statistics
import sys

out, layers, steps = os.environ["OUT"], int(os.environ["LAYERS"]), int(os.environ["STEPS"])
calls = {"seq4_ring_flash": 10, "seq4_ring": 0}  # flash calls a layer, over the ranks
ok = os.environ["FAILED"] == "0"
for d in sorted(glob.glob(os.path.join(out, "*/"))):
    name = os.path.basename(d.rstrip("/"))
    if not os.path.exists(os.path.join(d, "metrics.jsonl")):
        print(name, "no metric stream")
        ok = False
        continue
    recs = [json.loads(line) for line in open(os.path.join(d, "metrics.jsonl"))]
    steps_run = [r for r in recs if r["kind"] == "step"]
    times = [r["step_time_s"] for r in steps_run if r.get("step_time_s")]
    print(name, "step_s median of steps 2+:",
          statistics.median(times[1:]) if len(times) > 1 else times,
          "losses", [round(r["loss"], 5) for r in steps_run])
    got = {}
    for r in range(4):
        lines = [line for line in open(os.path.join(out, f"{name}.r{r}.log"))
                 if line.startswith("flash launches ")] or ["flash launches {}"]
        for key, n in json.loads(lines[-1][len("flash launches "):]).items():
            got[key] = got.get(key, 0) + n
    tc = layers * steps * calls.get(name, 4)
    want = {f"{k}_{r}": tc if r == "tc" else 0
            for k in ("fwd", "dq", "dkv") for r in ("tc", "ffma")}
    print(name, "flash launches over the ranks:", json.dumps(got),
          "as expected" if got == want else f"EXPECTED {json.dumps(want)}")
    ok = ok and got == want
sys.exit(0 if ok else 1)
PY
