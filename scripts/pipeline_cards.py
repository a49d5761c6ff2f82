"""GPT-2-small through the pipe axis on the cards of one host: the
worker and the reader of ``scripts/pipeline_cards.sh``.

    python scripts/pipeline_cards.py reference OUT
    python scripts/pipeline_cards.py rank SCHEDULE RANK PORT OUT
    python scripts/pipeline_cards.py report OUT

``reference``: the one-card pipe-1 run (``PipelineLMTrainer`` at
``pipeline_parallel=1`` on card 0, no process group). ``rank``: one
stage of pipe 4 over NCCL's P2P (``--coordinator``-style rendezvous at
``localhost:PORT``, card ``RANK``). Both train GPT-2-small (12 layers, d
768, 12 heads, d_ff 3072, vocab 50304, T 1024, RoPE, bf16, flash, AdamW)
from ``init_params(0)`` on the same ``STEPS`` batches of 8 sequences, 4
microbatches of 2, each step timed on the host around a loss fetch (a
device synchronise); then ``PROFILED`` more steps under ``torch.profiler``:
the stage's compute kernels a step (``compute``: every kernel but NCCL's),
the span of all its kernels, the idle share ``1 - compute / span`` (the
share of the step its card runs no compute: the bubble, the waits on
its neighbours and the host's gaps), the NCCL kernels' time (NCCL's P2P
kernels spin until the peer posts its half, so this is transfer plus
wait) and the part of it no compute kernel overlaps (``p2p_exposed``).
Each writes ``OUT/<run>.json``.

``report`` holds every schedule's losses against the reference within
``LOSS_RTOL`` (the bf16 bound of ``chip_smoke.py``'s flash phase) and
prints a table: median step ms (steps 2+), each stage's idle share
beside the schedule's bubble ``(S-1)/(M+S-1)`` (``(S-1)/(V M+S-1)``
interleaved), the NCCL ms and exposed P2P ms a step; exit 1 when a run is
missing or a loss is out of bounds.
"""

from __future__ import annotations

import json
import os
import statistics
import sys
import time

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

WIDTH = dict(num_layers=12, d_model=768, num_heads=12, d_ff=3072, vocab_size=50304,
             max_seq_len=1024, seq_len=1024)
STAGES, MICROBATCHES, BATCH, STEPS, PROFILED = 4, 4, 8, 8, 2
SCHEDULES = {"gpipe": {}, "1f1b": {}, "interleaved": {"num_virtual_stages": 3}}
LOSS_RTOL = 2e-2


def _config(schedule: str, pipe: int):
    from cs744_pytorch_distributed_tutorial_tpu_torch.parallel.pipeline import PipelineLMConfig

    return PipelineLMConfig(**WIDTH, pipeline_parallel=pipe, num_microbatches=MICROBATCHES,
                            global_batch_size=BATCH, schedule=schedule, attention_impl="flash",
                            use_rope=True, compute_dtype="bfloat16", optimizer="adamw",
                            device="cuda", **SCHEDULES.get(schedule, {}))


def _union(intervals: list[tuple[float, float]]) -> list[tuple[float, float]]:
    out: list[tuple[float, float]] = []
    for a, b in sorted(intervals):
        if out and a <= out[-1][1]:
            out[-1] = (out[-1][0], max(out[-1][1], b))
        else:
            out.append((a, b))
    return out


def _length(intervals) -> float:
    return sum(b - a for a, b in intervals)


def _minus(a_set, b_set) -> float:
    """The length of ``a_set`` not covered by ``b_set`` (both unions)."""
    total = 0.0
    for a, b in a_set:
        covered = sum(max(0.0, min(b, d) - max(a, c)) for c, d in b_set)
        total += (b - a) - covered
    return total


def _train(tr, toks) -> dict:
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    losses, ms = [], []
    batches = [tr.split_batch(toks[k * BATCH:(k + 1) * BATCH]) for k in range(STEPS)]
    for x, y in batches:
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        losses.append(float(tr.train_step(x, y)["loss"]))
        ms.append((time.perf_counter() - t0) * 1e3)
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for k in range(PROFILED):
            tr.train_step(*batches[k])
        torch.cuda.synchronize()
    kernels = [e for e in prof.events() if e.device_type == DeviceType.CUDA
               and not getattr(e, "is_user_annotation", False)]
    spans = [(e.time_range.start / 1e3, e.time_range.end / 1e3) for e in kernels]
    nccl = _union([s for s, e in zip(spans, kernels) if "nccl" in e.name.lower()])
    compute = _union([s for s, e in zip(spans, kernels) if "nccl" not in e.name.lower()])
    everything = _union(spans)
    span = (everything[-1][1] - everything[0][0]) if everything else 0.0
    return {
        "losses": losses, "step_ms": ms, "device": torch.cuda.get_device_name(),
        "compute_ms": _length(compute) / PROFILED if spans else None,
        "span_ms": span / PROFILED if spans else None,
        "idle_share": 1 - _length(compute) / span if span else None,
        "nccl_ms": _length(nccl) / PROFILED if spans else None,
        "p2p_exposed_ms": _minus(nccl, compute) / PROFILED if spans else None,
    }


def reference(out: str) -> None:
    import torch

    from cs744_pytorch_distributed_tutorial_tpu_torch.data import synthetic_tokens
    from cs744_pytorch_distributed_tutorial_tpu_torch.parallel.pipeline import PipelineLMTrainer

    torch.cuda.set_device(0)
    tr = PipelineLMTrainer(_config("gpipe", 1))
    tr.init(seed=0)
    toks = synthetic_tokens(STEPS * BATCH, WIDTH["seq_len"], WIDTH["vocab_size"], seed=23)
    _write(out, "reference", _train(tr, toks))


def rank(schedule: str, r: int, port: int, out: str) -> None:
    import torch

    from cs744_pytorch_distributed_tutorial_tpu_torch.data import synthetic_tokens
    from cs744_pytorch_distributed_tutorial_tpu_torch.parallel import mesh
    from cs744_pytorch_distributed_tutorial_tpu_torch.parallel.pipeline import PipelineLMTrainer

    mesh.initialize(f"localhost:{port}", STAGES, r, device=torch.device("cuda", r))
    try:
        tr = PipelineLMTrainer(_config(schedule, STAGES))
        tr.init(seed=0)
        toks = synthetic_tokens(STEPS * BATCH, WIDTH["seq_len"], WIDTH["vocab_size"], seed=23)
        _write(out, f"{schedule}_r{r}", dict(_train(tr, toks), stage=tr.stage))
    finally:
        mesh.shutdown()


def _write(out: str, name: str, record: dict) -> None:
    os.makedirs(out, exist_ok=True)
    with open(os.path.join(out, f"{name}.json"), "w") as f:
        json.dump(record, f)


def report(out: str) -> int:
    def load(name):
        path = os.path.join(out, f"{name}.json")
        return json.load(open(path)) if os.path.exists(path) else None

    ref = load("reference")
    if ref is None:
        print("no reference run")
        return 1
    ok = True
    print(f"pipe-1 reference on {ref['device']}: losses {ref['losses']}, step ms (median of "
          f"steps 2+) {statistics.median(ref['step_ms'][1:]):.2f}, compute "
          f"{ref['compute_ms']:.2f} ms a step, idle {ref['idle_share']:.4f}")
    summary = {"reference": {"step_ms": statistics.median(ref["step_ms"][1:]),
                             "compute_ms": ref["compute_ms"], "idle_share": ref["idle_share"]}}
    for schedule, kw in SCHEDULES.items():
        v = kw.get("num_virtual_stages", 1)
        m = MICROBATCHES * (v if schedule == "interleaved" else 1)
        bubble = (STAGES - 1) / (m + STAGES - 1)
        ranks = [load(f"{schedule}_r{r}") for r in range(STAGES)]
        if any(x is None for x in ranks):
            print(f"{schedule}: a rank wrote nothing")
            ok = False
            continue
        losses = ranks[-1]["losses"]
        gaps = [max(abs(a - b) / abs(b) for a in (x["losses"][k] for x in ranks))
                for k, b in enumerate(ref["losses"])]
        good = len(losses) == len(ref["losses"]) and max(gaps) <= LOSS_RTOL
        ok &= good
        step = statistics.median(max(x["step_ms"][k] for x in ranks)
                                 for k in range(1, STEPS))
        rows = {x["stage"]: x for x in ranks}
        print(f"{schedule}: losses {losses} (largest relative gap {max(gaps):.3e}, bound "
              f"{LOSS_RTOL}{'' if good else ', FAILED'}); step ms (median of steps 2+, the "
              f"slowest stage) {step:.2f}; bubble {bubble:.4f}")
        for s in sorted(rows):
            x = rows[s]
            print(f"  stage {s}: idle {x['idle_share']:.4f}, compute {x['compute_ms']:.2f} ms of "
                  f"a {x['span_ms']:.2f} ms span a step, NCCL {x['nccl_ms']:.3f} ms, P2P exposed "
                  f"{x['p2p_exposed_ms']:.3f} ms, host step ms (median of steps 2+) "
                  f"{statistics.median(x['step_ms'][1:]):.2f}")
        summary[schedule] = {"step_ms": step, "bubble": bubble, "gaps": gaps,
                             "stages": {s: {k: rows[s][k] for k in ("idle_share", "compute_ms",
                                                                     "span_ms", "nccl_ms",
                                                                     "p2p_exposed_ms")}
                                        for s in sorted(rows)}}
    print(json.dumps(summary))
    return 0 if ok else 1


if __name__ == "__main__":
    cmd, args = sys.argv[1], sys.argv[2:]
    if cmd == "reference":
        reference(args[0])
    elif cmd == "rank":
        rank(args[0], int(args[1]), int(args[2]), args[3])
    elif cmd == "report":
        sys.exit(report(args[0]))
    else:
        sys.exit(f"unknown command {cmd!r}: reference | rank | report")
