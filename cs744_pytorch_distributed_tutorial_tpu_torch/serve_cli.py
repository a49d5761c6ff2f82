"""CLI for the continuous-batching serving engine (``serve/``).

Runs the Poisson load benchmark against a paged-KV ``ServingEngine``
and, on request, the batch-at-a-time baseline at the same KV memory,
writing ``kind:"serve"`` and ``kind:"serve_summary"`` records to stdout
and ``--metrics-dir``:

    # GPT-2-small width, bf16, 16 slots over a 513-page pool:
    python -m cs744_pytorch_distributed_tutorial_tpu_torch.serve_cli \\
        --vocab-size 50304 --num-layers 12 --d-model 768 --num-heads 12 \\
        --num-kv-heads 4 --d-ff 3072 --max-seq-len 1024 --use-rope \\
        --compute-dtype bfloat16 --num-slots 16 --page-size 16 \\
        --num-pages 513 --max-pages-per-slot 32 --requests 64 --rate 64 \\
        --prompt-len 64 256 --output-len 64 256

    # greedy engine output against make_generator on every prompt:
    python -m cs744_pytorch_distributed_tutorial_tpu_torch.serve_cli \\
        --requests 8 --parity-check --device cpu

The flags are the JAX package's (``serve_cli.py``) with its names and
defaults, plus ``--compute-dtype`` (the JAX CLI serves in fp32) and
``--device`` (``cuda``, the default, or ``cpu``). ``--trace-dir``,
``--window-every``, the guard flags (``--deadline-s``, ``--max-queue-s``,
``--max-queue-depth``, ``--shed-policy``, ``--degrade-floor``) and the
chaos and recovery flags (``--chaos``, ``--max-restarts``,
``--restart-backoff-s``, ``--step-timeout-s``) exit with "not yet
ported". Weights are random from ``--seed``: latency, throughput and the
parity contract do not depend on them.
"""

from __future__ import annotations

import argparse
import json
import os
import sys

# Flags of the JAX CLI whose features are not ported: name -> default.
_NOT_YET_PORTED = {
    "trace_dir": None, "window_every": None, "deadline_s": None, "max_queue_s": None,
    "max_queue_depth": None, "shed_policy": None, "degrade_floor": 8, "chaos": None,
    "max_restarts": 2, "restart_backoff_s": 0.0, "step_timeout_s": None,
}


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(
        prog="cs744-torch-serve",
        description="Continuous-batching LM serving on PyTorch/CUDA: Poisson load benchmark",
    )
    # model (a decode TransformerLM, random weights)
    p.add_argument("--vocab-size", type=int, default=256)
    p.add_argument("--num-layers", type=int, default=4)
    p.add_argument("--num-heads", type=int, default=8)
    p.add_argument("--num-kv-heads", type=int, default=None)
    p.add_argument("--d-model", type=int, default=256)
    p.add_argument("--d-ff", type=int, default=1024)
    p.add_argument("--max-seq-len", type=int, default=512)
    p.add_argument("--use-rope", action="store_true")
    p.add_argument("--quant-kv", action="store_true",
                   help="int8 KV pages with per-row scales")
    p.add_argument("--compute-dtype", default="float32", choices=["float32", "bfloat16"])
    # engine geometry
    p.add_argument("--num-slots", type=int, default=8,
                   help="decode slots B in the fixed-shape step")
    p.add_argument("--page-size", type=int, default=16, help="tokens per KV page")
    p.add_argument("--num-pages", type=int, default=64,
                   help="pool pages per layer (page 0 reserved as trash)")
    p.add_argument("--max-pages-per-slot", type=int, default=16,
                   help="page-table width P: caps one request's KV")
    p.add_argument("--paged-attention-impl", default="auto",
                   choices=("auto", "gather", "kernel"),
                   help="decode attention: the CUDA live-pages kernel (auto; on the "
                        "CPU its plain version) or the gather reference")
    # sampling
    p.add_argument("--temperature", type=float, default=0.0)
    p.add_argument("--top-k", type=int, default=None)
    p.add_argument("--top-p", type=float, default=None)
    p.add_argument("--eos-id", type=int, default=None)
    # workload
    p.add_argument("--requests", type=int, default=32)
    p.add_argument("--rate", type=float, default=16.0, help="Poisson arrival rate, requests/sec")
    p.add_argument("--prompt-len", type=int, nargs=2, default=(8, 48), metavar=("MIN", "MAX"))
    p.add_argument("--output-len", type=int, nargs=2, default=(8, 64), metavar=("MIN", "MAX"))
    p.add_argument("--seed", type=int, default=0)
    # modes
    p.add_argument("--compare-baseline", action="store_true",
                   help="also replay through batch-at-a-time generate at equal KV memory "
                        "(batch = pool tokens / max_seq_len)")
    p.add_argument("--gate", action="store_true",
                   help="exit 1 unless the engine beats the baseline on both tokens/sec "
                        "and p99 TTFT (implies --compare-baseline)")
    p.add_argument("--parity-check", action="store_true",
                   help="greedy engine output must match make_generator token for token "
                        "on every workload prompt; exit 1 on any mismatch")
    p.add_argument("--metrics-dir", default=None,
                   help="also write records to METRICS_DIR/metrics.jsonl")
    p.add_argument("--device", choices=["cuda", "cpu"], default="cuda")
    # not yet ported
    p.add_argument("--trace-dir", default=None, help="not yet ported")
    p.add_argument("--window-every", type=float, default=None, help="not yet ported")
    p.add_argument("--deadline-s", type=float, default=None, help="not yet ported")
    p.add_argument("--max-queue-s", type=float, default=None, help="not yet ported")
    p.add_argument("--max-queue-depth", type=int, default=None, help="not yet ported")
    p.add_argument("--shed-policy", default=None, choices=("reject", "degrade"),
                   help="not yet ported")
    p.add_argument("--degrade-floor", type=int, default=8, help="not yet ported")
    p.add_argument("--chaos", default=None, help="not yet ported")
    p.add_argument("--max-restarts", type=int, default=2, help="not yet ported")
    p.add_argument("--restart-backoff-s", type=float, default=0.0, help="not yet ported")
    p.add_argument("--step-timeout-s", type=float, default=None, help="not yet ported")
    return p


def _make_sink(metrics_dir: str | None):
    from cs744_pytorch_distributed_tutorial_tpu_torch.obs.sinks import (
        JsonlSink,
        MultiSink,
        StreamSink,
    )

    sinks = [StreamSink(sys.stdout)]
    if metrics_dir:
        os.makedirs(metrics_dir, exist_ok=True)
        sinks.append(JsonlSink(os.path.join(metrics_dir, "metrics.jsonl")))
    return MultiSink(sinks)


def build_model(args):
    """The decode model the flags describe: random weights from
    ``--seed``, dense attention for the prompt pass, float weights held in
    the compute dtype, on ``--device``."""
    import torch

    from cs744_pytorch_distributed_tutorial_tpu_torch.config import resolve_device
    from cs744_pytorch_distributed_tutorial_tpu_torch.models.transformer import TransformerLM

    device = resolve_device(args.device)
    model = TransformerLM(
        vocab_size=args.vocab_size, num_layers=args.num_layers, num_heads=args.num_heads,
        num_kv_heads=args.num_kv_heads, d_model=args.d_model, d_ff=args.d_ff,
        max_seq_len=args.max_seq_len, dtype=args.compute_dtype, attention_impl="dense",
        use_rope=args.use_rope, quant_kv_cache=args.quant_kv,
        generator=torch.Generator().manual_seed(args.seed),
    )
    return model.to(device).cast_for_decode_()


def main(argv: list[str] | None = None) -> int:
    args = build_parser().parse_args(argv)
    for name, default in _NOT_YET_PORTED.items():
        if getattr(args, name) != default:
            flag = "--" + name.replace("_", "-")
            raise SystemExit(f"{flag} is not yet ported to the PyTorch/CUDA package")

    import numpy as np

    from cs744_pytorch_distributed_tutorial_tpu_torch.serve import (
        Request,
        ServeConfig,
        ServingEngine,
        make_poisson_workload,
        run_batch_baseline,
        run_poisson,
    )

    model = build_model(args)
    cfg = ServeConfig(
        num_slots=args.num_slots, page_size=args.page_size, num_pages=args.num_pages,
        max_pages_per_slot=args.max_pages_per_slot, temperature=args.temperature,
        top_k=args.top_k, top_p=args.top_p, eos_id=args.eos_id, seed=args.seed,
        paged_attention_impl=args.paged_attention_impl,
    )
    workload = make_poisson_workload(
        num_requests=args.requests, rate_rps=args.rate, prompt_len=tuple(args.prompt_len),
        output_len=tuple(args.output_len), vocab_size=args.vocab_size, seed=args.seed,
    )
    sink = _make_sink(args.metrics_dir)
    failed = False
    try:
        if args.parity_check:
            from cs744_pytorch_distributed_tutorial_tpu_torch.infer import make_generator

            engine = ServingEngine(model, cfg, device=args.device)
            for i, prompt in enumerate(workload.prompts):
                engine.submit(Request(prompt=prompt,
                                      max_new_tokens=int(workload.max_new_tokens[i])))
            by_id = {r.req_id: r for r in engine.run()}
            gens: dict = {}
            mismatches = 0
            for i, prompt in enumerate(workload.prompts):
                n = int(workload.max_new_tokens[i])
                if n not in gens:
                    gens[n] = make_generator(model, max_new_tokens=n, temperature=0.0,
                                             eos_id=cfg.eos_id, device=args.device)
                ref = gens[n](prompt[None, :].astype(np.int64))[0].tolist()
                if cfg.eos_id is not None and cfg.eos_id in ref:
                    ref = ref[: ref.index(cfg.eos_id) + 1]
                mismatches += by_id[i].generated != ref
            sink.emit({"kind": "serve", "event": "parity", "requests": len(workload),
                       "mismatches": mismatches, "parity_ok": mismatches == 0})
            failed |= mismatches > 0

        engine = ServingEngine(model, cfg, device=args.device, sink=sink)
        serve_rec = run_poisson(engine, workload, sink=sink)

        if args.compare_baseline or args.gate:
            pool_tokens = cfg.num_pages * cfg.page_size
            batch = max(1, pool_tokens // args.max_seq_len)
            base_rec = run_batch_baseline(model, workload, batch_size=batch,
                                          temperature=args.temperature, eos_id=args.eos_id,
                                          sink=sink, device=args.device)
            comparison = {
                "kind": "serve", "event": "comparison", "baseline_batch": batch,
                "engine_kv_tokens": pool_tokens, "baseline_kv_tokens": batch * args.max_seq_len,
                "tokens_per_sec_ratio": round(
                    serve_rec["tokens_per_sec"] / max(1e-9, base_rec["tokens_per_sec"]), 3),
                "ttft_p99_ratio": round(
                    serve_rec["ttft_p99_ms"] / max(1e-9, base_rec["ttft_p99_ms"]), 3),
                "engine_wins": (serve_rec["tokens_per_sec"] > base_rec["tokens_per_sec"]
                                and serve_rec["ttft_p99_ms"] < base_rec["ttft_p99_ms"]),
            }
            sink.emit(comparison)
            if args.gate and not comparison["engine_wins"]:
                print(json.dumps({"gate": "serve", "error": "continuous batching did not beat "
                                  "the batch-at-a-time baseline on both tokens/sec and p99 "
                                  "TTFT"}), file=sys.stderr)
                failed = True
    finally:
        sink.close()
    return 1 if failed else 0


if __name__ == "__main__":
    raise SystemExit(main())
