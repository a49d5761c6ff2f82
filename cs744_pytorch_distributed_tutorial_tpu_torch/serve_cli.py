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

    # spans, SLO windows and the device attribution of the programs
    # (obs serve-report renders and checks the directory):
    python -m cs744_pytorch_distributed_tutorial_tpu_torch.serve_cli \\
        --requests 24 --trace-dir /tmp/serve_trace --window-every 0.25

    # overload past the sustainable rate, shed at the door, expire stale
    # requests, and ride out injected decode faults under the
    # supervised restart ladder:
    python -m cs744_pytorch_distributed_tutorial_tpu_torch.serve_cli \\
        --requests 64 --rate 48 --deadline-s 30 --max-queue-depth 16 \\
        --shed-policy degrade --chaos 40:decode_nan,90:engine_crash

The flags are the JAX package's (``serve_cli.py``) with its names and
defaults, plus ``--compute-dtype`` (the JAX CLI serves in fp32),
``--recompute`` (``ServeConfig.recompute``) and ``--device`` (``cuda``,
the default, or ``cpu``). Weights are random from
``--seed``: latency, throughput and the parity contract do not depend on
them.
"""

from __future__ import annotations

import argparse
import json
import os
import sys


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
    p.add_argument("--recompute", default="prefill", choices=("prefill", "decode"),
                   help="how a preempted or resumed request rebuilds its KV: one dense pass "
                        "over prompt + produced tokens (the JAX engine's), or the prompt's "
                        "pass then the produced tokens fed back through decode steps (the "
                        "first pass's arithmetic: streams independent of preemptions and "
                        "restarts)")
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
    # tracing (obs/serve_trace.py)
    p.add_argument("--trace-dir", default=None,
                   help="write the serve trace here: the Perfetto trace (serve_trace.json), "
                        "span/window/request JSONL, and serve_phases.json (device time and "
                        "roofline of the decode and prefill programs)")
    p.add_argument("--window-every", type=float, default=None, metavar="S",
                   help="emit kind:'serve_window' SLO records every S seconds of the measured "
                        "run; defaults to 0.25 when --trace-dir is set")
    # deadlines and admission control (serve/guard.py); any of these
    # attaches a ServeGuard
    p.add_argument("--deadline-s", type=float, default=None,
                   help="default end-to-end deadline a request; expiry retires it as "
                        "timed_out and frees its pages")
    p.add_argument("--max-queue-s", type=float, default=None,
                   help="most time a request may wait queued for its first token")
    p.add_argument("--max-queue-depth", type=int, default=None,
                   help="bounded admission queue: arrivals beyond this depth are shed")
    p.add_argument("--shed-policy", default=None, choices=("reject", "degrade"),
                   help="overload response: reject new arrivals, or degrade (trim "
                        "max_new_tokens to the floor under page-pool pressure)")
    p.add_argument("--degrade-floor", type=int, default=8,
                   help="least max_new_tokens a degrade trim leaves")
    # chaos and supervised recovery (utils/chaos.py, serve/guard.py)
    p.add_argument("--chaos", default=None, metavar="IDX:KIND,...",
                   help="inject serve faults at measured decode-step indices, e.g. "
                        "'40:decode_nan,90:engine_crash'; kinds: decode_nan, slow_step, "
                        "engine_crash. Implies the supervised recovery loop")
    p.add_argument("--max-restarts", type=int, default=2,
                   help="engine restarts before recovery gives up")
    p.add_argument("--restart-backoff-s", type=float, default=0.0,
                   help="base exponential-backoff delay between restarts")
    p.add_argument("--step-timeout-s", type=float, default=None,
                   help="watchdog deadline a decode step: a hung step escalates warn -> "
                        "flight dump -> engine restart. Implies the supervised recovery loop")
    return p


def _parse_chaos(spec: str) -> dict[int, str]:
    """``"40:decode_nan,90:engine_crash"`` -> ``{40: ..., 90: ...}``."""
    faults: dict[int, str] = {}
    for part in spec.split(","):
        part = part.strip()
        if not part:
            continue
        idx, sep, kind = part.partition(":")
        if not sep:
            raise ValueError(f"chaos spec {part!r} is not IDX:KIND")
        faults[int(idx)] = kind
    return faults


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

    import numpy as np

    from cs744_pytorch_distributed_tutorial_tpu_torch.serve import (
        GuardConfig,
        Request,
        ServeConfig,
        ServeGuard,
        ServingEngine,
        make_poisson_workload,
        run_batch_baseline,
        run_poisson,
        run_serve_with_recovery,
    )

    model = build_model(args)
    cfg = ServeConfig(
        num_slots=args.num_slots, page_size=args.page_size, num_pages=args.num_pages,
        max_pages_per_slot=args.max_pages_per_slot, temperature=args.temperature,
        top_k=args.top_k, top_p=args.top_p, eos_id=args.eos_id, seed=args.seed,
        paged_attention_impl=args.paged_attention_impl, recompute=args.recompute,
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

        tracer = None
        window_every = args.window_every
        if args.trace_dir and window_every is None:
            window_every = 0.25
        if args.trace_dir or window_every is not None:
            from cs744_pytorch_distributed_tutorial_tpu_torch.obs.serve_trace import ServeTracer

            tracer = ServeTracer(args.num_slots, window_every_s=window_every)
        guard = None
        if any(v is not None for v in (args.deadline_s, args.max_queue_s,
                                       args.max_queue_depth, args.shed_policy)):
            guard = ServeGuard(cfg=GuardConfig(
                deadline_s=args.deadline_s, max_queue_s=args.max_queue_s,
                max_queue_depth=args.max_queue_depth, shed_policy=args.shed_policy or "reject",
                degrade_floor=args.degrade_floor,
            ))

        if args.chaos or args.step_timeout_s is not None:
            # The supervised loop: it owns the flight recorder (one an
            # engine, armed by its watchdog) and restarts the engine from
            # its snapshot on any ServeFailure.
            from cs744_pytorch_distributed_tutorial_tpu_torch.utils.chaos import (
                SERVE_FAULT_KINDS,
                FaultSchedule,
                ServeChaosMonkey,
            )

            monkey = None
            if args.chaos:
                faults = _parse_chaos(args.chaos)
                bad = sorted(set(faults.values()) - set(SERVE_FAULT_KINDS))
                if bad:
                    raise SystemExit(f"--chaos kinds {bad} not in {SERVE_FAULT_KINDS}")
                monkey = ServeChaosMonkey(FaultSchedule(faults), telemetry=sink)
            engines: list = []

            def make_engine():
                eng = ServingEngine(model, cfg, device=args.device, sink=sink, tracer=tracer,
                                    guard=guard)
                engines.append(eng)
                return eng

            serve_rec = run_serve_with_recovery(
                make_engine, workload, monkey=monkey, max_restarts=args.max_restarts,
                backoff_s=args.restart_backoff_s, step_timeout_s=args.step_timeout_s,
                telemetry=sink, sink=sink,
            )
            engine = engines[-1]
        else:
            engine = ServingEngine(model, cfg, device=args.device, sink=sink, tracer=tracer,
                                   guard=guard)
            # A SIGTERM or an uncaught crash dumps the serve event ring and
            # the pool's high water through the sink.
            flight = engine.make_flight_recorder()
            flight.install()
            try:
                serve_rec = run_poisson(engine, workload, sink=sink)
            finally:
                flight.uninstall()

        if args.trace_dir:
            from cs744_pytorch_distributed_tutorial_tpu_torch.obs.serve_trace import (
                profile_serve_programs,
            )

            tracer.write(args.trace_dir)
            # After the run: profiling re-runs the programs, off the clock.
            phase_recs = profile_serve_programs(engine)
            for rec in phase_recs:
                sink.emit(rec)
            with open(os.path.join(args.trace_dir, "serve_phases.json"), "w",
                      encoding="utf-8") as f:
                json.dump(phase_recs, f, indent=1)

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
