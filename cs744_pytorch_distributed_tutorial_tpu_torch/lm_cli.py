"""CLI for the transformer LM: train, then report held-out loss.

    python -m cs744_pytorch_distributed_tutorial_tpu_torch.lm_cli \\
        --num-layers 12 --d-model 768 --num-heads 12 --d-ff 3072 \\
        --vocab-size 50304 --max-seq-len 1024 --seq-len 1024 \\
        --global-batch-size 16 --use-rope --attention-impl flash \\
        --compute-dtype bfloat16 --steps 24 --eval-frac 0.04 --json

Then, with ``--generate N``, sample N tokens after a prompt (greedy at
``--temperature 0``), with ``--int8-decode [head|all]`` through the int8
weight-matmul kernel and with ``--int8-kv-cache`` over an int8 cache:

    python -m cs744_pytorch_distributed_tutorial_tpu_torch.lm_cli ... \
        --steps 0 --generate 128 --prompt-len 128 --generate-batch 16 \
        --temperature 0 --int8-decode head --json

``--fused-xent`` trains through the fused cross-entropy kernels. The MoE
LM trains (``--moe-dispatch dropless`` through the grouped-matmul kernels,
forward and backward; ``scatter``, the default, and ``einsum`` through
capacity slots) and generates:

    python -m cs744_pytorch_distributed_tutorial_tpu_torch.lm_cli \
        --num-layers 6 --d-model 512 --num-heads 8 --d-ff 1024 \
        --vocab-size 50304 --max-seq-len 512 --seq-len 512 --use-rope \
        --attention-impl flash --moe-experts 8 --moe-top-k 2 \
        --moe-dispatch dropless --compute-dtype bfloat16 \
        --global-batch-size 32 --steps 24 --num-seqs 800 --eval-frac 0.04 --json

    python -m cs744_pytorch_distributed_tutorial_tpu_torch.lm_cli \
        --num-layers 6 --d-model 512 --num-heads 8 --d-ff 1024 \
        --vocab-size 50304 --max-seq-len 512 --use-rope \
        --moe-experts 8 --moe-top-k 2 --moe-dispatch dropless \
        --compute-dtype bfloat16 --steps 0 --seq-len 128 --num-seqs 16 \
        --generate 128 --prompt-len 128 --generate-batch 16 --temperature 0 --json

The training options ``--remat`` (``--remat-policy none|dots``),
``--scan-layers``, ``--dropout-rate`` and ``--accum-steps`` run as the JAX
CLI's. ``--beam K`` decodes by beam search, ``--speculative-k K``
speculatively with a ``--draft-layers``-layer draft trained as the
target is (greedy at ``--temperature 0``, rejection sampling above):

    python -m cs744_pytorch_distributed_tutorial_tpu_torch.lm_cli ... \
        --steps 8 --generate 128 --temperature 0 --speculative-k 4 --draft-layers 1 --json

The run loop (``LMTrainer.fit``) checkpoints and resumes exactly
(``--checkpoint-dir``, ``--checkpoint-every``), keeps in-memory snapshots
(``--snapshot-every``, ``--snapshot-keep``), streams metrics
(``--metrics-dir``, ``--metrics-every``) and, with ``--max-restarts``,
restarts from the newest recoverable state after a NaN or a hang:

    python -m cs744_pytorch_distributed_tutorial_tpu_torch.lm_cli ... \
        --checkpoint-dir /tmp/ck --checkpoint-every 20 --metrics-dir /tmp/m \
        --max-restarts 1 --profile-dir /tmp/trace

Across ranks, one process a rank (``--coordinator host:port
--num-processes N --process-id R``, as the CIFAR CLI's; NCCL between
cards, Gloo with ``--device cpu``), with ``--data-parallel N`` and the
JAX CLI's wire flags (``--grad-compress int8``, ``--sync-bucket-mb``,
``--sync-overlap bucket|bucket+int8``) and sharded optimizers
(``--zero1``, ``--fsdp``):

    for r in 0 1 2 3; do
      python -m cs744_pytorch_distributed_tutorial_tpu_torch.lm_cli ... \
          --data-parallel 4 --zero1 --coordinator localhost:29517 \
          --num-processes 4 --process-id $r --device cpu &
    done

and the JAX CLI's sequence, tensor and expert axes (``--seq-parallel S``
with ``--attention-impl ring|ring_flash|ulysses|ulysses_flash``,
``--tensor-parallel T``, ``--moe-expert-parallel``): the world is
``data x seq x tensor`` processes, e.g. ``--data-parallel 2
--seq-parallel 2 --attention-impl ulysses_flash`` or ``--tensor-parallel
4 --zero1`` on 4 ranks.

Every rank trains, evaluates and joins the gathers of ``--fsdp``'s
weights for generation (the draft's too); rank 0 alone decodes and
prints. ``--num-processes 1`` (or any of those options) runs the wire on
a process group of one.

The flags are the JAX package's (``lm_cli.py``), with its names and
defaults, for the options the port runs, plus ``--device`` (``cuda``,
the default, or ``cpu``), ``--generate-batch`` (prompts are the
leading training sequences' prefixes; the JAX CLI takes one) and the
JAX CIFAR CLI's ``--step-timeout-s``, ``--profile-dir``,
``--profile-start-step`` and ``--profile-num-steps`` for the LMConfig
fields of those names (their defaults are LMConfig's). Other
flags of the JAX CLI (the pipeline axis's) are not accepted. The
JAX CLI's refusals of ``--beam`` and
``--speculative-k`` combinations are made before training. The stdout
lines and the ``--json`` summary keys are the JAX CLI's, plus
``generation`` (batch, times and every row's tokens; the decoder, and
for speculative decoding its target calls and accept rate) when
generating and, for an MoE run with steps, ``moe``:
every step's ``moe_aux``, ``moe_drop`` and ``moe_load_entropy`` (the
per-step MoE fields the JAX trainer's telemetry records).
"""

from __future__ import annotations

import argparse
import json
import math

import numpy as np

from cs744_pytorch_distributed_tutorial_tpu_torch.models.transformer import ATTENTION_IMPLS


def _json_loss(loss):
    """A loss value safe for json.dumps: non-finite floats become null."""
    return loss if loss is not None and math.isfinite(loss) else None


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(prog="cs744-torch-lm",
                                description="PyTorch/CUDA transformer LM training")
    # model
    p.add_argument("--vocab-size", type=int, default=1024,
                   help="ignored with --text-file (byte vocab = 256)")
    p.add_argument("--num-layers", type=int, default=4)
    p.add_argument("--num-heads", type=int, default=8)
    p.add_argument("--num-kv-heads", type=int, default=None,
                   help="grouped-query attention KV head count (1 = MQA)")
    p.add_argument("--d-model", type=int, default=256)
    p.add_argument("--d-ff", type=int, default=1024)
    p.add_argument("--max-seq-len", type=int, default=2048)
    p.add_argument("--attention-impl", default="ring", choices=list(ATTENTION_IMPLS),
                   help="dense, or flash (the CUDA kernels); across --seq-parallel ranks "
                        "ring, ring_flash (the flash kernels a hop), ulysses or "
                        "ulysses_flash; on one sequence shard ring/ulysses run dense and "
                        "ring_flash/ulysses_flash run flash")
    p.add_argument("--compute-dtype", default="float32", choices=["float32", "bfloat16"])
    p.add_argument("--remat", action="store_true")
    p.add_argument("--remat-policy", default="none", choices=["none", "dots"],
                   help="remat granularity: recompute everything, or keep matmul outputs and "
                        "recompute elementwise only")
    p.add_argument("--scan-layers", action="store_true",
                   help="the layer-stacked parameter layout: one blocks module whose "
                        "parameters carry a leading layer axis, run a layer at a time; "
                        "identical numerics")
    p.add_argument("--tie-embeddings", action="store_true")
    p.add_argument("--norm", default="layernorm", choices=["layernorm", "rmsnorm"])
    p.add_argument("--mlp", default="gelu", choices=["gelu", "swiglu"])
    p.add_argument("--use-rope", action="store_true")
    p.add_argument("--fused-xent", action="store_true",
                   help="fused softmax cross-entropy (the CUDA kernels of ops/fused_xent.py)")
    # MoE
    p.add_argument("--moe-experts", type=int, default=0)
    p.add_argument("--moe-top-k", type=int, default=2)
    p.add_argument("--moe-groups", type=int, default=1,
                   help="token groups for MoE routing/capacity (0 = ~1024 tokens a group; "
                        "dropless takes 1)")
    p.add_argument("--moe-dispatch", choices=("einsum", "scatter", "dropless"),
                   default="scatter",
                   help="token movement: capacity slots (einsum, scatter) or dropless (no "
                        "capacity: the grouped-matmul kernels)")
    p.add_argument("--moe-gmm-impl", choices=("auto", "ragged", "pallas"), default="auto",
                   help="grouped-matmul backend for --moe-dispatch dropless: auto and pallas "
                        "take the CUDA kernels, ragged the plain ragged_dot product")
    p.add_argument("--moe-expert-parallel", action="store_true",
                   help="split the experts over the data axis (the capacity slots' "
                        "all-to-all; scatter or einsum dispatch)")
    # mesh
    p.add_argument("--data-parallel", type=int, default=1)
    p.add_argument("--seq-parallel", type=int, default=1,
                   help="split each sequence over this many ranks (ring or Ulysses attention)")
    p.add_argument("--tensor-parallel", type=int, default=1,
                   help="split heads and d_ff over this many ranks (Megatron)")
    # optimization
    p.add_argument("--global-batch-size", type=int, default=8)
    p.add_argument("--seq-len", type=int, default=256)
    p.add_argument("--steps", type=int, default=100)
    p.add_argument("--lr", type=float, default=1e-3)
    p.add_argument("--optimizer", default="adamw", choices=["adamw", "sgd", "lion"])
    p.add_argument("--lr-schedule", default="constant",
                   choices=["constant", "cosine", "warmup_cosine"],
                   help="cosine schedules decay over --steps")
    p.add_argument("--warmup-steps", type=int, default=0,
                   help="linear warmup from 0 over this many steps")
    p.add_argument("--weight-decay", type=float, default=1e-4)
    p.add_argument("--grad-clip-norm", type=float, default=None)
    p.add_argument("--grad-compress", choices=["none", "int8"], default="none",
                   help="compress the data-parallel gradient sync: int8 bucket quantization "
                        "with error feedback (~3.9x fewer gradient bytes; pure-DP layouts only)")
    p.add_argument("--sync-bucket-mb", type=float, default=4.0,
                   help="bucket size (MiB) for the compressed sync's coalesced buffers")
    p.add_argument("--sync-overlap", choices=["off", "bucket", "bucket+int8"], default="off",
                   help="overlapped gradient sync (parallel/overlap.py, parallel/zero.py): "
                        "reverse-layer-order buckets, per-bucket collective + per-bucket "
                        "optimizer apply. Pure DP needs --optimizer sgd with constant lr; "
                        "--zero1/--fsdp admit any registry optimizer and schedule (per-bucket "
                        "scatter -> chunk apply -> gather). 'bucket+int8' overlaps the int8+EF "
                        "wire (--grad-compress int8; pure DP or --zero1)")
    p.add_argument("--label-smoothing", type=float, default=0.0)
    p.add_argument("--dropout-rate", type=float, default=0.0,
                   help="residual dropout on each block's sublayer outputs; masks are keyed "
                        "by the step index")
    p.add_argument("--no-halt-on-nonfinite", dest="halt_on_nonfinite",
                   action="store_false", default=True)
    p.add_argument("--accum-steps", type=int, default=1)
    p.add_argument("--zero1", action="store_true",
                   help="ZeRO-1: shard the optimizer moments over the data axis (optimizer "
                        "memory / data_parallel); composes with --grad-clip-norm and all "
                        "--optimizer rules (adamw/lion/sgd); no expert parallelism")
    p.add_argument("--fsdp", action="store_true",
                   help="ZeRO-3/FSDP: params AND optimizer moments persist as data-axis-sharded "
                        "chunks, gathered just-in-time per step (3x-params state / "
                        "data_parallel); same compositions and restrictions as --zero1")
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--log-every", type=int, default=20)
    p.add_argument("--metrics-dir", default=None,
                   help="write manifest.json + per-step metrics.jsonl here (obs/)")
    p.add_argument("--metrics-every", type=int, default=None,
                   help="metric emission cadence in steps (default 1; the LM loop fetches "
                        "every step already)")
    p.add_argument("--checkpoint-dir", default=None)
    p.add_argument("--checkpoint-every", type=int, default=0)
    p.add_argument("--snapshot-every", type=int, default=0,
                   help="keep in-memory state snapshots every N steps (utils/memstore.py): "
                        "restart recovery with no file read (0 disables)")
    p.add_argument("--snapshot-keep", type=int, default=2,
                   help="in-memory snapshots retained (default 2)")
    p.add_argument("--max-restarts", type=int, default=0,
                   help="restart from the newest recoverable state on detected training "
                        "failures (needs --checkpoint-dir or --snapshot-every)")
    p.add_argument("--restart-backoff-s", type=float, default=0.0,
                   help="exponential backoff base between restarts (attempt n sleeps "
                        "backoff * 2^(n-1), capped 60s)")
    p.add_argument("--restart-jitter", choices=("none", "decorrelated"), default="none",
                   help="decorrelate restart backoff across ranks (seeded per "
                        "process/generation)")
    p.add_argument("--step-timeout-s", type=float, default=None,
                   help="arm the hang watchdog around each step after the first")
    p.add_argument("--profile-dir", default=None,
                   help="write a profiler trace of steps [--profile-start-step, "
                        "+ --profile-num-steps) here")
    p.add_argument("--profile-start-step", type=int, default=2)
    p.add_argument("--profile-num-steps", type=int, default=3)
    # data
    p.add_argument("--text-file", default=None,
                   help="byte-level corpus from a local file (vocab 256); "
                        "default is the synthetic cyclic token stream")
    p.add_argument("--num-seqs", type=int, default=512,
                   help="synthetic stream size / corpus window cap")
    p.add_argument("--eval-frac", type=float, default=0.0,
                   help="hold out this fraction of sequences and report "
                        "final loss/perplexity on them")
    # generation
    p.add_argument("--generate", type=int, default=0, metavar="N",
                   help="after training, sample N tokens")
    p.add_argument("--prompt", default=None,
                   help="generation prompt (bytes with --text-file, else token ids); "
                        "default: the first training sequence's prefix")
    p.add_argument("--prompt-len", type=int, default=16)
    p.add_argument("--generate-batch", type=int, default=1, metavar="B",
                   help="generate for the first B training sequences' prefixes")
    p.add_argument("--temperature", type=float, default=1.0)
    p.add_argument("--top-k", type=int, default=None)
    p.add_argument("--top-p", type=float, default=None)
    p.add_argument("--int8-decode", nargs="?", const="head", default=None,
                   choices=["head", "all"], metavar="SCOPE",
                   help="generate with int8 weights (the int8 matmul kernel): 'head' "
                        "(default) quantizes lm_head only, 'all' every projection")
    p.add_argument("--int8-kv-cache", action="store_true",
                   help="store the decode KV cache int8 with per-row scales")
    p.add_argument("--beam", type=int, default=0, metavar="K",
                   help="beam-search decode with K beams instead of sampling")
    p.add_argument("--speculative-k", type=int, default=0, metavar="K",
                   help="speculative decoding: train a shallow draft on the same data, propose "
                        "K tokens per target verification chunk (infer/speculative.py; greedy "
                        "at --temperature 0, rejection sampling above; no --beam)")
    p.add_argument("--draft-layers", type=int, default=1,
                   help="layer count of the speculative draft model (same width/heads as the "
                        "target)")
    p.add_argument("--json", action="store_true")
    p.add_argument("--device", choices=["cuda", "cpu"], default="cuda")
    # rendezvous, as the CIFAR CLI's (master/part2a/part2a.py:80-85)
    p.add_argument("--coordinator", dest="coordinator_address", default=None,
                   help="rendezvous address host:port (the --master-ip analog)")
    p.add_argument("--num-processes", type=int, default=None,
                   help="the --num-nodes analog: world size (= --data-parallel)")
    p.add_argument("--process-id", type=int, default=None, help="the --rank analog")
    return p


def _split_eval(eval_frac: float, tokens, batch_size: int):
    """Hold out the leading ``eval_frac`` of ``tokens`` (at least one
    batch); returns ``(eval_tokens | None, train_tokens)``."""
    if eval_frac == 0:
        return None, tokens
    if not 0.0 < eval_frac < 1.0:
        raise SystemExit(f"--eval-frac must be in (0, 1), got {eval_frac}")
    n_eval = max(int(len(tokens) * eval_frac), batch_size)
    if n_eval >= len(tokens):
        raise SystemExit(
            f"--eval-frac {eval_frac} leaves no training data "
            f"({n_eval} of {len(tokens)} sequences held out)"
        )
    return tokens[:n_eval], tokens[n_eval:]


def _check_decoders(args) -> None:
    """The JAX CLI's refusals of ``--beam`` and ``--speculative-k``
    combinations (raised before training here)."""
    if args.beam > 0 and (args.top_k is not None or args.top_p is not None
                          or args.temperature != 1.0):
        raise SystemExit("--beam is deterministic highest-likelihood decoding; it cannot "
                         "combine with --temperature/--top-k/--top-p (drop --beam to sample)")
    if args.generate > 0 and args.speculative_k > 0:
        if args.beam > 0:
            raise SystemExit("--speculative-k does not combine with --beam")
        if args.top_k is not None or args.top_p is not None:
            raise SystemExit("--speculative-k supports temperature-only sampling (top-k/top-p "
                             "truncation re-normalizes the target distribution, breaking the "
                             "rejection-sampling exactness identity)")
        if args.int8_decode is not None or args.int8_kv_cache:
            raise SystemExit("--speculative-k does not combine with the int8 decode paths "
                             "(verify in float; quantize separately)")


def _speculative(args, trainer, tokens, model, prompt):
    """Train the ``--draft-layers`` draft as the target was trained (its
    configuration but the depth; every rank), then decode speculatively
    (rank 0; the others return None); returns ``(tokens, timing,
    stats)``."""
    import torch

    from cs744_pytorch_distributed_tutorial_tpu_torch.infer import make_speculative_generator
    from cs744_pytorch_distributed_tutorial_tpu_torch.obs.metrics import (
        Telemetry,
        speculative_accept_rate,
    )
    from cs744_pytorch_distributed_tutorial_tpu_torch.train.lm import LMTrainer

    draft_tr = LMTrainer(trainer.cfg.replace(num_layers=args.draft_layers))
    draft_tr.fit(tokens, args.steps)
    draft = draft_tr.decode_model()  # under fsdp a gather every rank joins
    if trainer.rank != 0:
        return None, None, None
    spec = make_speculative_generator(model, draft,
                                      max_new_tokens=args.generate, k=args.speculative_k,
                                      temperature=args.temperature, return_stats=True,
                                      device=args.device)
    gen = None
    if args.temperature > 0.0:
        gen = torch.Generator(device=trainer.device).manual_seed(args.seed)
    out, target_calls = spec(prompt[:1].astype(np.int64), gen)
    accept_rate = speculative_accept_rate(args.generate, target_calls, args.speculative_k)
    print(f"speculative: {target_calls} target calls for {args.generate} tokens "
          f"(k={args.speculative_k}, accept rate {accept_rate:.3f})")
    stats = {"target_calls": target_calls, "k": args.speculative_k, "accept_rate": accept_rate,
             "draft_layers": args.draft_layers}
    if args.metrics_dir is not None:
        # Appended to the training run's stream: one timeline a run.
        telemetry = Telemetry(args.metrics_dir, run="lm")
        telemetry.emit_event("speculative_decode", new_tokens=args.generate,
                             target_calls=target_calls, k=args.speculative_k,
                             accept_rate=accept_rate, draft_layers=args.draft_layers,
                             temperature=args.temperature)
        telemetry.close()
    return out, spec.timing, stats


def _generate(args, trainer, tokens):
    """Decode ``--generate`` tokens with the trainer's weights (sampling,
    ``--beam`` or ``--speculative-k``); prints the first row and returns
    ``(sample, generation record)``. Every rank builds the decode copy
    (under fsdp its weights are gathered, a collective); rank 0 alone
    decodes, the others return ``(None, None)``."""
    from cs744_pytorch_distributed_tutorial_tpu_torch.infer import (
        make_beam_searcher,
        make_generator,
    )

    if args.prompt is not None and args.text_file:
        prompt = np.frombuffer(args.prompt.encode("utf-8"), dtype=np.uint8)[None, :]
    elif args.prompt is not None:
        prompt = np.asarray([[int(t) for t in args.prompt.split()]])
    else:
        if args.generate_batch > len(tokens):
            raise SystemExit(f"--generate-batch {args.generate_batch} exceeds the "
                             f"{len(tokens)} training sequences")
        prompt = np.asarray(tokens[: args.generate_batch, : args.prompt_len])
    if args.int8_decode is not None:
        model = trainer.quantized_decode_model(args.int8_decode, kv_cache=args.int8_kv_cache)
    else:
        model = trainer.decode_model(kv_cache=args.int8_kv_cache)
    extra: dict = {}
    if args.speculative_k > 0:
        out, timing, stats = _speculative(args, trainer, tokens, model, prompt)
        if out is None:
            return None, None
        extra = {"decoder": "speculative", **stats}
    elif trainer.rank != 0:
        return None, None
    elif args.beam > 0:
        search = make_beam_searcher(model, beam_size=args.beam, max_new_tokens=args.generate,
                                    device=args.device)
        out, _ = search(prompt.astype(np.int64))
        timing, extra = search.timing, {"decoder": "beam", "beam": args.beam}
    else:
        generate = make_generator(model, max_new_tokens=args.generate,
                                  temperature=args.temperature, top_k=args.top_k,
                                  top_p=args.top_p, device=args.device)
        gen = None
        if args.temperature != 0.0:
            import torch

            gen = torch.Generator(device=trainer.device).manual_seed(args.seed)
        out = generate(prompt.astype(np.int64), gen)
        timing = generate.timing
    out = out.cpu().numpy()
    ids = out[0].tolist()
    if args.text_file:
        sample = bytes(ids).decode("utf-8", errors="replace")
        print(f"sample: {sample!r}")
    else:
        sample = ids
        print(f"sample ids: {ids}")
    t, new_tokens = timing, out.size
    total_s = t["prefill_s"] + t["decode_s"]
    generation = {
        "batch": int(out.shape[0]), "prompt_len": int(prompt.shape[1]),
        "new_tokens": args.generate, "int8_decode": args.int8_decode,
        "int8_kv_cache": args.int8_kv_cache, "prefill_ms": t["prefill_s"] * 1e3,
        "decode_ms_per_step": t["decode_s"] * 1e3 / max(1, t["decode_steps"]),
        "tokens_per_s": new_tokens / total_s, **extra, "tokens": out.tolist(),
    }
    print(f"generated {new_tokens} tokens in {total_s:.3f} s ({generation['tokens_per_s']:.1f} "
          f"tokens/s): prefill {generation['prefill_ms']:.2f} ms, "
          f"{generation['decode_ms_per_step']:.3f} ms a decode step")
    return sample, generation


def main(argv: list[str] | None = None) -> int:
    args = build_parser().parse_args(argv)
    _check_decoders(args)

    from cs744_pytorch_distributed_tutorial_tpu_torch.data import (
        BYTE_VOCAB,
        byte_corpus,
        synthetic_tokens,
    )
    from cs744_pytorch_distributed_tutorial_tpu_torch.train.lm import LMConfig, check_config

    if args.text_file:
        vocab = BYTE_VOCAB
        tokens = byte_corpus(args.text_file, args.seq_len, max_seqs=args.num_seqs,
                             seed=args.seed)
    else:
        vocab = args.vocab_size
        tokens = synthetic_tokens(args.num_seqs, args.seq_len, vocab, seed=args.seed)

    cfg = LMConfig(
        vocab_size=vocab,
        num_layers=args.num_layers,
        num_heads=args.num_heads,
        num_kv_heads=args.num_kv_heads,
        d_model=args.d_model,
        d_ff=args.d_ff,
        max_seq_len=args.max_seq_len,
        attention_impl=args.attention_impl,
        compute_dtype=args.compute_dtype,
        remat=args.remat,
        remat_policy=args.remat_policy,
        scan_layers=args.scan_layers,
        tie_embeddings=args.tie_embeddings,
        use_rope=args.use_rope,
        norm=args.norm,
        mlp=args.mlp,
        fused_xent=args.fused_xent,
        moe_experts=args.moe_experts,
        moe_top_k=args.moe_top_k,
        moe_groups=args.moe_groups,
        moe_dispatch=args.moe_dispatch,
        moe_gmm_impl=args.moe_gmm_impl,
        moe_expert_parallel=args.moe_expert_parallel,
        global_batch_size=args.global_batch_size,
        seq_len=args.seq_len,
        learning_rate=args.lr,
        optimizer=args.optimizer,
        lr_schedule=args.lr_schedule,
        warmup_steps=args.warmup_steps,
        # Cosine schedules decay over the full requested run.
        total_steps=args.steps if args.lr_schedule != "constant" else None,
        weight_decay=args.weight_decay,
        grad_clip_norm=args.grad_clip_norm,
        label_smoothing=args.label_smoothing,
        dropout_rate=args.dropout_rate,
        accum_steps=args.accum_steps,
        seed=args.seed,
        halt_on_nonfinite=args.halt_on_nonfinite,
        checkpoint_dir=args.checkpoint_dir,
        checkpoint_every=args.checkpoint_every,
        snapshot_every=args.snapshot_every,
        snapshot_keep=args.snapshot_keep,
        step_timeout_s=args.step_timeout_s,
        metrics_dir=args.metrics_dir,
        metrics_every=1 if args.metrics_every is None else args.metrics_every,
        profile_dir=args.profile_dir,
        profile_start_step=args.profile_start_step,
        profile_num_steps=args.profile_num_steps,
        data_parallel=args.data_parallel,
        seq_parallel=args.seq_parallel,
        tensor_parallel=args.tensor_parallel,
        grad_compress=args.grad_compress,
        sync_bucket_mb=args.sync_bucket_mb,
        sync_overlap=args.sync_overlap,
        zero1=args.zero1,
        fsdp=args.fsdp,
        device=args.device,
    )
    check_config(cfg)  # the JAX rejections, before any process group
    eval_tokens, tokens = _split_eval(args.eval_frac, tokens, cfg.global_batch_size)

    from cs744_pytorch_distributed_tutorial_tpu_torch.config import resolve_device
    from cs744_pytorch_distributed_tutorial_tpu_torch.parallel import mesh
    from cs744_pytorch_distributed_tutorial_tpu_torch.parallel.multihost import (
        attach,
        env_context,
    )

    # Under the elastic supervisor (launch.py) the coordinates arrive in
    # the GRAFT_ELASTIC_* environment: attach (the process group, the
    # heartbeats, the identity labels) instead of the flags.
    elastic_ctx = env_context()
    if elastic_ctx is not None:
        world_size, rank = elastic_ctx.num_processes, elastic_ctx.process_id
    else:
        world_size = args.num_processes or 1
        rank = args.process_id or 0
    layout = args.data_parallel * args.seq_parallel * args.tensor_parallel
    # A world of one needs no process group unless the wire is asked for.
    if (elastic_ctx is not None or args.num_processes is not None or world_size > 1
            or layout > 1 or args.zero1 or args.fsdp or args.grad_compress != "none"
            or args.sync_overlap != "off"):
        if layout != world_size:
            raise SystemExit(f"--data-parallel {args.data_parallel} x --seq-parallel "
                             f"{args.seq_parallel} x --tensor-parallel {args.tensor_parallel} "
                             f"must equal the world size (--num-processes {world_size}): one "
                             "process a rank")
        device = mesh.rank_device(resolve_device(args.device), rank)
        if elastic_ctx is not None:
            attach(elastic_ctx, device)
        else:
            mesh.initialize(args.coordinator_address, world_size, rank, device=device)
    try:
        return _run(args, cfg, vocab, tokens, eval_tokens)
    finally:
        mesh.shutdown()


def _run(args, cfg, vocab, tokens, eval_tokens) -> int:
    from cs744_pytorch_distributed_tutorial_tpu_torch.train.lm import LMTrainer

    trainer = LMTrainer(cfg)
    lead = trainer.rank == 0
    restarts = 0
    if args.max_restarts > 0:
        from cs744_pytorch_distributed_tutorial_tpu_torch.utils.failure import run_with_recovery

        _, _, losses, restarts = run_with_recovery(
            trainer, max_restarts=args.max_restarts, backoff_s=args.restart_backoff_s,
            backoff_jitter=args.restart_jitter, jitter_seed=args.seed, fit_args=(tokens,),
            fit_kwargs={"steps": args.steps},
        )
        if restarts and lead:
            print(f"recovered after {restarts} restart(s)")
    else:
        _, _, losses = trainer.fit(tokens, steps=args.steps)
    moe = ({key: trainer.history[key] for key in ("moe_aux", "moe_drop", "moe_load_entropy")}
           if args.moe_experts > 0 and losses else None)
    for i, loss in enumerate(losses):
        if lead and (i % args.log_every == 0 or i == len(losses) - 1):
            print(f"{i} loss:  {loss:f}")
    eval_metrics = None
    if eval_tokens is not None:
        eval_metrics = trainer.evaluate(eval_tokens)
        if lead:
            print(f"eval loss:  {eval_metrics['loss']:f}  "
                  f"perplexity:  {eval_metrics['perplexity']:f}")

    sample, generation = None, None
    if args.generate > 0:
        sample, generation = _generate(args, trainer, tokens)

    if args.json and lead:
        print(json.dumps({
            "vocab_size": vocab,
            "mesh": dict(trainer.mesh.sizes),
            "steps": args.steps,
            "first_loss": _json_loss(losses[0]) if losses else None,
            "final_loss": _json_loss(losses[-1]) if losses else None,
            "finite": bool(math.isfinite(losses[-1])) if losses else None,
            "steps_run": len(losses),
            "eval": eval_metrics,
            "sample": sample,
            **({"generation": generation} if generation is not None else {}),
            **({"moe": moe} if moe is not None else {}),
        }))
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
