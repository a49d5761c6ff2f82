"""CLI for the transformer LM: train, then report held-out loss.

    python -m cs744_pytorch_distributed_tutorial_tpu_torch.lm_cli \\
        --num-layers 12 --d-model 768 --num-heads 12 --d-ff 3072 \\
        --vocab-size 50304 --max-seq-len 1024 --seq-len 1024 \\
        --global-batch-size 16 --use-rope --attention-impl flash \\
        --compute-dtype bfloat16 --steps 24 --eval-frac 0.04 --json

The flags are the JAX package's (``lm_cli.py``), with its names and
defaults, for the options the port runs, plus ``--device`` (``cuda``,
the default, or ``cpu``). Other flags and choices of the JAX CLI (the
lion optimizer, cosine schedules) are not accepted;
``--fused-xent`` and ``--generate`` exit with "not yet ported". The
stdout lines and the ``--json`` summary keys are the JAX CLI's
(``sample`` is null: generation is not ported).
"""

from __future__ import annotations

import argparse
import json
import math

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
                   help="dense, or flash (the CUDA kernels); on one device ring/ulysses "
                        "run dense and ring_flash/ulysses_flash run flash")
    p.add_argument("--compute-dtype", default="float32", choices=["float32", "bfloat16"])
    p.add_argument("--tie-embeddings", action="store_true")
    p.add_argument("--norm", default="layernorm", choices=["layernorm", "rmsnorm"])
    p.add_argument("--mlp", default="gelu", choices=["gelu", "swiglu"])
    p.add_argument("--use-rope", action="store_true")
    p.add_argument("--fused-xent", action="store_true", help="not yet ported")
    # optimization
    p.add_argument("--global-batch-size", type=int, default=8)
    p.add_argument("--seq-len", type=int, default=256)
    p.add_argument("--steps", type=int, default=100)
    p.add_argument("--lr", type=float, default=1e-3)
    p.add_argument("--optimizer", default="adamw", choices=["adamw", "sgd"])
    p.add_argument("--lr-schedule", default="constant", choices=["constant"])
    p.add_argument("--warmup-steps", type=int, default=0,
                   help="linear warmup from 0 over this many steps")
    p.add_argument("--weight-decay", type=float, default=1e-4)
    p.add_argument("--label-smoothing", type=float, default=0.0)
    p.add_argument("--no-halt-on-nonfinite", dest="halt_on_nonfinite",
                   action="store_false", default=True)
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--log-every", type=int, default=20)
    # data
    p.add_argument("--text-file", default=None,
                   help="byte-level corpus from a local file (vocab 256); "
                        "default is the synthetic cyclic token stream")
    p.add_argument("--num-seqs", type=int, default=512,
                   help="synthetic stream size / corpus window cap")
    p.add_argument("--eval-frac", type=float, default=0.0,
                   help="hold out this fraction of sequences and report "
                        "final loss/perplexity on them")
    p.add_argument("--generate", type=int, default=0, metavar="N", help="not yet ported")
    p.add_argument("--json", action="store_true")
    p.add_argument("--device", choices=["cuda", "cpu"], default="cuda")
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


def main(argv: list[str] | None = None) -> int:
    args = build_parser().parse_args(argv)
    for flag, on in (("--fused-xent", args.fused_xent), ("--generate", args.generate)):
        if on:
            raise SystemExit(f"{flag} is not yet ported to the PyTorch/CUDA package")

    from cs744_pytorch_distributed_tutorial_tpu_torch.data import (
        BYTE_VOCAB,
        byte_corpus,
        synthetic_tokens,
    )
    from cs744_pytorch_distributed_tutorial_tpu_torch.train.lm import LMConfig, LMTrainer

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
        tie_embeddings=args.tie_embeddings,
        use_rope=args.use_rope,
        norm=args.norm,
        mlp=args.mlp,
        global_batch_size=args.global_batch_size,
        seq_len=args.seq_len,
        learning_rate=args.lr,
        optimizer=args.optimizer,
        lr_schedule=args.lr_schedule,
        warmup_steps=args.warmup_steps,
        weight_decay=args.weight_decay,
        label_smoothing=args.label_smoothing,
        seed=args.seed,
        halt_on_nonfinite=args.halt_on_nonfinite,
        device=args.device,
    )
    eval_tokens, tokens = _split_eval(args.eval_frac, tokens, cfg.global_batch_size)

    trainer = LMTrainer(cfg)
    _, _, losses = trainer.fit(tokens, steps=args.steps)
    for i, loss in enumerate(losses):
        if i % args.log_every == 0 or i == len(losses) - 1:
            print(f"{i} loss:  {loss:f}")
    eval_metrics = None
    if eval_tokens is not None:
        eval_metrics = trainer.evaluate(eval_tokens)
        print(f"eval loss:  {eval_metrics['loss']:f}  "
              f"perplexity:  {eval_metrics['perplexity']:f}")

    if args.json:
        print(json.dumps({
            "vocab_size": vocab,
            "mesh": {"data": 1, "seq": 1, "tensor": 1},
            "steps": args.steps,
            "first_loss": _json_loss(losses[0]) if losses else None,
            "final_loss": _json_loss(losses[-1]) if losses else None,
            "finite": bool(math.isfinite(losses[-1])) if losses else None,
            "steps_run": len(losses),
            "eval": eval_metrics,
            "sample": None,
        }))
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
