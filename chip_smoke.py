"""Smoke run of the PyTorch/CUDA port on one NVIDIA card.

    python3 chip_smoke.py

Phases, each raising on failure (the script then exits nonzero and prints
no result):

1. setup: the card, its power limit, torch/CUDA versions, TF32 settings,
   and the build of every kernel from ``csrc/`` (one ``nvcc`` per source,
   all started together), with ptxas's registers and spills for each
   tensor-core kernel;
2. kernels against their plain PyTorch versions on the card, then their
   times beside their bounds, the plain versions' times and one PyTorch
   library call's time:
   - fused SGD, one multi-tensor launch for a list, bitwise against the
     plain update over ResNet-18's 62 and VGG-11's 34 parameter shapes and
     a list of both with ragged shapes, led by a misaligned tensor (more
     than one launch holds); a whole update timed as one call, as a loop
     of one-tensor calls, plain and as ``torch.optim.SGD(fused=True)``;
   - the 3x3 conv wgrad at ResNet-18's routed (stride 1) and stride-2
     shapes at batch 256 and at ragged shapes, fp32 and bf16: each call on
     the route ``ops/fused_conv.py::tc_route`` gives it (the tensor cores;
     FFMA for rows of 4 or 6) and the tensor cores' calls again on FFMA, each
     route's share of the limit printed; both routes timed in turn;
3. main paths, through the port's CLI, part 1 (one rank), batch 256, 24
   steps each, the kernel launch counts zeroed just before each run and
   read just after: ResNet-18 at full width with ``--fast-conv
   --fused-optimizer`` (6 wgrad launches a step, all fp32 stride 1 on the
   tensor cores, and one fused-SGD launch for the 62 tensors), and VGG-11
   with ``--fused-optimizer`` (one a step for its 34);
4. NCCL paths at a world of one, 5 steps each: VGG-11 part 2b, and
   ResNet-18 part 3 (DDP) with ``--fast-conv``;
5. bf16: ResNet-18 ``--fast-conv --compute-dtype bfloat16``, 5 steps, the
   wgrad kernel launched on bf16 inputs;
6. trajectories: VGG-11 fused vs plain update (3 steps), and ResNet-18
   with the wgrad kernel vs the library's (4 steps, TF32 off);
7. profiles: where the device time of a main-path step goes, VGG-11 and
   ResNet-18 (with and without ``fast_conv``);
7a. the port's headline benchmark (``bench.py``): ResNet-18, bf16, DDP
   on a process group of one, batch 4096 (10 + 30 steps) and 1024 (10 +
   90), its ``kind: "bench"`` line after the card and the peak memory;
7b. the gradient wire's paths through the CLI on NCCL at a world of one,
   ResNet-18 at batch 256, 12 steps each, launch counts zeroed just
   before each run and read just after: part 2b's allreduce and ring,
   the overlapped schedule over both (``--sync-overlap bucket``: one
   fused-SGD launch a bucket, 12 buckets a step), the int8 wire over both
   and overlapped (``--grad-compress int8``, ``--sync-overlap
   bucket+int8``) and ``--accum-steps 2 --fused-optimizer``, each mode's
   step time (overlap hides nothing at one rank); then, with cuDNN
   deterministic, 3 Trainer steps each: the overlapped float paths
   bitwise equal to the fused ones, and one int8 step's mean and
   residual bitwise equal to the wire's CPU version on the same
   gradients;
7c. the sharded optimizers and the recipes through the CLI at a world of
   one, ResNet-18 at batch 256, 12 steps each: part 2b's allreduce and
   part 1's SGD as yardsticks, ``--sync zero1`` and
   ``--sync fsdp`` (NCCL), alone and with ``--sync-overlap bucket``, their
   reduce-scatters and all-gathers counted; part 1 with AdamW +
   warmup_cosine + clip and with Lion + cosine; part 2b with ``--sync-bn
   --debug-sync-check``; each mode's step time beside the card; then,
   with cuDNN deterministic, 3 Trainer steps each: zero1 and fsdp (alone
   and overlapped) bitwise equal to part 2b's allreduce, SyncBN's losses
   within 1e-3 of the per-replica path (TF32 off);
8. flash attention: the forward, dq and dk/dv kernels against their
   plain versions (the LM path's shape B16 T1024 H12 D64 causal, a
   non-causal and ragged shapes, the ViT path's [1024, 65, 3, 64],
   [512, 65, 6, 64] and [1024, 17, 3, 128] not causal; fp32 and bf16): fp32 inputs on the FFMA
   kernels, bf16 ones on the tensor-core kernels (bitwise repeatable) and
   again on the FFMA route, each call's route shown by its launches; then
   their times at the path's shape in bf16 (each kernel's two routes in
   turn; the tensor-core kernels must be the faster) beside their bounds,
   the plain versions', ``scaled_dot_product_attention``'s forward and
   backward, and the tensor-core kernels' registers and spills;
9. fused cross-entropy: the forward and backward kernels against their
   plain versions at the LM path's logits ([16384, 50304] fp32), in bf16
   and at a ragged shape ([37, 50257]), then their times beside their
   bounds, the plain versions' and ``F.cross_entropy``'s forward and
   backward;
10. the LM main path through the port's ``lm_cli``: GPT-2-small at full
    width (12 layers, d 768, 12 heads, vocab 50304, T 1024, batch 16, RoPE,
    bf16, AdamW, ``--attention-impl flash --fused-xent``), 24 steps and one
    eval batch (plain CE, as the JAX eval), every launch count zeroed just
    before and read just after (flash all on the tensor cores: 300
    forwards, 288 dq and 288 dk/dv, none on the FFMA route);
11. its throughput (``LMTrainer.train_step``, tokens/s and MFU) with flash
    and the fused cross-entropy, flash alone and dense attention,
    flash-vs-dense and fused-vs-plain cross-entropy trajectories (2 layers
    at full width, fp32, TF32 off), a profile of one step with and one
    without the fused cross-entropy, and flash's tensor-core route
    (forward and backward) against its FFMA route (2 layers at full width,
    batch 4, bf16, 4 AdamW steps, the plain versions printed beside as the
    yardstick); then 6 steps of GPT-2-small through ``lm_cli`` with Lion,
    a warmup-cosine schedule and the global-norm clip;
12. paged attention: the decode kernels (a block a 64-key span, then a
    merge kernel) against their plain version (the gather path) at
    the serving shape (16 slots, 12 query heads over 4 KV heads, D 64,
    page 16, ragged depths up to 511) in fp32, bf16 and int8 (under an
    fp32 and a bf16 query), at a ragged one (page 8, group 1, D 128, a
    slot at depth 0) and at the key spans' edge cases (depth 0, depths
    on and beside span boundaries, a page of 24, a narrowed table, groups
    1 and 16, D 32 and 128), every page a slot does not hold live written
    with NaN, two calls bitwise equal; then their times (bf16, and int8
    pages under a bf16 query, the variants serving runs) beside the bound,
    the gather path's and a gather plus
    ``scaled_dot_product_attention``'s;
13. the int8 weight matmul's two kernels (tensor cores for bf16 x, FFMA
    for fp32 x) against their plain version at the GPT-2-small head's
    decode ([16, 768] x [768, 50304]) and prompt-pass ([2048, 768])
    shapes and a ragged one ([77, 768] x [768, 50192]), bf16 x on both
    routes, each call's route shown by its launches; then both routes'
    times in turn (the tensor-core kernel must be the faster at the prompt
    pass) beside the bound, the plain version's and ``torch.matmul`` on
    the widened weight;
14. generation through ``lm_cli --generate 128``: GPT-2-small width with 4
    KV heads, batch 16, prompt 128, greedy, bf16, ``--int8-decode head``
    (one int8 matmul launch a model call: the prompt pass on the tensor
    cores, the decode steps on the route ``ops/quant.py::tc_route`` gives
    16 rows), then in bf16 alone (the share of greedy tokens the int8 head
    keeps) and with ``--int8-kv-cache``;
15. serving through ``serve_cli``: the same model, 16 slots over a
    513-page pool of 16 rows (32 pages a slot), 64 Poisson requests at 64
    rps, prompts and outputs 64-256 tokens, the paged kernels (12 calls a
    decode step, two launches a call); 16 requests of that distribution
    through the kernel and gather engines (the share of greedy tokens that
    agree); a pool-pressure run (97
    pages, int8 KV pages and the int8 head; 24 requests of the
    distribution) that must preempt; and a profile of 20 decode steps;
16. the fused grouped matmul (dropless MoE's expert FFN) against its plain
    version at the MoE path's prefill (M 4096) and decode (M 32) shapes,
    with group sizes from a real router's top-2 on random tokens, and at
    ragged shapes with empty groups, both activations, bf16 and fp32, each
    call on the route ``ops/gmm.py::fused_tc_route`` gives it and bf16 on
    both routes; both routes' times in turn beside the bound, the plain
    version's and ``torch._grouped_mm`` plus bias and gelu; one MoE layer's
    forward under ``torch.cuda.set_sync_debug_mode("error")`` (no host
    synchronisation);
17. MoE generation through ``lm_cli --generate 128``: the JAX package's
    MoE LM (``benchmarks/bench_vit_moe.py``: 6 layers, d 512, 8 heads, d_ff
    1024, 8 experts top-2, dropless, vocab 50304, RoPE, bf16), batch 16,
    prompt 128, greedy, 2 grouped-matmul launches a layer a model call
    (the prompt pass on the tensor cores, decode on the rule's route);
    prefill + 8 decode steps against the full forward; a profile of 5
    decode steps;
18. the grouped matmul's backward kernels against their plain versions at
    the MoE training path's shapes (lhs [32768, 512] against [8, 512,
    1024], and [32768, 1024] against [8, 1024, 512]; ragged group sizes
    with an empty group and router-drawn ones), fp32 and bf16, every call
    under ``torch.cuda.set_sync_debug_mode("error")`` with its launches
    exact: fp32 operands take the FFMA ``gmm`` (dlhs, rhs read transposed
    in place) and ``tgmm`` (drhs); bf16 ones the tensor-core ``gmm_tc`` and
    ``tgmm_tc`` (an fp32 dout in three bf16 pieces from ``split``, a bf16
    one in one), and the FFMA kernels on the same operands; ``split``
    bitwise against its plain version; ``colsum`` (dbias) and the forward
    with ``z`` (bf16 on both routes); then the path's four backward calls
    and the forward with ``z`` on both routes in turn, split and colsum,
    beside their bounds, the plain versions' and one PyTorch call's
    times;
19. MoE training through ``lm_cli``: the JAX package's
    ``moe_e8_top2_dropless_pallas`` (``benchmarks/bench_vit_moe.py``) at
    full width, batch 32 x T 512, flash, bf16, AdamW, 8 steps and one eval
    batch, every launch count exact (a step: 12 ``gmm_fused`` on the
    tensor cores, of which the 6 ``w_in`` calls write ``z``, 12 ``gmm_tc``,
    12 ``tgmm_tc``, 6
    ``split``, 12 ``colsum``, no FFMA ``gmm`` or ``tgmm``, and 18 flash,
    all on the tensor cores);
    its throughput, one step under ``set_sync_debug_mode("error")`` and a
    profile of 2 steps; a kernel-vs-plain trajectory (2 layers at full
    width, batch 8, fp32, 4 steps); the tensor-core routes against the FFMA
    routes, forward and backward (the same, in bf16, with the plain
    versions as a yardstick); and
    3 steps with the capacity-slot ``scatter`` dispatch (no grouped-matmul
    kernel);
20. the CIFAR Trainer's run loop: a seeded CIFAR-10-sized binary tree
    (50,000 + 10,000 records) read through the port in strict mode,
    bitwise against a numpy decode, the native decoder and gather built
    and used, their times against numpy at batch 256 and 4096; then
    through ``cli.main``, ResNet-18 fp32, part 2b (NCCL at a world of
    one), batch 256, ``--fused-optimizer``, one epoch (195 steps) with
    cuDNN deterministic: checkpoints every 50 steps, the metric stream,
    a profiler window over steps 10-14, the watchdog at 120 s, prefetch
    depth 2 (one fused-SGD launch a step, every batch gathered
    natively); again with a NaN injected once at step 120 and
    ``--max-restarts 1`` (restored from the disk checkpoint of step 100),
    and with ``--snapshot-every 50`` and no checkpoint directory
    (restored from host RAM, no file read): both bitwise equal to the
    first run in every parameter, momentum and BatchNorm buffer;
    ``--eval-only`` on the first run's checkpoints equal to its last
    eval; the trace holding the fused SGD kernel; the watchdog never
    firing; ``avg_batch_time_s`` at prefetch depth 0 and 2 in turns; a
    checkpoint's blocking, durable, read and copy-back times;
21. the phase profiler on the CIFAR Trainer (``obs/phases.py``) through
    the port's ``bench.py``: ``--phase-breakdown`` with its defaults
    (ResNet-18, bf16, DDP, batch 4096, NCCL at a world of one), then over
    the overlapped allreduce and the overlapped int8 wire, each with
    ``parity_ok``; ``python -m ...obs report`` on the written
    ``phase_report.json`` printing the table the bench printed;
    ``profile_phases`` on ResNet-18 fp32 batch 256 ``fast_conv`` (each
    segment's launches in one call exact: 6 tensor-core wgrads in the
    grads and fused segments, none in forward or the optimizer);
    ``device_op_breakdown`` of its fused step; ``--sync-compare``'s four
    bench records and its two pure data-parallel phase pairs (zero1's
    pair raises at one rank, as in JAX);
22. ``profile_lm_phases`` on GPT-2-small at full width (bf16, flash,
    ``fused_xent``) and on the MoE LM ``moe_e8_top2_dropless_pallas``,
    each with ``parity_ok`` and each segment's flash, fused
    cross-entropy and grouped-matmul launches in one call exact;
23. the LM run loop through ``lm_cli`` on GPT-2-small, 20 steps:
    checkpoints every 10, the metric stream, a profiler window whose
    trace holds the flash kernels, the watchdog; again with a NaN at step
    15 and ``--max-restarts 1`` (disk tier) and with ``--snapshot-every
    10`` (memory tier, no file read), both bitwise equal to the first run
    in every parameter and AdamW moment, every launch count exact; a
    checkpoint's blocking, durable, read and copy-back times (1.95 GB);
24. the LM training options on GPT-2-small at full width (bf16, flash,
    ``fused_xent``, AdamW, batch 16 x T 1024), 4 steps a run from one
    initial state: the baseline, remat ``none`` and ``dots``,
    ``scan_layers``, ``accum_steps=2``, dropout 0.1 alone and with remat;
    every launch count exact (remat runs the flash forward again in the
    backward; accumulation doubles every count); losses and parameters
    against the baseline, dropout with remat against dropout alone
    (first-step gradients); each run's step ms and peak memory;
25. beam search at GPT-2-small width (4 KV heads, bf16), batch 2, 4 beams,
    a 64-token prompt, 32 new tokens: beam 1 bitwise greedy, the score
    against a teacher-forced re-score, 32 int8 launches under the int8
    head, ms a beam step on the host and the device beside greedy
    decoding of the same 8 rows;
26. speculative decoding through ``lm_cli`` (``--speculative-k 4
    --draft-layers 1 --generate 128``, target and draft each trained 24
    steps, exact launch counts), greedy and at ``--temperature 0.8``:
    target calls, accept rate, tokens/s against plain greedy on the same
    weights and the tokens that agree with it; the target as its own
    draft in fp32 equal to plain greedy, every round accepting all 4;
27. the LM across ranks through ``lm_cli`` on NCCL at a world of one
    (``--num-processes 1``): GPT-2-small at full width (bf16, flash,
    ``fused_xent``, batch 16 x T 1024), 4 steps and one eval batch each,
    AdamW as the yardstick, ``--zero1`` and ``--fsdp`` alone and with
    ``--sync-overlap bucket``, AdamW and ``--zero1`` with the clip and
    ``warmup_cosine``, sgd plain and ``--sync-overlap bucket`` (one
    fused-SGD launch a bucket a step), ``--grad-compress int8`` (AdamW),
    sgd ``--sync-overlap bucket+int8`` and ``--zero1 --grad-compress int8
    --sync-overlap bucket+int8``, and the MoE LM (dropless) with AdamW and
    under ``--fsdp``: every collective counted against the schedule of the
    port's own bucket count (copies at a world of one), every launch
    exact, step ms and peak memory beside the yardstick's, and losses and
    parameters after 3 steps bitwise the yardstick's where the arithmetic
    is the same, else within a stated bound; then ``profile_lm_phases``
    on the all-reduce path, its sync segment present and traced. NCCL
    refuses two ranks on one card, so world > 1 rests on the Gloo tests
    (``tests/test_torch_port_lm_dp4.py``, ``..._zero_lm.py``);
28. the sequence axis's hops on the card (``seq_tensor_phase``): at
    GPT-2-small's heads (12, D 64, bf16, B 2) a 4,096-token sequence cut
    into n = 4 positions of 1,024, the ring flash attention's hop
    functions (``parallel/ring_attention.py``: ``rfa_merge``, ``rfa_dq``,
    ``rfa_dkv``, every position in the order a ring delivers its blocks)
    on the flash kernels, causal and not: each output and gradient
    against the same hops on the plain versions (the flash phase's bound,
    2e-2 x max|plain|) and against the flash kernels over the whole
    sequence (a bound from the hops' bf16 roundings, stated beside it);
    the tensor-core launches n(n+1)/2 = 10 (causal) or n^2 = 16 of each
    kernel, none masked, none on FFMA; Ulysses's inner calls (4 head
    groups of 3 heads over the whole sequence) likewise; the ring's
    summed device ms forward and backward beside the whole-sequence
    kernels' and their bounds. The trainer across these axes runs only
    on the Gloo tests (``tests/test_torch_port_lm_axes4.py``): NCCL
    refuses two ranks on one card;
29. tensor-parallel decode and serving (``tp_serving_phase``): GPT-2-small's
    decode width (12 layers, d 768, 12 heads over 4 KV heads, bf16, RoPE)
    at tensor 4, four rank processes of ``scripts/tp_serve_ranks.py`` on
    this card joined through shared memory (``HostMemoryGroup``: NCCL
    refuses two ranks on one card; Gloo's TCP costs 6.6-13.7 ms a sum on
    this host), each with its ``LMTrainer.tp_decode_model()`` slices: the
    first 16 requests
    of the serving trace submitted at once on 16 slots, 513 pages of 16,
    with bf16 pools and then int8 pools, then greedy ``make_generator``
    (batch 4, prompt 64, 32 new) and beam search (2 x 4 beams, 16 new);
    meanwhile this process runs the same on one rank with the whole
    weights. Each rank's pools [513, 16, 1, 64], its paged launches 2 x 12
    a decode step and no call of the plain version, the four ranks'
    tokens and logits identical, the first decode step's logits within
    ``TP_LOGIT_BOUND`` x max|logit| of the one rank's; the greedy tokens'
    agreement with the one rank's reported. The scripts/tp_serve_cards.sh
    run serves the same across 4 cards over NCCL;
30. the ViT family through the CIFAR ``Trainer`` (``vit_phase``; the JAX
    bench's runs, ``benchmarks/bench_vit_moe.py``): vit_tiny at batch 1024,
    vit_small at 512 and vit_wide_p8 at 1024, bf16, ``vit_attention=
    "flash"``, ``sync="ring"`` on NCCL at a world of one, synthetic CIFAR,
    3 warm-up and 10 timed steps: one tensor-core flash forward, dq and
    dk/dv a layer a step (T 65 and 17, not causal; head_dim 64 and 128),
    nothing on FFMA, no plain call; the losses finite and falling; ms a
    step, samples/s and MFU beside the card; then ``cli.main`` on
    vit_tiny ``--dropout 0.1`` (dense) for 8 steps. The flash phase (8)
    holds the kernels against their plain versions at these shapes;
31. the grouped matmul past 64 experts (``gmm_groups_phase``): at
    Qwen3-30B-A3B's MoE widths (d 2048, expert d_ff 768, 4,096 tokens x
    top-8) in bf16 on the tensor cores, and in fp32 on FFMA at a reduced
    size, at E 65, 128 and 256 with some experts empty, the forward (with
    and without ``z``), ``gmm``, ``tgmm`` and ``colsum`` against their
    plain versions, each call's launches exact and no host
    synchronisation; the forward's and dlhs's times at E 128;
32. training that survives losing a rank (``elastic_phase``): the port's
    ``launch`` with 4 CPU workers (Gloo) on the card's host, the
    coordinator SIGKILLed at step 3 and rank 2 a 100 ms straggler (two
    generations, rank 1 re-elected, ``fleet_check`` clean, rank 2 named,
    the losses an uninterrupted 3-worker run's at rtol 1e-6; the seconds
    to the survivors' exits and to the first resumed step); ResNet-18
    written by 4 CPU ranks and the LM (GPT-2-small's width, 2 layers,
    zero1) by 3, each restored on the card at a world of one through
    ``elastic_state`` (every file read; BatchNorm buffers, parameters,
    momentum and the re-chunked AdamW rows checked bit for bit) and
    trained 10 and 4 steps through the fused SGD, tensor-core wgrad,
    flash and fused cross-entropy kernels (launches exact), the losses
    within a bound set from the CPU states' largest difference
    (``ELASTIC_GAIN``) of the same steps from a world-1-written state;
33. the pipe axis (``pipeline_phase``): GPT-2-small at full width (RoPE,
    bf16, flash, AdamW) on 4 pipeline stages run in lockstep in this
    process (``parallel/pipeline.py::simulate_train_step``), 4
    microbatches of 2 sequences, 2 steps each on GPipe, 1F1B with the
    distributed tail and the interleaved schedule (V 3), from the weights
    of a pipe-1 ``LMTrainer`` trained on the same batches: every step's
    loss within ``PIPE_LOSS_RTOL`` (2e-2) of its, the flash launches
    exact on the tensor cores (96 forwards, dq and dk/dv; 192 forwards
    under 1F1B's recompute), none on FFMA, no plain call, the hops the
    schedule's (14, 14, 30 a step); each schedule's and the pipe-1 step
    timed (events and kernels); the MoE LM (dropless) on 2 stages, one
    GPipe step, its grouped-matmul launches exact; and a GPT-2-small
    state dict with HF's key names (drawn from a seed) converted by
    ``models/hf_interop.py``: one bf16 forward on the flash kernels
    within ``HF_LOGIT_TOL`` x max|logit| of the plain path;
34. the analysis package (``analysis_phase``): the port's linter over its
    package (exit 0 against ``analysis/graftlint_baseline.json``), then
    each of the nine registered trace entries built on the card (NCCL, a
    world of one), one step recorded under the dispatch mode and audited
    by TA001-TA010: no finding, the memory ledger within the card's
    section of ``analysis/memory_budget.json``, and the kernel paths at
    the main path's widths (the four CIFAR entries: ResNet-18 at batch
    256 with ``RESNET18_ROUTED`` tensor-core wgrads, ``cifar`` one
    fused-SGD launch too and ``cifar-overlap`` one a bucket; the three LM
    entries: GPT-2-small at 8 x 1024 in bf16, flash on the tensor cores
    and one fused cross-entropy forward and backward, ``lm-overlap``'s
    SGD a fused launch a bucket; ``lm-serve-paged``: GPT-2-small decode through
    the paged kernel, ``lm-serve`` none);
35. the H-pair-packed 3x3 conv forward (``conv_fwd_hpair_phase``; the TPU
    probe ``benchmarks/probe_fwd_hpair.py``): the kernel against its plain
    version at the probe's [4096, 32, 32, 64] bf16 and at B 3 and H 2,
    with ``pack_weights`` of a seeded HWIO weight and with a seeded random
    ``w_packed`` (2 bf16 ulps + 1e-5 x max|plain| an element, at most 0.1 %
    of elements differing), a refused C's ``ValueError``, the kernel against
    cuDNN's bf16 conv (the probe's 5e-2), every call's launch counted; its
    time, the plain version's and cuDNN's ``F.conv2d`` on the same x (a
    channels-last view) beside both bounds; then the probe's entry point,
    ``python -m ...ops.conv_fwd_hpair``'s ``main``, its launches counted.

Each phase prints its wall seconds as it ends, and the line before the
kernels JSON gives the whole run's and each phase's.

The last lines are the kernels JSON, the card's name and power limit, and
``{"ok": true, "device": {...}}``.
"""

from __future__ import annotations

import contextlib
import io
import json
import math
import statistics
import subprocess
import sys
import time

import torch

STEPS = 24  # main paths: 6144 synthetic images / global batch 256
NCCL_STEPS = 5
BF16_STEPS = 5
RAGGED_SHAPES = [(1,), (7,), (1000,), (3, 5, 7)]
LR, MU, WD = 0.1, 0.9, 1e-4
VGG11_TENSORS, RESNET18_TENSORS, RESNET18_ROUTED = 34, 62, 6
TF32_FLOPS = 495e12  # H100 SXM dense TF32 tensor-core peak
BF16_FLOPS = 989e12  # H100 SXM dense BF16 tensor-core peak

# conv3x3_wgrad shapes: (x shape, K). ResNet-18 at batch 256: the routed
# stride-1 convs (3 of each a step) and the stride-2 3x3 convs; ragged
# shapes where B, C, K and H, W are not multiples of the kernel's tiles.
WGRAD_S1 = [((256, 128, 16, 16), 128), ((256, 256, 8, 8), 256)]
WGRAD_S2 = [((256, 64, 32, 32), 128), ((256, 128, 16, 16), 256)]
WGRAD_RAGGED = [((3, 3, 8, 8), 10), ((5, 20, 6, 6), 7)]
WGRAD_RTOL = 1e-4  # max abs err <= WGRAD_RTOL * max|plain|
ROUTED_PER_SHAPE = 3

# Flash attention: (B, T, H, D, causal). The LM path's shape first.
FLASH_PATH = (16, 1024, 12, 64, True)
# The ViT path's shapes, not causal: vit_tiny's and vit_small's 65 tokens
# (64 patches and the class token), vit_wide_p8's 17 at head_dim 128.
VIT_FLASH_CASES = [(1024, 65, 3, 64, False), (512, 65, 6, 64, False), (1024, 17, 3, 128, False)]
FLASH_CASES = [FLASH_PATH, (4, 512, 12, 64, False), (1, 200, 3, 64, True),
               (2, 77, 2, 128, True), *VIT_FLASH_CASES]
FLASH_TOL = {torch.float32: 1e-4, torch.bfloat16: 2e-2}  # x max|plain|
FLASH_LSE_TOL = 1e-5
FLASH_REPLACES = {"fwd": 47, "dq": 177, "dkv": 222}

# The LM main path: the JAX package's GPT-2-small bench shape
# (benchmarks/bench_lm_gpt2.py), batch 16, 24 steps.
LM_STEPS = 24
LM_WIDTH = dict(num_layers=12, d_model=768, num_heads=12, d_ff=3072, vocab_size=50304,
                max_seq_len=1024, seq_len=1024)
LM_PARAMS, LM_TENSORS = 162_286_080, 148
LM_TIMED_STEPS = 10
LM_ROUTE_STEPS, LM_ROUTE_LR = 4, 1e-3  # the flash backward's route-vs-route trajectory

# The inference slice: the JAX package's GPT-2-small decode shape
# (benchmarks/bench_generate.py), 4 KV heads (GQA, group 3).
DECODE_WIDTH = dict(num_layers=12, d_model=768, num_heads=12, num_kv_heads=4, d_ff=3072,
                    vocab_size=50304, max_seq_len=1024)
GEN_BATCH, GEN_PROMPT, GEN_NEW = 16, 128, 128
SERVE_GEOMETRY = dict(num_slots=16, page_size=16, num_pages=513, max_pages_per_slot=32)
PRESSURE_PAGES = 97  # 96 allocatable pages for 16 slots of up to 32 pages
PRESSURE_REQUESTS = 24  # the pool-pressure run's trace, cut for the script's time limit
PROFILE_PROMPT, PROFILE_BUDGET = 128, 64
SERVE_TRACE = dict(num_requests=64, rate_rps=64.0, prompt_len=(64, 256), output_len=(64, 256),
                   seed=0)
# The serving tracer, guard and failure phases: overload at 3x the trace's
# rate under deadlines, a bounded queue and degrade; decode faults and a
# hung step on the pool-pressure geometry, its trace cut to CHAOS_REQUESTS.
# The kernel-vs-gather engine comparison serves a trace of this many
# requests (of SERVE_TRACE's distribution), cut from 64 to keep the whole
# script inside its time limit on a loaded host.
SERVE_COMPARE_REQUESTS = 16
OVERLOAD_RPS = 3 * SERVE_TRACE["rate_rps"]
OVERLOAD_FLAGS = ["--deadline-s", "30", "--max-queue-depth", "16", "--shed-policy", "degrade"]
# 217 pages of work for 96 (it preempts), outputs up to 193 (past both faults)
CHAOS_REQUESTS = 12
SERVE_CHAOS = "40:decode_nan,90:engine_crash"
# The hung step: the watchdog's ladder (warn, dump, abort) climbs a rung
# each section past the timeout, so the stall (1.2 s) aborts by 0.9 s; a
# false abort needs a fault-free step past 0.9 s or three past 0.3 s on one
# engine. Admission steps of the 16-request trace take 100-350 ms (a
# rebuilt engine's first step re-admits every request), so the hung step
# runs on the trace's first HUNG_REQUESTS requests, whose fault-free steps
# still reach 150-240 ms, three of them past 0.1 s in one run: too close
# to a 0.1 s timeout, far from 0.3 s.
SLOW_CHAOS, SLOW_STEP_TIMEOUT_S, SLOW_STALL_S, HUNG_REQUESTS = "60:slow_step", 0.3, 1.2, 4
SERVE_RUNS: dict = {}  # the serving phase's untraced run, for the tracer's cost
# Paged attention: (B, Hq, Hkv, D, page_size, pages a slot[, pos,
# pages_per_slot]); without pos, ragged depths with slot 0 at depth 0. The
# serving shape first, then a rank's share of it at tensor 4 (3 q heads
# over its 1 KV head, phase 29's); then the key spans' edge cases: depth 0
# everywhere, depths on and beside the 64-key span boundaries, a page of 24
# (no divisor of the span), a table narrowed to 5 of its 8 pages, groups 1
# and 16, D 32 and 128.
PAGED_SERVE = (16, 12, 4, 64, 16, 32)
PAGED_TP_SERVE = (16, 3, 1, 64, 16, 32)
PAGED_CASES = [PAGED_SERVE, PAGED_TP_SERVE, (5, 2, 2, 128, 8, 7),
               (4, 12, 4, 64, 16, 32, [0, 0, 0, 0], None),
               (6, 12, 4, 64, 16, 32, [63, 64, 65, 127, 128, 129], None),
               (3, 4, 2, 64, 24, 8, [47, 100, 191], None),
               (3, 6, 2, 64, 16, 8, [10, 70, 79], 5),
               (3, 2, 2, 32, 8, 20, [5, 64, 159], None),
               (2, 16, 1, 128, 16, 10, [0, 159], None)]
# name: (pool dtype, q dtype). int8_bf16q is the variant serving runs:
# bf16 compute over int8 pages, the output in bf16.
PAGED_VARIANTS = {"float32": (torch.float32, torch.float32),
                  "bfloat16": (torch.bfloat16, torch.bfloat16),
                  "int8": (torch.int8, torch.float32),
                  "int8_bf16q": (torch.int8, torch.bfloat16)}
PAGED_FP32_TOL = 2e-5  # max abs err of fp32 outputs
# The GPT-2-small head's decode step and prompt pass, and a ragged shape the
# tensor-core rule still takes (M not a multiple of 64, N a multiple of 16
# but not of 128).
INT8_SHAPES = {"decode": (GEN_BATCH, 768, 50304), "prefill": (GEN_BATCH * GEN_PROMPT, 768, 50304),
               "ragged": (77, 768, 50192)}

# Fused cross-entropy: (N, V, dtype). The LM path's logits first (B 16 x T
# 1024 rows, fp32: the model returns fp32 logits).
XENT_PATH = (16 * 1024, 50304)
XENT_CASES = [(*XENT_PATH, torch.float32), (*XENT_PATH, torch.bfloat16),
              (37, 50257, torch.float32), (37, 50257, torch.bfloat16)]
XENT_TOL = 1e-5  # loss and lse: x max(1, |plain lse|) a row

# The MoE LM of the JAX package's benchmarks/bench_vit_moe.py (bench_moe:
# 6 layers, d 512, 8 heads, vocab 50304, d_ff 1024, E 8, top-2, RoPE, bf16),
# dropless, max_seq_len 512; generation at batch 16, prompt 128, 128 new.
MOE_WIDTH = dict(num_layers=6, d_model=512, num_heads=8, d_ff=1024, vocab_size=50304,
                 max_seq_len=512)
MOE_EXPERTS, MOE_TOP_K = 8, 2
MOE_DECODE_STEPS = 8  # prefill + this many decode steps vs the full forward
MOE_LOGIT_RTOL = 2e-2  # rms(decode - full) / rms(full), bf16
GMM_RAGGED = (1000, 100, 70, [0, 300, 0, 250, 0, 0, 450, 0])  # M, K, N, group sizes
# The same groups at widths of 16-byte rows (the tensor cores take it).
GMM_RAGGED_TC = (1000, 96, 72, [0, 300, 0, 250, 0, 0, 450, 0])
# MoE training (the JAX bench's moe_e8_top2_dropless_pallas): batch 32 x T 512,
# 32768 routed rows a layer. Ragged group sizes for the backward's kernels: an
# empty group, boundaries off the 64-row tiles, summing to 32768.
MOE_TRAIN_BATCH, MOE_TRAIN_STEPS, MOE_TIMED_STEPS = 32, 8, 5
GMM_TRAIN_RAGGED = [4100, 0, 5000, 3333, 6000, 4444, 5555, 4336]
MOE_TRAJ_STEPS, MOE_TRAJ_LR = 4, 1e-3


def card_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60,
    )
    return out.stdout.strip().splitlines()[0]


def card_rates(name: str) -> tuple[float, float]:
    """(device-memory bytes/s, fp32 non-tensor-core FLOP/s) from the
    published data sheets: H100 SXM 3.35 TB/s and 67 TFLOP/s, H100 PCIe
    2.0 TB/s and 51 TFLOP/s, H200 4.8 TB/s and 67 TFLOP/s."""
    if "H200" in name:
        return 4.8e12, 67e12
    if "PCIe" in name:
        return 2.0e12, 51e12
    return 3.35e12, 67e12


def median_ms(fn, reps: int = 30, warmup: int = 5) -> float:
    """Median over ``reps`` runs of ``fn``, each fenced by CUDA events."""
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(reps):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end))
    return statistics.median(times)


def device_kernels(prof) -> list:
    """The kernels of a torch.profiler trace: its device events, less the
    user annotations (``record_function`` spans such as torch.optim's
    ``Optimizer.step``) that the profiler also lays on the device
    timeline and that would count their kernels twice."""
    from torch.autograd import DeviceType

    return [e for e in prof.events() if e.device_type == DeviceType.CUDA
            and not getattr(e, "is_user_annotation", False)]


def device_busy_ms(fn, reps: int = 10, match: str | None = None,
                   attempts: int = 3) -> float | None:
    """Kernel time on the card per call of ``fn`` (the sum of its kernels'
    durations from a torch.profiler trace, only those whose name holds
    ``match`` if given), without the host's launch gaps; None when the
    profiler records no device activity in ``attempts`` traces (a trace
    now and then comes back empty)."""
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    for _ in range(attempts):
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            for _ in range(reps):
                fn()
            torch.cuda.synchronize()
        total_us = sum(
            e.time_range.elapsed_us()
            for e in device_kernels(prof)
            if match is None or match in e.name
        )
        if total_us:
            return total_us / reps / 1e3
    return None


def kernel_breakdown(fn, reps: int = 10) -> dict[str, float]:
    """Device ms per call of ``fn`` by kernel (the name cut at its template
    arguments), from a torch.profiler trace of ``reps`` calls; empty when
    the profiler records no device activity."""
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(reps):
            fn()
        torch.cuda.synchronize()
    out: dict[str, float] = {}
    for e in device_kernels(prof):
        name = e.name.replace("(anonymous namespace)::", "").replace("void ", "")
        name = name.split("<")[0].split("(")[0].split("::")[-1]
        out[name] = out.get(name, 0.0) + e.time_range.elapsed_us() / reps / 1e3
    return out


def summarize_profile(prof, steps: int, label: str, groups: dict[str, tuple[str, ...]]) -> dict:
    """Where ``steps`` steps' device time went in a torch.profiler trace:
    kernel time a step (busy), first kernel start to last kernel end
    (span), idle share 1 - busy / span, the ms a step of each group of
    kernels (those whose name holds one of its strings) and the top 12
    kernels. Empty when the profiler recorded no device activity."""
    kernels = device_kernels(prof)
    if not kernels:
        print(f"{label}: torch.profiler recorded no device activity")
        return {}
    busy = sum(e.time_range.elapsed_us() for e in kernels)
    span = max(e.time_range.end for e in kernels) - min(e.time_range.start for e in kernels)
    by_name: dict[str, float] = {}
    for e in kernels:
        by_name[e.name] = by_name.get(e.name, 0.0) + e.time_range.elapsed_us()
    top = sorted(by_name.items(), key=lambda kv: -kv[1])[:12]
    return {
        "steps": steps,
        "device_busy_ms_per_step": busy / steps / 1e3,
        "span_ms_per_step": span / steps / 1e3,
        "idle_share": 1.0 - busy / span,
        "kernels_per_step": len(kernels) / steps,
        **{f"{group}_ms_per_step": sum(v for k, v in by_name.items() if any(s in k for s in keys))
           / steps / 1e3 for group, keys in groups.items()},
        "top_kernels_ms_per_step": {k[:90]: v / steps / 1e3 for k, v in top},
    }


@contextlib.contextmanager
def patched(module, **attrs):
    """``module``'s attributes set to ``attrs`` for the block, then
    restored: a route rule or a kernel function swapped for a comparison."""
    saved = {name: getattr(module, name) for name in attrs}
    for name, value in attrs.items():
        setattr(module, name, value)
    try:
        yield
    finally:
        for name, value in saved.items():
            setattr(module, name, value)


def kernel_modules():
    from cs744_pytorch_distributed_tutorial_tpu_torch.ops import flash_attention as A
    from cs744_pytorch_distributed_tutorial_tpu_torch.ops import fused_conv as C
    from cs744_pytorch_distributed_tutorial_tpu_torch.ops import fused_sgd as K
    from cs744_pytorch_distributed_tutorial_tpu_torch.ops import fused_xent as FX
    from cs744_pytorch_distributed_tutorial_tpu_torch.ops import gmm as G
    from cs744_pytorch_distributed_tutorial_tpu_torch.ops import paged_attention as PA
    from cs744_pytorch_distributed_tutorial_tpu_torch.ops import quant as QT
    from cs744_pytorch_distributed_tutorial_tpu_torch.ops import conv_fwd_hpair as HP

    return {"fused_sgd": K, "conv3x3_wgrad": C, "flash": A, "paged_attention": PA,
            "int8_matmul": QT, "fused_xent": FX, "gmm_fused": G, "conv3x3_fwd_hpair": HP}


def others(counts: dict, *allowed: str) -> dict:
    """The launch counts of ``counted`` other than ``allowed`` that are
    not zero."""
    return {k: n for k, n in counts.items() if n and k not in allowed}


def counted(fn):
    """``fn()`` with every kernel's launch count zeroed just before and
    read just after: (result, counts)."""
    mods = kernel_modules()
    for mod in mods.values():
        mod.reset_launch_count()
    torch.cuda.synchronize()
    out = fn()
    torch.cuda.synchronize()
    counts = {name: mod.launch_count() for name, mod in mods.items()}
    counts["paged_attention_int8"] = mods["paged_attention"].launch_count("int8")
    counts["int8_matmul_tc"] = mods["int8_matmul"].launch_count(route="tc")
    return out, counts


def run_cli(argv: list[str], main=None) -> dict:
    from cs744_pytorch_distributed_tutorial_tpu_torch import cli

    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        rc = (main or cli.main)(argv)
    text = buf.getvalue()
    print(text, end="")
    if rc != 0:
        raise RuntimeError(f"cli.main returned {rc}")
    return json.loads(text.strip().splitlines()[-1])


#: Wall seconds of each phase that ``main`` calls (``clock_phases``).
PHASE_SECONDS: dict[str, float] = {}
_phase_depth = [0]


def clock_phases() -> None:
    """Wrap every ``*_phase`` function of this script so that each call
    prints its wall seconds as it ends; the calls ``main`` makes (not
    those one phase makes of another) add theirs to ``PHASE_SECONDS``."""
    for name, fn in list(globals().items()):
        if name.endswith("_phase") and callable(fn):
            globals()[name] = _clocked(name, fn)


def _clocked(name: str, fn):
    def run(*args, **kwargs):
        t = time.perf_counter()
        _phase_depth[0] += 1
        try:
            return fn(*args, **kwargs)
        finally:
            _phase_depth[0] -= 1
            sec = time.perf_counter() - t
            if _phase_depth[0] == 0:
                PHASE_SECONDS[name] = PHASE_SECONDS.get(name, 0.0) + sec
            print(f"phase {name}: {sec:.1f} s", flush=True)
    return run


def randn(gen: torch.Generator, *shape, dtype=torch.float32) -> torch.Tensor:
    return torch.randn(shape, generator=gen, device=gen.device).to(dtype)


# --------------------------------------------------------------- fused SGD
def fused_sgd_phase(dev: torch.device) -> dict:
    """The multi-tensor kernel bitwise against the plain update, 3 steps,
    over three lists: ResNet-18's 62 shapes, VGG-11's 34 (one launch a
    step each), and one list of a tensor one float off its 16-byte
    alignment, both models' shapes and RAGGED_SHAPES (more tensors and
    chunks than one launch holds); each call's launches as the C entry
    point reports them (1, 1 and 2). Then a whole update of each model four
    ways, host-fenced and on the device: the multi-tensor call, a loop of
    one-tensor lists, plain, ``SGD(fused=True)``."""
    from cs744_pytorch_distributed_tutorial_tpu_torch.models import resnet18, vgg11
    from cs744_pytorch_distributed_tutorial_tpu_torch.ops import fused_sgd as K

    shapes = {
        "resnet18": [tuple(p.shape) for p in resnet18().parameters()],
        "vgg11": [tuple(p.shape) for p in vgg11().parameters()],
    }
    if len(shapes["resnet18"]) != RESNET18_TENSORS or len(shapes["vgg11"]) != VGG11_TENSORS:
        raise RuntimeError(f"unexpected parameter counts: {[len(v) for v in shapes.values()]}")
    gen = torch.Generator(device=dev).manual_seed(0)

    # label: (shapes, offset of tensor 0 in floats, launches a call)
    lists = {"resnet18": (shapes["resnet18"], 0, 1), "vgg11": (shapes["vgg11"], 0, 1),
             "over_capacity": ([(1000,)] + shapes["resnet18"] + shapes["vgg11"] + RAGGED_SHAPES,
                               1, 2)}
    launches, max_err = {}, 0.0
    for label, (list_shapes, offset, want) in lists.items():
        params = [randn(gen, *s) for s in list_shapes]
        moms = [0.1 * randn(gen, *s) for s in list_shapes]
        if offset:  # tensor 0 one float into its storage: its blocks take the scalar path
            n = math.prod(list_shapes[0])
            params[0] = torch.empty(n + offset, device=dev)[offset:].copy_(params[0])
            if params[0].data_ptr() % 16 == 0:
                raise RuntimeError("the misaligned tensor is 16-byte aligned")
        pp, mp = [p.clone() for p in params], [m.clone() for m in moms]
        K.reset_launch_count()
        for _ in range(3):
            grads = [randn(gen, *s) for s in list_shapes]
            K.fused_sgd_multi_(params, moms, grads, lr=LR, mu=MU, wd=WD)
            for p, m, g in zip(pp, mp, grads):
                K.fused_sgd_plain(p, m, g, lr=LR, mu=MU, wd=WD)
        torch.cuda.synchronize()
        launches[label] = K.launch_count() / 3
        if K.launch_count() != 3 * want:
            raise RuntimeError(f"fused_sgd {label}: {K.launch_count()} launches in 3 calls, "
                               f"expected {3 * want}")
        for i, (got, ref) in enumerate(zip(params + moms, pp + mp)):
            if got.numel():
                max_err = max(max_err, float((got - ref).abs().max()))
            if not torch.equal(got, ref):
                raise RuntimeError(
                    f"fused_sgd kernel differs from its plain version in list {label} at "
                    f"tensor {i % len(list_shapes)} {list_shapes[i % len(list_shapes)]}: max abs "
                    f"err {float((got - ref).abs().max())}")
    print(f"fused_sgd: lists {({k: len(v[0]) for k, v in lists.items()})} x 3 steps bitwise "
          f"equal to the plain update (the last led by a misaligned tensor); launches a call "
          f"{launches}")

    bw, flops = card_rates(torch.cuda.get_device_name(0))
    timed = {}
    for model, model_shapes in shapes.items():
        params = [randn(gen, *s) for s in model_shapes]
        moms = [torch.zeros_like(p) for p in params]
        grads = [randn(gen, *s) for s in model_shapes]

        def multi_update():
            K.fused_sgd_multi_(params, moms, grads, lr=LR, mu=MU, wd=WD)

        def loop_update():
            for p, m, g in zip(params, moms, grads):
                K.fused_sgd_multi_([p], [m], [g], lr=LR, mu=MU, wd=WD)

        def plain_update():
            for p, m, g in zip(params, moms, grads):
                K.fused_sgd_plain(p, m, g, lr=LR, mu=MU, wd=WD)

        lib_params = [torch.nn.Parameter(p.clone()) for p in params]
        for p, g in zip(lib_params, grads):
            p.grad = g.clone()
        lib_opt = torch.optim.SGD(lib_params, lr=LR, momentum=MU, weight_decay=WD, fused=True)

        n = sum(math.prod(s) for s in model_shapes)
        bytes_ms = 20.0 * n / bw * 1e3  # read p, m, g; write p, m (fp32)
        ops_ms = 6.0 * n / flops * 1e3  # 3 multiplies + 3 adds per element
        K.reset_launch_count()
        multi_update()
        per_update = K.launch_count()
        t = {
            "ms": median_ms(multi_update),
            "loop_ms": median_ms(loop_update),
            "plain_ms": median_ms(plain_update),
            "library_ms": median_ms(lib_opt.step),
            "device_ms": device_busy_ms(multi_update),
            "loop_device_ms": device_busy_ms(loop_update),
            "plain_device_ms": device_busy_ms(plain_update),
            "library_device_ms": device_busy_ms(lib_opt.step),
            "bound_ms": max(bytes_ms, ops_ms),
            "bound_by": "bytes" if bytes_ms >= ops_ms else "operations",
            "elements": n,
            "tensors": len(model_shapes),
            "launches_per_update": per_update,
            "loop_launches_per_update": len(model_shapes),
        }
        t["bound_share"] = t["bound_ms"] / t["ms"]
        if t["device_ms"]:
            t["bound_share_device"] = t["bound_ms"] / t["device_ms"]
        timed[model] = t
        print(f"fused_sgd: {model} update of {n} elements in {len(model_shapes)} tensors "
              f"({20 * n / 1e6:.1f} MB): multi-tensor {t['ms']:.4f} ms ({per_update} launch), "
              f"per-tensor loop {t['loop_ms']:.4f} ms ({len(model_shapes)} launches), plain "
              f"{t['plain_ms']:.4f} ms, torch.optim.SGD(fused=True) {t['library_ms']:.4f} ms, "
              f"bound {t['bound_ms']:.4f} ms; device busy per update (profiler): multi-tensor "
              f"{t['device_ms']}, loop {t['loop_device_ms']}, plain {t['plain_device_ms']}, "
              f"library {t['library_device_ms']} ms")
    # The record carries this slice's main path (ResNet-18); VGG-11 beside it.
    return {
        "name": "fused_sgd",
        "route": "cuda",
        "source": "cs744_pytorch_distributed_tutorial_tpu_torch/csrc/fused_sgd.cu",
        "replaces": "cs744_pytorch_distributed_tutorial_tpu/ops/fused_sgd.py:46",
        "tpu_kernel": "ops/fused_sgd.py::_kernel",
        "launches": None,  # filled in from the main path's run
        "max_abs_err": max_err,
        **timed["resnet18"],
        "work": "one whole ResNet-18 update (62 tensors, one launch)",
        "vgg11": timed["vgg11"],
        "launches_per_call_checked": launches,
    }


# ----------------------------------------------------------- conv wgrad
def wgrad_route(route: str):
    """conv3x3_wgrad on one route (``tc`` or ``ffma``) whatever the call
    (the route rule, patched for the block), for a route-vs-route
    comparison."""
    from cs744_pytorch_distributed_tutorial_tpu_torch.ops import fused_conv as C

    return patched(C, tc_route=lambda *args, **kw: route == "tc")


def wgrad_phase(dev: torch.device) -> list[dict]:
    """The kernels against the plain version at ResNet-18's routed (stride
    1) and stride-2 shapes at batch 256 and at ragged ones, fp32 and bf16:
    each call on the route ``tc_route`` gives it (6 x 6 images and the 4 x 4
    outputs of stride 2 take FFMA) and every call it gives the tensor cores
    again on the FFMA route,
    each call's route shown by its launches, within WGRAD_RTOL x max|plain|
    (each route's share of that limit printed); two tensor-core runs
    bitwise equal. Then the times of both routes in turn at the path's
    shapes (tensor cores, FFMA, FFMA, tensor cores: the mean of the two
    medians), fp32 and bf16, beside the bounds, the plain version's and
    cuDNN's. Returns the FFMA and tensor-core records of each stride."""
    import torch.nn.functional as F

    from cs744_pytorch_distributed_tutorial_tpu_torch.ops import _build
    from cs744_pytorch_distributed_tutorial_tpu_torch.ops import fused_conv as C

    gen = torch.Generator(device=dev).manual_seed(1)
    cases = [(s, shape, k) for s in (1, 2) for shape, k in WGRAD_RAGGED]
    cases += [(1, shape, k) for shape, k in WGRAD_S1] + [(2, shape, k) for shape, k in WGRAD_S2]
    keys = [(r, s) for r in C.ROUTES for s in (1, 2)]
    max_err = dict.fromkeys(keys, 0.0)
    share = {(r, s, d): 0.0 for r, s in keys for d in ("float32", "bfloat16")}
    for dtype in (torch.float32, torch.bfloat16):
        for stride, shape, k in cases:
            b, c, h, w = shape
            x = randn(gen, *shape, dtype=dtype)
            g = randn(gen, b, k, h // stride, w // stride, dtype=dtype)
            want = C.conv3x3_wgrad_plain(x, g, stride)
            scale = float(want.abs().max())
            rule = "tc" if C.tc_route(dtype, shape, stride) else "ffma"
            for route in (rule, "ffma") if rule == "tc" else (rule,):
                with wgrad_route(route) if route != rule else contextlib.nullcontext():
                    C.reset_launch_count()
                    got = C.conv3x3_wgrad(x, g, stride)
                    torch.cuda.synchronize()
                    if C.launch_count() != 1 or C.launch_count(route=route) != 1:
                        raise RuntimeError(f"conv3x3_wgrad {shape} stride {stride}: launches "
                                           f"{C.launch_count()}, expected one on {route}")
                    if route == "tc" and not torch.equal(got, C.conv3x3_wgrad(x, g, stride)):
                        raise RuntimeError(f"conv3x3_wgrad tc {shape} stride {stride} {dtype} is "
                                           f"not bitwise repeatable")
                err = float((got - want).abs().max())
                if not (math.isfinite(err) and err <= WGRAD_RTOL * scale):
                    raise RuntimeError(
                        f"conv3x3_wgrad {route} kernel disagrees with its plain version: stride "
                        f"{stride} x {shape} K {k} {dtype}: max abs err {err}, max|plain| "
                        f"{scale}")
                d = str(dtype)[6:]
                max_err[(route, stride)] = max(max_err[(route, stride)], err)
                share[(route, stride, d)] = max(share[(route, stride, d)],
                                                err / (WGRAD_RTOL * scale))
            del x, g, want, got
    for (route, s), e in max_err.items():
        print(f"conv3x3_wgrad {route} stride {s}: max abs err {e}, share of the limit "
              f"({WGRAD_RTOL} x max|plain|) fp32 {share[(route, s, 'float32')]:.4f}, bf16 "
              f"{share[(route, s, 'bfloat16')]:.4f}")
    print(f"conv3x3_wgrad: {len(cases)} shapes x (fp32, bf16) agree with the plain version on "
          f"the rule's route and, where that is the tensor cores, on FFMA too; the rule gives the "
          f"tensor cores {[c[1:] for c in cases if C.tc_route(torch.float32, c[1], c[0])]}")

    bw, flops = card_rates(torch.cuda.get_device_name(0))
    per_shape = {1: [], 2: []}
    tf32 = torch.backends.cudnn.allow_tf32
    for stride, shapes in ((1, WGRAD_S1), (2, WGRAD_S2)):
        for shape, k in shapes:
            b, c, h, w = shape
            ho, wo = h // stride, w // stride
            x = randn(gen, *shape)
            g = randn(gen, b, k, ho, wo)
            xb, gb = x.bfloat16(), g.bfloat16()
            # The library's wgrad: cuDNN, stride-2 on the input padded
            # beforehand (the pad is not in its time), stride 1 padding 1.
            pad = (0, 1, 0, 1)
            xl, p = (x, 1) if stride == 1 else (F.pad(x, pad), 0)
            xlb = xb if stride == 1 else F.pad(xb, pad)

            def library(xl=xl, g=g):
                return torch.nn.grad.conv2d_weight(xl, (k, c, 3, 3), g, stride=stride, padding=p)

            t = {"shape": [list(shape), k]}
            for label, (xx, gg) in (("fp32", (x, g)), ("bf16", (xb, gb))):
                runs = {}
                for turn in ("tc", "ffma", "ffma", "tc"):
                    with wgrad_route(turn):
                        runs.setdefault(turn, []).append(
                            median_ms(lambda: C.conv3x3_wgrad(xx, gg, stride)))
                        if f"{label}_{turn}_device_ms" not in t:
                            t[f"{label}_{turn}_device_ms"] = device_busy_ms(
                                lambda: C.conv3x3_wgrad(xx, gg, stride))
                for turn, v in runs.items():
                    t[f"{label}_{turn}_ms"] = statistics.mean(v)
                    t[f"{label}_{turn}_ms_runs"] = v
                # Where a tensor-core call's device time goes: the pre-passes
                # (x's tap planes, g's pieces), the products, the slices' sum.
                t[f"{label}_tc_kernels_ms"] = kernel_breakdown(
                    lambda: C.conv3x3_wgrad(xx, gg, stride))
            t["plain_ms"] = median_ms(lambda: C.conv3x3_wgrad_plain(x, g, stride))
            t["library_ms"] = median_ms(library)
            t["library_bf16_ms"] = median_ms(lambda: library(xlb, gb))
            torch.backends.cudnn.allow_tf32 = False
            try:
                t["library_fp32_ms"] = median_ms(library)
            finally:
                torch.backends.cudnn.allow_tf32 = tf32
            flop = 2.0 * k * 9 * c * b * ho * wo
            out_bytes = 4.0 * k * c * 9
            for label, nbytes, tc_passes in (("fp32", 4.0 * (x.numel() + g.numel()) + out_bytes, 3),
                                             ("bf16", 2.0 * (x.numel() + g.numel()) + out_bytes, 1)):
                bytes_ms = nbytes / bw * 1e3
                for route, ops_ms in (("ffma", flop / flops * 1e3),
                                      ("tc", tc_passes * flop / BF16_FLOPS * 1e3)):
                    key = f"{label}_{route}"
                    t[f"{key}_bound_ms"] = max(bytes_ms, ops_ms)
                    t[f"{key}_bound_by"] = "bytes" if bytes_ms >= ops_ms else "operations"
                    t[f"{key}_bound_share"] = t[f"{key}_bound_ms"] / t[f"{key}_ms"]
            t.update(gflop=flop / 1e9, tf32_bound_ms=flop / TF32_FLOPS * 1e3)
            per_shape[stride].append(t)
            print(f"conv3x3_wgrad stride {stride} x {list(shape)} K {k}: {flop / 1e9:.2f} GFLOP; "
                  f"fp32: tensor cores {t['fp32_tc_ms']:.4f} ms (runs {t['fp32_tc_ms_runs']}, "
                  f"device {t['fp32_tc_device_ms']} ms; bound {t['fp32_tc_bound_ms']:.4f}, "
                  f"{t['fp32_tc_bound_by']}, three bf16 passes: "
                  f"{100 * t['fp32_tc_bound_share']:.1f} %), FFMA {t['fp32_ffma_ms']:.4f} ms (runs "
                  f"{t['fp32_ffma_ms_runs']}, device {t['fp32_ffma_device_ms']} ms; bound "
                  f"{t['fp32_ffma_bound_ms']:.4f}: {100 * t['fp32_ffma_bound_share']:.1f} %); "
                  f"bf16: tensor cores {t['bf16_tc_ms']:.4f} ms (device {t['bf16_tc_device_ms']} "
                  f"ms; bound {t['bf16_tc_bound_ms']:.4f}: {100 * t['bf16_tc_bound_share']:.1f} "
                  f"%), FFMA {t['bf16_ffma_ms']:.4f} ms; plain {t['plain_ms']:.4f} ms; cuDNN wgrad "
                  f"{t['library_ms']:.4f} ms (TF32), {t['library_fp32_ms']:.4f} ms (fp32), "
                  f"{t['library_bf16_ms']:.4f} ms (bf16); TF32 bound {t['tf32_bound_ms']:.4f} ms; "
                  f"tensor-core device ms by kernel: fp32 {t['fp32_tc_kernels_ms']}, bf16 "
                  f"{t['bf16_tc_kernels_ms']}")
            del x, g, xb, gb, xl, xlb

    ptxas = _build.ptxas_report(C.TC_SOURCE)
    records = []
    for stride, times, work, reps in (
        (1, per_shape[1], "3 calls at each of ResNet-18's two routed shapes "
         "(the wgrads of one main-path step)", ROUTED_PER_SHAPE),
        (2, per_shape[2], "one call at each of ResNet-18's two stride-2 3x3 "
         "shapes (not on the main path: routing takes stride 1 only)", 1),
    ):
        for route in ("ffma", "tc"):
            def total(key, times=times):
                vals = [t[key] for t in times]
                return None if None in vals else reps * sum(vals)

            key = f"fp32_{route}"
            rec = {
                "name": f"conv3x3_wgrad_s{stride}" + ("_tc" if route == "tc" else ""),
                "route": "cuda",
                "source": "cs744_pytorch_distributed_tutorial_tpu_torch/csrc/"
                          + (C.TC_SOURCE if route == "tc" else C.SOURCE),
                "replaces": "cs744_pytorch_distributed_tutorial_tpu/ops/fused_conv.py:"
                            + ("70" if stride == 1 else "104"),
                "tpu_kernel": f"ops/fused_conv.py::_wgrad_kernel_s{stride} ("
                              + ("tensor-core route: fp32 as two bf16 pieces, bf16 as one"
                                 if route == "tc" else "FFMA route") + ")",
                "launches": None,  # filled in from the main path's run
                "max_abs_err": max_err[(route, stride)],
                "share_of_limit": share[(route, stride, "float32")],
                "share_of_limit_bf16": share[(route, stride, "bfloat16")],
                "ms": total(f"{key}_ms"),
                "device_ms": total(f"{key}_device_ms"),
                "bf16_ms": total(f"bf16_{route}_ms"),
                "bf16_device_ms": total(f"bf16_{route}_device_ms"),
                "plain_ms": total("plain_ms"),
                "bound_ms": total(f"{key}_bound_ms"),
                "bound_by": "operations" if all(t[f"{key}_bound_by"] == "operations"
                                                for t in times) else "bytes",
                "bf16_bound_ms": total(f"bf16_{route}_bound_ms"),
                "tf32_bound_ms": total("tf32_bound_ms"),
                "library_ms": total("library_ms"),
                "library": "torch.nn.grad.conv2d_weight (cuDNN, TF32)",
                "library_fp32_ms": total("library_fp32_ms"),
                "library_bf16_ms": total("library_bf16_ms"),
                "work": work,
                "shapes": times,
            }
            rec["bound_share"] = rec["bound_ms"] / rec["ms"]
            if route == "tc":
                rec["ptxas"] = {f"P={p}": ptxas.get(f"wgrad_tc_kernel<{p}>") for p in (1, 2)}
            records.append(rec)
    return records


# ------------------------------------------------------------- CLI paths
def cli_argv(model: str, part: str, steps: int, *flags: str) -> list[str]:
    return [
        "--part", part, "--num-devices", "1", "--model", model, *flags,
        "--synthetic-data", "--synthetic-train-size", str(256 * steps),
        "--synthetic-test-size", "512", "--global-batch-size", "256",
        "--epochs", "1", "--json", "--device", "cuda",
    ]


def counted_run(argv: list[str]) -> tuple[dict, dict]:
    """Run the CLI with every launch count zeroed just before and read
    just after."""
    from cs744_pytorch_distributed_tutorial_tpu_torch.ops import fused_conv as C

    summary, counts = counted(lambda: run_cli(argv))
    counts = {
        "fused_sgd": counts["fused_sgd"],
        **{f"conv3x3_wgrad_s{s}" + ("_tc" if r == "tc" else ""): C.launch_count(stride=s, route=r)
           for s in (1, 2) for r in C.ROUTES},
        "conv3x3_wgrad_bf16": C.launch_count(dtype=torch.bfloat16),
        "conv3x3_wgrad_bf16_tc": C.launch_count(dtype=torch.bfloat16, route="tc"),
    }
    return summary, counts


def check_run(label: str, summary: dict, counts: dict, steps: int, expect: dict) -> None:
    if summary["steps"] != steps:
        raise RuntimeError(f"{label}: ran {summary['steps']} steps, not {steps}")
    for key in ("final_train_loss", "final_eval_loss"):
        if not math.isfinite(summary[key]):
            raise RuntimeError(f"{label}: {key} is not finite: {summary[key]}")
    for name, want in expect.items():
        if counts[name] != want:
            raise RuntimeError(f"{label}: {name} launched {counts[name]} times, expected {want}")
    print(f"{label}: {steps} steps, loss {summary['final_train_loss']}, "
          f"avg_batch_time_s {summary['avg_batch_time_s']}, launches {counts}")


def main_path_phase(model: str, flags: tuple[str, ...], expect: dict) -> dict:
    summary, counts = counted_run(cli_argv(model, "1", STEPS, *flags))
    check_run(f"main path {model} part 1", summary, counts, STEPS, expect)
    if summary["avg_batch_time_s"] is None:
        raise RuntimeError(f"main path {model}: no avg_batch_time_s recorded")
    print(f"main path {model}: batch 256, {256 / summary['avg_batch_time_s']:.1f} samples/s")
    return counts


def nccl_phases() -> None:
    summary, counts = counted_run(cli_argv("vgg11", "2b", NCCL_STEPS, "--fused-optimizer"))
    if summary["backend"] != "nccl":
        raise RuntimeError(f"part 2b ran on backend {summary['backend']!r}, not nccl")
    check_run("NCCL path vgg11 part 2b", summary, counts, NCCL_STEPS,
              {"fused_sgd": NCCL_STEPS})  # one launch a step
    # DDP: every parameter's gradient, the autograd Function's dW
    # included, must reach the reducer, or DDP raises on the next step.
    summary, counts = counted_run(cli_argv("resnet18", "3", NCCL_STEPS, "--fast-conv"))
    if summary["backend"] != "nccl":
        raise RuntimeError(f"part 3 ran on backend {summary['backend']!r}, not nccl")
    check_run("DDP path resnet18 part 3", summary, counts, NCCL_STEPS,
              {"conv3x3_wgrad_s1_tc": RESNET18_ROUTED * NCCL_STEPS, "conv3x3_wgrad_s1": 0,
               "conv3x3_wgrad_s2": 0, "conv3x3_wgrad_s2_tc": 0})


def bf16_phase() -> None:
    argv = cli_argv("resnet18", "1", BF16_STEPS, "--fast-conv", "--fused-optimizer",
                    "--compute-dtype", "bfloat16")
    summary, counts = counted_run(argv)
    check_run("bf16 path resnet18 part 1", summary, counts, BF16_STEPS, {
        "conv3x3_wgrad_s1_tc": RESNET18_ROUTED * BF16_STEPS,
        "conv3x3_wgrad_s1": 0,
        "conv3x3_wgrad_bf16_tc": RESNET18_ROUTED * BF16_STEPS,
        "conv3x3_wgrad_bf16": RESNET18_ROUTED * BF16_STEPS,
        "fused_sgd": BF16_STEPS,  # one launch a step
    })


# ----------------------------------------------------------- trajectories
def _losses(cfg_kw: dict, steps: int, batch: int) -> list[float]:
    from cs744_pytorch_distributed_tutorial_tpu_torch.config import TrainConfig
    from cs744_pytorch_distributed_tutorial_tpu_torch.data import synthetic_cifar10
    from cs744_pytorch_distributed_tutorial_tpu_torch.train import Trainer

    ds = synthetic_cifar10(steps * batch, 8, seed=1)
    tr = Trainer(TrainConfig(sync="none", num_devices=1, global_batch_size=batch,
                             augment=False, learning_rate=0.02, **cfg_kw))
    out = []
    for s in range(steps):
        x = torch.from_numpy(ds.train_images[s * batch : (s + 1) * batch]).to(tr.device)
        y = torch.from_numpy(ds.train_labels[s * batch : (s + 1) * batch].astype("int64")).to(tr.device)
        out.append(float(tr.train_step(x, y)))
    return out


def trajectory_phase() -> None:
    """Same seed and batches, augmentation off, lr 0.02, batch 64.

    VGG-11, fused kernel vs plain update over 3 steps: the two updates
    round alike; the residue is cuDNN's run-to-run summation order, hence
    rtol 1e-3 on the loss.

    ResNet-18, the wgrad kernel vs the library's over 4 steps, with
    cuDNN's TF32 off for this comparison only, so both wgrads are fp32:
    loss within rtol 1e-4. The first step's routed wgrads are zero (zero
    last-BN gammas); steps 2 and later hold the kernel to non-zero ones."""
    vgg = {f: _losses(dict(model="vgg11", fused_optimizer=f), 3, 64) for f in (True, False)}
    for a, b in zip(vgg[True], vgg[False]):
        if not (math.isfinite(a) and abs(a - b) <= 1e-3 * abs(b)):
            raise RuntimeError(f"vgg11 fused vs plain trajectories differ: {vgg}")
    print(f"trajectory vgg11: fused {vgg[True]} plain {vgg[False]}")

    tf32 = torch.backends.cudnn.allow_tf32
    torch.backends.cudnn.allow_tf32 = False
    try:
        res = {f: _losses(dict(model="resnet18", fast_conv=f), 4, 64) for f in (True, False)}
    finally:
        torch.backends.cudnn.allow_tf32 = tf32
    for a, b in zip(res[True], res[False]):
        if not (math.isfinite(a) and abs(a - b) <= 1e-4 * abs(b)):
            raise RuntimeError(f"resnet18 fast_conv vs library trajectories differ: {res}")
    print(f"trajectory resnet18: fast_conv {res[True]} library {res[False]}")


# -------------------------------------------------------------- profiles
def profile_phase(model: str, **cfg_kw) -> dict:
    """Where a main-path step's device time goes: batch 256, fused
    optimizer, 5 steps on batches already on the card (so the host's
    batch gather is not in it), traced with torch.profiler. Idle share is
    1 - (sum of kernel time) / (first kernel start to last kernel end)."""
    from torch.profiler import ProfilerActivity, profile

    from cs744_pytorch_distributed_tutorial_tpu_torch.config import TrainConfig
    from cs744_pytorch_distributed_tutorial_tpu_torch.data import synthetic_cifar10
    from cs744_pytorch_distributed_tutorial_tpu_torch.train import Trainer

    tr = Trainer(TrainConfig(model=model, sync="none", num_devices=1,
                             fused_optimizer=True, **cfg_kw))
    ds = synthetic_cifar10(256 * 8, 8, seed=2)
    batches = [
        (torch.from_numpy(ds.train_images[s * 256 : (s + 1) * 256]).to(tr.device),
         torch.from_numpy(ds.train_labels[s * 256 : (s + 1) * 256].astype("int64")).to(tr.device))
        for s in range(8)
    ]
    for x, y in batches[:3]:
        tr.train_step(x, y)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        for x, y in batches[3:]:
            tr.train_step(x, y)
        torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    steps = len(batches) - 3
    summary = summarize_profile(prof, steps, f"profile {model}", {
        "fused_sgd": ("fused_sgd",), "wgrad_kernel": ("wgrad_kernel", "sum_splits_kernel"),
        "wgrad_tc": ("wgrad_tc_kernel", "wgrad_planes_kernel", "wgrad_split_kernel",
                     "wgrad_tc_sum_kernel")})
    if not summary:
        return {}
    out = {"model": model, **cfg_kw, **summary, "wall_ms_per_step_profiled": wall / steps * 1e3}
    print(json.dumps({"step_profile": out}))
    return out


# ------------------------------------------------------------- the bench
def bench_phase() -> dict:
    """The port's headline (``bench.py``): ResNet-18, bf16, DDP on a
    process group of one, batch 4096 (10 + 30 steps) and 1024 (10 + 90),
    its ``kind: "bench"`` line after the card and the peak memory."""
    from cs744_pytorch_distributed_tutorial_tpu_torch import bench
    from cs744_pytorch_distributed_tutorial_tpu_torch.obs.sinks import sanitize

    record, measured = bench.run_headline()
    for batch, m in measured.items():
        if not (m["samples_per_sec"] > 0 and m["device"].type == "cuda"):
            raise RuntimeError(f"bench at batch {batch}: {m}")
    print(f"bench card: {card_line()}")
    print("bench peak memory: " + ", ".join(
        f"batch {b} {m['peak_memory_bytes'] / 1e9:.3f} GB" for b, m in measured.items()))
    if record["mfu"] is None or record["vs_baseline"] is not None:
        raise RuntimeError(f"bench record: mfu {record['mfu']}, vs_baseline {record['vs_baseline']}")
    print(json.dumps(sanitize(record)))
    from torch.profiler import ProfilerActivity, profile

    with bench.headline_trainer(bench.GLOBAL_BATCH) as (tr, x, y):
        for _ in range(3):
            tr.train_step(x, y)
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            for _ in range(3):
                tr.train_step(x, y)
            torch.cuda.synchronize()
    summary = summarize_profile(prof, 3, "profile bench", {
        "bn": ("bn_", "batch_norm", "BatchNorm"), "conv": ("conv", "xmma", "cutlass", "sm90"),
        "nchw_nhwc": ("nchwToNhwc", "nhwcToNchw")})
    if summary:
        print(json.dumps({"bench_profile": summary}))
    return record


# ------------------------------------------------------------ sync paths
SYNC_STEPS = 12  # > 10, so the CLI's timing window (batches 1-10) fills
SYNC_MODES = {  # label: (flags, fused-SGD launches a step: None = a bucket each)
    "allreduce": ((), 0),
    "ring": (("--sync", "ring"), 0),
    "overlap allreduce": (("--sync-overlap", "bucket"), None),
    "overlap ring": (("--sync", "ring", "--sync-overlap", "bucket"), None),
    "int8 allreduce": (("--grad-compress", "int8"), 0),
    "int8 ring": (("--sync", "ring", "--grad-compress", "int8"), 0),
    "overlap int8": (("--grad-compress", "int8", "--sync-overlap", "bucket+int8"), None),
    "accum 2": (("--accum-steps", "2", "--fused-optimizer"), 1),
}


def resnet18_buckets() -> int:
    """Buckets of the overlapped schedule over ResNet-18 (4 MiB, reverse)."""
    from cs744_pytorch_distributed_tutorial_tpu_torch.models import resnet18
    from cs744_pytorch_distributed_tutorial_tpu_torch.parallel.overlap import overlap_layout

    shapes = [(tuple(p.shape), p.dtype) for p in resnet18().parameters()]
    return len(overlap_layout(shapes, "allreduce", 1, None).bucket_cols)


def _trainer_run(cfg_kw: dict, steps: int, batch: int = 64):
    """(losses, parameters, trainer) of ResNet-18 on the card, augmentation
    off, a process group of one; launch counts zeroed just before."""
    from cs744_pytorch_distributed_tutorial_tpu_torch.config import TrainConfig
    from cs744_pytorch_distributed_tutorial_tpu_torch.data import synthetic_cifar10
    from cs744_pytorch_distributed_tutorial_tpu_torch.train import Trainer

    ds = synthetic_cifar10(steps * batch, 8, seed=3)
    tr = Trainer(TrainConfig(model="resnet18", num_devices=1, global_batch_size=batch,
                             augment=False, learning_rate=0.02, **cfg_kw))

    def run():
        out = []
        for s in range(steps):
            x = torch.from_numpy(ds.train_images[s * batch : (s + 1) * batch]).to(tr.device)
            y = torch.from_numpy(ds.train_labels[s * batch : (s + 1) * batch].astype("int64"))
            out.append(float(tr.train_step(x, y.to(tr.device))))
        return out

    losses, counts = counted(run)
    return losses, [p.detach().clone() for p in tr.params], tr, counts


def sync_paths_phase() -> int:
    """The gradient wire's paths on NCCL at a world of one (ResNet-18,
    batch 256, ``SYNC_STEPS`` each, through the CLI): the overlapped
    schedule over allreduce and ring (one fused-SGD launch a bucket a
    step), the int8 wire over both and overlapped, and ``--accum-steps
    2``; each mode's step time (overlap hides nothing at one rank).
    Then, with cuDNN deterministic, 3 Trainer steps each: the overlapped
    float paths bitwise equal to the fused ones, and the int8 wire's
    residual and mean after one step bitwise equal to the CPU version on
    the same gradients; the residual nonzero."""
    from cs744_pytorch_distributed_tutorial_tpu_torch.parallel import buckets as B
    from cs744_pytorch_distributed_tutorial_tpu_torch.parallel import mesh
    from cs744_pytorch_distributed_tutorial_tpu_torch.parallel.sync import sync_bucket_compressed

    buckets = resnet18_buckets()
    for label, (flags, per_step) in SYNC_MODES.items():
        summary, counts = counted_run(cli_argv("resnet18", "2b", SYNC_STEPS, *flags))
        if summary["backend"] != "nccl":
            raise RuntimeError(f"{label} ran on backend {summary['backend']!r}, not nccl")
        want = (buckets if per_step is None else per_step) * SYNC_STEPS
        check_run(f"sync path {label}", summary, counts, SYNC_STEPS, {"fused_sgd": want})
        if summary["avg_batch_time_s"] is None:
            raise RuntimeError(f"sync path {label}: no avg_batch_time_s recorded")
        print(f"sync path {label}: {summary['avg_batch_time_s'] * 1e3:.3f} ms a step "
              f"(batches 1-10), {256 / summary['avg_batch_time_s']:.1f} samples/s")

    det = torch.backends.cudnn.deterministic
    torch.backends.cudnn.deterministic = True
    mesh.initialize(None, 1, 0, device=torch.device("cuda", 0))
    try:
        for sync in ("allreduce", "ring"):
            fused = _trainer_run(dict(sync=sync), 3)
            over = _trainer_run(dict(sync=sync, sync_overlap="bucket"), 3)
            if over[3]["fused_sgd"] != buckets * 3:
                raise RuntimeError(f"overlapped {sync}: {over[3]['fused_sgd']} fused-SGD "
                                   f"launches, expected {buckets * 3}")
            gap = max(float((a - b).abs().max()) for a, b in zip(over[1], fused[1]))
            if over[0] != fused[0] or gap != 0.0:
                raise RuntimeError(f"overlapped {sync} differs from fused: losses "
                                   f"{over[0]} vs {fused[0]}, parameter gap {gap}")
            print(f"sync path {sync}: overlapped == fused bitwise over 3 steps "
                  f"({over[3]['fused_sgd']} fused-SGD launches, {buckets} buckets)")
        # One int8 step from zero residuals: its residual is b - dequant(quant(b))
        # of the step's local gradient b, which the float run at a world of
        # one leaves in p.grad unchanged (the mean over one rank).
        ref = _trainer_run(dict(sync="allreduce"), 1)[2]
        _, _, tr, _ = _trainer_run(dict(sync="allreduce", grad_compress="int8"), 1)
        layout = B.bucket_layout(tr.params, rows=0)
        local = [p.grad for p in ref.params]
        for g, e, m in zip(B.flatten_for_sync(local, layout),
                           B.flatten_for_sync(tr.state.ef, layout),
                           B.flatten_for_sync([p.grad for p in tr.params], layout)):
            cpu_mean, cpu_resid = sync_bucket_compressed(g.cpu(), torch.zeros_like(g.cpu()),
                                                         "allreduce", 1)
            if not (torch.equal(e.cpu(), cpu_resid) and torch.equal(m.cpu(), cpu_mean)):
                raise RuntimeError("int8 wire on the card differs from its CPU version")
        nonzero = sum(int(bool(e.abs().max() > 0)) for e in tr.state.ef)
        if not nonzero:
            raise RuntimeError("int8 error feedback stayed zero")
        print(f"sync path int8: mean and residual == CPU version over {len(layout.bucket_cols)} "
              f"buckets; residual nonzero in {nonzero} of {len(tr.state.ef)} tensors")
    finally:
        mesh.shutdown()
        torch.backends.cudnn.deterministic = det
    return buckets


# ------------------------------------------- sharded optimizers and recipes
SHARDED_MODES = {  # label: (part, flags); the first two are the yardsticks
    "part 2b allreduce": ("2b", ()),
    "part 1 sgd": ("1", ()),
    "zero1": ("2b", ("--sync", "zero1")),
    "zero1 overlap": ("2b", ("--sync", "zero1", "--sync-overlap", "bucket")),
    "fsdp": ("2b", ("--sync", "fsdp")),
    "fsdp overlap": ("2b", ("--sync", "fsdp", "--sync-overlap", "bucket")),
    "adamw warmup_cosine clip": ("1", ("--optimizer", "adamw", "--lr", "1e-3", "--lr-schedule",
                                       "warmup_cosine", "--warmup-steps", "4", "--total-steps",
                                       str(SYNC_STEPS), "--grad-clip-norm", "1.0")),
    "lion cosine": ("1", ("--optimizer", "lion", "--lr", "1e-4", "--lr-schedule", "cosine",
                          "--total-steps", str(SYNC_STEPS))),
    "sync_bn debug_sync_check": ("2b", ("--sync-bn", "--debug-sync-check")),
}
COLLECTIVES = ("reduce_scatter_tensor", "all_gather_into_tensor")
SYNC_BN_RTOL = 1e-3  # SyncBN vs per-replica losses over 3 steps, TF32 off


@contextlib.contextmanager
def counted_collectives(names: tuple[str, ...] = COLLECTIVES):
    """Calls of ``names`` in the block, counted at ``torch.distributed``."""
    import torch.distributed as dist

    counts = dict.fromkeys(names, 0)
    saved = {name: getattr(dist, name) for name in names}

    def wrap(name):
        def call(*args, **kw):
            counts[name] += 1
            return saved[name](*args, **kw)
        return call

    with patched(dist, **{name: wrap(name) for name in names}):
        yield counts


def resnet18_zero_buckets() -> int:
    """Buckets of zero1's overlapped lane over ResNet-18 at a world of
    one (4 MiB, reverse, rows of one)."""
    from cs744_pytorch_distributed_tutorial_tpu_torch.models import resnet18
    from cs744_pytorch_distributed_tutorial_tpu_torch.parallel.zero import Zero1SGD

    shapes = [(tuple(p.shape), p.dtype) for p in resnet18().parameters()]
    return len(Zero1SGD(0.1, 0.9, 0.0, 1, overlap=True).layout(shapes).bucket_cols)


def sharded_phase() -> None:
    """ZeRO-1, FSDP and the recipes through the CLI on NCCL at a world of
    one (ResNet-18, batch 256, ``SYNC_STEPS`` each), beside part 2b's
    allreduce and part 1's SGD in the same run: zero1 and fsdp alone
    and overlapped, each one's reduce-scatters and all-gathers counted (a
    world of one runs them as copies: per tensor, 62 a step, as JAX at an
    axis of one; zero1's overlapped lane a bucket, fsdp one more gather
    for the eval); part 1 with AdamW + warmup_cosine + clip and with
    Lion + cosine; part 2b with SyncBN and the divergence check; each
    one's step time. Then, with cuDNN deterministic, 3 Trainer steps
    each: zero1 and fsdp, alone and overlapped, equal part 2b's allreduce
    bit for bit in losses and parameters (``p + (-lr m)`` is ``p - lr m``),
    and SyncBN's losses within ``SYNC_BN_RTOL`` of the per-replica path
    (TF32 off: the two BatchNorms round differently)."""
    from cs744_pytorch_distributed_tutorial_tpu_torch.parallel import mesh

    leaves, buckets = 62, resnet18_zero_buckets()
    expect = {  # (reduce-scatters, all-gathers) in the run
        "zero1": (leaves * SYNC_STEPS, leaves * SYNC_STEPS),
        "zero1 overlap": (buckets * SYNC_STEPS, buckets * SYNC_STEPS),
        "fsdp": (leaves * SYNC_STEPS, leaves * (SYNC_STEPS + 1)),
        "fsdp overlap": (leaves * SYNC_STEPS, leaves * (SYNC_STEPS + 1)),
        "sync_bn debug_sync_check": (0, SYNC_STEPS),  # one checksum gather a step
    }
    for label, (part, flags) in SHARDED_MODES.items():
        with counted_collectives() as coll:
            summary, counts = counted_run(cli_argv("resnet18", part, SYNC_STEPS, *flags))
        want_backend = "nccl" if part != "1" else None
        if summary["backend"] != want_backend:
            raise RuntimeError(f"{label} ran on backend {summary['backend']!r}, "
                               f"not {want_backend}")
        check_run(f"sharded path {label}", summary, counts, SYNC_STEPS, {
            "fused_sgd": 0, "conv3x3_wgrad_s1": 0, "conv3x3_wgrad_s1_tc": 0})
        got = (coll["reduce_scatter_tensor"], coll["all_gather_into_tensor"])
        if got != expect.get(label, (0, 0)):
            raise RuntimeError(f"{label}: {got} reduce-scatters and all-gathers, expected "
                               f"{expect.get(label, (0, 0))}")
        if summary["avg_batch_time_s"] is None:
            raise RuntimeError(f"sharded path {label}: no avg_batch_time_s recorded")
        print(f"sharded path {label}: {summary['avg_batch_time_s'] * 1e3:.3f} ms a step "
              f"(batches 1-10), {256 / summary['avg_batch_time_s']:.1f} samples/s, "
              f"{got[0]} reduce-scatters, {got[1]} all-gathers; card {card_line()}")

    det, tf32 = torch.backends.cudnn.deterministic, torch.backends.cudnn.allow_tf32
    torch.backends.cudnn.deterministic = True
    mesh.initialize(None, 1, 0, device=torch.device("cuda", 0))
    try:
        ref = _trainer_run(dict(sync="allreduce"), 3)
        for kw in (dict(sync="zero1"), dict(sync="zero1", sync_overlap="bucket"),
                   dict(sync="fsdp"), dict(sync="fsdp", sync_overlap="bucket")):
            losses, params, tr, _ = _trainer_run(kw, 3)
            if tr._fsdp:  # at a world of one a shard is the whole tensor, flat
                params = [p.view(r.shape) for p, r in zip(params, ref[1], strict=True)]
            gap = max(float((a - b).abs().max()) for a, b in zip(params, ref[1], strict=True))
            if losses != ref[0] or gap != 0.0:
                raise RuntimeError(f"{kw} differs from allreduce: losses {losses} vs "
                                   f"{ref[0]}, parameter gap {gap}")
            print(f"sharded {kw}: == allreduce bitwise over 3 steps, losses {losses}")
        torch.backends.cudnn.allow_tf32 = False
        plain, plain_p, *_ = _trainer_run(dict(sync="allreduce"), 3)
        synced, synced_p, *_ = _trainer_run(dict(sync="allreduce", sync_bn=True), 3)
        rel = max(abs(a - b) / abs(b) for a, b in zip(synced, plain))
        if not rel <= SYNC_BN_RTOL:
            raise RuntimeError(f"SyncBN losses {synced} vs per-replica {plain}: rel {rel}")
        gap = max(float((a - b).abs().max()) for a, b in zip(synced_p, plain_p))
        print(f"sync_bn at a world of one: losses {synced} vs per-replica {plain}, "
              f"largest relative gap {rel:.3e} (limit {SYNC_BN_RTOL}), parameters apart "
              f"by at most {gap:.3e}")
    finally:
        mesh.shutdown()
        torch.backends.cudnn.deterministic, torch.backends.cudnn.allow_tf32 = det, tf32


# ---------------------------------------------------------- flash attention
def flash_ffma_route():
    """The flash forward and backward on the FFMA kernels whatever the
    inputs (the route rule, patched for the block to refuse the tensor
    cores), for a route-vs-route comparison."""
    from cs744_pytorch_distributed_tutorial_tpu_torch.ops import flash_attention as A

    return patched(A, tc_route=lambda *args, **kw: False)


def plain_flash():
    """The flash autograd Function through the plain versions of the
    forward, dq and dk/dv on CUDA tensors (the module functions it calls,
    patched for the block), as a trajectory's yardstick."""
    from cs744_pytorch_distributed_tutorial_tpu_torch.ops import flash_attention as A

    return patched(A, flash_forward_lse=A.flash_forward_lse_plain, flash_dq=A.flash_dq_plain,
                   flash_dkv=A.flash_dkv_plain)


def flash_phase(dev: torch.device) -> list[dict]:
    """The kernels against their plain versions (each backward kernel
    given the plain lse and delta, so each is checked on its own): fp32
    inputs take the FFMA forward, dq and dk/dv, bf16 ones the tensor-core
    kernels (a second run bitwise equal), then the same bf16 inputs on the
    FFMA route; every call's route shown by its launches. Then times at the
    LM path's shape in bf16, each kernel's two routes in turn (tensor
    cores, FFMA, FFMA, tensor cores: the mean of the two medians)."""
    import torch.nn.functional as F

    from cs744_pytorch_distributed_tutorial_tpu_torch.ops import _build
    from cs744_pytorch_distributed_tutorial_tpu_torch.ops import flash_attention as A

    gen = torch.Generator(device=dev).manual_seed(3)
    names = ("fwd", "dq", "dkv", "fwd_tc", "dq_tc", "dkv_tc")
    err = {k: 0.0 for k in names}
    share = {}  # (name, dtype) -> max over cases of err / (tolerance x max|plain|)
    lse_err = {"fwd": 0.0, "fwd_tc": 0.0}

    def routed(want: dict, fn):
        A.reset_launch_count()
        res = fn()
        torch.cuda.synchronize()
        got = {(k, r): A.launch_count(k, route=r) for k in A.KERNELS for r in A.ROUTES
               if A.launch_count(k, route=r)}
        if got != want:
            raise RuntimeError(f"flash launches {got}, expected {want}")
        return res

    for dtype in (torch.float32, torch.bfloat16):
        route = "tc" if dtype == torch.bfloat16 else "ffma"
        sfx = "_tc" if route == "tc" else ""
        for b, t, h, d, causal in FLASH_CASES:
            q, k, v, do = (randn(gen, b, t, h, d, dtype=dtype) for _ in range(4))
            want_o, want_lse = A.flash_forward_lse_plain(q, k, v, causal)
            delta = A.flash_delta(want_o, do)
            args = (q, k, v, do, want_lse, delta, causal)

            def backward():
                return (A.flash_forward_lse(q, k, v, causal), A.flash_dq(*args),
                        A.flash_dkv(*args))

            (out, lse), dq, (dk, dv) = routed(
                {("fwd", route): 1, ("dq", route): 1, ("dkv", route): 1}, backward)
            want_dq = A.flash_dq_plain(*args)
            want_dk, want_dv = A.flash_dkv_plain(*args)
            case = f"{dtype} B{b} T{t} H{h} D{d} causal={causal}"
            checks = [("fwd" + sfx, out, want_o), ("dq" + sfx, dq, want_dq),
                      ("dkv" + sfx, dk, want_dk), ("dkv" + sfx, dv, want_dv)]
            lses = [("fwd" + sfx, lse)]
            if route == "tc":
                (out2, lse2), dq2, (dk2, dv2) = backward()
                if not (torch.equal(out, out2) and torch.equal(lse, lse2)):
                    raise RuntimeError(f"flash tensor-core forward not bitwise repeatable at "
                                       f"{case}")
                if not (torch.equal(dq, dq2) and torch.equal(dk, dk2) and torch.equal(dv, dv2)):
                    raise RuntimeError(f"flash tensor-core backward not bitwise repeatable at "
                                       f"{case}")
                with flash_ffma_route():
                    (fo, flse), fdq, (fdk, fdv) = routed(
                        {("fwd", "ffma"): 1, ("dq", "ffma"): 1, ("dkv", "ffma"): 1}, backward)
                checks += [("fwd", fo, want_o), ("dq", fdq, want_dq), ("dkv", fdk, want_dk),
                           ("dkv", fdv, want_dv)]
                lses.append(("fwd", flse))
            torch.cuda.synchronize()
            for name, got_lse in lses:
                e = float((got_lse - want_lse).abs().max())
                if not (math.isfinite(e) and e <= FLASH_LSE_TOL):
                    raise RuntimeError(f"flash {name} lse disagrees with its plain version at "
                                       f"{case}: {e}")
                lse_err[name] = max(lse_err[name], e)
            for name, got, want in checks:
                e = float((got.float() - want.float()).abs().max())
                scale = float(want.float().abs().max())
                if got.dtype != dtype or not (math.isfinite(e) and e <= FLASH_TOL[dtype] * scale):
                    raise RuntimeError(
                        f"flash {name} kernel disagrees with its plain version at {case}: "
                        f"max abs err {e}, max|plain| {scale}, dtype {got.dtype}")
                err[name] = max(err[name], e)
                key = (name, dtype)
                share[key] = max(share.get(key, 0.0), e / (FLASH_TOL[dtype] * scale))

    def shares(name):
        return ", ".join(f"{str(dt)[6:]} {share[(name, dt)]:.4f}" for dt in (torch.float32,
                                                                             torch.bfloat16)
                         if (name, dt) in share)

    for name in names:
        print(f"flash {name}: {len(FLASH_CASES)} shapes agree with the plain version, max abs "
              f"err {err[name]}, share of the limit ({FLASH_TOL[torch.float32]} fp32, "
              f"{FLASH_TOL[torch.bfloat16]} bf16 x max|plain|): {shares(name)}"
              + (f"; lse max abs err {lse_err[name]} (tolerance {FLASH_LSE_TOL})"
                 if name in lse_err else "")
              + ("; bitwise repeatable" if name.endswith("_tc") else ""))
    for name in ("fwd", "dq", "dkv"):
        print(f"flash {name} bf16 share of the limit: tensor cores "
              f"{share[(name + '_tc', torch.bfloat16)]:.4f}, FFMA route on the same inputs "
              f"{share[(name, torch.bfloat16)]:.4f}")

    # Times at the path's shape, bf16.
    b, t, h, d, causal = FLASH_PATH
    q, k, v, do = (randn(gen, b, t, h, d, dtype=torch.bfloat16) for _ in range(4))
    out, lse = A.flash_forward_lse(q, k, v, causal)
    delta = A.flash_delta(out, do)
    args = (q, k, v, do, lse, delta, causal)
    calls = {
        "fwd": (lambda: A.flash_forward_lse(q, k, v, causal),
                lambda: A.flash_forward_lse_plain(q, k, v, causal)),
        "dq": (lambda: A.flash_dq(*args), lambda: A.flash_dq_plain(*args)),
        "dkv": (lambda: A.flash_dkv(*args), lambda: A.flash_dkv_plain(*args)),
    }
    plain_ms = {name: median_ms(plain, reps=10, warmup=2) for name, (_, plain) in calls.items()}
    ms_runs, device_ms = {}, {}
    for turn in ("tc", "ffma", "ffma", "tc"):
        ctx = flash_ffma_route() if turn == "ffma" else contextlib.nullcontext()
        with ctx:
            for base in ("fwd", "dq", "dkv"):
                name = base + ("_tc" if turn == "tc" else "")
                ms_runs.setdefault(name, []).append(median_ms(calls[base][0]))
                if name not in device_ms:
                    device_ms[name] = device_busy_ms(calls[base][0],
                                                     match=f"flash_{name}_kernel")
    # The library's attention on [B, H, T, D] copies made beforehand.
    ql, kl, vl = (x.transpose(1, 2).contiguous().requires_grad_() for x in (q, k, v))
    gl = do.transpose(1, 2).contiguous()
    ol = F.scaled_dot_product_attention(ql, kl, vl, is_causal=causal)
    library = {
        "fwd": lambda: F.scaled_dot_product_attention(ql, kl, vl, is_causal=causal),
        "bwd": lambda: torch.autograd.grad(ol, (ql, kl, vl), gl, retain_graph=True),
    }
    library_ms = {key: median_ms(fn) for key, fn in library.items()}
    library_device_ms = {key: device_busy_ms(fn) for key, fn in library.items()}

    bw, fp32_flops = card_rates(torch.cuda.get_device_name(0))
    ptxas = _build.ptxas_report(A.TC_SOURCE)
    pairs = b * h * (t * (t + 1) // 2 if causal else t * t)  # (query, key) pairs computed
    tensor_bytes = 2.0 * b * t * h * d  # one bf16 [B, T, H, D]
    row_bytes = 4.0 * b * h * t  # one fp32 [B*H, T]
    work = {  # (products of D-long rows, tensors read + written, row vectors)
        "fwd": (2, 4, 1), "dq": (3, 5, 2), "dkv": (4, 6, 2),
    }
    records = []
    for name in names:
        base = name.removesuffix("_tc")
        tc = name != base
        products, tensors, rows = work[base]
        flop = 2.0 * products * pairs * d
        nbytes = tensors * tensor_bytes + rows * row_bytes
        bytes_ms, ops_ms = nbytes / bw * 1e3, flop / BF16_FLOPS * 1e3
        lib_key = "fwd" if base == "fwd" else "bwd"
        rec = {
            "name": f"flash_{name}",
            "route": "cuda",
            "source": "cs744_pytorch_distributed_tutorial_tpu_torch/csrc/"
                      + ("flash_attention_tc.cu" if tc else "flash_attention.cu"),
            "replaces": f"cs744_pytorch_distributed_tutorial_tpu/ops/flash_attention.py:"
                        f"{FLASH_REPLACES[base]}",
            "tpu_kernel": "ops/flash_attention.py::" + {"fwd": "_kernel", "dq": "_dq_kernel",
                                                        "dkv": "_dkv_kernel"}[base]
                          + (" (tensor-core route: bf16)" if tc else
                             " (FFMA route: fp32, head_dim 32, strides TMA cannot read)"),
            "launches": None,  # filled in from the main path's run
            "max_abs_err": err[name],
            "share_of_limit": {str(dt)[6:]: share[(name, dt)] for dt in (torch.float32,
                                                                       torch.bfloat16)
                               if (name, dt) in share},
            "ms": statistics.mean(ms_runs[name]),
            "ms_runs": ms_runs[name],
            "device_ms": device_ms[name],
            "plain_ms": plain_ms[base],
            "bound_ms": max(bytes_ms, ops_ms),
            "bound_by": "bytes" if bytes_ms >= ops_ms else "operations",
            "fp32_ffma_bound_ms": flop / fp32_flops * 1e3,
            "library_ms": library_ms[lib_key],
            "library_device_ms": library_device_ms[lib_key],
            "library": ("scaled_dot_product_attention forward" if base == "fwd" else
                        "scaled_dot_product_attention backward (dq, dk and dv together)"),
            "gflop": flop / 1e9,
            "mbytes": nbytes / 1e6,
            "shape": list(FLASH_PATH),
            "dtype": "bfloat16",
        }
        if base == "fwd":
            rec["lse_max_abs_err"] = lse_err[name]
        if tc:  # ptxas's report of this process's build (None if the library was cached)
            for head_dim, key in ((d, "ptxas"), (128, "ptxas_head_dim_128")):
                rec[key] = ptxas.get(f"flash_{name}_kernel<{head_dim}>")
        rec["bound_share"] = rec["bound_ms"] / rec["ms"]
        records.append(rec)
        print(f"flash {name} at B{b} T{t} H{h} D{d} causal bf16: {flop / 1e9:.2f} GFLOP, "
              f"{nbytes / 1e6:.1f} MB; kernel {rec['ms']:.4f} ms (runs {ms_runs[name]}, device "
              f"{rec['device_ms']} ms), plain {rec['plain_ms']:.4f} ms, {rec['library']} "
              f"{rec['library_ms']:.4f} ms (device {rec['library_device_ms']} ms), bound "
              f"{rec['bound_ms']:.4f} ms ({rec['bound_by']}; {100 * rec['bound_share']:.2f} % of "
              f"it), FP32 FFMA floor {rec['fp32_ffma_bound_ms']:.4f} ms"
              + (f"; ptxas {rec['ptxas']} (head_dim 128: {rec['ptxas_head_dim_128']})" if tc
                 else ""))
    for base in ("fwd", "dq", "dkv"):
        tc_ms, ffma_ms = (statistics.mean(ms_runs[n]) for n in (base + "_tc", base))
        if not tc_ms < ffma_ms:
            raise RuntimeError(f"flash {base}: the tensor-core kernel ({tc_ms} ms) is not faster "
                               f"than the FFMA kernel it replaces ({ffma_ms} ms)")
    return records


# ------------------------------------------------------ fused cross-entropy
def fused_xent_phase(dev: torch.device) -> list[dict]:
    """Both kernels against their plain versions (the backward given the
    plain lse, so each kernel is checked on its own), then their times at
    the LM path's shape.

    Loss and lse must lie within 1e-5 x max(1, |plain lse|) of the plain
    version's in each row (both sum in fp32, in another order). Each fp32
    gradient entry within ``fp32_grad_limit`` of its plain value (8 ulp of
    the entry, plus a few ulp of p at the label's column: the same expf of
    the same inputs); each bf16 gradient entry within one bf16 ulp of its
    plain value (both round the same fp32 value once)."""
    import torch.nn.functional as F

    from cs744_pytorch_distributed_tutorial_tpu_torch.ops import fused_xent as FX

    gen = torch.Generator(device=dev).manual_seed(4)
    worst = {"fwd": 0.0, "bwd": 0.0}
    err = {"fwd": 0.0, "bwd": 0.0}
    for n, v, dtype in XENT_CASES:
        x = (4 * randn(gen, n, v)).to(dtype)
        labels = torch.randint(0, v, (n,), generator=gen, device=dev)
        g = torch.rand((n,), generator=gen, device=dev)
        loss, lse = FX.fused_xent_fwd(x, labels)
        want_loss, want_lse = FX.fused_xent_fwd_plain(x, labels)
        torch.cuda.synchronize()
        limit = XENT_TOL * want_lse.abs().clamp_min(1.0)
        e_fwd = max(float((loss - want_loss).abs().max()), float((lse - want_lse).abs().max()))
        share = max(float(((loss - want_loss).abs() / limit).max()),
                    float(((lse - want_lse).abs() / limit).max()))
        del loss, lse, want_loss, limit
        d = FX.fused_xent_bwd(x, labels, want_lse, g)
        want_d = FX.fused_xent_bwd_plain(x, labels, want_lse, g)
        torch.cuda.synchronize()
        diff = (d.float() - want_d.float()).abs()
        if dtype == torch.float32:
            dshare = float((diff / FX.fp32_grad_limit(want_d, labels, g)).max())
        else:
            wf = want_d.float().abs().clamp_min(torch.finfo(torch.float32).tiny)
            dshare = float((diff / torch.exp2(torch.floor(torch.log2(wf)) - 7)).max())
        case = f"[{n}, {v}] {dtype}"
        if d.dtype != dtype or not (math.isfinite(share) and share <= 1.0):
            raise RuntimeError(f"fused_xent fwd kernel disagrees with its plain version at {case}: "
                               f"max abs err {e_fwd}, {share} of the limit")
        if not (math.isfinite(dshare) and dshare <= 1.0):
            raise RuntimeError(f"fused_xent bwd kernel disagrees with its plain version at {case}: "
                               f"max abs err {float(diff.max())}, {dshare} of the limit")
        err["fwd"], err["bwd"] = max(err["fwd"], e_fwd), max(err["bwd"], float(diff.max()))
        worst["fwd"], worst["bwd"] = max(worst["fwd"], share), max(worst["bwd"], dshare)
        print(f"fused_xent {case}: loss/lse max abs err {e_fwd} ({share:.3f} of the limit), "
              f"gradient max abs err {float(diff.max())} ({dshare:.3f} of the limit)")
        del x, d, want_d, diff, want_lse
        torch.cuda.empty_cache()
    print(f"fused_xent: {len(XENT_CASES)} cases agree with the plain versions; largest share of "
          f"the limit: fwd {worst['fwd']:.3f}, bwd {worst['bwd']:.3f} (limits: loss and lse "
          f"{XENT_TOL} x max(1, |lse|); gradient per entry: 2^-20 x |plain| + 2^-22 x g at the "
          f"label fp32, one ulp bf16)")

    # Times at the path's shape, fp32 (and the kernels on bf16 logits).
    n, v = XENT_PATH
    x = 4 * randn(gen, n, v)
    xb = x.bfloat16()
    labels = torch.randint(0, v, (n,), generator=gen, device=dev)
    g = torch.full((n,), 1.0 / n, device=dev)  # the mean's gradient
    _, lse = FX.fused_xent_fwd(x, labels)
    _, lse_b = FX.fused_xent_fwd(xb, labels)
    xl = x.detach().requires_grad_()
    lib_loss = F.cross_entropy(xl, labels, reduction="none")
    calls = {
        "fwd": (lambda: FX.fused_xent_fwd(x, labels), lambda: FX.fused_xent_fwd_plain(x, labels),
                lambda: FX.fused_xent_fwd(xb, labels),
                lambda: F.cross_entropy(x, labels, reduction="none")),
        "bwd": (lambda: FX.fused_xent_bwd(x, labels, lse, g),
                lambda: FX.fused_xent_bwd_plain(x, labels, lse, g),
                lambda: FX.fused_xent_bwd(xb, labels, lse_b, g),
                lambda: torch.autograd.grad(lib_loss, xl, g, retain_graph=True)),
    }
    bw, fp32_flops = card_rates(torch.cuda.get_device_name(0))
    records = []
    for name, (kernel, plain, kernel_bf16, library) in calls.items():
        passes = 1 if name == "fwd" else 2  # the logits read; and the gradient written
        nbytes = passes * 4.0 * n * v + 16.0 * n  # + labels (int64), two fp32 row vectors
        flop = 4.0 * n * v  # max, subtract, exp, add (fwd); subtract, exp, onehot, scale (bwd)
        bytes_ms, ops_ms = nbytes / bw * 1e3, flop / fp32_flops * 1e3
        rec = {
            "name": f"fused_xent_{name}",
            "route": "cuda",
            "source": "cs744_pytorch_distributed_tutorial_tpu_torch/csrc/fused_xent.cu",
            "replaces": "cs744_pytorch_distributed_tutorial_tpu/ops/fused_xent.py:"
                        + ("48" if name == "fwd" else "79"),
            "tpu_kernel": "ops/fused_xent.py::" + ("_kernel" if name == "fwd" else "_bwd_kernel"),
            "launches": None,  # filled in from the main path's run
            "max_abs_err": err[name],
            "share_of_limit": worst[name],
            "ms": median_ms(kernel),
            "device_ms": device_busy_ms(kernel, match=f"xent_{name}_kernel"),
            "bf16_ms": median_ms(kernel_bf16),
            "plain_ms": median_ms(plain, reps=10, warmup=2),
            "bound_ms": max(bytes_ms, ops_ms),
            "bound_by": "bytes" if bytes_ms >= ops_ms else "operations",
            "library_ms": median_ms(library),
            "library_device_ms": device_busy_ms(library),
            "library": ("F.cross_entropy(reduction='none') forward" if name == "fwd" else
                        "F.cross_entropy(reduction='none') backward"),
            "shape": [n, v], "dtype": "float32", "mbytes": nbytes / 1e6,
        }
        rec["bound_share"] = rec["bound_ms"] / rec["ms"]
        records.append(rec)
        print(f"fused_xent {name} at [{n}, {v}] fp32: {nbytes / 1e6:.1f} MB; kernel "
              f"{rec['ms']:.4f} ms (device {rec['device_ms']} ms; bf16 logits {rec['bf16_ms']:.4f} "
              f"ms), plain {rec['plain_ms']:.4f} ms, {rec['library']} {rec['library_ms']:.4f} ms "
              f"(device {rec['library_device_ms']} ms), bound {rec['bound_ms']:.4f} ms "
              f"({rec['bound_by']}; {100 * rec['bound_share']:.2f} % of it)")
    del x, xb, xl, lib_loss, calls
    torch.cuda.empty_cache()
    return records


# ------------------------------------------------------------- the LM path
def lm_flops_per_token(layers: int, d: int, d_ff: int, t: int, vocab: int) -> float:
    """Training FLOPs a token, as benchmarks/bench_lm_gpt2.py counts them:
    3x the forward's q/k/v/o, MLP, attention (causal not discounted) and
    head matmuls."""
    per_layer = 4 * d**2 + 2 * d * d_ff + 2 * t * d
    return 3.0 * (layers * 2.0 * per_layer + 2.0 * d * vocab)


def lm_config(**kw):
    from cs744_pytorch_distributed_tutorial_tpu_torch.train.lm import LMConfig

    base = dict(LM_WIDTH, global_batch_size=16, use_rope=True, attention_impl="flash",
                compute_dtype="bfloat16", optimizer="adamw", device="cuda")
    return LMConfig(**{**base, **kw})


def flash_counts() -> dict:
    """The flash launches since the last reset by kernel and route: fwd,
    dq and dkv (FFMA), fwd_tc, dq_tc and dkv_tc (tensor cores)."""
    from cs744_pytorch_distributed_tutorial_tpu_torch.ops import flash_attention as A

    return {name + ("_tc" if route == "tc" else ""): A.launch_count(name, route=route)
            for name in A.KERNELS for route in A.ROUTES}


def lm_main_path_phase() -> dict:
    """Returns the launches of each flash and fused cross-entropy kernel."""
    from cs744_pytorch_distributed_tutorial_tpu_torch import lm_cli
    from cs744_pytorch_distributed_tutorial_tpu_torch.ops import flash_attention as A
    from cs744_pytorch_distributed_tutorial_tpu_torch.ops import fused_xent as FX

    argv = [arg for key, value in LM_WIDTH.items()
            for arg in (f"--{key.replace('_', '-')}", str(value))]
    argv += ["--global-batch-size", "16", "--use-rope", "--attention-impl", "flash",
             "--fused-xent", "--compute-dtype", "bfloat16", "--optimizer", "adamw", "--steps",
             str(LM_STEPS), "--num-seqs", "400", "--eval-frac", "0.04", "--json", "--device",
             "cuda"]
    t0 = time.perf_counter()
    summary, all_counts = counted(lambda: run_cli(argv, main=lm_cli.main))
    wall = time.perf_counter() - t0
    counts = flash_counts()
    xent = {name: FX.launch_count(name, torch.float32) for name in FX.KERNELS}
    bf16 = A.launch_count(dtype=torch.bfloat16)
    if others(all_counts, "flash", "fused_xent"):
        raise RuntimeError(f"the LM path launched another kernel than flash and fused_xent: "
                           f"{all_counts}")
    layers = LM_WIDTH["num_layers"]
    # 24 training forwards and one eval forward (400 sequences: 16 held out,
    # one eval batch; 384 train, 24 distinct batches) per layer, the forward
    # and the backward's dq and dk/dv all on the tensor cores; one fused
    # cross-entropy forward and backward a training step on the fp32
    # logits (the eval takes plain CE, as the JAX package's).
    expect = {"fwd": 0, "dq": 0, "dkv": 0, "fwd_tc": layers * (LM_STEPS + 1),
              "dq_tc": layers * LM_STEPS, "dkv_tc": layers * LM_STEPS}
    if counts != expect or bf16 != sum(expect.values()):
        raise RuntimeError(f"LM path flash launches {counts} (bf16 {bf16}), expected {expect}")
    if xent != {"fwd": LM_STEPS, "bwd": LM_STEPS} or all_counts["fused_xent"] != 2 * LM_STEPS:
        raise RuntimeError(f"LM path fused_xent launches {xent} (all dtypes "
                           f"{all_counts['fused_xent']}), expected {LM_STEPS} each, fp32")
    if summary["steps_run"] != LM_STEPS or not summary["finite"]:
        raise RuntimeError(f"LM path: {summary}")
    first, final = summary["first_loss"], summary["final_loss"]
    if not (math.isfinite(first) and math.isfinite(final) and final < first):
        raise RuntimeError(f"LM path loss did not fall: first {first}, final {final}")
    if not math.isfinite(summary["eval"]["loss"]):
        raise RuntimeError(f"LM path eval loss not finite: {summary['eval']}")
    print(f"LM main path: {LM_STEPS} steps + eval in {wall:.1f} s wall (model build and "
          f"first-step set-up included), loss {first} -> {final}, eval {summary['eval']}, "
          f"flash launches {counts}, fused_xent launches {xent}")
    return {**{f"flash_{k}": n for k, n in counts.items()},
            **{f"fused_xent_{k}": n for k, n in xent.items()}}


def lm_lion_phase() -> None:
    """GPT-2-small through ``lm_cli`` with Lion, a warmup-cosine schedule
    over its 6 steps and the global-norm clip (bf16, flash)."""
    from cs744_pytorch_distributed_tutorial_tpu_torch import lm_cli

    steps = 6
    argv = [arg for key, value in LM_WIDTH.items()
            for arg in (f"--{key.replace('_', '-')}", str(value))]
    argv += ["--global-batch-size", "16", "--use-rope", "--attention-impl", "flash",
             "--compute-dtype", "bfloat16", "--optimizer", "lion", "--lr", "1e-4",
             "--lr-schedule", "warmup_cosine", "--warmup-steps", "2", "--grad-clip-norm", "1.0",
             "--steps", str(steps), "--num-seqs", "120", "--json", "--device", "cuda"]
    t0 = time.perf_counter()
    summary = run_cli(argv, main=lm_cli.main)
    wall = time.perf_counter() - t0
    if summary["steps_run"] != steps or not summary["finite"]:
        raise RuntimeError(f"LM Lion run: {summary}")
    print(f"LM lion warmup_cosine clip: {steps} steps in {wall:.1f} s wall (build included), "
          f"loss {summary['first_loss']} -> {summary['final_loss']}; card {card_line()}")


def _timed_steps(tr, batches, steps: int) -> float:
    """ms per ``train_step`` over ``steps`` steps, fenced by CUDA events."""
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for i in range(steps):
        tr.train_step(*batches[i % len(batches)])
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / steps


def lm_throughput_phase() -> dict:
    """``LMTrainer.train_step`` at the main path's config, 3 warm-up steps
    then LM_TIMED_STEPS timed, with flash and the fused cross-entropy (the
    main path), flash alone and dense attention; then a profile of 3 steps
    on pre-staged batches with and without the fused cross-entropy."""
    from cs744_pytorch_distributed_tutorial_tpu_torch.data import synthetic_tokens
    from cs744_pytorch_distributed_tutorial_tpu_torch.train.lm import LMTrainer

    b, t = 16, LM_WIDTH["seq_len"]
    toks = synthetic_tokens(4 * b, t, LM_WIDTH["vocab_size"], seed=1)
    flops = lm_flops_per_token(LM_WIDTH["num_layers"], LM_WIDTH["d_model"], LM_WIDTH["d_ff"],
                               t, LM_WIDTH["vocab_size"])
    peak = BF16_FLOPS
    out: dict = {"flops_per_token": flops}
    for impl, kw in (("flash+fused_xent", dict(attention_impl="flash", fused_xent=True)),
                     ("flash", dict(attention_impl="flash")),
                     ("dense", dict(attention_impl="dense"))):
        tr = LMTrainer(lm_config(**kw))
        model, _ = tr.init()
        params = list(model.parameters())
        n = sum(p.numel() for p in params)
        if (n, len(params)) != (LM_PARAMS, LM_TENSORS):
            raise RuntimeError(f"GPT-2-small has {n} parameters in {len(params)} tensors")
        batches = [tr.split_batch(toks[i * b : (i + 1) * b]) for i in range(4)]
        torch.cuda.reset_peak_memory_stats()
        _timed_steps(tr, batches, 3)
        ms = _timed_steps(tr, batches, LM_TIMED_STEPS)
        tok_s = b * t / (ms / 1e3)
        out[impl] = {"ms_per_step": ms, "tokens_per_s": tok_s, "mfu": tok_s * flops / peak,
                     "peak_memory_gb": torch.cuda.max_memory_allocated() / 1e9}
        print(f"LM throughput {impl}: {ms:.3f} ms/step, {tok_s:.1f} tokens/s, MFU "
              f"{100 * out[impl]['mfu']:.2f} % of {peak / 1e12:.0f} TFLOP/s bf16 "
              f"({flops / 1e9:.4f} GFLOP/token), peak memory {out[impl]['peak_memory_gb']:.2f} GB, "
              f"{n} parameters in {len(params)} tensors")
        if impl != "dense":
            out[f"profile_{impl}"] = lm_profile(tr, batches, impl)
        del tr, model, params, batches
        torch.cuda.empty_cache()
    return out


def lm_profile(tr, batches, label: str) -> dict:
    """Where a flash step's device time goes: 3 steps on batches already
    on the card, traced with torch.profiler (idle share as in
    ``profile_phase``); the cross-entropy's kernels apart, fused or the
    library's (``cunn_SoftMax{Forward,Backward}`` and ``nll_loss``)."""
    from torch.profiler import ProfilerActivity, profile

    steps = 3
    tr.train_step(*batches[0])
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        for i in range(steps):
            tr.train_step(*batches[i % len(batches)])
        torch.cuda.synchronize()
    names = ("fwd", "dq", "dkv", "fwd_tc", "dq_tc", "dkv_tc")
    groups = {f"flash_{n}": (f"flash_{n}_kernel",) for n in names}
    groups["cross_entropy"] = ("xent_fwd_kernel", "xent_bwd_kernel", "SoftMax", "nll_loss")
    out = summarize_profile(prof, steps, f"profile LM {label}", groups)
    if not out:
        return {}
    flash_ms = sum(out[f"flash_{n}_ms_per_step"] for n in names)
    out["flash_share_of_busy"] = flash_ms / out["device_busy_ms_per_step"]
    out["cross_entropy_share_of_busy"] = (out["cross_entropy_ms_per_step"]
                                          / out["device_busy_ms_per_step"])
    print(json.dumps({"lm_step_profile": {"config": label, **out}}))
    return out


def lm_trajectory_phase() -> None:
    """Two pairs of runs: flash kernels vs dense attention, and the fused
    cross-entropy kernels vs the library's cross-entropy (both with flash).
    2 layers at full width, batch 4, T 1024, fp32 with TF32 off (set in
    main), 4 AdamW steps from the same init on the same batches: losses
    within rtol 1e-4, the first step's gradient norm (same weights, so a
    wrong gradient kernel shows here before Adam's step sizes hide it)
    within rtol 1e-5, and every parameter within 1e-3 after the 4 steps
    (3.97e-4 measured for flash vs dense on an H100 SXM)."""
    from cs744_pytorch_distributed_tutorial_tpu_torch.data import synthetic_tokens
    from cs744_pytorch_distributed_tutorial_tpu_torch.train.lm import LMTrainer

    toks = synthetic_tokens(16, LM_WIDTH["seq_len"], LM_WIDTH["vocab_size"], seed=3)
    for label, pair in (
        ("flash vs dense", {"flash": dict(attention_impl="flash"),
                            "dense": dict(attention_impl="dense")}),
        ("fused_xent vs plain CE", {"fused_xent": dict(attention_impl="flash", fused_xent=True),
                                    "plain CE": dict(attention_impl="flash")}),
    ):
        losses, grad_norms, params = {}, {}, {}
        for name, kw in pair.items():
            tr = LMTrainer(lm_config(num_layers=2, global_batch_size=4, compute_dtype="float32",
                                     **kw))
            model, _ = tr.init()
            steps = [tr.train_step(*tr.split_batch(toks[4 * s : 4 * s + 4])) for s in range(4)]
            losses[name] = [float(m["loss"]) for m in steps]
            grad_norms[name] = [float(m["grad_norm"]) for m in steps]
            params[name] = [p.detach() for p in model.parameters()]
            del tr, model
        a_name, b_name = pair
        for a, b in zip(losses[a_name], losses[b_name]):
            if not (math.isfinite(a) and abs(a - b) <= 1e-4 * abs(b)):
                raise RuntimeError(f"LM {label} trajectories differ: {losses}")
        g_a, g_b = grad_norms[a_name][0], grad_norms[b_name][0]
        if not abs(g_a - g_b) <= 1e-5 * abs(g_b):
            raise RuntimeError(f"LM {label} first-step gradient norms differ: {g_a} vs {g_b}")
        gap = max(float((a - b).abs().max()) for a, b in zip(params[a_name], params[b_name]))
        del params
        torch.cuda.empty_cache()
        if not gap <= 1e-3:
            raise RuntimeError(f"LM {label} parameters differ by {gap} after 4 steps")
        print(f"trajectory LM {label} (2 layers, full width, fp32): {a_name} {losses[a_name]} "
              f"{b_name} {losses[b_name]}; grad norms {a_name} {grad_norms[a_name]} {b_name} "
              f"{grad_norms[b_name]}; max abs parameter gap after 4 steps {gap}")



def lm_flash_route_trajectory_phase() -> dict:
    """Flash's tensor-core route (forward, dq and dk/dv) against its FFMA
    route over LM_ROUTE_STEPS AdamW steps (lr LM_ROUTE_LR) of GPT-2-small
    at full width and 2 layers, batch 4 x T 1024, bf16 compute (the LM
    path's dtype, where the routes differ), from one init on the same
    batches; each run's launches show its route. Limits as the MoE route
    trajectory's: losses within rtol 1e-4; the first step's gradient norm
    (same weights) within rtol 1e-4; the parameters within 2 x lr a step at
    most (AdamW moves an element by about lr whatever its gradient's size,
    so one whose gradient's sign rests on rounding may step the other way)
    and 1e-4 on average. A third run through the plain versions of the
    forward, dq and dk/dv (fp32 einsums: a third order of the same sums; no
    flash kernel) is printed beside them as the yardstick. Returns each
    run's flash launches."""
    from cs744_pytorch_distributed_tutorial_tpu_torch.data import synthetic_tokens
    from cs744_pytorch_distributed_tutorial_tpu_torch.ops import flash_attention as A
    from cs744_pytorch_distributed_tutorial_tpu_torch.train.lm import LMTrainer

    b, layers = 4, 2
    toks = synthetic_tokens(b * LM_ROUTE_STEPS, LM_WIDTH["seq_len"], LM_WIDTH["vocab_size"],
                            seed=6)
    routes = {"tensor_cores": contextlib.nullcontext, "ffma": flash_ffma_route,
              "plain": plain_flash}
    runs, launches = {}, {}
    for name, route in routes.items():
        tr = LMTrainer(lm_config(num_layers=layers, global_batch_size=b,
                                 learning_rate=LM_ROUTE_LR))
        model, _ = tr.init()
        A.reset_launch_count()
        with route():
            steps = [tr.train_step(*tr.split_batch(toks[b * i : b * (i + 1)]))
                     for i in range(LM_ROUTE_STEPS)]
        torch.cuda.synchronize()
        launches[name] = {k: n for k, n in flash_counts().items() if n}
        runs[name] = ({k: [float(m[k]) for m in steps] for k in ("loss", "grad_norm")},
                      [p.detach() for p in model.parameters()])
        del tr, model
    n = layers * LM_ROUTE_STEPS
    want = {"tensor_cores": {"fwd_tc": n, "dq_tc": n, "dkv_tc": n},
            "ffma": {"fwd": n, "dq": n, "dkv": n}, "plain": {}}
    if launches != want:
        raise RuntimeError(f"LM flash route trajectory launches {launches}, expected {want}")

    def gaps(x, y):
        d = torch.cat([(p - q).abs().flatten() for p, q in zip(runs[x][1], runs[y][1])])
        return float(d.max()), float(d.mean())

    (gap, mean_gap), (ref_gap, ref_mean) = gaps("tensor_cores", "ffma"), gaps("plain", "ffma")
    ht, hf, hp = (runs[k][0] for k in routes)
    del runs
    torch.cuda.empty_cache()
    loss_rel = max(abs(x - y) / abs(y) for x, y in zip(ht["loss"], hf["loss"]))
    g_t, g_f = ht["grad_norm"][0], hf["grad_norm"][0]
    summary = (f"losses tensor cores {ht['loss']} FFMA {hf['loss']} plain {hp['loss']} (max "
               f"relative gap {loss_rel:.3e}); grad norms tensor cores {ht['grad_norm']} FFMA "
               f"{hf['grad_norm']} plain {hp['grad_norm']}; parameter gap after "
               f"{LM_ROUTE_STEPS} steps max {gap} mean {mean_gap} (plain vs FFMA: max {ref_gap} "
               f"mean {ref_mean})")
    if not all(math.isfinite(x) and abs(x - y) <= 1e-4 * abs(y)
               for x, y in zip(ht["loss"], hf["loss"])):
        raise RuntimeError(f"LM flash route trajectory losses differ: {summary}")
    if not abs(g_t - g_f) <= 1e-4 * abs(g_f):
        raise RuntimeError(f"LM flash route trajectory first-step gradient norms differ: "
                           f"{summary}")
    if not (gap <= 2 * LM_ROUTE_LR * LM_ROUTE_STEPS and mean_gap <= 1e-4):
        raise RuntimeError(f"LM flash route trajectory parameters differ: {summary}")
    print(f"trajectory LM flash tensor-core vs FFMA route (2 layers, full width, batch "
          f"{b}, bf16): {summary}; launches {launches}")
    return launches

# ------------------------------------------------------------ paged attention
def paged_inputs(gen: torch.Generator, case: tuple, variant: str) -> dict:
    """Pools, a shuffled table, the case's depths (or ragged ones, slot 0
    at depth 0), and every page a slot does not hold live: NaN in the
    float pools, or in the scale pools of int8 ones; the plain version is
    given the values before."""
    dtype, q_dtype = PAGED_VARIANTS[variant]
    b, hq, hkv, d, ps, ppr, *extra = case
    pos_list, narrow = (list(extra) + [None, None])[:2]
    dev = gen.device
    num_pages = b * ppr + 1
    table = (1 + torch.randperm(num_pages - 1, generator=gen, device=dev)).view(b, ppr)
    table = table.to(torch.int32)
    if pos_list is None:
        pos = torch.randint(0, ppr * ps, (b,), generator=gen, device=dev).to(torch.int32)
        pos[0] = 0
    else:
        pos = torch.tensor(pos_list, dtype=torch.int32, device=dev)
    live = torch.arange(ppr, device=dev)[None, :] <= (pos // ps)[:, None].long()
    dead = table[~live].long()
    shape = (num_pages, ps, hkv, d)
    q = randn(gen, b, 1, hq, d, dtype=q_dtype)
    if dtype == torch.int8:
        kp, vp = (torch.randint(-127, 128, shape, generator=gen, device=dev).to(dtype)
                  for _ in range(2))
        ks, vs = (torch.rand(shape[:3], generator=gen, device=dev) / 127 + 0.5 / 127
                  for _ in range(2))
        plain = dict(key_pages=kp, value_pages=vp, key_scale_pages=ks.clone(),
                     value_scale_pages=vs.clone())
        ks[dead], vs[dead] = float("nan"), float("nan")
        kernel = dict(key_pages=kp, value_pages=vp, key_scale_pages=ks, value_scale_pages=vs)
    else:
        kp, vp = (randn(gen, *shape, dtype=dtype) for _ in range(2))
        plain = dict(key_pages=kp.clone(), value_pages=vp.clone())
        kp[dead], vp[dead] = float("nan"), float("nan")
        kernel = dict(key_pages=kp, value_pages=vp)
    return {"q": q, "table": table, "pos": pos, "kernel": kernel, "plain": plain,
            "pages_per_slot": narrow}


def paged_phase(dev: torch.device) -> dict:
    """The kernels against the gather path at every case and variant (two
    calls bitwise equal), then their times at the serving shape in bf16
    and int8 pages with bf16 q (the serving path's variants).

    fp32 outputs must lie within 2e-5 of the plain version's. A bf16
    output may differ by one bf16 ulp of the plain value (2^-7 of it),
    since both round their fp32 result, plus 2^-8 S, S = sum_i p_i |v_i|
    (the plain version over |V|): with float pools both sides round each
    probability to bf16 before PV, to within 2^-8 of it, the kernels
    exp(s - a span's or a running max) and the plain version the
    normalised p, so the two sums differ by a few parts in 2^-8 S (1e-6 is
    added for outputs of 0). At depths of 100-511 S is about 0.8, and one
    key dropped or counted twice moves some output of its slot by more
    than that limit."""
    import torch.nn.functional as F

    from cs744_pytorch_distributed_tutorial_tpu_torch.ops import paged_attention as PA
    from cs744_pytorch_distributed_tutorial_tpu_torch.parallel.ring_attention import gather_pages

    gen = torch.Generator(device=dev).manual_seed(5)
    err, worst = {}, {}
    PA.reset_launch_count()
    for case in PAGED_CASES:
        for variant in PAGED_VARIANTS:
            x = paged_inputs(gen, case, variant)
            q, table, pos, narrow = x["q"], x["table"], x["pos"], x["pages_per_slot"]
            kern, plain = dict(x["kernel"]), dict(x["plain"])
            kpk, vpk = kern.pop("key_pages"), kern.pop("value_pages")
            kp, vp = plain.pop("key_pages"), plain.pop("value_pages")
            want = PA.paged_attention_plain(q, kp, vp, table, pos, pages_per_slot=narrow, **plain)
            if want.dtype == torch.float32:
                limit = torch.full_like(want, PAGED_FP32_TOL)
            else:
                wide = (lambda t: t) if kp.dtype == torch.int8 else torch.Tensor.float
                spread = PA.paged_attention_plain(q.float(), wide(kp), wide(vp).abs(), table,
                                                  pos, pages_per_slot=narrow, **plain)
                limit = 2**-7 * want.float().abs() + 2**-8 * spread + 1e-6
            got = PA.paged_attention(q, kpk, vpk, table, pos, pages_per_slot=narrow, **kern)
            torch.cuda.synchronize()
            e = float((got.float() - want.float()).abs().max())
            ratio = float(((got.float() - want.float()).abs() / limit).max())
            if got.dtype != want.dtype or not (math.isfinite(e) and ratio <= 1.0):
                raise RuntimeError(f"paged attention disagrees with its plain version at {case} "
                                   f"{variant}: max abs err {e}, {ratio} of the limit, dtype "
                                   f"{got.dtype}")
            again = PA.paged_attention(q, kpk, vpk, table, pos, pages_per_slot=narrow, **kern)
            if not torch.equal(got, again):
                raise RuntimeError(f"paged attention is not repeatable at {case} {variant}")
            err[variant] = max(err.get(variant, 0.0), e)
            worst[variant] = max(worst.get(variant, 0.0), ratio)
    # two calls a case and variant, two launches a call (the spans, the merge)
    want_launches = 4 * len(PAGED_CASES) * len(PAGED_VARIANTS)
    if PA.launch_count() != want_launches:
        raise RuntimeError(f"paged attention: {PA.launch_count()} launches, expected "
                           f"{want_launches}")
    print(f"paged attention: {len(PAGED_CASES)} cases x {tuple(PAGED_VARIANTS)} (pool/q) agree "
          f"with the gather path, dead pages NaN, bitwise repeatable; max abs err {err}; "
          f"largest share of the limit {worst} (limit: {PAGED_FP32_TOL} fp32; 2^-7 |plain| + "
          f"2^-8 sum p|v| + 1e-6 bf16)")

    bw, fp32_flops = card_rates(torch.cuda.get_device_name(0))
    b, hq, hkv, d, ps, ppr = PAGED_SERVE
    timed = {}
    for variant in ("bfloat16", "int8_bf16q"):
        x = paged_inputs(gen, PAGED_SERVE, variant)
        q, table, pos = x["q"], x["table"], x["pos"]
        kw = x["plain"]
        kp, vp = kw["key_pages"], kw["value_pages"]
        scales = {k: v for k, v in kw.items() if "scale" in k}
        keys = int((pos.long() + 1).sum())  # live rows read, summed over slots
        elt = kp.element_size()
        nbytes = (2.0 * keys * hkv * d * elt + (8.0 * keys * hkv if scales else 0.0)
                  + 2 * q.numel() * q.element_size() + 4.0 * (table.numel() + b))
        flop = 4.0 * keys * hq * d
        bytes_ms, ops_ms = nbytes / bw * 1e3, flop / fp32_flops * 1e3

        def call():
            return PA.paged_attention(q, kp, vp, table, pos, **scales)

        spans = -(-(ppr * ps) // PA.SPAN)
        t = {
            "ms": median_ms(call),
            "device_ms": device_busy_ms(call, match="paged_decode"),
            "plain_ms": median_ms(lambda: PA.paged_attention_plain(q, kp, vp, table, pos,
                                                                   **scales)),
            "bound_ms": max(bytes_ms, ops_ms),
            "bound_by": "bytes" if bytes_ms >= ops_ms else "operations",
            "live_rows": keys, "mbytes": nbytes / 1e6, "max_pos": int(pos.max()),
            "grid_blocks": hkv * b * spans,
            "live_blocks": hkv * int(((pos.long() + PA.SPAN) // PA.SPAN).sum()),
        }
        t["bound_share"] = t["bound_ms"] / t["ms"]
        if t["device_ms"]:
            t["bound_share_device"] = t["bound_ms"] / t["device_ms"]
        if not scales:
            rep = hq // hkv
            mask = (torch.arange(ppr * ps, device=dev)[None, :] <= pos[:, None])[:, None, None]

            def library():
                k = gather_pages(kp, table).transpose(1, 2).repeat_interleave(rep, dim=1)
                v = gather_pages(vp, table).transpose(1, 2).repeat_interleave(rep, dim=1)
                return F.scaled_dot_product_attention(q.transpose(1, 2), k, v, attn_mask=mask)

            t["library_ms"] = median_ms(library)
            t["library_device_ms"] = device_busy_ms(library)
        timed[variant] = t
        print(f"paged attention at {PAGED_SERVE} {variant}, {keys} live rows (depths up to "
              f"{t['max_pos']}), {nbytes / 1e6:.3f} MB: kernels {t['ms']:.4f} ms (device "
              f"{t['device_ms']} ms; {t['live_blocks']} live of {t['grid_blocks']} blocks), "
              f"plain {t['plain_ms']:.4f} ms"
              + (f", gather + SDPA {t['library_ms']:.4f} ms (device {t['library_device_ms']} ms)"
                 if "library_ms" in t else "")
              + f", bound {t['bound_ms']:.5f} ms ({t['bound_by']})")
    if timed["bfloat16"]["live_blocks"] < 132:
        raise RuntimeError(f"paged attention: {timed['bfloat16']['live_blocks']} blocks with "
                           f"live keys at the serving shape, fewer than the card's 132 SMs")
    main_t = timed["bfloat16"]
    return {
        "name": "paged_attention",
        "route": "cuda",
        "source": "cs744_pytorch_distributed_tutorial_tpu_torch/csrc/paged_attention.cu",
        "replaces": "cs744_pytorch_distributed_tutorial_tpu/ops/paged_attention.py:74",
        "tpu_kernel": "ops/paged_attention.py::_decode_kernel",
        "kernels": "paged_decode_split_kernel + paged_decode_merge_kernel",
        "launches": None,  # filled in from the serving path's run (two a call)
        "max_abs_err": max(err.values()),
        "max_abs_err_by_variant": err,
        "share_of_limit_by_variant": worst,
        **{k: main_t[k] for k in ("ms", "device_ms", "plain_ms", "bound_ms", "bound_by",
                                   "live_blocks", "grid_blocks")},
        "library_ms": main_t["library_ms"],
        "library_device_ms": main_t["library_device_ms"],
        "library": "gather_pages + repeat_interleave + scaled_dot_product_attention (per-slot mask)",
        "shape": list(PAGED_SERVE), "dtype": "bfloat16",
        "int8_bf16q": timed["int8_bf16q"],
    }


# ---------------------------------------------------------- int8 weight matmul
def int8_route(route: str):
    """The int8 matmul on one route (``tc`` or ``ffma``) whatever the call
    (the route rule, patched for the block), for a route-vs-route
    comparison."""
    from cs744_pytorch_distributed_tutorial_tpu_torch.ops import quant as QT

    return patched(QT, tc_route=lambda *args, **kw: route == "tc")


def int8_matmul_phase(dev: torch.device) -> list[dict]:
    """Both kernels against the plain version at INT8_SHAPES: fp32 x on the
    FFMA kernel (the rule's only route for it), bf16 x on the route the
    rule takes and on each route in turn, every call's route shown by its
    launches. Then the bf16 times of the two routes in turn at each shape
    (tensor cores, FFMA, FFMA, tensor cores: the mean of the two medians)
    beside the bound, the plain version's and ``torch.matmul`` on the
    widened weight. The tensor-core kernel must be the faster at a prompt
    pass. Returns the FFMA and tensor-core records."""
    from cs744_pytorch_distributed_tutorial_tpu_torch.ops import _build
    from cs744_pytorch_distributed_tutorial_tpu_torch.ops import quant as QT

    gen = torch.Generator(device=dev).manual_seed(6)
    bw, fp32_flops = card_rates(torch.cuda.get_device_name(0))
    err = {"ffma": 0.0, "tc": 0.0}
    share = {"ffma": 0.0, "tc": 0.0}  # bf16: max of err / limit over the elements
    rules, timed = {}, {}

    def launched(route: str, fn):
        QT.reset_launch_count()
        out = fn()
        torch.cuda.synchronize()
        got = {r: QT.launch_count(route=r) for r in QT.ROUTES if QT.launch_count(route=r)}
        if got != {route: 1}:
            raise RuntimeError(f"int8_matmul launches {got}, expected one on {route}")
        return out

    for label, (m, k, n) in INT8_SHAPES.items():
        q, scale = QT.quantize_int8(randn(gen, k, n))
        x32 = randn(gen, m, k)
        rules[label] = "tc" if QT.tc_route(torch.bfloat16, m, k, n) else "ffma"
        for dtype in (torch.float32, torch.bfloat16):
            x = x32.to(dtype)
            want = QT.int8_matmul_plain(x, q, scale)
            if dtype == torch.float32:
                runs = [("ffma", launched("ffma", lambda: QT.int8_matmul(x, q, scale)))]
            else:
                rule = rules[label]
                runs = [(rule, launched(rule, lambda: QT.int8_matmul(x, q, scale)))]
                for route in ("tc", "ffma"):
                    with int8_route(route):
                        runs.append((route, launched(route, lambda: QT.int8_matmul(x, q, scale))))
            top = float(want.float().abs().max())
            for route, got in runs:
                diff = (got.float() - want.float()).abs()
                if dtype == torch.float32:
                    ok = float(diff.max()) <= 1e-5 * top
                else:
                    limit = 2**-7 * want.float().abs() + 1e-5 * top
                    ok = bool((diff <= limit).all())
                    share[route] = max(share[route], float((diff / limit).max()))
                if got.dtype != dtype or not ok:
                    raise RuntimeError(f"int8_matmul {route} kernel disagrees with its plain "
                                       f"version at {label} [{m},{k}]x[{k},{n}] {dtype}: max abs "
                                       f"err {float(diff.max())}, max|plain| {top}")
                err[route] = max(err[route], float(diff.max()))
                del diff
            del runs, want
        xb = x32.bfloat16()
        nbytes = k * n + 2.0 * m * k + 2.0 * m * n + 4.0 * n
        flop = 2.0 * m * k * n
        bytes_ms, ops_ms = nbytes / bw * 1e3, flop / BF16_FLOPS * 1e3
        def call():
            return QT.int8_matmul(xb, q, scale)

        ms_runs, device_ms = {}, {}
        for turn in ("tc", "ffma", "ffma", "tc"):
            with int8_route(turn):
                ms_runs.setdefault(turn, []).append(median_ms(call))
                if turn not in device_ms:
                    device_ms[turn] = device_busy_ms(
                        call, match="int8_matmul_tc_kernel" if turn == "tc" else
                        "int8_matmul_kernel")
        t = {
            "shape": [m, k, n], "dtype": "bfloat16", "rule": rules[label],
            "ms": {r: statistics.mean(v) for r, v in ms_runs.items()}, "ms_runs": ms_runs,
            "device_ms": device_ms,
            "fp32_ms": median_ms(lambda: QT.int8_matmul(x32, q, scale)),
            "plain_ms": median_ms(lambda: QT.int8_matmul_plain(xb, q, scale), reps=10),
            "library_ms": median_ms(lambda: torch.matmul(xb, q.to(xb.dtype)) * scale),
            "bound_ms": max(bytes_ms, ops_ms),
            "bound_by": "bytes" if bytes_ms >= ops_ms else "operations",
            "fp32_ffma_bound_ms": flop / fp32_flops * 1e3,
            "gflop": flop / 1e9, "mbytes": nbytes / 1e6,
        }
        t["bound_share"] = {r: t["bound_ms"] / v for r, v in t["ms"].items()}
        timed[label] = t
        print(f"int8_matmul {label} [{m},{k}]x[{k},{n}] bf16 (the rule takes {rules[label]}): "
              f"{flop / 1e9:.2f} GFLOP, {nbytes / 1e6:.1f} MB; tensor cores {t['ms']['tc']:.4f} "
              f"ms (runs {ms_runs['tc']}, device {device_ms['tc']} ms), FFMA "
              f"{t['ms']['ffma']:.4f} ms (runs {ms_runs['ffma']}, device {device_ms['ffma']} ms; "
              f"fp32 x {t['fp32_ms']:.4f} ms), plain {t['plain_ms']:.4f} ms, torch.matmul on the "
              f"widened weight {t['library_ms']:.4f} ms, bound {t['bound_ms']:.4f} ms "
              f"({t['bound_by']}; tensor cores {100 * t['bound_share']['tc']:.2f} %, FFMA "
              f"{100 * t['bound_share']['ffma']:.2f} % of it), FP32 FFMA floor "
              f"{t['fp32_ffma_bound_ms']:.4f} ms")
        del q, scale, x32, xb
    print(f"int8_matmul: {len(INT8_SHAPES)} shapes agree with the plain version (fp32 x on the "
          f"FFMA kernel; bf16 x on both routes), max abs err FFMA {err['ffma']}, tensor cores "
          f"{err['tc']} (tolerance 1e-5 x max|plain| fp32; 2^-7 |plain| + 1e-5 x max|plain| "
          f"bf16, share of it: FFMA {share['ffma']:.4f}, tensor cores {share['tc']:.4f}); the "
          f"rule's route by shape {rules}")
    tc_ms, ffma_ms = timed["prefill"]["ms"]["tc"], timed["prefill"]["ms"]["ffma"]
    if not tc_ms < ffma_ms:
        raise RuntimeError(f"int8_matmul prefill: the tensor-core kernel ({tc_ms} ms) is not "
                           f"faster than the FFMA kernel ({ffma_ms} ms)")
    ptxas = _build.ptxas_report(QT.TC_SOURCE)
    records = []
    for route, label in (("ffma", "decode"), ("tc", "prefill")):
        t = timed[label]
        rec = {
            "name": "int8_matmul" + ("_tc" if route == "tc" else ""),
            "route": "cuda",
            "source": "cs744_pytorch_distributed_tutorial_tpu_torch/csrc/"
                      + (QT.TC_SOURCE if route == "tc" else QT.SOURCE),
            "replaces": "cs744_pytorch_distributed_tutorial_tpu/ops/quant.py:101",
            "tpu_kernel": "ops/quant.py::_kernel" + (" (tensor-core route: bf16 x)"
                                                    if route == "tc" else
                                                    " (FFMA route: fp32 x, odd K or N)"),
            "launches": None,  # filled in from the generation path's run
            "max_abs_err": err[route],
            "share_of_limit_bf16": share[route],
            "ms": t["ms"][route],
            "device_ms": t["device_ms"][route],
            "plain_ms": t["plain_ms"],
            "bound_ms": t["bound_ms"],
            "bound_by": t["bound_by"],
            "bound_share": t["bound_share"][route],
            "library_ms": t["library_ms"],
            "library": "torch.matmul(x, q.to(x.dtype)) * scale",
            "fp32_ffma_bound_ms": t["fp32_ffma_bound_ms"],
            "shape": t["shape"], "dtype": "bfloat16",
            "rule": rules,
            **{other: {key: (v[route] if isinstance(v, dict) and route in v else v)
                       for key, v in timed[other].items() if key != "ms_runs"}
               for other in INT8_SHAPES if other != label},
        }
        if route == "tc":
            rec["ptxas"] = {f"W={w}": ptxas.get(f"int8_matmul_tc_kernel<{w}>") for w in (1, 2)}
        records.append(rec)
    return records


# ---------------------------------------------------------------- generation
def width_argv(**extra) -> list[str]:
    dims = {**DECODE_WIDTH, **extra}
    return [arg for key, value in dims.items() for arg in (f"--{key.replace('_', '-')}",
                                                          str(value))]


def generation_phase() -> dict:
    """``lm_cli --generate`` at full width: int8 head (the main path), bf16,
    and int8 head with an int8 KV cache. The prompt pass's int8 launch
    takes the tensor cores, the decode steps' the route the rule gives 16
    rows. Returns the int8 launches of the main path by route."""
    from cs744_pytorch_distributed_tutorial_tpu_torch import lm_cli
    from cs744_pytorch_distributed_tutorial_tpu_torch.ops import quant as QT

    base = width_argv() + [
        "--use-rope", "--compute-dtype", "bfloat16", "--steps", "0", "--seq-len",
        str(GEN_PROMPT), "--num-seqs", str(GEN_BATCH), "--generate", str(GEN_NEW),
        "--prompt-len", str(GEN_PROMPT), "--generate-batch", str(GEN_BATCH),
        "--temperature", "0", "--json", "--device", "cuda"]
    d, vocab = DECODE_WIDTH["d_model"], DECODE_WIDTH["vocab_size"]
    decode_route = "tc" if QT.tc_route(torch.bfloat16, GEN_BATCH, d, vocab) else "ffma"
    runs = {}
    for label, flags in (("int8 head", ["--int8-decode", "head"]), ("bf16", []),
                         ("int8 head + int8 KV cache", ["--int8-decode", "head",
                                                        "--int8-kv-cache"])):
        summary, counts = counted(lambda: run_cli(base + flags, main=lm_cli.main))
        g = summary["generation"]
        toks = torch.tensor(g["tokens"])
        vocab = DECODE_WIDTH["vocab_size"]
        if toks.shape != (GEN_BATCH, GEN_NEW) or not bool(((toks >= 0) & (toks < vocab)).all()):
            raise RuntimeError(f"generation {label}: tokens of shape {tuple(toks.shape)} "
                               f"out of range")
        # One launch a model call: the prompt pass (2,048 rows, tensor cores)
        # and 127 decode steps (16 rows, the decode route).
        want_int8 = GEN_NEW if flags else 0
        want_tc = (1 + (GEN_NEW - 1) * (decode_route == "tc")) if flags else 0
        if (counts["int8_matmul"] != want_int8 or counts["int8_matmul_tc"] != want_tc
                or others(counts, "int8_matmul", "int8_matmul_tc")):
            raise RuntimeError(f"generation {label}: launches {counts}, expected "
                               f"{want_int8} int8_matmul ({want_tc} on the tensor cores, decode "
                               f"on {decode_route}) and no other")
        runs[label] = (toks, counts)
        print(f"generation {label}: batch {GEN_BATCH}, prompt {GEN_PROMPT}, {GEN_NEW} new "
              f"tokens: {g['tokens_per_s']:.1f} tokens/s, prefill {g['prefill_ms']:.2f} ms, "
              f"{g['decode_ms_per_step']:.3f} ms a decode step; launches {counts}")
    base_toks = runs["bf16"][0]
    for label in ("int8 head", "int8 head + int8 KV cache"):
        share = float((runs[label][0] == base_toks).float().mean())
        print(f"generation: {label} keeps {100 * share:.2f} % of the bf16 run's greedy tokens")
    counts = runs["int8 head"][1]
    tc = counts["int8_matmul_tc"]
    return {"tc": tc, "ffma": counts["int8_matmul"] - tc}


# ------------------------------------------------------------------- serving
def serve_argv(**geometry) -> list[str]:
    tr = SERVE_TRACE
    return width_argv() + [
        "--use-rope", "--compute-dtype", "bfloat16",
        *[a for k, v in {**SERVE_GEOMETRY, **geometry}.items()
          for a in (f"--{k.replace('_', '-')}", str(v))],
        "--requests", str(tr["num_requests"]), "--rate", str(tr["rate_rps"]),
        "--prompt-len", *map(str, tr["prompt_len"]), "--output-len", *map(str, tr["output_len"]),
        "--seed", str(tr["seed"]), "--device", "cuda"]


def json_lines(text: str) -> list[dict]:
    return [json.loads(line) for line in text.splitlines() if line.startswith("{")]


def serve_summary(text: str) -> dict:
    return next(r for r in json_lines(text) if r.get("kind") == "serve_summary")


def serving_phase() -> int:
    """``serve_cli`` at full width (the main path); returns its paged
    launches."""
    from cs744_pytorch_distributed_tutorial_tpu_torch import serve_cli

    buf = io.StringIO()

    def run():
        with contextlib.redirect_stdout(buf):
            return serve_cli.main(serve_argv())

    t0 = time.perf_counter()
    rc, counts = counted(run)
    wall = time.perf_counter() - t0
    if rc != 0:
        raise RuntimeError(f"serve_cli returned {rc}")
    s = serve_summary(buf.getvalue())
    n = SERVE_TRACE["num_requests"]
    if s["completed"] != n or s["requests"] != n or s["paged_attention_impl"] != "kernel":
        raise RuntimeError(f"serving: {s}")
    want = 2 * DECODE_WIDTH["num_layers"] * s["decode_steps_all"]
    if counts["paged_attention"] != want or others(counts, "paged_attention"):
        raise RuntimeError(f"serving: launches {counts}, expected {want} paged launches (two a "
                           f"call, 12 calls x {s['decode_steps_all']} decode steps) and no other")
    SERVE_RUNS["untraced"] = s
    print(f"serving (kernel, bf16): {n} requests, {s['total_output_tokens']} tokens in "
          f"{s['makespan_s']} s: {s['tokens_per_sec']} tokens/s, TTFT p50 {s['ttft_p50_ms']} ms "
          f"p99 {s['ttft_p99_ms']} ms, ITL p50 {s['itl_p50_ms']} ms p99 {s['itl_p99_ms']} ms, "
          f"{s['decode_ms_per_step']:.3f} ms a decode step (host wall), {s['decode_steps']} "
          f"decode steps ({s['decode_steps_all']} with warm-up), slot occupancy "
          f"{s['slot_occupancy']:.3f}, page high water {s['page_high_water']} of "
          f"{s['pages_allocatable']}, {s['preemptions']} preemptions; {wall:.1f} s wall with "
          f"model build; launches {counts}")
    return counts["paged_attention"]


def serve_tokens(model, impl: str, trace, cfg_kw: dict) -> tuple[list, dict]:
    """Every request of ``trace`` submitted at once and run to the end."""
    from cs744_pytorch_distributed_tutorial_tpu_torch.serve import (
        Request,
        ServeConfig,
        ServingEngine,
    )

    eng = ServingEngine(model, ServeConfig(**cfg_kw, paged_attention_impl=impl), device="cuda")
    reqs = [eng.submit(Request(prompt=p, max_new_tokens=int(n)))
            for p, n in zip(trace.prompts, trace.max_new_tokens)]
    eng.run()
    return [list(r.prompt[r.orig_prompt_len:]) + r.generated for r in reqs], eng.stats()


def decode_model(**kw):
    from cs744_pytorch_distributed_tutorial_tpu_torch.train.lm import LMConfig, LMTrainer

    cfg = LMConfig(**DECODE_WIDTH, use_rope=True, compute_dtype="bfloat16", seq_len=128,
                   device="cuda")
    tr = LMTrainer(cfg)
    if kw.get("quant"):
        params = tr.quantize_for_decode(tr.gather_for_decode(), "head")
        model = tr.quantized_decode_model("head", kv_cache=True, params=params)
    else:
        model = tr.decode_model()
    del tr
    torch.cuda.empty_cache()
    return model


def serving_checks_phase() -> None:
    """Kernel vs gather engines on a trace of ``SERVE_COMPARE_REQUESTS``;
    the pool-pressure run on the serving trace; a profile of 20 decode
    steps."""
    from cs744_pytorch_distributed_tutorial_tpu_torch.ops import quant as QT
    from cs744_pytorch_distributed_tutorial_tpu_torch.serve import (
        ServeConfig,
        ServingEngine,
        make_poisson_workload,
        run_poisson,
    )

    trace = make_poisson_workload(vocab_size=DECODE_WIDTH["vocab_size"],
                                  **{**SERVE_TRACE, "num_requests": PRESSURE_REQUESTS})
    compare = make_poisson_workload(vocab_size=DECODE_WIDTH["vocab_size"],
                                    **{**SERVE_TRACE, "num_requests": SERVE_COMPARE_REQUESTS})
    model = decode_model()
    kernel_out, ks = serve_tokens(model, "kernel", compare, SERVE_GEOMETRY)
    gather_out, gs = serve_tokens(model, "gather", compare, SERVE_GEOMETRY)
    same = sum(a == b for k, g in zip(kernel_out, gather_out) for a, b in zip(k, g))
    total = sum(len(k) for k in kernel_out)
    first = [next((i for i, (a, b) in enumerate(zip(k, g)) if a != b), None)
             for k, g in zip(kernel_out, gather_out)]
    diverged = [i for i in first if i is not None]
    print(f"serving kernel vs gather engine ({SERVE_COMPARE_REQUESTS} requests submitted at "
          f"once): {same} of {total} greedy "
          f"tokens agree ({100 * same / total:.2f} %); {len(diverged)} of {len(first)} requests "
          f"diverge, the first at output index {min(diverged) if diverged else None}; decode "
          f"ms a step (host wall): kernel {ks['decode_ms_per_step']:.3f}, gather "
          f"{gs['decode_ms_per_step']:.3f}")
    decode_profile(model)
    del model
    torch.cuda.empty_cache()

    qmodel = decode_model(quant=True)
    cfg = ServeConfig(**{**SERVE_GEOMETRY, "num_pages": PRESSURE_PAGES})
    eng = ServingEngine(qmodel, cfg, device="cuda")
    s, counts = counted(lambda: run_poisson(eng, trace))
    layers = DECODE_WIDTH["num_layers"]
    n = PRESSURE_REQUESTS
    if s["completed"] != n or s["preemptions"] <= 0:
        raise RuntimeError(f"pool-pressure run: {s}")
    # The int8 head: a prefill's padded prompt (64 rows and up) on the tensor
    # cores, a decode step's 16 rows on the route the rule gives them.
    decode_tc = QT.tc_route(torch.bfloat16, SERVE_GEOMETRY["num_slots"],
                            DECODE_WIDTH["d_model"], DECODE_WIDTH["vocab_size"])
    want = {"paged_attention": 2 * layers * s["decode_steps_all"],  # two launches a call
            "int8_matmul": s["decode_steps_all"] + s["prefills_all"],
            "int8_matmul_tc": s["prefills_all"] + s["decode_steps_all"] * decode_tc}
    if (counts["paged_attention"] != want["paged_attention"]
            or counts["int8_matmul"] != want["int8_matmul"]
            or counts["int8_matmul_tc"] != want["int8_matmul_tc"]
            or counts["paged_attention_int8"] != want["paged_attention"]):
        raise RuntimeError(f"pool-pressure run: launches {counts}, expected {want}")
    print(f"serving pool pressure ({PRESSURE_PAGES - 1} pages, int8 KV pages, int8 head): "
          f"{n} requests completed, {s['preemptions']} preemptions, page high water "
          f"{s['page_high_water']}, {s['tokens_per_sec']} tokens/s, TTFT p99 "
          f"{s['ttft_p99_ms']} ms, ITL p99 {s['itl_p99_ms']} ms, {s['decode_ms_per_step']:.3f} "
          f"ms a decode step; launches {counts} ({s['prefills_all']} prefills, "
          f"{s['decode_steps_all']} decode steps)")
    del qmodel, eng
    torch.cuda.empty_cache()


def decode_profile(model) -> dict:
    """20 decode steps of the kernel engine with all 16 slots active
    (prompts 128, budgets 64: none retires), traced with torch.profiler;
    idle share as in ``profile_phase``."""
    from torch.profiler import ProfilerActivity, profile

    from cs744_pytorch_distributed_tutorial_tpu_torch.serve import (
        Request,
        ServeConfig,
        ServingEngine,
    )

    eng = ServingEngine(model, ServeConfig(**SERVE_GEOMETRY), device="cuda")
    gen = torch.Generator().manual_seed(9)
    for _ in range(SERVE_GEOMETRY["num_slots"]):
        prompt = torch.randint(1, DECODE_WIDTH["vocab_size"], (PROFILE_PROMPT,), generator=gen)
        eng.submit(Request(prompt=prompt.numpy(), max_new_tokens=PROFILE_BUDGET))
    for _ in range(3):  # admission, then warm steps
        eng.step()
    torch.cuda.synchronize()
    steps = 20
    t0 = time.perf_counter()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        for _ in range(steps):
            eng.step()
        torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    out = summarize_profile(prof, steps, "decode profile", {"paged": ("paged_decode",)})
    if not out:
        return {}
    out.update(active_slots=SERVE_GEOMETRY["num_slots"],
               wall_ms_per_step_profiled=wall / steps * 1e3,
               paged_share_of_busy=out["paged_ms_per_step"] / out["device_busy_ms_per_step"])
    print(json.dumps({"decode_profile": out}))
    return out


# ------------------------------------- serving: the tracer, the guard, failure
def traced_serving_phase() -> int:
    """(a) ``bench.py --serve`` with ``--trace-dir`` on the serving
    phase's trace (the traced serving path): spans and request rows audit
    clean, ``obs serve-report --check`` exits 0, the paged launches are
    exactly two a call, 12 calls a decode step of the run, plus the
    profiler's own decode steps; prints the decode and prefill attribution
    and the tracer's cost beside the serving phase's untraced run. Returns
    the run's paged launches."""
    import pathlib
    import shutil
    import tempfile

    from cs744_pytorch_distributed_tutorial_tpu_torch import bench
    from cs744_pytorch_distributed_tutorial_tpu_torch.obs.serve_trace import (
        check_spans,
        load_trace_dir,
        reconcile,
    )

    from cs744_pytorch_distributed_tutorial_tpu_torch.obs.flight import StragglerMonitor
    from cs744_pytorch_distributed_tutorial_tpu_torch.obs.serve_trace import ServeTracer

    # The tracer's own host time (every hook) and the flight recorder's
    # straggler window, each summed over the run.
    hooks = ("on_submit", "on_requeue", "on_admit", "on_decode_step", "on_preempt",
             "on_retire", "on_shed", "sample_ttft", "sample_itl", "flush_window")
    spent = {"tracer": 0.0, "straggler": 0.0}

    def timed(fn, key):
        def call(*args, **kw):
            t = time.perf_counter()
            try:
                return fn(*args, **kw)
            finally:
                spent[key] += time.perf_counter() - t
        return call

    root = pathlib.Path(tempfile.mkdtemp(prefix="serve_trace_"))
    try:
        buf = io.StringIO()

        def run():
            with contextlib.redirect_stdout(buf):
                return bench.main(["--serve", *serve_argv(), "--trace-dir", str(root)])

        t0 = time.perf_counter()
        with patched(ServeTracer, **{h: timed(getattr(ServeTracer, h), "tracer") for h in hooks}), \
                patched(StragglerMonitor, record=timed(StragglerMonitor.record, "straggler")):
            rc, counts = counted(run)
        wall = time.perf_counter() - t0
        records = json_lines(buf.getvalue())
        s = serve_summary(buf.getvalue())
        n = SERVE_TRACE["num_requests"]
        if rc != 0 or s["completed"] != n or s["requests"] != n:
            raise RuntimeError(f"traced serving: rc {rc}, {s}")
        data = load_trace_dir(str(root))
        problems = check_spans(data["spans"]) + reconcile(data["spans"], data["requests"])
        if problems or len(data["requests"]) != n:
            raise RuntimeError(f"traced serving: {len(data['requests'])} request rows, "
                               f"problems {problems[:5]}")
        rep = subprocess.run([sys.executable, "-m",
                              "cs744_pytorch_distributed_tutorial_tpu_torch.obs",
                              "serve-report", str(root), "--check"],
                             capture_output=True, text=True, timeout=300)
        if rep.returncode != 0 or "serve-trace check: OK" not in rep.stdout:
            raise RuntimeError(f"obs serve-report --check: rc {rep.returncode}\n{rep.stdout}\n"
                               f"{rep.stderr}")
        phases = json.loads((root / "serve_phases.json").read_text())
        summ = phases[-1]
        calls = 2 * DECODE_WIDTH["num_layers"]
        run_launches = calls * s["decode_steps_all"]
        profiled = calls * summ["profiled_decode_steps"]
        if counts["paged_attention"] != run_launches + profiled or others(counts,
                                                                        "paged_attention"):
            raise RuntimeError(f"traced serving: launches {counts}, expected {run_launches} "
                               f"paged launches of the run ({s['decode_steps_all']} decode "
                               f"steps) + {profiled} of the profiler "
                               f"({summ['profiled_decode_steps']} steps) and no other")
        windows = [r for r in records if r.get("kind") == "serve_window"]
        base = SERVE_RUNS.get("untraced", {})
        card = card_line()
        print(f"traced serving ({card}): {n} requests, {len(data['spans'])} spans, "
              f"{len(windows)} SLO windows, check_spans and reconcile clean, serve-report "
              f"--check OK; {s['tokens_per_sec']} tokens/s, TTFT p99 {s['ttft_p99_ms']} ms, "
              f"ITL p99 {s['itl_p99_ms']} ms (untraced: {base.get('tokens_per_sec')} "
              f"tokens/s, TTFT p99 {base.get('ttft_p99_ms')} ms, ITL p99 "
              f"{base.get('itl_p99_ms')} ms); launches: {run_launches} paged of the run + "
              f"{profiled} of the profiler; {wall:.1f} s wall; the tracer's hooks "
              f"{spent['tracer'] * 1e3:.2f} ms in all, "
              f"{spent['tracer'] * 1e6 / s['decode_steps']:.1f} us a decode step, the flight "
              f"recorder's straggler window {spent['straggler'] * 1e6 / s['decode_steps']:.1f} "
              f"us a decode step")
        for r in phases[:-1]:
            print(f"serve_phase {r['phase']}: device {r['device_ms']} ms ({r['clock']} clock; "
                  f"wall {r['wall_ms']} ms), {r['flops']:.4g} FLOPs, {r['bytes_accessed']:.4g} "
                  f"bytes, {r['roofline']}" + (f", depth {r['depth']}" if "depth" in r else ""))
        print(f"serve_phase_summary: decode_step_ms {summ['decode_step_ms']}, decode_host_ms "
              f"{summ.get('decode_host_ms')}, decode_host_exposed_ms "
              f"{summ.get('decode_host_exposed_ms')} over {summ['decode_steps_observed']} "
              f"decode steps")
        print(json.dumps({"traced_serving": {
            "card": card, "summary": s, "untraced": base, "serve_phases": phases,
            "windows": len(windows), "spans": len(data["spans"]), "launches": counts,
            "tracer_hooks_s": spent["tracer"], "straggler_s": spent["straggler"],
            "wall_s": wall}}))
        return run_launches
    finally:
        shutil.rmtree(root, ignore_errors=True)


def tracer_cost_pairs_phase(turns: str = "UTTUUTTU") -> dict:
    """The tracer's cost in paired turns, not run by ``main`` (alone:
    ``python -c "import chip_smoke as CS; CS.tracer_cost_pairs_phase()"``,
    ~3.5 min): the serving phase's ``serve_cli`` command untraced (U) and
    with ``--trace-dir`` (T) in ``turns``, one card; prints each run's
    tokens/s, TTFT and ITL p99, host ms a decode step and the traced
    runs' hook time a step, then the medians."""
    import shutil
    import tempfile

    from cs744_pytorch_distributed_tutorial_tpu_torch import serve_cli
    from cs744_pytorch_distributed_tutorial_tpu_torch.obs.serve_trace import ServeTracer

    hooks = ("on_submit", "on_requeue", "on_admit", "on_decode_step", "on_preempt",
             "on_retire", "on_shed", "sample_ttft", "sample_itl", "flush_window")
    card = card_line()
    rows: dict = {"U": [], "T": []}
    for turn in turns:
        spent = [0.0]

        def timed(fn):
            def call(*args, **kw):
                t = time.perf_counter()
                try:
                    return fn(*args, **kw)
                finally:
                    spent[0] += time.perf_counter() - t
            return call

        root = tempfile.mkdtemp(prefix="serve_pair_")
        buf = io.StringIO()
        try:
            with patched(ServeTracer, **{h: timed(getattr(ServeTracer, h)) for h in hooks}), \
                    contextlib.redirect_stdout(buf):
                rc = serve_cli.main(serve_argv() + (["--trace-dir", root] if turn == "T" else []))
        finally:
            shutil.rmtree(root, ignore_errors=True)
        s = serve_summary(buf.getvalue())
        if rc != 0 or s["completed"] != SERVE_TRACE["num_requests"]:
            raise RuntimeError(f"tracer pairs: turn {turn}: rc {rc}, {s}")
        row = {k: s[k] for k in ("tokens_per_sec", "ttft_p99_ms", "itl_p99_ms",
                                 "decode_ms_per_step", "decode_steps")}
        row["hooks_us_a_step"] = spent[0] * 1e6 / s["decode_steps"]
        rows[turn].append(row)
        print(f"tracer pairs {turn} ({card}): {json.dumps(row)}", flush=True)
    medians = {key: {turn: statistics.median(r[key] for r in rows[turn]) for turn in rows}
               for key in ("tokens_per_sec", "ttft_p99_ms", "itl_p99_ms", "decode_ms_per_step",
                           "hooks_us_a_step")}
    print(f"tracer pairs ({card}), medians untraced U vs traced T: {json.dumps(medians)}")
    print(json.dumps({"tracer_pairs": {"card": card, "rows": rows, "medians": medians}}))
    return medians


def overload_phase() -> None:
    """(b) ``serve_cli`` at 3x the trace's rate with deadlines, a bounded
    queue and degrade: every request ends in exactly one terminal status
    (``run_poisson`` raises otherwise; the counts must add up), the pool
    holds its invariants and no page at the end, two paged launches a
    call."""
    from cs744_pytorch_distributed_tutorial_tpu_torch import serve as S
    from cs744_pytorch_distributed_tutorial_tpu_torch import serve_cli

    engines, real = [], S.run_poisson

    def spy(engine, workload, **kw):
        engines.append(engine)
        return real(engine, workload, **kw)

    buf = io.StringIO()

    def run():
        with contextlib.redirect_stdout(buf):
            return serve_cli.main([*serve_argv(), "--rate", str(OVERLOAD_RPS), *OVERLOAD_FLAGS])

    with patched(S, run_poisson=spy):
        rc, counts = counted(run)
    records = json_lines(buf.getvalue())
    s = serve_summary(buf.getvalue())
    n = SERVE_TRACE["num_requests"]
    statuses = {k: s[k] for k in ("completed", "rejected", "timed_out", "recovered")}
    (eng,) = engines
    if (rc != 0 or s["requests"] != n or sum(statuses.values()) != n
            or not eng.pool.check_invariants() or eng.pool.allocated_pages != 0):
        raise RuntimeError(f"overload: rc {rc}, statuses {statuses}, {s}")
    want = 2 * DECODE_WIDTH["num_layers"] * s["decode_steps_all"]
    if counts["paged_attention"] != want or others(counts, "paged_attention"):
        raise RuntimeError(f"overload: launches {counts}, expected {want} paged launches")
    sheds = [r for r in records if r.get("kind") == "serve_shed"]
    trims = [r for r in sheds if r["reason"] == "degrade_trim"]
    expired = [r for r in records if r.get("event") == "timed_out"]
    print(f"overload ({card_line()}): {n} requests at {OVERLOAD_RPS} rps with "
          f"{' '.join(OVERLOAD_FLAGS)}: statuses {statuses}, {len(trims)} degrade trims "
          f"({sum(r['tokens_shed'] for r in trims)} tokens shed), "
          f"{len(sheds) - len(trims)} rejections, {len(expired)} deadline expiries; "
          f"{s['tokens_per_sec']} tokens/s, TTFT p99 {s['ttft_p99_ms']} ms, ITL p99 "
          f"{s['itl_p99_ms']} ms; pool invariants hold, 0 pages live; launches {counts}")
    print(json.dumps({"overload": {"summary": s, "trims": len(trims),
                                   "tokens_shed": sum(r["tokens_shed"] for r in trims),
                                   "expired": len(expired), "launches": counts}}))


def chaos_serve_run(qmodel, extra: list[str], requests: int = CHAOS_REQUESTS) -> dict:
    """``serve_cli`` on the pool-pressure geometry (int8 KV pages and the
    int8 head of ``qmodel``, handed in for ``build_model``) with ``extra``
    flags: its summary, records, launches, the streams by submission order,
    and the recovery timeline (fault injections, engine rebuilds and the
    replayed requests' first new tokens, on the engines' clock)."""
    from cs744_pytorch_distributed_tutorial_tpu_torch import serve as S
    from cs744_pytorch_distributed_tutorial_tpu_torch import serve_cli
    from cs744_pytorch_distributed_tutorial_tpu_torch.ops import quant as QT
    from cs744_pytorch_distributed_tutorial_tpu_torch.utils import chaos as CH

    engines, faults, rebuilds = [], [], []
    real_poisson, real_recovery = S.run_poisson, S.run_serve_with_recovery
    real_inject = CH.ChaosMonkey._inject

    def poisson(engine, workload, **kw):
        engines.append(engine)
        return real_poisson(engine, workload, **kw)

    def recovery(make_engine, workload, **kw):
        def make():
            t0 = time.monotonic()
            engines.append(make_engine())
            rebuilds.append((t0, time.monotonic()))
            return engines[-1]
        return real_recovery(make, workload, **kw)

    def inject(self, idx, kind):
        faults.append((time.monotonic(), idx, kind))
        real_inject(self, idx, kind)

    argv = [*serve_argv(num_pages=PRESSURE_PAGES), "--requests", str(requests),
            "--quant-kv", *extra]

    class Schedule(CH.FaultSchedule):  # a slow_step stalls SLOW_STALL_S
        def __init__(self, faults):
            super().__init__({idx: {"kind": kind, "stall_s": SLOW_STALL_S}
                              if kind == "slow_step" else kind for idx, kind in faults.items()})

    buf = io.StringIO()
    step_s: list[float] = []  # every engine step's host wall time, watched or not
    real_step = S.ServingEngine.step

    def timed_step(self):
        t0 = time.perf_counter()
        try:
            return real_step(self)
        finally:
            step_s.append(time.perf_counter() - t0)

    def run():
        with contextlib.redirect_stdout(buf):
            return serve_cli.main(argv)

    with patched(serve_cli, build_model=lambda args: qmodel), \
            patched(S, run_poisson=poisson, run_serve_with_recovery=recovery), \
            patched(CH.ChaosMonkey, _inject=inject), patched(CH, FaultSchedule=Schedule), \
            patched(S.ServingEngine, step=timed_step):
        t0 = time.perf_counter()
        rc, counts = counted(run)
        wall = time.perf_counter() - t0
    records = json_lines(buf.getvalue())
    s = serve_summary(buf.getvalue())
    done = sorted((r for e in engines for r in e._completed), key=lambda r: r.req_id)
    streams = [[int(t) for t in list(r.prompt[r.orig_prompt_len:]) + r.generated] for r in done]
    # A resumed request's first token after each resume boundary, on the
    # engines' clock: the replayed requests' way back.
    resumed = sorted(r.token_times[b] for r in done for b in r.resume_boundaries
                     if b < len(r.token_times))
    recoveries = []
    for j, ((t_fault, idx, kind), (b0, b1)) in enumerate(zip(faults, rebuilds[1:])):
        end = faults[j + 1][0] if j + 1 < len(faults) else float("inf")
        back = [t for t in resumed if b1 < t < end]
        recoveries.append({"fault": kind, "decode_step": idx,
                           "to_rebuild_ms": (b0 - t_fault) * 1e3,
                           "rebuild_ms": (b1 - b0) * 1e3,
                           "first_replayed_token_ms": (back[0] - t_fault) * 1e3 if back else None,
                           "last_replayed_token_ms": (back[-1] - t_fault) * 1e3 if back else None,
                           "replayed_requests": len(back)})
    if rc != 0 or s["requests"] != requests or len(streams) != requests:
        raise RuntimeError(f"serving under failure {extra}: rc {rc}, {s}")
    if s["completed"] + s["recovered"] != requests:
        raise RuntimeError(f"serving under failure {extra}: statuses {s}")
    layers = DECODE_WIDTH["num_layers"]
    decode_tc = QT.tc_route(torch.bfloat16, SERVE_GEOMETRY["num_slots"],
                            DECODE_WIDTH["d_model"], DECODE_WIDTH["vocab_size"])
    want = {"paged_attention": 2 * layers * s["decode_steps_all"],
            "paged_attention_int8": 2 * layers * s["decode_steps_all"],
            "int8_matmul": s["decode_steps_all"] + s["prefills_all"],
            "int8_matmul_tc": s["prefills_all"] + s["decode_steps_all"] * decode_tc}
    got = {k: counts[k] for k in want}
    if got != want or others(counts, "paged_attention", "paged_attention_int8", "int8_matmul",
                             "int8_matmul_tc"):
        raise RuntimeError(f"serving under failure {extra}: launches {counts}, expected {want}")
    return {"summary": s, "records": records, "launches": counts, "streams": streams,
            "recoveries": recoveries, "faults": faults, "wall_s": wall, "step_s": step_s}


def serving_failure_phase() -> dict:
    """(c) The pool-pressure geometry, CHAOS_REQUESTS requests, greedy,
    through ``serve_cli``: a fault-free run, then ``--chaos 40:decode_nan,
    90:engine_crash`` and, on the first HUNG_REQUESTS requests beside their
    own fault-free run, a ``slow_step`` (a ``SLOW_STALL_S`` stall) under
    ``--step-timeout-s`` (the
    watchdog's abort; every step's host time printed), both with
    ``--recompute decode``: restarts equal
    the faults that fired and every stream is the fault-free run's token
    for token (no fed-back token mismatched). Then the chaos run with the
    JAX engine's one-pass re-prefill (``--recompute prefill``), whose
    rebuilt rows differ from the decode steps' in the last bits: its
    agreement with the fault-free run is printed, not held. Prints each
    recovery's wall time."""
    qmodel = decode_model(quant=True)
    card = card_line()
    decode = ["--recompute", "decode"]
    base = chaos_serve_run(qmodel, decode)
    if base["summary"]["preemptions"] <= 0:
        raise RuntimeError(f"pool-pressure run without preemptions: {base['summary']}")
    out = {"card": card, "fault_free": {k: base[k] for k in ("summary", "launches", "wall_s")}}
    bases = {CHAOS_REQUESTS: base, HUNG_REQUESTS: chaos_serve_run(qmodel, decode, HUNG_REQUESTS)}
    runs = (("chaos", decode + ["--chaos", SERVE_CHAOS], 2, "DecodeNanError", CHAOS_REQUESTS),
            ("hung step", decode + ["--chaos", SLOW_CHAOS, "--step-timeout-s",
                                    str(SLOW_STEP_TIMEOUT_S)], 1, "HungStepError", HUNG_REQUESTS),
            ("chaos, recompute prefill", ["--recompute", "prefill", "--chaos", SERVE_CHAOS], 2,
             "DecodeNanError", CHAOS_REQUESTS))
    for label, flags, faults, failure, requests in runs:
        base = bases[requests]
        r = chaos_serve_run(qmodel, flags, requests)
        s = r["summary"]
        events = [e for e in r["records"] if e.get("kind") == "event"]
        names = [e["event"] for e in events]
        restart = [e for e in events if e["event"] == "recovery_restart"]
        if (s["restarts"] != faults or names.count("chaos_inject") != faults
                or len(restart) != faults or failure not in restart[0]["failure"]
                or "recovery_complete" not in names or "recovery_giveup" in names):
            raise RuntimeError(f"serving under failure ({label}): restarts {s['restarts']}, "
                               f"events {names}")
        same = sum(a == b for x, y in zip(r["streams"], base["streams"]) for a, b in zip(x, y))
        total = sum(len(x) for x in base["streams"])
        identical = r["streams"] == base["streams"]
        exact = "prefill" not in label
        if exact and (not identical or s["replay_mismatches"] != 0):
            raise RuntimeError(f"serving under failure ({label}): {same} of {total} tokens "
                               f"agree with the fault-free run, {s['replay_mismatches']} "
                               f"fed-back tokens mismatched")
        print(f"serving under failure, {label} ({card}): {requests} requests, "
              f"{s['restarts']} restarts for {faults} faults, statuses completed "
              f"{s['completed']} recovered {s['recovered']}; {same} of {total} greedy tokens "
              f"agree with the fault-free run" + (" (identical)" if identical else "")
              + f"; {s['replay_mismatches']} fed-back mismatches, {s['preemptions']} "
              f"preemptions, {s['tokens_per_sec']} tokens/s (fault-free "
              f"{base['summary']['tokens_per_sec']}); recoveries " + json.dumps(r["recoveries"])
              + f"; launches {r['launches']}")
        if label == "hung step":
            # The stalled step is the slowest; the others are fault-free:
            # a false abort needs one past 3 x the timeout, or three past it
            # on one engine.
            steps = sorted(r["step_s"], reverse=True)
            stall, rest = steps[0], steps[1:]
            over = sum(t > SLOW_STEP_TIMEOUT_S for t in rest)
            print(f"serving under failure, hung step: the stalled step took {stall * 1e3:.1f} "
                  f"ms; the slowest of the other {len(rest)} steps "
                  f"{(rest[0] if rest else 0.0) * 1e3:.1f} ms, {over} past the "
                  f"{SLOW_STEP_TIMEOUT_S * 1e3:.0f} ms timeout (abort at "
                  f"{3 * SLOW_STEP_TIMEOUT_S * 1e3:.0f} ms, the stall {SLOW_STALL_S * 1e3:.0f} "
                  f"ms); the fault-free base run's slowest step "
                  f"{max(base['step_s']) * 1e3:.1f} ms")
        out[label] = {"summary": s, "recoveries": r["recoveries"], "agree": same,
                      "total": total, "identical": identical, "launches": r["launches"],
                      "wall_s": r["wall_s"], "slowest_step_s": max(r["step_s"])}
    print(json.dumps({"serving_under_failure": out}))
    del qmodel
    torch.cuda.empty_cache()
    return out


# ----------------------------------------------------------- grouped matmul
def moe_layer(dev: torch.device):
    """One MoE layer of the MoE LM's width, flax's init from seed 7, biases
    drawn non-zero (so the epilogue's bias shows), on the card."""
    from cs744_pytorch_distributed_tutorial_tpu_torch.models.moe import MoEFFN

    layer = MoEFFN(MOE_WIDTH["d_model"], MOE_EXPERTS, MOE_WIDTH["d_ff"], top_k=MOE_TOP_K,
                   dispatch_impl="dropless")
    gen = torch.Generator().manual_seed(7)
    layer.reset_parameters(gen)
    with torch.no_grad():
        layer.b_in.copy_(0.1 * torch.randn(layer.b_in.shape, generator=gen))
        layer.b_out.copy_(0.1 * torch.randn(layer.b_out.shape, generator=gen))
    return layer.requires_grad_(False).to(dev)


def gmm_library(lhs, rhs, bias, group_sizes, act: str):
    """``torch._grouped_mm`` plus the per-row bias and gelu, or None with
    the reason when the op does not run on this card's PyTorch. Row offsets
    and row groups are made beforehand (routing information)."""
    import torch.nn.functional as F

    grouped_mm = getattr(torch, "_grouped_mm", None)
    if grouped_mm is None or lhs.dtype != torch.bfloat16:
        return None, "torch._grouped_mm takes bf16 only" if grouped_mm else "no torch._grouped_mm"
    offs = torch.cumsum(group_sizes, 0, dtype=torch.int32)
    rows = torch.repeat_interleave(torch.arange(len(group_sizes), device=lhs.device),
                                   group_sizes.long(), output_size=lhs.shape[0])
    row_bias = bias[rows]
    for b in (rhs, rhs.transpose(1, 2).contiguous().transpose(1, 2)):  # row-, column-major

        def call(b=b):
            y = grouped_mm(lhs, b, offs=offs).float() + row_bias
            return (F.gelu(y, approximate="tanh") if act == "gelu" else y).to(lhs.dtype)

        try:
            call()
            torch.cuda.synchronize()
            return call, None
        except (RuntimeError, NotImplementedError, TypeError, ValueError) as exc:
            reason = f"{type(exc).__name__}: {str(exc).splitlines()[0]}"
    return None, reason


def gmm_fused_route(route: str):
    """The grouped matmul's forward on one route (``tc`` or ``ffma``)
    whatever the call (``fused_tc_route``, patched for the block)."""
    from cs744_pytorch_distributed_tutorial_tpu_torch.ops import gmm as G

    return patched(G, fused_tc_route=lambda *args, **kw: route == "tc")


def gmm_phase(dev: torch.device) -> list[dict]:
    """The forward's kernels against their plain version at the MoE path's
    shapes (group sizes from the router's top-2 on random tokens) and
    ragged ones, both activations, bf16 and fp32: each call on the route
    ``fused_tc_route`` gives it (fp32 and widths off 16-byte rows take
    FFMA), and every bf16 call the tensor cores can take on both routes,
    each call's route shown by its launches; fp32 within 1e-5 x max|plain|
    (the sums in another order), bf16 within one ulp of each plain value
    plus 1e-5 x max|plain|; two tensor-core runs bitwise equal. Then the
    times of both routes in turn (tensor cores, FFMA, FFMA, tensor cores:
    the mean of the two medians) at prefill, decode and the ragged shape;
    the tensor cores must be the faster at prefill. Then one MoE layer's
    forward with host synchronisation made an error. Returns the FFMA and
    tensor-core records."""
    from cs744_pytorch_distributed_tutorial_tpu_torch.models.moe import MoEFFN
    from cs744_pytorch_distributed_tutorial_tpu_torch.ops import _build
    from cs744_pytorch_distributed_tutorial_tpu_torch.ops import gmm as G

    gen = torch.Generator(device=dev).manual_seed(8)
    layer = moe_layer(dev)
    d, e = MOE_WIDTH["d_model"], MOE_EXPERTS
    cases = {}
    with torch.no_grad():
        for label, rows in (("prefill", GEN_BATCH * GEN_PROMPT), ("decode", GEN_BATCH)):
            tokens = randn(gen, rows, d, dtype=torch.bfloat16)
            _, _, idx = layer.route(tokens)
            _, sizes, tok_ids = MoEFFN.group_by_expert(idx, e)
            xs = tokens[tok_ids]
            w_in, w_out = layer.w_in.bfloat16(), layer.w_out.bfloat16()
            h = G.grouped_matmul_fused_plain(xs, w_in, layer.b_in, sizes, activation="gelu")
            cases[f"{label} w_in gelu"] = (xs, w_in, layer.b_in, sizes, "gelu")
            cases[f"{label} w_out"] = (h, w_out, layer.b_out, sizes, "none")
            print(f"gmm {label}: {rows} tokens, top-2 group sizes {sizes.tolist()}")
        for name, (m, k, n, ragged) in (("ragged", GMM_RAGGED), ("ragged_tc", GMM_RAGGED_TC)):
            args = (randn(gen, m, k), randn(gen, len(ragged), k, n) / k**0.5,
                    randn(gen, len(ragged), n), torch.tensor(ragged, device=dev))
            cases[f"{name} gelu"] = (*args, "gelu")
            cases[name] = (*args, "none")

    err = {"ffma": 0.0, "tc": 0.0}
    worst = {"ffma": 0.0, "tc": 0.0}
    rules = {}
    for label, (lhs, rhs, bias, sizes, act) in cases.items():
        for dtype in (torch.bfloat16, torch.float32):
            a, b = lhs.to(dtype), rhs.to(dtype)
            shape = (a.shape[0], a.shape[1], b.shape[2])
            rule = "tc" if G.fused_tc_route(dtype, shape) else "ffma"
            rules[f"{label} {str(dtype)[6:]}"] = rule
            eligible = G.fused_tc_route(dtype, (max(shape[0], G.FUSED_TC_MIN_ROWS), *shape[1:]))
            want = G.grouped_matmul_fused_plain(a, b, bias, sizes, activation=act)
            top = float(want.float().abs().max())
            for route in ("tc", "ffma") if eligible else ("ffma",):
                with gmm_fused_route(route) if route != rule else contextlib.nullcontext():
                    G.reset_launch_count()
                    got = G.grouped_matmul_fused(a, b, bias, sizes, activation=act)
                    torch.cuda.synchronize()
                    name = "fused_tc" if route == "tc" else "fused"
                    if G.launch_count() != 1 or G.launch_count(name) != 1:
                        raise RuntimeError(f"gmm_fused {label} {dtype}: launches "
                                           f"{ {k: G.launch_count(k) for k in G.KERNELS} }, "
                                           f"expected one {name}")
                    if route == "tc" and not torch.equal(
                            got, G.grouped_matmul_fused(a, b, bias, sizes, activation=act)):
                        raise RuntimeError(f"gmm_fused_tc {label} is not bitwise repeatable")
                diff = (got.float() - want.float()).abs()
                if dtype == torch.float32:
                    share = float(diff.max()) / (1e-5 * top)
                else:
                    share = float((diff / (2**-7 * want.float().abs() + 1e-5 * top)).max())
                if got.dtype != dtype or not (math.isfinite(share) and share <= 1.0):
                    raise RuntimeError(f"gmm_fused {route} kernel disagrees with its plain version "
                                       f"at {label} {dtype} {list(a.shape)}x{list(b.shape)}: max "
                                       f"abs err {float(diff.max())}, {share} of the limit")
                err[route] = max(err[route], float(diff.max()))
                worst[route] = max(worst[route], share)
                print(f"gmm_fused {route} {label} {dtype} [{a.shape[0]}, {a.shape[1]}] x "
                      f"{list(b.shape)}: max abs err {float(diff.max())} ({share:.3f} of the "
                      f"limit)")
    print(f"gmm_fused: {len(cases)} cases x (bf16, fp32) agree with the plain version on the "
          f"rule's route and bf16 on both, max abs err FFMA {err['ffma']}, tensor cores "
          f"{err['tc']}, largest share of the limit FFMA {worst['ffma']:.3f}, tensor cores "
          f"{worst['tc']:.3f} (limit: 1e-5 x max|plain| fp32; one bf16 ulp + 1e-5 x max|plain| "
          f"bf16); the rule's routes {rules}")

    bw, fp32_flops = card_rates(torch.cuda.get_device_name(0))
    timed = {}
    for label in ("prefill w_in gelu", "prefill w_out", "decode w_in gelu", "decode w_out",
                  "ragged_tc gelu"):
        lhs, rhs, bias, sizes, act = cases[label]
        lhs, rhs = lhs.bfloat16(), rhs.bfloat16()
        (mm, kk), nn_ = lhs.shape, rhs.shape[2]
        hit = int((sizes > 0).sum())  # experts with rows: their weights are read
        nbytes = (2.0 * mm * kk + 2.0 * hit * kk * nn_ + 4.0 * hit * nn_ + 4.0 * len(sizes)
                  + 2.0 * mm * nn_)
        flop = 2.0 * mm * kk * nn_
        bytes_ms, ops_ms = nbytes / bw * 1e3, flop / BF16_FLOPS * 1e3
        library, reason = gmm_library(lhs, rhs, bias, sizes, act)
        kernel = lambda: G.grouped_matmul_fused(lhs, rhs, bias, sizes, activation=act)  # noqa: E731
        runs, device = {}, {}
        for turn in ("tc", "ffma", "ffma", "tc"):
            with gmm_fused_route(turn):
                runs.setdefault(turn, []).append(median_ms(kernel))
                if turn not in device:
                    device[turn] = device_busy_ms(
                        kernel, match="gmm_fused_tc_kernel" if turn == "tc" else "gmm_fused_kernel")
        t = {
            "shape": [mm, kk, nn_], "groups_hit": hit, "activation": act, "dtype": "bfloat16",
            "rule": "tc" if G.fused_tc_route(torch.bfloat16, (mm, kk, nn_)) else "ffma",
            "ms": {r: statistics.mean(v) for r, v in runs.items()}, "ms_runs": runs,
            "device_ms": device,
            "fp32_ms": median_ms(lambda: G.grouped_matmul_fused(
                lhs.float(), rhs.float(), bias, sizes, activation=act)),
            "plain_ms": median_ms(lambda: G.grouped_matmul_fused_plain(
                lhs, rhs, bias, sizes, activation=act), reps=10),
            "library_ms": median_ms(library) if library else None,
            "library_device_ms": device_busy_ms(library) if library else None,
            "library": ("torch._grouped_mm + row bias + gelu" if library
                        else f"not run: {reason}"),
            "bound_ms": max(bytes_ms, ops_ms),
            "bound_by": "bytes" if bytes_ms >= ops_ms else "operations",
            "fp32_ffma_bound_ms": flop / fp32_flops * 1e3,
            "gflop": flop / 1e9, "mbytes": nbytes / 1e6,
        }
        t["bound_share"] = {r: t["bound_ms"] / v for r, v in t["ms"].items()}
        timed[label] = t
        print(f"gmm_fused {label} [{mm}, {kk}] x [{len(sizes)}, {kk}, {nn_}] bf16 ({hit} experts "
              f"hit; the rule takes {t['rule']}): {flop / 1e9:.3f} GFLOP, {nbytes / 1e6:.2f} MB; "
              f"tensor cores {t['ms']['tc']:.4f} ms (runs {runs['tc']}, device {device['tc']} "
              f"ms), FFMA {t['ms']['ffma']:.4f} ms (runs {runs['ffma']}, device "
              f"{device['ffma']} ms; fp32 {t['fp32_ms']:.4f} ms), plain {t['plain_ms']:.4f} ms, "
              f"{t['library']} {t['library_ms']} ms (device {t['library_device_ms']} ms), bound "
              f"{t['bound_ms']:.5f} ms ({t['bound_by']}; tensor cores "
              f"{100 * t['bound_share']['tc']:.2f} %, FFMA {100 * t['bound_share']['ffma']:.2f} "
              f"% of it), FP32 FFMA floor {t['fp32_ffma_bound_ms']:.4f} ms")
    for phase in ("prefill", "decode"):
        tc_ms, ffma_ms = (sum(timed[f"{phase} {c}"]["ms"][r] for c in ("w_in gelu", "w_out"))
                          for r in ("tc", "ffma"))
        print(f"gmm_fused {phase} layer: tensor cores {tc_ms:.4f} ms, FFMA {ffma_ms:.4f} ms "
              f"({ffma_ms / tc_ms:.2f}x); the rule takes "
              f"{timed[f'{phase} w_in gelu']['rule']} at {timed[f'{phase} w_in gelu']['shape'][0]} "
              f"rows (FUSED_TC_MIN_ROWS {G.FUSED_TC_MIN_ROWS})")
        if phase == "prefill" and not tc_ms < ffma_ms:
            raise RuntimeError(f"gmm_fused prefill: the tensor-core kernel ({tc_ms} ms) is not "
                               f"faster than the FFMA kernel ({ffma_ms} ms)")

    # One MoE layer's forward with every host synchronisation an error.
    for label, t in (("prefill", GEN_PROMPT), ("decode", 1)):
        x = randn(gen, GEN_BATCH, t, d, dtype=torch.bfloat16)
        torch.cuda.synchronize()
        with torch.no_grad():
            torch.cuda.set_sync_debug_mode("error")
            try:
                y = layer(x, torch.bfloat16)
            finally:
                torch.cuda.set_sync_debug_mode("default")
        torch.cuda.synchronize()
        if y.shape != x.shape or not bool(torch.isfinite(y).all()):
            raise RuntimeError(f"MoE layer {label}: output {tuple(y.shape)} not finite")
        print(f"MoE layer forward at {label} ([{GEN_BATCH}, {t}, {d}] bf16) ran under "
              f"torch.cuda.set_sync_debug_mode('error'): no host synchronisation")

    def layer_total(key, phase, route):
        vals = [timed[f"{phase} {c}"][key] for c in ("w_in gelu", "w_out")]
        vals = [v[route] if isinstance(v, dict) else v for v in vals]
        return None if None in vals else sum(vals)

    keys = ("ms", "device_ms", "plain_ms", "bound_ms", "library_ms", "fp32_ffma_bound_ms")
    ptxas = _build.ptxas_report(G.TC_SOURCE)
    records = []
    for route in ("ffma", "tc"):
        rec = {
            "name": "gmm_fused" + ("_tc" if route == "tc" else ""),
            "route": "cuda",
            "source": "cs744_pytorch_distributed_tutorial_tpu_torch/csrc/"
                      + (G.TC_SOURCE if route == "tc" else G.SOURCE),
            "replaces": "cs744_pytorch_distributed_tutorial_tpu/ops/gmm.py:278",
            "tpu_kernel": "ops/gmm.py::_gmm_fused_kernel (the undifferentiated forward, without "
                          "with_z; with it: the gmm_fused_with_z records), "
                          + ("tensor-core route" if route == "tc" else "FFMA route"),
            "launches": None,  # filled in from the MoE generation path's run
            "max_abs_err": err[route],
            "share_of_limit": worst[route],
            **{key: layer_total(key, "prefill", route) for key in keys},
            "bound_by": "bytes" if all(timed[f"prefill {c}"]["bound_by"] == "bytes"
                                       for c in ("w_in gelu", "w_out")) else "operations",
            "library": timed["prefill w_in gelu"]["library"],
            "work": "one MoE layer's two calls at a prefill (16 x 128 tokens, top-2: 4,096 rows)",
            "decode_layer": {key: layer_total(key, "decode", route) for key in keys},
            "ragged_tc_gelu": {key: (v[route] if isinstance(v, dict) and route in v else v)
                               for key, v in timed["ragged_tc gelu"].items() if key != "ms_runs"},
            "rule": rules,
            "calls": timed,
        }
        rec["bound_share"] = rec["bound_ms"] / rec["ms"]
        if route == "tc":
            rec["ptxas"] = {name: usage for name, usage in ptxas.items()
                            if name.startswith("gmm_fused_tc_kernel")}
        records.append(rec)
    return records


# ------------------------------------------------------------ MoE generation
def moe_generation_phase() -> dict:
    """``lm_cli --generate 128`` on the MoE LM (the main path); returns its
    grouped-matmul launches by kernel: the prompt pass (4,096 routed rows)
    on the tensor cores, each decode step (32 rows) on the route
    ``fused_tc_route`` gives it. Then prefill + MOE_DECODE_STEPS decode
    steps against the full forward, and a profile of 5 decode steps."""
    from cs744_pytorch_distributed_tutorial_tpu_torch import lm_cli
    from cs744_pytorch_distributed_tutorial_tpu_torch.ops import gmm as G

    moe_flags = ["--moe-experts", str(MOE_EXPERTS), "--moe-top-k", str(MOE_TOP_K),
                 "--moe-dispatch", "dropless"]
    argv = [a for key, value in MOE_WIDTH.items() for a in (f"--{key.replace('_', '-')}",
                                                            str(value))]
    argv += moe_flags + [
        "--use-rope", "--compute-dtype", "bfloat16", "--steps", "0", "--seq-len",
        str(GEN_PROMPT), "--num-seqs", str(GEN_BATCH), "--generate", str(GEN_NEW),
        "--prompt-len", str(GEN_PROMPT), "--generate-batch", str(GEN_BATCH),
        "--temperature", "0", "--json", "--device", "cuda"]
    t0 = time.perf_counter()
    summary, counts = counted(lambda: run_cli(argv, main=lm_cli.main))
    wall = time.perf_counter() - t0
    g = summary["generation"]
    toks = torch.tensor(g["tokens"])
    vocab = MOE_WIDTH["vocab_size"]
    if toks.shape != (GEN_BATCH, GEN_NEW) or not bool(((toks >= 0) & (toks < vocab)).all()):
        raise RuntimeError(f"MoE generation: tokens of shape {tuple(toks.shape)} out of range")
    calls = 2 * MOE_WIDTH["num_layers"]  # w_in and w_out a layer, a model call
    decode_tc = G.fused_tc_route(torch.bfloat16, (MOE_TOP_K * GEN_BATCH, MOE_WIDTH["d_model"],
                                                  MOE_WIDTH["d_ff"]))
    decode = calls * (GEN_NEW - 1)
    want = {"fused_tc": calls + (decode if decode_tc else 0), "fused": 0 if decode_tc else decode}
    per_kernel = {k: G.launch_count(k) for k in G.KERNELS}
    if (counts["gmm_fused"] != calls * GEN_NEW
            or per_kernel != {**dict.fromkeys(G.KERNELS, 0), **want}
            or others(counts, "gmm_fused")):
        raise RuntimeError(f"MoE generation: launches {counts}, grouped-matmul kernels "
                           f"{per_kernel}; expected {want} (no z) and no other")
    print(f"MoE generation: batch {GEN_BATCH}, prompt {GEN_PROMPT}, {GEN_NEW} new tokens: "
          f"{g['tokens_per_s']:.1f} tokens/s, prefill {g['prefill_ms']:.2f} ms, "
          f"{g['decode_ms_per_step']:.3f} ms a decode step; {wall:.1f} s wall with model build; "
          f"launches {counts}, by kernel {want}")
    moe_decode_checks()
    return per_kernel


def moe_decode_checks() -> None:
    """Prefill 128 tokens + MOE_DECODE_STEPS decode steps against the full
    forward over the same 136 tokens: the bf16 logits' relative RMS error
    within MOE_LOGIT_RTOL (a router near-tie that flips one token's experts
    between the two passes moves that token's logits by far more than bf16
    rounding, so the limit is on the RMS, and the largest error and the
    share of positions with the same argmax are printed beside it); then
    a profile of 5 decode steps."""
    from torch.profiler import ProfilerActivity, profile

    from cs744_pytorch_distributed_tutorial_tpu_torch.train.lm import LMConfig, LMTrainer

    cfg = LMConfig(**MOE_WIDTH, use_rope=True, compute_dtype="bfloat16", seq_len=GEN_PROMPT,
                   moe_experts=MOE_EXPERTS, moe_top_k=MOE_TOP_K, moe_dispatch="dropless",
                   device="cuda")
    model = LMTrainer(cfg).decode_model()
    dev = next(model.parameters()).device
    gen = torch.Generator(device=dev).manual_seed(10)
    t_all = GEN_PROMPT + MOE_DECODE_STEPS
    tokens = torch.randint(0, MOE_WIDTH["vocab_size"], (GEN_BATCH, t_all), generator=gen,
                           device=dev)
    with torch.no_grad():
        full = model(tokens)
        cache = model.init_cache(GEN_BATCH)
        steps = [model(tokens[:, :GEN_PROMPT], "prefill", cache=cache)]
        for pos in range(GEN_PROMPT, t_all):
            steps.append(model(tokens[:, pos : pos + 1], "decode", decode_pos=pos, cache=cache))
        got = torch.cat(steps, dim=1)
        diff = got - full
        rel = float(diff.square().mean().sqrt() / full.square().mean().sqrt())
        same = float((got.argmax(-1) == full.argmax(-1)).float().mean())
        worst = float(diff.abs().max())
    if not (math.isfinite(rel) and rel <= MOE_LOGIT_RTOL):
        raise RuntimeError(f"MoE prefill + decode logits differ from the full forward: relative "
                           f"RMS {rel} (limit {MOE_LOGIT_RTOL}), max abs {worst}")
    print(f"MoE prefill {GEN_PROMPT} + {MOE_DECODE_STEPS} decode steps vs the full forward "
          f"(bf16): relative RMS error {rel:.3e} ({rel / MOE_LOGIT_RTOL:.3f} of the limit "
          f"{MOE_LOGIT_RTOL}), max abs error {worst}, same argmax at {100 * same:.2f} % of "
          f"positions")
    del full, got, diff, steps

    steps = 5
    pos = t_all
    last = tokens[:, -1:]
    with torch.no_grad():
        model(last, "decode", decode_pos=pos, cache=cache)  # warm
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            for i in range(steps):
                model(last, "decode", decode_pos=pos + 1 + i, cache=cache)
            torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    out = summarize_profile(prof, steps, "MoE decode profile",
                            {"gmm": ("gmm_fused_kernel", "gmm_fused_tc_kernel")})
    if out:
        out.update(wall_ms_per_step_profiled=wall / steps * 1e3,
                   gmm_share_of_busy=out["gmm_ms_per_step"] / out["device_busy_ms_per_step"])
        print(json.dumps({"moe_decode_profile": out}))
    del model, cache
    torch.cuda.empty_cache()


# ------------------------------------------------------ grouped-matmul backward
def quiet(fn):
    """``fn()`` with every host synchronisation an error."""
    torch.cuda.set_sync_debug_mode("error")
    try:
        return fn()
    finally:
        torch.cuda.set_sync_debug_mode("default")


def gmm_bwd_library(name: str, lhs, rhs, dout, group_sizes):
    """One PyTorch call computing the same function as a backward kernel,
    or None with the reason: ``torch._grouped_mm`` on bf16 copies of the
    fp32 operands for ``gmm`` (dout @ rhs^T) and ``tgmm`` (lhs^T @ dout by
    row groups), ``torch.segment_reduce`` for ``colsum``. Operands are
    made beforehand."""
    offs = torch.cumsum(group_sizes, 0, dtype=torch.int32)
    if name == "colsum":
        lengths = group_sizes.long()
        calls = [lambda: torch.segment_reduce(dout, "sum", lengths=lengths, axis=0, unsafe=True)]
        label = "torch.segment_reduce(dout, 'sum', lengths) (fp32)"
    else:
        grouped_mm = getattr(torch, "_grouped_mm", None)
        if grouped_mm is None:
            return None, "no torch._grouped_mm", None
        d16 = dout.bfloat16()
        if name == "gmm":
            w = rhs.bfloat16()
            calls = [lambda b=b: grouped_mm(d16, b, offs=offs)
                     for b in (w.transpose(1, 2), w.transpose(1, 2).contiguous())]
            label = "torch._grouped_mm(dout bf16, rhs^T bf16, offs)"
        else:
            a = lhs.bfloat16()
            calls = [lambda a_t=a_t: grouped_mm(a_t, d16, offs=offs)
                     for a_t in (a.t(), a.t().contiguous())]
            label = "torch._grouped_mm(lhs^T bf16, dout bf16, offs) -> [E, K, N]"
    reason = None
    for call in calls:
        try:
            call()
            torch.cuda.synchronize()
            return call, None, label
        except (RuntimeError, NotImplementedError, TypeError, ValueError) as exc:
            reason = f"{type(exc).__name__}: {str(exc).splitlines()[0]}"
    return None, reason, label


def gmm_backward_phase(dev: torch.device) -> list[dict]:
    """The backward's kernels and the forward's ``z`` against their plain
    versions at the MoE training path's shapes, fp32 and bf16 operands,
    with the ragged and the router's group sizes, each kernel call under
    ``set_sync_debug_mode("error")`` and each call's launches exact (the
    route rule's choice): fp32 operands take the FFMA ``gmm``/``tgmm``;
    bf16 ones take ``gmm_tc``/``tgmm_tc`` with an fp32 dout in three pieces
    (``split``) and a bf16 dout in one, and the FFMA kernels on the same
    operands through the module's private launchers. fp32 outputs (gmm,
    tgmm, gmm_tc, tgmm_tc, colsum, and z in fp32) within 1e-5 x max|plain|
    (sums in another order; every product is exact: widened bf16, or a
    bf16 piece times a bf16 value), bf16 z within one ulp of each plain
    value plus 1e-5 x max|plain|, split bitwise equal to its plain version.
    Two runs of tgmm and of tgmm_tc are bitwise equal. Then the times of
    the path's four calls (gmm and tgmm for w_in and w_out) on both routes
    in turn, split and colsum: returns one record each for gmm, tgmm (the
    FFMA route), gmm_tc, tgmm_tc, split, colsum and the forward with
    ``z``."""
    from cs744_pytorch_distributed_tutorial_tpu_torch.models.moe import MoEFFN
    from cs744_pytorch_distributed_tutorial_tpu_torch.ops import gmm as G

    gen = torch.Generator(device=dev).manual_seed(11)
    d, f, e = MOE_WIDTH["d_model"], MOE_WIDTH["d_ff"], MOE_EXPERTS
    m = MOE_TRAIN_BATCH * MOE_WIDTH["max_seq_len"] * MOE_TOP_K  # routed rows a layer
    layer = moe_layer(dev)
    with torch.no_grad():
        tokens = randn(gen, m // MOE_TOP_K, d, dtype=torch.bfloat16)
        _, _, idx = layer.route(tokens)
        _, routed, _ = MoEFFN.group_by_expert(idx, e)
    del layer, tokens, idx
    print(f"gmm backward: {m} routed rows, ragged group sizes {GMM_TRAIN_RAGGED}, router's "
          f"{routed.tolist()}")
    sizes = {"ragged": torch.tensor(GMM_TRAIN_RAGGED, device=dev), "router": routed}
    shapes = {"w_in": (d, f), "w_out": (f, d)}  # the forward product's (K, N)
    names = ("gmm", "tgmm", "gmm_tc", "tgmm_tc", "split", "colsum", "fused_z", "fused_z_tc")
    err, worst = dict.fromkeys(names, 0.0), dict.fromkeys(names, 0.0)

    def check(name, got, want, dtype, label):
        diff = (got.float() - want.float()).abs()
        top = float(want.float().abs().max())
        if dtype == torch.float32:
            share = float(diff.max()) / (1e-5 * top)
        else:
            share = float((diff / (2**-7 * want.float().abs() + 1e-5 * top)).max())
        if got.dtype != want.dtype or got.shape != want.shape or not (
                math.isfinite(share) and share <= 1.0):
            raise RuntimeError(f"{name} kernel disagrees with its plain version at {label}: "
                               f"max abs err {float(diff.max())}, {share} of the limit")
        err[name], worst[name] = max(err[name], float(diff.max())), max(worst[name], share)
        print(f"{name} {label}: max abs err {float(diff.max())} ({share:.3f} of the limit)")

    def via(launches: dict, fn):
        """``fn()`` with host synchronisation an error; its grouped-matmul
        launches must be exactly ``launches``."""
        G.reset_launch_count()
        out = quiet(fn)
        got = {k: G.launch_count(k) for k in G.KERNELS if G.launch_count(k)}
        if got != launches:
            raise RuntimeError(f"grouped-matmul route: launches {got}, expected {launches}")
        return out

    def ffma_gmm(dout, w, gs):  # the FFMA route through the module's private launcher
        out = torch.empty((dout.shape[0], w.shape[1]), device=dev)
        G._gmm_ffma(dout, w, G._sizes(gs), out, True)
        return out

    def ffma_tgmm(a, dout, gs):
        out = torch.empty((gs.shape[0], a.shape[1], dout.shape[1]), device=dev)
        G._tgmm_ffma(a, dout, G._sizes(gs), out)
        return out

    def repeats(label, dw, fn):
        if not torch.equal(dw, fn()):
            raise RuntimeError(f"{label} is not bitwise repeatable")

    operands = {}
    for wname, (k, n) in shapes.items():
        lhs = randn(gen, m, k)
        rhs = randn(gen, e, k, n) / k**0.5
        bias = randn(gen, e, n)
        dout = randn(gen, m, n)
        d16 = dout.bfloat16()
        operands[wname] = (lhs, rhs, bias, dout)
        split = via({"split": 1}, lambda: G.split_bf16(dout))
        if not torch.equal(split.view(torch.int16), G.split_bf16_plain(dout).view(torch.int16)):
            raise RuntimeError(f"split differs from its plain version at {wname} [{m}, {n}]")
        print(f"split {wname} [{m}, {n}]: bitwise equal to its plain version")
        for s_label, gs in sizes.items():
            for dtype in (torch.float32, torch.bfloat16):
                a, w = lhs.to(dtype), rhs.to(dtype)
                label = f"{wname} {s_label} {str(dtype)[6:]} [{m}, {k}] x [{e}, {k}, {n}]"
                want_g = G.grouped_matmul_plain(dout, w, gs, trans_rhs=True)
                want_t = G.tgmm_plain(a, dout, gs)
                if dtype == torch.float32:
                    check("gmm", via({"gmm": 1}, lambda: G.gmm(dout, w, gs, trans_rhs=True)),
                          want_g, dtype, label)
                    dw = via({"tgmm": 1}, lambda: G.tgmm(a, dout, gs))
                    check("tgmm", dw, want_t, dtype, label)
                    repeats(f"tgmm at {label}", dw, lambda: G.tgmm(a, dout, gs))
                else:
                    check("gmm_tc", via({"gmm_tc": 1, "split": 1},
                                        lambda: G.gmm(dout, w, gs, trans_rhs=True)),
                          want_g, torch.float32, label + " dout fp32 (3 pieces)")
                    dw = via({"tgmm_tc": 1}, lambda: G.tgmm(a, dout, gs, split=split))
                    check("tgmm_tc", dw, want_t, torch.float32, label + " dout fp32 (3 pieces)")
                    repeats(f"tgmm_tc at {label}", dw, lambda: G.tgmm(a, dout, gs, split=split))
                    check("gmm", via({"gmm": 1}, lambda: ffma_gmm(dout, w, gs)), want_g,
                          torch.float32, label + " (FFMA route)")
                    dw = via({"tgmm": 1}, lambda: ffma_tgmm(a, dout, gs))
                    check("tgmm", dw, want_t, torch.float32, label + " (FFMA route)")
                    repeats(f"tgmm at {label}", dw, lambda: ffma_tgmm(a, dout, gs))
                    check("gmm_tc", via({"gmm_tc": 1}, lambda: G.gmm(d16, w, gs, trans_rhs=True)),
                          G.grouped_matmul_plain(d16, w, gs, trans_rhs=True), torch.float32,
                          label + " dout bf16 (1 piece)")
                    dw = via({"tgmm_tc": 1}, lambda: G.tgmm(a, d16, gs))
                    check("tgmm_tc", dw, G.tgmm_plain(a, d16, gs), torch.float32,
                          label + " dout bf16 (1 piece)")
                    repeats(f"tgmm_tc at {label} (1 piece)", dw, lambda: G.tgmm(a, d16, gs))
                check("colsum", via({"colsum": 1}, lambda: G.segment_sum_rows(dout, gs)),
                      G.segment_sum_rows_plain(dout, gs), torch.float32, label)
                h_plain, z_plain = G.grouped_matmul_fused_plain(a, w, bias, gs, activation="gelu",
                                                                with_z=True)
                # The forward with z: bf16 on both routes (the rule takes the
                # tensor cores), fp32 on FFMA.
                for fz in ("fused_z_tc", "fused_z") if dtype == torch.bfloat16 else ("fused_z",):
                    forced = fz == "fused_z" and dtype == torch.bfloat16
                    with gmm_fused_route("ffma") if forced else contextlib.nullcontext():
                        h, z = via({fz: 1}, lambda: G._fused(a, w, bias, gs, "gelu", None, True))
                    route = " (FFMA route)" if forced else ""
                    check(fz, z, z_plain, dtype, label + " z" + route)
                    check(fz, h, h_plain, dtype, label + " out" + route)
                del dw, h, z, h_plain, z_plain, want_g, want_t
        del split, d16
        torch.cuda.empty_cache()
    print("gmm backward kernels agree with their plain versions on both routes, no host "
          "synchronisation; " + ", ".join(f"{k} max abs err {err[k]} ({worst[k]:.3f} of the "
                                          f"limit)" for k in names))

    # Times of the path's bf16 calls, router group sizes: per layer, gmm,
    # tgmm and colsum once for w_in and once for w_out, split once (w_in's
    # fp32 dz, whose pieces both of w_in's calls read; w_out's gradient
    # arrives in bf16, one piece), the forward with z once (w_in). gmm and
    # tgmm on both routes, in turn: tensor cores, FFMA, FFMA, tensor cores.
    bw, fp32_flops = card_rates(torch.cuda.get_device_name(0))
    gs = routed
    gs32 = G._sizes(gs)
    timed: dict[str, dict] = {name: {} for name in names}
    for wname, (k, n) in shapes.items():
        lhs, rhs, bias, dout = operands[wname]
        a, w = lhs.bfloat16(), rhs.bfloat16()
        pieces = 3 if wname == "w_in" else 1
        dp = dout if pieces == 3 else dout.bfloat16()  # dout as the path hands it over
        dw32 = dp.float()  # the FFMA route widens it
        sp = G.split_bf16(dp) if pieces == 3 else None
        out_g = torch.empty((m, k), device=dev)
        out_t = torch.empty((e, k, n), device=dev)
        dbytes = dp.element_size() * m * n
        flop = 2.0 * m * k * n
        g_bytes = dbytes + 2.0 * e * k * n + 4.0 * e + 4.0 * m * k
        t_bytes = 2.0 * m * k + dbytes + 4.0 * e + 4.0 * e * k * n
        plain_g = median_ms(lambda: G.grouped_matmul_plain(dp, w, gs, trans_rhs=True), reps=3,
                            warmup=1)
        plain_t = median_ms(lambda: G.tgmm_plain(a, dp, gs), reps=3, warmup=1)
        calls = {
            # name: (kernel, plain ms, bytes, flop, peak, library function, pieces)
            "gmm_tc": (lambda: G.gmm(dp, w, gs, trans_rhs=True, split=sp), plain_g, g_bytes, flop,
                       BF16_FLOPS, "gmm", pieces),
            "gmm": (lambda: G._gmm_ffma(dw32, w, gs32, out_g, True), plain_g, g_bytes, flop,
                    fp32_flops, "gmm", None),
            "tgmm_tc": (lambda: G.tgmm(a, dp, gs, split=sp), plain_t, t_bytes, flop, BF16_FLOPS,
                        "tgmm", pieces),
            "tgmm": (lambda: G._tgmm_ffma(a, dw32, gs32, out_t), plain_t, t_bytes, flop,
                     fp32_flops, "tgmm", None),
            "colsum": (lambda: G.segment_sum_rows(dw32, gs),
                       median_ms(lambda: G.segment_sum_rows_plain(dw32, gs), reps=3, warmup=1),
                       4.0 * m * n + 4.0 * e + 4.0 * e * n, 1.0 * m * n, fp32_flops, "colsum",
                       None),
        }
        if wname == "w_in":
            calls["split"] = (lambda: G.split_bf16(dout),
                              median_ms(lambda: G.split_bf16_plain(dout), reps=3, warmup=1),
                              10.0 * m * n, 2.0 * m * n, fp32_flops, None, None)
            def ffma_fused_z():
                with gmm_fused_route("ffma"):
                    return G._fused(a, w, bias, gs, "gelu", None, True)

            fz_plain = median_ms(lambda: G.grouped_matmul_fused_plain(
                a, w, bias, gs, activation="gelu", with_z=True), reps=3, warmup=1)
            fz_bytes = 2.0 * m * k + 2.0 * e * k * n + 4.0 * e * n + 4.0 * e + 2 * 2.0 * m * n
            calls["fused_z_tc"] = (lambda: G._fused(a, w, bias, gs, "gelu", None, True), fz_plain,
                                   fz_bytes, flop, BF16_FLOPS, "fused_z", None)
            calls["fused_z"] = (ffma_fused_z, fz_plain, fz_bytes, flop, BF16_FLOPS, "fused_z",
                                None)
        libs = {}
        for lib_name in ("gmm", "tgmm", "colsum"):
            libs[lib_name] = gmm_bwd_library(lib_name, a, w, dp, gs)
        fz_lib, fz_reason = gmm_library(a, w, bias, gs, "gelu")
        libs["fused_z"] = (fz_lib, fz_reason, "torch._grouped_mm + row bias + gelu (bf16, no z)")
        libs[None] = (None, "no single PyTorch call makes the pieces", None)
        route_ms = {}
        turns = [name for name in ("gmm_tc", "gmm", "tgmm_tc", "tgmm", "fused_z_tc", "fused_z")
                 if name in calls]
        for name in turns + turns[::-1]:  # in turn, then again reversed
            route_ms.setdefault(name, []).append(median_ms(calls[name][0]))
        for name, (kernel, plain_ms, nbytes, flop_, peak, lib_name, npieces) in calls.items():
            library, reason, lib_label = libs[lib_name]
            bytes_ms, ops_ms = nbytes / bw * 1e3, flop_ / peak * 1e3
            kname = {"gmm": "gmm_fused_kernel", "fused_z": "gmm_fused_kernel",
                     "fused_z_tc": "gmm_fused_tc_kernel", "gmm_tc": "::gmm_tc_kernel",
                     "tgmm_tc": "::tgmm_tc_kernel"}.get(name, f"{name}_kernel")
            t = {
                "ms": (statistics.mean(route_ms[name]) if name in route_ms
                       else median_ms(kernel)),
                "device_ms": device_busy_ms(kernel, match=kname),
                "plain_ms": plain_ms,
                "library_ms": median_ms(library) if library else None,
                "library_device_ms": device_busy_ms(library) if library else None,
                "library": lib_label if library else f"not run: {reason}",
                "bound_ms": max(bytes_ms, ops_ms),
                "bound_by": "bytes" if bytes_ms >= ops_ms else "operations",
                "gflop": flop_ / 1e9, "mbytes": nbytes / 1e6,
            }
            if name in route_ms:
                t["ms_runs"] = route_ms[name]
            if npieces:
                t["pieces"] = npieces
                t["pass_floor_ms"] = npieces * flop_ / BF16_FLOPS * 1e3
            t["bound_share"] = t["bound_ms"] / t["ms"]
            timed[name][wname] = t
            floor = (f", {npieces}-pass floor {t['pass_floor_ms']:.5f} ms" if npieces else "")
            shape = f"[{m}, {n}]" if name == "split" else f"[{m}, {k}] x [{e}, {k}, {n}]"
            print(f"{name} {wname} {shape} path call: {flop_ / 1e9:.3f} "
                  f"GFLOP, {nbytes / 1e6:.2f} MB; kernel {t['ms']:.4f} ms (device "
                  f"{t['device_ms']} ms), plain {t['plain_ms']:.4f} ms, {t['library']} "
                  f"{t['library_ms']} ms (device {t['library_device_ms']} ms), bound "
                  f"{t['bound_ms']:.5f} ms ({t['bound_by']}; {100 * t['bound_share']:.2f} % of "
                  f"it){floor}")
        for fn_name in ("gmm", "tgmm", "fused_z"):
            if wname not in timed[fn_name]:
                continue
            tc, ffma = timed[f"{fn_name}_tc"][wname]["ms"], timed[fn_name][wname]["ms"]
            print(f"{fn_name} {wname} path call: tensor cores {tc:.4f} ms, FFMA {ffma:.4f} ms "
                  f"({ffma / tc:.2f}x; {'faster' if tc < ffma else 'NOT faster'} on tensor cores)")
        del sp, out_g, out_t, dw32, dp
    del operands
    torch.cuda.empty_cache()

    src = "cs744_pytorch_distributed_tutorial_tpu_torch/csrc/"
    replaces = {"gmm": ("105", "gmm.cu", "_gmm_kernel (dlhs = gmm(dout, rhs^T)), FFMA route"),
                "tgmm": ("124", "gmm.cu", "_tgmm_kernel (drhs), FFMA route"),
                "gmm_tc": ("105", "gmm_tc.cu", "_gmm_kernel (dlhs), tensor-core route"),
                "tgmm_tc": ("124", "gmm_tc.cu", "_tgmm_kernel (drhs), tensor-core route"),
                "split": ("105", "gmm_tc.cu", "part of the _gmm_kernel/_tgmm_kernel port: the "
                                              "fp32 dout as three bf16 pieces"),
                "colsum": ("124", "gmm.cu", "_tgmm_kernel on an all-ones lhs (_segment_sum_rows: "
                                            "dbias)"),
                "fused_z": ("278", "gmm.cu", "_gmm_fused_kernel with with_z (the differentiated "
                                             "gelu forward), FFMA route"),
                "fused_z_tc": ("278", "gmm_tc.cu", "_gmm_fused_kernel with with_z, tensor-core "
                                                   "route")}
    records = []
    for name in names:
        calls = timed[name]

        def total(key, calls=calls):
            vals = [c.get(key) for c in calls.values()]
            return None if None in vals else sum(vals)

        line, source, what = replaces[name]
        records.append({
            "name": name.replace("fused_z", "gmm_fused_with_z"),
            "kernel": name,
            "route": "cuda",
            "source": src + source,
            "replaces": f"cs744_pytorch_distributed_tutorial_tpu/ops/gmm.py:{line}",
            "tpu_kernel": f"ops/gmm.py::{what}",
            "launches": None,  # filled in from the MoE training path's run
            "max_abs_err": err[name],
            "share_of_limit": worst[name],
            **{key: total(key) for key in ("ms", "device_ms", "plain_ms", "bound_ms",
                                           "library_ms", "library_device_ms", "pass_floor_ms")},
            "bound_by": "bytes" if all(c["bound_by"] == "bytes" for c in calls.values())
            else "operations",
            "library": next(iter(calls.values()))["library"],
            "work": ("one MoE layer's calls of a training step (32 x 512 tokens, top-2, bf16 "
                     "compute): " + " and ".join(calls)),
            "calls": calls,
        })
    return records


# ------------------------------------------------------------- MoE training
def moe_train_argv(dispatch: str, steps: int) -> list[str]:
    """``lm_cli`` flags of the MoE training path: ``steps`` steps over
    distinct batches of 32 and one held-out eval batch."""
    argv = [a for key, value in MOE_WIDTH.items() for a in (f"--{key.replace('_', '-')}",
                                                            str(value))]
    return argv + [
        "--seq-len", str(MOE_WIDTH["max_seq_len"]), "--use-rope", "--attention-impl", "flash",
        "--compute-dtype", "bfloat16", "--optimizer", "adamw", "--moe-experts",
        str(MOE_EXPERTS), "--moe-top-k", str(MOE_TOP_K), "--moe-dispatch", dispatch,
        "--global-batch-size", str(MOE_TRAIN_BATCH), "--steps", str(steps), "--num-seqs",
        str(MOE_TRAIN_BATCH * (steps + 1)), "--eval-frac", str(1 / (steps + 2)), "--json",
        "--device", "cuda"]


def moe_train_path_phase() -> dict:
    """``lm_cli`` trains the MoE LM (the main path); returns the launches
    of each grouped-matmul kernel. A step's forward makes 12 gmm_fused
    launches, all on the tensor cores (6 w_in with z, 6 w_out without),
    its backward 12 gmm_tc and
    12 tgmm_tc (w_in's fp32 dz in three pieces, split once a layer: 6
    split; w_out's bf16 gradient in one), no FFMA gmm or tgmm, and 12
    colsum (the bias gradient has a launch of its own); flash 6 forward, 6
    dq and 6 dk/dv, all on the tensor cores; the eval batch 12 gmm_fused
    without z (tensor cores) and 6 flash forwards (tensor cores)."""
    from cs744_pytorch_distributed_tutorial_tpu_torch import lm_cli
    from cs744_pytorch_distributed_tutorial_tpu_torch.ops import flash_attention as A
    from cs744_pytorch_distributed_tutorial_tpu_torch.ops import gmm as G

    steps, layers = MOE_TRAIN_STEPS, MOE_WIDTH["num_layers"]
    t0 = time.perf_counter()
    summary, all_counts = counted(lambda: run_cli(moe_train_argv("dropless", steps),
                                                  main=lm_cli.main))
    wall = time.perf_counter() - t0
    gmm = {k: G.launch_count(k) for k in G.KERNELS}
    flash = flash_counts()
    want_gmm = {"fused": 0, "fused_z": 0, "fused_tc": layers * (steps + 2),
                "fused_z_tc": layers * steps, "gmm": 0, "tgmm": 0,
                "colsum": 2 * layers * steps, "gmm_tc": 2 * layers * steps,
                "tgmm_tc": 2 * layers * steps, "split": layers * steps}
    # gmm_tc counts under its dout's dtype: fp32 (w_in, 3 pieces), bf16 (w_out, 1 piece).
    pieces = {str(dt)[6:]: G.launch_count("gmm_tc", dt) for dt in (torch.float32, torch.bfloat16)}
    if gmm != want_gmm or pieces != {"float32": layers * steps, "bfloat16": layers * steps} or (
            G.launch_count("tgmm_tc", torch.bfloat16) != 2 * layers * steps) or others(
            all_counts, "gmm_fused", "flash"):
        raise RuntimeError(f"MoE training path: grouped-matmul launches {gmm} (gmm_tc by dout "
                           f"dtype {pieces}), all {all_counts}; expected {want_gmm} and no "
                           f"kernel but gmm and flash")
    want_flash = {"fwd": 0, "dq": 0, "dkv": 0, "fwd_tc": layers * (steps + 1),
                  "dq_tc": layers * steps, "dkv_tc": layers * steps}
    if flash != want_flash:
        raise RuntimeError(f"MoE training path: flash launches {flash}, expected {want_flash}")
    moe = summary.get("moe") or {}
    if summary["steps_run"] != steps or not summary["finite"] or not math.isfinite(
            summary["eval"]["loss"]):
        raise RuntimeError(f"MoE training path: {summary}")
    if not (all(math.isfinite(x) for x in moe.get("moe_aux", [math.nan]))
            and moe.get("moe_drop") == [0.0] * steps):
        raise RuntimeError(f"MoE training path: moe metrics {moe}")
    print(f"MoE training path: {steps} steps + eval in {wall:.1f} s wall (model build and "
          f"first-step set-up included), loss {summary['first_loss']} -> "
          f"{summary['final_loss']}, eval {summary['eval']}, moe_aux {moe['moe_aux']}, moe_drop "
          f"{moe['moe_drop']}, moe_load_entropy {moe['moe_load_entropy']}; gmm launches "
          f"{gmm} (gmm_tc by dout dtype {pieces}), flash launches {flash}")
    return gmm


def moe_config(**kw):
    from cs744_pytorch_distributed_tutorial_tpu_torch.train.lm import LMConfig

    base = dict(MOE_WIDTH, seq_len=MOE_WIDTH["max_seq_len"], use_rope=True,
                attention_impl="flash", compute_dtype="bfloat16", optimizer="adamw",
                global_batch_size=MOE_TRAIN_BATCH, moe_experts=MOE_EXPERTS, moe_top_k=MOE_TOP_K,
                moe_dispatch="dropless", device="cuda")
    return LMConfig(**{**base, **kw})


def moe_train_throughput_phase() -> dict:
    """``LMTrainer.train_step`` on the MoE training path's config: 2
    warm-up steps, MOE_TIMED_STEPS timed with CUDA events; one step with
    host synchronisation an error; a profile of 2 steps (the grouped
    matmuls' share of the device time)."""
    from torch.profiler import ProfilerActivity, profile

    from cs744_pytorch_distributed_tutorial_tpu_torch.data import synthetic_tokens
    from cs744_pytorch_distributed_tutorial_tpu_torch.train.lm import LMTrainer

    b, t = MOE_TRAIN_BATCH, MOE_WIDTH["max_seq_len"]
    d, f, layers, vocab = (MOE_WIDTH[k] for k in ("d_model", "d_ff", "num_layers",
                                                   "vocab_size"))
    tr = LMTrainer(moe_config())
    tr.init()
    toks = synthetic_tokens(2 * b, t, vocab, seed=2)
    batches = [tr.split_batch(toks[i * b : (i + 1) * b]) for i in range(2)]
    torch.cuda.reset_peak_memory_stats()
    _timed_steps(tr, batches, 2)
    ms = _timed_steps(tr, batches, MOE_TIMED_STEPS)
    tok_s = b * t / (ms / 1e3)
    # Active parameters a token: attention, top-2 of the experts, the router.
    moe_flops = 3.0 * layers * 2.0 * MOE_TOP_K * 2.0 * d * f
    flops = (lm_flops_per_token(layers, d, MOE_TOP_K * f, t, vocab)
             + 3.0 * layers * 2.0 * d * MOE_EXPERTS)
    out = {"ms_per_step": ms, "tokens_per_s": tok_s, "flops_per_token": flops,
           "moe_flops_per_token": moe_flops, "mfu": tok_s * flops / BF16_FLOPS,
           "peak_memory_gb": torch.cuda.max_memory_allocated() / 1e9}
    print(f"MoE training throughput: {ms:.3f} ms/step, {tok_s:.1f} tokens/s, "
          f"{flops / 1e9:.4f} GFLOP a token of which the experts {moe_flops / 1e9:.4f} (active "
          f"parameters), MFU {100 * out['mfu']:.2f} % of {BF16_FLOPS / 1e12:.0f} TFLOP/s bf16, "
          f"peak memory {out['peak_memory_gb']:.2f} GB")
    torch.cuda.synchronize()
    m = quiet(lambda: tr.train_step(*batches[0]))
    torch.cuda.synchronize()
    print(f"MoE training step under set_sync_debug_mode('error'): no host synchronisation "
          f"(loss {float(m['loss'])})")

    steps = 2
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        for i in range(steps):
            tr.train_step(*batches[i % 2])
        torch.cuda.synchronize()
    groups = {"gmm": ("gmm_fused_kernel", "gmm_fused_tc_kernel", "tgmm_kernel", "colsum_kernel",
                      "gmm_tc_kernel", "split_kernel"),
              "gmm_forward": ("gmm_fused_kernel<__nv_bfloat16", "gmm_fused_tc_kernel"),
              "gmm_forward_tc": ("gmm_fused_tc_kernel",),
              "gmm_tc": ("::gmm_tc_kernel",), "tgmm_tc": ("::tgmm_tc_kernel",),
              "split": ("split_kernel",), "gmm_ffma": ("gmm_fused_kernel<float",),
              "tgmm": ("tgmm_kernel",), "colsum": ("colsum_kernel",),
              "flash": ("flash_fwd_kernel", "flash_dq_kernel", "flash_dkv_kernel",
                        "flash_fwd_tc_kernel", "flash_dq_tc_kernel", "flash_dkv_tc_kernel"),
              "flash_forward_tc": ("flash_fwd_tc_kernel",),
              "flash_backward_tc": ("flash_dq_tc_kernel", "flash_dkv_tc_kernel")}
    prof_out = summarize_profile(prof, steps, "MoE training profile", groups)
    if prof_out:
        prof_out["gmm_share_of_busy"] = (prof_out["gmm_ms_per_step"]
                                         / prof_out["device_busy_ms_per_step"])
        print(json.dumps({"moe_train_profile": prof_out}))
    out["profile"] = prof_out
    del tr, batches
    torch.cuda.empty_cache()
    return out


def plain_grouped_matmuls():
    """The grouped-matmul autograd Functions through the plain versions on
    CUDA tensors (the module functions they call, patched for the block),
    for a kernel-vs-plain trajectory."""
    from cs744_pytorch_distributed_tutorial_tpu_torch.ops import gmm as G

    def fused(lhs, rhs, bias, group_sizes, activation, out_dtype, with_z):
        res = G.grouped_matmul_fused_plain(lhs, rhs, bias, group_sizes, activation=activation,
                                           out_dtype=out_dtype, with_z=with_z)
        return res if with_z else (res, None)

    return patched(
        G, _fused=fused, segment_sum_rows=G.segment_sum_rows_plain,
        split_bf16=G.split_bf16_plain,
        gmm=lambda lhs, rhs, gs, *, trans_rhs=False, split=None: G.grouped_matmul_plain(
            lhs, rhs, gs, trans_rhs=trans_rhs),
        tgmm=lambda lhs, dout, gs, *, split=None: G.tgmm_plain(lhs, dout, gs))


def moe_train_trajectory_phase() -> None:
    """The grouped-matmul kernels against their plain versions over
    MOE_TRAJ_STEPS AdamW steps (lr 1e-3) of the MoE LM at full width and 2
    layers, batch 8 x T 512, fp32 (TF32 off), from one init on the same
    batches: losses and moe_aux within rtol 1e-4, the first step's
    gradient norm (same weights) within rtol 1e-5, and the parameters
    within 2 x lr (an element whose gradient sits at fp32 rounding level
    may take an Adam step of the other sign), 1e-7 on average."""
    from cs744_pytorch_distributed_tutorial_tpu_torch.data import synthetic_tokens
    from cs744_pytorch_distributed_tutorial_tpu_torch.ops import gmm as G
    from cs744_pytorch_distributed_tutorial_tpu_torch.train.lm import LMTrainer

    b, t = 8, MOE_WIDTH["max_seq_len"]
    toks = synthetic_tokens(b * MOE_TRAJ_STEPS, t, MOE_WIDTH["vocab_size"], seed=4)
    runs = {}
    for name in ("kernel", "plain"):
        tr = LMTrainer(moe_config(num_layers=2, global_batch_size=b, compute_dtype="float32",
                                  learning_rate=MOE_TRAJ_LR))
        model, _ = tr.init()
        G.reset_launch_count()
        ctx = plain_grouped_matmuls() if name == "plain" else contextlib.nullcontext()
        with ctx:
            steps = [tr.train_step(*tr.split_batch(toks[b * s : b * (s + 1)]))
                     for s in range(MOE_TRAJ_STEPS)]
        torch.cuda.synchronize()
        launches = G.launch_count()
        if (launches == 0) != (name == "plain") or G.launch_count(dtype=torch.bfloat16):
            raise RuntimeError(f"MoE trajectory {name}: {launches} grouped-matmul launches")
        runs[name] = ({k: [float(m[k]) for m in steps] for k in steps[0]},
                      [p.detach() for p in model.parameters()])
        del tr, model
    (hk, pk), (hp, pp) = runs["kernel"], runs["plain"]
    for key in ("loss", "moe_aux"):
        for a, c in zip(hk[key], hp[key]):
            if not (math.isfinite(a) and abs(a - c) <= 1e-4 * abs(c)):
                raise RuntimeError(f"MoE trajectory {key} differ: kernel {hk[key]} plain "
                                   f"{hp[key]}")
    g_k, g_p = hk["grad_norm"][0], hp["grad_norm"][0]
    if not abs(g_k - g_p) <= 1e-5 * abs(g_p):
        raise RuntimeError(f"MoE trajectory first-step gradient norms differ: {g_k} vs {g_p}")
    gaps = torch.cat([(a - c).abs().flatten() for a, c in zip(pk, pp)])
    gap, mean_gap = float(gaps.max()), float(gaps.mean())
    del runs, pk, pp, gaps
    torch.cuda.empty_cache()
    if not (gap <= 2 * MOE_TRAJ_LR and mean_gap <= 1e-7):
        raise RuntimeError(f"MoE trajectory parameters differ by {gap} (mean {mean_gap}) "
                           f"after {MOE_TRAJ_STEPS} steps")
    print(f"trajectory MoE grouped-matmul kernels vs plain (2 layers, full width, batch {b}, "
          f"fp32): losses kernel {hk['loss']} plain {hp['loss']}; moe_aux kernel "
          f"{hk['moe_aux']} plain {hp['moe_aux']}; grad norms kernel {hk['grad_norm']} plain "
          f"{hp['grad_norm']}; parameter gap after {MOE_TRAJ_STEPS} steps max {gap} mean "
          f"{mean_gap}")


def ffma_route():
    """The grouped matmuls, forward and backward, on the FFMA kernels
    whatever the operands (the route rules, patched for the block to take
    no tensor-core call), for a route-vs-route trajectory."""
    from cs744_pytorch_distributed_tutorial_tpu_torch.ops import gmm as G

    return patched(G, tc_pieces=lambda *args, **kw: 0, fused_tc_route=lambda *args, **kw: False)


def moe_route_trajectory_phase() -> None:
    """The tensor-core routes (forward and backward) against the FFMA
    routes over MOE_TRAJ_STEPS
    AdamW steps (lr 1e-3) of the MoE LM at full width and 2 layers, batch
    8 x T 512, bf16 compute (the path's dtype, where the routes differ),
    from one init on the same batches; each run's launches show its route.
    Losses within rtol 1e-4; the first step's gradient norm (same weights)
    within rtol 1e-4; the parameters within 2 x lr a step at most (AdamW
    moves an element by about lr whatever its gradient's size, so one whose
    gradient's sign rests on rounding takes a step of the other sign, and
    in bf16 the rounding of one step's activations reaches every later
    gradient) and 1e-4 on average. A third run through the plain versions
    (cuBLAS fp32 products: a third order of the same sums) is printed
    beside them as the yardstick of how far two correct routes part."""
    from cs744_pytorch_distributed_tutorial_tpu_torch.data import synthetic_tokens
    from cs744_pytorch_distributed_tutorial_tpu_torch.ops import gmm as G
    from cs744_pytorch_distributed_tutorial_tpu_torch.train.lm import LMTrainer

    b, t = 8, MOE_WIDTH["max_seq_len"]
    toks = synthetic_tokens(b * MOE_TRAJ_STEPS, t, MOE_WIDTH["vocab_size"], seed=5)
    runs, launches = {}, {}
    routes = {"tensor_cores": contextlib.nullcontext, "ffma": ffma_route,
              "plain": plain_grouped_matmuls}
    for name, route in routes.items():
        tr = LMTrainer(moe_config(num_layers=2, global_batch_size=b, learning_rate=MOE_TRAJ_LR))
        model, _ = tr.init()
        G.reset_launch_count()
        with route():
            steps = [tr.train_step(*tr.split_batch(toks[b * s : b * (s + 1)]))
                     for s in range(MOE_TRAJ_STEPS)]
        torch.cuda.synchronize()
        launches[name] = {k: G.launch_count(k) for k in G.KERNELS if G.launch_count(k)}
        runs[name] = ({k: [float(m[k]) for m in steps] for k in ("loss", "grad_norm")},
                      [p.detach() for p in model.parameters()])
        del tr, model
    n = 2 * 2 * MOE_TRAJ_STEPS  # w_in and w_out of 2 layers a step
    tc, ffma = launches["tensor_cores"], launches["ffma"]
    if not (tc.get("gmm_tc") == tc.get("tgmm_tc") == n
            and tc.get("fused_tc") == tc.get("fused_z_tc") == n // 2
            and not {"gmm", "tgmm", "fused", "fused_z"} & set(tc)
            and ffma.get("gmm") == ffma.get("tgmm") == n
            and ffma.get("fused") == ffma.get("fused_z") == n // 2
            and not {"gmm_tc", "tgmm_tc", "split", "fused_tc", "fused_z_tc"} & set(ffma)):
        raise RuntimeError(f"MoE route trajectory launches: {launches}")

    def gaps(x, y):
        d = torch.cat([(p - q).abs().flatten() for p, q in zip(runs[x][1], runs[y][1])])
        return float(d.max()), float(d.mean())

    (gap, mean_gap), (ref_gap, ref_mean) = gaps("tensor_cores", "ffma"), gaps("plain", "ffma")
    ht, hf, hp = (runs[k][0] for k in routes)
    del runs
    torch.cuda.empty_cache()
    if not all(math.isfinite(x) and abs(x - y) <= 1e-4 * abs(y)
               for x, y in zip(ht["loss"], hf["loss"])):
        raise RuntimeError(f"MoE route trajectory losses differ: tensor cores {ht['loss']} FFMA "
                           f"{hf['loss']}")
    g_t, g_f = ht["grad_norm"][0], hf["grad_norm"][0]
    if not abs(g_t - g_f) <= 1e-4 * abs(g_f):
        raise RuntimeError(f"MoE route trajectory first-step gradient norms differ: {g_t} vs "
                           f"{g_f}")
    if not (gap <= 2 * MOE_TRAJ_LR * MOE_TRAJ_STEPS and mean_gap <= 1e-4):
        raise RuntimeError(f"MoE route trajectory parameters differ by {gap} (mean {mean_gap}) "
                           f"after {MOE_TRAJ_STEPS} steps; plain vs FFMA {ref_gap} (mean "
                           f"{ref_mean})")
    print(f"trajectory MoE tensor-core vs FFMA route (2 layers, full width, batch {b}, bf16): "
          f"losses tensor cores {ht['loss']} FFMA {hf['loss']} plain {hp['loss']}; grad norms "
          f"tensor cores {ht['grad_norm']} FFMA {hf['grad_norm']}; parameter gap after "
          f"{MOE_TRAJ_STEPS} steps max {gap} mean {mean_gap} (plain vs FFMA: max {ref_gap} mean "
          f"{ref_mean}); launches {launches}")


def moe_scatter_phase() -> None:
    """3 steps of the MoE LM through ``lm_cli`` with the capacity-slot
    ``scatter`` dispatch (the JAX default; batched products, no
    grouped-matmul kernel): finite losses, moe_drop in [0, 1)."""
    from cs744_pytorch_distributed_tutorial_tpu_torch import lm_cli

    steps = 3
    t0 = time.perf_counter()
    summary, counts = counted(lambda: run_cli(moe_train_argv("scatter", steps),
                                              main=lm_cli.main))
    wall = time.perf_counter() - t0
    drops = summary["moe"]["moe_drop"]
    if (summary["steps_run"] != steps or not summary["finite"] or counts["gmm_fused"]
            or others(counts, "flash") or not all(0.0 <= x < 1.0 for x in drops)):
        raise RuntimeError(f"MoE scatter run: {summary}, launches {counts}")
    print(f"MoE scatter dispatch: {steps} steps + eval in {wall:.1f} s wall, loss "
          f"{summary['first_loss']} -> {summary['final_loss']}, eval {summary['eval']}, "
          f"moe_drop {drops}, moe_aux {summary['moe']['moe_aux']}; launches {counts}")


# ------------------------------------------------------------- run loop
RUN_LOOP_PER_FILE = 10_000  # records a file: CIFAR-10's 50,000 + 10,000, binary layout
RUN_LOOP_EVERY = 50
RUN_LOOP_NAN_STEP = 120  # restores step 100's state, replays 100..194
PREFETCH_STEPS = 24
FUSED_SGD_KERNEL = "fused_sgd_multi_kernel"
RUN_LOOP_BACKEND = "nccl"


def write_cifar_binary(root, seed: int = 14):
    """A seeded ``cifar-10-batches-bin`` tree, CIFAR-10's size: five files of
    ``RUN_LOOP_PER_FILE`` (10,000) records and a test file of as many (1
    label byte + 3,072 CHW bytes each). Returns each file's raw bytes."""
    import numpy as np

    rng = np.random.default_rng(seed)
    d = root / "cifar-10-batches-bin"
    d.mkdir()
    raws = {}
    names = [f"data_batch_{i}.bin" for i in range(1, 6)] + ["test_batch.bin"]
    for name in names:
        recs = rng.integers(0, 256, size=(RUN_LOOP_PER_FILE, 3073), dtype=np.uint8)
        recs[:, 0] = rng.integers(0, 10, size=RUN_LOOP_PER_FILE)
        (d / name).write_bytes(recs.tobytes())
        raws[name] = recs.reshape(-1)
    return raws


def host_median_ms(fn, reps: int = 5) -> float:
    fn()
    times = []
    for _ in range(reps):
        t0 = time.perf_counter()
        fn()
        times.append((time.perf_counter() - t0) * 1e3)
    return statistics.median(times)


def host_data_phase(root) -> dict:
    """The binary tree written and read through the port (strict mode),
    bitwise against a numpy decode; the native decoder and gather built
    and used; their times against numpy."""
    import numpy as np

    from cs744_pytorch_distributed_tutorial_tpu_torch.data import load_cifar10
    from cs744_pytorch_distributed_tutorial_tpu_torch.data.native_batcher import (
        gather_rows,
        native_usable,
    )
    from cs744_pytorch_distributed_tutorial_tpu_torch.data.native_decode import (
        decode_cifar_records,
        decode_cifar_records_numpy,
    )
    from cs744_pytorch_distributed_tutorial_tpu_torch.native import native_available

    t0 = time.perf_counter()
    raws = write_cifar_binary(root)
    write_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    ds = load_cifar10(str(root), synthetic=False)
    load_s = time.perf_counter() - t0
    if not (native_available("decode") and native_available("batcher")):
        raise RuntimeError("the native decoder or batcher did not build (g++)")
    train = [decode_cifar_records_numpy(raws[f"data_batch_{i}.bin"]) for i in range(1, 6)]
    test = decode_cifar_records_numpy(raws["test_batch.bin"])
    want = (np.concatenate([p[0] for p in train]), np.concatenate([p[1] for p in train]), *test)
    got = (ds.train_images, ds.train_labels, ds.test_images, ds.test_labels)
    if ds.synthetic or any(a.shape != b.shape or not np.array_equal(a, b)
                           for a, b in zip(got, want)):
        raise RuntimeError("the binary CIFAR reader differs from the numpy decode")
    if ds.train_images.shape != (5 * RUN_LOOP_PER_FILE, 32, 32, 3) or not native_usable(ds.train_images):
        raise RuntimeError(f"binary CIFAR: shape {ds.train_images.shape}, native gather unusable")
    raw = np.concatenate([raws[f"data_batch_{i}.bin"] for i in range(1, 6)])
    out = {
        "write_s": write_s,
        "load_s": load_s,
        "decode_ms_native": host_median_ms(lambda: decode_cifar_records(raw)),
        "decode_ms_numpy": host_median_ms(lambda: decode_cifar_records_numpy(raw)),
    }
    rng = np.random.default_rng(0)
    for batch in (256, 4096):
        idx = rng.permutation(5 * RUN_LOOP_PER_FILE)[:batch]
        buf = np.empty((batch, 32, 32, 3), np.uint8)
        if not np.array_equal(gather_rows(ds.train_images, idx, out=buf),
                              np.take(ds.train_images, idx, axis=0)):
            raise RuntimeError(f"native gather differs from np.take at batch {batch}")
        out[f"gather_ms_native_{batch}"] = host_median_ms(
            lambda: gather_rows(ds.train_images, idx, out=buf), reps=20)
        out[f"gather_ms_numpy_{batch}"] = host_median_ms(
            lambda: np.take(ds.train_images, idx, axis=0), reps=20)
    print(f"run loop data: {5 * RUN_LOOP_PER_FILE} + {RUN_LOOP_PER_FILE} binary records written in "
          f"{write_s:.2f} s, loaded (native decode, strict) in {load_s:.2f} s, bitwise == "
          f"numpy; {json.dumps(out)}")
    return out


@contextlib.contextmanager
def captured_trainers(nan_at_call: int | None = None):
    """Patch the port's Trainer so each instance ``fit`` runs on is
    recorded, and (optionally) so train_step returns a NaN loss once, at
    its ``nan_at_call``-th call over every instance."""
    from cs744_pytorch_distributed_tutorial_tpu_torch.train import engine as E

    trainers, calls = [], {"n": 0}
    fit, train_step = E.Trainer.fit, E.Trainer.train_step

    def recording_fit(self, *args, **kwargs):
        if self not in trainers:
            trainers.append(self)
        return fit(self, *args, **kwargs)

    def nan_once(self, x, y):
        loss = train_step(self, x, y)
        calls["n"] += 1
        if calls["n"] == nan_at_call:
            loss = torch.full_like(loss, float("nan"))
        return loss

    attrs = {"fit": recording_fit}
    if nan_at_call is not None:
        attrs["train_step"] = nan_once
    with patched(E.Trainer, **attrs):
        yield trainers, calls


def run_loop_argv(root, *flags: str) -> list[str]:
    return ["--part", "2b", "--num-devices", "1", "--model", "resnet18", "--data-root",
            str(root), "--global-batch-size", "256", "--epochs", "1", "--fused-optimizer",
            "--step-timeout-s", "120", "--prefetch-depth", "2", "--json", "--device", "cuda",
            *flags]


def states_equal(a: dict, b: dict) -> tuple[bool, float]:
    """Bitwise equality of two ``Trainer.capture_state`` dicts, and the
    largest gap over their tensors."""
    pairs = [(x, y) for key in ("params", "momentum", "ef", "opt_nu")
             for x, y in zip(a[key], b[key], strict=True)]
    pairs += [(a["buffers"][n], b["buffers"][n]) for n in a["buffers"]]
    gap = max(float((x.double() - y.double()).abs().max()) for x, y in pairs)
    same = (a["step"] == b["step"] and a["opt_count"] == b["opt_count"]
            and torch.equal(a["augment_gen"], b["augment_gen"])
            and all(torch.equal(x, y) for x, y in pairs))
    return same, gap


def stream_events(metrics_dir) -> list[dict]:
    with open(metrics_dir / "metrics.jsonl") as f:
        return [r for r in map(json.loads, f) if r["kind"] == "event"]


def run_loop_phase() -> dict:
    """The CIFAR Trainer's run loop on the card (ResNet-18 fp32, part 2b on
    NCCL at a world of one, batch 256, ``--fused-optimizer``, one epoch of
    the binary CIFAR tree, cuDNN deterministic): checkpoints every 50
    steps, the metric stream, a profiler window over steps 10-14, the
    watchdog at 120 s, prefetch depth 2; again with a NaN injected once at
    step 120 and ``--max-restarts 1`` (disk tier), and with
    ``--snapshot-every 50`` and no checkpoint directory (memory tier):
    both bitwise equal to the first run; ``--eval-only`` on the first
    run's checkpoints; prefetch depth 0 vs 2; a save's and a restore's
    cost."""
    import pathlib
    import shutil
    import tempfile

    from cs744_pytorch_distributed_tutorial_tpu_torch.ops import fused_sgd as K
    from cs744_pytorch_distributed_tutorial_tpu_torch.utils.checkpoint import (
        Checkpointer,
        to_host,
    )

    root = pathlib.Path(tempfile.mkdtemp(prefix="run_loop_"))
    steps = 5 * RUN_LOOP_PER_FILE // 256  # one epoch: 195 steps
    det = torch.backends.cudnn.deterministic
    torch.backends.cudnn.deterministic = True
    try:
        out = {"host_data": host_data_phase(root)}
        states, summaries = {}, {}
        runs = {
            "run": ((), None),
            "disk": (("--checkpoint-dir", str(root / "ck_disk"), "--max-restarts", "1"),
                     RUN_LOOP_NAN_STEP + 1),
            "memory": (("--snapshot-every", str(RUN_LOOP_EVERY), "--max-restarts", "1"),
                       RUN_LOOP_NAN_STEP + 1),
        }
        for label, (flags, nan_call) in runs.items():
            if label == "run":
                flags = ("--checkpoint-dir", str(root / "ck_run"), "--profile-dir",
                         str(root / "trace"), "--profile-start-step", "10",
                         "--profile-num-steps", "5")
            if label != "memory":
                flags += ("--checkpoint-every", str(RUN_LOOP_EVERY))
            flags += ("--metrics-dir", str(root / f"metrics_{label}"))
            restores = Checkpointer.total_restores
            t0 = time.perf_counter()
            with captured_trainers(nan_call) as (trainers, calls):
                summary, counts = counted(lambda: run_cli(run_loop_argv(root, *flags)))
            wall = time.perf_counter() - t0
            (tr,) = trainers
            states[label], summaries[label] = to_host(tr.capture_state()), summary
            restarts = 0 if nan_call is None else 1
            restart_at = RUN_LOOP_NAN_STEP // RUN_LOOP_EVERY * RUN_LOOP_EVERY
            launches = steps + (0 if nan_call is None else RUN_LOOP_NAN_STEP + 1 - restart_at)
            # Every batch of the epoch and of the eval gathered natively
            # (a recovered run's first attempt gathers as far as its
            # producer ran ahead).
            native = steps + -(-RUN_LOOP_PER_FILE // 256)
            if (summary["steps"] != steps or summary["restarts"] != restarts
                    or summary["backend"] != RUN_LOOP_BACKEND or counts["fused_sgd"] != launches
                    or others(counts, "fused_sgd") or not math.isfinite(summary["final_eval_loss"])
                    or summary["native_batches"] < native
                    or (label == "run" and summary["native_batches"] != native)):
                raise RuntimeError(f"run loop {label}: {summary}, launches {counts}")
            events = stream_events(root / f"metrics_{label}")
            if any(e["event"] == "flight_dump" and e.get("reason") == "watchdog" for e in events):
                raise RuntimeError(f"run loop {label}: the watchdog fired: {events}")
            if label == "run":
                run_trainer = tr
            restored = [e["source"] for e in events if e["event"] == "restore"]
            if restored != ({"run": [], "disk": ["disk"], "memory": ["memory"]}[label]):
                raise RuntimeError(f"run loop {label}: restores {restored}")
            if label == "memory" and Checkpointer.total_restores != restores:
                raise RuntimeError("the memory tier's recovery read a checkpoint file")
            out[f"{label}_wall_s"] = wall
            out[f"{label}_fused_sgd_launches"] = counts["fused_sgd"]
            print(f"run loop {label}: {summary['steps']} steps, {summary['restarts']} restart(s), "
                  f"{counts['fused_sgd']} fused-SGD launches, {summary['native_batches']} native "
                  f"batches, eval loss {summary['final_eval_loss']}, {wall:.1f} s wall")
        for label in ("disk", "memory"):
            same, gap = states_equal(states[label], states["run"])
            if not same:
                raise RuntimeError(f"run loop: recovery from the {label} tier differs from the "
                                   f"uninterrupted run by {gap}")
            print(f"run loop: recovery from the {label} tier == the uninterrupted run, bitwise "
                  f"(every parameter, momentum and BatchNorm buffer, the generator's state)")

        ev = run_cli(run_loop_argv(root, "--checkpoint-dir", str(root / "ck_run"),
                                   "--eval-only"))
        want = summaries["run"]["final_eval_loss"]
        if (abs(ev["final_eval_loss"] - want) > 1e-6 * abs(want)
                or ev["final_eval_accuracy"] != summaries["run"]["final_eval_accuracy"]):
            raise RuntimeError(f"--eval-only {ev} differs from the run's final eval {want}")
        print(f"run loop: --eval-only {ev['final_eval_loss']} vs the run's {want}")

        m = root / "metrics_run"
        with open(m / "metrics.jsonl") as f:
            records = [r for r in map(json.loads, f) if r["kind"] == "step"]
        traces = list((root / "trace").glob("trace_rank0_*.json"))
        if not ((m / "manifest.json").exists() and records and len(traces) == 1):
            raise RuntimeError(f"run loop: metrics {len(records)} step records, traces {traces}")
        if FUSED_SGD_KERNEL not in traces[0].read_text():
            raise RuntimeError("the profiler window's trace holds no fused SGD kernel")
        out["trace_mb"] = traces[0].stat().st_size / 1e6
        print(f"run loop: {len(records)} step records, manifest, a {out['trace_mb']:.1f} MB trace "
              f"holding {FUSED_SGD_KERNEL}; the watchdog never fired")

        # Prefetch depth 0 vs 2 in turns, synthetic data through the same loader.
        for depth in ("0", "2", "2", "0"):
            s = run_cli(cli_argv("resnet18", "1", PREFETCH_STEPS, "--fused-optimizer",
                                 "--prefetch-depth", depth))
            out.setdefault(f"avg_batch_time_s_depth{depth}", []).append(s["avg_batch_time_s"])
        print(f"run loop prefetch: avg_batch_time_s depth 0 "
              f"{out['avg_batch_time_s_depth0']}, depth 2 {out['avg_batch_time_s_depth2']}")

        # A checkpoint's costs on the run's trainer (ResNet-18, fused SGD).
        tr = run_trainer
        ck = Checkpointer(str(root / "ck_cost"))
        save_ms, durable_ms, restore_ms, load_ms = [], [], [], []
        for i in range(3):
            tr.state.step = steps + i + 1
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            ck.save(tr.capture_state())
            t1 = time.perf_counter()
            ck.latest_step()
            t2 = time.perf_counter()
            state = ck.restore_latest()
            t3 = time.perf_counter()
            tr.restore_state(state)
            torch.cuda.synchronize()
            t4 = time.perf_counter()
            save_ms.append((t1 - t0) * 1e3)
            durable_ms.append((t2 - t0) * 1e3)
            restore_ms.append((t3 - t2) * 1e3)
            load_ms.append((t4 - t3) * 1e3)
        ck.close()
        nbytes = sum(f.stat().st_size for f in (root / "ck_cost").rglob("rank0.pt")) / len(
            list((root / "ck_cost").iterdir()))
        out.update(save_blocking_ms=save_ms, save_durable_ms=durable_ms,
                   restore_read_ms=restore_ms, restore_copy_ms=load_ms,
                   checkpoint_mb=nbytes / 1e6)
        print(json.dumps({"run_loop": out}))
        return out
    finally:
        torch.backends.cudnn.deterministic = det
        shutil.rmtree(root, ignore_errors=True)



# ----------------------------------------------------------- phase profiler
LM_LOOP_STEPS, LM_LOOP_EVERY, LM_LOOP_NAN_CALL = 20, 10, 15  # the NaN restores step 10
PHASE_BREAKDOWNS = {  # label: bench.py flags (each with its defaults otherwise)
    "auto": (),
    "allreduce_bucket": ("--sync", "allreduce", "--sync-overlap", "bucket"),
    "int8_bucket": ("--sync", "allreduce", "--grad-compress", "int8", "--sync-overlap",
                    "bucket+int8"),
}


def kernel_detail() -> dict:
    """Every path kernel's launches since the last reset, by kernel and
    route (read after ``counted``)."""
    from cs744_pytorch_distributed_tutorial_tpu_torch.ops import fused_conv as C
    from cs744_pytorch_distributed_tutorial_tpu_torch.ops import fused_xent as FX
    from cs744_pytorch_distributed_tutorial_tpu_torch.ops import gmm as G

    detail = {f"flash_{k}": n for k, n in flash_counts().items()}
    detail.update({f"fused_xent_{k}": FX.launch_count(k) for k in FX.KERNELS})
    detail.update({f"gmm_{k}": G.launch_count(k) for k in G.KERNELS})
    detail.update({f"conv3x3_wgrad_s{s}" + ("_tc" if r == "tc" else ""): C.launch_count(s, route=r)
                   for s in (1, 2) for r in ("ffma", "tc")})
    return {k: n for k, n in detail.items() if n}


def segment_launches(segs, x, y, start: dict) -> dict:
    """Each segment's launches in one call (``counted``: zeroed just before,
    read just after), the trainer restored to ``start`` after each; the
    optimizer's inputs are the grads segment's gradients."""
    tr = segs.trainer
    out = {}
    for name in ("forward", "grads", "opt", "fused"):
        grads = segs.grads(x, y)[1] if name == "opt" else None
        fn = {"forward": lambda: segs.forward(x, y), "grads": lambda: segs.grads(x, y),
              "opt": lambda: segs.opt(grads if segs.sync is None else segs.sync(grads)),
              "fused": lambda: segs.fused(x, y)}[name]
        _, counts = counted(fn)
        out[name] = {**kernel_detail(), **({"fused_sgd": counts["fused_sgd"]}
                                           if counts["fused_sgd"] else {})}
        tr.restore_state(start)
    return out


def cifar_phases_phase() -> dict:
    """Phase 21: the phase profiler on the CIFAR Trainer (``obs/phases.py``)
    through the port's ``bench.py``: ``--phase-breakdown`` with its
    defaults (ResNet-18, bf16, DDP, batch 4096, NCCL at a world of one),
    then over the overlapped allreduce and the overlapped int8 wire, each
    with ``parity_ok``; ``python -m ...obs report`` on the first one's
    ``phase_report.json`` printing the table the bench printed;
    ``profile_phases`` on ResNet-18 fp32 at batch 256 with ``fast_conv``
    (the backward launches the tensor-core wgrad 6 times a call, the
    forward none); ``device_op_breakdown`` of its fused step; and
    ``--sync-compare``'s four bench records and the two pure
    data-parallel wires' phase pairs (zero1's pair needs more than one
    rank and raises, as in JAX)."""
    import pathlib
    import shutil
    import tempfile

    from cs744_pytorch_distributed_tutorial_tpu_torch import bench
    from cs744_pytorch_distributed_tutorial_tpu_torch.obs import phases as P
    from cs744_pytorch_distributed_tutorial_tpu_torch.utils.profiling import device_op_breakdown

    root = pathlib.Path(tempfile.mkdtemp(prefix="phases_"))
    out: dict = {"card": card_line()}
    try:
        for label, flags in PHASE_BREAKDOWNS.items():
            mdir = root / label
            stdout, stderr = io.StringIO(), io.StringIO()
            t0 = time.perf_counter()
            with contextlib.redirect_stdout(stdout), contextlib.redirect_stderr(stderr):
                rc = bench.main(["--phase-breakdown", *flags, "--metrics-dir", str(mdir)])
            wall = time.perf_counter() - t0
            records = [json.loads(line) for line in stdout.getvalue().splitlines()
                       if line.startswith("{")]
            summary = next(r for r in records if r["kind"] == "phase_summary")
            print(stderr.getvalue(), end="")
            print(json.dumps({"phase_breakdown": label, "records": records}))
            if (rc != 0 or not summary["parity_ok"]
                    or summary["fused_clock"] not in P.DEVICE_CLOCKS):
                raise RuntimeError(f"--phase-breakdown {label}: rc {rc}, {summary}")
            if label == "auto":
                rep = subprocess.run([sys.executable, "-m",
                                      "cs744_pytorch_distributed_tutorial_tpu_torch.obs", "report",
                                      str(mdir)], capture_output=True, text=True, timeout=300)
                if rep.returncode != 0 or rep.stdout.strip() not in stderr.getvalue():
                    raise RuntimeError(f"obs report printed another table:\n{rep.stdout}\n"
                                       f"{rep.stderr}")
                print("obs report on phase_report.json: the table the bench printed")
            out[f"breakdown_{label}"] = {"records": records, "wall_s": wall}

        with bench.headline_trainer(256, "cuda", compute_dtype="float32",
                                    fast_conv=True) as (tr, x, y):
            segs = P.build_cifar_segments(tr)
            start = tr.capture_state(clone=True)
            launches = segment_launches(segs, x, y, start)
            want = {"forward": {}, "grads": {"conv3x3_wgrad_s1_tc": RESNET18_ROUTED},
                    "opt": {}, "fused": {"conv3x3_wgrad_s1_tc": RESNET18_ROUTED}}
            if launches != want:
                raise RuntimeError(f"ResNet-18 fast_conv segments launched {launches}, "
                                   f"expected {want}")
            report = P.profile_phases(tr, x, y)
            print(report.table())
            print(json.dumps({"profile_phases_resnet18_fp32_fast_conv": report.records()}))
            if not report.parity_ok or report.fused_clock not in P.DEVICE_CLOCKS:
                raise RuntimeError("profile_phases on ResNet-18 fp32 fast_conv: parity "
                                   f"{report.parity_ok}, clock {report.fused_clock}")
            total, rows = device_op_breakdown(tr.train_step, x, y, iters=3, top=12)
            print(f"device_op_breakdown of the fused ResNet-18 fp32 fast_conv step: {total:.4f} "
                  f"ms a step; top ops " + json.dumps([[round(ms, 4), name[:80]]
                                                        for ms, name in rows]))
            if not any("wgrad_tc_kernel" in name for _, name in rows):
                raise RuntimeError("device_op_breakdown shows no wgrad_tc_kernel in the step")
            out.update(segment_launches_resnet18=launches, profile_resnet18=report.records(),
                       breakdown_device_ms=total, breakdown_rows=rows)

        class Sink:
            records: list = []

            def emit(self, rec):
                self.records.append(rec)

        sink = Sink()
        t0 = time.perf_counter()
        try:
            bench.sync_compare(sink)
            raise RuntimeError("sync_compare's zero1 phase pair ran at a world of one")
        except ValueError as e:
            if "bucket" not in str(e):
                raise
        kinds = [r["kind"] for r in sink.records]
        print(json.dumps({"sync_compare": sink.records, "wall_s": time.perf_counter() - t0}))
        if kinds != ["bench"] * 4 + ["sync_compare"] * 2 or not all(
                r["parity_ok"] for r in sink.records[4:]):
            raise RuntimeError(f"sync_compare records {kinds}")
        out["sync_compare"] = sink.records
        return out
    finally:
        shutil.rmtree(root, ignore_errors=True)


def lm_phases_phase() -> dict:
    """Phase 22: ``profile_lm_phases`` on GPT-2-small at full width (12
    layers, d 768, T 1024, batch 16, bf16, flash, ``fused_xent``) and on the
    MoE LM ``moe_e8_top2_dropless_pallas`` (6 layers, d 512, E 8 top-2,
    batch 32 x T 512), each with ``parity_ok``, and each segment's kernel
    launches in one call exact: flash, the fused cross-entropy and the
    grouped matmuls."""
    from cs744_pytorch_distributed_tutorial_tpu_torch.data import synthetic_tokens
    from cs744_pytorch_distributed_tutorial_tpu_torch.obs import phases as P
    from cs744_pytorch_distributed_tutorial_tpu_torch.train.lm import LMTrainer

    gpt, moe = LM_WIDTH["num_layers"], MOE_WIDTH["num_layers"]
    fwd_gpt = {"flash_fwd_tc": gpt, "fused_xent_fwd": 1}
    grads_gpt = {**fwd_gpt, "flash_dq_tc": gpt, "flash_dkv_tc": gpt, "fused_xent_bwd": 1}
    fwd_moe = {"flash_fwd_tc": moe, "gmm_fused_tc": moe, "gmm_fused_z_tc": moe}
    grads_moe = {**fwd_moe, "flash_dq_tc": moe, "flash_dkv_tc": moe, "gmm_gmm_tc": 2 * moe,
                 "gmm_tgmm_tc": 2 * moe, "gmm_split": moe, "gmm_colsum": 2 * moe}
    cases = {
        "gpt2_small": (lm_config(fused_xent=True), 16,
                       {"forward": fwd_gpt, "grads": grads_gpt, "opt": {}, "fused": grads_gpt}),
        "moe_e8_top2_dropless": (moe_config(), MOE_TRAIN_BATCH,
                                 {"forward": fwd_moe, "grads": grads_moe, "opt": {},
                                  "fused": grads_moe}),
    }
    out: dict = {}
    for label, (cfg, batch, want) in cases.items():
        tr = LMTrainer(cfg)
        tr.init()
        x, y = tr.split_batch(synthetic_tokens(batch, cfg.seq_len, cfg.vocab_size, seed=0))
        segs = P.build_lm_segments(tr)
        launches = segment_launches(segs, x, y, tr.capture_state(clone=True))
        if launches != want:
            raise RuntimeError(f"{label} segments launched {launches}, expected {want}")
        t0 = time.perf_counter()
        report = P.profile_lm_phases(tr, x, y)
        wall = time.perf_counter() - t0
        print(report.table())
        print(json.dumps({f"profile_lm_phases_{label}": report.records(), "wall_s": wall,
                          "launches": launches}))
        if not report.parity_ok or report.fused_clock not in P.DEVICE_CLOCKS:
            raise RuntimeError(f"profile_lm_phases {label}: parity {report.parity_ok}, clock "
                               f"{report.fused_clock}")
        out[label] = {"records": report.records(), "launches": launches}
        del tr, segs, x, y
        torch.cuda.empty_cache()
    return out


@contextlib.contextmanager
def captured_lm_trainers(nan_at_call: int | None = None):
    """Patch the port's LMTrainer so each instance ``fit`` runs on is
    recorded, and (optionally) so train_step returns a NaN loss once, at
    its ``nan_at_call``-th call over every instance."""
    from cs744_pytorch_distributed_tutorial_tpu_torch.train import lm as L

    trainers, calls = [], {"n": 0}
    fit, train_step = L.LMTrainer.fit, L.LMTrainer.train_step

    def recording_fit(self, *args, **kwargs):
        if self not in trainers:
            trainers.append(self)
        return fit(self, *args, **kwargs)

    def nan_once(self, x, y):
        m = train_step(self, x, y)
        calls["n"] += 1
        if calls["n"] == nan_at_call:
            m = dict(m, loss=torch.full_like(m["loss"], float("nan")))
        return m

    attrs = {"fit": recording_fit}
    if nan_at_call is not None:
        attrs["train_step"] = nan_once
    with patched(L.LMTrainer, **attrs):
        yield trainers


def lm_states_equal(a: dict, b: dict) -> tuple[bool, float]:
    pairs = [(x, y) for key in ("params", "momentum", "opt_nu")
             for x, y in zip(a[key], b[key], strict=True)]
    gap = max(float((x.double() - y.double()).abs().max()) for x, y in pairs)
    same = ((a["step"], a["opt_count"]) == (b["step"], b["opt_count"])
            and all(torch.equal(x, y) for x, y in pairs))
    return same, gap


def lm_run_loop_phase() -> dict:
    """Phase 23: the LM trainer's run loop through ``lm_cli`` on
    GPT-2-small at full width (bf16, flash, ``--fused-xent``),
    ``LM_LOOP_STEPS`` steps: a checkpoint every ``LM_LOOP_EVERY``, the
    metric stream, a profiler window over steps 2-4 whose trace holds the
    flash kernels, the watchdog at 300 s; again with a NaN injected once at
    call ``LM_LOOP_NAN_CALL`` and ``--max-restarts 1`` (restored from the
    disk checkpoint before it), and with ``--snapshot-every LM_LOOP_EVERY``
    and no checkpoint directory (restored from host RAM, no file read):
    both bitwise equal to the first run in every parameter and moment;
    then a checkpoint's blocking, durable, read and copy-back costs for
    the parameters and both AdamW moments."""
    import pathlib
    import shutil
    import tempfile

    from cs744_pytorch_distributed_tutorial_tpu_torch import lm_cli
    from cs744_pytorch_distributed_tutorial_tpu_torch.utils.checkpoint import (
        Checkpointer,
        to_host,
    )

    steps, layers = LM_LOOP_STEPS, LM_WIDTH["num_layers"]
    argv = [arg for key, value in LM_WIDTH.items()
            for arg in (f"--{key.replace('_', '-')}", str(value))]
    argv += ["--global-batch-size", "16", "--use-rope", "--attention-impl", "flash",
             "--fused-xent", "--compute-dtype", "bfloat16", "--optimizer", "adamw", "--steps",
             str(steps), "--num-seqs", "320", "--json", "--device", "cuda"]
    root = pathlib.Path(tempfile.mkdtemp(prefix="lm_run_loop_"))
    runs = {
        "run": (("--checkpoint-dir", str(root / "ck_run"), "--checkpoint-every",
                 str(LM_LOOP_EVERY), "--profile-dir", str(root / "trace"), "--step-timeout-s",
                 "300"), None),
        "disk": (("--checkpoint-dir", str(root / "ck_disk"), "--checkpoint-every",
                  str(LM_LOOP_EVERY), "--max-restarts", "1"), LM_LOOP_NAN_CALL),
        "memory": (("--snapshot-every", str(LM_LOOP_EVERY), "--max-restarts", "1"),
                   LM_LOOP_NAN_CALL),
    }
    out: dict = {"card": card_line()}
    states = {}
    try:
        for label, (flags, nan_call) in runs.items():
            mdir = root / f"metrics_{label}"
            restores = Checkpointer.total_restores
            t0 = time.perf_counter()
            with captured_lm_trainers(nan_call) as trainers:
                summary, _ = counted(lambda: run_cli([*argv, *flags, "--metrics-dir", str(mdir)],
                                                     main=lm_cli.main))
            wall = time.perf_counter() - t0
            detail = kernel_detail()
            (tr,) = trainers
            states[label] = to_host(tr.capture_state())
            # Train calls: every step, and on a recovered run the replay from
            # the restored step; one eval forward certifies the final state.
            calls = steps + (0 if nan_call is None else nan_call - LM_LOOP_EVERY)
            want = {"flash_fwd_tc": layers * (calls + 1), "flash_dq_tc": layers * calls,
                    "flash_dkv_tc": layers * calls, "fused_xent_fwd": calls,
                    "fused_xent_bwd": calls}
            run_steps = steps if nan_call is None else steps - LM_LOOP_EVERY
            if detail != want or summary["steps_run"] != run_steps or not summary["finite"]:
                raise RuntimeError(f"LM run loop {label}: {summary}, launches {detail}, "
                                   f"expected {want}")
            events = stream_events(mdir)
            restored = [(e["source"], e["step"]) for e in events if e["event"] == "restore"]
            if restored != {"run": [], "disk": [("disk", LM_LOOP_EVERY)],
                            "memory": [("memory", LM_LOOP_EVERY)]}[label]:
                raise RuntimeError(f"LM run loop {label}: restores {restored}")
            if any(e["event"] == "flight_dump" and e.get("reason") == "watchdog"
                   for e in events):
                raise RuntimeError(f"LM run loop {label}: the watchdog fired")
            if label == "memory" and Checkpointer.total_restores != restores:
                raise RuntimeError("the LM memory tier's recovery read a checkpoint file")
            if label == "run":
                run_trainer = tr
            out[f"{label}_wall_s"], out[f"{label}_launches"] = wall, detail
            print(f"LM run loop {label}: {summary['steps_run']} steps run, restores {restored}, "
                  f"launches {detail}, final loss {summary['final_loss']}, {wall:.1f} s wall")
        for label in ("disk", "memory"):
            same, gap = lm_states_equal(states[label], states["run"])
            if not same:
                raise RuntimeError(f"LM run loop: recovery from the {label} tier differs from "
                                   f"the uninterrupted run by {gap}")
            print(f"LM run loop: recovery from the {label} tier == the uninterrupted run, "
                  f"bitwise (every parameter, both AdamW moments, the count and the step)")
        shutil.rmtree(root / "ck_disk", ignore_errors=True)

        with open(root / "metrics_run" / "metrics.jsonl") as f:
            records = [r for r in map(json.loads, f) if r["kind"] == "step"]
        traces = list((root / "trace").glob("trace_rank0_*.json"))
        text = traces[0].read_text() if len(traces) == 1 else ""
        if not ((root / "metrics_run" / "manifest.json").exists() and len(records) == steps
                and "flash_fwd_tc_kernel" in text and "flash_dq_tc_kernel" in text):
            raise RuntimeError(f"LM run loop: {len(records)} step records, traces {traces}")
        out["trace_mb"] = traces[0].stat().st_size / 1e6
        del text
        print(f"LM run loop: {len(records)} step records, manifest, a {out['trace_mb']:.1f} MB "
              f"trace holding flash_fwd_tc_kernel and flash_dq_tc_kernel")
        shutil.rmtree(root / "ck_run", ignore_errors=True)

        tr = run_trainer
        ck = Checkpointer(str(root / "ck_cost"), max_to_keep=1)
        save_ms, durable_ms, restore_ms, load_ms = [], [], [], []
        for i in range(3):
            tr.step = steps + i + 1
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            ck.save(tr.capture_state())
            t1 = time.perf_counter()
            ck.latest_step()
            t2 = time.perf_counter()
            state = ck.restore_latest()
            t3 = time.perf_counter()
            tr.restore_state(state)
            torch.cuda.synchronize()
            t4 = time.perf_counter()
            save_ms.append((t1 - t0) * 1e3)
            durable_ms.append((t2 - t0) * 1e3)
            restore_ms.append((t3 - t2) * 1e3)
            load_ms.append((t4 - t3) * 1e3)
        ck.close()
        nbytes = next((root / "ck_cost").rglob("rank0.pt")).stat().st_size
        out.update(save_blocking_ms=save_ms, save_durable_ms=durable_ms,
                   restore_read_ms=restore_ms, restore_copy_ms=load_ms, checkpoint_mb=nbytes / 1e6)
        print(json.dumps({"lm_run_loop": out}))
        return out
    finally:
        shutil.rmtree(root, ignore_errors=True)


# ------------------------------------------- LM options, beam, speculative
OPT_STEPS, OPT_TIMED = 4, 3  # steps a run of phase 24; the last OPT_TIMED timed
OPT_RUNS = {  # label: LMConfig overrides on the main path's config
    "baseline": {}, "remat_none": dict(remat=True), "remat_dots": dict(remat=True,
                                                                       remat_policy="dots"),
    "scan_layers": dict(scan_layers=True), "accum_2": dict(accum_steps=2),
    "dropout_0.1": dict(dropout_rate=0.1), "dropout_0.1_remat": dict(dropout_rate=0.1, remat=True),
}
BEAM_BATCH, BEAM_K, BEAM_PROMPT, BEAM_NEW = 2, 4, 64, 32  # 32 new: the time limit
BEAM_SCORE_RTOL = 1e-3  # |beam score - teacher-forced re-score| / |re-score|, bf16
SPEC_K, SPEC_NEW, SPEC_STEPS, SPEC_PROMPT = 4, 128, 24, 64


def lm_options_phase() -> dict:
    """Phase 24: GPT-2-small at full width (bf16, flash, ``fused_xent``,
    AdamW, batch 16 x T 1024), OPT_STEPS steps from one initial state on
    the same batches for each of OPT_RUNS, every launch count exact (a
    step: 12 flash forwards, 12 dq, 12 dk/dv, one fused cross-entropy
    forward and backward; remat runs the forwards again in the backward,
    under either policy, the kernels being opaque to a dispatch-level
    policy; accum_steps=2 doubles every count). Against the baseline:
    remat, dots and scan_layers losses within rtol 1e-5 and parameters
    within 2 x lr a step at most, 1e-6 on average (bitwise expected,
    printed); accum_steps=2 losses within rtol 2e-3, parameters within 2 x
    lr a step, 1e-4 on average; dropout losses within 5 % of the
    baseline's and not equal to them. Dropout with remat against dropout
    alone: losses equal, and the first step's gradients within 1e-6 x
    max|g| (bitwise expected, printed). Each run's step ms (CUDA events,
    the last OPT_TIMED steps) and its peak memory above what was allocated
    before its trainer was built."""
    from cs744_pytorch_distributed_tutorial_tpu_torch.data import synthetic_tokens
    from cs744_pytorch_distributed_tutorial_tpu_torch.models.transformer import (
        stack_block_params,
        unstack_block_params,
    )
    from cs744_pytorch_distributed_tutorial_tpu_torch.train.lm import LMTrainer

    b, layers = 16, LM_WIDTH["num_layers"]
    toks = synthetic_tokens(b * OPT_STEPS, LM_WIDTH["seq_len"], LM_WIDTH["vocab_size"], seed=24)
    start = LMTrainer(lm_config(fused_xent=True))
    start.init()
    init_sd = {k: v.detach().clone() for k, v in start.model.state_dict().items()}
    lr = start.cfg.learning_rate
    del start
    torch.cuda.empty_cache()
    runs: dict = {}
    for label, kw in OPT_RUNS.items():
        # Peak memory: the run's own (its model, optimizer, batches and
        # activations) above what earlier runs left for the comparisons.
        torch.cuda.synchronize()
        before = torch.cuda.memory_allocated()
        torch.cuda.reset_peak_memory_stats()
        tr = LMTrainer(lm_config(fused_xent=True, **kw))
        tr.init(state_dict=stack_block_params(init_sd) if kw.get("scan_layers") else init_sd)
        batches = [tr.split_batch(toks[b * i: b * (i + 1)]) for i in range(OPT_STEPS)]
        timer = [torch.cuda.Event(enable_timing=True) for _ in range(2)]
        first_grads = []

        def steps():
            losses = []
            for i, (x, y) in enumerate(batches):
                if i == OPT_STEPS - OPT_TIMED:
                    timer[0].record()
                losses.append(tr.train_step(x, y)["loss"])
                if i == 0 and label.startswith("dropout"):
                    first_grads.extend(p.grad.detach().clone() for p in tr.model.parameters())
            timer[1].record()
            return losses

        losses, all_counts = counted(steps)
        detail = kernel_detail()
        ms = timer[0].elapsed_time(timer[1]) / OPT_TIMED
        sd = tr.model.state_dict()
        if kw.get("scan_layers"):
            sd = unstack_block_params(sd)
        runs[label] = {"losses": [float(v) for v in losses], "ms_per_step": ms,
                       "peak_memory_gb": (torch.cuda.max_memory_allocated() - before) / 1e9,
                       "launches": detail, "params": {k: v.detach() for k, v in sd.items()},
                       "grads": first_grads}
        # A step: each layer's forward (again in the backward under remat),
        # dq and dk/dv, and one cross-entropy forward and backward, a
        # microbatch each.
        micro = kw.get("accum_steps", 1) * OPT_STEPS
        want = {"flash_fwd_tc": layers * micro * (2 if kw.get("remat") else 1),
                "flash_dq_tc": layers * micro, "flash_dkv_tc": layers * micro,
                "fused_xent_fwd": micro, "fused_xent_bwd": micro}
        if detail != want or others(all_counts, "flash", "fused_xent"):
            raise RuntimeError(f"LM options {label}: launches {detail} (all {all_counts}), "
                               f"expected {want}")
        print(f"LM options {label}: losses {runs[label]['losses']}, {ms:.3f} ms a step, peak "
              f"memory {runs[label]['peak_memory_gb']:.3f} GB, launches {detail}")
        del tr, batches, sd
        torch.cuda.empty_cache()

    def gap(a: str, c: str) -> tuple[float, float, bool]:
        d = torch.cat([(runs[a]["params"][k] - runs[c]["params"][k]).abs().flatten()
                       for k in runs[c]["params"]])
        same = all(torch.equal(runs[a]["params"][k], runs[c]["params"][k])
                   for k in runs[c]["params"])
        return float(d.max()), float(d.mean()), same

    base = runs["baseline"]["losses"]
    out: dict = {"card": card_line()}
    for label, (rtol, mean_tol) in (("remat_none", (1e-5, 1e-6)), ("remat_dots", (1e-5, 1e-6)),
                                    ("scan_layers", (1e-5, 1e-6)), ("accum_2", (2e-3, 1e-4))):
        losses = runs[label]["losses"]
        loss_gap = max(abs(x - y) / abs(y) for x, y in zip(losses, base))
        pmax, pmean, same = gap(label, "baseline")
        line = (f"LM options {label} vs baseline: max relative loss gap {loss_gap:.3e}, parameter "
                f"gap max {pmax} mean {pmean}, bitwise {same and losses == base}")
        print(line)
        if not (loss_gap <= rtol and pmax <= 2 * lr * OPT_STEPS and pmean <= mean_tol):
            raise RuntimeError(line)
    for label in ("dropout_0.1", "dropout_0.1_remat"):
        losses = runs[label]["losses"]
        if not all(math.isfinite(x) and abs(x - y) <= 0.05 * abs(y) and x != y
                   for x, y in zip(losses, base)):
            raise RuntimeError(f"LM options {label}: losses {losses} vs baseline {base}")
    ga, gb = runs["dropout_0.1"]["grads"], runs["dropout_0.1_remat"]["grads"]
    g_gap = max(float((x - y).abs().max()) for x, y in zip(ga, gb))
    g_max = max(float(x.abs().max()) for x in ga)
    g_same = all(torch.equal(x, y) for x, y in zip(ga, gb))
    d_line = (f"LM options dropout 0.1 with remat vs without: losses "
              f"{runs['dropout_0.1_remat']['losses']} vs {runs['dropout_0.1']['losses']}, first "
              f"step's gradient gap {g_gap} (max |g| {g_max}), bitwise {g_same}")
    print(d_line)
    if runs["dropout_0.1_remat"]["losses"] != runs["dropout_0.1"]["losses"] or not (
            g_gap <= 1e-6 * g_max):
        raise RuntimeError(d_line)
    for label, r in runs.items():
        out[label] = {k: r[k] for k in ("losses", "ms_per_step", "peak_memory_gb", "launches")}
    del runs
    torch.cuda.empty_cache()
    print(json.dumps({"lm_options": out}))
    return out


def beam_phase() -> dict:
    """Phase 25: beam search at GPT-2-small width (4 KV heads, bf16), batch
    BEAM_BATCH, BEAM_K beams, a BEAM_PROMPT-token prompt, BEAM_NEW new
    tokens, random weights: beam 1 bitwise equal to greedy
    ``make_generator``; the K-beam score of each row against a
    teacher-forced re-score of its tokens (the full forward, fp32
    log-softmax) within BEAM_SCORE_RTOL; with the int8 head exactly one
    int8 launch a model call (BEAM_NEW in all, on the route its rows
    take) and no other kernel; ms a beam step on the host clock and on
    the device (torch.profiler's kernel time), beside greedy decoding of
    the same rows. Returns the int8 head run's launches by route."""
    from cs744_pytorch_distributed_tutorial_tpu_torch.data import synthetic_tokens
    from cs744_pytorch_distributed_tutorial_tpu_torch.infer import (
        make_beam_searcher,
        make_generator,
    )
    from cs744_pytorch_distributed_tutorial_tpu_torch.train.lm import LMConfig, LMTrainer

    tr = LMTrainer(LMConfig(**DECODE_WIDTH, use_rope=True, compute_dtype="bfloat16",
                            device="cuda"))
    model = tr.decode_model()
    prompt = torch.from_numpy(synthetic_tokens(BEAM_BATCH, BEAM_PROMPT, DECODE_WIDTH["vocab_size"],
                                               seed=25)[:, :BEAM_PROMPT]).long().cuda()
    greedy = make_generator(model, max_new_tokens=BEAM_NEW, temperature=0.0)
    beam1 = make_beam_searcher(model, beam_size=1, max_new_tokens=BEAM_NEW)
    want, (got1, _) = greedy(prompt), beam1(prompt)
    if not torch.equal(got1, want):
        raise RuntimeError(f"beam 1 differs from greedy at {int((got1 != want).sum())} tokens")
    search = make_beam_searcher(model, beam_size=BEAM_K, max_new_tokens=BEAM_NEW)
    (toks, scores), counts = counted(lambda: search(prompt))
    if any(counts.values()):
        raise RuntimeError(f"the float beam search launched kernels: {counts}")
    host_ms = search.timing["decode_s"] * 1e3 / search.timing["decode_steps"]
    with torch.no_grad():
        logp = torch.log_softmax(model(torch.cat([prompt, toks], 1)).float(), -1)
    t0 = BEAM_PROMPT
    rescore = logp[:, t0 - 1:-1].gather(-1, toks[..., None])[..., 0].sum(-1)
    rel = float(((scores - rescore).abs() / rescore.abs()).max())
    line = (f"beam K={BEAM_K}: scores {scores.tolist()}, teacher-forced {rescore.tolist()}, "
            f"max relative gap {rel:.3e}")
    print(line)
    if not (bool(torch.isfinite(scores).all()) and rel <= BEAM_SCORE_RTOL):
        raise RuntimeError(line)
    steps = BEAM_NEW - 1
    greedy_b = make_generator(model, max_new_tokens=BEAM_NEW, temperature=0.0)
    rows = prompt.repeat_interleave(BEAM_K, 0)
    greedy_b(rows)
    g_host_ms = greedy_b.timing["decode_s"] * 1e3 / greedy_b.timing["decode_steps"]
    device_ms = device_busy_ms(lambda: search(prompt), reps=1)
    g_device_ms = device_busy_ms(lambda: greedy_b(rows), reps=1)
    qmodel = tr.quantized_decode_model("head")
    qsearch = make_beam_searcher(qmodel, beam_size=BEAM_K, max_new_tokens=BEAM_NEW)
    (qtoks, _), qcounts = counted(lambda: qsearch(prompt))
    if qcounts["int8_matmul"] != BEAM_NEW or others(qcounts, "int8_matmul", "int8_matmul_tc"):
        raise RuntimeError(f"int8-head beam search launches {qcounts}, expected {BEAM_NEW} "
                           f"int8_matmul and no other")
    agree = float((qtoks == toks).float().mean())
    out = {"card": card_line(), "host_ms_per_beam_step": host_ms,
           "device_ms_per_beam_step": None if device_ms is None else device_ms / steps,
           "greedy_host_ms_per_step_same_rows": g_host_ms,
           "greedy_device_ms_per_step_same_rows": (None if g_device_ms is None
                                                   else g_device_ms / steps),
           "score_max_relative_gap": rel, "int8_launches": qcounts["int8_matmul"],
           "int8_launches_tc": qcounts["int8_matmul_tc"], "int8_head_token_agreement": agree}
    print(json.dumps({"beam": out}))
    del tr, model, qmodel
    torch.cuda.empty_cache()
    tc = qcounts["int8_matmul_tc"]
    return {"tc": tc, "ffma": qcounts["int8_matmul"] - tc}


def speculative_phase() -> dict:
    """Phase 26: speculative decoding through ``lm_cli`` on GPT-2-small
    (bf16, flash, ``fused_xent``; the target and the 1-layer draft each
    trained SPEC_STEPS steps at batch 16 x T 1024): ``--speculative-k
    SPEC_K --draft-layers 1 --generate SPEC_NEW``, greedy and at
    ``--temperature 0.8``, every launch count exact (the two trainings'
    flash and fused cross-entropy; decoding runs dense attention, as the
    JAX decode model, and no kernel). Greedy: the tokens that agree with
    plain greedy ``make_generator`` on the same target weights, target
    calls, accept rate and tokens/s against plain greedy's. Then the
    target as its own draft in fp32 (TF32 off): equal to plain greedy,
    every round accepting all k (ceil((SPEC_NEW - 1) / (SPEC_K + 1))
    calls). Returns each run's launches."""
    from cs744_pytorch_distributed_tutorial_tpu_torch import lm_cli
    from cs744_pytorch_distributed_tutorial_tpu_torch.data import synthetic_tokens
    from cs744_pytorch_distributed_tutorial_tpu_torch.infer import (
        make_generator,
        make_speculative_generator,
    )
    from cs744_pytorch_distributed_tutorial_tpu_torch.obs.metrics import speculative_accept_rate
    from cs744_pytorch_distributed_tutorial_tpu_torch.train.lm import LMTrainer

    argv = [arg for key, value in LM_WIDTH.items()
            for arg in (f"--{key.replace('_', '-')}", str(value))]
    argv += ["--global-batch-size", "16", "--use-rope", "--attention-impl", "flash",
             "--fused-xent", "--compute-dtype", "bfloat16", "--steps", str(SPEC_STEPS),
             "--num-seqs", str(16 * SPEC_STEPS), "--generate", str(SPEC_NEW), "--prompt-len",
             str(SPEC_PROMPT), "--speculative-k", str(SPEC_K), "--draft-layers", "1", "--json",
             "--device", "cuda"]
    layers = LM_WIDTH["num_layers"]
    want = {"flash_fwd_tc": (layers + 1) * SPEC_STEPS, "flash_dq_tc": (layers + 1) * SPEC_STEPS,
            "flash_dkv_tc": (layers + 1) * SPEC_STEPS, "fused_xent_fwd": 2 * SPEC_STEPS,
            "fused_xent_bwd": 2 * SPEC_STEPS}
    out: dict = {"card": card_line()}
    for label, temp in (("greedy", "0"), ("temperature_0.8", "0.8")):
        t0 = time.perf_counter()
        with captured_lm_trainers() as trainers:
            summary, counts = counted(lambda: run_cli([*argv, "--temperature", temp],
                                                      main=lm_cli.main))
        wall = time.perf_counter() - t0
        detail = kernel_detail()
        g = summary["generation"]
        toks = torch.tensor(g["tokens"])
        in_range = bool(((toks >= 0) & (toks < LM_WIDTH["vocab_size"])).all())
        if (detail != want or others(counts, "flash", "fused_xent") or not in_range
                or toks.shape != (1, SPEC_NEW)
                or not -(-(SPEC_NEW - 1) // (SPEC_K + 1)) <= g["target_calls"] < SPEC_NEW):
            raise RuntimeError(f"speculative {label}: launches {detail} (all {counts}), expected "
                               f"{want}; generation {dict(g, tokens=None)}")
        rec = {k: g[k] for k in ("target_calls", "accept_rate", "tokens_per_s", "prefill_ms",
                                 "decode_ms_per_step")}
        rec.update(wall_s=wall, launches=detail, final_loss=summary["final_loss"])
        if label == "greedy":
            target = trainers[0]  # fit runs the target first, then the draft
            model = target.decode_model()
            # lm_cli's prompt: the first training sequence's prefix.
            data = synthetic_tokens(16 * SPEC_STEPS, LM_WIDTH["seq_len"], LM_WIDTH["vocab_size"],
                                    seed=0)
            prompt = torch.from_numpy(data[:1, :SPEC_PROMPT]).long().cuda()
            plain = make_generator(model, max_new_tokens=SPEC_NEW, temperature=0.0)
            want_toks = plain(prompt).cpu()
            t = plain.timing
            rec["plain_greedy_tokens_per_s"] = SPEC_NEW / (t["prefill_s"] + t["decode_s"])
            rec["tokens_agreeing_with_plain_greedy"] = int((want_toks == toks).sum())
            # The target as its own draft, fp32, TF32 off (set in main).
            fp32 = LMTrainer(target.cfg.replace(compute_dtype="float32")).decode_model(
                target.model.state_dict())
            spec = make_speculative_generator(fp32, fp32, max_new_tokens=SPEC_NEW, k=SPEC_K,
                                              return_stats=True)
            self_toks, calls = spec(prompt)
            self_want = make_generator(fp32, max_new_tokens=SPEC_NEW, temperature=0.0)(prompt)
            # Every round accepting all k: ceil((N - 1) / (k + 1)) calls (the
            # rate formula then reads below 1 by the last round's overshoot).
            rate = speculative_accept_rate(SPEC_NEW, calls, SPEC_K)
            all_accepted = calls == -(-(SPEC_NEW - 1) // (SPEC_K + 1))
            line = (f"speculative fp32 self-draft: {calls} target calls (every round accepted "
                    f"all {SPEC_K}: {all_accepted}), accept rate {rate}, equal to plain greedy "
                    f"{torch.equal(self_toks, self_want)}")
            print(line)
            if not (torch.equal(self_toks, self_want) and all_accepted):
                raise RuntimeError(line)
            rec.update(fp32_self_draft_target_calls=calls, fp32_self_draft_accept_rate=rate)
            del model, fp32, spec
        del trainers
        torch.cuda.empty_cache()
        out[label] = rec
        print(f"speculative {label}: {rec}")
    print(json.dumps({"speculative": out}))
    return out

# ----------------------------------------------------------- the LM across ranks
RANK_STEPS, RANK_SNAPSHOT = 4, 3  # steps a run; parameters compared after this many
RANK_LR = 1e-3
RANK_COLLECTIVES = ("reduce_scatter_tensor", "all_gather_into_tensor", "all_reduce",
                    "all_to_all_single", "all_gather")
RANK_INT8_LOSS_RTOL = 0.02  # the int8 wire's short-run bar (tests' INT8_TOL)
RANK_MODES = {  # label: (flags, yardstick label or None, MoE model)
    "adamw": ((), None, False),
    "zero1": (("--zero1",), "adamw", False),
    "zero1 overlap": (("--zero1", "--sync-overlap", "bucket"), "adamw", False),
    "fsdp": (("--fsdp",), "adamw", False),
    "fsdp overlap": (("--fsdp", "--sync-overlap", "bucket"), "adamw", False),
    "adamw clip warmup_cosine": (("--grad-clip-norm", "1.0", "--lr-schedule", "warmup_cosine",
                                  "--warmup-steps", "1"), None, False),
    "zero1 clip warmup_cosine": (("--zero1", "--grad-clip-norm", "1.0", "--lr-schedule",
                                  "warmup_cosine", "--warmup-steps", "1"),
                                 "adamw clip warmup_cosine", False),
    "sgd": (("--optimizer", "sgd"), None, False),
    "sgd overlap": (("--optimizer", "sgd", "--sync-overlap", "bucket"), "sgd", False),
    "int8": (("--grad-compress", "int8"), "adamw", False),
    "sgd int8 overlap": (("--optimizer", "sgd", "--grad-compress", "int8", "--sync-overlap",
                          "bucket+int8"), "sgd", False),
    "zero1 int8 overlap": (("--zero1", "--grad-compress", "int8", "--sync-overlap",
                            "bucket+int8"), "adamw", False),
    "moe adamw": ((), None, True),
    "moe fsdp": (("--fsdp",), "moe adamw", True),
}


def rank_argv(flags: tuple[str, ...], moe: bool) -> list[str]:
    """``lm_cli`` flags of a phase-27 run: RANK_STEPS steps and one held-out
    eval batch, NCCL at a world of one."""
    if moe:
        argv = moe_train_argv("dropless", RANK_STEPS)
    else:
        argv = [arg for key, value in LM_WIDTH.items()
                for arg in (f"--{key.replace('_', '-')}", str(value))]
        argv += ["--global-batch-size", "16", "--use-rope", "--attention-impl", "flash",
                 "--fused-xent", "--compute-dtype", "bfloat16", "--optimizer", "adamw",
                 "--steps", str(RANK_STEPS), "--num-seqs", str(16 * (RANK_STEPS + 1)),
                 "--eval-frac", "0.2", "--json", "--device", "cuda"]
    return argv + ["--lr", str(RANK_LR), "--num-processes", "1", *flags]


@contextlib.contextmanager
def timed_lm_trainers():
    """Patch the port's LMTrainer: each instance ``fit`` runs on is
    recorded with CUDA events around every ``train_step`` and a copy of
    its optimizer's parameters (flat) after RANK_SNAPSHOT steps."""
    from cs744_pytorch_distributed_tutorial_tpu_torch.train import lm as L

    runs: list[dict] = []
    fit, train_step = L.LMTrainer.fit, L.LMTrainer.train_step

    def recording_fit(self, *args, **kwargs):
        runs.append({"trainer": self, "events": [], "snapshot": None})
        return fit(self, *args, **kwargs)

    def timed_step(self, x, y, *args, **kwargs):
        run = runs[-1]
        ev = [torch.cuda.Event(enable_timing=True) for _ in range(2)]
        ev[0].record()
        m = train_step(self, x, y, *args, **kwargs)
        ev[1].record()
        run["events"].append(ev)
        if len(run["events"]) == RANK_SNAPSHOT:
            run["snapshot"] = [p.detach().reshape(-1).clone() for p in self.optimizer.params]
        return m

    with patched(L.LMTrainer, fit=recording_fit, train_step=timed_step):
        yield runs


def fused_sgd_launches(numels: list[int]) -> int:
    """Launches of one ``fused_sgd_multi_`` call over tensors of
    ``numels`` elements: the C entry's packing (``csrc/fused_sgd.cu``: up
    to 64 segments and 640 chunks of 32K elements a launch)."""
    chunk, max_segs, max_blocks = 32768, 64, 640
    launches = segs = blocks = 0
    for n in numels:
        left = -(-n // chunk)
        while left:
            if segs == max_segs or blocks == max_blocks:
                launches, segs, blocks = launches + 1, 0, 0
            take = min(left, max_blocks - blocks)
            segs, blocks, left = segs + 1, blocks + take, left - take
    return launches + (blocks > 0)


def rank_expectations(tr, label: str, flags: tuple[str, ...], moe: bool) -> tuple[dict, dict]:
    """(collective calls, kernel launches) a run of ``label`` must make at a
    world of one: the port's zero1/fsdp collective schedules (the JAX
    ``*_collective_schedule`` shape) of its own unit count, as copies;
    per-tensor all-reduces on the plain path (bucketed only above one
    rank), a bucket's on the overlapped one; one all-reduce a step and an
    eval batch for the world-mean metrics, one more a step for the clip's
    norm; the int8 wire's quantize round trip runs without its collectives
    at one rank (``sync._int8_allreduce_flat`` returns there), zero1's
    int8 lane keeps its delta all-gathers."""
    from cs744_pytorch_distributed_tutorial_tpu_torch.parallel import zero as Z

    s, e = RANK_STEPS, 1
    leaves = len(tr.optimizer.params)
    zero1, fsdp = "--zero1" in flags, "--fsdp" in flags
    overlap, int8 = "--sync-overlap" in flags, "int8" in flags
    units = tr.overlap.num_buckets if tr.overlap is not None else leaves
    coll = dict.fromkeys(RANK_COLLECTIVES, 0)
    coll["all_reduce"] = s + e + (s if (zero1 or fsdp) and "--grad-clip-norm" in flags else 0)
    if zero1 and int8:
        coll["all_gather_into_tensor"] = units * s
    elif zero1 or fsdp:
        sched = Z.zero1_collective_schedule(units, 2)  # a world above one's shape
        coll["reduce_scatter_tensor"] = sched["reduce_scatter"] * s
        coll["all_gather_into_tensor"] = sched["all_gather"] * (s + (e if fsdp else 0))
    elif overlap and not int8:
        coll["all_reduce"] += units * s
    elif not int8:
        coll["all_reduce"] += leaves * s
    layers = (MOE_WIDTH if moe else LM_WIDTH)["num_layers"]
    launches = {"flash_fwd_tc": layers * (s + e), "flash_dq_tc": layers * s,
                "flash_dkv_tc": layers * s}
    if moe:
        launches.update({"gmm_fused_tc": layers * (s + 2 * e), "gmm_fused_z_tc": layers * s,
                         "gmm_gmm_tc": 2 * layers * s, "gmm_tgmm_tc": 2 * layers * s,
                         "gmm_split": layers * s, "gmm_colsum": 2 * layers * s})
    else:
        launches.update({"fused_xent_fwd": s, "fused_xent_bwd": s})
    if overlap and not (zero1 or fsdp):  # one call a bucket: a launch, two past 640 chunks
        launches["fused_sgd"] = s * sum(
            fused_sgd_launches([tr.optimizer.params[i].numel() for i in members])
            for members in tr.overlap.members)
    return coll, launches


def lm_ranks_phase() -> dict:
    """Phase 27: the LM across ranks on the card, at a world of one on NCCL
    (NCCL refuses two ranks on one card, so world > 1 rests on the Gloo
    tests against JAX). Each of RANK_MODES through ``lm_cli``: its
    collectives and launches exact (``rank_expectations``), its step ms
    (CUDA events, the steps after the first) and peak memory above what
    was allocated before it beside its yardstick's, and its losses and
    parameters after RANK_SNAPSHOT steps against the yardstick's: bitwise
    where the arithmetic is the same (zero1, fsdp, their overlapped lanes
    and the clip: the sharded rules are the replicated optimizer's
    multi-tensor ops on rows; sgd overlapped: the fused-SGD kernel rounds
    as the plain update; fsdp's MoE), else (the int8 wire) losses within
    RANK_INT8_LOSS_RTOL and parameters within 2 lr a step. Then
    ``profile_lm_phases`` on the all-reduce path in a process group of
    one: its sync segment present and on the device clock."""
    from cs744_pytorch_distributed_tutorial_tpu_torch import lm_cli
    from cs744_pytorch_distributed_tutorial_tpu_torch.data import synthetic_tokens
    from cs744_pytorch_distributed_tutorial_tpu_torch.obs import phases as P
    from cs744_pytorch_distributed_tutorial_tpu_torch.parallel import mesh
    from cs744_pytorch_distributed_tutorial_tpu_torch.train.lm import LMTrainer

    card = card_line()
    out: dict = {"card": card}
    keep: dict = {}
    for label, (flags, yard, moe) in RANK_MODES.items():
        torch.cuda.synchronize()
        before = torch.cuda.memory_allocated()
        torch.cuda.reset_peak_memory_stats()
        with timed_lm_trainers() as runs, counted_collectives(RANK_COLLECTIVES) as coll:
            summary, all_counts = counted(lambda: run_cli(rank_argv(flags, moe),
                                                          main=lm_cli.main))
        peak = (torch.cuda.max_memory_allocated() - before) / 1e9
        launches = kernel_detail()
        if all_counts["fused_sgd"]:
            launches["fused_sgd"] = all_counts["fused_sgd"]
        (run,) = runs
        tr = run["trainer"]
        want_coll, want_launches = rank_expectations(tr, label, flags, moe)
        if dict(coll) != want_coll or launches != want_launches or others(
                all_counts, "flash", "fused_xent", "fused_sgd", "gmm_fused"):
            raise RuntimeError(f"LM ranks {label}: collectives {dict(coll)} (expected "
                               f"{want_coll}), launches {launches} (expected {want_launches}), "
                               f"all {all_counts}")
        if summary["mesh"]["data"] != 1 or summary["steps_run"] != RANK_STEPS or not (
                summary["finite"] and math.isfinite(summary["eval"]["loss"])):
            raise RuntimeError(f"LM ranks {label}: {summary}")
        times = [a.elapsed_time(b) for a, b in run["events"][1:]]
        ms = statistics.median(times)
        losses = [float(v) for v in tr.history["loss"]]
        rec = {"ms_per_step": ms, "peak_memory_gb": peak, "losses": losses,
               "collectives": dict(coll), "launches": launches}
        line = (f"LM ranks {label} ({card}): {ms:.3f} ms a step (median of steps 2-"
                f"{RANK_STEPS}), peak memory {peak:.3f} GB")
        if yard is not None:
            y = keep[yard]
            line += (f" (yardstick {yard}: {y['ms_per_step']:.3f} ms, "
                     f"{y['peak_memory_gb']:.3f} GB)")
            snap, ysnap = run["snapshot"], y["snapshot"]
            gap = max(float((a.double() - b.double()).abs().max())
                      for a, b in zip(snap, ysnap, strict=True))
            same = gap == 0.0 and losses[:RANK_SNAPSHOT] == y["losses"][:RANK_SNAPSHOT]
            loss_gap = max(abs(a - b) / abs(b) for a, b in zip(losses[:RANK_SNAPSHOT],
                                                                 y["losses"][:RANK_SNAPSHOT]))
            rec.update(bitwise=same, param_gap=gap, loss_gap=loss_gap)
            if "int8" in label:
                bound = 2 * RANK_LR * RANK_SNAPSHOT
                ok = loss_gap <= RANK_INT8_LOSS_RTOL and gap <= bound
                line += (f"; after {RANK_SNAPSHOT} steps vs {yard}: losses within "
                         f"{loss_gap:.3e} (bound {RANK_INT8_LOSS_RTOL}), parameters within "
                         f"{gap:.3e} (bound {bound})")
            else:
                ok = same
                line += f"; after {RANK_SNAPSHOT} steps bitwise {yard}'s: {same} (gap {gap})"
            if not ok:
                raise RuntimeError(line)
        line += (f"; collectives {dict(coll)}; launches {launches}; losses {losses}")
        print(line)
        out[label] = rec
        keep[label] = {**rec, "snapshot": run["snapshot"]}
        if yard is None and not any(m[1] == label for m in RANK_MODES.values()):
            keep.pop(label)
        del runs, run, tr
        torch.cuda.empty_cache()
    del keep
    torch.cuda.empty_cache()
    z, f = out["zero1"]["peak_memory_gb"], out["fsdp"]["peak_memory_gb"]
    print(f"LM ranks peak memory a rank ({card}): adamw {out['adamw']['peak_memory_gb']:.3f} "
          f"GB, zero1 {z:.3f} GB, fsdp {f:.3f} GB (fsdp - zero1 {f - z:+.3f} GB)")

    mesh.initialize(None, 1, 0, device=torch.device("cuda", 0))
    try:
        tr = LMTrainer(lm_config(fused_xent=True))
        tr.init()
        x, y = tr.split_batch(synthetic_tokens(16, LM_WIDTH["seq_len"], LM_WIDTH["vocab_size"],
                                               seed=0))
        segs = P.build_lm_segments(tr)
        report = P.profile_lm_phases(tr, x, y)
        sync = report.phase("grad_sync")
        print(report.table())
        if (segs.sync is None or not report.parity_ok or sync.clock not in P.DEVICE_CLOCKS
                or not sync.device_ms > 0 or report.n_chips != 1):
            raise RuntimeError(f"profile_lm_phases in a process group of one: sync "
                               f"{sync}, parity {report.parity_ok}")
        out["profile_lm_phases_world1"] = report.records()
        print(json.dumps({"profile_lm_phases_world1": report.records()}))
        del tr, segs, x, y
    finally:
        mesh.shutdown()
        torch.cuda.empty_cache()
    print(json.dumps({"lm_ranks": out}))
    return out


# ------------------------------------------------- the sequence axis's hops
SEQ_SHAPE = (2, 4096, 12, 64)  # B, T, H, D: GPT-2-small's heads, a 4,096-token sequence
SEQ_RANKS = 4
BF16_HALF_ULP = 2.0 ** -9  # bf16's rounding error, relative


def _flash_work(shape: tuple, causal: bool, kernel: str) -> tuple[float, float]:
    """(FLOPs, bytes) of one flash kernel call on [B, T, H, D] bf16, as
    the flash phase counts them."""
    b, t, h, d = shape
    pairs = b * h * (t * (t + 1) // 2 if causal else t * t)
    products, tensors, rows = {"fwd": (2, 4, 1), "dq": (3, 5, 2), "dkv": (4, 6, 2)}[kernel]
    return 2.0 * products * pairs * d, tensors * 2.0 * b * t * h * d + rows * 4.0 * b * h * t


def seq_tensor_phase(dev: torch.device) -> dict:
    """Phase 28: the ring flash attention's hop functions and Ulysses's
    inner calls on the flash kernels at a 4,096-token sequence on n = 4
    positions (no process group: the blocks go round in a ring's order in
    one process), against their plain versions and the whole-sequence
    kernels; launches by route, device ms beside the bounds."""
    from cs744_pytorch_distributed_tutorial_tpu_torch.ops import flash_attention as A
    from cs744_pytorch_distributed_tutorial_tpu_torch.parallel import collectives as C
    from cs744_pytorch_distributed_tutorial_tpu_torch.parallel import ring_attention as R

    t0 = time.perf_counter()
    card = card_line()
    n = SEQ_RANKS
    gen = torch.Generator(device=dev).manual_seed(28)
    q, k, v, g = (randn(gen, *SEQ_SHAPE, dtype=torch.bfloat16) for _ in range(4))
    bw, _ = card_rates(torch.cuda.get_device_name(0))
    out: dict = {"card": card, "launches": {}}

    def launches() -> dict:
        return {f"{kern}_{route}": A.launch_count(kern, route=route)
                for kern in A.KERNELS for route in A.ROUTES}

    def err(got, want) -> tuple[float, float]:
        got, want = got.detach().float(), want.detach().float()
        return float((got - want).abs().max()), float(want.abs().max())

    for causal in (True, False):
        label = "causal" if causal else "full"
        each = n * (n + 1) // 2 if causal else n * n
        A.reset_launch_count()
        C.hops.clear()
        ring_out, lse, grads = R.simulate_ring_flash(q, k, v, n, causal, g=g)
        torch.cuda.synchronize()
        got = launches()
        want_launches = {key: (each if key.endswith("_tc") else 0) for key in got}
        if got != want_launches or C.hops["seq"] != 2 * n - 1:
            raise RuntimeError(f"seq_tensor {label}: launches {got} (expected {want_launches}), "
                               f"hops {C.hops['seq']} (expected {2 * n - 1})")
        out["launches"][f"ring_flash_{label}"] = got
        with plain_flash():
            p_out, p_lse, p_grads = R.simulate_ring_flash(q, k, v, n, causal, g=g)
        # The whole sequence through the kernels, with the whole row statistics.
        w_out, w_lse = A.flash_forward_lse(q, k, v, causal)
        w_delta = A.flash_delta(w_out, g)
        w_dq = A.flash_dq(q, k, v, g, w_lse, w_delta, causal)
        w_dk, w_dv = A.flash_dkv(q, k, v, g, w_lse, w_delta, causal)
        torch.cuda.synchronize()
        rec: dict = {"plain": {}, "whole": {}}
        for name, got_t, plain_t, whole_t in (
                ("out", ring_out, p_out, w_out), ("dq", grads[0], p_grads[0], w_dq),
                ("dk", grads[1], p_grads[1], w_dk), ("dv", grads[2], p_grads[2], w_dv)):
            e, scale = err(got_t, plain_t)
            bound = FLASH_TOL[torch.bfloat16] * scale
            if not (math.isfinite(e) and e <= bound):
                raise RuntimeError(f"seq_tensor {label} {name}: hops on the kernels vs on the "
                                   f"plain versions {e} > {bound}")
            rec["plain"][name] = {"max_abs_err": e, "bound": bound, "share": e / bound}
            # Against the whole sequence: the ring rounds each hop's output
            # (the forward's to v.dtype before the merge; each hop's dq, dk,
            # dv to bf16 before the fp32 sums) and its result once more;
            # the whole-sequence kernel rounds once. A rounding is at most
            # half a bf16 ulp of its value. A forward hop's output is a
            # convex mix of V rows, so at most max|v|; a backward hop's is
            # taken as at most n times the whole sequence's largest
            # gradient. The bound is (hops + 2) half-ulps of that scale.
            e, scale = err(got_t, whole_t)
            if name == "out":
                scale, hops = max(scale, float(v.float().abs().max())), 1
            else:
                scale, hops = n * scale, n
            bound = (hops + 2) * BF16_HALF_ULP * scale
            if not (math.isfinite(e) and e <= bound):
                raise RuntimeError(f"seq_tensor {label} {name}: the ring vs the whole-sequence "
                                   f"kernels {e} > {bound}")
            rec["whole"][name] = {"max_abs_err": e, "bound": bound, "share": e / bound}
        e_lse = float((lse - w_lse).abs().max())
        if not e_lse <= 1e-3:
            raise RuntimeError(f"seq_tensor {label}: the ring's lse vs the whole's {e_lse}")
        rec["lse_max_abs_err"] = e_lse

        # Device time: the ring's kernels a pass (forward; backward alone,
        # from the forward's saved output and lse) beside the whole
        # sequence's, and each beside its bound.
        qs, ks, vs, gs = (list(x.chunk(n, dim=1)) for x in (q, k, v, g))
        outs, lses = list(ring_out.chunk(n, dim=1)), list(lse.chunk(n, dim=1))

        def ring_fwd():
            return R.simulate([R._rfa_forward_steps(qs[i], ks[i], vs[i], i, n, causal)
                               for i in range(n)])

        def ring_bwd():
            return R.simulate([R._rfa_backward_steps(qs[i], ks[i], vs[i], outs[i].contiguous(),
                                                     lses[i].contiguous(), gs[i].contiguous(), i,
                                                     n, causal) for i in range(n)])

        def whole_fwd():
            return A.flash_forward_lse(q, k, v, causal)

        def whole_bwd():
            return A.flash_dq(q, k, v, g, w_lse, w_delta, causal), A.flash_dkv(
                q, k, v, g, w_lse, w_delta, causal)

        blk = (SEQ_SHAPE[0], SEQ_SHAPE[1] // n, *SEQ_SHAPE[2:])
        timing = {}
        for key, fn, kernels, ring in (("ring_fwd", ring_fwd, ("fwd",), True),
                                       ("ring_bwd", ring_bwd, ("dq", "dkv"), True),
                                       ("whole_fwd", whole_fwd, ("fwd",), False),
                                       ("whole_bwd", whole_bwd, ("dq", "dkv"), False)):
            flop = nbytes = 0.0
            for kern in kernels:
                if ring:  # n diagonal hops (causal or not), the others unmasked
                    for diag, count in ((causal, n), (False, each - n)):
                        f, b_ = _flash_work(blk, diag, kern)
                        flop, nbytes = flop + count * f, nbytes + count * b_
                else:
                    f, b_ = _flash_work(SEQ_SHAPE, causal, kern)
                    flop, nbytes = flop + f, nbytes + b_
            bytes_ms, ops_ms = nbytes / bw * 1e3, flop / BF16_FLOPS * 1e3
            timing[key] = {
                "kernel_device_ms": device_busy_ms(fn, reps=5, match="flash_"),
                "all_device_ms": device_busy_ms(fn, reps=5),
                "bound_ms": max(bytes_ms, ops_ms),
                "bound_by": "bytes" if bytes_ms >= ops_ms else "operations",
                "gflop": flop / 1e9, "mbytes": nbytes / 1e6,
            }
        rec["timing"] = timing
        out[f"ring_flash_{label}"] = rec
        print(f"seq_tensor ring_flash {label} at B{SEQ_SHAPE[0]} T{SEQ_SHAPE[1]} H{SEQ_SHAPE[2]} "
              f"D{SEQ_SHAPE[3]} bf16 on {n} positions ({card}): launches {got}, hops "
              f"{2 * n - 1}; vs plain hops {rec['plain']}; vs the whole sequence "
              f"{rec['whole']}; lse {e_lse}; device ms {timing}")
        del ring_out, lse, grads, p_out, p_lse, p_grads, w_out, w_lse, w_dq, w_dk, w_dv

    # Ulysses's inner calls: 4 head groups of 3 heads over the whole sequence.
    for causal in (True, False):
        label = "causal" if causal else "full"
        qg, kg, vg = (x.detach().requires_grad_() for x in (q, k, v))
        A.reset_launch_count()
        u_out = R.simulate_ulysses(qg, kg, vg, n, causal, "flash")
        u_grads = torch.autograd.grad(u_out, (qg, kg, vg), g)
        torch.cuda.synchronize()
        got = launches()
        want_launches = {key: (n if key.endswith("_tc") else 0) for key in got}
        if got != want_launches:
            raise RuntimeError(f"seq_tensor ulysses {label}: launches {got} (expected "
                               f"{want_launches})")
        out["launches"][f"ulysses_flash_{label}"] = got
        with plain_flash():
            p_out = R.simulate_ulysses(qg, kg, vg, n, causal, "flash")
            p_grads = torch.autograd.grad(p_out, (qg, kg, vg), g)
        w_out = A.flash_attention(qg, kg, vg, causal)
        w_grads = torch.autograd.grad(w_out, (qg, kg, vg), g)
        rec = {}
        for name, a, b_, w in (("out", u_out, p_out, w_out),
                               *zip(("dq", "dk", "dv"), u_grads, p_grads, w_grads)):
            e, scale = err(a, b_)
            bound = FLASH_TOL[torch.bfloat16] * scale
            if not (math.isfinite(e) and e <= bound):
                raise RuntimeError(f"seq_tensor ulysses {label} {name}: {e} > {bound}")
            rec[name] = {"max_abs_err": e, "bound": bound, "share": e / bound,
                         "bitwise_whole_sequence": bool(torch.equal(a, w))}
        out[f"ulysses_flash_{label}"] = rec
        print(f"seq_tensor ulysses_flash {label} ({n} head groups of {SEQ_SHAPE[2] // n} heads, "
              f"{card}): launches {got}; vs plain {rec}")
        del qg, kg, vg, u_out, u_grads, p_out, p_grads, w_out, w_grads
    torch.cuda.empty_cache()
    out["seconds"] = time.perf_counter() - t0
    print(f"seq_tensor phase: {out['seconds']:.1f} s")
    print(json.dumps({"seq_tensor": out}))
    return out


TP_RANKS = 4
# Phase 29's bound on the first decode step's logits, the tensor ranks
# against one rank on the whole weights: max |difference| <= this x
# max|logit|. The ranks round each partial product of attn_out and mlp_out
# to bf16 and sum the four in bf16, where one rank rounds once: about one
# bf16 ulp (2^-8 relative) a sublayer, 24 sublayers in a random walk, on
# the residual stream the head reads; 5e-2 holds that with room, and a
# wrong head or slice gives O(1).
TP_LOGIT_BOUND = 5e-2
TP_SCRIPT = "scripts/tp_serve_ranks.py"


def _load_script(path: str):
    import importlib.util

    spec = importlib.util.spec_from_file_location(path.rsplit("/", 1)[-1][:-3], path)
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


def _agreement(got: list, want: list) -> dict:
    """How far two lists of token streams agree: the share of equal tokens
    and each stream's first differing index (None where equal)."""
    same = sum(a == b for g, w in zip(got, want) for a, b in zip(g, w))
    total = sum(len(w) for w in want)
    first = [next((i for i, (a, b) in enumerate(zip(g, w)) if a != b), None)
             for g, w in zip(got, want)]
    diverged = [i for i in first if i is not None]
    return {"equal_tokens": same, "tokens": total, "share": same / total,
            "streams_diverged": len(diverged), "streams": len(want),
            "first_divergence": min(diverged) if diverged else None}


def tp_serving_phase() -> dict:
    """Phase 29: tensor-parallel decode and serving at GPT-2-small's decode
    width, tensor 4: four rank processes (``scripts/tp_serve_ranks.py
    --mode smoke``) on this card, each with its own slices and pools,
    joined through shared memory (NCCL refuses two ranks on one card),
    while this process runs the same on one rank with the whole weights. Each rank's pools
    [513, 16, 1, 64], its paged launches exact and no plain call, the ranks'
    tokens identical, the first decode step's logits within
    ``TP_LOGIT_BOUND`` of the one rank's, the greedy agreement reported."""
    import os
    import shutil

    from cs744_pytorch_distributed_tutorial_tpu_torch.parallel.mesh import free_port

    t0 = time.perf_counter()
    card = card_line()
    root = os.path.dirname(os.path.abspath(__file__))
    script = os.path.join(root, TP_SCRIPT)
    TS = _load_script(script)
    out = os.path.join(root, "build", "tp_serving")
    shutil.rmtree(out, ignore_errors=True)
    os.makedirs(out)
    port = free_port()
    logs = [open(os.path.join(out, f"rank{r}.log"), "w") for r in range(TP_RANKS)]
    procs = [subprocess.Popen([sys.executable, script, "--mode", "smoke", "--rank", str(r),
                               "--world", str(TP_RANKS), "--port", str(port), "--out", out],
                              stdout=logs[r], stderr=subprocess.STDOUT)
             for r in range(TP_RANKS)]
    try:  # the ranks run while this process runs the one-rank reference
        ref = TS.reference()
        t_ref = time.perf_counter() - t0
        rcs = [p.wait(timeout=600) for p in procs]
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
        for f in logs:
            f.close()
    if any(rcs):
        tails = [open(os.path.join(out, f"rank{r}.log")).read()[-3000:] for r in range(TP_RANKS)]
        raise RuntimeError(f"tp_serving: rank exit codes {rcs}\n" + "\n".join(tails))
    ranks = [torch.load(os.path.join(out, f"rank{r}.pt"), weights_only=False)
             for r in range(TP_RANKS)]
    layers = TS.DECODE_WIDTH["num_layers"]
    kv = TS.DECODE_WIDTH["num_kv_heads"] // TP_RANKS
    head_dim = TS.DECODE_WIDTH["d_model"] // TS.DECODE_WIDTH["num_heads"]
    pages, ps = TS.SERVE_GEOMETRY["num_pages"], TS.SERVE_GEOMETRY["page_size"]
    rec: dict = {"card": card, "launches": {}, "runs": {},
                 "rank_build_seconds": [res["build_seconds"] for res in ranks],
                 "one_rank_build_seconds": ref["build_seconds"],
                 "sum_ms": [res["sum_ms"] for res in ranks]}
    failures = []
    for run in ("bfloat16", "int8"):
        for r, res in enumerate(ranks):
            got = res[run]
            steps = got["stats"]["decode_steps_all"]
            want = 2 * layers * steps  # the spans and the merge, a layer a step
            if got["launches"] != want or got["plain_calls"] != 0:
                failures.append(f"{run} rank {r}: paged launches {got['launches']}, plain calls "
                                f"{got['plain_calls']}; expected {want} ({steps} steps)")
            scale_shape = [pages, ps, kv] if run == "int8" else None
            if (got["pool_shape"] != [pages, ps, kv, head_dim]
                    or got["pool_dtype"] != f"torch.{run}" or got["scale_shape"] != scale_shape
                    or not got["pools_contiguous"]):
                failures.append(f"{run} rank {r}: pools {got['pool_shape']} {got['pool_dtype']} "
                                f"scales {got['scale_shape']}")
            if got["streams"] != ranks[0][run]["streams"]:
                failures.append(f"{run}: rank {r}'s tokens differ from rank 0's")
            if not torch.equal(got["first_logits"], ranks[0][run]["first_logits"]):
                failures.append(f"{run}: rank {r}'s logits differ from rank 0's")
        # The first decode step's logits on the slots both engines fed the
        # same token (a bf16 near-tie at a prefill can pick another first
        # token, and that slot's logits then answer another input).
        mine, one = ranks[0][run], ref[run]
        fed = [i for i, (a, b) in enumerate(zip(mine["streams"], one["streams"])) if a[0] == b[0]]
        diff = (mine["first_logits"] - one["first_logits"])[fed]
        err = float(diff.abs().max()) if fed else math.inf
        scale = float(one["first_logits"][fed].abs().max()) if fed else 0.0
        if not (math.isfinite(err) and err <= TP_LOGIT_BOUND * scale):
            failures.append(f"{run}: first decode step's logits {err} from one rank's > "
                            f"{TP_LOGIT_BOUND} x {scale} (slots {fed})")
        rec["launches"][run] = [res[run]["launches"] for res in ranks]
        rec["runs"][run] = {
            "decode_steps": mine["stats"]["decode_steps_all"],
            "logits_slots_compared": len(fed), "logits_max_abs_err": err,
            "logits_bound": TP_LOGIT_BOUND * scale,
            "logits_share": err / (TP_LOGIT_BOUND * scale) if scale else None,
            "greedy_vs_one_rank": _agreement(mine["streams"], one["streams"]),
            "one_rank_decode_steps": one["stats"]["decode_steps_all"],
            "decode_ms_per_step": mine["stats"]["decode_ms_per_step"],
            "one_rank_decode_ms_per_step": one["stats"]["decode_ms_per_step"],
            "seconds": [res[run]["seconds"] for res in ranks], "one_rank_seconds": one["seconds"],
        }
    for key in ("generate", "beam", "beam_scores"):
        for r, res in enumerate(ranks):
            if not torch.equal(res[key], ranks[0][key]):
                failures.append(f"{key}: rank {r} differs from rank 0")
    beam_err = float((ranks[0]["beam_scores"] - ref["beam_scores"]).abs().max())
    rec["generate"] = {"greedy_vs_one_rank": _agreement(ranks[0]["generate"].tolist(),
                                                        ref["generate"].tolist()),
                       "timing": ranks[0]["generate_timing"],
                       "one_rank_timing": ref["generate_timing"]}
    rec["beam"] = {"tokens_vs_one_rank": _agreement(ranks[0]["beam"].tolist(),
                                                    ref["beam"].tolist()),
                   "scores_max_abs_diff": beam_err, "timing": ranks[0]["beam_timing"],
                   "one_rank_timing": ref["beam_timing"]}
    rec["decoder_seconds"] = [res["seconds"] for res in ranks]
    rec["one_rank_seconds"] = t_ref
    rec["seconds"] = time.perf_counter() - t0
    for run, r in rec["runs"].items():
        print(f"tp_serving {run} pools at tensor {TP_RANKS} ({card}): {r['decode_steps']} decode "
              f"steps, paged launches a rank {rec['launches'][run]} (2 x {layers} a step); "
              f"first decode step's logits {r['logits_max_abs_err']:.5g} from one rank's on "
              f"{r['logits_slots_compared']} slots ({r['logits_share']} of the bound); greedy vs "
              f"one rank {r['greedy_vs_one_rank']}; host ms a decode step "
              f"{r['decode_ms_per_step']:.3f} (one rank {r['one_rank_decode_ms_per_step']:.3f}); "
              f"run seconds {r['seconds']} (one rank {r['one_rank_seconds']:.1f})")
    print(f"tp_serving generate (batch {TS.GEN['batch']}, prompt {TS.GEN['prompt']}, "
          f"{TS.GEN['new']} new) and beam ({TS.BEAM['batch']} x {TS.BEAM['beams']} beams, "
          f"{TS.BEAM['new']} new) at tensor {TP_RANKS}: {rec['generate']}; {rec['beam']}; "
          f"seconds {rec['decoder_seconds']}")
    print(f"tp_serving phase: {rec['seconds']:.1f} s (ranks' model builds "
          f"{rec['rank_build_seconds']} s; a sum of [16, 1, 768] bf16 over the 4 ranks "
          f"{rec['sum_ms']} ms of host; the one-rank reference {t_ref:.1f} s beside the ranks)")
    print(json.dumps({"tp_serving": rec}))
    if failures:
        raise RuntimeError("tp_serving: " + "; ".join(failures))
    return rec


# The ViT family on the CIFAR trainer: the JAX bench's runs
# (benchmarks/bench_vit_moe.py:96-106,124-129,337): bf16, flash, sync ring
# at a world of one, one batch of synthetic CIFAR trained on again and again,
# with the JAX bench's ViT training recipe (its vit_descends, :151-164: AdamW
# at lr 1e-3; the default SGD at lr 0.1 makes the loss climb).
VIT_RECIPE = dict(optimizer="adamw", learning_rate=1e-3)
VIT_RUNS = (("vit_tiny", 1024), ("vit_small", 512), ("vit_wide_p8", 1024))
VIT_DIMS = {"vit_tiny": ((192, 6, 768), 4), "vit_small": ((384, 8, 1536), 4),
            "vit_wide_p8": ((384, 6, 1536), 8)}  # (d, layers, d_ff), patch
VIT_WARMUP, VIT_TIMED_STEPS = 3, 10
VIT_CLI_STEPS = 8  # vit_tiny --dropout 0.1, dense, batch 256


def vit_flops_per_sample(d: int, layers: int, d_ff: int, n_tokens: int) -> float:
    """Training FLOPs a sample as benchmarks/bench_vit_moe.py:79-84 counts
    them: 3x the forward's q/k/v/o projections, MLP and full (not causal)
    attention products; the patch embedding and the head left out."""
    per_layer = n_tokens * (4 * d * d + 2 * d * d_ff) + 2 * n_tokens**2 * d
    return 3.0 * 2.0 * layers * per_layer


def vit_phase() -> dict:
    """The three ViTs through the CIFAR ``Trainer`` (``VIT_RUNS``,
    ``VIT_RECIPE``): warm-up
    steps, then ``VIT_TIMED_STEPS`` timed by CUDA events, every launch count
    zeroed just before and read just after: one tensor-core flash forward,
    dq and dk/dv a layer a step, no FFMA launch, no call of a plain flash
    version, no other kernel; the losses finite and falling; ms a step,
    samples/s and MFU (``vit_flops_per_sample`` over the dense BF16 peak);
    then a profile of 3 more steps: the device time a step by kernel and
    the flash kernels' share of it.
    Then ``vit_tiny --dropout 0.1`` (dense, no kernel) through ``cli.main``
    for ``VIT_CLI_STEPS`` steps."""
    from cs744_pytorch_distributed_tutorial_tpu_torch.config import TrainConfig
    from cs744_pytorch_distributed_tutorial_tpu_torch.data import synthetic_cifar10
    from cs744_pytorch_distributed_tutorial_tpu_torch.ops import flash_attention as A
    from cs744_pytorch_distributed_tutorial_tpu_torch.parallel import mesh
    from cs744_pytorch_distributed_tutorial_tpu_torch.train import Trainer

    dev = torch.device("cuda", 0)
    card = card_line()
    plain_calls = [0]

    def spy(fn):
        def call(*args, **kw):
            plain_calls[0] += 1
            return fn(*args, **kw)
        return call

    out: dict = {"launches": {}}
    steps = VIT_WARMUP + VIT_TIMED_STEPS
    mesh.initialize(None, 1, 0, device=dev)
    try:
        for model, batch in VIT_RUNS:
            (d, layers, d_ff), patch = VIT_DIMS[model]
            tr = Trainer(TrainConfig(model=model, sync="ring", num_devices=1,
                                     global_batch_size=batch, compute_dtype="bfloat16",
                                     synthetic_data=True, vit_attention="flash", device="cuda",
                                     **VIT_RECIPE))
            ds = synthetic_cifar10(batch, 16, seed=0)
            x = torch.from_numpy(ds.train_images).to(dev)
            y = torch.from_numpy(ds.train_labels.astype("int64")).to(dev)

            def run():
                losses = []
                start, end = (torch.cuda.Event(enable_timing=True) for _ in range(2))
                for i in range(steps):
                    if i == VIT_WARMUP:
                        start.record()
                    losses.append(tr.train_step(x, y))
                end.record()
                end.synchronize()
                return [float(v) for v in losses], start.elapsed_time(end) / VIT_TIMED_STEPS

            plain_calls[0] = 0
            with patched(A, flash_forward_lse_plain=spy(A.flash_forward_lse_plain),
                         flash_dq_plain=spy(A.flash_dq_plain),
                         flash_dkv_plain=spy(A.flash_dkv_plain)):
                (losses, ms), counts = counted(run)
            flash = flash_counts()
            want = {k: (layers * steps if k.endswith("_tc") else 0) for k in flash}
            if flash != want or others(counts, "flash") or plain_calls[0]:
                raise RuntimeError(f"ViT {model}: flash launches {flash} (expected {want}), "
                                   f"other kernels {others(counts, 'flash')}, plain flash calls "
                                   f"{plain_calls[0]}")
            tail = statistics.mean(losses[-3:])
            if not (all(math.isfinite(v) for v in losses) and tail < losses[0]):
                raise RuntimeError(f"ViT {model}: losses {losses} not finite or not falling")
            n_tokens = (32 // patch) ** 2 + 1
            flops = vit_flops_per_sample(d, layers, d_ff, n_tokens)
            sps = batch / (ms / 1e3)
            peak = torch.cuda.max_memory_allocated() / 1e9
            by_kernel = kernel_breakdown(lambda: tr.train_step(x, y), reps=3)
            busy = sum(by_kernel.values())
            flash_ms = sum(v for k, v in by_kernel.items() if "flash" in k)
            out[model] = {"batch": batch, "ms_per_step": ms, "samples_per_s": sps,
                          "mfu": sps * flops / BF16_FLOPS, "flops_per_sample": flops,
                          "tokens": n_tokens, "loss_first": losses[0], "loss_last3": tail,
                          "peak_memory_gb": peak, "device_busy_ms": busy,
                          "flash_ms": flash_ms, "flash_share": flash_ms / busy if busy else None,
                          "top_kernels_ms": dict(sorted(by_kernel.items(),
                                                        key=lambda kv: -kv[1])[:8])}
            out["launches"][model] = flash
            print(f"ViT {model} batch {batch} (T {n_tokens}, flash, bf16, ring): {ms:.3f} ms/step, "
                  f"{sps:.1f} samples/s, MFU {100 * out[model]['mfu']:.2f} % of "
                  f"{BF16_FLOPS / 1e12:.0f} TFLOP/s bf16 ({flops / 1e9:.4f} GFLOP/sample) on "
                  f"{card}; losses {losses[0]:.4f} -> {tail:.4f} (mean of the last 3); flash "
                  f"launches {flash}, no plain call; a step's kernels {busy:.3f} ms on the "
                  f"device, the flash kernels {flash_ms:.3f} ms of it "
                  + (f"({100 * flash_ms / busy:.1f} %)" if busy else "(no device trace)")
                  + f"; top kernels {json.dumps(out[model]['top_kernels_ms'])}")
            del tr, x, y
            torch.cuda.empty_cache()
            torch.cuda.reset_peak_memory_stats()
    finally:
        mesh.shutdown()

    argv = ["--part", "1", "--model", "vit_tiny", "--dropout", "0.1", "--synthetic-data",
            "--synthetic-train-size", str(256 * VIT_CLI_STEPS), "--synthetic-test-size", "256",
            "--global-batch-size", "256", "--log-every", "4", "--json"]
    summary, counts = counted(lambda: run_cli(argv))
    if (summary["steps"] != VIT_CLI_STEPS or not math.isfinite(summary["final_train_loss"])
            or others(counts)):
        raise RuntimeError(f"vit_tiny --dropout 0.1: {summary}, launches {others(counts)}")
    out["cli_dropout"] = summary
    print(f"cli vit_tiny --dropout 0.1 (dense): {summary['steps']} steps, final loss "
          f"{summary['final_train_loss']:.4f}, eval accuracy {summary['final_eval_accuracy']}")
    return out


# The grouped matmul past 64 experts at Qwen3-30B-A3B's published MoE widths
# (its config.json: hidden_size 2048, moe_intermediate_size 768,
# num_experts 128, num_experts_per_tok 8): 4,096 tokens x top-8 routes, bf16
# on the tensor cores, at E 65, 128 (Qwen3's) and 256 (DeepSeek-V3's); the
# FFMA route in fp32 at a reduced size. Every GROUPS_EMPTY_EVERY-th expert
# gets no route.
GROUPS_WIDTH = dict(d=2048, f=768, tokens=4096, top_k=8)
GROUPS_FFMA_WIDTH = dict(d=256, f=96, tokens=512, top_k=8)
GROUPS_EXPERTS = (65, 128, 256)
GROUPS_EMPTY_EVERY = 16
GROUPS_TIMED_E = 128


def gmm_groups_phase(dev: torch.device) -> dict:
    """Every grouped-matmul kernel past 64 experts against its plain
    version: the forward with gelu and ``z`` (w_in) and without (w_out),
    ``gmm`` of an fp32 dout against w_in read transposed (dlhs), ``tgmm``
    (drhs) and ``colsum`` (dbias), at each of ``GROUPS_EXPERTS``, group
    sizes from a top-8 draw of a random router with some experts empty:
    bf16 on the tensor cores at ``GROUPS_WIDTH``, fp32 on the FFMA kernels
    at ``GROUPS_FFMA_WIDTH``; each call under host synchronisation made an
    error, its launches exact; fp32 outputs within 1e-5 x max|plain|, bf16
    within one ulp of each plain value plus 1e-5 x max|plain| (the gmm
    backward phase's limits). Then the forward and dlhs times at E
    ``GROUPS_TIMED_E`` on the tensor cores. Returns, by kernel, the largest
    share of the limit and those times."""
    from cs744_pytorch_distributed_tutorial_tpu_torch.models.moe import MoEFFN
    from cs744_pytorch_distributed_tutorial_tpu_torch.ops import gmm as G

    gen = torch.Generator(device=dev).manual_seed(21)
    worst: dict = {}

    def check(name, got, want, label):
        diff = (got.float() - want.float()).abs()
        top = float(want.float().abs().max())
        if want.dtype == torch.float32:
            share = float(diff.max()) / (1e-5 * top)
        else:
            share = float((diff / (2**-7 * want.float().abs() + 1e-5 * top)).max())
        if got.dtype != want.dtype or got.shape != want.shape or not (
                math.isfinite(share) and share <= 1.0):
            raise RuntimeError(f"{name} disagrees with its plain version at {label}: max abs err "
                               f"{float(diff.max())}, {share} of the limit")
        worst[name] = max(worst.get(name, 0.0), share)

    def via(launches: dict, fn):
        G.reset_launch_count()
        res = quiet(fn)
        got = {k: G.launch_count(k) for k in G.KERNELS if G.launch_count(k)}
        if got != launches:
            raise RuntimeError(f"grouped matmul past 64 groups: launches {got}, expected "
                               f"{launches}")
        return res

    def draw(e, d, f, tokens, top_k, dtype):
        x = randn(gen, tokens, d)
        logits = x @ (randn(gen, d, e) / d**0.5)
        logits[:, ::GROUPS_EMPTY_EVERY] = -math.inf
        _, sizes, tok_ids = MoEFFN.group_by_expert(logits.topk(top_k, dim=-1).indices, e)
        lhs = x[tok_ids].to(dtype)
        w_in = (randn(gen, e, d, f) / d**0.5).to(dtype)
        w_out = (randn(gen, e, f, d) / f**0.5).to(dtype)
        b_in, b_out = 0.1 * randn(gen, e, f), 0.1 * randn(gen, e, d)
        return lhs, w_in, w_out, b_in, b_out, sizes

    times = {}
    for route, width, dtype in (("tc", GROUPS_WIDTH, torch.bfloat16),
                                ("ffma", GROUPS_FFMA_WIDTH, torch.float32)):
        sfx = "_tc" if route == "tc" else ""
        for e in GROUPS_EXPERTS:
            lhs, w_in, w_out, b_in, b_out, sizes = draw(e, **width, dtype=dtype)
            label = f"{route} E {e} {list(lhs.shape)}"
            empty = int((sizes == 0).sum())
            (h, z) = via({"fused_z" + sfx: 1},
                         lambda: G._fused(lhs, w_in, b_in, sizes, "gelu", None, True))
            want_h, want_z = G.grouped_matmul_fused_plain(lhs, w_in, b_in, sizes,
                                                          activation="gelu", with_z=True)
            check("fused_z" + sfx, h, want_h, label)
            check("fused_z" + sfx, z, want_z, label)
            y = via({"fused" + sfx: 1}, lambda: G.grouped_matmul_fused(h, w_out, b_out, sizes))
            check("fused" + sfx, y, G.grouped_matmul_fused_plain(h, w_out, b_out, sizes), label)
            del want_h, want_z, y, z
            dz = randn(gen, lhs.shape[0], w_in.shape[2])
            pieces = {"gmm_tc": 1, "split": 1} if route == "tc" else {"gmm": 1}
            dlhs = via(pieces, lambda: G.gmm(dz, w_in, sizes, trans_rhs=True))
            check("gmm" + sfx, dlhs, G.grouped_matmul_plain(dz, w_in, sizes, trans_rhs=True),
                  label)
            del dlhs
            tgmm_launch = {"tgmm_tc": 1, "split": 1} if route == "tc" else {"tgmm": 1}
            drhs = via(tgmm_launch, lambda: G.tgmm(lhs, dz, sizes))
            check("tgmm" + sfx, drhs, G.tgmm_plain(lhs, dz, sizes), label)
            del drhs
            dbias = via({"colsum": 1}, lambda: G.segment_sum_rows(dz, sizes))
            check("colsum", dbias, G.segment_sum_rows_plain(dz, sizes), label)
            print(f"gmm groups {label}: {empty} empty experts, largest group "
                  f"{int(sizes.max())}; forward (z), forward, gmm, tgmm and colsum agree with "
                  f"their plain versions")
            if route == "tc" and e == GROUPS_TIMED_E:
                times["fused_tc"] = median_ms(
                    lambda: G.grouped_matmul_fused(lhs, w_in, b_in, sizes, activation="gelu"))
                times["gmm_tc"] = median_ms(lambda: G.gmm(dz, w_in, sizes, trans_rhs=True))
                print(f"gmm groups E {e} times on {card_line()}: forward (gelu) "
                      f"{times['fused_tc']:.4f} ms, dlhs gmm_tc (3 pieces, split included) "
                      f"{times['gmm_tc']:.4f} ms")
            del lhs, w_in, w_out, dz, h
            torch.cuda.empty_cache()
    print("gmm groups, largest share of the limit by kernel: "
          + json.dumps({k: round(v, 4) for k, v in worst.items()}))
    return {"share": worst, "ms_e128": times}


# ------------------------------------------- phase 32: training that survives
# losing a rank. Part 1, the supervisor on the card's host (CPU workers,
# Gloo): the coordinator killed at step 3, rank 2 a 100 ms straggler.
ELASTIC_DEMO = ("--steps", "6", "--kill", "3:0", "--slow", "2:100",
                "--collective-deadline-s", "6")
# Part 2: ResNet-18 written by 4 CPU ranks (part 2b, --sync-bn, fp32, no
# augmentation, global batch 16, 2 steps), restored on the card at a
# world of one and trained 10 steps at batch 256, --fast-conv
# --fused-optimizer.
ELASTIC_RESNET_WRITE = ("--part", "2b", "--model", "resnet18", "--sync-bn", "--no-augment",
                        "--synthetic-data", "--synthetic-train-size", "32",
                        "--synthetic-test-size", "16", "--global-batch-size", "16",
                        "--epochs", "1", "--device", "cpu")
ELASTIC_RESNET_RANKS, ELASTIC_RESNET_BATCH, ELASTIC_RESNET_STEPS = 4, 256, 10
# Part 3: GPT-2-small's width at 2 layers, AdamW, zero1: one step at T 128
# written by 3 CPU ranks (3 rows: the padding is not trivial), re-chunked
# onto the card (3 -> 1) and trained 4 steps at 16 x T 1024, bf16, flash,
# the fused cross-entropy.
ELASTIC_LM_LAYERS, ELASTIC_LM_RANKS = 2, 3
ELASTIC_LM_WRITE = ("--num-layers", str(ELASTIC_LM_LAYERS), "--d-model", "768",
                    "--num-heads", "12", "--d-ff", "3072", "--vocab-size", "50304",
                    "--max-seq-len", "1024", "--seq-len", "128", "--use-rope",
                    "--attention-impl", "dense", "--optimizer", "adamw", "--zero1",
                    "--global-batch-size", "3", "--steps", "1", "--num-seqs", "3",
                    "--eval-frac", "0", "--device", "cpu")
ELASTIC_LM_BATCH, ELASTIC_LM_STEPS = 16, 4
# The card's losses from the other world's state against those from the
# world-1-written one: within ELASTIC_GAIN x the two CPU states' largest
# difference (parameters and optimizer state: the tensors a training loss
# depends on), and no tighter than 4x the card's own repeat gap (the
# world-1 state restored twice) or ELASTIC_REL_FLOOR x the largest loss
# (TF32 convolutions and bf16 LM steps round at ~1e-3 of their inputs).
# On an H100 the gaps measured 0.03x (ResNet-18) and 0.15x (the LM) the
# CPU states' difference; a restore that mixed up rows or dropped the
# momentum moves the loss by far more.
ELASTIC_GAIN, ELASTIC_REL_FLOOR = 10.0, 1e-4


def _elastic_cpu_jobs(root, repo: str) -> dict:
    """Start every CPU process of phase 32 at once: the two launcher runs
    (the kill and an uninterrupted run at 3 workers), the ResNet writers
    (4 ranks and a world of one) and the LM writers (3 ranks and a world
    of one). Returns name -> (Popen, log path)."""
    import os

    from cs744_pytorch_distributed_tutorial_tpu_torch.parallel.mesh import free_port

    env = dict(os.environ, CUDA_VISIBLE_DEVICES="", PYTHONPATH=repo)
    procs: dict = {}

    def start(name, argv, threads):
        log = root / f"{name}.log"
        procs[name] = (subprocess.Popen([sys.executable, "-m", *argv], stdout=open(log, "w"),
                                        stderr=subprocess.STDOUT, cwd=repo,
                                        env=dict(env, OMP_NUM_THREADS=str(threads))), log)

    pkg = "cs744_pytorch_distributed_tutorial_tpu_torch"
    start("lm_world1", [f"{pkg}.lm_cli", *ELASTIC_LM_WRITE, "--data-parallel", "1",
                        "--checkpoint-dir", str(root / "lm1")], 2)
    port = free_port()
    for r in range(ELASTIC_LM_RANKS):
        start(f"lm_rank{r}", [f"{pkg}.lm_cli", *ELASTIC_LM_WRITE,
                              "--data-parallel", str(ELASTIC_LM_RANKS),
                              "--checkpoint-dir", str(root / "lm3"),
                              "--coordinator", f"localhost:{port}",
                              "--num-processes", str(ELASTIC_LM_RANKS), "--process-id", str(r)], 1)
    start("kill", [f"{pkg}.launch", "--platform", "cpu", "--nprocs", "4",
                   "--store", str(root / "kill"), *ELASTIC_DEMO], 1)
    start("clean", [f"{pkg}.launch", "--platform", "cpu", "--nprocs", "3",
                    "--store", str(root / "clean"), "--steps", ELASTIC_DEMO[1]], 1)
    start("resnet_world1", [f"{pkg}.cli", *ELASTIC_RESNET_WRITE, "--num-devices", "1",
                            "--checkpoint-dir", str(root / "rn1")], 1)
    port = free_port()
    for r in range(ELASTIC_RESNET_RANKS):
        start(f"resnet_rank{r}", [f"{pkg}.cli", *ELASTIC_RESNET_WRITE,
                                  "--num-devices", str(ELASTIC_RESNET_RANKS),
                                  "--checkpoint-dir", str(root / "rn4"),
                                  "--coordinator", f"localhost:{port}",
                                  "--num-processes", str(ELASTIC_RESNET_RANKS),
                                  "--process-id", str(r)], 1)
    return procs


def _elastic_wait(procs: dict, names, timeout_s: float) -> float:
    """Wait for the named CPU processes; raise with a log's tail on a
    failure. Returns the seconds waited."""
    t0 = time.perf_counter()
    for name in names:
        proc, log = procs[name]
        try:
            rc = proc.wait(timeout=max(1.0, timeout_s - (time.perf_counter() - t0)))
        except subprocess.TimeoutExpired:
            rc = None
        if rc != 0:
            for other, _ in procs.values():
                if other.poll() is None:
                    other.kill()
            tail = "".join(open(log, encoding="utf-8", errors="replace").readlines()[-25:])
            raise RuntimeError(f"elastic: CPU process {name} ended {rc}:\n{tail}")
    return time.perf_counter() - t0


def _state_gap(a: dict, b: dict, keys) -> dict:
    """The largest absolute difference between two states' tensors, by
    collection."""
    gaps = {}
    for key in keys:
        va, vb = a[key], b[key]
        pairs = zip(va.values(), vb.values()) if isinstance(va, dict) else zip(va, vb)
        gaps[key] = max((float((x.float() - y.float()).abs().max())
                         for x, y in pairs if x.is_floating_point()), default=0.0)
    return gaps


def _elastic_card_runs(ckdirs: dict, build, steps, check, detail) -> dict:
    """For each checkpoint directory: a fresh trainer (``build()``),
    ``Checkpointer.restore_latest(adapt=trainer.elastic_state)``, the
    restored state checked (``check``), then ``steps(trainer)``'s losses.
    The first directory's run is counted (every launch count zeroed just
    before it and read after, ``detail()`` the counts by kernel and
    route); the world-1 directory runs twice (the card's repeat gap)."""
    from cs744_pytorch_distributed_tutorial_tpu_torch.utils.checkpoint import Checkpointer

    def run(ckdir, label):
        tr = build()
        ck = Checkpointer(str(ckdir))
        t0 = time.perf_counter()
        state = ck.restore_latest(adapt=tr.elastic_state)
        restore_ms[label] = (time.perf_counter() - t0) * 1e3
        read = ck.last_read
        ck.close()
        tr.restore_state(state)
        check(label, tr, state, read)
        return steps(tr), state

    restore_ms: dict = {}
    (other, other_state), counts = counted(lambda: run(ckdirs["other"], "other"))
    launches = detail()
    ref, ref_state = run(ckdirs["world1"], "world1")
    again, _ = run(ckdirs["world1"], "world1")
    return {"other": other, "world1": ref, "again": again, "counts": counts,
            "launches": launches, "other_state": other_state, "world1_state": ref_state,
            "restore_ms": restore_ms}


def _elastic_bound(label: str, runs: dict, gaps: dict) -> dict:
    cpu_gap = max(gaps.values())
    noise = max(abs(a - b) for a, b in zip(runs["world1"], runs["again"]))
    gap = max(abs(a - b) for a, b in zip(runs["other"], runs["world1"]))
    terms = {"gain x cpu gap": ELASTIC_GAIN * cpu_gap, "4 x repeat gap": 4 * noise,
             "rel floor": ELASTIC_REL_FLOOR * max(abs(v) for v in runs["world1"])}
    bound = max(terms.values())
    finite = all(math.isfinite(v) for v in runs["other"] + runs["world1"])
    print(f"elastic {label}: restore (every rank file read, re-cut, host tensors) "
          f"{runs['restore_ms']['other']:.1f} ms, the world-1 state's "
          f"{runs['restore_ms']['world1']:.1f} ms")
    print(f"elastic {label}: losses from the other world's state {runs['other']}, from the "
          f"world-1 state {runs['world1']} (again {runs['again']}); CPU states' largest "
          f"difference {json.dumps(gaps)}, card repeat gap {noise:.3e}; loss gap {gap:.3e} = "
          f"{gap / bound:.4f} of the bound {bound:.3e} ({max(terms, key=terms.get)}; "
          f"{json.dumps(terms)})")
    if not finite or gap > bound:
        raise RuntimeError(f"elastic {label}: loss gap {gap} over the bound {bound}")
    return {"losses": runs["other"], "reference": runs["world1"], "cpu_state_gap": gaps,
            "restore_ms": runs["restore_ms"],
            "repeat_gap": noise, "loss_gap": gap, "bound": bound, "bound_terms": terms,
            "share": gap / bound}


def elastic_phase() -> dict:
    """Phase 32: training that survives losing a rank, in three parts, the
    CPU processes of all three started together first.

    1. The port's ``launch`` on the card's host: 4 Gloo CPU workers, the
       coordinator SIGKILLed at step 3, rank 2 stalled 100 ms a step; exit
       0, two generations, generation 1's coordinator global rank 1,
       ``fleet_check`` clean, rank 2 the straggler the skew report names
       most, the stitched losses equal an uninterrupted 3-worker run's at
       rtol 1e-6; the seconds from the kill to the last survivor's exit
       and to generation 1's first step (``scripts/elastic_report.py``).
    2. ResNet-18 written by 4 CPU ranks restores on the card at a world of
       one (every rank file read; the BatchNorm buffers rank 0's bit for
       bit; parameters and momentum every file's) and trains
       ``ELASTIC_RESNET_STEPS`` steps at batch 256 with the fused SGD and
       the tensor-core wgrad (launches exact), its losses within the bound
       of the same steps from a world-1-written state.
    3. The LM (GPT-2-small's width, 2 layers, zero1) written by 3 CPU ranks
       restores on the card: AdamW's ``m`` and ``v`` the three files' rows
       concatenated, the padding dropped, bit for bit; 4 steps at 16 x
       T 1024, bf16, flash and the fused cross-entropy (launches exact),
       within the bound of the world-1-written state's."""
    import os
    import pathlib
    import tempfile

    from cs744_pytorch_distributed_tutorial_tpu_torch.config import TrainConfig
    from cs744_pytorch_distributed_tutorial_tpu_torch.data import (
        synthetic_cifar10,
        synthetic_tokens,
    )
    from cs744_pytorch_distributed_tutorial_tpu_torch.ops import fused_conv as C
    from cs744_pytorch_distributed_tutorial_tpu_torch.ops import fused_xent as FX
    from cs744_pytorch_distributed_tutorial_tpu_torch.parallel import mesh
    from cs744_pytorch_distributed_tutorial_tpu_torch.train import Trainer
    from cs744_pytorch_distributed_tutorial_tpu_torch.train.lm import LMTrainer
    from cs744_pytorch_distributed_tutorial_tpu_torch.utils.checkpoint import RankStates

    repo = os.path.dirname(os.path.abspath(__file__))
    report = _load_script(os.path.join(repo, "scripts", "elastic_report.py"))
    root = pathlib.Path(tempfile.mkdtemp(prefix="elastic_"))
    dev = torch.device("cuda", 0)
    card = card_line()
    out: dict = {"card": card}
    procs = _elastic_cpu_jobs(root, repo)
    mesh.initialize(None, 1, 0, device=dev)  # NCCL, a world of one
    try:
        # ---- part 2: ResNet-18 from 4 ranks onto the card
        ds = synthetic_cifar10(ELASTIC_RESNET_BATCH * ELASTIC_RESNET_STEPS, 16, seed=32)
        xs = torch.from_numpy(ds.train_images).to(dev).split(ELASTIC_RESNET_BATCH)
        ys = torch.from_numpy(ds.train_labels.astype("int64")).to(dev).split(
            ELASTIC_RESNET_BATCH)
        out["resnet_writers_s"] = _elastic_wait(
            procs, ["resnet_world1", *(f"resnet_rank{r}" for r in range(ELASTIC_RESNET_RANKS))],
            120)
        files = RankStates([str(root / "rn4" / "step_2" / f"rank{r}.pt")
                            for r in range(ELASTIC_RESNET_RANKS)])

        def resnet_check(label, tr, state, read):
            if label != "other":
                return
            if read != list(range(ELASTIC_RESNET_RANKS)):
                raise RuntimeError(f"elastic ResNet-18: read rank files {read}")
            for name, buf in tr.model.named_buffers():
                if not torch.equal(buf.cpu(), files[0]["buffers"][name]):
                    raise RuntimeError(f"elastic ResNet-18: buffer {name} is not rank 0's")
            for r in range(ELASTIC_RESNET_RANKS):
                for key, live in (("params", tr.state.params), ("momentum", tr.state.momentum)):
                    if not all(torch.equal(a.cpu(), b) for a, b in zip(live, files[r][key],
                                                                       strict=True)):
                        raise RuntimeError(f"elastic ResNet-18: {key} differ from rank {r}'s")

        def resnet_steps(tr):
            return [float(tr.train_step(x, y)) for x, y in zip(xs, ys)]

        cfg = TrainConfig(model="resnet18", sync="allreduce", sync_bn=True, augment=False,
                          num_devices=1, global_batch_size=ELASTIC_RESNET_BATCH,
                          fast_conv=True, fused_optimizer=True, synthetic_data=True,
                          device="cuda")
        runs = _elastic_card_runs(
            {"other": root / "rn4", "world1": root / "rn1"}, lambda: Trainer(cfg),
            resnet_steps, resnet_check, lambda: {"conv3x3_wgrad_s1_tc": C.launch_count(
                stride=1, route="tc"), "conv3x3_wgrad": C.launch_count()})
        counts = {"fused_sgd": runs["counts"]["fused_sgd"], **runs["launches"]}
        n = RESNET18_ROUTED * ELASTIC_RESNET_STEPS
        want = {"fused_sgd": ELASTIC_RESNET_STEPS, "conv3x3_wgrad_s1_tc": n, "conv3x3_wgrad": n}
        if counts != want or others(runs["counts"], "fused_sgd", "conv3x3_wgrad"):
            raise RuntimeError(f"elastic ResNet-18: launches {runs['counts']} / {counts}, "
                               f"expected {want}")
        counts.pop("conv3x3_wgrad")
        cpu_gap = _state_gap(files[0], RankStates([str(root / "rn1" / "step_2" / "rank0.pt")])[0],
                             ("params", "momentum"))
        out["resnet"] = dict(_elastic_bound("ResNet-18 4 -> 1", runs, cpu_gap), launches=counts)

        # ---- part 3: the LM's zero1 rows from 3 ranks onto the card
        toks = synthetic_tokens(ELASTIC_LM_BATCH * ELASTIC_LM_STEPS, LM_WIDTH["seq_len"],
                                LM_WIDTH["vocab_size"], seed=33)
        out["lm_writers_s"] = _elastic_wait(
            procs, ["lm_world1", *(f"lm_rank{r}" for r in range(ELASTIC_LM_RANKS))], 150)
        lm_files = RankStates([str(root / "lm3" / "step_1" / f"rank{r}.pt")
                               for r in range(ELASTIC_LM_RANKS)])

        def lm_check(label, tr, state, read):
            if label != "other":
                return
            if read != list(range(ELASTIC_LM_RANKS)):
                raise RuntimeError(f"elastic LM: read rank files {read}")
            for key in ("momentum", "opt_nu"):
                for i, p in enumerate(state["params"]):
                    rows = torch.cat([lm_files[r][key][i] for r in range(ELASTIC_LM_RANKS)])
                    pad = rows[p.numel():]
                    if not (torch.equal(state[key][i], rows[:p.numel()]) and not pad.any()):
                        raise RuntimeError(f"elastic LM: {key} {i} is not the rows "
                                           "concatenated, the padding dropped")
            if state["opt_count"] != 1 or state["step"] != 1:
                raise RuntimeError(f"elastic LM: restored step {state['step']}, count "
                                   f"{state['opt_count']}")

        def lm_steps(tr):
            return [float(tr.train_step(*tr.split_batch(
                toks[i * ELASTIC_LM_BATCH:(i + 1) * ELASTIC_LM_BATCH]))["loss"])
                for i in range(ELASTIC_LM_STEPS)]

        def lm_build():
            tr = LMTrainer(lm_config(num_layers=ELASTIC_LM_LAYERS, zero1=True, fused_xent=True,
                                     global_batch_size=ELASTIC_LM_BATCH))
            tr.init()
            return tr

        lm_runs = _elastic_card_runs(
            {"other": root / "lm3", "world1": root / "lm1"}, lm_build, lm_steps, lm_check,
            lambda: {**{f"flash_{k}": v for k, v in flash_counts().items()},
                     **{f"fused_xent_{k}": FX.launch_count(k, torch.float32)
                        for k in FX.KERNELS}})
        n = ELASTIC_LM_LAYERS * ELASTIC_LM_STEPS
        want = {"flash_fwd": 0, "flash_dq": 0, "flash_dkv": 0, "flash_fwd_tc": n,
                "flash_dq_tc": n, "flash_dkv_tc": n, "fused_xent_fwd": ELASTIC_LM_STEPS,
                "fused_xent_bwd": ELASTIC_LM_STEPS}
        if (lm_runs["launches"] != want or others(lm_runs["counts"], "flash", "fused_xent")
                or lm_runs["counts"]["fused_xent"] != 2 * ELASTIC_LM_STEPS):
            raise RuntimeError(f"elastic LM: launches {lm_runs['counts']} / "
                               f"{lm_runs['launches']}, expected {want}")
        lm_gap = _state_gap(lm_runs["other_state"], lm_runs["world1_state"],
                            ("params", "momentum", "opt_nu"))
        out["lm"] = dict(_elastic_bound("LM 3 -> 1", lm_runs, lm_gap),
                         launches={k: v for k, v in lm_runs["launches"].items() if v})
    finally:
        mesh.shutdown()

    # ---- part 1: the supervisor
    out["launch_wait_s"] = _elastic_wait(procs, ["kill", "clean"], 120)
    rep = report.summarize(str(root / "kill"), str(root / "clean"))
    (incident,) = rep["incidents"]
    checks = {
        "generations": rep["generations"] == [0, 1],
        "coordinator": rep["coordinators"].get(1) == 1,
        "fleet_check": rep["fleet_check"] == [],
        "straggler": rep["straggler"] == 2,
        "steps": rep["same_steps_as_clean"],
        "losses": rep["max_rel_gap_vs_clean"] is not None and rep["max_rel_gap_vs_clean"] <= 1e-6,
        "dead": incident["dead"] == [0] and incident["death_reasons"] == ["sigkill"],
    }
    out["launch"] = {k: rep[k] for k in ("generations", "coordinators", "stragglers",
                                         "max_skew_ms", "max_rel_gap_vs_clean")}
    out["launch"]["incident"] = {k: v for k, v in incident.items() if k != "survivors"}
    out["launch"]["survivors"] = {r: (s["ended_by"], s["s_after_kill"])
                                  for r, s in incident["survivors"].items()}
    print(f"elastic launch (CPU workers on {card}): " + json.dumps(out["launch"]))
    print(f"elastic launch: {incident['s_kill_to_last_survivor_exit']} s from the kill to the "
          f"last survivor's exit, {incident['s_kill_to_first_resumed_step']} s to generation "
          f"1's first step")
    if not all(checks.values()):
        raise RuntimeError(f"elastic launch: failed checks "
                           f"{[k for k, ok in checks.items() if not ok]}: {json.dumps(rep)}")
    return out


# -------------------------------------------------------- phase 33: the pipe axis
PIPE_STAGES, PIPE_MICROBATCHES, PIPE_MB_SEQS, PIPE_STEPS = 4, 4, 2, 2
PIPE_SCHEDULES = {"gpipe": {}, "1f1b": {}, "interleaved": {"num_virtual_stages": 3}}
# |pipe-4 loss - pipe-1 loss| / pipe-1 loss at each step, bf16: the flash
# phase's bf16 bound (FLASH_TOL), stated before the first run.
PIPE_LOSS_RTOL = 2e-2
# The MoE LM's grouped matmuls on the pipeline path: 2 stages, 2
# microbatches of 4 x 512, one GPipe step.
PIPE_MOE_STAGES, PIPE_MOE_MICROBATCHES, PIPE_MOE_BATCH = 2, 2, 8
HF_VOCAB = 50257  # GPT-2's own vocabulary
HF_LOGIT_TOL = 2e-2  # max |kernel - plain| / max |plain| of the logits, bf16


def _pipe_hops(schedule: str, v: int) -> int:
    """The pipe-axis hops a step: one a tick each way."""
    s, m = PIPE_STAGES, PIPE_MICROBATCHES
    return 2 * ((v * m if schedule == "interleaved" else m) + s - 1)


def gpt2_hf_state_dict(gen: torch.Generator) -> dict:
    """A GPT-2-small state dict with ``transformers``' key names (tied
    ``lm_head.weight``), N(0, 0.02) weights, unit norm scales and zero
    biases drawn from ``gen``: what ``GPT2LMHeadModel(GPT2Config())``
    holds, without the package."""
    d, layers, ff, n_pos = 768, 12, 3072, 1024
    randn = lambda *shape: torch.randn(shape, generator=gen, device=gen.device) * 0.02  # noqa
    sd = {"transformer.wte.weight": randn(HF_VOCAB, d), "transformer.wpe.weight": randn(n_pos, d)}
    for i in range(layers):
        pre = f"transformer.h.{i}"
        sd.update({
            f"{pre}.ln_1.weight": torch.ones(d, device=gen.device),
            f"{pre}.ln_1.bias": torch.zeros(d, device=gen.device),
            f"{pre}.attn.c_attn.weight": randn(d, 3 * d), f"{pre}.attn.c_attn.bias": randn(3 * d),
            f"{pre}.attn.c_proj.weight": randn(d, d), f"{pre}.attn.c_proj.bias": randn(d),
            f"{pre}.ln_2.weight": torch.ones(d, device=gen.device),
            f"{pre}.ln_2.bias": torch.zeros(d, device=gen.device),
            f"{pre}.mlp.c_fc.weight": randn(d, ff), f"{pre}.mlp.c_fc.bias": randn(ff),
            f"{pre}.mlp.c_proj.weight": randn(ff, d), f"{pre}.mlp.c_proj.bias": randn(d),
        })
    sd["transformer.ln_f.weight"] = torch.ones(d, device=gen.device)
    sd["transformer.ln_f.bias"] = torch.zeros(d, device=gen.device)
    sd["lm_head.weight"] = sd["transformer.wte.weight"]
    return sd


def pipeline_phase() -> dict:
    """Phase 33: GPT-2-small at full width (bf16, RoPE, flash, AdamW) on
    four pipeline stages run in lockstep in this process
    (``parallel/pipeline.py::simulate_train_step``), 4 microbatches of 2
    sequences, 2 steps on each schedule (GPipe, 1F1B with the distributed
    tail, interleaved V 3), from the weights of a pipe-1 ``LMTrainer``
    that trains the same 2 batches: each step's loss within
    ``PIPE_LOSS_RTOL`` of the pipe-1 one, the flash launches exact on the
    tensor cores (48 forwards, dq and dk/dv a step; 1F1B's recompute 48
    forwards more), none on FFMA, no plain call, the hops the schedule's;
    each schedule's step and the pipe-1 step timed (CUDA events and the
    profiler's kernel time). The MoE LM (dropless) on 2 stages, one GPipe
    step: its grouped-matmul launches exact. Then a GPT-2-small state
    dict with HF's key names through ``models/hf_interop.py``: one bf16
    forward on the flash kernels against the same model's plain path."""
    from cs744_pytorch_distributed_tutorial_tpu_torch.data import synthetic_tokens
    from cs744_pytorch_distributed_tutorial_tpu_torch.models import hf_interop as H
    from cs744_pytorch_distributed_tutorial_tpu_torch.models.transformer import TransformerLM
    from cs744_pytorch_distributed_tutorial_tpu_torch.ops import flash_attention as A
    from cs744_pytorch_distributed_tutorial_tpu_torch.ops import gmm as G
    from cs744_pytorch_distributed_tutorial_tpu_torch.parallel import collectives as Coll
    from cs744_pytorch_distributed_tutorial_tpu_torch.parallel import pipeline as PP
    from cs744_pytorch_distributed_tutorial_tpu_torch.train.lm import LMTrainer

    card = card_line()
    layers = LM_WIDTH["num_layers"]
    batch = PIPE_MICROBATCHES * PIPE_MB_SEQS
    toks = synthetic_tokens(batch * PIPE_STEPS, LM_WIDTH["seq_len"], LM_WIDTH["vocab_size"],
                            seed=23)
    plain_calls = [0]

    def spy(fn):
        def call(*args, **kw):
            plain_calls[0] += 1
            return fn(*args, **kw)
        return call

    def timed(step) -> tuple[float, float | None]:
        """(CUDA-event ms of one more step, the profiler's kernel ms a step)."""
        start, end = (torch.cuda.Event(enable_timing=True) for _ in range(2))
        start.record()
        step()
        end.record()
        end.synchronize()
        return start.elapsed_time(end), device_busy_ms(step, reps=1)

    ref = LMTrainer(lm_config(global_batch_size=batch))
    ref.init(seed=0)
    logical = PP.from_transformer_lm_params(
        {k: v.detach().clone() for k, v in ref.model.state_dict().items()}, layers)
    batches = [ref.split_batch(toks[s * batch:(s + 1) * batch]) for s in range(PIPE_STEPS)]
    want = [float(ref.train_step(*batches[s])["loss"]) for s in range(PIPE_STEPS)]
    ref_ms = timed(lambda: ref.train_step(*batches[0]))
    out: dict = {"card": card, "pipe1_losses": want, "pipe1_step_ms": ref_ms[0],
                 "pipe1_busy_ms": ref_ms[1], "launches": {}, "schedules": {}}
    del ref
    torch.cuda.empty_cache()
    for schedule, kw in PIPE_SCHEDULES.items():
        cfg = PP.PipelineLMConfig(**LM_WIDTH, pipeline_parallel=PIPE_STAGES,
                                  num_microbatches=PIPE_MICROBATCHES, global_batch_size=batch,
                                  schedule=schedule, attention_impl="flash", use_rope=True,
                                  compute_dtype="bfloat16", optimizer="adamw", device="cuda",
                                  **kw)
        stages = [PP.PipelineLMTrainer(cfg, stage=i) for i in range(PIPE_STAGES)]
        for tr in stages:
            tr.init(params=logical)

        def run():
            Coll.hops.clear()
            return [float(PP.simulate_train_step(stages, *batches[s])["loss"])
                    for s in range(PIPE_STEPS)]

        plain_calls[0] = 0
        with patched(A, flash_forward_lse_plain=spy(A.flash_forward_lse_plain),
                     flash_dq_plain=spy(A.flash_dq_plain), flash_dkv_plain=spy(A.flash_dkv_plain)):
            losses, counts = counted(run)
        hops = Coll.hops["pipe"]
        flash = flash_counts()
        fwd = layers * PIPE_MICROBATCHES * PIPE_STEPS
        want_flash = {"fwd": 0, "dq": 0, "dkv": 0, "fwd_tc": fwd * (2 if schedule == "1f1b" else 1),
                      "dq_tc": fwd, "dkv_tc": fwd}
        v = kw.get("num_virtual_stages", 1)
        if flash != want_flash or others(counts, "flash") or plain_calls[0] or (
                hops != _pipe_hops(schedule, v) * PIPE_STEPS):
            raise RuntimeError(f"pipeline {schedule}: flash launches {flash} (expected "
                               f"{want_flash}), other kernels {others(counts, 'flash')}, plain "
                               f"flash calls {plain_calls[0]}, hops {hops} (expected "
                               f"{_pipe_hops(schedule, v) * PIPE_STEPS})")
        gaps = [abs(a - b) / abs(b) for a, b in zip(losses, want)]
        if not all(math.isfinite(x) for x in losses) or max(gaps) > PIPE_LOSS_RTOL:
            raise RuntimeError(f"pipeline {schedule}: losses {losses} against pipe-1 {want} "
                               f"(relative gaps {gaps}, bound {PIPE_LOSS_RTOL})")
        ms = timed(lambda: PP.simulate_train_step(stages, *batches[0]))
        out["launches"][schedule] = flash
        out["schedules"][schedule] = {"losses": losses, "relative_gaps": gaps, "step_ms": ms[0],
                                      "busy_ms": ms[1], "hops_a_step": hops // PIPE_STEPS,
                                      "dist_tail": stages[0]._dist_tail}
        print(f"pipeline {schedule} (4 stages in one process, M {PIPE_MICROBATCHES}"
              f"{f', V {v}' if v > 1 else ''}): losses {losses} vs pipe-1 {want} (relative "
              f"{gaps}, bound {PIPE_LOSS_RTOL}); flash launches {flash}, no plain call; hops "
              f"{hops // PIPE_STEPS} a step; step {ms[0]:.1f} ms (events), kernels {ms[1]} ms, "
              f"pipe-1 step {ref_ms[0]:.1f} ms / kernels {ref_ms[1]} ms; {card}")
        del stages
        torch.cuda.empty_cache()

    # The MoE LM (dropless): the grouped matmuls on the pipeline path.
    moe_cfg = PP.PipelineLMConfig(
        **MOE_WIDTH, seq_len=MOE_WIDTH["max_seq_len"], pipeline_parallel=PIPE_MOE_STAGES,
        num_microbatches=PIPE_MOE_MICROBATCHES, global_batch_size=PIPE_MOE_BATCH,
        attention_impl="flash", use_rope=True, compute_dtype="bfloat16", moe_experts=MOE_EXPERTS,
        moe_top_k=MOE_TOP_K, moe_dispatch="dropless", device="cuda")
    moe_stages = [PP.PipelineLMTrainer(moe_cfg, stage=i) for i in range(PIPE_MOE_STAGES)]
    params = moe_stages[0].init_params(0)
    for tr in moe_stages:
        tr.init(params=params)
    moe_toks = synthetic_tokens(PIPE_MOE_BATCH, MOE_WIDTH["max_seq_len"], MOE_WIDTH["vocab_size"],
                                seed=29)
    moe_loss, counts = counted(lambda: float(PP.simulate_train_step(
        moe_stages, *moe_stages[0].split_batch(moe_toks))["loss"]))
    gmm = {k: G.launch_count(k) for k in G.KERNELS}
    units = MOE_WIDTH["num_layers"] * PIPE_MOE_MICROBATCHES
    want_gmm = {"fused": 0, "fused_z": 0, "fused_tc": units, "fused_z_tc": units, "gmm": 0,
                "tgmm": 0, "colsum": 2 * units, "gmm_tc": 2 * units, "tgmm_tc": 2 * units,
                "split": units}
    if gmm != want_gmm or others(counts, "gmm_fused", "flash") or not math.isfinite(moe_loss):
        raise RuntimeError(f"pipeline MoE: grouped-matmul launches {gmm} (expected {want_gmm}), "
                           f"all {counts}, loss {moe_loss}")
    out["moe"] = {"loss": moe_loss, "launches": gmm}
    print(f"pipeline MoE (dropless, 2 stages, GPipe, M {PIPE_MOE_MICROBATCHES}): loss {moe_loss}, "
          f"grouped-matmul launches {gmm}")
    del moe_stages
    torch.cuda.empty_cache()

    # HF's GPT-2 key names through hf_interop, one forward.
    gen = torch.Generator(device="cuda").manual_seed(31)
    sd = gpt2_hf_state_dict(gen)
    cfg = H.gpt2_model_config(sd)
    with torch.device("meta"):
        model = TransformerLM(**dict(cfg, attention_impl="flash", dtype="bfloat16"))
    model.load_state_dict(H.lm_state_dict_from_hf_gpt2(sd), assign=True)
    model = model.to("cuda")
    tokens = torch.randint(0, HF_VOCAB, (2, cfg["max_seq_len"]), generator=gen, device="cuda")
    with torch.no_grad():
        logits, counts = counted(lambda: model(tokens))
        with plain_flash():
            plain = model(tokens)
    flash = flash_counts()
    err = float((logits - plain).abs().max() / plain.abs().max())
    if flash["fwd_tc"] != 12 or flash["fwd"] or others(counts, "flash") or not (
            torch.isfinite(logits).all() and err <= HF_LOGIT_TOL):
        raise RuntimeError(f"HF GPT-2 import: flash launches {flash}, other {counts}, logit "
                           f"error {err} (bound {HF_LOGIT_TOL})")
    out["hf_gpt2"] = {"logit_err": err, "config": {k: v for k, v in cfg.items()
                                                   if k != "attention_impl"}}
    print(f"HF GPT-2-small import (hf_interop, {len(sd)} tensors, tied, eps 1e-5, biases): "
          f"logits [2, 1024, {HF_VOCAB}] on the flash kernels vs the plain path, max error "
          f"{err:.3e} x max|plain| (bound {HF_LOGIT_TOL}); flash launches {flash}; {card}")
    return out


# Phase 34: the analysis package. The port's linter over its package, then
# the trace and memory audits of one recorded step of each of the nine
# registered entries at the main path's widths (the CIFAR entries at
# ResNet-18 through the wgrad kernels, cifar with fused SGD; the LM
# entries at GPT-2-small through flash and fused_xent; lm-serve-paged at
# GPT-2-small through the paged kernel), gated against the card's section
# of analysis/memory_budget.json, which
#   python -m cs744_pytorch_distributed_tutorial_tpu_torch.analysis memory \
#       --device cuda --write-budget --budget <copy of the file>
# writes on the card.
ANALYSIS_ENTRIES = ("cifar", "cifar-int8", "cifar-overlap", "cifar-overlap-zero1",
                    "lm", "lm-overlap", "lm-overlap-fsdp", "lm-serve", "lm-serve-paged")


def _analysis_launches() -> dict:
    """The kernels' launch counts by the names of the kernels line."""
    from cs744_pytorch_distributed_tutorial_tpu_torch.ops import flash_attention as A
    from cs744_pytorch_distributed_tutorial_tpu_torch.ops import fused_conv as C
    from cs744_pytorch_distributed_tutorial_tpu_torch.ops import fused_sgd as K
    from cs744_pytorch_distributed_tutorial_tpu_torch.ops import fused_xent as FX
    from cs744_pytorch_distributed_tutorial_tpu_torch.ops import paged_attention as PA

    out = {"fused_sgd": K.launch_count(), "paged_attention": PA.launch_count()}
    for stride in (1, 2):
        for route in ("ffma", "tc"):
            out[f"conv3x3_wgrad_s{stride}" + ("_tc" if route == "tc" else "")] = C.launch_count(
                stride, route=route)
    for kern in ("fwd", "dq", "dkv"):
        out[f"flash_{kern}"] = A.launch_count(kern, route="ffma")
        out[f"flash_{kern}_tc"] = A.launch_count(kern, route="tc")
    for kern in ("fwd", "bwd"):
        out[f"fused_xent_{kern}"] = FX.launch_count(kern)
    return {k: n for k, n in out.items() if n}


def analysis_phase() -> dict:
    """The linter (exit 0 against the port's baseline), then each entry
    built on the card, its step recorded once and audited by every TA
    rule (``audits.run_audits`` with the trace and memory audits of one
    recording): findings, schedule, memory ledger and the kernels'
    launches printed a line an entry. Raises on any finding, on a kernel
    path that launched the wrong kernels, and (TA007) on a ledger past the
    card's section of ``analysis/memory_budget.json``."""
    import gc

    import torch.distributed as dist

    from cs744_pytorch_distributed_tutorial_tpu_torch.analysis.cli import main as lint_main
    from cs744_pytorch_distributed_tutorial_tpu_torch.analysis.trace import audits as TA
    from cs744_pytorch_distributed_tutorial_tpu_torch.analysis.trace import memory as TM
    from cs744_pytorch_distributed_tutorial_tpu_torch.analysis.trace.registry import (
        get_entrypoints,
        load_builtin_entrypoints,
    )
    from cs744_pytorch_distributed_tutorial_tpu_torch.parallel import mesh

    t0 = time.perf_counter()
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        rc = lint_main([])
    print(buf.getvalue(), end="")
    if rc != 0:
        raise RuntimeError(f"graftlint exited {rc} on the port's package")
    lint_s = time.perf_counter() - t0
    section = TM.device_section("cuda")
    budget = TM.load_budget(TM.DEFAULT_BUDGET, section)

    def audit(entry) -> tuple[list, dict]:
        gc.collect()
        torch.cuda.empty_cache()
        t = time.perf_counter()
        step = entry.build("cuda")
        build_s = time.perf_counter() - t
        for mod in kernel_modules().values():
            mod.reset_launch_count()
        run = TA.record_step(step)
        launches = _analysis_launches()
        findings, summary = TA.audit_run(entry, step, run, None, "cuda")
        mem, ledger = TM.audit_memory_run(entry, step, run, None, budget)
        row = {
            "entry": entry.name, "schedule": summary["schedule"],
            "wire_bytes": summary["recorded_wire_bytes"], "ops": summary["ops"],
            "step_s": round(summary["step_seconds"], 3), "build_s": round(build_s, 2),
            "launches": launches,
            "ledger": {k: ledger[k] for k in ("argument_bytes", "output_bytes", "temp_bytes",
                                              "alias_bytes", "total_bytes", "cuda_peak_bytes")},
            "ta001_opaque_kernels": summary["ta001_opaque_kernels"],
            **{k: summary[k] for k in ("model", "layers", "d_model", "global_batch_size",
                                       "num_slots") if k in summary},
        }
        print("analysis " + json.dumps(row), flush=True)
        return findings + mem, row

    created = not dist.is_initialized()
    load_builtin_entrypoints()
    try:
        findings, suppressed, rows, _, errors = TA.run_audits(
            get_entrypoints(list(ANALYSIS_ENTRIES)), audit=audit)
    finally:
        if created:
            mesh.shutdown()
    if findings or errors:
        raise RuntimeError(f"analysis: findings {[f.text() for f in findings]}, errors {errors}")
    rows = {row["entry"]: row for row in rows}
    def wgrads(n: dict) -> bool:  # ResNet-18's routed wgrads, all on the tensor cores
        return (n.get("conv3x3_wgrad_s1_tc") == RESNET18_ROUTED
                and not n.get("conv3x3_wgrad_s1") and not n.get("conv3x3_wgrad_s2"))

    def lm(n: dict) -> bool:  # flash on the tensor cores, one fused cross-entropy
        return (all(n.get(f"flash_{k}_tc", 0) > 0 for k in ("fwd", "dq", "dkv"))
                and not any(n.get(f"flash_{k}") for k in ("fwd", "dq", "dkv"))
                and n.get("fused_xent_fwd") == 1 and n.get("fused_xent_bwd") == 1)

    expect = {  # the kernel paths the entries run on the card; the
        # overlapped SGD updates a bucket at a time on the fused kernel
        "cifar": lambda n: wgrads(n) and n.get("fused_sgd") == 1,
        "cifar-overlap": lambda n: wgrads(n) and n.get("fused_sgd", 0) > 1,
        **dict.fromkeys(("cifar-int8", "cifar-overlap-zero1"),
                        lambda n: wgrads(n) and not n.get("fused_sgd")),
        **dict.fromkeys(("lm", "lm-overlap-fsdp"), lambda n: lm(n) and not n.get("fused_sgd")),
        "lm-overlap": lambda n: lm(n) and n.get("fused_sgd", 0) > 1,
        "lm-serve": lambda n: not n.get("paged_attention"),
        "lm-serve-paged": lambda n: n.get("paged_attention", 0) > 0,
    }
    for name, ok in expect.items():
        if not ok(rows[name]["launches"]):
            raise RuntimeError(f"analysis: {name} launched {rows[name]['launches']}")
    seconds = time.perf_counter() - t0
    print(f"analysis: lint {lint_s:.1f} s, {len(rows)} entries audited, 0 findings "
          f"({suppressed} suppressed at their registration), {seconds:.1f} s")
    return {"lint_s": lint_s, "section": section, "entries": rows, "seconds": seconds}


# Phase 35: the H-pair-packed 3x3 conv forward (the TPU probe
# benchmarks/probe_fwd_hpair.py), at the probe's shape and at ragged ones,
# then its entry point. No training, serving or LM path launches it.
HPAIR_SHAPE = (4096, 32, 32, 64)
HPAIR_RAGGED = [(3, 32, 32, 64), (3, 2, 32, 64)]  # no tile divides B 3; H 2: a tile past H


def conv_fwd_hpair_phase(dev: torch.device) -> dict:
    """The kernel against its plain version (``agreement``: 2 bf16 ulps +
    1e-5 x max|plain| an element, at most 0.1 % differing) with
    ``pack_weights`` of a seeded HWIO weight and with a seeded random
    ``w_packed`` at ``HPAIR_SHAPE`` and at ``HPAIR_RAGGED``; a refused
    shape's ``ValueError``; the kernel against cuDNN's bf16 conv (the
    probe's 5e-2 check); each call's launch counted. Then the times at
    ``HPAIR_SHAPE`` (kernel, plain, cuDNN) beside the bounds, and the
    probe's entry point (``main``) as the path, its launches counted.
    Returns the kernels line's record."""
    import torch.nn.functional as F

    from cs744_pytorch_distributed_tutorial_tpu_torch.ops import _build
    from cs744_pytorch_distributed_tutorial_tpu_torch.ops import conv_fwd_hpair as H

    t0 = time.perf_counter()
    torch.backends.cuda.matmul.allow_tf32 = False  # the plain version's product in fp32
    gen = torch.Generator(device=dev).manual_seed(35)
    worst = {"share": 0.0, "differing": 0.0, "max_abs_err": 0.0}
    H.reset_launch_count()
    calls = 0
    for shape in (HPAIR_SHAPE, *HPAIR_RAGGED):
        x = randn(gen, *shape, dtype=torch.bfloat16)
        for label, wp in (("pack_weights", H.pack_weights(0.1 * randn(gen, 3, 3, 64, 64))),
                          ("random", (0.1 * randn(gen, 768, 128)).to(torch.bfloat16))):
            got = H.conv3x3_fwd_hpair(x, wp)
            calls += 1
            a = H.agreement(got, H.conv3x3_fwd_hpair_plain(x, wp))
            print(f"conv3x3_fwd_hpair {list(shape)} {label}: {json.dumps(a)}")
            if not a["ok"] or not math.isfinite(a["share"]):
                raise RuntimeError(f"conv3x3_fwd_hpair disagrees with its plain version at "
                                   f"{list(shape)} ({label}): {a}")
            for k in worst:
                worst[k] = max(worst[k], a[k])
            del got
    try:
        H.conv3x3_fwd_hpair(torch.zeros((2, 8, 32, 32), dtype=torch.bfloat16, device=dev),
                            torch.zeros((384, 64), dtype=torch.bfloat16, device=dev))
        raise RuntimeError("conv3x3_fwd_hpair took C = 32, which its kernel does not cover")
    except ValueError as e:
        print(f"conv3x3_fwd_hpair refuses C = 32: {e}")

    x = randn(gen, *HPAIR_SHAPE, dtype=torch.bfloat16)
    wk = 0.1 * randn(gen, 3, 3, 64, 64)
    wp = H.pack_weights(wk)
    w_oihw = H.hwio_to_oihw(wk).to(torch.bfloat16).contiguous(memory_format=torch.channels_last)
    x_nchw = x.permute(0, 3, 1, 2)  # channels-last view: cuDNN reads x as stored

    def library():
        return F.conv2d(x_nchw, w_oihw, padding=1).permute(0, 2, 3, 1)

    got, ref = H.conv3x3_fwd_hpair(x, wp), library()
    calls += 1
    err = float((got.float() - ref.float()).abs().max())
    rel = err / float(ref.float().abs().max())
    print(f"conv3x3_fwd_hpair against cuDNN's bf16 conv: max abs err {err}, rel {rel} (the "
          f"probe's limit {H.PROBE_REL_LIMIT}); agreement {json.dumps(H.agreement(got, ref))}")
    if not rel < H.PROBE_REL_LIMIT:
        raise RuntimeError(f"conv3x3_fwd_hpair: numerics mismatch against cuDNN (rel {rel})")
    torch.cuda.synchronize()
    if H.launch_count() != calls:
        raise RuntimeError(f"conv3x3_fwd_hpair: {H.launch_count()} launches for {calls} calls")
    del got, ref

    t = {
        "ms": median_ms(lambda: H.conv3x3_fwd_hpair(x, wp)),
        "device_ms": device_busy_ms(lambda: H.conv3x3_fwd_hpair(x, wp)),
        "library_ms": median_ms(library),
        "library_device_ms": device_busy_ms(library),
        "plain_ms": median_ms(lambda: H.conv3x3_fwd_hpair_plain(x, wp), reps=5, warmup=1),
        "plain_device_ms": device_busy_ms(lambda: H.conv3x3_fwd_hpair_plain(x, wp), reps=3),
    }
    t["ms_second"] = median_ms(lambda: H.conv3x3_fwd_hpair(x, wp))  # kernel, cuDNN, kernel
    bounds = H.bounds_ms(tuple(x.shape))  # H100 SXM peaks, from this run's shape
    bound, lib_bound = bounds["bound_ms"], bounds["library_bound_ms"]
    print(f"conv3x3_fwd_hpair {list(HPAIR_SHAPE)} on {card_line()}: kernel {t['ms']:.4f} ms, again "
          f"after cuDNN {t['ms_second']:.4f} (device {t['device_ms']} ms), bound {bound:.4f} ms "
          f"({bounds['bound_by']}): {100 * bound / t['ms']:.1f} % of it; cuDNN bf16 conv2d "
          f"{t['library_ms']:.4f} ms (device {t['library_device_ms']} ms), its own bound "
          f"{lib_bound:.4f} ms ({bounds['library_bound_by']}): "
          f"{100 * lib_bound / t['library_ms']:.1f} %; "
          f"kernel / cuDNN {t['ms'] / t['library_ms']:.3f}; plain {t['plain_ms']:.4f} ms (device "
          f"{t['plain_device_ms']} ms)")

    # The path: the probe's entry point, as a user runs it.
    H.reset_launch_count()
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        rc = H.main([])
    torch.cuda.synchronize()
    text = buf.getvalue()
    print(text, end="")
    probe = json.loads(text.strip().splitlines()[-1])
    launches = H.launch_count()
    if rc != 0 or launches != probe["calls"] or launches < 1:
        raise RuntimeError(f"conv_fwd_hpair.main: rc {rc}, {launches} launches for "
                           f"{probe['calls']} calls")
    ptxas = _build.ptxas_report(H.SOURCE)
    print(f"conv_fwd_hpair phase: {time.perf_counter() - t0:.1f} s")
    return {
        "name": "conv3x3_fwd_hpair",
        "route": "cuda",
        "source": "cs744_pytorch_distributed_tutorial_tpu_torch/csrc/" + H.SOURCE,
        "replaces": "benchmarks/probe_fwd_hpair.py:50",
        "tpu_kernel": "benchmarks/probe_fwd_hpair.py::_fwd_kernel (pallas_call :116)",
        "launches": launches,
        "max_abs_err": worst["max_abs_err"],
        "share_of_limit": worst["share"],
        "share_differing": worst["differing"],
        "ms": t["ms"],
        "ms_second": t["ms_second"],
        "device_ms": t["device_ms"],
        "plain_ms": t["plain_ms"],
        "plain_device_ms": t["plain_device_ms"],
        "bound_ms": bound,
        "bound_by": bounds["bound_by"],
        "bound_share": bound / t["ms"],
        "library_ms": t["library_ms"],
        "library_device_ms": t["library_device_ms"],
        "library": "F.conv2d (cuDNN, bf16, channels-last view of x)",
        "library_bound_ms": lib_bound,
        "library_bound_share": lib_bound / t["library_ms"],
        "cudnn_rel_err": rel,
        "probe": {k: probe[k] for k in ("rel_err", "kernel_ms", "library_ms", "calls")},
        "ptxas": ptxas,
        "work": f"one call at {list(HPAIR_SHAPE)} (the probe's shape)",
    }


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is False; this script "
              "needs an NVIDIA card", file=sys.stderr)
        return 1
    from cs744_pytorch_distributed_tutorial_tpu_torch.ops import _build
    from cs744_pytorch_distributed_tutorial_tpu_torch.ops import conv_fwd_hpair as HP
    from cs744_pytorch_distributed_tutorial_tpu_torch.ops import flash_attention as A
    from cs744_pytorch_distributed_tutorial_tpu_torch.ops import fused_conv as C
    from cs744_pytorch_distributed_tutorial_tpu_torch.ops import fused_sgd as K
    from cs744_pytorch_distributed_tutorial_tpu_torch.ops import fused_xent as FX
    from cs744_pytorch_distributed_tutorial_tpu_torch.ops import gmm as G
    from cs744_pytorch_distributed_tutorial_tpu_torch.ops import paged_attention as PA
    from cs744_pytorch_distributed_tutorial_tpu_torch.ops import quant as QT

    t_start = time.perf_counter()
    clock_phases()
    dev = torch.device("cuda", 0)
    torch.cuda.set_device(dev)
    # Stated, not inherited: fp32 convolutions in TF32 (cuDNN's default),
    # fp32 matrix products in full fp32 (PyTorch's default).
    torch.backends.cudnn.allow_tf32 = True
    torch.backends.cuda.matmul.allow_tf32 = False
    card = card_line()
    print(f"card: {card}")
    print(f"python {sys.version.split()[0]}, torch {torch.__version__}, "
          f"CUDA {torch.version.cuda}, device {torch.cuda.get_device_name(0)}, "
          f"count {torch.cuda.device_count()}")
    print(f"cudnn.allow_tf32={torch.backends.cudnn.allow_tf32} "
          f"matmul.allow_tf32={torch.backends.cuda.matmul.allow_tf32}")
    t0 = time.perf_counter()
    modules = (K, C, A, PA, QT, FX, G, HP)
    sources = [src for module in modules for src in getattr(module, "SOURCES", (module.SOURCE,))]
    _build.build_all(sources)
    for module in modules:
        module.load_kernel()
    print("built " + ", ".join(f"{s} in {_build.build_seconds[s]:.2f} s" for s in sources)
          + f", in parallel (wall {time.perf_counter() - t0:.2f} s)")
    for src in (A.TC_SOURCE, QT.TC_SOURCE, G.TC_SOURCE, C.TC_SOURCE, HP.SOURCE):  # tensor cores
        for kernel, usage in _build.ptxas_report(src).items():
            print(f"ptxas {src}: {kernel}: {usage['registers']} registers, "
                  f"{usage['spill_stores']} bytes spill stores, {usage['spill_loads']} bytes "
                  f"spill loads")

    records = [fused_sgd_phase(dev), *wgrad_phase(dev)]
    # ResNet-18's fp32 stride-1 wgrads all on the tensor cores; the whole
    # update one fused-SGD launch a step (62 tensors), VGG-11's too (34).
    counts = main_path_phase("resnet18", ("--fast-conv", "--fused-optimizer"), {
        "fused_sgd": STEPS,
        "conv3x3_wgrad_s1_tc": RESNET18_ROUTED * STEPS,
        "conv3x3_wgrad_s1": 0,
        "conv3x3_wgrad_s2": 0,
        "conv3x3_wgrad_s2_tc": 0,
    })
    vgg_counts = main_path_phase("vgg11", ("--fused-optimizer",), {
        "fused_sgd": STEPS,
        "conv3x3_wgrad_s1": 0, "conv3x3_wgrad_s1_tc": 0,
        "conv3x3_wgrad_s2": 0, "conv3x3_wgrad_s2_tc": 0,
    })
    for rec in records:
        rec["launches"] = counts[rec["name"]]
    records[0]["launches_vgg11_path"] = vgg_counts["fused_sgd"]
    nccl_phases()
    bf16_phase()
    trajectory_phase()
    profile_phase("vgg11")
    profile_phase("resnet18", fast_conv=True)
    profile_phase("resnet18", fast_conv=False)
    bench_phase()
    buckets = sync_paths_phase()
    print(f"fused_sgd on the overlapped paths: one launch a bucket ({buckets} a ResNet-18 step)")
    sharded_phase()

    lm_records = flash_phase(dev) + fused_xent_phase(dev)
    lm_counts = lm_main_path_phase()
    for rec in lm_records:
        rec["launches"] = lm_counts[rec["name"]]
    records += lm_records
    lm_throughput_phase()
    lm_trajectory_phase()
    lm_lion_phase()
    route_launches = lm_flash_route_trajectory_phase()
    for rec in lm_records:  # the FFMA kernels' launches, off the bf16 main path
        if rec["name"] in ("flash_fwd", "flash_dq", "flash_dkv"):
            rec["launches_ffma_route_trajectory"] = route_launches["ffma"][rec["name"][6:]]

    paged_record = paged_phase(dev)
    int8_records = int8_matmul_phase(dev)
    int8_launches = generation_phase()
    for rec in int8_records:
        rec["launches"] = int8_launches["tc" if rec["name"].endswith("_tc") else "ffma"]
    paged_record["launches"] = serving_phase()
    records += [paged_record, *int8_records]
    serving_checks_phase()
    # The serving tracer, guard and recovery: their main path is
    # the traced serving run.
    paged_record["launches_traced_serving"] = traced_serving_phase()
    overload_phase()
    failure = serving_failure_phase()
    chaos = failure["chaos"]["launches"]
    for rec in int8_records:  # the int8 head's launches in the chaos run, by route
        tc = chaos["int8_matmul_tc"]
        rec["launches_serving_chaos"] = tc if rec["name"].endswith("_tc") else (
            chaos["int8_matmul"] - tc)

    gmm_records = gmm_phase(dev)
    gen_gmm = moe_generation_phase()
    for rec in gmm_records:
        rec["launches"] = gen_gmm["fused_tc" if rec["name"].endswith("_tc") else "fused"]
    records += gmm_records

    bwd_records = gmm_backward_phase(dev)
    train_counts = moe_train_path_phase()
    for rec in bwd_records:
        rec["launches"] = train_counts[rec.pop("kernel")]
    records += bwd_records
    moe_train_throughput_phase()
    moe_train_trajectory_phase()
    moe_route_trajectory_phase()
    moe_scatter_phase()

    run_loop = run_loop_phase()
    records[0]["launches_run_loop"] = run_loop["run_fused_sgd_launches"]

    # The phase profiler's segments, one call each, and the LM run loop.
    cifar_phases = cifar_phases_phase()
    lm_phases = lm_phases_phase()
    lm_loop = lm_run_loop_phase()
    # The LM training options, beam search and speculative decoding.
    lm_options = lm_options_phase()
    beam_int8 = beam_phase()
    speculative = speculative_phase()
    for rec in int8_records:
        rec["launches_beam"] = beam_int8["tc" if rec["name"].endswith("_tc") else "ffma"]
    # The LM across ranks (NCCL at a world of one).
    lm_ranks = lm_ranks_phase()
    # The sequence axis's hops on the flash kernels.
    seq_tensor = seq_tensor_phase(dev)
    # Tensor-parallel decode and serving: four ranks' paged kernels on
    # their own KV heads.
    paged_record["launches_tp_serving"] = tp_serving_phase()["launches"]
    # The ViT family on the CIFAR trainer (flash at T 65 and 17), and the
    # grouped matmul past 64 experts.
    vit = vit_phase()
    groups = gmm_groups_phase(dev)
    # Training that survives losing a rank: the supervisor on the host,
    # then ResNet-18 and the LM restored on the card from other worlds.
    elastic = elastic_phase()
    elastic_launches = {**elastic["resnet"]["launches"], **elastic["lm"]["launches"]}
    # The pipe axis: GPT-2-small on four simulated stages, each schedule.
    pipeline = pipeline_phase()
    # The analysis package: the linter, and one recorded step of each
    # registered entry audited (TA001-TA010) on the card.
    analysis = analysis_phase()
    # The H-pair-packed conv forward (the TPU probe's kernel) and its
    # entry point, off every training, serving and LM path.
    records.append(conv_fwd_hpair_phase(dev))
    gmm_keys = {"gmm_fused": "fused", "gmm_fused_tc": "fused_tc", "gmm_fused_with_z": "fused_z",
                "gmm_fused_with_z_tc": "fused_z_tc", "gmm": "gmm", "gmm_tc": "gmm_tc",
                "tgmm": "tgmm", "tgmm_tc": "tgmm_tc", "colsum": "colsum"}
    for rec in records:
        if rec["name"] in ("flash_fwd_tc", "flash_dq_tc", "flash_dkv_tc"):
            kern = rec["name"][len("flash_"):]
            rec["launches_vit_path"] = {model: n[kern] for model, n in vit["launches"].items()}
        key = gmm_keys.get(rec["name"])
        if key in groups["share"]:
            rec["share_of_limit_e65_128_256"] = groups["share"][key]
        if key in groups["ms_e128"]:
            rec["ms_e128"] = groups["ms_e128"][key]
    for rec in records:
        key = {"gmm_fused_tc": "gmm_fused_tc", "gmm_fused_with_z_tc": "gmm_fused_z_tc",
               "gmm_tc": "gmm_gmm_tc", "tgmm_tc": "gmm_tgmm_tc", "split": "gmm_split",
               "colsum": "gmm_colsum"}.get(rec["name"], rec["name"])
        segs = {f"{label}_{seg}": n[key] for label, case in (
            ("resnet18_fast_conv", {"launches": cifar_phases["segment_launches_resnet18"]}),
            *lm_phases.items()) for seg, n in case["launches"].items() if key in n}
        if segs:
            rec["launches_phase_segments"] = segs
        if key in lm_loop["run_launches"]:
            rec["launches_lm_run_loop"] = lm_loop["run_launches"][key]
        opts = {label: r["launches"][key] for label, r in lm_options.items()
                if label != "card" and key in r["launches"]}
        if opts:
            rec["launches_lm_options"] = opts
        spec = {label: r["launches"][key] for label, r in speculative.items()
                if label != "card" and key in r["launches"]}
        if spec:
            rec["launches_speculative"] = spec
        ranks = {label: r["launches"][key] for label, r in lm_ranks.items()
                 if isinstance(r, dict) and key in r.get("launches", {})}
        if ranks:
            rec["launches_lm_ranks"] = ranks
        if rec["name"] in ("flash_fwd_tc", "flash_dq_tc", "flash_dkv_tc"):
            kern = rec["name"][len("flash_"):-len("_tc")]
            rec["launches_seq_tensor"] = {label: n[f"{kern}_tc"]
                                          for label, n in seq_tensor["launches"].items()}
        if rec["name"] in elastic_launches:
            rec["launches_elastic"] = elastic_launches[rec["name"]]
        if rec["name"].startswith("flash_"):
            kern = rec["name"][len("flash_"):]
            rec["launches_pipeline"] = {sched: n[kern] for sched, n in
                                        pipeline["launches"].items()}
        audited = {entry: row["launches"][rec["name"]]
                   for entry, row in analysis["entries"].items() if rec["name"] in row["launches"]}
        if audited:
            rec["launches_analysis"] = audited
        moe_key = {**gmm_keys, "split": "split"}.get(rec["name"])
        if moe_key in pipeline["moe"]["launches"]:
            rec["launches_pipeline_moe"] = pipeline["moe"]["launches"][moe_key]

    print(f"wall {time.perf_counter() - t_start:.1f} s, of which the phases' (s): "
          + json.dumps({name: round(sec, 1) for name, sec in PHASE_SECONDS.items()}))
    print(json.dumps({"kernels": records}))
    print(card_line())
    print(json.dumps({
        "ok": True,
        "device": {
            "platform": "gpu",
            "kind": torch.cuda.get_device_name(0),
            "count": torch.cuda.device_count(),
        },
    }))
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
