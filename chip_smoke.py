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
   - fused SGD at ResNet-18's 62 and VGG-11's 34 parameter shapes and
     ragged ones;
   - the 3x3 conv wgrad at ResNet-18's routed (stride 1) and stride-2
     shapes at batch 256 and at ragged shapes, fp32 and bf16;
3. main paths, through the port's CLI, part 1 (one rank), batch 256, 24
   steps each, the kernel launch counts zeroed just before each run and
   read just after: ResNet-18 at full width with ``--fast-conv
   --fused-optimizer`` (this slice's path: 6 wgrad and 62 fused-SGD
   launches a step), and VGG-11 with ``--fused-optimizer`` (34 a step);
4. NCCL paths at a world of one, 5 steps each: VGG-11 part 2b, and
   ResNet-18 part 3 (DDP) with ``--fast-conv``;
5. bf16: ResNet-18 ``--fast-conv --compute-dtype bfloat16``, 5 steps, the
   wgrad kernel launched on bf16 inputs;
6. trajectories: VGG-11 fused vs plain update (3 steps), and ResNet-18
   with the wgrad kernel vs the library's (4 steps, TF32 off);
7. profiles: where the device time of a main-path step goes, VGG-11 and
   ResNet-18 (with and without ``fast_conv``);
8. flash attention: the forward, dq and dk/dv kernels against their
   plain versions (the LM path's shape B16 T1024 H12 D64 causal, a
   non-causal and ragged shapes, fp32 and bf16): fp32 dq and dk/dv on the
   FFMA kernels, bf16 ones on the tensor-core kernels (bitwise repeatable)
   and again on the FFMA route, each call's route shown by its launches;
   then their times at the path's shape in bf16 (the backward's two routes
   in turn; the tensor-core kernels must be the faster) beside their
   bounds, the plain versions', ``scaled_dot_product_attention``'s forward
   and backward, and the tensor-core kernels' registers and spills;
9. fused cross-entropy: the forward and backward kernels against their
   plain versions at the LM path's logits ([16384, 50304] fp32), in bf16
   and at a ragged shape ([37, 50257]), then their times beside their
   bounds, the plain versions' and ``F.cross_entropy``'s forward and
   backward;
10. the LM main path through the port's ``lm_cli``: GPT-2-small at full
    width (12 layers, d 768, 12 heads, vocab 50304, T 1024, batch 16, RoPE,
    bf16, AdamW, ``--attention-impl flash --fused-xent``), 24 steps and one
    eval batch (plain CE, as the JAX eval), every launch count zeroed just
    before and read just after (the flash backward all on the tensor
    cores: 288 dq and 288 dk/dv, none on the FFMA route);
11. its throughput (``LMTrainer.train_step``, tokens/s and MFU) with flash
    and the fused cross-entropy, flash alone and dense attention,
    flash-vs-dense and fused-vs-plain cross-entropy trajectories (2 layers
    at full width, fp32, TF32 off), a profile of one step with and one
    without the fused cross-entropy, and the flash backward's tensor-core
    route against its FFMA route (2 layers at full width, batch 4, bf16, 4
    AdamW steps, the plain versions printed beside as the yardstick);
12. paged attention: the decode kernel against its plain version (the
    gather path) at the serving shape (16 slots, 12 query heads over 4 KV
    heads, D 64, page 16, ragged depths up to 511) in fp32, bf16 and int8
    (under an fp32 and a bf16 query), and at a ragged one (page 8, group
    1, D 128, a slot at depth 0), every page a slot does not hold live
    written with NaN; then its times (bf16, and int8 pages under a bf16
    query, the variants serving runs) beside its bound, the gather path's
    and a gather plus ``scaled_dot_product_attention``'s;
13. the int8 weight matmul against its plain version at the GPT-2-small
    head's decode ([16, 768] x [768, 50304]) and prompt-pass ([2048, 768])
    shapes in bf16 and fp32, then its times beside its bound, the plain
    version's and ``torch.matmul`` on the widened weight;
14. generation through ``lm_cli --generate 128``: GPT-2-small width with 4
    KV heads, batch 16, prompt 128, greedy, bf16, ``--int8-decode head``
    (one int8 matmul launch a model call), then in bf16 alone (the share
    of greedy tokens the int8 head keeps) and with ``--int8-kv-cache``;
15. serving through ``serve_cli``: the same model, 16 slots over a
    513-page pool of 16 rows (32 pages a slot), 64 Poisson requests at 64
    rps, prompts and outputs 64-256 tokens, the paged kernel (12 launches
    a decode step); the same trace through the kernel and gather engines
    (the share of greedy tokens that agree); a pool-pressure run (97
    pages, int8 KV pages and the int8 head) that must preempt; and a
    profile of 20 decode steps;
16. the fused grouped matmul (dropless MoE's expert FFN) against its plain
    version at the MoE path's prefill (M 4096) and decode (M 32) shapes,
    with group sizes from a real router's top-2 on random tokens, and at a
    ragged shape with empty groups, both activations, bf16 and fp32; its
    times beside its bound, the plain version's and ``torch._grouped_mm``
    plus bias and gelu; one MoE layer's forward under
    ``torch.cuda.set_sync_debug_mode("error")`` (no host synchronisation);
17. MoE generation through ``lm_cli --generate 128``: the JAX package's
    MoE LM (``benchmarks/bench_vit_moe.py``: 6 layers, d 512, 8 heads, d_ff
    1024, 8 experts top-2, dropless, vocab 50304, RoPE, bf16), batch 16,
    prompt 128, greedy, 2 grouped-matmul launches a layer a model call;
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
    bitwise against its plain version; ``colsum`` (dbias) and the forward's
    ``z``; then the path's four calls on both routes in turn, split and
    colsum, beside their bounds, the plain versions' and one PyTorch
    call's times;
19. MoE training through ``lm_cli``: the JAX package's
    ``moe_e8_top2_dropless_pallas`` (``benchmarks/bench_vit_moe.py``) at
    full width, batch 32 x T 512, flash, bf16, AdamW, 8 steps and one eval
    batch, every launch count exact (a step: 12 ``gmm_fused`` of which the
    6 ``w_in`` calls write ``z``, 12 ``gmm_tc``, 12 ``tgmm_tc``, 6
    ``split``, 12 ``colsum``, no FFMA ``gmm`` or ``tgmm``, and 18 flash,
    the backward's 12 on the tensor cores);
    its throughput, one step under ``set_sync_debug_mode("error")`` and a
    profile of 2 steps; a kernel-vs-plain trajectory (2 layers at full
    width, batch 8, fp32, 4 steps); the tensor-core route against the FFMA
    route (the same, in bf16, with the plain versions as a yardstick); and
    3 steps with the capacity-slot ``scatter`` dispatch (no grouped-matmul
    kernel).

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
FLASH_CASES = [FLASH_PATH, (4, 512, 12, 64, False), (1, 200, 3, 64, True),
               (2, 77, 2, 128, True)]
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
PROFILE_PROMPT, PROFILE_BUDGET = 128, 64
SERVE_TRACE = dict(num_requests=64, rate_rps=64.0, prompt_len=(64, 256), output_len=(64, 256),
                   seed=0)
# Paged attention: (B, Hq, Hkv, D, page_size, pages a slot). The serving
# shape first.
PAGED_SERVE = (16, 12, 4, 64, 16, 32)
PAGED_CASES = [PAGED_SERVE, (5, 2, 2, 128, 8, 7)]
# name: (pool dtype, q dtype). int8_bf16q is the variant serving runs:
# bf16 compute over int8 pages, the output in bf16.
PAGED_VARIANTS = {"float32": (torch.float32, torch.float32),
                  "bfloat16": (torch.bfloat16, torch.bfloat16),
                  "int8": (torch.int8, torch.float32),
                  "int8_bf16q": (torch.int8, torch.bfloat16)}
PAGED_FP32_TOL = 2e-5  # max abs err of fp32 outputs
INT8_SHAPES = {"decode": (GEN_BATCH, 768, 50304), "prefill": (GEN_BATCH * GEN_PROMPT, 768, 50304)}

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


def kernel_modules():
    from cs744_pytorch_distributed_tutorial_tpu_torch.ops import flash_attention as A
    from cs744_pytorch_distributed_tutorial_tpu_torch.ops import fused_conv as C
    from cs744_pytorch_distributed_tutorial_tpu_torch.ops import fused_sgd as K
    from cs744_pytorch_distributed_tutorial_tpu_torch.ops import fused_xent as FX
    from cs744_pytorch_distributed_tutorial_tpu_torch.ops import gmm as G
    from cs744_pytorch_distributed_tutorial_tpu_torch.ops import paged_attention as PA
    from cs744_pytorch_distributed_tutorial_tpu_torch.ops import quant as QT

    return {"fused_sgd": K, "conv3x3_wgrad": C, "flash": A, "paged_attention": PA,
            "int8_matmul": QT, "fused_xent": FX, "gmm_fused": G}


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


def randn(gen: torch.Generator, *shape, dtype=torch.float32) -> torch.Tensor:
    return torch.randn(shape, generator=gen, device=gen.device).to(dtype)


# --------------------------------------------------------------- fused SGD
def fused_sgd_phase(dev: torch.device) -> dict:
    from cs744_pytorch_distributed_tutorial_tpu_torch.models import resnet18, vgg11
    from cs744_pytorch_distributed_tutorial_tpu_torch.ops import fused_sgd as K

    shapes = {
        "resnet18": [tuple(p.shape) for p in resnet18().parameters()],
        "vgg11": [tuple(p.shape) for p in vgg11().parameters()],
    }
    if len(shapes["resnet18"]) != RESNET18_TENSORS or len(shapes["vgg11"]) != VGG11_TENSORS:
        raise RuntimeError(f"unexpected parameter counts: {[len(v) for v in shapes.values()]}")
    gen = torch.Generator(device=dev).manual_seed(0)

    # Correctness: 3 steps of kernel vs plain on the same inputs; the
    # misaligned case (a view one float into its storage) takes the
    # kernel's scalar path.
    max_err = 0.0
    all_shapes = sorted(set(shapes["resnet18"] + shapes["vgg11"] + RAGGED_SHAPES))
    cases = [(s, 0) for s in all_shapes] + [((1000,), 1)]
    for shape, offset in cases:
        n = math.prod(shape)
        p = randn(gen, n + offset)[offset:].view(shape)
        m = (0.1 * randn(gen, n + offset))[offset:].view(shape)
        pk, mk, pp, mp = p.clone(), m.clone(), p.clone(), m.clone()
        if offset:
            pk = torch.empty(n + offset, device=dev)[offset:].view(shape).copy_(p)
            mk = torch.empty(n + offset, device=dev)[offset:].view(shape).copy_(m)
        for _ in range(3):
            g = randn(gen, *shape)
            K.fused_sgd_(pk, mk, g, lr=LR, mu=MU, wd=WD)
            K.fused_sgd_plain(pp, mp, g, lr=LR, mu=MU, wd=WD)
        torch.cuda.synchronize()
        for got, want in ((pk, pp), (mk, mp)):
            err = (got - want).abs()
            tol = 1e-6 * want.abs() + 1e-7
            if not bool((err <= tol).all()):
                raise RuntimeError(
                    f"fused_sgd kernel disagrees with its plain version at shape "
                    f"{shape} offset {offset}: max abs err {float(err.max())}"
                )
            max_err = max(max_err, float(err.max()))
    print(f"fused_sgd: {len(cases)} shapes x 3 steps agree with the plain "
          f"version, max abs err {max_err} (tolerance 1e-6*|p| + 1e-7)")

    bw, flops = card_rates(torch.cuda.get_device_name(0))
    timed = {}
    for model, model_shapes in shapes.items():
        params = [randn(gen, *s) for s in model_shapes]
        moms = [torch.zeros_like(p) for p in params]
        grads = [randn(gen, *s) for s in model_shapes]

        def kernel_update():
            for p, m, g in zip(params, moms, grads):
                K.fused_sgd_(p, m, g, lr=LR, mu=MU, wd=WD)

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
        t = {
            "ms": median_ms(kernel_update),
            "plain_ms": median_ms(plain_update),
            "library_ms": median_ms(lib_opt.step),
            "device_ms": device_busy_ms(kernel_update),
            "plain_device_ms": device_busy_ms(plain_update),
            "library_device_ms": device_busy_ms(lib_opt.step),
            "bound_ms": max(bytes_ms, ops_ms),
            "bound_by": "bytes" if bytes_ms >= ops_ms else "operations",
            "elements": n,
            "tensors": len(model_shapes),
        }
        timed[model] = t
        print(f"fused_sgd: {model} update of {n} elements in {len(model_shapes)} "
              f"tensors ({20 * n / 1e6:.1f} MB): kernel {t['ms']:.4f} ms, plain "
              f"{t['plain_ms']:.4f} ms, torch.optim.SGD(fused=True) "
              f"{t['library_ms']:.4f} ms, bound {t['bound_ms']:.4f} ms; device busy "
              f"per update (profiler): kernel {t['device_ms']}, plain "
              f"{t['plain_device_ms']}, library {t['library_device_ms']} ms")
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
        "work": "one whole ResNet-18 update (62 tensors)",
        "vgg11": timed["vgg11"],
    }


# ----------------------------------------------------------- conv wgrad
def wgrad_phase(dev: torch.device) -> list[dict]:
    import torch.nn.functional as F

    from cs744_pytorch_distributed_tutorial_tpu_torch.ops import fused_conv as C

    gen = torch.Generator(device=dev).manual_seed(1)
    cases = [(s, shape, k) for s in (1, 2) for shape, k in WGRAD_RAGGED]
    cases += [(1, shape, k) for shape, k in WGRAD_S1] + [(2, shape, k) for shape, k in WGRAD_S2]
    max_err = {1: 0.0, 2: 0.0}
    max_rel = {1: 0.0, 2: 0.0}
    for dtype in (torch.float32, torch.bfloat16):
        for stride, shape, k in cases:
            b, c, h, w = shape
            x = randn(gen, *shape, dtype=dtype)
            g = randn(gen, b, k, h // stride, w // stride, dtype=dtype)
            got = C.conv3x3_wgrad(x, g, stride)
            want = C.conv3x3_wgrad_plain(x, g, stride)
            torch.cuda.synchronize()
            err = float((got - want).abs().max())
            scale = float(want.abs().max())
            if not (math.isfinite(err) and err <= WGRAD_RTOL * scale):
                raise RuntimeError(
                    f"conv3x3_wgrad kernel disagrees with its plain version: stride "
                    f"{stride} x {shape} K {k} {dtype}: max abs err {err}, max|plain| {scale}"
                )
            max_err[stride] = max(max_err[stride], err)
            max_rel[stride] = max(max_rel[stride], err / scale)
    for s in (1, 2):
        print(f"conv3x3_wgrad stride {s}: {sum(c[0] == s for c in cases)} shapes x "
              f"(fp32, bf16) agree with the plain version, max abs err {max_err[s]}, "
              f"max abs err / max|plain| {max_rel[s]:.3e} (tolerance {WGRAD_RTOL})")

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
            xl, pad = (x, 1) if stride == 1 else (F.pad(x, (0, 1, 0, 1)), 0)

            def library():
                return torch.nn.grad.conv2d_weight(xl, (k, c, 3, 3), g, stride=stride, padding=pad)

            t = {
                "shape": [list(shape), k],
                "ms": median_ms(lambda: C.conv3x3_wgrad(x, g, stride)),
                "device_ms": device_busy_ms(lambda: C.conv3x3_wgrad(x, g, stride)),
                "bf16_ms": median_ms(lambda: C.conv3x3_wgrad(xb, gb, stride)),
                "plain_ms": median_ms(lambda: C.conv3x3_wgrad_plain(x, g, stride)),
                "library_ms": median_ms(library),
            }
            torch.backends.cudnn.allow_tf32 = False
            try:
                t["library_fp32_ms"] = median_ms(library)
            finally:
                torch.backends.cudnn.allow_tf32 = tf32
            flop = 2.0 * k * 9 * c * b * ho * wo
            nbytes = 4.0 * (x.numel() + g.numel() + k * c * 9)
            bytes_ms, ops_ms = nbytes / bw * 1e3, flop / flops * 1e3
            t.update(
                gflop=flop / 1e9, mbytes=nbytes / 1e6,
                bound_ms=max(bytes_ms, ops_ms),
                bound_by="bytes" if bytes_ms >= ops_ms else "operations",
                tf32_bound_ms=flop / TF32_FLOPS * 1e3,
            )
            t["fp32_peak_share"] = t["bound_ms"] / t["ms"]
            per_shape[stride].append(t)
            print(f"conv3x3_wgrad stride {stride} x {list(shape)} K {k}: {flop / 1e9:.2f} "
                  f"GFLOP, {nbytes / 1e6:.1f} MB; kernel {t['ms']:.4f} ms (device "
                  f"{t['device_ms']} ms, bf16 {t['bf16_ms']:.4f} ms), plain "
                  f"{t['plain_ms']:.4f} ms, cuDNN wgrad {t['library_ms']:.4f} ms (TF32) "
                  f"{t['library_fp32_ms']:.4f} ms (fp32), bound {t['bound_ms']:.4f} ms "
                  f"({t['bound_by']}; {100 * t['fp32_peak_share']:.1f} % of it), TF32 "
                  f"bound {t['tf32_bound_ms']:.4f} ms")

    records = []
    for stride, times, work, reps in (
        (1, per_shape[1], "3 calls at each of ResNet-18's two routed shapes "
         "(the wgrads of one main-path step)", ROUTED_PER_SHAPE),
        (2, per_shape[2], "one call at each of ResNet-18's two stride-2 3x3 "
         "shapes (not on the main path: routing takes stride 1 only)", 1),
    ):
        def total(key):
            vals = [t[key] for t in times]
            return None if None in vals else reps * sum(vals)

        bound = total("bound_ms")
        records.append({
            "name": f"conv3x3_wgrad_s{stride}",
            "route": "cuda",
            "source": "cs744_pytorch_distributed_tutorial_tpu_torch/csrc/fused_conv.cu",
            "replaces": "cs744_pytorch_distributed_tutorial_tpu/ops/fused_conv.py:"
                        + ("70" if stride == 1 else "104"),
            "tpu_kernel": f"ops/fused_conv.py::_wgrad_kernel_s{stride}",
            "launches": None,  # filled in from the main path's run
            "max_abs_err": max_err[stride],
            "max_rel_err": max_rel[stride],
            "ms": total("ms"),
            "device_ms": total("device_ms"),
            "bf16_ms": total("bf16_ms"),
            "plain_ms": total("plain_ms"),
            "bound_ms": bound,
            "bound_by": "operations" if all(t["bound_by"] == "operations" for t in times) else "bytes",
            "tf32_bound_ms": total("tf32_bound_ms"),
            "library_ms": total("library_ms"),
            "library_fp32_ms": total("library_fp32_ms"),
            "work": work,
            "shapes": times,
        })
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
        "conv3x3_wgrad_s1": C.launch_count(stride=1),
        "conv3x3_wgrad_s2": C.launch_count(stride=2),
        "conv3x3_wgrad_bf16": C.launch_count(dtype=torch.bfloat16),
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
              {"fused_sgd": VGG11_TENSORS * NCCL_STEPS})
    # DDP: every parameter's gradient, the autograd Function's dW
    # included, must reach the reducer, or DDP raises on the next step.
    summary, counts = counted_run(cli_argv("resnet18", "3", NCCL_STEPS, "--fast-conv"))
    if summary["backend"] != "nccl":
        raise RuntimeError(f"part 3 ran on backend {summary['backend']!r}, not nccl")
    check_run("DDP path resnet18 part 3", summary, counts, NCCL_STEPS,
              {"conv3x3_wgrad_s1": RESNET18_ROUTED * NCCL_STEPS, "conv3x3_wgrad_s2": 0})


def bf16_phase() -> None:
    argv = cli_argv("resnet18", "1", BF16_STEPS, "--fast-conv", "--fused-optimizer",
                    "--compute-dtype", "bfloat16")
    summary, counts = counted_run(argv)
    check_run("bf16 path resnet18 part 1", summary, counts, BF16_STEPS, {
        "conv3x3_wgrad_s1": RESNET18_ROUTED * BF16_STEPS,
        "conv3x3_wgrad_bf16": RESNET18_ROUTED * BF16_STEPS,
        "fused_sgd": RESNET18_TENSORS * BF16_STEPS,
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
        "fused_sgd": ("fused_sgd",), "wgrad_kernel": ("wgrad_kernel", "sum_splits_kernel")})
    if not summary:
        return {}
    out = {"model": model, **cfg_kw, **summary, "wall_ms_per_step_profiled": wall / steps * 1e3}
    print(json.dumps({"step_profile": out}))
    return out


# ---------------------------------------------------------- flash attention
@contextlib.contextmanager
def flash_ffma_route():
    """The flash backward on the FFMA kernels whatever the inputs (the
    route rule, patched for the block to refuse the tensor cores), for a
    route-vs-route comparison."""
    from cs744_pytorch_distributed_tutorial_tpu_torch.ops import flash_attention as A

    saved = A.tc_route
    A.tc_route = lambda *args, **kw: False
    try:
        yield
    finally:
        A.tc_route = saved


@contextlib.contextmanager
def plain_flash_backward():
    """The flash autograd Function's backward through the plain versions
    of dq and dk/dv on CUDA tensors (the module functions it calls, patched
    for the block), as a trajectory's yardstick."""
    from cs744_pytorch_distributed_tutorial_tpu_torch.ops import flash_attention as A

    saved = A.flash_dq, A.flash_dkv
    A.flash_dq, A.flash_dkv = A.flash_dq_plain, A.flash_dkv_plain
    try:
        yield
    finally:
        A.flash_dq, A.flash_dkv = saved


def flash_phase(dev: torch.device) -> list[dict]:
    """The kernels against their plain versions (each backward kernel
    given the plain lse and delta, so each is checked on its own): fp32
    inputs take the FFMA dq and dk/dv, bf16 ones the tensor-core kernels
    (a second run bitwise equal), then the same bf16 inputs on the FFMA
    route; every call's route shown by its launches. Then times at the LM
    path's shape in bf16, the backward's two routes in turn (tensor cores,
    FFMA, FFMA, tensor cores: the mean of the two medians)."""
    import torch.nn.functional as F

    from cs744_pytorch_distributed_tutorial_tpu_torch.ops import _build
    from cs744_pytorch_distributed_tutorial_tpu_torch.ops import flash_attention as A

    gen = torch.Generator(device=dev).manual_seed(3)
    names = ("fwd", "dq", "dkv", "dq_tc", "dkv_tc")
    err = {k: 0.0 for k in names}
    share = {}  # (name, dtype) -> max over cases of err / (tolerance x max|plain|)
    lse_err = 0.0

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
                {("fwd", "ffma"): 1, ("dq", route): 1, ("dkv", route): 1}, backward)
            want_dq = A.flash_dq_plain(*args)
            want_dk, want_dv = A.flash_dkv_plain(*args)
            case = f"{dtype} B{b} T{t} H{h} D{d} causal={causal}"
            checks = [("fwd", out, want_o), ("dq" + sfx, dq, want_dq),
                      ("dkv" + sfx, dk, want_dk), ("dkv" + sfx, dv, want_dv)]
            if route == "tc":
                _, dq2, (dk2, dv2) = backward()
                if not (torch.equal(dq, dq2) and torch.equal(dk, dk2) and torch.equal(dv, dv2)):
                    raise RuntimeError(f"flash tensor-core backward not bitwise repeatable at "
                                       f"{case}")
                with flash_ffma_route():
                    _, fdq, (fdk, fdv) = routed(
                        {("fwd", "ffma"): 1, ("dq", "ffma"): 1, ("dkv", "ffma"): 1}, backward)
                checks += [("dq", fdq, want_dq), ("dkv", fdk, want_dk), ("dkv", fdv, want_dv)]
            torch.cuda.synchronize()
            e = float((lse - want_lse).abs().max())
            if not (math.isfinite(e) and e <= FLASH_LSE_TOL):
                raise RuntimeError(f"flash fwd lse disagrees with its plain version at {case}: {e}")
            lse_err = max(lse_err, e)
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
              + (f"; lse max abs err {lse_err} (tolerance {FLASH_LSE_TOL})" if name == "fwd"
                 else "")
              + ("; bitwise repeatable" if name.endswith("_tc") else ""))
    for name in ("dq", "dkv"):
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
    ms_runs = {"fwd": [median_ms(calls["fwd"][0])]}
    device_ms = {"fwd": device_busy_ms(calls["fwd"][0], match="flash_fwd_kernel")}
    for turn in ("tc", "ffma", "ffma", "tc"):
        ctx = flash_ffma_route() if turn == "ffma" else contextlib.nullcontext()
        with ctx:
            for base in ("dq", "dkv"):
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
        lib_key = "fwd" if name == "fwd" else "bwd"
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
                             "" if base == "fwd" else " (FFMA route: fp32, head_dim 32, "
                             "strides TMA cannot read)"),
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
            "library": ("scaled_dot_product_attention forward" if name == "fwd" else
                        "scaled_dot_product_attention backward (dq, dk and dv together)"),
            "gflop": flop / 1e9,
            "mbytes": nbytes / 1e6,
            "shape": list(FLASH_PATH),
            "dtype": "bfloat16",
        }
        if name == "fwd":
            rec["lse_max_abs_err"] = lse_err
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
    for base in ("dq", "dkv"):
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
    dq and dkv (FFMA), dq_tc and dkv_tc (tensor cores)."""
    from cs744_pytorch_distributed_tutorial_tpu_torch.ops import flash_attention as A

    return {name + ("_tc" if route == "tc" else ""): A.launch_count(name, route=route)
            for name in A.KERNELS for route in A.ROUTES if name != "fwd" or route == "ffma"}


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
    # one eval batch; 384 train, 24 distinct batches) per layer, the
    # backward's dq and dk/dv all on the tensor cores; one fused
    # cross-entropy forward and backward a training step on the fp32
    # logits (the eval takes plain CE, as the JAX package's).
    expect = {"fwd": layers * (LM_STEPS + 1), "dq": 0, "dkv": 0, "dq_tc": layers * LM_STEPS,
              "dkv_tc": layers * LM_STEPS}
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
    names = ("fwd", "dq", "dkv", "dq_tc", "dkv_tc")
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
    """The flash backward's tensor-core route against its FFMA route over
    LM_ROUTE_STEPS AdamW steps (lr LM_ROUTE_LR) of GPT-2-small at full
    width and 2 layers, batch 4 x T 1024, bf16 compute (the LM path's
    dtype, where the routes differ), from one init on the same batches;
    each run's launches show its route. Limits as the MoE route
    trajectory's: losses within rtol 1e-4; the first step's gradient norm
    (same weights) within rtol 1e-4; the parameters within 2 x lr a step at
    most (AdamW moves an element by about lr whatever its gradient's size,
    so one whose gradient's sign rests on rounding may step the other way)
    and 1e-4 on average. A third run through the plain versions of dq and
    dk/dv (fp32 einsums: a third order of the same sums) is printed beside
    them as the yardstick. Returns each run's flash launches."""
    from cs744_pytorch_distributed_tutorial_tpu_torch.data import synthetic_tokens
    from cs744_pytorch_distributed_tutorial_tpu_torch.ops import flash_attention as A
    from cs744_pytorch_distributed_tutorial_tpu_torch.train.lm import LMTrainer

    b, layers = 4, 2
    toks = synthetic_tokens(b * LM_ROUTE_STEPS, LM_WIDTH["seq_len"], LM_WIDTH["vocab_size"],
                            seed=6)
    routes = {"tensor_cores": contextlib.nullcontext, "ffma": flash_ffma_route,
              "plain": plain_flash_backward}
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
    want = {"tensor_cores": {"fwd": n, "dq_tc": n, "dkv_tc": n},
            "ffma": {"fwd": n, "dq": n, "dkv": n}, "plain": {"fwd": n}}
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
    print(f"trajectory LM flash backward tensor-core vs FFMA route (2 layers, full width, batch "
          f"{b}, bf16): {summary}; launches {launches}")
    return launches

# ------------------------------------------------------------ paged attention
def paged_inputs(gen: torch.Generator, case: tuple, variant: str) -> dict:
    """Pools, a shuffled table, ragged depths (slot 0 at depth 0), and every
    page a slot does not hold live: NaN in the float pools, or in the scale
    pools of int8 ones; the plain version is given the values before."""
    dtype, q_dtype = PAGED_VARIANTS[variant]
    b, hq, hkv, d, ps, ppr = case
    dev = gen.device
    num_pages = b * ppr + 1
    table = (1 + torch.randperm(num_pages - 1, generator=gen, device=dev)).view(b, ppr)
    table = table.to(torch.int32)
    pos = torch.randint(0, ppr * ps, (b,), generator=gen, device=dev)
    pos = pos.to(torch.int32)
    pos[0] = 0
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
    return {"q": q, "table": table, "pos": pos, "kernel": kernel, "plain": plain}


def paged_phase(dev: torch.device) -> dict:
    """The kernel against the gather path, then its times at the serving
    shape in bf16 and int8 pages with bf16 q (the serving path's
    variants).

    fp32 outputs must lie within 2e-5 of the plain version's. A bf16
    output may differ by one bf16 ulp of the plain value (2^-7 of it),
    since both round their fp32 result, plus 2^-8 S, S = sum_i p_i |v_i|
    (the plain version over |V|): with float pools both sides round each
    probability to bf16 before PV, to within 2^-8 of it, the kernel
    exp(s - running max) and the plain version the normalised p, so the
    two sums differ by a few parts in 2^-8 S (1e-6 is added for outputs
    of 0). At depths of 100-511 S is about 0.8, and one key dropped or
    counted twice moves some output of its slot by more than that limit."""
    import torch.nn.functional as F

    from cs744_pytorch_distributed_tutorial_tpu_torch.ops import paged_attention as PA
    from cs744_pytorch_distributed_tutorial_tpu_torch.parallel.ring_attention import gather_pages

    gen = torch.Generator(device=dev).manual_seed(5)
    err, worst = {}, {}
    for case in PAGED_CASES:
        for variant in PAGED_VARIANTS:
            x = paged_inputs(gen, case, variant)
            q, table, pos = x["q"], x["table"], x["pos"]
            kern, plain = x["kernel"], x["plain"]
            got = PA.paged_attention(q, kern.pop("key_pages"), kern.pop("value_pages"), table,
                                     pos, **kern)
            kp, vp = plain.pop("key_pages"), plain.pop("value_pages")
            want = PA.paged_attention_plain(q, kp, vp, table, pos, **plain)
            torch.cuda.synchronize()
            e = float((got.float() - want.float()).abs().max())
            if want.dtype == torch.float32:
                limit = torch.full_like(want, PAGED_FP32_TOL)
            else:
                wide = (lambda t: t) if kp.dtype == torch.int8 else torch.Tensor.float
                spread = PA.paged_attention_plain(q.float(), wide(kp), wide(vp).abs(), table,
                                                  pos, **plain)
                limit = 2**-7 * want.float().abs() + 2**-8 * spread + 1e-6
            ratio = float(((got.float() - want.float()).abs() / limit).max())
            if got.dtype != want.dtype or not (math.isfinite(e) and ratio <= 1.0):
                raise RuntimeError(f"paged attention kernel disagrees with its plain version at "
                                   f"{case} {variant}: max abs err {e}, {ratio} of the limit, "
                                   f"dtype {got.dtype}")
            err[variant] = max(err.get(variant, 0.0), e)
            worst[variant] = max(worst.get(variant, 0.0), ratio)
    print(f"paged attention: {len(PAGED_CASES)} shapes x {tuple(PAGED_VARIANTS)} (pool/q) agree "
          f"with the gather path, dead pages NaN; max abs err {err}; largest share of the limit "
          f"{worst} (limit: {PAGED_FP32_TOL} fp32; 2^-7 |plain| + 2^-8 sum p|v| + 1e-6 bf16)")

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
        t = {
            "ms": median_ms(lambda: PA.paged_attention(q, kp, vp, table, pos, **scales)),
            "device_ms": device_busy_ms(lambda: PA.paged_attention(q, kp, vp, table, pos,
                                                                   **scales),
                                        match="paged_decode_kernel"),
            "plain_ms": median_ms(lambda: PA.paged_attention_plain(q, kp, vp, table, pos,
                                                                   **scales)),
            "bound_ms": max(bytes_ms, ops_ms),
            "bound_by": "bytes" if bytes_ms >= ops_ms else "operations",
            "live_rows": keys, "mbytes": nbytes / 1e6, "max_pos": int(pos.max()),
        }
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
              f"{t['max_pos']}), {nbytes / 1e6:.3f} MB: kernel {t['ms']:.4f} ms (device "
              f"{t['device_ms']} ms), plain {t['plain_ms']:.4f} ms"
              + (f", gather + SDPA {t['library_ms']:.4f} ms (device {t['library_device_ms']} ms)"
                 if "library_ms" in t else "")
              + f", bound {t['bound_ms']:.5f} ms ({t['bound_by']})")
    main_t = timed["bfloat16"]
    return {
        "name": "paged_attention",
        "route": "cuda",
        "source": "cs744_pytorch_distributed_tutorial_tpu_torch/csrc/paged_attention.cu",
        "replaces": "cs744_pytorch_distributed_tutorial_tpu/ops/paged_attention.py:74",
        "tpu_kernel": "ops/paged_attention.py::_decode_kernel",
        "launches": None,  # filled in from the serving path's run
        "max_abs_err": max(err.values()),
        "max_abs_err_by_variant": err,
        "share_of_limit_by_variant": worst,
        **{k: main_t[k] for k in ("ms", "device_ms", "plain_ms", "bound_ms", "bound_by")},
        "library_ms": main_t["library_ms"],
        "library_device_ms": main_t["library_device_ms"],
        "library": "gather_pages + repeat_interleave + scaled_dot_product_attention (per-slot mask)",
        "shape": list(PAGED_SERVE), "dtype": "bfloat16",
        "int8_bf16q": timed["int8_bf16q"],
    }


# ---------------------------------------------------------- int8 weight matmul
def int8_matmul_phase(dev: torch.device) -> dict:
    from cs744_pytorch_distributed_tutorial_tpu_torch.ops import quant as QT

    gen = torch.Generator(device=dev).manual_seed(6)
    bw, fp32_flops = card_rates(torch.cuda.get_device_name(0))
    err, rel, timed = 0.0, 0.0, {}
    for label, (m, k, n) in INT8_SHAPES.items():
        q, scale = QT.quantize_int8(randn(gen, k, n))
        x32 = randn(gen, m, k)
        for dtype in (torch.float32, torch.bfloat16):
            x = x32.to(dtype)
            got, want = QT.int8_matmul(x, q, scale), QT.int8_matmul_plain(x, q, scale)
            torch.cuda.synchronize()
            diff = (got.float() - want.float()).abs()
            top = float(want.float().abs().max())
            if dtype == torch.float32:
                ok = float(diff.max()) <= 1e-5 * top
            else:
                ok = bool((diff <= 2**-7 * want.float().abs() + 1e-5 * top).all())
            if got.dtype != dtype or not ok:
                raise RuntimeError(f"int8_matmul kernel disagrees with its plain version at "
                                   f"{label} [{m},{k}]x[{k},{n}] {dtype}: max abs err "
                                   f"{float(diff.max())}, max|plain| {top}")
            err = max(err, float(diff.max()))
            rel = max(rel, float(diff.max()) / top)
            del got, want, diff
        xb = x32.bfloat16()
        nbytes = k * n + 2.0 * m * k + 2.0 * m * n + 4.0 * n
        flop = 2.0 * m * k * n
        bytes_ms, ops_ms = nbytes / bw * 1e3, flop / BF16_FLOPS * 1e3
        t = {
            "shape": [m, k, n], "dtype": "bfloat16",
            "ms": median_ms(lambda: QT.int8_matmul(xb, q, scale)),
            "device_ms": device_busy_ms(lambda: QT.int8_matmul(xb, q, scale),
                                        match="int8_matmul_kernel"),
            "fp32_ms": median_ms(lambda: QT.int8_matmul(x32, q, scale)),
            "plain_ms": median_ms(lambda: QT.int8_matmul_plain(xb, q, scale), reps=10),
            "library_ms": median_ms(lambda: torch.matmul(xb, q.to(xb.dtype)) * scale),
            "bound_ms": max(bytes_ms, ops_ms),
            "bound_by": "bytes" if bytes_ms >= ops_ms else "operations",
            "fp32_ffma_bound_ms": flop / fp32_flops * 1e3,
            "gflop": flop / 1e9, "mbytes": nbytes / 1e6,
        }
        t["bound_share"] = t["bound_ms"] / t["ms"]
        timed[label] = t
        print(f"int8_matmul {label} [{m},{k}]x[{k},{n}] bf16: {flop / 1e9:.2f} GFLOP, "
              f"{nbytes / 1e6:.1f} MB; kernel {t['ms']:.4f} ms (device {t['device_ms']} ms; "
              f"fp32 x {t['fp32_ms']:.4f} ms), plain {t['plain_ms']:.4f} ms, torch.matmul on the "
              f"widened weight {t['library_ms']:.4f} ms, bound {t['bound_ms']:.4f} ms "
              f"({t['bound_by']}; {100 * t['bound_share']:.2f} % of it), FP32 FFMA floor "
              f"{t['fp32_ffma_bound_ms']:.4f} ms")
        del q, scale, x32, xb
    print(f"int8_matmul: {len(INT8_SHAPES)} shapes x (fp32, bf16) agree with the plain version, "
          f"max abs err {err}, / max|plain| {rel:.3e} (tolerance 1e-5 x max|plain| fp32; 1 bf16 "
          f"ulp + 1e-5 x max|plain| bf16)")
    d = timed["decode"]
    return {
        "name": "int8_matmul",
        "route": "cuda",
        "source": "cs744_pytorch_distributed_tutorial_tpu_torch/csrc/int8_matmul.cu",
        "replaces": "cs744_pytorch_distributed_tutorial_tpu/ops/quant.py:101",
        "tpu_kernel": "ops/quant.py::_kernel",
        "launches": None,  # filled in from the generation path's run
        "max_abs_err": err,
        "max_rel_err": rel,
        **{k: d[k] for k in ("ms", "device_ms", "plain_ms", "bound_ms", "bound_by",
                             "library_ms", "fp32_ffma_bound_ms")},
        "library": "torch.matmul(x, q.to(x.dtype)) * scale",
        "shape": d["shape"], "dtype": "bfloat16",
        "prefill": timed["prefill"],
    }


# ---------------------------------------------------------------- generation
def width_argv(**extra) -> list[str]:
    dims = {**DECODE_WIDTH, **extra}
    return [arg for key, value in dims.items() for arg in (f"--{key.replace('_', '-')}",
                                                          str(value))]


def generation_phase() -> int:
    """``lm_cli --generate`` at full width: int8 head (the main path), bf16,
    and int8 head with an int8 KV cache. Returns the int8 launches of the
    main path."""
    from cs744_pytorch_distributed_tutorial_tpu_torch import lm_cli

    base = width_argv() + [
        "--use-rope", "--compute-dtype", "bfloat16", "--steps", "0", "--seq-len",
        str(GEN_PROMPT), "--num-seqs", str(GEN_BATCH), "--generate", str(GEN_NEW),
        "--prompt-len", str(GEN_PROMPT), "--generate-batch", str(GEN_BATCH),
        "--temperature", "0", "--json", "--device", "cuda"]
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
        want_int8 = GEN_NEW if flags else 0  # one launch a model call: prefill + 127 steps
        if counts["int8_matmul"] != want_int8 or others(counts, "int8_matmul"):
            raise RuntimeError(f"generation {label}: launches {counts}, expected "
                               f"{want_int8} int8_matmul and no other")
        runs[label] = (toks, counts)
        print(f"generation {label}: batch {GEN_BATCH}, prompt {GEN_PROMPT}, {GEN_NEW} new "
              f"tokens: {g['tokens_per_s']:.1f} tokens/s, prefill {g['prefill_ms']:.2f} ms, "
              f"{g['decode_ms_per_step']:.3f} ms a decode step; launches {counts}")
    base_toks = runs["bf16"][0]
    for label in ("int8 head", "int8 head + int8 KV cache"):
        share = float((runs[label][0] == base_toks).float().mean())
        print(f"generation: {label} keeps {100 * share:.2f} % of the bf16 run's greedy tokens")
    return runs["int8 head"][1]["int8_matmul"]


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


def serve_summary(text: str) -> dict:
    recs = [json.loads(line) for line in text.strip().splitlines() if line.startswith("{")]
    return next(r for r in recs if r.get("kind") == "serve_summary")


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
    want = DECODE_WIDTH["num_layers"] * s["decode_steps_all"]
    if counts["paged_attention"] != want or others(counts, "paged_attention",
                                                    "paged_attention_int8"):
        raise RuntimeError(f"serving: launches {counts}, expected {want} paged (12 x "
                           f"{s['decode_steps_all']} decode steps) and no other")
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
    """Kernel vs gather engines on the trace; the pool-pressure run; a
    profile of 20 decode steps."""
    from cs744_pytorch_distributed_tutorial_tpu_torch.serve import (
        ServeConfig,
        ServingEngine,
        make_poisson_workload,
        run_poisson,
    )

    trace = make_poisson_workload(vocab_size=DECODE_WIDTH["vocab_size"], **SERVE_TRACE)
    model = decode_model()
    kernel_out, ks = serve_tokens(model, "kernel", trace, SERVE_GEOMETRY)
    gather_out, gs = serve_tokens(model, "gather", trace, SERVE_GEOMETRY)
    same = sum(a == b for k, g in zip(kernel_out, gather_out) for a, b in zip(k, g))
    total = sum(len(k) for k in kernel_out)
    first = [next((i for i, (a, b) in enumerate(zip(k, g)) if a != b), None)
             for k, g in zip(kernel_out, gather_out)]
    diverged = [i for i in first if i is not None]
    print(f"serving kernel vs gather engine (trace submitted at once): {same} of {total} greedy "
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
    n = SERVE_TRACE["num_requests"]
    if s["completed"] != n or s["preemptions"] <= 0:
        raise RuntimeError(f"pool-pressure run: {s}")
    want = {"paged_attention": layers * s["decode_steps_all"],
            "int8_matmul": s["decode_steps_all"] + s["prefills_all"]}
    if (counts["paged_attention"] != want["paged_attention"]
            or counts["int8_matmul"] != want["int8_matmul"]
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
    out = summarize_profile(prof, steps, "decode profile", {"paged": ("paged_decode_kernel",)})
    if not out:
        return {}
    out.update(active_slots=SERVE_GEOMETRY["num_slots"],
               wall_ms_per_step_profiled=wall / steps * 1e3,
               paged_share_of_busy=out["paged_ms_per_step"] / out["device_busy_ms_per_step"])
    print(json.dumps({"decode_profile": out}))
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


def gmm_phase(dev: torch.device) -> dict:
    """The kernel against its plain version at the MoE path's shapes (group
    sizes from the router's top-2 on random tokens) and a ragged one, both
    activations, bf16 and fp32: fp32 within 1e-5 x max|plain| (the sums in
    another order), bf16 within one ulp of each plain value plus 1e-5 x
    max|plain|. Then the times of the main path's bf16 calls, and one MoE
    layer's forward with host synchronisation made an error."""
    from cs744_pytorch_distributed_tutorial_tpu_torch.models.moe import MoEFFN
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
        m, k, n, ragged = GMM_RAGGED
        args = (randn(gen, m, k), randn(gen, len(ragged), k, n) / k**0.5,
                randn(gen, len(ragged), n), torch.tensor(ragged, device=dev))
        cases["ragged gelu"] = (*args, "gelu")
        cases["ragged"] = (*args, "none")

    err, worst = 0.0, 0.0
    for label, (lhs, rhs, bias, sizes, act) in cases.items():
        for dtype in (torch.bfloat16, torch.float32):
            a, b = lhs.to(dtype), rhs.to(dtype)
            got = G.grouped_matmul_fused(a, b, bias, sizes, activation=act)
            want = G.grouped_matmul_fused_plain(a, b, bias, sizes, activation=act)
            torch.cuda.synchronize()
            diff = (got.float() - want.float()).abs()
            top = float(want.float().abs().max())
            if dtype == torch.float32:
                share = float(diff.max()) / (1e-5 * top)
            else:
                share = float((diff / (2**-7 * want.float().abs() + 1e-5 * top)).max())
            if got.dtype != dtype or not (math.isfinite(share) and share <= 1.0):
                raise RuntimeError(f"gmm_fused kernel disagrees with its plain version at "
                                   f"{label} {dtype} {list(a.shape)}x{list(b.shape)}: max abs "
                                   f"err {float(diff.max())}, {share} of the limit")
            err, worst = max(err, float(diff.max())), max(worst, share)
            print(f"gmm_fused {label} {dtype} [{a.shape[0]}, {a.shape[1]}] x "
                  f"{list(b.shape)}: max abs err {float(diff.max())} ({share:.3f} of the limit)")
    print(f"gmm_fused: {len(cases)} cases x (bf16, fp32) agree with the plain version, max abs "
          f"err {err}, largest share of the limit {worst:.3f} (limit: 1e-5 x max|plain| fp32; "
          f"one bf16 ulp + 1e-5 x max|plain| bf16)")

    bw, fp32_flops = card_rates(torch.cuda.get_device_name(0))
    timed = {}
    for label in ("prefill w_in gelu", "prefill w_out", "decode w_in gelu", "decode w_out"):
        lhs, rhs, bias, sizes, act = cases[label]
        (mm, kk), nn_ = lhs.shape, rhs.shape[2]
        hit = int((sizes > 0).sum())  # experts with rows: their weights are read
        nbytes = 2.0 * mm * kk + 2.0 * hit * kk * nn_ + 4.0 * hit * nn_ + 4.0 * e + 2.0 * mm * nn_
        flop = 2.0 * mm * kk * nn_
        bytes_ms, ops_ms = nbytes / bw * 1e3, flop / BF16_FLOPS * 1e3
        library, reason = gmm_library(lhs, rhs, bias, sizes, act)
        kernel = lambda: G.grouped_matmul_fused(lhs, rhs, bias, sizes, activation=act)  # noqa: E731
        t = {
            "shape": [mm, kk, nn_], "groups_hit": hit, "activation": act, "dtype": "bfloat16",
            "ms": median_ms(kernel),
            "device_ms": device_busy_ms(kernel, match="gmm_fused_kernel"),
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
        t["bound_share"] = t["bound_ms"] / t["ms"]
        timed[label] = t
        print(f"gmm_fused {label} [{mm}, {kk}] x [{e}, {kk}, {nn_}] bf16 ({hit} experts hit): "
              f"{flop / 1e9:.3f} GFLOP, {nbytes / 1e6:.2f} MB; kernel {t['ms']:.4f} ms (device "
              f"{t['device_ms']} ms; fp32 {t['fp32_ms']:.4f} ms), plain {t['plain_ms']:.4f} ms, "
              f"{t['library']} {t['library_ms']} ms (device {t['library_device_ms']} ms), bound "
              f"{t['bound_ms']:.5f} ms ({t['bound_by']}; {100 * t['bound_share']:.2f} % of it), "
              f"FP32 FFMA floor {t['fp32_ffma_bound_ms']:.4f} ms")

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

    def layer_total(key, phase):
        vals = [timed[f"{phase} w_in gelu"][key], timed[f"{phase} w_out"][key]]
        return None if None in vals else sum(vals)

    return {
        "name": "gmm_fused",
        "route": "cuda",
        "source": "cs744_pytorch_distributed_tutorial_tpu_torch/csrc/gmm.cu",
        "replaces": "cs744_pytorch_distributed_tutorial_tpu/ops/gmm.py:278",
        "tpu_kernel": "ops/gmm.py::_gmm_fused_kernel (the undifferentiated forward, without "
                      "with_z; with it: the gmm_fused_with_z record)",
        "launches": None,  # filled in from the MoE generation path's run
        "max_abs_err": err,
        "share_of_limit": worst,
        **{key: layer_total(key, "decode") for key in (
            "ms", "device_ms", "plain_ms", "bound_ms", "library_ms", "fp32_ffma_bound_ms")},
        "bound_by": "bytes" if all(timed[f"decode {c}"]["bound_by"] == "bytes"
                                   for c in ("w_in gelu", "w_out")) else "operations",
        "library": timed["decode w_in gelu"]["library"],
        "work": "one MoE layer's two calls at a decode step (16 tokens, top-2)",
        "prefill_layer": {key: layer_total(key, "prefill") for key in (
            "ms", "device_ms", "plain_ms", "bound_ms", "library_ms", "fp32_ffma_bound_ms")},
        "calls": timed,
    }


# ------------------------------------------------------------ MoE generation
def moe_generation_phase() -> int:
    """``lm_cli --generate 128`` on the MoE LM (the main path); returns its
    gmm_fused launches. Then prefill + MOE_DECODE_STEPS decode steps
    against the full forward, and a profile of 5 decode steps."""
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
    want = 2 * MOE_WIDTH["num_layers"] * GEN_NEW  # w_in and w_out a layer, a model call
    per_kernel = {k: G.launch_count(k) for k in G.KERNELS}
    if (counts["gmm_fused"] != want or per_kernel["fused"] != want
            or others(counts, "gmm_fused")):
        raise RuntimeError(f"MoE generation: launches {counts}, grouped-matmul kernels "
                           f"{per_kernel}; expected {want} gmm_fused without z and no other")
    print(f"MoE generation: batch {GEN_BATCH}, prompt {GEN_PROMPT}, {GEN_NEW} new tokens: "
          f"{g['tokens_per_s']:.1f} tokens/s, prefill {g['prefill_ms']:.2f} ms, "
          f"{g['decode_ms_per_step']:.3f} ms a decode step; {wall:.1f} s wall with model build; "
          f"launches {counts}")
    moe_decode_checks()
    return counts["gmm_fused"]


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
    out = summarize_profile(prof, steps, "MoE decode profile", {"gmm": ("gmm_fused_kernel",)})
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
    names = ("gmm", "tgmm", "gmm_tc", "tgmm_tc", "split", "colsum", "fused_z")
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
                _, z = via({"fused_z": 1}, lambda: G._fused(a, w, bias, gs, "gelu", None, True))
                _, z_plain = G.grouped_matmul_fused_plain(a, w, bias, gs, activation="gelu",
                                                          with_z=True)
                check("fused_z", z, z_plain, dtype, label)
                del dw, z, z_plain, want_g, want_t
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
            calls["fused_z"] = (
                lambda: G._fused(a, w, bias, gs, "gelu", None, True),
                median_ms(lambda: G.grouped_matmul_fused_plain(a, w, bias, gs, activation="gelu",
                                                               with_z=True), reps=3, warmup=1),
                2.0 * m * k + 2.0 * e * k * n + 4.0 * e * n + 4.0 * e + 2 * 2.0 * m * n,
                flop, BF16_FLOPS, "fused_z", None)
        libs = {}
        for lib_name in ("gmm", "tgmm", "colsum"):
            libs[lib_name] = gmm_bwd_library(lib_name, a, w, dp, gs)
        fz_lib, fz_reason = gmm_library(a, w, bias, gs, "gelu")
        libs["fused_z"] = (fz_lib, fz_reason, "torch._grouped_mm + row bias + gelu (bf16, no z)")
        libs[None] = (None, "no single PyTorch call makes the pieces", None)
        route_ms = {}
        for name in ("gmm_tc", "gmm", "tgmm_tc", "tgmm"):  # in turn, then again reversed
            route_ms[name] = [median_ms(calls[name][0])]
        for name in ("tgmm", "tgmm_tc", "gmm", "gmm_tc"):
            route_ms[name].append(median_ms(calls[name][0]))
        for name, (kernel, plain_ms, nbytes, flop_, peak, lib_name, npieces) in calls.items():
            library, reason, lib_label = libs[lib_name]
            bytes_ms, ops_ms = nbytes / bw * 1e3, flop_ / peak * 1e3
            kname = {"gmm": "gmm_fused_kernel", "fused_z": "gmm_fused_kernel",
                     "gmm_tc": "::gmm_tc_kernel", "tgmm_tc": "::tgmm_tc_kernel"}.get(
                         name, f"{name}_kernel")
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
        for fn_name in ("gmm", "tgmm"):
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
                                             "gelu forward)")}
    records = []
    for name in names:
        calls = timed[name]

        def total(key, calls=calls):
            vals = [c.get(key) for c in calls.values()]
            return None if None in vals else sum(vals)

        line, source, what = replaces[name]
        records.append({
            "name": "gmm_fused_with_z" if name == "fused_z" else name,
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
    launches (6 w_in with z, 6 w_out without), its backward 12 gmm_tc and
    12 tgmm_tc (w_in's fp32 dz in three pieces, split once a layer: 6
    split; w_out's bf16 gradient in one), no FFMA gmm or tgmm, and 12
    colsum (the bias gradient has a launch of its own); flash 6 forward, 6
    dq and 6 dk/dv, all on the tensor cores; the eval batch 12 gmm_fused
    without z and 6 flash forwards."""
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
    want_gmm = {"fused": layers * (steps + 2), "fused_z": layers * steps, "gmm": 0, "tgmm": 0,
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
    want_flash = {"fwd": layers * (steps + 1), "dq": 0, "dkv": 0, "dq_tc": layers * steps,
                  "dkv_tc": layers * steps}
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
    groups = {"gmm": ("gmm_fused_kernel", "tgmm_kernel", "colsum_kernel", "gmm_tc_kernel",
                      "split_kernel"),
              "gmm_forward": ("gmm_fused_kernel<__nv_bfloat16",),
              "gmm_tc": ("::gmm_tc_kernel",), "tgmm_tc": ("::tgmm_tc_kernel",),
              "split": ("split_kernel",), "gmm_ffma": ("gmm_fused_kernel<float",),
              "tgmm": ("tgmm_kernel",), "colsum": ("colsum_kernel",),
              "flash": ("flash_fwd_kernel", "flash_dq_kernel", "flash_dkv_kernel",
                        "flash_dq_tc_kernel", "flash_dkv_tc_kernel"),
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


@contextlib.contextmanager
def plain_grouped_matmuls():
    """The grouped-matmul autograd Functions through the plain versions on
    CUDA tensors (the module functions they call, patched for the block),
    for a kernel-vs-plain trajectory."""
    from cs744_pytorch_distributed_tutorial_tpu_torch.ops import gmm as G

    saved = {name: getattr(G, name)
             for name in ("_fused", "gmm", "tgmm", "segment_sum_rows", "split_bf16")}

    def fused(lhs, rhs, bias, group_sizes, activation, out_dtype, with_z):
        res = G.grouped_matmul_fused_plain(lhs, rhs, bias, group_sizes, activation=activation,
                                           out_dtype=out_dtype, with_z=with_z)
        return res if with_z else (res, None)

    G._fused, G.segment_sum_rows, G.split_bf16 = fused, G.segment_sum_rows_plain, G.split_bf16_plain
    G.gmm = lambda lhs, rhs, gs, *, trans_rhs=False, split=None: G.grouped_matmul_plain(
        lhs, rhs, gs, trans_rhs=trans_rhs)
    G.tgmm = lambda lhs, dout, gs, *, split=None: G.tgmm_plain(lhs, dout, gs)
    try:
        yield
    finally:
        for name, fn in saved.items():
            setattr(G, name, fn)


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


@contextlib.contextmanager
def ffma_route():
    """The grouped-matmul backward on the FFMA kernels whatever the
    operands (the route rule, patched for the block to take no tensor-core
    call), for a route-vs-route trajectory."""
    from cs744_pytorch_distributed_tutorial_tpu_torch.ops import gmm as G

    saved = G.tc_pieces
    G.tc_pieces = lambda *args, **kw: 0
    try:
        yield
    finally:
        G.tc_pieces = saved


def moe_route_trajectory_phase() -> None:
    """The tensor-core route against the FFMA route over MOE_TRAJ_STEPS
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
    if not (tc.get("gmm_tc") == tc.get("tgmm_tc") == n and not {"gmm", "tgmm"} & set(tc)
            and ffma.get("gmm") == ffma.get("tgmm") == n
            and not {"gmm_tc", "tgmm_tc", "split"} & set(ffma)):
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


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is False; this script "
              "needs an NVIDIA card", file=sys.stderr)
        return 1
    from cs744_pytorch_distributed_tutorial_tpu_torch.ops import _build
    from cs744_pytorch_distributed_tutorial_tpu_torch.ops import flash_attention as A
    from cs744_pytorch_distributed_tutorial_tpu_torch.ops import fused_conv as C
    from cs744_pytorch_distributed_tutorial_tpu_torch.ops import fused_sgd as K
    from cs744_pytorch_distributed_tutorial_tpu_torch.ops import fused_xent as FX
    from cs744_pytorch_distributed_tutorial_tpu_torch.ops import gmm as G
    from cs744_pytorch_distributed_tutorial_tpu_torch.ops import paged_attention as PA
    from cs744_pytorch_distributed_tutorial_tpu_torch.ops import quant as QT

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
    modules = (K, C, A, PA, QT, FX, G)
    sources = [src for module in modules for src in getattr(module, "SOURCES", (module.SOURCE,))]
    _build.build_all(sources)
    for module in modules:
        module.load_kernel()
    print("built " + ", ".join(f"{s} in {_build.build_seconds[s]:.2f} s" for s in sources)
          + f", in parallel (wall {time.perf_counter() - t0:.2f} s)")
    for src in (A.TC_SOURCE, G.TC_SOURCE):  # the tensor-core kernels' registers and spills
        for kernel, usage in _build.ptxas_report(src).items():
            print(f"ptxas {src}: {kernel}: {usage['registers']} registers, "
                  f"{usage['spill_stores']} bytes spill stores, {usage['spill_loads']} bytes "
                  f"spill loads")

    records = [fused_sgd_phase(dev), *wgrad_phase(dev)]
    counts = main_path_phase("resnet18", ("--fast-conv", "--fused-optimizer"), {
        "fused_sgd": RESNET18_TENSORS * STEPS,
        "conv3x3_wgrad_s1": RESNET18_ROUTED * STEPS,
        "conv3x3_wgrad_s2": 0,
    })
    vgg_counts = main_path_phase("vgg11", ("--fused-optimizer",), {
        "fused_sgd": VGG11_TENSORS * STEPS,
        "conv3x3_wgrad_s1": 0,
        "conv3x3_wgrad_s2": 0,
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

    lm_records = flash_phase(dev) + fused_xent_phase(dev)
    lm_counts = lm_main_path_phase()
    for rec in lm_records:
        rec["launches"] = lm_counts[rec["name"]]
    records += lm_records
    lm_throughput_phase()
    lm_trajectory_phase()
    route_launches = lm_flash_route_trajectory_phase()
    for rec in lm_records:  # the FFMA backward's launches, off the bf16 main path
        if rec["name"] in ("flash_dq", "flash_dkv"):
            rec["launches_ffma_route_trajectory"] = route_launches["ffma"][rec["name"][6:]]

    paged_record = paged_phase(dev)
    int8_record = int8_matmul_phase(dev)
    int8_record["launches"] = generation_phase()
    paged_record["launches"] = serving_phase()
    records += [paged_record, int8_record]
    serving_checks_phase()

    gmm_record = gmm_phase(dev)
    gmm_record["launches"] = moe_generation_phase()
    records.append(gmm_record)

    bwd_records = gmm_backward_phase(dev)
    train_counts = moe_train_path_phase()
    for rec in bwd_records:
        rec["launches"] = train_counts[rec.pop("kernel")]
    records += bwd_records
    moe_train_throughput_phase()
    moe_train_trajectory_phase()
    moe_route_trajectory_phase()
    moe_scatter_phase()

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
