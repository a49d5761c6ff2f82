"""Smoke run of the PyTorch/CUDA port on one NVIDIA card.

    python3 chip_smoke.py

Phases, each raising on failure (the script then exits nonzero and prints
no result):

1. setup: the card, its power limit, torch/CUDA versions, TF32 settings,
   and the build of every kernel from ``csrc/`` (one ``nvcc`` per source,
   all started together);
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
   non-causal and ragged shapes, fp32 and bf16), then their times at the
   path's shape in bf16 beside their bounds, the plain versions' and
   ``scaled_dot_product_attention``'s forward and backward;
9. the LM main path through the port's ``lm_cli``: GPT-2-small at full
   width (12 layers, d 768, 12 heads, vocab 50304, T 1024, batch 16, RoPE,
   bf16, AdamW, ``--attention-impl flash``), 24 steps and one eval batch,
   every launch count zeroed just before and read just after;
10. its throughput (``LMTrainer.train_step``, tokens/s and MFU) with flash
    and with dense attention, a flash-vs-dense trajectory (2 layers at full
    width, fp32, TF32 off), and a profile of one flash step.

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


def device_busy_ms(fn, reps: int = 10, match: str | None = None) -> float | None:
    """Kernel time on the card per call of ``fn`` (the sum of its kernels'
    durations from a torch.profiler trace, only those whose name holds
    ``match`` if given), without the host's launch gaps; None when the
    profiler records no device activity."""
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(reps):
            fn()
        torch.cuda.synchronize()
    total_us = sum(
        e.time_range.elapsed_us()
        for e in device_kernels(prof)
        if match is None or match in e.name
    )
    return total_us / reps / 1e3 if total_us else None


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
    from cs744_pytorch_distributed_tutorial_tpu_torch.ops import fused_sgd as K

    K.reset_launch_count()
    C.reset_launch_count()
    summary = run_cli(argv)
    counts = {
        "fused_sgd": K.launch_count(),
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
    kernels = device_kernels(prof)
    if not kernels:
        print(f"profile {model}: torch.profiler recorded no device activity")
        return {}
    busy = sum(e.time_range.elapsed_us() for e in kernels)
    span = max(e.time_range.end for e in kernels) - min(e.time_range.start for e in kernels)
    by_name: dict[str, float] = {}
    for e in kernels:
        by_name[e.name] = by_name.get(e.name, 0.0) + e.time_range.elapsed_us()
    top = sorted(by_name.items(), key=lambda kv: -kv[1])[:10]
    steps = len(batches) - 3

    def ms_of(*keys):
        return sum(v for k, v in by_name.items() if any(s in k for s in keys)) / steps / 1e3

    out = {
        "model": model, **cfg_kw,
        "steps": steps,
        "device_busy_ms_per_step": busy / steps / 1e3,
        "span_ms_per_step": span / steps / 1e3,
        "wall_ms_per_step_profiled": wall / steps * 1e3,
        "idle_share": 1.0 - busy / span,
        "kernels_per_step": len(kernels) / steps,
        "fused_sgd_ms_per_step": ms_of("fused_sgd"),
        "wgrad_kernel_ms_per_step": ms_of("wgrad_kernel", "sum_splits_kernel"),
        "top_kernels_ms_per_step": {k[:90]: v / steps / 1e3 for k, v in top},
    }
    print(json.dumps({"step_profile": out}))
    return out


# ---------------------------------------------------------- flash attention
def flash_phase(dev: torch.device) -> list[dict]:
    """The three kernels against their plain versions (each kernel given
    the plain lse and delta, so each is checked on its own), then their
    times at the LM path's shape in bf16."""
    import torch.nn.functional as F

    from cs744_pytorch_distributed_tutorial_tpu_torch.ops import flash_attention as A

    gen = torch.Generator(device=dev).manual_seed(3)
    err = {k: 0.0 for k in A.KERNELS}
    rel = {k: 0.0 for k in A.KERNELS}
    lse_err = 0.0
    for dtype in (torch.float32, torch.bfloat16):
        for b, t, h, d, causal in FLASH_CASES:
            q, k, v, do = (randn(gen, b, t, h, d, dtype=dtype) for _ in range(4))
            out, lse = A.flash_forward_lse(q, k, v, causal)
            want_o, want_lse = A.flash_forward_lse_plain(q, k, v, causal)
            delta = A.flash_delta(want_o, do)
            dq = A.flash_dq(q, k, v, do, want_lse, delta, causal)
            dk, dv = A.flash_dkv(q, k, v, do, want_lse, delta, causal)
            want_dq = A.flash_dq_plain(q, k, v, do, want_lse, delta, causal)
            want_dk, want_dv = A.flash_dkv_plain(q, k, v, do, want_lse, delta, causal)
            torch.cuda.synchronize()
            case = f"{dtype} B{b} T{t} H{h} D{d} causal={causal}"
            e = float((lse - want_lse).abs().max())
            if not (math.isfinite(e) and e <= FLASH_LSE_TOL):
                raise RuntimeError(f"flash fwd lse disagrees with its plain version at {case}: {e}")
            lse_err = max(lse_err, e)
            for name, got, want in (("fwd", out, want_o), ("dq", dq, want_dq),
                                    ("dkv", dk, want_dk), ("dkv", dv, want_dv)):
                e = float((got.float() - want.float()).abs().max())
                scale = float(want.float().abs().max())
                if got.dtype != dtype or not (math.isfinite(e) and e <= FLASH_TOL[dtype] * scale):
                    raise RuntimeError(
                        f"flash {name} kernel disagrees with its plain version at {case}: "
                        f"max abs err {e}, max|plain| {scale}, dtype {got.dtype}")
                err[name] = max(err[name], e)
                rel[name] = max(rel[name], e / scale)
    for name in A.KERNELS:
        print(f"flash {name}: {len(FLASH_CASES)} shapes x (fp32, bf16) agree with the plain "
              f"version, max abs err {err[name]}, / max|plain| {rel[name]:.3e} (tolerance "
              f"{FLASH_TOL[torch.float32]} fp32, {FLASH_TOL[torch.bfloat16]} bf16)"
              + (f"; lse max abs err {lse_err} (tolerance {FLASH_LSE_TOL})" if name == "fwd" else ""))

    # Times at the path's shape, bf16.
    b, t, h, d, causal = FLASH_PATH
    q, k, v, do = (randn(gen, b, t, h, d, dtype=torch.bfloat16) for _ in range(4))
    out, lse = A.flash_forward_lse(q, k, v, causal)
    delta = A.flash_delta(out, do)
    calls = {
        "fwd": (lambda: A.flash_forward_lse(q, k, v, causal),
                lambda: A.flash_forward_lse_plain(q, k, v, causal)),
        "dq": (lambda: A.flash_dq(q, k, v, do, lse, delta, causal),
               lambda: A.flash_dq_plain(q, k, v, do, lse, delta, causal)),
        "dkv": (lambda: A.flash_dkv(q, k, v, do, lse, delta, causal),
                lambda: A.flash_dkv_plain(q, k, v, do, lse, delta, causal)),
    }
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
    pairs = b * h * (t * (t + 1) // 2 if causal else t * t)  # (query, key) pairs computed
    tensor_bytes = 2.0 * b * t * h * d  # one bf16 [B, T, H, D]
    row_bytes = 4.0 * b * h * t  # one fp32 [B*H, T]
    work = {  # (products of D-long rows, tensors read + written, row vectors)
        "fwd": (2, 4, 1), "dq": (3, 5, 2), "dkv": (4, 6, 2),
    }
    records = []
    for name in A.KERNELS:
        kernel, plain = calls[name]
        products, tensors, rows = work[name]
        flop = 2.0 * products * pairs * d
        nbytes = tensors * tensor_bytes + rows * row_bytes
        bytes_ms, ops_ms = nbytes / bw * 1e3, flop / BF16_FLOPS * 1e3
        lib_key = "fwd" if name == "fwd" else "bwd"
        rec = {
            "name": f"flash_{name}",
            "route": "cuda",
            "source": "cs744_pytorch_distributed_tutorial_tpu_torch/csrc/flash_attention.cu",
            "replaces": f"cs744_pytorch_distributed_tutorial_tpu/ops/flash_attention.py:"
                        f"{FLASH_REPLACES[name]}",
            "tpu_kernel": "ops/flash_attention.py::" + {"fwd": "_kernel", "dq": "_dq_kernel",
                                                        "dkv": "_dkv_kernel"}[name],
            "launches": None,  # filled in from the main path's run
            "max_abs_err": err[name],
            "max_rel_err": rel[name],
            "ms": median_ms(kernel),
            "device_ms": device_busy_ms(kernel, match=f"flash_{name}_kernel"),
            "plain_ms": median_ms(plain, reps=10, warmup=2),
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
        rec["bound_share"] = rec["bound_ms"] / rec["ms"]
        records.append(rec)
        print(f"flash {name} at B{b} T{t} H{h} D{d} causal bf16: {flop / 1e9:.2f} GFLOP, "
              f"{nbytes / 1e6:.1f} MB; kernel {rec['ms']:.4f} ms (device {rec['device_ms']} ms), "
              f"plain {rec['plain_ms']:.4f} ms, {rec['library']} {rec['library_ms']:.4f} ms "
              f"(device {rec['library_device_ms']} ms), bound {rec['bound_ms']:.4f} ms "
              f"({rec['bound_by']}; {100 * rec['bound_share']:.2f} % of it), FP32 FFMA floor "
              f"{rec['fp32_ffma_bound_ms']:.4f} ms")
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


def lm_main_path_phase() -> dict:
    from cs744_pytorch_distributed_tutorial_tpu_torch import lm_cli
    from cs744_pytorch_distributed_tutorial_tpu_torch.ops import flash_attention as A
    from cs744_pytorch_distributed_tutorial_tpu_torch.ops import fused_conv as C
    from cs744_pytorch_distributed_tutorial_tpu_torch.ops import fused_sgd as K

    argv = [arg for key, value in LM_WIDTH.items()
            for arg in (f"--{key.replace('_', '-')}", str(value))]
    argv += ["--global-batch-size", "16", "--use-rope", "--attention-impl", "flash",
             "--compute-dtype", "bfloat16", "--optimizer", "adamw", "--steps", str(LM_STEPS),
             "--num-seqs", "400", "--eval-frac", "0.04", "--json", "--device", "cuda"]
    for module in (A, C, K):
        module.reset_launch_count()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    summary = run_cli(argv, main=lm_cli.main)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    counts = {name: A.launch_count(name) for name in A.KERNELS}
    bf16 = A.launch_count(dtype=torch.bfloat16)
    if K.launch_count() or C.launch_count():
        raise RuntimeError("the LM path launched a CIFAR kernel")
    layers = LM_WIDTH["num_layers"]
    # 24 training forwards and one eval forward (400 sequences: 16 held out,
    # one eval batch; 384 train, 24 distinct batches) per layer.
    expect = {"fwd": layers * (LM_STEPS + 1), "dq": layers * LM_STEPS, "dkv": layers * LM_STEPS}
    if counts != expect or bf16 != sum(expect.values()):
        raise RuntimeError(f"LM path flash launches {counts} (bf16 {bf16}), expected {expect}")
    if summary["steps_run"] != LM_STEPS or not summary["finite"]:
        raise RuntimeError(f"LM path: {summary}")
    first, final = summary["first_loss"], summary["final_loss"]
    if not (math.isfinite(first) and math.isfinite(final) and final < first):
        raise RuntimeError(f"LM path loss did not fall: first {first}, final {final}")
    if not math.isfinite(summary["eval"]["loss"]):
        raise RuntimeError(f"LM path eval loss not finite: {summary['eval']}")
    print(f"LM main path: {LM_STEPS} steps + eval in {wall:.1f} s wall (model build and "
          f"first-step set-up included), loss {first} -> {final}, eval {summary['eval']}, "
          f"flash launches {counts}")
    return counts


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
    then LM_TIMED_STEPS timed, with flash and with dense attention; then a
    profile of 3 flash steps on pre-staged batches."""
    from cs744_pytorch_distributed_tutorial_tpu_torch.data import synthetic_tokens
    from cs744_pytorch_distributed_tutorial_tpu_torch.train.lm import LMTrainer

    b, t = 16, LM_WIDTH["seq_len"]
    toks = synthetic_tokens(4 * b, t, LM_WIDTH["vocab_size"], seed=1)
    flops = lm_flops_per_token(LM_WIDTH["num_layers"], LM_WIDTH["d_model"], LM_WIDTH["d_ff"],
                               t, LM_WIDTH["vocab_size"])
    peak = BF16_FLOPS
    out: dict = {"flops_per_token": flops}
    for impl in ("flash", "dense"):
        tr = LMTrainer(lm_config(attention_impl=impl))
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
        if impl == "flash":
            out["profile"] = lm_profile(tr, batches)
        del tr, model, params, batches
        torch.cuda.empty_cache()
    return out


def lm_profile(tr, batches) -> dict:
    """Where a flash step's device time goes: 3 steps on batches already
    on the card, traced with torch.profiler (idle share as in
    ``profile_phase``)."""
    from torch.profiler import ProfilerActivity, profile

    steps = 3
    tr.train_step(*batches[0])
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        for i in range(steps):
            tr.train_step(*batches[i % len(batches)])
        torch.cuda.synchronize()
    kernels = device_kernels(prof)
    if not kernels:
        print("profile LM: torch.profiler recorded no device activity")
        return {}
    busy = sum(e.time_range.elapsed_us() for e in kernels)
    span = max(e.time_range.end for e in kernels) - min(e.time_range.start for e in kernels)
    by_name: dict[str, float] = {}
    for e in kernels:
        by_name[e.name] = by_name.get(e.name, 0.0) + e.time_range.elapsed_us()
    flash = {name: sum(v for k, v in by_name.items() if f"flash_{name}_kernel" in k) / steps / 1e3
             for name in ("fwd", "dq", "dkv")}
    out = {
        "steps": steps,
        "device_busy_ms_per_step": busy / steps / 1e3,
        "span_ms_per_step": span / steps / 1e3,
        "idle_share": 1.0 - busy / span,
        "kernels_per_step": len(kernels) / steps,
        "flash_ms_per_step": flash,
        "flash_share_of_busy": sum(flash.values()) / (busy / steps / 1e3),
        "top_kernels_ms_per_step": {
            k[:90]: v / steps / 1e3 for k, v in sorted(by_name.items(), key=lambda kv: -kv[1])[:12]
        },
    }
    print(json.dumps({"lm_step_profile": out}))
    return out


def lm_trajectory_phase() -> None:
    """Flash kernels vs dense attention: 2 layers at full width, batch 4,
    T 1024, fp32 with TF32 off (set in main), 4 AdamW steps from the same
    init on the same batches: losses within rtol 1e-4, the first step's
    gradient norm (same weights, so a wrong dq, dk or dv shows here
    before Adam's step sizes hide it) within rtol 1e-5, and every
    parameter within 1e-3 after the 4 steps (3.97e-4 measured on an
    H100 SXM)."""
    from cs744_pytorch_distributed_tutorial_tpu_torch.data import synthetic_tokens
    from cs744_pytorch_distributed_tutorial_tpu_torch.train.lm import LMTrainer

    toks = synthetic_tokens(16, LM_WIDTH["seq_len"], LM_WIDTH["vocab_size"], seed=3)
    losses, grad_norms, params = {}, {}, {}
    for impl in ("flash", "dense"):
        tr = LMTrainer(lm_config(num_layers=2, global_batch_size=4, compute_dtype="float32",
                                 attention_impl=impl))
        model, _ = tr.init()
        steps = [tr.train_step(*tr.split_batch(toks[4 * s : 4 * s + 4])) for s in range(4)]
        losses[impl] = [float(m["loss"]) for m in steps]
        grad_norms[impl] = [float(m["grad_norm"]) for m in steps]
        params[impl] = [p.detach() for p in model.parameters()]
        del tr, model
    for a, b in zip(losses["flash"], losses["dense"]):
        if not (math.isfinite(a) and abs(a - b) <= 1e-4 * abs(b)):
            raise RuntimeError(f"LM flash vs dense trajectories differ: {losses}")
    g_flash, g_dense = grad_norms["flash"][0], grad_norms["dense"][0]
    if not abs(g_flash - g_dense) <= 1e-5 * abs(g_dense):
        raise RuntimeError(f"LM flash vs dense first-step gradient norms differ: "
                           f"{g_flash} vs {g_dense}")
    gap = max(float((a - b).abs().max()) for a, b in zip(params["flash"], params["dense"]))
    del params
    torch.cuda.empty_cache()
    if not gap <= 1e-3:
        raise RuntimeError(f"LM flash vs dense parameters differ by {gap} after 4 steps")
    print(f"trajectory LM (2 layers, full width, fp32): flash {losses['flash']} "
          f"dense {losses['dense']}; grad norms flash {grad_norms['flash']} dense "
          f"{grad_norms['dense']}; max abs parameter gap after 4 steps {gap}")


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is False; this script "
              "needs an NVIDIA card", file=sys.stderr)
        return 1
    from cs744_pytorch_distributed_tutorial_tpu_torch.ops import _build
    from cs744_pytorch_distributed_tutorial_tpu_torch.ops import flash_attention as A
    from cs744_pytorch_distributed_tutorial_tpu_torch.ops import fused_conv as C
    from cs744_pytorch_distributed_tutorial_tpu_torch.ops import fused_sgd as K

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
    sources = [K.SOURCE, C.SOURCE, A.SOURCE]
    _build.build_all(sources)
    K.load_kernel()
    C.load_kernel()
    A.load_kernel()
    print("built " + ", ".join(f"{s} in {_build.build_seconds[s]:.2f} s" for s in sources)
          + f", in parallel (wall {time.perf_counter() - t0:.2f} s)")

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

    flash_records = flash_phase(dev)
    flash_counts = lm_main_path_phase()
    for rec in flash_records:
        rec["launches"] = flash_counts[rec["name"].removeprefix("flash_")]
    records += flash_records
    lm_throughput_phase()
    lm_trajectory_phase()

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
