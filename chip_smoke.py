"""Smoke run of the PyTorch/CUDA port on one NVIDIA card.

    python3 chip_smoke.py

Phases, each raising on failure (the script then exits nonzero and prints
no result):

1. setup: the card, its power limit, torch/CUDA versions, TF32 settings,
   and the build of every kernel of the main path from ``csrc/``;
2. kernels: each kernel against its plain PyTorch version on the card at
   the main path's shapes (VGG-11's 34 parameter tensors) and ragged ones,
   then its time beside its bound, the plain version's time and one
   PyTorch library call's time;
3. main path: the port's CLI, part 1 (one rank) on VGG-11 at full width
   with the fused optimizer, batch 256, 24 steps; the kernel launch
   counts are zeroed just before and read just after;
4. NCCL path: part 2b through ``init_process_group("nccl")`` at a world
   of one, 5 steps, counts read the same way;
5. trajectory: three VGG-11 steps with the fused kernel against three
   with the plain update, same seed and data;
6. profile: where the device time of a main-path step goes.

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

VGG11_STEPS = 24  # 6144 synthetic images / global batch 256
NCCL_STEPS = 5
RAGGED_SHAPES = [(1,), (7,), (1000,), (3, 5, 7)]
LR, MU, WD = 0.1, 0.9, 1e-4


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


def device_busy_ms(fn, reps: int = 10) -> float | None:
    """Kernel time on the card per call of ``fn`` (the sum of its kernels'
    durations from a torch.profiler trace), without the host's launch
    gaps; None when the profiler records no device activity."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(reps):
            fn()
        torch.cuda.synchronize()
    total_us = sum(
        e.time_range.elapsed_us()
        for e in prof.events()
        if e.device_type == DeviceType.CUDA
    )
    return total_us / reps / 1e3 if total_us else None


def run_cli(argv: list[str]) -> dict:
    from cs744_pytorch_distributed_tutorial_tpu_torch import cli

    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        rc = cli.main(argv)
    text = buf.getvalue()
    print(text, end="")
    if rc != 0:
        raise RuntimeError(f"cli.main returned {rc}")
    return json.loads(text.strip().splitlines()[-1])


def kernel_phase(dev: torch.device) -> dict:
    from cs744_pytorch_distributed_tutorial_tpu_torch.models import vgg11
    from cs744_pytorch_distributed_tutorial_tpu_torch.ops import fused_sgd as K

    shapes = [tuple(p.shape) for p in vgg11().parameters()]
    if len(shapes) != 34:
        raise RuntimeError(f"VGG-11 has {len(shapes)} parameter tensors, expected 34")
    gen = torch.Generator(device=dev).manual_seed(0)

    def randn(*shape):
        return torch.randn(shape, generator=gen, device=dev)

    # Correctness: 3 steps of kernel vs plain on the same inputs; the
    # misaligned case (a view one float into its storage) takes the
    # kernel's scalar path.
    max_err = 0.0
    cases = [(s, 0) for s in shapes + RAGGED_SHAPES] + [((1000,), 1)]
    for shape, offset in cases:
        n = math.prod(shape)
        p = randn(n + offset)[offset:].view(shape)
        m = (0.1 * randn(n + offset))[offset:].view(shape)
        pk, mk, pp, mp = p.clone(), m.clone(), p.clone(), m.clone()
        if offset:
            pk = torch.empty(n + offset, device=dev)[offset:].view(shape).copy_(p)
            mk = torch.empty(n + offset, device=dev)[offset:].view(shape).copy_(m)
        for _ in range(3):
            g = randn(*shape)
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

    # Time one whole VGG-11 update (34 tensors) three ways.
    params = [randn(*s) for s in shapes]
    moms = [torch.zeros_like(p) for p in params]
    grads = [randn(*s) for s in shapes]

    def kernel_update():
        for p, m, g in zip(params, moms, grads):
            K.fused_sgd_(p, m, g, lr=LR, mu=MU, wd=WD)

    def plain_update():
        for p, m, g in zip(params, moms, grads):
            K.fused_sgd_plain(p, m, g, lr=LR, mu=MU, wd=WD)

    lib_params = [torch.nn.Parameter(p.clone()) for p in params]
    for p, g in zip(lib_params, grads):
        p.grad = g.clone()
    lib_opt = torch.optim.SGD(
        lib_params, lr=LR, momentum=MU, weight_decay=WD, fused=True
    )

    kernel_ms = median_ms(kernel_update)
    plain_ms = median_ms(plain_update)
    library_ms = median_ms(lib_opt.step)
    kernel_dev = device_busy_ms(kernel_update)
    plain_dev = device_busy_ms(plain_update)
    library_dev = device_busy_ms(lib_opt.step)

    n = sum(math.prod(s) for s in shapes)
    bw, flops = card_rates(torch.cuda.get_device_name(0))
    bytes_ms = 20.0 * n / bw * 1e3  # read p, m, g; write p, m (fp32)
    ops_ms = 6.0 * n / flops * 1e3  # 3 multiplies + 3 adds per element
    print(f"fused_sgd: VGG-11 update of {n} elements ({20 * n / 1e6:.1f} MB): "
          f"kernel {kernel_ms:.4f} ms, plain {plain_ms:.4f} ms, "
          f"torch.optim.SGD(fused=True) {library_ms:.4f} ms, "
          f"bound {max(bytes_ms, ops_ms):.4f} ms; device busy per update "
          f"(profiler): kernel {kernel_dev}, plain {plain_dev}, library {library_dev} ms")
    return {
        "name": "fused_sgd",
        "route": "cuda",
        "source": "cs744_pytorch_distributed_tutorial_tpu_torch/csrc/fused_sgd.cu",
        "replaces": "cs744_pytorch_distributed_tutorial_tpu/ops/fused_sgd.py:46",
        "tpu_kernel": "ops/fused_sgd.py::_kernel",
        "launches": None,  # filled in from the main path's run
        "max_abs_err": max_err,
        "ms": kernel_ms,
        "kernel_ms": kernel_ms,
        "plain_ms": plain_ms,
        "bound_ms": max(bytes_ms, ops_ms),
        "bound_by": "bytes" if bytes_ms >= ops_ms else "operations",
        "library_ms": library_ms,
        "device_ms": kernel_dev,
        "plain_device_ms": plain_dev,
        "library_device_ms": library_dev,
        "elements": n,
    }


def main_path_phase() -> tuple[dict, int]:
    from cs744_pytorch_distributed_tutorial_tpu_torch.ops import fused_sgd as K

    argv = [
        "--part", "1", "--model", "vgg11", "--fused-optimizer",
        "--synthetic-data", "--synthetic-train-size", str(256 * VGG11_STEPS),
        "--synthetic-test-size", "512", "--global-batch-size", "256",
        "--epochs", "1", "--json", "--device", "cuda",
    ]
    K.reset_launch_count()
    summary = run_cli(argv)
    launches = K.launch_count()
    if summary["steps"] != VGG11_STEPS:
        raise RuntimeError(f"main path ran {summary['steps']} steps, not {VGG11_STEPS}")
    for key in ("final_train_loss", "final_eval_loss"):
        if not math.isfinite(summary[key]):
            raise RuntimeError(f"main path {key} is not finite: {summary[key]}")
    if summary["avg_batch_time_s"] is None:
        raise RuntimeError("main path recorded no avg_batch_time_s")
    if launches != 34 * VGG11_STEPS:
        raise RuntimeError(
            f"fused_sgd launched {launches} times on the main path, "
            f"expected 34 x {VGG11_STEPS}"
        )
    print(f"main path: VGG-11 part 1, batch 256, {VGG11_STEPS} steps, "
          f"{256 / summary['avg_batch_time_s']:.1f} samples/s "
          f"(avg_batch_time_s {summary['avg_batch_time_s']}), "
          f"fused_sgd launches {launches}")
    return summary, launches


def nccl_phase() -> None:
    from cs744_pytorch_distributed_tutorial_tpu_torch.ops import fused_sgd as K

    argv = [
        "--part", "2b", "--num-devices", "1", "--model", "vgg11",
        "--fused-optimizer", "--synthetic-data",
        "--synthetic-train-size", str(256 * NCCL_STEPS),
        "--synthetic-test-size", "256", "--global-batch-size", "256",
        "--epochs", "1", "--json", "--device", "cuda",
    ]
    K.reset_launch_count()
    summary = run_cli(argv)
    launches = K.launch_count()
    if summary["backend"] != "nccl":
        raise RuntimeError(f"part 2b ran on backend {summary['backend']!r}, not nccl")
    if summary["steps"] != NCCL_STEPS or not math.isfinite(summary["final_train_loss"]):
        raise RuntimeError(f"NCCL path summary is wrong: {summary}")
    if launches != 34 * NCCL_STEPS:
        raise RuntimeError(f"fused_sgd launched {launches} times on the NCCL path")
    print(f"NCCL path: part 2b world 1, {NCCL_STEPS} steps, loss "
          f"{summary['final_train_loss']}, fused_sgd launches {launches}")


def trajectory_phase() -> None:
    """Fused kernel vs plain update over three VGG-11 steps, same seed and
    batches (augmentation off). The two updates round alike; the residue
    is cuDNN's run-to-run summation order, hence rtol 1e-3 on the loss."""
    from cs744_pytorch_distributed_tutorial_tpu_torch.config import TrainConfig
    from cs744_pytorch_distributed_tutorial_tpu_torch.data import synthetic_cifar10
    from cs744_pytorch_distributed_tutorial_tpu_torch.train import Trainer

    ds = synthetic_cifar10(3 * 64, 8, seed=1)
    losses = {}
    for fused in (True, False):
        cfg = TrainConfig(
            model="vgg11", sync="none", num_devices=1, global_batch_size=64,
            augment=False, learning_rate=0.02, fused_optimizer=fused,
        )
        tr = Trainer(cfg)
        out = []
        for s in range(3):
            x = torch.from_numpy(ds.train_images[s * 64 : (s + 1) * 64]).to(tr.device)
            y = torch.from_numpy(ds.train_labels[s * 64 : (s + 1) * 64].astype("int64")).to(tr.device)
            out.append(float(tr.train_step(x, y)))
        losses[fused] = out
    for a, b in zip(losses[True], losses[False]):
        if not (math.isfinite(a) and abs(a - b) <= 1e-3 * abs(b)):
            raise RuntimeError(f"fused vs plain trajectories differ: {losses}")
    print(f"trajectory: fused {losses[True]} plain {losses[False]}")


def profile_phase() -> dict:
    """Where a main-path step's device time goes: VGG-11, batch 256, fused
    optimizer, 5 steps on batches already on the card (so the host's
    batch gather is not in it), traced with torch.profiler. Idle share is
    1 - (sum of kernel time) / (first kernel start to last kernel end)."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    from cs744_pytorch_distributed_tutorial_tpu_torch.config import TrainConfig
    from cs744_pytorch_distributed_tutorial_tpu_torch.data import synthetic_cifar10
    from cs744_pytorch_distributed_tutorial_tpu_torch.train import Trainer

    tr = Trainer(TrainConfig(model="vgg11", sync="none", num_devices=1,
                             fused_optimizer=True))
    ds = synthetic_cifar10(256 * 8, 8, seed=2)
    batches = [
        (torch.from_numpy(ds.train_images[s * 256 : (s + 1) * 256]).to(tr.device),
         torch.from_numpy(ds.train_labels[s * 256 : (s + 1) * 256].astype("int64")).to(tr.device))
        for s in range(8)
    ]
    for x, y in batches[:3]:
        tr.train_step(x, y)
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        for x, y in batches[3:]:
            tr.train_step(x, y)
        torch.cuda.synchronize()
    kernels = [e for e in prof.events() if e.device_type == DeviceType.CUDA]
    if not kernels:
        print("profile: torch.profiler recorded no device activity")
        return {}
    busy = sum(e.time_range.elapsed_us() for e in kernels)
    span = max(e.time_range.end for e in kernels) - min(e.time_range.start for e in kernels)
    by_name: dict[str, float] = {}
    for e in kernels:
        by_name[e.name] = by_name.get(e.name, 0.0) + e.time_range.elapsed_us()
    top = sorted(by_name.items(), key=lambda kv: -kv[1])[:10]
    steps = len(batches) - 3
    out = {
        "steps": steps,
        "device_busy_ms_per_step": busy / steps / 1e3,
        "span_ms_per_step": span / steps / 1e3,
        "idle_share": 1.0 - busy / span,
        "fused_sgd_ms_per_step": sum(
            v for k, v in by_name.items() if "fused_sgd" in k) / steps / 1e3,
        "top_kernels_ms_per_step": {k[:90]: v / steps / 1e3 for k, v in top},
    }
    print(json.dumps({"step_profile": out}))
    return out


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is False; this script "
              "needs an NVIDIA card", file=sys.stderr)
        return 1
    from cs744_pytorch_distributed_tutorial_tpu_torch.ops import _build
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
    K.load_kernel()
    print(f"built {K.SOURCE} in {_build.build_seconds[K.SOURCE]:.2f} s "
          f"(load {time.perf_counter() - t0:.2f} s)")

    record = kernel_phase(dev)
    _, launches = main_path_phase()
    record["launches"] = launches
    nccl_phase()
    trajectory_phase()
    profile_phase()

    print(json.dumps({"kernels": [record]}))
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
