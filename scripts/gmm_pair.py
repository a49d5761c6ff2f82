"""Time this checkout's grouped-matmul forward and ``gmm`` kernels against
another build of the same two sources (a parent commit's), in paired runs
on one card.

    python scripts/gmm_pair.py OTHER_CSRC_DIR [--out RESULT.json]

``OTHER_CSRC_DIR`` holds the other ``gmm.cu`` and ``gmm_tc.cu`` with the
headers they include. Both builds take the package's nvcc flags
(``ops/_build.py``) and are called through their C entry points
(``ops/gmm.py::bind``) on the same tensors, at the MoE path's E = 8 shapes:

- the forward on the tensor cores (``gmm_fused_tc``): a prefill layer's
  w_in (lhs [4096, 512] against [8, 512, 1024], gelu, bf16 out) and the
  training w_in with ``z`` (lhs [32768, 512]);
- the forward on FFMA (``gmm_fused``): the prefill w_in in fp32;
- ``gmm_tc``, the backward's dlhs: w_in's (an fp32 dout [32768, 1024] in
  three bf16 pieces, split beforehand, against w_in read transposed) and
  w_out's (a bf16 dout [32768, 512], one piece, against [8, 1024, 512]);
- ``gmm`` on FFMA: w_in's dlhs in fp32.

Group sizes are the MoE training path's ragged ones (an empty group), cut
in eight for the prefill. Each case runs other, this, this, other (the
median of 30 CUDA-event-fenced calls each); the two builds' outputs are
compared (the largest difference and the count of elements that differ
are printed) and each is held against the plain version (ops/gmm.py) at
chip_smoke.py's limits: fp32 within 1e-5 x max|plain|, bf16 within one
ulp of each plain value plus 1e-5 x max|plain|. Each build's registers and
spills (ptxas) are printed. The card's name and power limit are printed
beside the times; the JSON is printed last and, with ``--out``, written
there too.
"""

from __future__ import annotations

import argparse
import ctypes
import json
import os
import statistics
import subprocess
import sys
from pathlib import Path

import torch

REPO = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(REPO))

from cs744_pytorch_distributed_tutorial_tpu_torch.ops import _build  # noqa: E402
from cs744_pytorch_distributed_tutorial_tpu_torch.ops import gmm as G  # noqa: E402

TRAIN_SIZES = [4100, 0, 5000, 3333, 6000, 4444, 5555, 4336]  # 32,768 routed rows
PREFILL_SIZES = [n // 8 for n in TRAIN_SIZES[:-1]] + [4096 - sum(n // 8 for n in TRAIN_SIZES[:-1])]
D, F = 512, 1024  # the MoE LM's d_model and d_ff


def card_line() -> str:
    out = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, check=True, timeout=60)
    return out.stdout.strip().splitlines()[0]


def build(csrc: Path, tag: str) -> dict:
    """The C entry points of ``csrc``'s gmm.cu and gmm_tc.cu, built under
    ``build/gmm_pair/<tag>/``."""
    out_dir = _build.BUILD_DIR.parent / "gmm_pair" / tag
    out_dir.mkdir(parents=True, exist_ok=True)
    libs = []
    for name in ("gmm.cu", "gmm_tc.cu"):
        so = out_dir / (Path(name).stem + ".so")
        cmd = [_build._nvcc(), *_build.NVCC_FLAGS, "-o", str(so), str(csrc / name)]
        proc = subprocess.run(cmd, capture_output=True, text=True)
        if proc.returncode:
            raise RuntimeError(f"nvcc failed on {csrc / name}:\n{proc.stdout}{proc.stderr}")
        libs.append(ctypes.CDLL(str(so)))
        for line in (proc.stdout + proc.stderr).splitlines():
            if "Compiling entry" in line or "registers" in line or "spill" in line:
                print(f"ptxas {tag} {name}: {line.strip()}")
    return G.bind(*libs)


def median_ms(fn, reps: int = 30, warmup: int = 5) -> float:
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(reps):
        start, end = (torch.cuda.Event(enable_timing=True) for _ in range(2))
        start.record()
        fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end))
    return statistics.median(times)


def cases(dev: torch.device) -> dict:
    """name -> (kernel, output tensors, C arguments, the plain outputs, the
    input tensors) on shared inputs; the C arguments hold raw pointers, so
    the caller keeps the inputs alive with them."""
    gen = torch.Generator(device=dev).manual_seed(5)

    def randn(*shape, dtype=torch.float32):
        return torch.randn(*shape, generator=gen, device=dev).to(dtype)

    def sizes(rows):
        return torch.tensor(rows, dtype=torch.int32, device=dev)

    p = lambda t: t.data_ptr() if t is not None else None  # noqa: E731
    w_in = randn(8, D, F, dtype=torch.bfloat16) / D**0.5
    w_out = randn(8, F, D, dtype=torch.bfloat16) / F**0.5
    b_in = 0.1 * randn(8, F)
    out = {}
    for label, rows, z in (("fused_tc prefill w_in", PREFILL_SIZES, False),
                           ("fused_tc train w_in with z", TRAIN_SIZES, True)):
        m, gs = sum(rows), sizes(rows)
        lhs = randn(m, D, dtype=torch.bfloat16)
        o = torch.empty(m, F, dtype=torch.bfloat16, device=dev)
        zo = torch.empty_like(o) if z else None
        plain = G.grouped_matmul_fused_plain(lhs, w_in, b_in, gs, activation="gelu", with_z=z)
        out[label] = ("fused_tc", [o] + ([zo] if z else []),
                      (p(lhs), p(w_in), p(b_in), p(gs), p(o), p(zo), m, D, F, 8, 1, 1),
                      list(plain) if z else [plain], (lhs, w_in, b_in, gs))
    m, gs = sum(PREFILL_SIZES), sizes(PREFILL_SIZES)
    lhs32, w32 = randn(m, D), w_in.float()
    o32 = torch.empty(m, F, device=dev)
    out["fused (FFMA) prefill w_in fp32"] = (
        "fused", [o32], (p(lhs32), p(w32), p(b_in), p(gs), p(o32), None, m, D, F, 8, 1, 0, 0),
        [G.grouped_matmul_fused_plain(lhs32, w32, b_in, gs, activation="gelu")],
        (lhs32, w32, b_in, gs))
    m, gs = sum(TRAIN_SIZES), sizes(TRAIN_SIZES)
    dz = randn(m, F)
    pieces = G.split_bf16_plain(dz).contiguous()
    o = torch.empty(m, D, device=dev)
    out["gmm_tc dlhs w_in (3 pieces)"] = (
        "gmm_tc", [o], (p(pieces), p(w_in), p(gs), p(o), m, F, D, 8, 3, 0),
        [G.grouped_matmul_plain(dz, w_in, gs, trans_rhs=True)], (pieces, w_in, gs))
    dout = randn(m, D, dtype=torch.bfloat16)
    o2 = torch.empty(m, F, device=dev)
    out["gmm_tc dlhs w_out (1 piece)"] = (
        "gmm_tc", [o2], (p(dout), p(w_out), p(gs), p(o2), m, D, F, 8, 1, 0),
        [G.grouped_matmul_plain(dout, w_out, gs, trans_rhs=True)], (dout, w_out, gs))
    o3 = torch.empty(m, D, device=dev)
    out["gmm (FFMA) dlhs w_in fp32"] = (
        "gmm", [o3], (p(dz), p(w32), p(gs), p(o3), m, F, D, 8, 0, 0, 1),
        [G.grouped_matmul_plain(dz, w32, gs, trans_rhs=True)], (dz, w32, gs))
    return out


def share(got: torch.Tensor, want: torch.Tensor) -> float:
    """The largest error of ``got`` against the plain ``want`` as a share
    of chip_smoke.py's limit for its dtype."""
    diff = (got.float() - want.float()).abs()
    top = float(want.float().abs().max())
    if want.dtype == torch.float32:
        return float(diff.max()) / (1e-5 * top)
    return float((diff / (2**-7 * want.float().abs() + 1e-5 * top)).max())


def main(argv: list[str] | None = None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("other_csrc", type=Path)
    ap.add_argument("--out", default=None, help="also write the JSON result here")
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("gmm_pair: no CUDA card", file=sys.stderr)
        return 1
    dev = torch.device("cuda", 0)
    torch.cuda.set_device(dev)
    builds = {"other": build(args.other_csrc.resolve(), "other"),
              "this": build(_build.CSRC_DIR, "this")}
    card = card_line()
    stream = torch.cuda.current_stream(dev).cuda_stream
    result = {"card": card, "cases": {}}
    for label, (kernel, outs, call_args, plain, _inputs) in cases(dev).items():

        def run(which, kernel=kernel, call_args=call_args):
            err = builds[which][kernel](*call_args, stream)
            if err:
                raise RuntimeError(f"{which} {kernel} failed: CUDA error {err}")

        shares = {}
        for which in ("other", "this"):
            run(which)
            torch.cuda.synchronize()
            shares[which] = max(share(a, b) for a, b in zip(outs, plain))
            if which == "other":
                want = [t.clone() for t in outs]
        same = all(torch.equal(a, b) for a, b in zip(want, outs))
        diff = max(float((a.float() - b.float()).abs().max()) for a, b in zip(want, outs))
        ndiff = sum(int((a != b).sum()) for a, b in zip(want, outs))
        if max(shares.values()) > 1.0:
            raise RuntimeError(f"{label}: a build disagrees with the plain version: {shares}")
        times = {"other": [], "this": []}
        for which in ("other", "this", "this", "other"):
            times[which].append(median_ms(lambda: run(which)))
        row = {which: statistics.mean(t) for which, t in times.items()}
        row["runs"] = times
        row.update(bitwise_equal=same, max_abs_diff=diff, elements_differing=ndiff,
                   share_of_limit=shares)
        result["cases"][label] = row
        print(f"{label}: other {row['other']:.4f} ms, this {row['this']:.4f} ms "
              f"(runs {times}); outputs bitwise equal: {same} (max abs diff {diff}, {ndiff} "
              f"elements differ); share of the limit against plain {shares}; on {card}",
              flush=True)
    if args.out:
        os.makedirs(os.path.dirname(os.path.abspath(args.out)), exist_ok=True)
        with open(args.out, "w") as f:
            json.dump(result, f, indent=1)
    print(json.dumps(result))
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
