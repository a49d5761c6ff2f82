"""The overlapped schedule (``parallel/overlap.py``) against the fused one,
the int8 wire's short runs, gradient accumulation under both, and the
Trainer's rejections of option mixes the JAX engine rejects.

One launch of 4 Gloo processes (this file, run as a script) trains
tiny_cnn (global batch 32, one fixed batch, augmentation on) under each
configuration of ``RUNS``. Held, as the JAX package holds its own
overlapped schedule (``tests/test_sync_parity.py``):

- the overlapped ring equals the fused ring bit for bit, losses and
  parameters after 3 steps, with default and with 1 KiB buckets;
- the overlapped all-reduce equals the fused all-reduce within rtol
  1e-6, atol 1e-7 (the multi-rank sync tests' tolerance): gloo picks its
  summation order by buffer size, and the two schedules' buckets differ
  (bit for bit at a world of one, below);
- with ``accum_steps=2`` both wires within rtol 1e-5, atol 1e-6, as the
  JAX suite holds them: the fused schedule syncs each microbatch;
- int8 with error feedback, fused and overlapped, ends 8 steps within
  2 % of the float run's loss, and overlapped within 2 % of fused; the
  residuals are nonzero and each rank's own.
"""

import os
import subprocess
import sys

import numpy as np
import pytest
import torch
import torch.distributed as dist

from cs744_pytorch_distributed_tutorial_tpu_torch.config import TrainConfig
from cs744_pytorch_distributed_tutorial_tpu_torch.ops.fused_sgd import fused_sgd_plain
from cs744_pytorch_distributed_tutorial_tpu_torch.parallel import mesh
from cs744_pytorch_distributed_tutorial_tpu_torch.parallel.overlap import OverlappedSGD
from cs744_pytorch_distributed_tutorial_tpu_torch.train import Trainer

WORLD, BATCH = 4, 32
TINY_MB = 2.0**-10  # 1 KiB buckets: several for tiny_cnn
RUNS = {  # name: (steps, config)
    "fused_allreduce": (3, dict(sync="allreduce")),
    "overlap_allreduce": (3, dict(sync="allreduce", sync_overlap="bucket")),
    "overlap_allreduce_tiny": (3, dict(sync="allreduce", sync_overlap="bucket",
                                       sync_bucket_mb=TINY_MB)),
    "fused_ring": (3, dict(sync="ring")),
    "overlap_ring": (3, dict(sync="ring", sync_overlap="bucket")),
    "overlap_ring_tiny": (3, dict(sync="ring", sync_overlap="bucket", sync_bucket_mb=TINY_MB)),
    "fused_ring_accum2": (3, dict(sync="ring", accum_steps=2)),
    "overlap_ring_accum2": (3, dict(sync="ring", sync_overlap="bucket", accum_steps=2)),
    "fused_allreduce_accum2": (3, dict(sync="allreduce", accum_steps=2)),
    "overlap_allreduce_accum2": (3, dict(sync="allreduce", sync_overlap="bucket",
                                         accum_steps=2)),
    "f32_8": (8, dict(sync="allreduce")),
    "int8_8": (8, dict(sync="allreduce", grad_compress="int8")),
    "int8_overlap_8": (8, dict(sync="allreduce", grad_compress="int8",
                               sync_overlap="bucket+int8")),
    "int8_ring_overlap_8": (8, dict(sync="ring", grad_compress="int8",
                                    sync_overlap="bucket+int8", sync_bucket_mb=TINY_MB)),
    "int8_overlap_accum2": (3, dict(sync="int8_allreduce", sync_overlap="bucket+int8",
                                    accum_steps=2)),
}
COMMON = dict(model="tiny_cnn", num_devices=WORLD, global_batch_size=BATCH,
              synthetic_data=True, learning_rate=0.02)
REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _batch(rank: int):
    from cs744_pytorch_distributed_tutorial_tpu_torch.data import synthetic_cifar10

    ds = synthetic_cifar10(BATCH, 8, seed=0)
    per = BATCH // WORLD
    return (torch.from_numpy(ds.train_images[rank * per : (rank + 1) * per]),
            torch.from_numpy(ds.train_labels[rank * per : (rank + 1) * per].astype(np.int64)))


def _worker(rank: int, port: int, out_path: str) -> None:
    dist.init_process_group(
        "gloo", init_method=f"tcp://localhost:{port}", world_size=WORLD, rank=rank
    )
    try:
        x, y = _batch(rank)
        res = {}
        for name, (steps, kw) in RUNS.items():
            tr = Trainer(TrainConfig(**COMMON, **kw, device="cpu"))
            res[f"{name}/losses"] = np.array(
                [tr.global_mean(tr.train_step(x, y)) for _ in range(steps)])
            res.update({f"{name}/p/{i}": p.detach().numpy() for i, p in enumerate(tr.params)})
            res.update({f"{name}/ef/{i}": e.numpy() for i, e in enumerate(tr.state.ef)})
            if tr.overlap is not None:
                res[f"{name}/buckets"] = np.array(tr.overlap.num_buckets)
        np.savez(out_path, **res)
    finally:
        dist.destroy_process_group()


@pytest.fixture(scope="module")
def results(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("overlap")
    port = mesh.free_port()
    env = dict(os.environ, PYTHONPATH=REPO, OMP_NUM_THREADS="1")
    procs = [
        subprocess.Popen(
            [sys.executable, os.path.abspath(__file__), str(r), str(port), str(tmp / f"r{r}.npz")],
            env=env, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True,
        )
        for r in range(WORLD)
    ]
    logs = []
    try:
        for p in procs:
            logs.append(p.communicate(timeout=180)[0])
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
    assert all(p.returncode == 0 for p in procs), "\n".join(logs)
    return [dict(np.load(tmp / f"r{r}.npz")) for r in range(WORLD)]


def _params(res: dict, name: str) -> list[np.ndarray]:
    return [res[k] for k in sorted((k for k in res if k.startswith(f"{name}/p/")),
                                   key=lambda k: int(k.rsplit("/", 1)[1]))]


@pytest.mark.parametrize("overlap,fused", [
    ("overlap_ring", "fused_ring"),
    ("overlap_ring_tiny", "fused_ring"),
])
def test_overlapped_ring_is_bitwise_the_fused_ring(results, overlap, fused):
    for r, res in enumerate(results):
        np.testing.assert_array_equal(res[f"{overlap}/losses"], res[f"{fused}/losses"])
        for a, b in zip(_params(res, overlap), _params(res, fused), strict=True):
            np.testing.assert_array_equal(a, b, err_msg=f"rank {r}")
    assert results[0]["overlap_ring_tiny/buckets"] > 1


@pytest.mark.parametrize("overlap,fused", [
    ("overlap_allreduce", "fused_allreduce"),
    ("overlap_allreduce_tiny", "fused_allreduce"),
])
def test_overlapped_allreduce_matches_the_fused_allreduce(results, overlap, fused):
    _close(results, overlap, fused, rtol=1e-6, atol=1e-7)
    assert results[0]["overlap_allreduce_tiny/buckets"] > 1


@pytest.mark.parametrize("sync", ["ring", "allreduce"])
def test_overlap_with_accumulation_matches_fused(results, sync):
    """The fused schedule syncs each microbatch (a mean of means), the
    overlapped one the accumulated sum once: equal up to reassociation,
    held at the JAX suite's rtol 1e-5, atol 1e-6."""
    _close(results, f"overlap_{sync}_accum2", f"fused_{sync}_accum2", rtol=1e-5, atol=1e-6)


def _close(results, a_name: str, b_name: str, **tol) -> None:
    for r, res in enumerate(results):
        np.testing.assert_allclose(res[f"{a_name}/losses"], res[f"{b_name}/losses"], **tol)
        for a, b in zip(_params(res, a_name), _params(res, b_name), strict=True):
            np.testing.assert_allclose(a, b, err_msg=f"rank {r}", **tol)


def test_int8_short_runs_stay_close(results):
    res = results[0]
    ref = res["f32_8/losses"][-1]
    assert res["f32_8/losses"][-1] < res["f32_8/losses"][0]  # it trains
    for name in ("int8_8", "int8_overlap_8", "int8_ring_overlap_8"):
        assert res[f"{name}/losses"][-1] == pytest.approx(ref, rel=0.02), name
    assert res["int8_overlap_8/losses"][-1] == pytest.approx(res["int8_8/losses"][-1], rel=0.02)
    assert np.isfinite(res["int8_overlap_accum2/losses"]).all()
    for name in ("int8_8", "int8_overlap_8", "int8_ring_overlap_8", "int8_overlap_accum2"):
        efs = [[v for k, v in sorted(r.items()) if k.startswith(f"{name}/ef/")] for r in results]
        assert len(efs[0]) == len(_params(res, name))
        assert any(np.abs(e).max() > 0 for e in efs[0]), name
        # Each rank keeps its own residual; the parameters stay replicated.
        assert any(not np.array_equal(a, b) for a, b in zip(efs[0], efs[1])), name
        for r in range(1, WORLD):
            for a, b in zip(_params(results[r], name), _params(res, name)):
                np.testing.assert_array_equal(a, b)
    for name in ("fused_ring", "overlap_ring"):
        assert not any(k.startswith(f"{name}/ef/") for k in res)


# ------------------------------------------------------ a world of one
@pytest.fixture
def world_of_one():
    mesh.initialize(None, 1, 0, device=torch.device("cpu"))
    yield
    mesh.shutdown()


def _steps(cfg_kw: dict, model: str, steps: int = 2):
    x, y = _batch(0)
    tr = Trainer(TrainConfig(model=model, num_devices=1, global_batch_size=BATCH // WORLD,
                             augment=False, learning_rate=0.02, device="cpu", **cfg_kw))
    losses = [float(tr.train_step(x, y)) for _ in range(steps)]
    return losses, [p.detach().clone() for p in tr.params], tr


@pytest.mark.parametrize("sync", ["allreduce", "ring"])
def test_overlap_bitwise_at_world_one_through_residual_blocks(world_of_one, sync):
    """ResNet-18's hooks run in autograd order, not reverse parameter
    order (the shortcut's projection, the blocks' branches); buckets
    still go out in layout order, and the result is the fused one."""
    fused = _steps(dict(sync=sync), "resnet18")
    over = _steps(dict(sync=sync, sync_overlap="bucket", sync_bucket_mb=0.25), "resnet18")
    assert over[2].overlap.num_buckets > 4
    assert over[0] == fused[0]
    for a, b in zip(over[1], fused[1], strict=True):
        assert torch.equal(a, b)


def test_int8_at_world_one_quantizes_and_feeds_back(world_of_one):
    from cs744_pytorch_distributed_tutorial_tpu_torch.ops.quant import (
        dequantize_chunked,
        quantize_chunked,
    )
    from cs744_pytorch_distributed_tutorial_tpu_torch.parallel import buckets as B

    losses, _, tr = _steps(dict(sync="allreduce", grad_compress="int8"), "tiny_cnn", steps=1)
    assert any(float(e.abs().max()) > 0 for e in tr.state.ef)
    # The step's residual is b - dequant(quant(b)) over each bucket of
    # the local gradient (the residual started at zero).
    layout = B.bucket_layout(tr.params, rows=0)
    x, y = _batch(0)
    ref = Trainer(TrainConfig(model="tiny_cnn", num_devices=1, global_batch_size=BATCH // WORLD,
                              augment=False, learning_rate=0.02, device="cpu", sync="allreduce"))
    ref.train_step(x, y)
    grads = [p.grad for p in ref.params]
    for buf, ebuf in zip(B.flatten_for_sync(grads, layout),
                         B.flatten_for_sync(tr.state.ef, layout)):
        pad = -buf.numel() % 256
        b = torch.nn.functional.pad(buf, (0, pad))
        deq = dequantize_chunked(*quantize_chunked(b, 256))
        assert torch.equal(ebuf, (b - deq)[: buf.numel()])


def _apply_case(device: str):
    """The overlapped schedule's per-bucket apply against the plain
    update, tensor by tensor, on ResNet-18's parameters (ring at a world
    of one: the synced gradient is the local one)."""
    from cs744_pytorch_distributed_tutorial_tpu_torch.models import get_model
    from cs744_pytorch_distributed_tutorial_tpu_torch.ops import fused_sgd as K

    gen = torch.Generator().manual_seed(0)
    model = get_model("resnet18", num_classes=10, generator=gen).to(device)
    params = list(model.parameters())
    moms = [torch.randn(p.shape, generator=gen).to(device) for p in params]
    ov = OverlappedSGD(params, moms, None, name="ring", world_size=1, lr=0.1, mu=0.9, wd=1e-4,
                       bucket_bytes=2**20)
    x = torch.randn(4, 3, 32, 32, generator=gen).to(device)
    K.reset_launch_count()
    for _ in range(2):
        want_p = [p.detach().clone() for p in params]
        want_m = [m.clone() for m in moms]
        ov.begin()
        model(x).square().mean().backward()
        ov.finish()
        for p, m, wp, wm in zip(params, moms, want_p, want_m):
            fused_sgd_plain(wp, wm, p.grad, lr=0.1, mu=0.9, wd=1e-4)
            assert torch.equal(p.detach(), wp) and torch.equal(m, wm)
            p.grad = None
    ov.remove_hooks()
    return ov.num_buckets, K.launch_count()


def test_per_bucket_apply_is_the_plain_update():
    buckets, launches = _apply_case("cpu")
    assert buckets > 4 and launches == 0  # the plain version on CPU tensors


@pytest.mark.cuda
def test_per_bucket_apply_bitwise_on_card():
    """On the card each bucket's update is one fused-SGD kernel launch,
    bitwise equal to the plain update."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card and nvcc")
    buckets, launches = _apply_case("cuda")
    assert launches == 2 * buckets


# ------------------------------------------------------------ rejections
@pytest.mark.parametrize("kw,match", [
    (dict(sync="gather_scatter", grad_compress="int8"), "applies to the flat allreduce"),
    (dict(sync="p2p_star", grad_compress="int8"), "applies to the flat allreduce"),
    (dict(sync="auto", grad_compress="int8"), "applies to the flat allreduce"),
    (dict(sync="allreduce", grad_compress="int8", fused_optimizer=True), "does not compose"),
    (dict(sync="allreduce", grad_compress="fp8"), "unknown grad_compress"),
    (dict(sync="allreduce", sync_overlap="on"), "unknown sync_overlap"),
    (dict(sync="allreduce", sync_overlap="bucket", fused_optimizer=True), "cannot combine"),
    (dict(sync="allreduce", sync_overlap="bucket", grad_compress="int8"), "float bucketed wire"),
    (dict(sync="int8_ring", sync_overlap="bucket"), "float bucketed wire"),
    (dict(sync="auto", sync_overlap="bucket"), "float bucketed wire"),
    (dict(sync="gather_scatter", sync_overlap="bucket"), "float bucketed wire"),
    (dict(sync="ring", sync_overlap="bucket+int8"), "requires grad_compress"),
    (dict(sync="allreduce", sync_overlap="bucket", optimizer="adamw"), "fixed-lr"),
    (dict(sync="allreduce", sync_overlap="bucket", lr_schedule="cosine"), "fixed-lr"),
    (dict(sync="allreduce", sync_overlap="bucket", warmup_steps=5), "fixed-lr"),
    (dict(sync="allreduce", sync_overlap="bucket", grad_clip_norm=1.0), "fixed-lr"),
    (dict(sync="allreduce", sync_bucket_mb=-1.0), "sync_bucket_mb"),
])
def test_rejections(world_of_one, kw, match):
    with pytest.raises(ValueError, match=match):
        Trainer(TrainConfig(model="tiny_cnn", num_devices=1, global_batch_size=8,
                            device="cpu", **kw))


if __name__ == "__main__":
    _worker(int(sys.argv[1]), int(sys.argv[2]), sys.argv[3])
