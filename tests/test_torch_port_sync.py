"""The port's gradient-sync strategies against the JAX package's.

One launch of 4 Gloo processes (this file, run as a script) applies all
six strategies to per-rank numpy gradients: the five explicit ones
through ``parallel/sync.py::sync_grads``, and ``auto`` through
``DistributedDataParallel`` as the trainer uses it. The JAX strategies
run under ``shard_map`` on 4 of the harness's 8 host devices, per leaf.
Tolerance rtol 1e-6: the port divides before its all-reduce (as part2b
does), JAX after, and the sums may be taken in another order.
"""

import os
import subprocess
import sys

import numpy as np
import pytest
import torch

from cs744_pytorch_distributed_tutorial_tpu_torch.parallel.sync import (
    sync_grads,
    sync_wire_bytes,
)

WORLD = 4
SHAPES = [(3, 5, 7), (10,), (1,), (16, 3, 3, 3), (33,)]
EXPLICIT = ["none", "gather_scatter", "p2p_star", "allreduce", "ring"]
REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _rank_grads(rank: int) -> list[np.ndarray]:
    rng = np.random.default_rng(100 + rank)
    return [rng.standard_normal(s).astype(np.float32) for s in SHAPES]


def _worker(rank: int, port: int, out_path: str) -> None:
    import torch.distributed as dist
    from torch.nn.parallel import DistributedDataParallel

    dist.init_process_group(
        "gloo", init_method=f"tcp://localhost:{port}", world_size=WORLD, rank=rank
    )
    try:
        grads = _rank_grads(rank)
        res = {}
        for name in EXPLICIT:
            ts = [torch.from_numpy(g.copy()) for g in grads]
            sync_grads(ts, name, WORLD)
            res.update({f"{name}/{i}": t.numpy() for i, t in enumerate(ts)})

        class Linear(torch.nn.Module):
            """loss = sum_i <w_i, g_i>, so each parameter's gradient is g_i."""

            def __init__(self):
                super().__init__()
                self.w = torch.nn.ParameterList(torch.nn.Parameter(torch.zeros(s)) for s in SHAPES)

            def forward(self, gs):
                return sum((w * g).sum() for w, g in zip(self.w, gs))

        model = Linear()
        ddp = DistributedDataParallel(model, broadcast_buffers=False)
        ddp([torch.from_numpy(g) for g in grads]).backward()
        res.update({f"auto/{i}": w.grad.numpy() for i, w in enumerate(model.w)})
        np.savez(out_path, **res)
    finally:
        dist.destroy_process_group()


def _free_port() -> int:
    import socket

    with socket.socket() as s:
        s.bind(("localhost", 0))
        return s.getsockname()[1]


def _jax_sync(name: str, mesh) -> list[np.ndarray]:
    import jax
    from jax.sharding import PartitionSpec as P

    from cs744_pytorch_distributed_tutorial_tpu.parallel.sync import sync_grads as jax_sync

    stacked = [np.stack([_rank_grads(r)[i] for r in range(WORLD)]) for i in range(len(SHAPES))]

    def local(*leaves):
        out = jax_sync([x[0] for x in leaves], name, "data", WORLD, bucket_bytes=0)
        return [o[None] for o in out]

    fn = jax.shard_map(
        local, mesh=mesh, in_specs=P("data"), out_specs=P("data"), check_vma=False
    )
    return [np.asarray(o) for o in jax.jit(fn)(*stacked)]


def test_six_strategies_match_jax_over_four_gloo_ranks(tmp_path, mesh4):
    port = _free_port()
    env = dict(os.environ, PYTHONPATH=REPO, OMP_NUM_THREADS="1")
    procs = [
        subprocess.Popen(
            [sys.executable, os.path.abspath(__file__), str(r), str(port), str(tmp_path / f"r{r}.npz")],
            env=env, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True,
        )
        for r in range(WORLD)
    ]
    logs = []
    try:
        for p in procs:
            logs.append(p.communicate(timeout=120)[0])
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
    assert all(p.returncode == 0 for p in procs), "\n".join(logs)
    results = [np.load(tmp_path / f"r{r}.npz") for r in range(WORLD)]

    for name in EXPLICIT + ["auto"]:
        want = _jax_sync(name, mesh4)
        for r in range(WORLD):
            for i in range(len(SHAPES)):
                np.testing.assert_allclose(
                    results[r][f"{name}/{i}"], want[i][r], rtol=1e-6, atol=1e-7,
                    err_msg=f"{name} rank {r} leaf {i}",
                )
    # The averaged strategies leave every rank with the same mean.
    mean = [np.mean([_rank_grads(r)[i] for r in range(WORLD)], axis=0) for i in range(len(SHAPES))]
    for name in EXPLICIT[1:] + ["auto"]:
        for i in range(len(SHAPES)):
            np.testing.assert_allclose(results[0][f"{name}/{i}"], mean[i], rtol=1e-5, atol=1e-6)


@pytest.mark.parametrize("world", [1, 2, 4])
@pytest.mark.parametrize("name", EXPLICIT + ["auto"])
def test_sync_wire_bytes_match_jax(name, world):
    from cs744_pytorch_distributed_tutorial_tpu.parallel.sync import (
        sync_wire_bytes as jax_wire_bytes,
    )

    params = {f"p{i}": np.zeros(s, np.float32) for i, s in enumerate(SHAPES)}
    tparams = [torch.zeros(s) for s in SHAPES]
    assert sync_wire_bytes(tparams, name, world) == jax_wire_bytes(params, name, world)


def test_none_strategy_leaves_grads_alone():
    g = torch.arange(5.0)
    sync_grads([g], "none", 1)
    assert torch.equal(g, torch.arange(5.0))


if __name__ == "__main__":
    _worker(int(sys.argv[1]), int(sys.argv[2]), sys.argv[3])
