"""The port's int8 gradient wire against the JAX package's.

``quantize_chunked``/``dequantize_chunked`` must be JAX's bit for bit,
an all-zero chunk and exact half-step ties included. One launch of 4
Gloo processes (this file, run as a script) runs the flat wires
``_int8_allreduce_flat`` and ``_int8_ring_flat`` on per-rank buffers
whose sizes are not multiples of n x Q, the per-tensor ``int8_*``
strategies through ``sync_grads``, and ``sync_grads_compressed`` with
error feedback over several buckets; the JAX functions run on the same
buffers under ``shard_map`` on 4 host devices. Means and residuals agree
within 2^-20 of the largest input value (about 8 fp32 ulps of it), not
bit for bit: XLA's CPU backend compiles each multiply-add of the JAX
code (a dequantize feeding a sum or a difference) into one fused
multiply-add with a single rounding, while the port rounds the product
first. The codes themselves, and the wire at a world of one, are JAX's
bit for bit; the all-to-all wire's residuals keep the error-feedback
identity ``mean + sum(residual) / n == mean of the inputs``.
"""

import os
import subprocess
import sys

import numpy as np
import pytest
import torch

from cs744_pytorch_distributed_tutorial_tpu_torch.ops.quant import (
    dequantize_chunked,
    quantize_chunked,
)
from cs744_pytorch_distributed_tutorial_tpu_torch.parallel import sync as S

WORLD = 4
SIZES = [1, 77, 1000, 3000, 4 * 256 + 5]
LEAVES = [(3, 5, 7), (10,), (1,), (16, 3, 3, 3), (300,), (40, 25)]
BUCKET_BYTES = 2048  # several buckets over LEAVES
TOL = 2.0**-20  # x the largest input value; see the module docstring
REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _buffer(rank: int, size: int) -> np.ndarray:
    rng = np.random.default_rng(1000 * size + rank)
    x = rng.standard_normal(size).astype(np.float32)
    x[: size // 3] *= 1e-3  # chunks of very different scales
    return x


def _leaves(rank: int, seed: int) -> list[np.ndarray]:
    rng = np.random.default_rng(seed + rank)
    return [rng.standard_normal(s).astype(np.float32) for s in LEAVES]


def _input_max(key: str) -> float:
    kind, rest = key.split("/", 1)
    if kind in ("allreduce", "ring"):
        size = int(rest.split("/")[0])
        return max(float(np.abs(_buffer(r, size)).max()) for r in range(WORLD))
    seeds = (10,) if kind == "leaf" else (20, 30)
    return sum(max(float(np.abs(g).max()) for r in range(WORLD) for g in _leaves(r, seed))
               for seed in seeds)


def _worker(rank: int, port: int, out_path: str) -> None:
    import torch.distributed as dist

    dist.init_process_group(
        "gloo", init_method=f"tcp://localhost:{port}", world_size=WORLD, rank=rank
    )
    try:
        res = {}
        for size in SIZES:
            x = torch.from_numpy(_buffer(rank, size))
            for name, fn in (("allreduce", S._int8_allreduce_flat), ("ring", S._int8_ring_flat)):
                mean, resid = fn(x, WORLD)
                res[f"{name}/{size}/mean"], res[f"{name}/{size}/resid"] = mean.numpy(), resid.numpy()
        for name in ("int8_allreduce", "int8_ring"):
            ts = [torch.from_numpy(g) for g in _leaves(rank, 10)]
            S.sync_grads(ts, name, WORLD)
            res.update({f"leaf/{name}/{i}": t.numpy() for i, t in enumerate(ts)})
        for name in ("int8_allreduce", "int8_ring"):
            gs = [torch.from_numpy(g) for g in _leaves(rank, 20)]
            ef = [torch.from_numpy(e) * 1e-2 for e in _leaves(rank, 30)]
            S.sync_grads_compressed(gs, ef, name, WORLD, bucket_bytes=BUCKET_BYTES)
            res.update({f"comp/{name}/g/{i}": t.numpy() for i, t in enumerate(gs)})
            res.update({f"comp/{name}/ef/{i}": t.numpy() for i, t in enumerate(ef)})
        np.savez(out_path, **res)
    finally:
        dist.destroy_process_group()


def _free_port() -> int:
    import socket

    with socket.socket() as s:
        s.bind(("localhost", 0))
        return s.getsockname()[1]


def _spawn(tmp_path) -> list:
    port = _free_port()
    env = dict(os.environ, PYTHONPATH=REPO, OMP_NUM_THREADS="1")
    procs = [
        subprocess.Popen(
            [sys.executable, os.path.abspath(__file__), str(r), str(port),
             str(tmp_path / f"r{r}.npz")],
            env=env, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True,
        )
        for r in range(WORLD)
    ]
    return procs


def _collect(procs, tmp_path) -> list:
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
    return [np.load(tmp_path / f"r{r}.npz") for r in range(WORLD)]


def _shard_map(fn, mesh, n_out):
    import jax
    from jax.sharding import PartitionSpec as P

    def local(*xs):
        outs = fn(*[x[0] for x in xs])
        return tuple(o[None] for o in outs)

    return jax.jit(jax.shard_map(local, mesh=mesh, in_specs=P("data"),
                                 out_specs=(P("data"),) * n_out, check_vma=False))


def test_int8_wire_matches_jax_over_four_gloo_ranks(tmp_path, mesh4):
    import jax

    from cs744_pytorch_distributed_tutorial_tpu.parallel import sync as JS

    procs = _spawn(tmp_path)  # the ranks run while JAX compiles
    want = {}
    for size in SIZES:
        x = np.stack([_buffer(r, size) for r in range(WORLD)])
        for name, fn in (("allreduce", JS._int8_allreduce_flat), ("ring", JS._int8_ring_flat)):
            mean, resid = _shard_map(lambda b, f=fn: f(b, "data", WORLD), mesh4, 2)(x)
            want[f"{name}/{size}/mean"], want[f"{name}/{size}/resid"] = mean, resid
    for name in ("int8_allreduce", "int8_ring"):
        stacked = [np.stack([_leaves(r, 10)[i] for r in range(WORLD)]) for i in range(len(LEAVES))]
        outs = _shard_map(lambda *ls, n=name: JS.sync_grads(list(ls), n, "data", WORLD),
                          mesh4, len(LEAVES))(*stacked)
        want.update({f"leaf/{name}/{i}": o for i, o in enumerate(outs)})
    for name in ("int8_allreduce", "int8_ring"):
        gs = [np.stack([_leaves(r, 20)[i] for r in range(WORLD)]) for i in range(len(LEAVES))]
        es = [np.stack([_leaves(r, 30)[i] * np.float32(1e-2) for r in range(WORLD)])
              for i in range(len(LEAVES))]
        k = len(LEAVES)

        def comp(*ls, n=name):
            mean, ef = JS.sync_grads_compressed(list(ls[:k]), list(ls[k:]), n, "data", WORLD,
                                                bucket_bytes=BUCKET_BYTES)
            return (*mean, *ef)

        outs = _shard_map(comp, mesh4, 2 * k)(*gs, *es)
        want.update({f"comp/{name}/g/{i}": o for i, o in enumerate(outs[:k])})
        want.update({f"comp/{name}/ef/{i}": o for i, o in enumerate(outs[k:])})
    want = jax.tree.map(np.asarray, want)

    results = _collect(procs, tmp_path)
    for key, value in want.items():
        atol = TOL * _input_max(key)
        for r in range(WORLD):
            np.testing.assert_allclose(results[r][key], value[r], rtol=0, atol=atol,
                                       err_msg=f"{key} rank {r}")
    # The mean is every rank's, and close to the exact one.
    for size in SIZES:
        exact = np.mean([_buffer(r, size) for r in range(WORLD)], axis=0)
        for name in ("allreduce", "ring"):
            got = results[0][f"{name}/{size}/mean"]
            for r in range(1, WORLD):
                np.testing.assert_array_equal(results[r][f"{name}/{size}/mean"], got)
            assert np.abs(got - exact).max() <= 0.05 * np.abs(exact).max()
        # The all-to-all wire feeds back every rounding it makes (the ring
        # leaves its per-hop requantizations out, by design).
        got = results[0][f"allreduce/{size}/mean"]
        fed_back = got + sum(results[r][f"allreduce/{size}/resid"] for r in range(WORLD)) / WORLD
        np.testing.assert_allclose(fed_back, exact, rtol=0, atol=TOL * _input_max(f"allreduce/{size}"))


@pytest.mark.parametrize("name", ["allreduce", "ring"])
@pytest.mark.parametrize("size", SIZES)
def test_int8_wire_at_world_one_still_quantizes(name, size):
    from cs744_pytorch_distributed_tutorial_tpu.parallel import sync as JS

    x = _buffer(0, size)
    port_fn = S._int8_allreduce_flat if name == "allreduce" else S._int8_ring_flat
    jax_fn = JS._int8_allreduce_flat if name == "allreduce" else JS._int8_ring_flat
    mean, resid = port_fn(torch.from_numpy(x), 1)
    want_mean, want_resid = jax_fn(x, "data", 1)
    np.testing.assert_array_equal(mean.numpy(), np.asarray(want_mean))
    np.testing.assert_array_equal(resid.numpy(), np.asarray(want_resid))
    if size > 1:  # a lone element is its chunk's max, and exact
        assert np.abs(resid.numpy()).max() > 0  # not the identity
    np.testing.assert_array_equal(mean.numpy() + resid.numpy(), x)


def _tie_chunks(chunk: int) -> np.ndarray:
    """Three chunks: random, all zero, and exact half-step ties (max 127,
    so the scale is 1 and x / scale is x)."""
    rng = np.random.default_rng(3)
    ties = np.zeros(chunk, np.float32)
    ties[0] = 127.0
    halves = np.arange(1, chunk) % 20 - 10 + 0.5
    ties[1:] = halves.astype(np.float32)
    return np.concatenate([rng.standard_normal(chunk).astype(np.float32) * 3,
                           np.zeros(chunk, np.float32), ties])


@pytest.mark.parametrize("chunk", [8, 256])
def test_quantize_chunked_bitwise_vs_jax(chunk):
    import jax.numpy as jnp

    from cs744_pytorch_distributed_tutorial_tpu.ops.quant import (
        dequantize_chunked as jax_dequant,
    )
    from cs744_pytorch_distributed_tutorial_tpu.ops.quant import (
        quantize_chunked as jax_quant,
    )

    x = _tie_chunks(chunk)
    q, scale = quantize_chunked(torch.from_numpy(x), chunk)
    jq, jscale = jax_quant(jnp.asarray(x), chunk)
    assert q.dtype == torch.int8 and scale.dtype == torch.float32
    np.testing.assert_array_equal(q.numpy(), np.asarray(jq))
    np.testing.assert_array_equal(scale.numpy(), np.asarray(jscale))
    assert scale[1] == 1.0 and not q[1].any()  # the all-zero chunk
    assert (q[2, 1:].numpy() == np.round(x[2 * chunk + 1 :])).all()  # half to even
    deq = dequantize_chunked(q, scale)
    np.testing.assert_array_equal(deq.numpy(), np.asarray(jax_dequant(jq, jscale)))
    with pytest.raises(ValueError, match="multiple of"):
        quantize_chunked(torch.zeros(chunk + 1), chunk)


if __name__ == "__main__":
    _worker(int(sys.argv[1]), int(sys.argv[2]), sys.argv[3])
