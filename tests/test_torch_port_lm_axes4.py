"""The port's ``LMTrainer`` on 4 Gloo ranks laid out over the sequence,
tensor and expert axes, against the JAX ``LMTrainer`` on 4 host devices
with the same mesh.

One launch of 4 processes (this file, run as a script) trains every
layout in turn while JAX runs its own. The LM is tiny: 2 layers, d 32, 4
heads, d_ff 64, vocab 64, T 16, global batch 8, RoPE, fp32, from the JAX
init carried over by ``models/convert.py`` (each rank loads its slices of
the global tree), for 4 steps on the same batches:

1. seq 4, ``ring``, AdamW;
2. seq 4, ``ring_flash`` (the flash kernels' plain versions a hop; JAX's
   Pallas kernels in interpret mode, 4 positions a shard);
3. data 2 x seq 2, ``ulysses_flash``, 2 KV heads, the clip;
4. tensor 4, dense, dropout 0.1, zero1: both sides fed the same numpy
   masks (flax's ``nn.Dropout`` and the port's ``dropout_mask`` patched),
   so the losses must be JAX's; the port's own masks, drawn again
   unpatched, are the same on the four tensor ranks;
5. data 2 x tensor 2, fsdp, Lion;
6. seq 2 x tensor 2, ``ulysses``, sgd;
7. data 4, 4 experts split over the data axis, ``scatter``, zero1;
8. data 2 x tensor 2, 4 experts split over data, ``einsum``, AdamW with
   the clip.

Losses, ``grad_norm``, ``param_norm`` and the MoE statistics rtol 1e-5 on
every rank. The final parameters, gathered to the global tree on every
rank (``LMTrainer.state_dict``), rtol 1e-5, atol 1e-6; AdamW's as
``test_torch_port_lm_dp4.py`` holds them (all but one element in 10,000,
those within lr a step: an element whose ranks' gradients nearly cancel
carries the sum order into Adam's step, ``ROADMAP.md`` C). Every rank's
(data, seq, tensor) coordinates are its device's in the JAX mesh, and the
ring-flash layout's hops a step are n - 1 forward and n backward a layer.
"""

import os
import subprocess
import sys

import numpy as np
import pytest
import torch

WORLD, STEPS, BATCH, T, V = 4, 4, 8, 16, 64
SMALL = dict(vocab_size=V, num_layers=2, num_heads=4, d_model=32, d_ff=64, max_seq_len=T,
             seq_len=T, global_batch_size=BATCH, use_rope=True, learning_rate=1e-3)
CLIP = 0.05
DROPOUT = 0.1
# name: ((data, seq, tensor), options)
LAYOUTS = {
    "seq4_ring": ((1, 4, 1), dict(attention_impl="ring")),
    "seq4_ring_flash": ((1, 4, 1), dict(attention_impl="ring_flash")),
    "data2_seq2_ulysses_flash_gqa_clip": ((2, 2, 1), dict(attention_impl="ulysses_flash",
                                                          num_kv_heads=2, grad_clip_norm=CLIP)),
    "tensor4_dropout_zero1": ((1, 1, 4), dict(attention_impl="dense", dropout_rate=DROPOUT,
                                              zero1=True)),
    "data2_tensor2_fsdp_lion": ((2, 1, 2), dict(attention_impl="dense", fsdp=True,
                                                optimizer="lion")),
    "seq2_tensor2_ulysses_sgd": ((1, 2, 2), dict(attention_impl="ulysses", optimizer="sgd")),
    "data4_ep_scatter_zero1": ((4, 1, 1), dict(attention_impl="dense", moe_experts=4,
                                               moe_expert_parallel=True, moe_dispatch="scatter",
                                               zero1=True)),
    "data2_tensor2_ep_einsum_clip": ((2, 1, 2), dict(attention_impl="dense", moe_experts=4,
                                                     moe_expert_parallel=True,
                                                     moe_dispatch="einsum",
                                                     grad_clip_norm=CLIP)),
}
TOL = {"metrics": dict(rtol=1e-5), "params": dict(rtol=1e-5, atol=1e-6)}
ADAM_OUTLIERS = 1e-4
REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _config(name: str) -> dict:
    (d, s, t), kw = LAYOUTS[name]
    return dict(SMALL, **kw, data_parallel=d, seq_parallel=s, tensor_parallel=t)


def _init_key(name: str) -> str:
    kw = LAYOUTS[name][1]
    return "moe" if kw.get("moe_experts") else "gqa" if kw.get("num_kv_heads") else "base"


def _tokens():
    from cs744_pytorch_distributed_tutorial_tpu_torch.data import synthetic_tokens

    return synthetic_tokens(STEPS * BATCH, T, V, seed=1)


def _masks():
    """One fixed keep-mask a (layer, site), flax's call order."""
    rng = np.random.default_rng(4)
    return [rng.random((BATCH, T, SMALL["d_model"])) >= DROPOUT
            for _ in range(2 * SMALL["num_layers"])]


# ------------------------------------------------------------------ ranks
def _run(name: str, init: dict, toks, res: dict) -> None:
    from cs744_pytorch_distributed_tutorial_tpu_torch.models import transformer as TM
    from cs744_pytorch_distributed_tutorial_tpu_torch.parallel import collectives as C
    from cs744_pytorch_distributed_tutorial_tpu_torch.train.lm import LMConfig, LMTrainer

    cfg = LMConfig(**_config(name), device="cpu")
    real_mask = TM.dropout_mask
    if cfg.dropout_rate:
        masks = _masks()

        def fixed(key, shape, rate, device):  # (seed, step, microbatch, layer, site)
            return torch.from_numpy(masks[2 * key[3] + key[4]])

        TM.dropout_mask = fixed
    try:
        tr = LMTrainer(cfg)
        tr.init(state_dict=init)
        history: dict[str, list] = {}
        for s in range(STEPS):
            C.hops.clear()
            m = tr.train_step(*tr.split_batch(toks[s * BATCH : (s + 1) * BATCH]))
            for k, v in m.items():
                history.setdefault(k, []).append(float(v))
        res[f"{name}/hops"] = np.array(C.hops["seq"])
    finally:
        TM.dropout_mask = real_mask
    res.update({f"{name}/{k}": np.array(v) for k, v in history.items()})
    res.update({f"{name}/params/{k}": v.numpy() for k, v in tr.state_dict().items()})
    res[f"{name}/coords"] = np.array([tr.mesh.axis_index(a) for a in ("data", "seq", "tensor")])
    if cfg.dropout_rate:  # the port's own masks on this rank, unpatched
        drawn = []

        def spy(key, shape, rate, device):
            keep = real_mask(key, shape, rate, device)
            drawn.append(keep.numpy())
            return keep

        TM.dropout_mask = spy
        try:
            with torch.no_grad():
                tr.objective(*tr.split_batch(toks[:BATCH]), step=0)
        finally:
            TM.dropout_mask = real_mask
        res[f"{name}/own_masks"] = np.stack(drawn)


def _worker(rank: int, port: int, tmp: str, out_path: str) -> None:
    import torch.distributed as dist

    torch.set_num_threads(1)
    dist.init_process_group("gloo", init_method=f"tcp://localhost:{port}", world_size=WORLD,
                            rank=rank)
    try:
        inits = {key: torch.load(os.path.join(tmp, f"init_{key}.pt"))
                 for key in ("base", "gqa", "moe")}
        toks, res = _tokens(), {}
        for name in LAYOUTS:
            _run(name, inits[_init_key(name)], toks, res)
        np.savez(out_path, **res)
    finally:
        dist.destroy_process_group()


def _free_port() -> int:
    import socket

    with socket.socket() as s:
        s.bind(("localhost", 0))
        return s.getsockname()[1]


# -------------------------------------------------------------------- JAX
def _jax_mesh(name: str):
    import jax

    from cs744_pytorch_distributed_tutorial_tpu.parallel import make_mesh

    d, s, t = LAYOUTS[name][0]
    return make_mesh({"data": d, "seq": s, "tensor": t}, devices=jax.devices()[:WORLD])


def _flax_dropout(masks):
    """flax ``nn.Dropout.__call__`` fed ``masks`` in call order."""
    import jax.numpy as jnp

    calls = {"n": 0}

    def call(self, inputs, deterministic=None, rng=None):
        det = self.deterministic if deterministic is None else deterministic
        if det or self.rate == 0.0:
            return inputs
        mask = masks[calls["n"] % len(masks)]
        calls["n"] += 1
        return jnp.where(mask, inputs / (1.0 - self.rate), jnp.zeros_like(inputs))

    return call


class _InitOnce:
    """Stands in for the JAX trainer's host-side init model: the global
    variables of a model are drawn once (its first layout) and handed to
    the layouts after it, which lay them out by their own specs."""

    variables: dict = {}

    def __init__(self, key: str, model):
        self.key, self.model = key, model

    def init(self, rng, dummy):
        if self.key not in self.variables:
            self.variables[self.key] = self.model.init(rng, dummy)
        return self.variables[self.key]


def _jax_run(name: str, toks) -> dict:
    import flax.linen as fnn
    import jax

    from cs744_pytorch_distributed_tutorial_tpu.train import LMConfig as JaxConfig
    from cs744_pytorch_distributed_tutorial_tpu.train import LMTrainer as JaxTrainer

    cfg = _config(name)
    saved = fnn.Dropout.__call__
    if cfg.get("dropout_rate"):
        fnn.Dropout.__call__ = _flax_dropout(_masks())
    try:
        mesh = _jax_mesh(name)
        jt = JaxTrainer(JaxConfig(**cfg), mesh=mesh)
        model = jt._init_model()
        jt._init_model = lambda: _InitOnce(_init_key(name), model)
        params, opt = jt.init()
        init = jt.gather_for_decode(params)
        history: dict[str, list] = {}
        for s in range(STEPS):
            params, opt, m = jt.train_step(params, opt,
                                           *jt.shard_batch(toks[s * BATCH:(s + 1) * BATCH]), s)
            for k, v in m.items():
                history.setdefault(k, []).append(float(v))
    finally:
        fnn.Dropout.__call__ = saved
    devices = list(np.asarray(jax.devices()[:WORLD]))
    coords = [tuple(int(c) for c in np.argwhere(mesh.devices == dev)[0]) for dev in devices]
    return {"init": init, "history": history, "params": jt.gather_for_decode(params),
            "coords": coords}


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """(each rank's results, JAX's runs by layout)."""
    from cs744_pytorch_distributed_tutorial_tpu_torch.models.convert import lm_params_from_jax

    tmp = tmp_path_factory.mktemp("lm_axes4")
    toks = _tokens()
    firsts = {"base": "seq4_ring", "gqa": "data2_seq2_ulysses_flash_gqa_clip",
              "moe": "data4_ep_scatter_zero1"}
    want = {name: _jax_run(name, toks) for name in firsts.values()}
    for key, name in firsts.items():
        torch.save(lm_params_from_jax(want[name]["init"]), tmp / f"init_{key}.pt")
    port = _free_port()
    env = dict(os.environ, PYTHONPATH=REPO, OMP_NUM_THREADS="1")
    procs = [subprocess.Popen([sys.executable, os.path.abspath(__file__), str(r), str(port),
                               str(tmp), str(tmp / f"r{r}.npz")], env=env,
                              stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
             for r in range(WORLD)]
    try:  # the ranks train while JAX compiles and runs
        for name in LAYOUTS:
            if name not in want:
                want[name] = _jax_run(name, toks)
        logs = [p.communicate(timeout=300)[0] for p in procs]
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
    assert all(p.returncode == 0 for p in procs), "\n".join(logs)
    return [dict(np.load(tmp / f"r{r}.npz")) for r in range(WORLD)], want


# ------------------------------------------------------------------ tests
@pytest.mark.parametrize("name", list(LAYOUTS))
def test_trainer_matches_jax_on_four_ranks(runs, name):
    from cs744_pytorch_distributed_tutorial_tpu_torch.models.convert import lm_params_from_jax

    results, want = runs
    jr = want[name]
    kw = LAYOUTS[name][1]
    adam = kw.get("optimizer", "adamw") == "adamw"
    params = lm_params_from_jax(jr["params"])
    for r, res in enumerate(results):
        got_keys = sorted(k.split("/")[1] for k in res if k.startswith(f"{name}/")
                          and k.count("/") == 1 and k.split("/")[1] not in ("hops", "coords",
                                                                            "own_masks"))
        assert got_keys == sorted(jr["history"]), (name, r)
        for key, values in jr["history"].items():
            np.testing.assert_allclose(res[f"{name}/{key}"], values, **TOL["metrics"],
                                       err_msg=f"{name} {key}, rank {r}")
        if not adam:
            for k, v in params.items():
                np.testing.assert_allclose(res[f"{name}/params/{k}"], v.numpy(), **TOL["params"],
                                           err_msg=f"{name} {k}, rank {r}")
            continue
        gaps = np.concatenate([np.abs(res[f"{name}/params/{k}"] - v.numpy()).ravel()
                               for k, v in params.items()])
        limit = np.concatenate([TOL["params"]["atol"] + TOL["params"]["rtol"]
                                * np.abs(v.numpy()).ravel() for v in params.values()])
        assert (gaps > limit).sum() <= ADAM_OUTLIERS * gaps.size, (name, r)
        assert gaps.max() <= SMALL["learning_rate"] * STEPS and gaps.mean() <= 1e-6, (name, r)


def test_ranks_sit_where_the_jax_mesh_puts_their_devices(runs):
    results, want = runs
    for name in LAYOUTS:
        for r, res in enumerate(results):
            assert tuple(res[f"{name}/coords"]) == want[name]["coords"][r], (name, r)


def test_tensor_ranks_draw_the_same_dropout_masks(runs):
    results, _ = runs
    name = "tensor4_dropout_zero1"
    masks = [res[f"{name}/own_masks"] for res in results]
    assert masks[0].shape == (2 * SMALL["num_layers"], BATCH, T, SMALL["d_model"])
    assert 0.8 < masks[0].mean() < 1.0
    for m in masks[1:]:
        np.testing.assert_array_equal(m, masks[0])


def test_ring_flash_hops_a_step(runs):
    """n - 1 hops in the forward and n in the backward, a layer."""
    results, _ = runs
    n, layers = LAYOUTS["seq4_ring_flash"][0][1], SMALL["num_layers"]
    for res in results:
        assert int(res["seq4_ring_flash/hops"]) == layers * (2 * n - 1)
        assert int(res["seq4_ring/hops"]) == layers * 2 * (n - 1)


# ------------------------------------------------- refusals, in one process
REJECTIONS = [
    (dict(seq_parallel=2, attention_impl="dense"), "incompatible with seq_parallel"),
    (dict(seq_parallel=2, attention_impl="flash"), "incompatible with seq_parallel"),
    (dict(seq_parallel=3, attention_impl="ring"), "not divisible by seq axis"),
    (dict(tensor_parallel=3, attention_impl="dense"), "num_heads 4 not divisible by tensor"),
    (dict(tensor_parallel=4, d_ff=66, attention_impl="dense"), "d_ff 66 not divisible"),
    (dict(tensor_parallel=2, seq_parallel=4, attention_impl="ulysses"),
     "per-tensor-shard heads"),
    (dict(data_parallel=2, moe_experts=3, moe_expert_parallel=True, attention_impl="dense"),
     "not divisible by the data axis"),
    (dict(data_parallel=2, moe_experts=4, moe_expert_parallel=True, moe_dispatch="dropless",
          attention_impl="dense"), "does not compose with moe_expert_parallel"),
    (dict(tensor_parallel=2, grad_compress="int8", attention_impl="dense"),
     "requires a data-parallel layout"),
    (dict(seq_parallel=2, zero1=True, sync_overlap="bucket", attention_impl="ring"),
     "sync_overlap requires a data-parallel layout"),
]


@pytest.mark.parametrize("kw,match", REJECTIONS)
def test_rejections_are_jax_s(kw, match):
    """The JAX ``LMTrainer``'s refusals of these layouts: the same type
    and message on both sides, the port's before any process group."""
    import jax

    from cs744_pytorch_distributed_tutorial_tpu.parallel import make_mesh
    from cs744_pytorch_distributed_tutorial_tpu.train import LMConfig as JaxConfig
    from cs744_pytorch_distributed_tutorial_tpu.train import LMTrainer as JaxTrainer
    from cs744_pytorch_distributed_tutorial_tpu_torch.train.lm import LMConfig, LMTrainer

    cfg = {**SMALL, **kw}
    sizes = {a: cfg.get(f"{a}_parallel", 1) for a in ("data", "seq", "tensor")}
    mesh = make_mesh(sizes, devices=jax.devices()[:int(np.prod(list(sizes.values())))])
    with pytest.raises(ValueError, match=match):
        JaxTrainer(JaxConfig(**cfg), mesh=mesh)
    with pytest.raises(ValueError, match=match):
        LMTrainer(LMConfig(**cfg, device="cpu"))


def test_restore_into_another_tensor_parallel_raises():
    """A state's tensor slices are layout-pinned (JAX: tensor_parallel
    must match the save); the world alone may not differ either."""
    from cs744_pytorch_distributed_tutorial_tpu_torch.train.lm import LMConfig, LMTrainer

    tr = LMTrainer(LMConfig(**SMALL, attention_impl="dense", device="cpu"))
    tr.init()
    state = tr.capture_state(clone=True)
    assert state["layout"] == [1, 1, 1]
    tr.restore_state(state)
    with pytest.raises(ValueError, match="layout-pinned"):
        tr.restore_state({**state, "layout": [1, 1, 2]})
    with pytest.raises(ValueError, match="world"):
        tr.restore_state({**state, "world_size": 2})


SPEC_MODELS = {
    "gpt2": dict(use_rope=False),
    "llama_gqa": dict(norm="rmsnorm", mlp="swiglu", num_kv_heads=2),
    "scan_layers": dict(scan_layers=True),
    "moe": dict(num_experts=4),
}


@pytest.mark.parametrize("model", list(SPEC_MODELS))
def test_rank_slices_are_jax_s(model):
    """``lm_shard_from_jax`` (the port's ``lm_param_specs`` on its names)
    cuts every parameter as the JAX ``lm_param_specs`` cuts the flax tree,
    at every (data, tensor) coordinate, and ``jax_lm_params_from_shards``
    joins the slices back into the JAX tree."""
    import jax
    import jax.numpy as jnp

    from cs744_pytorch_distributed_tutorial_tpu.models.transformer import (
        TransformerLM as JaxLM,
    )
    from cs744_pytorch_distributed_tutorial_tpu.models.transformer import (
        lm_param_specs as jax_specs,
    )
    from cs744_pytorch_distributed_tutorial_tpu_torch.models import convert

    kw = {**{k: SMALL[k] for k in ("vocab_size", "num_layers", "num_heads", "d_model", "d_ff",
                                   "max_seq_len", "use_rope")}, **SPEC_MODELS[model]}
    params = jax.device_get(JaxLM(**kw, attention_impl="dense").init(
        jax.random.key(0), jnp.zeros((2, T), jnp.int32))["params"])
    expert = "num_experts" in kw
    specs = jax_specs(params, "tensor", "data" if expert else None)
    sizes = {"data": 2, "seq": 1, "tensor": 2, "expert": 2 if expert else 1}
    shards = []
    for d in range(2):
        for t in range(2):
            coords = {"data": d, "seq": 0, "tensor": t}

            def cut(x, spec, coords=coords):
                x = np.asarray(x)
                for dim, axis in enumerate(tuple(spec)):
                    if axis is not None:
                        n = x.shape[dim] // 2
                        x = x[(slice(None),) * dim + (slice(coords[axis] * n,
                                                            (coords[axis] + 1) * n),)]
                return x

            want = convert.lm_params_from_jax(jax.tree.map(
                cut, params, specs, is_leaf=lambda x: isinstance(x, np.ndarray)))
            got = convert.lm_shard_from_jax(params, coords, sizes)
            assert sorted(got) == sorted(want)
            for name, value in want.items():
                np.testing.assert_array_equal(got[name].numpy(), value.numpy(), err_msg=name)
            shards.append((coords, got))
    back = convert.jax_lm_params_from_shards(shards, sizes)
    for (path, a), (_, b) in zip(jax.tree_util.tree_flatten_with_path(params)[0],
                                 jax.tree_util.tree_flatten_with_path(back)[0], strict=True):
        np.testing.assert_array_equal(np.asarray(a), np.asarray(b), err_msg=str(path))


@pytest.mark.parametrize("flags,match", [
    (["--seq-parallel", "2", "--attention-impl", "dense"], "incompatible with seq_parallel"),
    (["--tensor-parallel", "2", "--seq-parallel", "2"], "must equal the world size")])
def test_lm_cli_refuses_before_any_process_group(flags, match):
    from cs744_pytorch_distributed_tutorial_tpu_torch import lm_cli

    argv = ["--num-layers", "2", "--d-model", "32", "--num-heads", "4", "--d-ff", "64",
            "--vocab-size", "64", "--max-seq-len", "16", "--seq-len", "16", "--steps", "1",
            "--num-seqs", "8", "--device", "cpu", *flags]
    error = ValueError if "incompatible" in match else SystemExit
    with pytest.raises(error, match=match):
        lm_cli.main(argv)


if __name__ == "__main__":
    _worker(int(sys.argv[1]), int(sys.argv[2]), sys.argv[3], sys.argv[4])
