"""The port's ViT family (``models/vit.py``) and its CIFAR training options
against the JAX package's.

Weights come from the flax init through ``models/convert.py``; inputs are
numpy draws from fixed seeds (NHWC for JAX, the same arrays permuted to
NCHW for the port):

- the forward (fp32, 2 layers, narrow) with dense and with flash
  attention at T 65 (patch 4) and T 17 (patch 8), rtol/atol 2e-5 (the JAX
  suite's ``tests/test_vit.py`` bound); the port's flash takes its plain
  versions on the CPU, the JAX flash runs ``flash_interpret=True``;
- 3 ``Trainer`` steps of a vit_tiny-shaped narrow model (both registries
  patched to the narrow widths) against the JAX ``Trainer``: sync
  ``none`` and ``ring`` with flash (under ``none`` against JAX's dense
  attention: JAX's flash does not trace there), ``auto`` with dense;
  losses within
  rtol 1e-4, final parameters within rtol 1e-4 / atol 1e-5 (the bounds of
  ``test_torch_port_trainer.py``);
- dropout (on ``pos_drop`` and every block's two sites): rate 0 is
  bitwise the dropout-free path; masks are fixed by the key and change
  with the step; the keep fraction is within 5 binomial standard
  deviations of 1 - rate and kept values are scaled by 1 / (1 - rate);
  with flax's ``nn.Dropout`` fed the port's masks (patched in this test
  only) the loss is within 1e-5 relative of the flax model's; the
  trainer's key moves with the step;
- every JAX refusal of ``dropout_rate``/``vit_attention``/``patch_size``
  raises the same exception type in the port, and ``causal=False``
  refuses the sequence axis, the decode modes and the KV caches;
- ``--dropout`` through ``cli.main`` on the CPU; the converter's round
  trip bitwise; ``get_model`` builds the three factories.
"""

import functools
import json
import math

import numpy as np
import pytest
import torch
import torch.distributed as dist
import torch.nn.functional as F

from cs744_pytorch_distributed_tutorial_tpu_torch import cli
from cs744_pytorch_distributed_tutorial_tpu_torch import models as PM
from cs744_pytorch_distributed_tutorial_tpu_torch.config import TrainConfig
from cs744_pytorch_distributed_tutorial_tpu_torch.models import transformer as T
from cs744_pytorch_distributed_tutorial_tpu_torch.models.convert import (
    jax_vit_params_from_state_dict,
    vit_state_dict_from_jax,
)
from cs744_pytorch_distributed_tutorial_tpu_torch.models.vit import ViT, vit_tiny
from cs744_pytorch_distributed_tutorial_tpu_torch.train import Trainer

NARROW = dict(d_model=32, num_layers=2, num_heads=2, d_ff=64)
STEPS, BATCH, LR = 3, 8, 0.02


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _images(b: int, seed: int) -> np.ndarray:
    return np.random.default_rng(seed).standard_normal((b, 32, 32, 3)).astype(np.float32)


def _nchw(x: np.ndarray) -> torch.Tensor:
    return torch.from_numpy(x).permute(0, 3, 1, 2).contiguous()


@functools.lru_cache(maxsize=None)
def _jax_params(patch_size: int):
    """The flax init of the narrow ViT at ``patch_size`` (the same tree for
    every attention and dropout option), with a non-zero class token and
    biases, so that they enter the outputs."""
    import jax
    import jax.numpy as jnp

    from cs744_pytorch_distributed_tutorial_tpu.models.vit import ViT as JaxViT

    model = JaxViT(**NARROW, patch_size=patch_size)
    params = jax.jit(model.init)(jax.random.key(0), jnp.zeros((1, 32, 32, 3)))["params"]
    rng = np.random.default_rng(7)
    params = jax.tree_util.tree_map_with_path(
        lambda path, v: (jnp.asarray(0.1 * rng.standard_normal(v.shape), v.dtype)
                         if path[-1].key in ("cls_token", "bias") else v), params)
    return jax.device_get(params)


def _jax_vit(patch_size: int = 4, **kw):
    from cs744_pytorch_distributed_tutorial_tpu.models.vit import ViT as JaxViT

    return JaxViT(**NARROW, patch_size=patch_size, **kw), _jax_params(patch_size)


# ------------------------------------------------------------ the forward
@pytest.mark.parametrize("impl", ["dense", "flash"])
@pytest.mark.parametrize("patch", [4, 8], ids=["T65", "T17"])
def test_forward_matches_jax(patch, impl):
    import jax
    import jax.numpy as jnp

    kw = dict(NARROW, patch_size=patch)
    jm, params = _jax_vit(patch, attention_impl=impl, flash_interpret=True)
    x = _images(2, patch)
    want = np.asarray(jax.jit(jm.apply)({"params": params}, jnp.asarray(x)))
    model = ViT(**kw, attention_impl=impl)
    model.load_state_dict(vit_state_dict_from_jax(params))
    assert model.pos_embed.shape[1] == (32 // patch) ** 2 + 1
    got = model(_nchw(x))
    assert got.dtype == torch.float32 and got.shape == (2, 10)
    np.testing.assert_allclose(got.detach().numpy(), want, rtol=2e-5, atol=2e-5)


def test_patch_grid_is_flattened_in_the_jax_order():
    """The tokens after the patch embedding, before the class token, equal
    the JAX model's NHWC reshape: row-major over (h, w)."""
    import jax
    import jax.numpy as jnp
    import flax.linen as fnn

    _, params = _jax_vit()
    x = _images(1, 3)
    conv = fnn.Conv(NARROW["d_model"], (4, 4), strides=(4, 4))
    want = conv.apply({"params": params["patch_embed"]}, jnp.asarray(x))
    want = np.asarray(want).reshape(1, -1, NARROW["d_model"])
    model = ViT(**NARROW)
    model.load_state_dict(vit_state_dict_from_jax(params))
    got = model.patch_embed(_nchw(x)).flatten(2).transpose(1, 2)
    np.testing.assert_allclose(got.detach().numpy(), want, rtol=1e-5, atol=1e-5)


def test_factories_build_with_the_jax_defaults():
    gen = torch.Generator().manual_seed(0)
    for name, (patch, d, layers, heads, d_ff) in {
            "vit_tiny": (4, 192, 6, 3, 768), "vit_small": (4, 384, 8, 6, 1536),
            "vit_wide_p8": (8, 384, 6, 3, 1536)}.items():
        m = PM.get_model(name, num_classes=10, generator=gen)
        assert (m.patch_size, m.d_model, m.num_heads, len(m.blocks)) == (patch, d, heads, layers)
        assert m.blocks[0].mlp_in.out_features == d_ff and not list(m.buffers())
        assert m.head.weight.dtype == torch.float32 and not m.cls_token.any()
        assert abs(float(m.pos_embed.detach().std()) - 0.02) < 0.002
    out = vit_tiny(**NARROW)(torch.zeros(2, 3, 32, 32))
    assert out.shape == (2, 10) and out.dtype == torch.float32


def test_convert_round_trip_is_bitwise():
    import jax

    _, params = _jax_vit()
    sd = vit_state_dict_from_jax(params)
    model = ViT(**NARROW)
    assert set(sd) == set(model.state_dict())
    assert sd["patch_embed.weight"].shape == (32, 3, 4, 4)
    back = jax_vit_params_from_state_dict(sd)
    assert jax.tree.all(jax.tree.map(lambda a, b: np.array_equal(np.asarray(a), b), params,
                                     back))
    again = vit_state_dict_from_jax(back)
    assert all(torch.equal(sd[k], again[k]) for k in sd)


# ------------------------------------------------------------ the trainer
@pytest.fixture
def narrow_registries(monkeypatch):
    """``vit_tiny`` in both registries built at the narrow widths."""
    from cs744_pytorch_distributed_tutorial_tpu import models as JM
    from cs744_pytorch_distributed_tutorial_tpu.models.vit import ViT as JaxViT

    monkeypatch.setitem(JM.MODEL_REGISTRY, "vit_tiny", lambda **kw: JaxViT(**{**NARROW, **kw}))
    monkeypatch.setitem(PM.MODEL_REGISTRY, "vit_tiny", lambda **kw: ViT(**{**NARROW, **kw}))


@pytest.fixture
def gloo_world_of_one():
    import socket

    with socket.socket() as s:
        s.bind(("localhost", 0))
        port = s.getsockname()[1]
    dist.init_process_group("gloo", init_method=f"tcp://localhost:{port}", world_size=1, rank=0)
    try:
        yield
    finally:
        dist.destroy_process_group()


def _jax_trajectory(cfg_kw: dict, images: np.ndarray, labels: np.ndarray):
    import jax

    from cs744_pytorch_distributed_tutorial_tpu.config import TrainConfig as JaxConfig
    from cs744_pytorch_distributed_tutorial_tpu.parallel import make_mesh
    from cs744_pytorch_distributed_tutorial_tpu.parallel.mesh import shard_global_batch
    from cs744_pytorch_distributed_tutorial_tpu.train import Trainer as JaxTrainer

    mesh1 = make_mesh({"data": 1}, devices=jax.devices()[:1])
    jtr = JaxTrainer(JaxConfig(**cfg_kw), mesh=mesh1)
    state = jtr.init()
    init = jax.device_get(state.params)
    losses = []
    for s in range(STEPS):
        rows = slice(s * BATCH, (s + 1) * BATCH)
        xb, yb = shard_global_batch(mesh1, images[rows], labels[rows])
        state, metrics = jtr.train_step(state, xb, yb, jax.random.key(0))
        losses.append(float(metrics["loss"]))
    return init, losses, jax.device_get(state.params)


# JAX's flash ViT under 'none' does not trace on this JAX (its shard_map's
# check_vma rejects the Pallas call's output), so the port's flash under
# 'none' is held against JAX's dense attention there.
@pytest.mark.parametrize("sync,attention,jax_attention", [
    ("none", "flash", "dense"), ("ring", "flash", "flash"), ("auto", "dense", "dense")])
def test_trainer_steps_match_jax(narrow_registries, gloo_world_of_one, sync, attention,
                                 jax_attention):
    import jax

    from cs744_pytorch_distributed_tutorial_tpu.data import synthetic_cifar10

    ds = synthetic_cifar10(STEPS * BATCH, 8, seed=0)
    kw = dict(model="vit_tiny", sync=sync, num_devices=1, global_batch_size=BATCH,
              synthetic_data=True, augment=False, learning_rate=LR, vit_attention=attention)
    init, want_losses, want = _jax_trajectory(dict(kw, vit_attention=jax_attention),
                                              ds.train_images, ds.train_labels)
    tr = Trainer(TrainConfig(**kw, device="cpu"))
    tr.model.load_state_dict(vit_state_dict_from_jax(init))
    losses = []
    for s in range(STEPS):
        rows = slice(s * BATCH, (s + 1) * BATCH)
        x = torch.from_numpy(ds.train_images[rows])
        y = torch.from_numpy(ds.train_labels[rows].astype(np.int64))
        losses.append(float(tr.train_step(x, y)))
    np.testing.assert_allclose(losses, want_losses, rtol=1e-4)
    got = jax_vit_params_from_state_dict(tr.model.state_dict())
    for path, a in jax.tree_util.tree_leaves_with_path(want):
        b = got
        for key in path:
            b = b[key.key]
        np.testing.assert_allclose(b, np.asarray(a), rtol=1e-4, atol=1e-5, err_msg=str(path))


# ------------------------------------------------------------ dropout
def _narrow_model(rate: float, impl: str = "flash") -> ViT:
    return ViT(**NARROW, attention_impl=impl, dropout_rate=rate,
               generator=torch.Generator().manual_seed(1))


def test_dropout_rate_zero_is_the_dropout_free_path():
    x = _nchw(_images(2, 1))
    model = _narrow_model(0.0)
    with torch.no_grad():
        assert torch.equal(model(x), model(x, dropout=(0, 5, 0)))
    cfg = dict(model="vit_tiny", sync="none", num_devices=1, global_batch_size=4,
               synthetic_data=True, augment=False, device="cpu")
    xs = torch.from_numpy((np.random.default_rng(2).random((4, 32, 32, 3)) * 255)
                          .astype(np.uint8))
    ys = torch.arange(4)
    runs = []
    for extra in ({}, {"dropout_rate": 0.0}):
        tr = Trainer(TrainConfig(**cfg, **extra))
        runs.append([float(tr.train_step(xs, ys)) for _ in range(2)])
    assert runs[0] == runs[1]


def test_dropout_masks_are_keyed_by_the_step():
    x = _nchw(_images(2, 1))
    model = _narrow_model(0.3)
    with torch.no_grad():
        a, again = model(x, dropout=(0, 1, 0)), model(x, dropout=(0, 1, 0))
        b = model(x, dropout=(0, 2, 0))
        plain = model(x)
    assert torch.equal(a, again) and not torch.equal(a, b) and not torch.equal(a, plain)


def test_trainer_keys_dropout_by_seed_step_and_rank(monkeypatch):
    seen = []
    real = T.dropout_mask

    def spy(key, shape, rate, device):
        seen.append(tuple(key))
        return real(key, shape, rate, device)

    monkeypatch.setattr(T, "dropout_mask", spy)
    cfg = TrainConfig(model="vit_tiny", sync="none", num_devices=1, global_batch_size=2,
                      synthetic_data=True, augment=False, dropout_rate=0.1, seed=11,
                      device="cpu")
    tr = Trainer(cfg)
    xs, ys = torch.zeros(2, 32, 32, 3, dtype=torch.uint8), torch.tensor([0, 1])
    tr.train_step(xs, ys)
    tr.train_step(xs, ys)
    layers = len(tr.model.blocks)
    per_step = 1 + 2 * layers  # pos_drop, then each block's two sites
    assert len(seen) == 2 * per_step
    assert seen[0] == (11, 0, 0, -1, 0) and seen[per_step] == (11, 1, 0, -1, 0)
    assert {k[3:] for k in seen[:per_step]} == {(-1, 0)} | {(i, s) for i in range(layers)
                                                           for s in (0, 1)}


def test_keep_fraction_and_scale():
    rate, captured = 0.3, []
    real = T.dropout_mask

    def spy(key, shape, r, device):
        mask = real(key, shape, r, device)
        captured.append(mask)
        return mask

    model = _narrow_model(rate)
    x = _nchw(_images(8, 4))
    try:
        T.dropout_mask = spy
        with torch.no_grad():
            model(x, dropout=(3, 0, 0))
    finally:
        T.dropout_mask = real
    n = sum(m.numel() for m in captured)
    kept = sum(int(m.sum()) for m in captured)
    assert len(captured) == 1 + 2 * NARROW["num_layers"]
    assert abs(kept / n - (1 - rate)) <= 5 * math.sqrt(rate * (1 - rate) / n)
    # pos_drop's kept values are scaled by 1 / (1 - rate), the rest zero.
    inp = torch.ones(2, 3, 4)
    out = T.dropout(inp, rate, (0, 0, 0, -1, 0))
    keep = real((0, 0, 0, -1, 0), inp.shape, rate, inp.device)
    assert torch.equal(out, torch.where(keep, inp / (1 - rate), torch.zeros(())))


def test_dropout_with_the_same_masks_matches_flax(monkeypatch):
    """flax's ``nn.Dropout`` and the port's mask source replaced by the same
    numpy masks, in flax's call order (pos_drop, then each block's
    attn_drop and mlp_drop): the mean cross-entropy within 1e-5 relative."""
    import flax.linen as fnn
    import jax
    import jax.numpy as jnp
    import optax

    rate, b = 0.3, 2
    x = _images(b, 5)
    labels = np.array([3, 7])
    jm, params = _jax_vit(dropout_rate=rate)
    t = (32 // 4) ** 2 + 1
    rng = np.random.default_rng(6)
    masks = [rng.random((b, t, NARROW["d_model"])) >= rate
             for _ in range(1 + 2 * NARROW["num_layers"])]
    calls = {"n": 0}

    def flax_dropout(self, inputs, deterministic=None, rng=None):
        mask = masks[calls["n"]]
        calls["n"] += 1
        return jnp.where(mask, inputs / (1.0 - self.rate), jnp.zeros_like(inputs))

    monkeypatch.setattr(fnn.Dropout, "__call__", flax_dropout)
    logits = jm.apply({"params": params}, jnp.asarray(x), train=True,
                      rngs={"dropout": jax.random.key(0)})
    want = float(optax.softmax_cross_entropy_with_integer_labels(
        logits, jnp.asarray(labels)).mean())
    assert calls["n"] == len(masks)

    def port_mask(key, shape, r, device):
        assert r == rate and tuple(shape) == masks[0].shape
        layer, site = key[3], key[4]
        return torch.from_numpy(masks[0 if layer == -1 else 1 + 2 * layer + site])

    monkeypatch.setattr(T, "dropout_mask", port_mask)
    model = ViT(**NARROW, attention_impl="flash", dropout_rate=rate)
    model.load_state_dict(vit_state_dict_from_jax(params))
    got = F.cross_entropy(model(_nchw(x), dropout=(0, 0, 0)), torch.from_numpy(labels))
    assert float(got) == pytest.approx(want, rel=1e-5)


# ------------------------------------------------------------ refusals
REFUSALS = {
    "dropout_one": dict(model="vit_tiny", dropout_rate=1.0),
    "dropout_negative": dict(model="vit_tiny", dropout_rate=-0.5),
    "dropout_on_vgg": dict(model="vgg11", dropout_rate=0.1),
    "attention_on_cnn": dict(model="tiny_cnn", vit_attention="flash"),
    "attention_unknown": dict(model="vit_tiny", vit_attention="sparse"),
    "flash_under_auto": dict(model="vit_tiny", vit_attention="flash", sync="auto"),
    "flash_under_allreduce": dict(model="vit_tiny", vit_attention="flash", sync="allreduce"),
    "sync_bn": dict(model="vit_tiny", sync_bn=True),
}


@pytest.mark.parametrize("case", sorted(REFUSALS))
def test_trainer_refuses_what_jax_refuses(case):
    import jax

    from cs744_pytorch_distributed_tutorial_tpu.config import TrainConfig as JaxConfig
    from cs744_pytorch_distributed_tutorial_tpu.parallel import make_mesh
    from cs744_pytorch_distributed_tutorial_tpu.train import Trainer as JaxTrainer

    kw = dict(dict(sync="none", num_devices=1, global_batch_size=8, synthetic_data=True),
              **REFUSALS[case])
    mesh1 = make_mesh({"data": 1}, devices=jax.devices()[:1])
    with pytest.raises(Exception) as jax_exc:
        JaxTrainer(JaxConfig(**kw), mesh=mesh1)
    with pytest.raises(Exception) as port_exc:
        Trainer(TrainConfig(**kw, device="cpu"))
    assert port_exc.type is jax_exc.type is ValueError


def test_model_refusals():
    import jax
    import jax.numpy as jnp

    from cs744_pytorch_distributed_tutorial_tpu.models.vit import ViT as JaxViT

    with pytest.raises(ValueError, match="patch_size"):
        JaxViT(patch_size=5).init(jax.random.key(0), jnp.zeros((1, 32, 32, 3)))
    with pytest.raises(ValueError, match="patch_size"):
        ViT(patch_size=5)
    with pytest.raises(ValueError, match="unknown attention_impl"):
        ViT(attention_impl="ring")
    with pytest.raises(ValueError, match="causal=False"):
        T.Attention(32, 4, impl="ring", seq_size=2, causal=False)
    attn = T.Attention(32, 4, causal=False)
    x = torch.zeros(1, 3, 32)
    for mode in ("prefill", "decode"):
        cache = T.KVCache(torch.zeros(1, 8, 4, 8), torch.zeros(1, 8, 4, 8))
        with pytest.raises(ValueError, match="causal=False"):
            attn(x, torch.float32, mode=mode, pos=0, kv=cache)
    assert attn(x, torch.float32).shape == x.shape


def test_block_attends_both_ways_without_the_mask():
    """A non-causal block's first position sees the last: changing the last
    token moves the first output; a causal block's first output stays."""
    gen = torch.Generator().manual_seed(0)
    x = torch.randn(1, 5, 32, generator=gen)
    y = x.clone()
    y[0, -1] += 1.0
    for causal, moves in ((False, True), (True, False)):
        block = T.Block(32, 4, 64, impl="flash", causal=causal)
        with torch.no_grad():
            a, b = block(x, torch.float32), block(y, torch.float32)
        assert (not torch.equal(a[0, 0], b[0, 0])) is moves


# ------------------------------------------------------------ the CLI
def test_cli_dropout_trains_on_cpu(narrow_registries, capsys):
    argv = ["--part", "1", "--model", "vit_tiny", "--dropout", "0.1", "--synthetic-data",
            "--synthetic-train-size", "32", "--synthetic-test-size", "8",
            "--global-batch-size", "8", "--device", "cpu", "--json"]
    assert cli.main(argv) == 0
    summary = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert summary["model"] == "vit_tiny" and summary["steps"] == 4
    assert math.isfinite(summary["final_train_loss"])
    args = cli.build_parser().parse_args(["--dropout", "0.25"])
    assert args.dropout_rate == 0.25


def test_bench_phase_breakdown_on_the_vit(narrow_registries, capsys):
    """``bench.py --phase-breakdown --model vit_tiny`` (dense ViT under DDP,
    a model with no batch statistics): its segments compose to the fused
    step exactly."""
    from cs744_pytorch_distributed_tutorial_tpu_torch import bench

    assert bench.main(["--phase-breakdown", "--batch", "8", "--model", "vit_tiny",
                       "--phase-iters", "1", "--device", "cpu", "--compute-dtype",
                       "float32"]) == 0
    records = [json.loads(line) for line in capsys.readouterr().out.strip().splitlines()]
    (summary,) = [r for r in records if r["kind"] == "phase_summary"]
    assert summary["parity_ok"] and summary["max_param_abs_diff"] == 0.0
    assert summary["loss_fused"] == summary["loss_segmented"]
    assert records[-1]["metric"] == "cifar10_vit_tiny_phase_breakdown"
