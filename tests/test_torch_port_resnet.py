"""The port's ResNets against the JAX package's.

JAX initialises, the zero-initialised last BatchNorm gamma of every
block is overwritten with non-zero numpy values (at init nothing flows
back through a zero scale, so the routed convs' weight gradients would
be zeros compared with zeros), ``models/convert.py`` carries the weights
into the port, and the same numpy batch (NHWC for JAX, NCHW for the
port) goes through both. The JAX side runs plain ``nn.Conv`` in
float64; the port runs ``fast_conv=True`` in float32, its routed convs
taking the wgrad kernel's plain version on the CPU. Train-mode logits
agree at rtol 1e-4, atol 1e-5 and every parameter gradient at rtol
2e-4, atol 2e-4 (the JAX package's fast_conv gradient tolerance): the
port's fp32 rounding.
"""

import functools
import json

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from cs744_pytorch_distributed_tutorial_tpu.models.resnet import (
    BasicBlock as JaxBasicBlock,
)
from cs744_pytorch_distributed_tutorial_tpu.models.resnet import (
    BottleneckBlock as JaxBottleneckBlock,
)
from cs744_pytorch_distributed_tutorial_tpu.models.resnet import ResNet as JaxResNet
from cs744_pytorch_distributed_tutorial_tpu_torch import cli
from cs744_pytorch_distributed_tutorial_tpu_torch.config import TrainConfig
from cs744_pytorch_distributed_tutorial_tpu_torch.models.convert import (
    jax_from_state_dict,
    state_dict_from_jax,
)
from cs744_pytorch_distributed_tutorial_tpu_torch.models import get_model
from cs744_pytorch_distributed_tutorial_tpu_torch.models.resnet import (
    FastConv3x3,
    ResNet,
    same_pads,
)
from cs744_pytorch_distributed_tutorial_tpu_torch.train import Trainer

BATCH = 2
# name -> (converter arch, stage sizes, block, CIFAR stem, image side,
#          routed convs under fast_conv, numpy seed of gammas and batch)
CONFIGS = {
    "resnet18": ("resnet18", (2, 2, 2, 2), "basic", True, 32, 6, 1),
    "imagenet_stem": ("resnet18", (1, 1, 1, 1), "basic", False, 64, 2, 1),
    "resnet50": ("resnet50", (1, 1, 1, 1), "bottleneck", True, 32, 0, 0),
}
_JAX_BLOCKS = {"basic": JaxBasicBlock, "bottleneck": JaxBottleneckBlock}


def _leaves_of(tree, prefix=""):
    for k in sorted(tree):
        if isinstance(tree[k], dict):
            yield from _leaves_of(tree[k], f"{prefix}{k}/")
        else:
            yield f"{prefix}{k}", tree[k]


def _leaves(tree):
    for k, v in _leaves_of(tree):
        yield k, np.asarray(v)


def _nonzero_last_gammas(params, block, rng):
    """Every block's last BatchNorm scale (zeros at init) set to draws
    from U(0.5, 1.5); the tree is copied, not changed in place."""
    last = "BatchNorm_1" if block == "basic" else "BatchNorm_2"
    out = {}
    for name, sub in params.items():
        if name.startswith(("BasicBlock_", "BottleneckBlock_")):
            sub = dict(sub)
            assert not np.any(sub[last]["scale"]), "expected a zero-initialised gamma"
            n = sub[last]["scale"].shape[0]
            sub[last] = {**sub[last], "scale": rng.uniform(0.5, 1.5, n).astype(np.float32)}
        out[name] = sub
    return out


@functools.lru_cache(maxsize=None)
def _jax_setup(name):
    """The JAX model and its variables (numpy), with non-zero gammas, and
    a batch (NHWC images, labels)."""
    _, stages, block, cifar_stem, side, _, seed = CONFIGS[name]
    jmodel = JaxResNet(stage_sizes=stages, block=_JAX_BLOCKS[block],
                       num_classes=10, cifar_stem=cifar_stem)
    variables = jmodel.init(jax.random.key(0), jnp.zeros((1, side, side, 3)), train=False)
    variables = jax.tree.map(np.asarray, variables)
    rng = np.random.default_rng(seed)
    params = _nonzero_last_gammas(variables["params"], block, rng)
    x = rng.standard_normal((BATCH, side, side, 3)).astype(np.float32)
    labels = rng.integers(0, 10, BATCH).astype(np.int32)
    return jmodel, {"params": params, "batch_stats": variables["batch_stats"]}, x, labels


def _port_model(name, fast_conv=True):
    arch, stages, block, cifar_stem, _, _, _ = CONFIGS[name]
    _, variables, _, _ = _jax_setup(name)
    tmodel = ResNet(stages, block, num_classes=10, cifar_stem=cifar_stem, fast_conv=fast_conv)
    tmodel.load_state_dict(state_dict_from_jax(variables, arch))
    return tmodel


def _jax_reference(name):
    """Train-mode loss, logits and parameter gradients of the JAX model
    (plain ``nn.Conv``), evaluated in float64."""
    _, stages, block, cifar_stem, _, _, _ = CONFIGS[name]
    _, variables, x, labels = _jax_setup(name)
    jmodel = JaxResNet(stage_sizes=stages, block=_JAX_BLOCKS[block], num_classes=10,
                       cifar_stem=cifar_stem, dtype=jnp.float64)
    with jax.enable_x64(True):
        f64 = functools.partial(jax.tree.map, lambda a: jnp.asarray(a, jnp.float64))
        stats = f64(variables["batch_stats"])

        def loss_fn(params):
            logits, _ = jmodel.apply(
                {"params": params, "batch_stats": stats},
                jnp.asarray(x, jnp.float64), train=True, mutable=["batch_stats"],
            )
            loss = optax.softmax_cross_entropy_with_integer_labels(
                logits, jnp.asarray(labels)
            ).mean()
            return loss, logits

        (loss, logits), grads = jax.jit(jax.value_and_grad(loss_fn, has_aux=True))(
            f64(variables["params"])
        )
        return float(loss), np.asarray(logits), jax.tree.map(np.asarray, grads)


@pytest.mark.parametrize("name", list(CONFIGS))
def test_train_forward_and_grads_match_jax(name):
    """The reference is the JAX model evaluated in float64, the port runs
    in float32. Against an fp32 JAX run the gradients would also carry
    ReLU flips: at batch 2 the net has about a million ReLU inputs, and
    fp32 rounding sends one lying within ~1e-6 of zero to the other side
    in one framework only, which moves the gradients upstream of it by
    up to 1e-2. Measured on the CPU: JAX fp32 against the port in fp32
    showed such a flip for 3 of 6 seeds of ResNet-18 and all 6 of
    ResNet-50, while the port's fp32 gradients against its own float64
    run showed none for the seeds used here."""
    arch, routed = CONFIGS[name][0], CONFIGS[name][5]
    _, _, x, labels = _jax_setup(name)
    jloss, jlogits, jgrads = _jax_reference(name)

    tmodel = _port_model(name)
    fast = [m for m in tmodel.modules() if isinstance(m, FastConv3x3)]
    assert len(fast) == routed
    tmodel.train()
    tlogits = tmodel(torch.from_numpy(x.transpose(0, 3, 1, 2).copy()))
    tloss = torch.nn.functional.cross_entropy(tlogits, torch.from_numpy(labels).long())
    tloss.backward()
    np.testing.assert_allclose(tlogits.detach().numpy(), jlogits, rtol=1e-4, atol=1e-5)
    np.testing.assert_allclose(float(tloss.detach()), jloss, rtol=1e-5)
    for m in fast:
        assert float(m.weight.grad.abs().max()) > 0.0, "routed conv got a zero gradient"

    grad_sd = dict(tmodel.state_dict())
    grad_sd.update({k: p.grad for k, p in tmodel.named_parameters()})
    got = dict(_leaves(jax_from_state_dict(grad_sd, arch)["params"]))
    want = dict(_leaves(jgrads))
    assert set(got) == set(want)
    for leaf, w in want.items():
        np.testing.assert_allclose(got[leaf], w, rtol=2e-4, atol=2e-4, err_msg=leaf)


@pytest.mark.parametrize("name", list(CONFIGS))
def test_converter_round_trips_bitwise(name):
    arch = CONFIGS[name][0]
    _, variables, _, _ = _jax_setup(name)
    back = jax_from_state_dict(state_dict_from_jax(variables, arch), arch)
    a, b = dict(_leaves(variables)), dict(_leaves(back))
    assert set(a) == set(b)
    for leaf in a:
        assert a[leaf].dtype == b[leaf].dtype and np.array_equal(a[leaf], b[leaf]), leaf
    sd = _port_model(name).state_dict()
    again = state_dict_from_jax(jax_from_state_dict(sd, arch), arch)
    assert set(again) == set(sd)
    for k in sd:
        assert torch.equal(sd[k], again[k]), k


@pytest.mark.parametrize(
    "arch,n_tensors,n_params,routed",
    [("resnet18", 62, 11_173_962, 6), ("resnet34", None, None, 18), ("resnet50", None, None, 0)],
)
def test_port_init_matches_jax_structure(arch, n_tensors, n_params, routed):
    """The port's own init: ResNet-18's 62 tensors and 11,173,962
    parameters, zero last gammas, the routed conv count, and the same
    tree of shapes as the JAX model's once converted."""
    from cs744_pytorch_distributed_tutorial_tpu.models import get_model as jax_get_model

    model = get_model(arch, num_classes=10, fast_conv=True)
    params = list(model.parameters())
    if n_tensors is not None:
        assert len(params) == n_tensors and sum(p.numel() for p in params) == n_params
    assert sum(isinstance(m, FastConv3x3) for m in model.modules()) == routed
    for blk in model.blocks:
        assert not bool(getattr(blk, blk.last_bn).weight.any())
    want = jax.eval_shape(
        functools.partial(jax_get_model(arch, num_classes=10).init, train=False),
        jax.random.key(0), jnp.zeros((1, 32, 32, 3)),
    )
    want = {k: tuple(v.shape) for k, v in _leaves_of(want["params"])}
    tree = jax_from_state_dict(model.state_dict(), arch)["params"]
    assert {k: v.shape for k, v in _leaves(tree)} == want


@pytest.mark.parametrize(
    "size,k,stride,pads",
    [(32, 3, 1, (1, 1)), (32, 3, 2, (0, 1)), (7, 3, 2, (1, 1)), (32, 1, 2, (0, 0))],
)
def test_same_pads_match_flax(size, k, stride, pads):
    assert same_pads(size, k, stride) == pads


@pytest.mark.parametrize(
    "image_size,imagenet_stem,cifar_stem",
    [(32, None, True), (64, None, True), (72, None, False), (32, True, False), (96, False, True)],
)
def test_trainer_stem_rule(image_size, imagenet_stem, cifar_stem):
    cfg = TrainConfig(model="resnet18", sync="none", num_devices=1, device="cpu",
                      image_size=image_size, imagenet_stem=imagenet_stem)
    assert Trainer(cfg).model.cifar_stem is cifar_stem


def test_trainer_fast_conv_matches_library_conv():
    """Port Trainer, part 1, ResNet-18 at batch 4: two steps with
    fast_conv against two without, from the same seed and batches. The
    second step runs with non-zero gammas, so its wgrads are not zero."""
    rng = np.random.default_rng(3)
    images = rng.integers(0, 256, (2, 4, 32, 32, 3), dtype=np.uint8)
    labels = rng.integers(0, 10, (2, 4)).astype(np.int64)
    losses = {}
    for fast in (True, False):
        cfg = TrainConfig(model="resnet18", sync="none", num_devices=1, global_batch_size=4,
                          augment=False, learning_rate=0.02, fast_conv=fast, device="cpu")
        tr = Trainer(cfg)
        assert sum(isinstance(m, FastConv3x3) for m in tr.model.modules()) == (6 if fast else 0)
        losses[fast] = [
            float(tr.train_step(torch.from_numpy(images[s]), torch.from_numpy(labels[s])))
            for s in range(2)
        ]
    np.testing.assert_allclose(losses[True], losses[False], rtol=1e-5)


def test_cli_trains_resnet18_fast_conv_on_cpu(capsys):
    argv = ["--part", "1", "--model", "resnet18", "--fast-conv", "--fused-optimizer",
            "--synthetic-data", "--synthetic-train-size", "16", "--synthetic-test-size", "8",
            "--global-batch-size", "8", "--device", "cpu", "--json"]
    assert cli.main(argv) == 0
    summary = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert summary["model"] == "resnet18" and summary["steps"] == 2
    assert np.isfinite(summary["final_train_loss"]) and np.isfinite(summary["final_eval_loss"])
