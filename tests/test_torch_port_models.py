"""The port's VGG-11 and tiny_cnn against the JAX package's models.

JAX initializes, ``models/convert.py`` carries the weights into the
port, and the same numpy batch (NHWC for JAX, NCHW for the port) goes
through both. Train-mode logits and parameter gradients agree at rtol
1e-4, atol 1e-5 (fp32 convolutions summed in another order).
"""

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from cs744_pytorch_distributed_tutorial_tpu.models import get_model as jax_get_model
from cs744_pytorch_distributed_tutorial_tpu_torch.models import get_model
from cs744_pytorch_distributed_tutorial_tpu_torch.models.convert import (
    jax_from_state_dict,
    state_dict_from_jax,
)

ARCHS = ["vgg11", "tiny_cnn"]
BATCH = 4


def _setup(arch, seed=0):
    rng = np.random.default_rng(seed)
    x = rng.standard_normal((BATCH, 32, 32, 3)).astype(np.float32)
    labels = rng.integers(0, 10, BATCH).astype(np.int32)
    jmodel = jax_get_model(arch, num_classes=10)
    variables = jmodel.init(jax.random.key(seed), jnp.zeros((1, 32, 32, 3)), train=False)
    variables = jax.tree.map(np.asarray, variables)
    tmodel = get_model(arch, num_classes=10)
    tmodel.load_state_dict(state_dict_from_jax(variables, arch))
    return jmodel, variables, tmodel, x, labels


def _tree_pairs(a, b, prefix=""):
    for k in a:
        if isinstance(a[k], dict):
            yield from _tree_pairs(a[k], b[k], f"{prefix}{k}/")
        else:
            yield f"{prefix}{k}", np.asarray(a[k]), np.asarray(b[k])


@pytest.mark.parametrize("arch", ARCHS)
def test_train_forward_and_grads_match_jax(arch):
    jmodel, variables, tmodel, x, labels = _setup(arch)

    def loss_fn(params):
        logits, _ = jmodel.apply(
            {"params": params, "batch_stats": variables["batch_stats"]},
            jnp.asarray(x), train=True, mutable=["batch_stats"],
        )
        loss = optax.softmax_cross_entropy_with_integer_labels(
            logits, jnp.asarray(labels)
        ).mean()
        return loss, logits

    (jloss, jlogits), jgrads = jax.jit(jax.value_and_grad(loss_fn, has_aux=True))(
        variables["params"]
    )

    tmodel.train()
    tlogits = tmodel(torch.from_numpy(x.transpose(0, 3, 1, 2).copy()))
    tloss = torch.nn.functional.cross_entropy(tlogits, torch.from_numpy(labels).long())
    tloss.backward()
    np.testing.assert_allclose(tlogits.detach().numpy(), np.asarray(jlogits),
                               rtol=1e-4, atol=1e-5)
    np.testing.assert_allclose(float(tloss.detach()), float(jloss), rtol=1e-5)

    grad_sd = dict(tmodel.state_dict())
    grad_sd.update({k: p.grad for k, p in tmodel.named_parameters()})
    tgrads = jax_from_state_dict(grad_sd, arch)["params"]
    for name, want, got in _tree_pairs(jax.tree.map(np.asarray, jgrads), tgrads):
        np.testing.assert_allclose(got, want, rtol=1e-4, atol=1e-5, err_msg=name)


@pytest.mark.parametrize("arch", ARCHS)
def test_converter_round_trips_bitwise(arch):
    _, variables, tmodel, _, _ = _setup(arch, seed=3)
    back = jax_from_state_dict(state_dict_from_jax(variables, arch), arch)
    for name, a, b in _tree_pairs(variables, back):
        assert a.dtype == b.dtype and np.array_equal(a, b), name
    sd = tmodel.state_dict()
    again = state_dict_from_jax(jax_from_state_dict(sd, arch), arch)
    assert set(again) == set(sd)
    for k in sd:
        assert torch.equal(sd[k], again[k]), k


def test_tiny_cnn_head_is_permuted_not_copied():
    """tiny_cnn flattens an 8x8x16 map: JAX in (h, w, c) order, the port
    in (c, h, w). The converter permutes the dense rows accordingly."""
    _, variables, tmodel, _, _ = _setup("tiny_cnn")
    kernel = variables["params"]["Dense_0"]["kernel"]  # [(h, w, c), 10]
    w = tmodel.fc1.weight.detach().numpy()  # [10, (c, h, w)]
    h, ww, c = 2, 5, 7
    np.testing.assert_array_equal(w[:, c * 64 + h * 8 + ww], kernel[(h * 8 + ww) * 16 + c])


@pytest.mark.parametrize("arch", ARCHS)
def test_running_stats_match_up_to_bessel(arch):
    """One train-mode forward updates BatchNorm running stats in both:
    the means agree; torch stores the Bessel-corrected (n/(n-1)) variance
    and flax the biased one. Undoing the factor, the variances agree, and
    with them the eval-mode logits."""
    jmodel, variables, tmodel, x, _ = _setup(arch, seed=5)
    _, mutated = jmodel.apply(variables, jnp.asarray(x), train=True, mutable=["batch_stats"])
    tmodel.train()
    with torch.no_grad():
        tmodel(torch.from_numpy(x.transpose(0, 3, 1, 2).copy()))
    sd = tmodel.state_dict()
    stats = jax_from_state_dict(sd, arch)["batch_stats"]
    side = 32
    fixed = {}
    bn_index = 0
    for entry in tmodel.cfg:
        if entry == "M":
            side //= 2
            continue
        name = f"BatchNorm_{bn_index}"
        n = BATCH * side * side
        want = mutated["batch_stats"][name]
        np.testing.assert_allclose(stats[name]["mean"], np.asarray(want["mean"]),
                                   rtol=1e-4, atol=1e-5)
        debesseled = 0.9 + (stats[name]["var"] - 0.9) * (n - 1) / n
        np.testing.assert_allclose(debesseled, np.asarray(want["var"]), rtol=1e-4, atol=1e-5)
        fixed[name] = {"mean": stats[name]["mean"], "var": debesseled.astype(np.float32)}
        bn_index += 1

    jvars = {"params": variables["params"], "batch_stats": jax.tree.map(np.asarray, mutated["batch_stats"])}
    jlogits = jmodel.apply(jvars, jnp.asarray(x), train=False)
    tmodel.load_state_dict(
        state_dict_from_jax({"params": variables["params"], "batch_stats": fixed}, arch)
    )
    tmodel.eval()
    with torch.no_grad():
        tlogits = tmodel(torch.from_numpy(x.transpose(0, 3, 1, 2).copy()))
    np.testing.assert_allclose(tlogits.numpy(), np.asarray(jlogits), rtol=1e-4, atol=1e-4)
