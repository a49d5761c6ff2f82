"""The port's fused SGD against the JAX package's optimizer.

The same numpy inputs go through the JAX optax chain (``train/state.py::
make_optimizer``) and the Pallas kernel in interpret mode
(``ops/fused_sgd.py::FusedSGD``) on one side, the port's CPU path (the
kernel's plain version) on the other. Tolerance rtol 1e-6, atol 1e-7:
both sides round in fp32; XLA may contract a multiply-add the port
rounds twice. The JAX package is imported inside the tests that use it,
so the ``cuda``-marked test also runs on a machine with a card and no
flax.
"""

import math

import numpy as np
import pytest
import torch

from cs744_pytorch_distributed_tutorial_tpu_torch.config import TrainConfig
from cs744_pytorch_distributed_tutorial_tpu_torch.models import vgg11
from cs744_pytorch_distributed_tutorial_tpu_torch.ops import fused_sgd as K
from cs744_pytorch_distributed_tutorial_tpu_torch.train.state import SGD, make_optimizer

LR, MU, WD = 0.1, 0.9, 1e-4
TREE_SHAPES = {"conv": (3, 3, 3, 16), "bias": (16,), "dense": (64, 10), "odd": (3, 5, 7)}
RAGGED_SHAPES = [(1,), (7,), (1000,), (3, 5, 7)]


def _tree(rng):
    return {k: rng.standard_normal(s).astype(np.float32) for k, s in TREE_SHAPES.items()}


@pytest.mark.parametrize("fused", [True, False])
def test_update_matches_jax_optax_chain(fused):
    import jax.numpy as jnp
    import optax

    from cs744_pytorch_distributed_tutorial_tpu.config import TrainConfig as JaxConfig
    from cs744_pytorch_distributed_tutorial_tpu.train.state import (
        make_optimizer as jax_make_optimizer,
    )

    rng = np.random.default_rng(0)
    p0 = _tree(rng)
    grads = [_tree(rng) for _ in range(3)]

    tx = jax_make_optimizer(JaxConfig(learning_rate=LR, momentum=MU, weight_decay=WD))
    jp = {k: jnp.asarray(v) for k, v in p0.items()}
    opt = tx.init(jp)
    for g in grads:
        updates, opt = tx.update({k: jnp.asarray(v) for k, v in g.items()}, opt, jp)
        jp = optax.apply_updates(jp, updates)

    port = make_optimizer(
        TrainConfig(learning_rate=LR, momentum=MU, weight_decay=WD,
                    fused_optimizer=fused, device="cpu")
    )
    assert isinstance(port, K.FusedSGD) and (type(port) is SGD) != fused
    keys = sorted(p0)
    tp = [torch.from_numpy(p0[k].copy()) for k in keys]
    mom = port.init(tp)
    for g in grads:
        port.apply(tp, mom, [torch.from_numpy(g[k]) for k in keys])
    for k, t in zip(keys, tp):
        np.testing.assert_allclose(t.numpy(), np.asarray(jp[k]), rtol=1e-6, atol=1e-7)


def test_update_matches_pallas_kernel_interpret():
    import jax.numpy as jnp

    from cs744_pytorch_distributed_tutorial_tpu.ops.fused_sgd import FusedSGD as JaxFusedSGD

    rng = np.random.default_rng(1)
    shape = (3, 5, 7)  # ragged: the Pallas side pads it to (8, 128) lanes
    p = rng.standard_normal(shape).astype(np.float32)
    m = rng.standard_normal(shape).astype(np.float32)
    grads = [rng.standard_normal(shape).astype(np.float32) for _ in range(3)]

    jf = JaxFusedSGD(LR, MU, WD, interpret=True)
    jp, jm = jnp.asarray(p), jnp.asarray(m)
    for g in grads:
        jp, jm = jf.apply(jp, jm, jnp.asarray(g))

    tp, tm = torch.from_numpy(p.copy()), torch.from_numpy(m.copy())
    for g in grads:
        K.fused_sgd_(tp, tm, torch.from_numpy(g), lr=LR, mu=MU, wd=WD)
    np.testing.assert_allclose(tp.numpy(), np.asarray(jp), rtol=1e-6, atol=1e-7)
    np.testing.assert_allclose(tm.numpy(), np.asarray(jm), rtol=1e-6, atol=1e-7)


def test_update_matches_torch_optim_sgd():
    """torch-SGD semantics: the port's update traces torch.optim.SGD."""
    rng = np.random.default_rng(2)
    p0 = rng.standard_normal((7, 5)).astype(np.float32)
    grads = [rng.standard_normal((7, 5)).astype(np.float32) for _ in range(5)]
    ref = torch.nn.Parameter(torch.from_numpy(p0.copy()))
    opt = torch.optim.SGD([ref], lr=LR, momentum=MU, weight_decay=WD)
    p, m = torch.from_numpy(p0.copy()), torch.zeros(7, 5)
    for g in grads:
        ref.grad = torch.from_numpy(g)
        opt.step()
        K.fused_sgd_(p, m, torch.from_numpy(g), lr=LR, mu=MU, wd=WD)
    np.testing.assert_allclose(p.numpy(), ref.detach().numpy(), rtol=1e-6, atol=1e-7)


@pytest.mark.parametrize("shape", RAGGED_SHAPES)
def test_ragged_shapes(shape):
    p = torch.arange(math.prod(shape), dtype=torch.float32).reshape(shape)
    m = torch.ones(shape)
    g = torch.full(shape, 0.5)
    want_m = MU * 1.0 + (0.5 + WD * p.numpy())
    want_p = p.numpy() - LR * want_m
    K.fused_sgd_(p, m, g, lr=LR, mu=MU, wd=WD)
    np.testing.assert_allclose(m.numpy(), want_m, rtol=1e-6)
    np.testing.assert_allclose(p.numpy(), want_p, rtol=1e-6)


@pytest.mark.parametrize(
    "bad",
    ["float64_p", "float16_g", "noncontiguous", "shape"],
)
def test_wrapper_rejects_bad_input(bad):
    p, m, g = torch.zeros(4, 6), torch.zeros(4, 6), torch.zeros(4, 6)
    if bad == "float64_p":
        p = p.double()
    elif bad == "float16_g":
        g = g.half()
    elif bad == "noncontiguous":
        m = torch.zeros(6, 4).t()
    else:
        g = torch.zeros(4, 5)
    with pytest.raises((TypeError, ValueError)):
        K.fused_sgd_(p, m, g, lr=LR, mu=MU, wd=WD)


def test_cpu_path_launches_no_kernel():
    K.reset_launch_count()
    K.fused_sgd_(torch.ones(5), torch.zeros(5), torch.ones(5), lr=LR, mu=MU, wd=WD)
    assert K.launch_count() == 0


@pytest.mark.cuda
def test_kernel_matches_plain_on_card():
    """The CUDA kernel against its plain version at VGG-11's 34 parameter
    shapes and the ragged ones, 3 steps; both round alike, so the
    tolerance only covers a different contraction choice."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card and nvcc")
    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(0)
    shapes = [tuple(p.shape) for p in vgg11().parameters()] + RAGGED_SHAPES
    K.reset_launch_count()
    for shape in shapes:
        p = torch.randn(shape, generator=gen, device=dev)
        m = 0.1 * torch.randn(shape, generator=gen, device=dev)
        pk, mk, pp, mp = p.clone(), m.clone(), p.clone(), m.clone()
        for _ in range(3):
            g = torch.randn(shape, generator=gen, device=dev)
            K.fused_sgd_(pk, mk, g, lr=LR, mu=MU, wd=WD)
            K.fused_sgd_plain(pp, mp, g, lr=LR, mu=MU, wd=WD)
        torch.cuda.synchronize()
        for got, want in ((pk, pp), (mk, mp)):
            assert bool(((got - want).abs() <= 1e-6 * want.abs() + 1e-7).all()), shape
    assert K.launch_count() == 3 * len(shapes)
