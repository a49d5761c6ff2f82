"""The port's fused SGD against the JAX package's optimizer.

The same numpy inputs go through the JAX optax chain (``train/state.py::
make_optimizer``) and the Pallas kernel in interpret mode
(``ops/fused_sgd.py::FusedSGD``) on one side, the port's CPU path (the
kernel's plain version) on the other. Tolerance rtol 1e-6, atol 1e-7:
both sides round in fp32; XLA may contract a multiply-add the port
rounds twice. The JAX package is imported inside the tests that use it,
so the ``cuda``-marked tests also run on a machine with a card and no
flax. The multi-tensor entry (``fused_sgd_multi_``, which
``FusedSGD.apply`` takes) is held bitwise to the per-tensor plain
update and its list checks on the CPU; on the card the kernel is held
bitwise to the plain update and its launches are counted.
"""

import math

import numpy as np
import pytest
import torch

from cs744_pytorch_distributed_tutorial_tpu_torch.config import TrainConfig
from cs744_pytorch_distributed_tutorial_tpu_torch.models import resnet18, resnet50, vgg11
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

    port = K.FusedSGD(LR, MU, WD)  # through fused_sgd_multi_, a list of one
    tp, tm = torch.from_numpy(p.copy()), torch.from_numpy(m.copy())
    for g in grads:
        port.apply([tp], [tm], [torch.from_numpy(g)])
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
        K.fused_sgd_multi_([p], [m], [torch.from_numpy(g)], lr=LR, mu=MU, wd=WD)
    np.testing.assert_allclose(p.numpy(), ref.detach().numpy(), rtol=1e-6, atol=1e-7)


@pytest.mark.parametrize("shape", RAGGED_SHAPES)
def test_ragged_shapes(shape):
    p = torch.arange(math.prod(shape), dtype=torch.float32).reshape(shape)
    m = torch.ones(shape)
    g = torch.full(shape, 0.5)
    want_m = MU * 1.0 + (0.5 + WD * p.numpy())
    want_p = p.numpy() - LR * want_m
    K.fused_sgd_multi_([p], [m], [g], lr=LR, mu=MU, wd=WD)
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
        K.fused_sgd_multi_([p], [m], [g], lr=LR, mu=MU, wd=WD)


def test_cpu_path_launches_no_kernel():
    K.reset_launch_count()
    K.fused_sgd_multi_([torch.ones(5)] * 2, [torch.zeros(5)] * 2, [torch.ones(5)] * 2,
                       lr=LR, mu=MU, wd=WD)
    assert K.launch_count() == 0


# Lists for the multi-tensor entry: (shapes).
MULTI_LISTS = {
    "empty": [],
    "one": [(3, 5, 7)],
    "ragged": RAGGED_SHAPES + [(0,), (2, 3)],
    "hundred": [(int(n),) for n in np.random.default_rng(3).integers(1, 3000, 100)],
}


def _lists(shapes, seed, device="cpu", offset=0):
    """p, m, g lists from numpy; with ``offset``, tensor 0's p starts one
    float into its storage (not 16-byte aligned)."""
    rng = np.random.default_rng(seed)

    def t(shape, scale=1.0):
        return torch.from_numpy((scale * rng.standard_normal(shape)).astype(np.float32)).to(device)

    ps, ms, gs = ([t(s) for s in shapes], [t(s, 0.1) for s in shapes],
                  [[t(s) for s in shapes] for _ in range(3)])
    if offset and shapes:
        n = math.prod(shapes[0])
        base = torch.empty(n + offset, device=device)
        ps[0] = base[offset:].view(shapes[0]).copy_(ps[0])
    return ps, ms, gs


@pytest.mark.parametrize("case", sorted(MULTI_LISTS))
def test_multi_matches_plain_per_tensor_bitwise(case):
    shapes = MULTI_LISTS[case]
    ps, ms, gs = _lists(shapes, 4)
    pp, mp = [p.clone() for p in ps], [m.clone() for m in ms]
    for step in gs:
        K.fused_sgd_multi_(ps, ms, step, lr=LR, mu=MU, wd=WD)
        for p, m, g in zip(pp, mp, step):
            K.fused_sgd_plain(p, m, g, lr=LR, mu=MU, wd=WD)
    for got, want in zip(ps + ms, pp + mp):
        assert torch.equal(got, want)


@pytest.mark.parametrize("bad", ["mixed_devices", "float64_g", "shape", "lengths", "noncontig_m"])
def test_multi_rejects_bad_lists(bad):
    ps, ms, gs = [torch.zeros(4, 6) for _ in range(3)], [torch.zeros(4, 6) for _ in range(3)], \
        [torch.zeros(4, 6) for _ in range(3)]
    if bad == "mixed_devices":
        gs[1] = torch.zeros(4, 6, device="meta")
    elif bad == "float64_g":
        gs[2] = gs[2].double()
    elif bad == "shape":
        gs[1] = torch.zeros(4, 5)
    elif bad == "lengths":
        gs = gs[:2]
    else:
        ms[0] = torch.zeros(6, 4).t()
    with pytest.raises((TypeError, ValueError)):
        K.fused_sgd_multi_(ps, ms, gs, lr=LR, mu=MU, wd=WD)


def test_rows_check_every_tensor_every_call():
    """The rows handed to the C entry point: (p, m, g, numel) pointers
    and sizes; a bad p, m or g anywhere in the list raises, whatever the
    calls before it."""
    ps, ms, gs = _lists([(3, 4), (5,), (0,)], 6)
    for step in gs[:2]:
        rows = K._rows(ps, ms, step)
        assert rows.tolist() == [[p.data_ptr(), m.data_ptr(), g.data_ptr(), p.numel()]
                                 for p, m, g in zip(ps, ms, step)]
    for bad in (torch.zeros(4, 3).t(), torch.zeros(3, 4, dtype=torch.float64), torch.zeros(12)):
        for lists in ([bad, *ps[1:]], ms, gs[1]), (ps, [bad, *ms[1:]], gs[1]), \
                (ps, ms, [bad, *gs[1][1:]]):
            with pytest.raises((TypeError, ValueError)):
                K._rows(*lists)


@pytest.mark.parametrize("change", ["numel", "dtype"])
def test_rows_follow_a_tensor_at_a_reused_address(change):
    """A p at the address of an earlier p is checked and sized anew:
    another numel is packed, another dtype refused."""
    base = torch.zeros(16)
    ps, ms, gs = [base[:12].view(3, 4)], [torch.zeros(3, 4)], [torch.ones(3, 4)]
    assert K._rows(ps, ms, gs).tolist() == [[base.data_ptr(), ms[0].data_ptr(),
                                             gs[0].data_ptr(), 12]]
    if change == "numel":
        ps, ms, gs = [base[:10]], [torch.zeros(10)], [torch.ones(10)]
        assert K._rows(ps, ms, gs).tolist() == [[base.data_ptr(), ms[0].data_ptr(),
                                                 gs[0].data_ptr(), 10]]
    else:
        ps = [base.view(torch.float16)[:12].view(3, 4)]
        assert ps[0].data_ptr() == base.data_ptr()
        with pytest.raises(TypeError):
            K._rows(ps, ms, gs)


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
            K.fused_sgd_multi_([pk], [mk], [g], lr=LR, mu=MU, wd=WD)
            K.fused_sgd_plain(pp, mp, g, lr=LR, mu=MU, wd=WD)
        torch.cuda.synchronize()
        for got, want in ((pk, pp), (mk, mp)):
            assert bool(((got - want).abs() <= 1e-6 * want.abs() + 1e-7).all()), shape
    assert K.launch_count() == 3 * len(shapes)


@pytest.mark.cuda
def test_multi_kernel_bitwise_on_card():
    """The multi-tensor kernel bitwise against the plain update, 3 steps:
    ResNet-18's 62 shapes (one launch a step), and ResNet-18's, VGG-11's
    and the ragged shapes in one list led by a tensor one float off its
    16-byte alignment (more tensors and chunks than one launch holds)."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card and nvcc")
    r18 = [tuple(p.shape) for p in resnet18().parameters()]
    v11 = [tuple(p.shape) for p in vgg11().parameters()]
    for shapes, offset in ((r18, 0), ([(1000,)] + r18 + v11 + RAGGED_SHAPES, 1)):
        ps, ms, gs = _lists(shapes, 5, device="cuda", offset=offset)
        assert ps[0].data_ptr() % 16 == 4 * offset
        pp, mp = [p.clone() for p in ps], [m.clone() for m in ms]
        want = 1 if not offset else 2
        K.reset_launch_count()
        for step in gs:
            K.fused_sgd_multi_(ps, ms, step, lr=LR, mu=MU, wd=WD)
            for p, m, g in zip(pp, mp, step):
                K.fused_sgd_plain(p, m, g, lr=LR, mu=MU, wd=WD)
        torch.cuda.synchronize()
        assert K.launch_count() == 3 * want
        for i, (got, ref) in enumerate(zip(ps + ms, pp + mp)):
            assert torch.equal(got, ref), (i, shapes[i % len(shapes)])


@pytest.mark.cuda
@pytest.mark.parametrize(
    "model,want",
    [("resnet18", 1), ("vgg11", 1), ("resnet50", 3), ("65_tensors", 2), ("21m_elements", 2)],
)
def test_multi_kernel_launch_counts_on_card(model, want):
    """Launches a list takes, as the C entry point reports them: one for
    ResNet-18 (62 tensors, 390 chunks of 32K) and VGG-11 (34, 309); three
    for ResNet-50's 161 tensors; two past 64 tensors or past 640 chunks."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card and nvcc")
    shapes = {"65_tensors": [(1,)] * 65, "21m_elements": [(640 * 32768 + 1,)]}.get(model)
    if shapes is None:
        net = {"resnet18": resnet18, "vgg11": vgg11, "resnet50": resnet50}[model]()
        shapes = [tuple(p.shape) for p in net.parameters()]
    ps, ms, gs = _lists(shapes, 7, device="cuda")
    pp, mp = [p.clone() for p in ps], [m.clone() for m in ms]
    K.reset_launch_count()
    K.fused_sgd_multi_(ps, ms, gs[0], lr=LR, mu=MU, wd=WD)
    torch.cuda.synchronize()
    assert K.launch_count() == want
    for p, m, g in zip(pp, mp, gs[0]):
        K.fused_sgd_plain(p, m, g, lr=LR, mu=MU, wd=WD)
    assert all(torch.equal(got, ref) for got, ref in zip(ps + ms, pp + mp))
