"""The port's fused cross-entropy against the JAX package's Pallas kernels.

The same numpy logits and labels go through the JAX
``fused_cross_entropy`` (its forward and backward kernels in interpret
mode) and the port's (its plain versions on CPU tensors):

- the per-row loss and logsumexp within 1e-5 (rtol and atol) in fp32
  and for bf16 logits (both sum in fp32; only the order of the sums
  differs);
- the gradient of the mean loss within 1e-5 of each JAX entry, relative
  to that entry, in fp32 (the entries are about p / N, most far below
  1e-6, so an absolute term at the scale of the largest would check
  none of them; the two sides' logsumexps may differ in their last bits,
  which scales a whole row by about 1e-6), and within one bf16 ulp of
  the JAX gradient for bf16 logits (both round the same fp32 value once;
  exp may differ in its last fp32 bit, which can move the rounding by
  one ulp);
- N and V off every tile (N 37 with V 1000, and V 50304 at N 3), labels
  out of range (they pick no column: the loss is the logsumexp), and
  logits of +-1e4.

``LMTrainer`` with ``fused_xent=True`` follows the plain-CE trainer for
3 steps (tiny LM, fp32): losses within 1e-5 relative, as the JAX
package's ``tests/test_fused_xent.py`` holds its trainer. The
``cuda``-marked test holds the CUDA kernels against their plain versions
on the card.
"""

import importlib

import numpy as np
import pytest
import torch

from cs744_pytorch_distributed_tutorial_tpu_torch.data import synthetic_tokens
from cs744_pytorch_distributed_tutorial_tpu_torch.ops import fused_xent as X
from cs744_pytorch_distributed_tutorial_tpu_torch.train.lm import LMConfig, LMTrainer

CASES = [(37, 1000, "float32"), (37, 1000, "bfloat16"), (3, 50304, "float32"),
         (3, 50304, "bfloat16"), (8, 128, "float32")]


def _jx():
    return importlib.import_module("cs744_pytorch_distributed_tutorial_tpu.ops.fused_xent")


def _inputs(n, v, seed, scale=4.0):
    rng = np.random.default_rng(seed)
    logits = (scale * rng.standard_normal((n, v))).astype(np.float32)
    labels = rng.integers(0, v, n).astype(np.int32)
    return logits, labels


def _bf16_ulp(x: np.ndarray) -> np.ndarray:
    """One bf16 ulp at each |x| (8 significant bits)."""
    ax = np.maximum(np.abs(x), np.finfo(np.float32).tiny)
    return np.exp2(np.floor(np.log2(ax)) - 7)


def _jax_run(logits, labels, dtype):
    import jax
    import jax.numpy as jnp

    jl = jnp.asarray(logits).astype(getattr(jnp, dtype))
    jlab = jnp.asarray(labels)
    loss, lse = _jx()._forward(jl, jlab, 256, 512, True)
    grad = jax.grad(lambda x: _jx().fused_cross_entropy(x, jlab, interpret=True).mean())(jl)
    return np.asarray(loss), np.asarray(lse), np.asarray(grad.astype(jnp.float32))


def _port_run(logits, labels, dtype):
    x = torch.from_numpy(logits).to(getattr(torch, dtype)).requires_grad_()
    lab = torch.from_numpy(labels)
    loss, lse = X.fused_xent_fwd(x.detach(), lab)
    X.fused_cross_entropy(x, lab).mean().backward()
    assert loss.dtype == lse.dtype == torch.float32 and x.grad.dtype == x.dtype
    return loss.numpy(), lse.numpy(), x.grad.float().numpy()


def _compare(logits, labels, dtype):
    want = _jax_run(logits, labels, dtype)
    X.reset_launch_count()
    got = _port_run(logits, labels, dtype)
    assert X.launch_count() == 0  # CPU tensors take the plain versions
    for g, w in zip(got[:2], want[:2]):
        np.testing.assert_allclose(g, w, rtol=1e-5, atol=1e-5)
    if dtype == "float32":
        np.testing.assert_allclose(got[2], want[2], rtol=1e-5, atol=np.finfo(np.float32).tiny)
    else:
        assert np.all(np.abs(got[2] - want[2]) <= _bf16_ulp(want[2]))


@pytest.mark.parametrize("n,v,dtype", CASES)
def test_fused_xent_matches_jax(n, v, dtype):
    logits, labels = _inputs(n, v, seed=n * 31 + v)
    _compare(logits, labels, dtype)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_fused_xent_extreme_logits_and_labels_out_of_range(dtype):
    """Logits of +-1e4 and 500 (an online max that jumps), and labels -1
    and V, which pick no column."""
    logits = np.tile(np.asarray([1e4, -1e4, 0.0, 500.0], np.float32), (8, 32))
    logits[3] = -logits[3]
    labels = np.asarray([0, 1, 2, 3, 127, 64, -1, 128], np.int32)
    _compare(logits, labels, dtype)
    loss = X.fused_cross_entropy(torch.from_numpy(logits), torch.from_numpy(labels))
    assert torch.isfinite(loss).all()
    lse = torch.logsumexp(torch.from_numpy(logits).float(), -1)
    assert torch.equal(loss[6:], lse[6:])


@pytest.mark.parametrize(
    "logits,labels,err",
    [((4, 10), (5,), ValueError), ((40,), (40,), ValueError), ((4, 0), (4,), ValueError)],
)
def test_fused_xent_rejects_bad_shapes(logits, labels, err):
    with pytest.raises(err):
        X.fused_cross_entropy(torch.zeros(logits), torch.zeros(labels, dtype=torch.long))


def test_fused_xent_rejects_float_labels_and_half_logits():
    with pytest.raises(TypeError):
        X.fused_cross_entropy(torch.zeros(4, 10), torch.zeros(4))
    with pytest.raises(TypeError):
        X.fused_cross_entropy(torch.zeros(4, 10, dtype=torch.float16), torch.zeros(4).long())


def test_fp32_grad_limit_holds_each_entry():
    """The per-entry limit that holds the fp32 backward kernel to its plain
    version admits what the two sides may differ by (each side's expf off
    by up to 2 ulp) and refuses a wrong gradient even where the entries
    are far below the row's largest: the entries under 1e-6 zeroed or
    1e-4 off, an lse 1e-5 off, the onehot left out."""
    gen = torch.Generator().manual_seed(4)
    n, v = 8, 50304
    x = 4 * torch.randn((n, v), generator=gen)
    labels = torch.randint(0, v, (n,), generator=gen)
    g = torch.rand((n,), generator=gen)
    _, lse = X.fused_xent_fwd_plain(x, labels)
    want = X.fused_xent_bwd_plain(x, labels, lse, g)
    lim = X.fp32_grad_limit(want, labels, g)

    def share(d):
        return float(((d - want).abs() / lim).max())

    e = torch.exp(x - lse[:, None])
    up = torch.full_like(e, 1.0)
    e2 = torch.nextafter(torch.nextafter(e, up), up)
    onehot = torch.zeros_like(x).scatter_(1, labels[:, None], 1.0)
    small = want.abs() < 1e-6
    assert share(want) == 0.0
    assert share((e2 - onehot) * g[:, None]) < 1.0
    assert share(torch.where(small, 0.0, want)) > 1.0
    assert share(torch.where(small, want * (1 + 1e-4), want)) > 1.0
    assert share(X.fused_xent_bwd_plain(x, labels, lse + 1e-5, g)) > 1.0
    assert share(e * g[:, None]) > 1.0


SMALL = dict(vocab_size=64, num_layers=2, num_heads=4, d_model=32, d_ff=64, max_seq_len=32,
             seq_len=32, global_batch_size=4, use_rope=True, attention_impl="flash",
             device="cpu")


def test_trainer_fused_xent_matches_plain_ce():
    """3 AdamW steps from the same seed: the fused loss and gradient follow
    plain CE (losses within 1e-5 relative, parameters within 1e-5)."""
    toks = synthetic_tokens(12, 32, 64, seed=1)
    runs = {}
    for fused in (False, True):
        tr = LMTrainer(LMConfig(**SMALL, fused_xent=fused))
        model, _ = tr.init()
        steps = [tr.train_step(*tr.split_batch(toks[4 * s : 4 * s + 4])) for s in range(3)]
        runs[fused] = ([float(m["loss"]) for m in steps], [float(m["grad_norm"]) for m in steps],
                       [p.detach().clone() for p in model.parameters()])
    for a, b in zip(runs[True][0], runs[False][0]):
        assert a == pytest.approx(b, rel=1e-5)
    for a, b in zip(runs[True][1], runs[False][1]):
        assert a == pytest.approx(b, rel=1e-4)
    gap = max(float((a - b).abs().max()) for a, b in zip(runs[True][2], runs[False][2]))
    assert gap <= 1e-5
    assert X.launch_count() == 0


def test_trainer_fused_xent_eval_uses_plain_ce():
    tr = LMTrainer(LMConfig(**SMALL, fused_xent=True))
    tr.init()
    x, y = tr.split_batch(synthetic_tokens(4, 32, 64, seed=2))
    with torch.no_grad():
        logits = tr.model(x)
    want = torch.nn.functional.cross_entropy(logits.reshape(-1, 64), y.reshape(-1))
    assert float(tr.eval_step(x, y)["loss"]) == pytest.approx(float(want), rel=1e-6)


def test_label_smoothing_with_fused_xent_raises():
    with pytest.raises(ValueError, match="label_smoothing is incompatible with fused_xent"):
        LMTrainer(LMConfig(**SMALL, fused_xent=True, label_smoothing=0.1))


@pytest.mark.cuda
def test_fused_xent_kernels_match_plain_on_card():
    """Both kernels against their plain versions on the card: fp32 and bf16
    logits, ragged N and V, a row base off every 16-byte boundary (a view
    one element into its storage), labels out of range. Loss and lse
    within 1e-5 relative to the row's logsumexp scale; each fp32 gradient
    entry within ``fp32_grad_limit`` of its plain value; the bf16 gradient
    within one bf16 ulp."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card and nvcc")
    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(0)
    X.reset_launch_count()
    cases = [(64, 50304, 0), (37, 50257, 0), (5, 1000, 1), (3, 7, 1), (1, 1, 0)]
    for n, v, offset in cases:
        for dtype in (torch.float32, torch.bfloat16):
            base = 4 * torch.randn((n * v + offset,), generator=gen, device=dev)
            x = base.to(dtype)[offset:].view(n, v)
            labels = torch.randint(0, v, (n,), generator=gen, device=dev)
            if n > 1:
                labels[0] = -1
            g = torch.rand((n,), generator=gen, device=dev)
            loss, lse = X.fused_xent_fwd(x, labels)
            want_loss, want_lse = X.fused_xent_fwd_plain(x, labels)
            d = X.fused_xent_bwd(x, labels, want_lse, g)
            want_d = X.fused_xent_bwd_plain(x, labels, want_lse, g)
            torch.cuda.synchronize()
            scale = 1e-5 * want_lse.abs().clamp_min(1.0)
            assert bool(((loss - want_loss).abs() <= scale).all()), (n, v, dtype)
            assert bool(((lse - want_lse).abs() <= scale).all()), (n, v, dtype)
            assert d.dtype == dtype and d.shape == (n, v)
            err = (d.float() - want_d.float()).abs()
            if dtype == torch.float32:
                assert bool((err <= X.fp32_grad_limit(want_d, labels, g)).all()), (n, v)
            else:
                wf = want_d.float().abs().clamp_min(torch.finfo(torch.float32).tiny)
                assert bool((err <= torch.exp2(torch.floor(torch.log2(wf)) - 7)).all())
    assert X.launch_count("fwd") == X.launch_count("bwd") == 2 * len(cases)
    x = torch.randn((16, 300), device=dev, requires_grad=True)
    labels = torch.randint(0, 300, (16,), device=dev)
    X.fused_cross_entropy(x, labels).mean().backward()
    want = torch.autograd.grad(torch.nn.functional.cross_entropy(x, labels), x)[0]
    torch.testing.assert_close(x.grad, want, rtol=1e-5, atol=1e-7)
