"""The port's int8 weight path against the JAX package's ``ops/quant.py``.

``quantize_int8`` and ``quantize_kv`` give the JAX package's int8 codes
bit for bit (``torch.round`` and ``jnp.round`` both round half to even)
and scales within 1 ulp; ``int8_matmul`` (its plain version on CPU
tensors) agrees with the JAX ``int8_matmul`` (the Pallas kernel in
interpret mode, or its XLA reference when K is not a multiple of 128) at
1e-5 relative in fp32; ``quantize_lm_params`` over the port's
``state_dict`` gives the JAX quantized tree through the converter. The
route rule (``tc_route``) is held case by case, and the CPU wrapper takes
the plain version whatever route the rule would give a CUDA call. The
``cuda``-marked tests hold both CUDA kernels (tensor cores for bf16 x,
FFMA otherwise) against their plain version on the card. JAX is imported
inside the tests that use it.
"""

import importlib

import numpy as np
import pytest
import torch

from cs744_pytorch_distributed_tutorial_tpu_torch.models.convert import (
    jax_lm_params_from_state_dict,
    lm_params_from_jax,
)
from cs744_pytorch_distributed_tutorial_tpu_torch.ops import quant as Q


def _jq():
    return importlib.import_module("cs744_pytorch_distributed_tutorial_tpu.ops.quant")


def _ulps(a, b):
    return np.abs(a.view(np.int32).astype(np.int64) - b.view(np.int32).astype(np.int64))


def test_quantize_int8_and_kv_codes_match_jax():
    import jax.numpy as jnp

    rng = np.random.default_rng(0)
    w = rng.standard_normal((96, 40)).astype(np.float32)
    w[:, 3] = 0.0  # an all-zero column: scale 1, codes 0
    w[5, 7] = 127.5 * np.abs(w[:, 7]).max() / 127.0  # a tie at the column max
    jq, js = _jq().quantize_int8(jnp.asarray(w))
    q, s = Q.quantize_int8(torch.from_numpy(w))
    assert q.dtype == torch.int8 and s.dtype == torch.float32
    np.testing.assert_array_equal(q.numpy(), np.asarray(jq))
    assert _ulps(s.numpy(), np.asarray(js)).max() <= 1 and s[3] == 1.0

    x = rng.standard_normal((2, 5, 3, 16)).astype(np.float32)
    x[0, 0, 0] = 0.0
    jq, js = _jq().quantize_kv(jnp.asarray(x))
    q, s = Q.quantize_kv(torch.from_numpy(x))
    np.testing.assert_array_equal(q.numpy(), np.asarray(jq))
    assert s.shape == (2, 5, 3) and _ulps(s.numpy(), np.asarray(js)).max() <= 1


@pytest.mark.parametrize("m,k,n", [(16, 256, 384), (5, 200, 70), (33, 128, 9)])
def test_int8_matmul_matches_jax(m, k, n):
    """K a multiple of 128 (the Pallas kernel, interpret mode) and not
    (its XLA reference), leading dims kept."""
    import jax.numpy as jnp

    rng = np.random.default_rng(m)
    x = rng.standard_normal((1, m, k)).astype(np.float32)
    q, s = _jq().quantize_int8(jnp.asarray(rng.standard_normal((k, n)).astype(np.float32)))
    want = np.asarray(_jq().int8_matmul(jnp.asarray(x), q, s, interpret=True))
    Q.reset_launch_count()
    got = Q.int8_matmul(torch.from_numpy(x), torch.from_numpy(np.array(q)),
                        torch.from_numpy(np.array(s)))
    assert Q.launch_count() == 0  # CPU tensors take the plain version
    assert got.shape == (1, m, n) and got.dtype == torch.float32
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-5, atol=1e-5 * np.abs(want).max())


def test_int8_matmul_bfloat16_matches_jax():
    import jax.numpy as jnp

    rng = np.random.default_rng(7)
    x = rng.standard_normal((4, 128)).astype(np.float32)
    q, s = _jq().quantize_int8(jnp.asarray(rng.standard_normal((128, 64)).astype(np.float32)))
    want = _jq().int8_matmul(jnp.asarray(x).astype(jnp.bfloat16), q, s, interpret=True)
    got = Q.int8_matmul(torch.from_numpy(x).bfloat16(), torch.from_numpy(np.array(q)),
                        torch.from_numpy(np.array(s)))
    assert got.dtype == torch.bfloat16
    # bf16 outputs: one rounding of fp32 sums taken in another order, up
    # to 1 bf16 ulp apart (2**-7 relative; near zero, the sums' spread).
    want = np.asarray(want, np.float32)
    np.testing.assert_allclose(got.float().numpy(), want, rtol=2**-7,
                               atol=1e-5 * np.abs(want).max())


@pytest.mark.parametrize("m,k,n,dtype,aligned,want", [
    (2048, 768, 50304, torch.bfloat16, True, True),   # a prompt pass
    (16, 768, 50304, torch.bfloat16, True, True),     # a decode step (TC_MIN_ROWS)
    (77, 768, 50192, torch.bfloat16, True, True),     # ragged M; N a multiple of 16, not 128
    (2048, 768, 50304, torch.float32, True, False),   # fp32 x: FFMA
    (5, 200, 70, torch.bfloat16, True, False),        # N not a multiple of 16
    (16, 204, 64, torch.bfloat16, True, False),       # K not a multiple of 8
    (16, 0, 64, torch.bfloat16, True, False),         # no contraction
    (16, 768, 50304, torch.bfloat16, False, False),   # x or q off 16 bytes
])
def test_int8_tc_route(m, k, n, dtype, aligned, want):
    assert Q.tc_route(dtype, m, k, n, aligned) is want


def test_int8_tc_route_row_threshold():
    """The fewest rows that take the tensor cores is the rule's constant:
    one row fewer takes the FFMA kernel."""
    assert Q.TC_MIN_ROWS >= 1
    assert Q.tc_route(torch.bfloat16, Q.TC_MIN_ROWS, 768, 50304)
    assert not Q.tc_route(torch.bfloat16, Q.TC_MIN_ROWS - 1, 768, 50304)


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
def test_cpu_int8_matmul_takes_plain_version(dtype):
    """CPU tensors at a shape the rule sends to the tensor cores in bf16:
    the wrapper returns the plain version bit for bit and no route counts a
    launch."""
    rng = np.random.default_rng(3)
    q, s = Q.quantize_int8(torch.from_numpy(rng.standard_normal((128, 256)).astype(np.float32)))
    x = torch.from_numpy(rng.standard_normal((2, 64, 128)).astype(np.float32)).to(dtype)
    Q.reset_launch_count()
    got = Q.int8_matmul(x, q, s)
    assert got.shape == (2, 64, 256) and got.dtype == dtype
    assert torch.equal(got, Q.int8_matmul_plain(x, q, s))
    assert Q.launch_count() == Q.launch_count(route="tc") == Q.launch_count(route="ffma") == 0


def test_int8_matmul_checks_inputs():
    x = torch.zeros(2, 8)
    q = torch.zeros(8, 4, dtype=torch.int8)
    with pytest.raises(ValueError, match="K dim"):
        Q.int8_matmul(torch.zeros(2, 6), q, torch.ones(4))
    with pytest.raises(ValueError, match="scale"):
        Q.int8_matmul(x, q, torch.ones(3))
    with pytest.raises(ValueError, match="int8"):
        Q.int8_matmul(x, q.float(), torch.ones(4))
    with pytest.raises(TypeError, match="float32 or bfloat16"):
        Q.int8_matmul(x.double(), q, torch.ones(4))


@pytest.mark.parametrize("scope", ["head", "all"])
def test_quantize_lm_params_matches_jax_tree(scope):
    """The port's quantize over its state_dict, carried back to a flax
    tree, equals the JAX quantize over the same flax params; the carried
    JAX tree loads into a quant_dense TransformerLM."""
    import jax
    import jax.numpy as jnp

    from cs744_pytorch_distributed_tutorial_tpu.models.transformer import TransformerLM as JaxLM
    from cs744_pytorch_distributed_tutorial_tpu_torch.models.transformer import TransformerLM

    kw = dict(vocab_size=64, num_layers=1, num_heads=4, d_model=32, d_ff=64, max_seq_len=16,
              use_rope=True, mlp="swiglu", num_kv_heads=2)
    params = JaxLM(**kw).init(jax.random.key(0), jnp.zeros((1, 4), jnp.int32))["params"]
    mods = Q.resolve_quant_modules(scope)
    want = _jq().quantize_lm_params(params, mods)
    got = jax_lm_params_from_state_dict(Q.quantize_lm_params(lm_params_from_jax(params), mods))
    flat_want = {tuple(k.key for k in path): leaf
                 for path, leaf in jax.tree_util.tree_flatten_with_path(want)[0]}
    flat_got = {tuple(k.key for k in path): leaf
                for path, leaf in jax.tree_util.tree_flatten_with_path(got)[0]}
    assert set(flat_got) == set(flat_want)
    for path, leaf in flat_want.items():
        if path[-1] == "qkernel":
            np.testing.assert_array_equal(flat_got[path], np.asarray(leaf), err_msg=str(path))
        else:
            np.testing.assert_allclose(flat_got[path], np.asarray(leaf), rtol=1.2e-7,
                                       err_msg=str(path))
    model = TransformerLM(**kw, quant_dense=True, quant_modules=mods)
    model.load_state_dict(lm_params_from_jax(want))
    assert isinstance(model.lm_head, Q.QuantLinear)
    assert isinstance(model.blocks[0].mlp_gate, Q.QuantLinear) == (scope == "all")
    with pytest.raises(ValueError, match="unknown quant modules"):
        Q.quantize_lm_params({}, ("embed",))


@pytest.mark.cuda
def test_int8_matmul_kernel_matches_plain_on_card():
    """The CUDA kernels against their plain version (fp32 matmul, TF32 off)
    at the decode and ragged shapes, fp32 and bf16, each call on the route
    the rule gives it: max abs err <= 1e-5 x max|plain| in fp32, the bf16
    output within 1 bf16 ulp (2**-7 relative; near zero, 1e-5 x max|plain|,
    the fp32 sums' spread) of the plain one."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card and nvcc")
    torch.backends.cuda.matmul.allow_tf32 = False
    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(0)
    Q.reset_launch_count()
    shapes = [(16, 768, 4096), (1, 768, 50304), (100, 3072, 768), (7, 33, 5), (70, 130, 1000)]
    for m, k, n in shapes:
        w = torch.randn((k, n), generator=gen, device=dev)
        q, s = Q.quantize_int8(w)
        x = torch.randn((m, k), generator=gen, device=dev)
        for dtype in (torch.float32, torch.bfloat16):
            xd = x.to(dtype)
            got, want = Q.int8_matmul(xd, q, s), Q.int8_matmul_plain(xd, q, s)
            torch.cuda.synchronize()
            assert got.dtype == dtype and got.shape == (m, n)
            err = (got.float() - want.float()).abs()
            if dtype == torch.float32:
                assert float(err.max()) <= 1e-5 * float(want.abs().max()), (m, k, n)
            else:
                tol = 2**-7 * want.float().abs() + 1e-5 * float(want.float().abs().max())
                assert bool((err <= tol).all()), (m, k, n)
    assert Q.launch_count() == 2 * len(shapes)
    assert Q.launch_count(torch.bfloat16) == len(shapes)


@pytest.mark.cuda
def test_int8_matmul_tc_matches_plain_on_card(monkeypatch):
    """The tensor-core kernel at the GPT-2-small head's decode step and
    prompt pass and at a ragged shape (M not a multiple of 64, N a multiple
    of 16 but not of 128), bf16 x: each call launches the tensor-core
    kernel once, agrees with the plain version within 1 bf16 ulp (2**-7
    |plain| + 1e-5 x max|plain|), and gives the same bits twice; the FFMA
    route (tc_route patched to refuse) on the same inputs within the same
    limit."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card and nvcc")
    torch.backends.cuda.matmul.allow_tf32 = False
    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(1)
    for m, k, n in [(16, 768, 50304), (2048, 768, 50304), (77, 768, 50192)]:
        q, s = Q.quantize_int8(torch.randn((k, n), generator=gen, device=dev))
        x = torch.randn((m, k), generator=gen, device=dev).bfloat16()
        assert Q.tc_route(x.dtype, m, k, n)
        want = Q.int8_matmul_plain(x, q, s).float()
        limit = 2**-7 * want.abs() + 1e-5 * float(want.abs().max())
        Q.reset_launch_count()
        got, again = Q.int8_matmul(x, q, s), Q.int8_matmul(x, q, s)
        torch.cuda.synchronize()
        assert Q.launch_count(route="tc") == Q.launch_count() == 2, (m, k, n)
        assert got.dtype == torch.bfloat16 and got.shape == (m, n)
        assert torch.equal(got, again), (m, k, n)
        with monkeypatch.context() as patch:
            patch.setattr(Q, "tc_route", lambda *a, **kw: False)
            ffma = Q.int8_matmul(x, q, s)
            torch.cuda.synchronize()
        assert Q.launch_count(route="ffma") == 1, (m, k, n)
        for route, y in (("tc", got), ("ffma", ffma)):
            assert bool(((y.float() - want).abs() <= limit).all()), (route, m, k, n)
