"""The port's H-pair-packed 3x3 conv forward against the TPU probe's.

The JAX probe (``benchmarks/probe_fwd_hpair.py``) is loaded by file path
inside the fixture that needs it, so the ``cuda``-marked test also runs
on a machine with a card and no JAX. The same numpy inputs (x rounded to
bf16 from fp32 on both sides: the same bits) go through the probe's
Pallas kernel in interpret mode and the port's CPU path (the kernel's
plain version), for ``pack_weights(w)`` and for a random ``w_packed``.
Tolerance (``conv_fwd_hpair.agreement``): every element within 2 bf16
ulps of the larger magnitude plus 1e-5 x max|JAX output| (results near
zero, where the fp32 sums cancel), and at most 0.1 % of elements
differing at all (about 0.01-0.02 % do: near-ties of the final bf16
rounding after fp32 sums in another order).
"""

import importlib.util
import json
from pathlib import Path

import numpy as np
import pytest
import torch
import torch.nn.functional as F

from cs744_pytorch_distributed_tutorial_tpu_torch.ops import conv_fwd_hpair as H

PROBE = Path(__file__).resolve().parents[1] / "benchmarks" / "probe_fwd_hpair.py"

# (B, H, W, C, the probe's block_batch): the probe's CPU widths at B 4,
# and a narrow case.
CASES = [(4, 32, 32, 64, 2), (2, 8, 16, 16, 1)]


@pytest.fixture(scope="module")
def probe():
    spec = importlib.util.spec_from_file_location("probe_fwd_hpair", PROBE)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def _x(rng, b, h, w, c):
    return rng.standard_normal((b, h, w, c)).astype(np.float32)


def _hwio(rng, c, k):
    return (0.1 * rng.standard_normal((3, 3, c, k))).astype(np.float32)


def _bits(a) -> np.ndarray:
    """The bf16 bits of a JAX array or a torch tensor."""
    if isinstance(a, torch.Tensor):
        return a.contiguous().view(torch.int16).numpy().view(np.uint16)
    return np.asarray(a).view(np.uint16)


def _assert_agree(got: torch.Tensor, want: torch.Tensor) -> dict:
    assert got.shape == want.shape and got.dtype == want.dtype
    a = H.agreement(got, want)
    assert a["ok"], a
    return a


@pytest.mark.parametrize("c,k", [(64, 64), (16, 16), (8, 12)])
def test_pack_weights_bitwise(probe, c, k):
    import jax.numpy as jnp

    wk = _hwio(np.random.default_rng(c + k), c, k)
    want = _bits(probe.pack_weights(jnp.asarray(wk)))
    got = H.pack_weights(wk)
    assert got.dtype == torch.bfloat16 and tuple(got.shape) == (12 * c, 2 * k)
    np.testing.assert_array_equal(_bits(got), want)
    np.testing.assert_array_equal(_bits(H.pack_weights(torch.from_numpy(wk))), want)


@pytest.mark.parametrize("b,h,w,c,bb", CASES)
@pytest.mark.parametrize("weights", ["packed", "random"])
def test_matches_pallas_interpret(probe, b, h, w, c, bb, weights):
    import jax.numpy as jnp

    rng = np.random.default_rng(b * h + w + c)
    x = _x(rng, b, h, w, c)
    if weights == "packed":
        wp_j = probe.pack_weights(jnp.asarray(_hwio(rng, c, c)))
    else:
        wp_j = jnp.asarray(0.1 * rng.standard_normal((12 * c, 2 * c)), jnp.bfloat16)
    want = probe.conv3x3_fwd_hpair(jnp.asarray(x, jnp.bfloat16), wp_j, block_batch=bb,
                                   interpret=True)
    want = torch.from_numpy(np.array(want.astype(jnp.float32))).to(torch.bfloat16)
    wp = torch.from_numpy(_bits(wp_j).view(np.int16).copy()).view(torch.bfloat16)
    H.reset_launch_count()
    got = H.conv3x3_fwd_hpair(torch.from_numpy(x).to(torch.bfloat16), wp)
    assert H.launch_count() == 0  # CPU tensors take the plain version
    _assert_agree(got, want)


@pytest.mark.parametrize("b,h,w,c,bb", CASES)
def test_plain_is_the_same_conv(b, h, w, c, bb):
    """The plain version with ``pack_weights(w)`` against JAX's SAME conv
    with w (bf16 operands, fp32 sums, rounded once), in NHWC/HWIO."""
    import jax.numpy as jnp
    from jax import lax

    rng = np.random.default_rng(7 * b + c)
    x, wk = _x(rng, b, h, w, c), _hwio(rng, c, c)
    want = lax.conv_general_dilated(
        jnp.asarray(x, jnp.bfloat16), jnp.asarray(wk, jnp.bfloat16), (1, 1), "SAME",
        dimension_numbers=("NHWC", "HWIO", "NHWC"), preferred_element_type=jnp.float32,
    ).astype(jnp.bfloat16)
    want = torch.from_numpy(np.array(want.astype(jnp.float32))).to(torch.bfloat16)
    got = H.conv3x3_fwd_hpair_plain(torch.from_numpy(x).to(torch.bfloat16), H.pack_weights(wk))
    _assert_agree(got, want)


def test_agreement_limits():
    """Two ulps of the larger magnitude pass and three do not; a gap near
    zero within 1e-5 x max|want| passes; more than 0.1 % of elements
    differing fails."""
    want = torch.full((2000,), 1.5, dtype=torch.bfloat16)
    ulp = 2.0**-7  # a bf16 ulp in [1, 2)
    assert H.agreement(want, want) == {"share": 0.0, "differing": 0.0, "max_abs_err": 0.0,
                                       "ok": True}
    for steps, ok in ((2, True), (3, False)):
        got = want.clone()
        got[0] = 1.5 + steps * ulp
        assert H.agreement(got, want)["ok"] is ok
    got, ref = want.clone(), want.clone()
    ref[1], got[1] = 0.0, 1e-5
    assert H.agreement(got, ref)["ok"]
    got = want.clone()
    got[:3] = 1.5 + ulp  # 0.15 % of elements
    a = H.agreement(got, want)
    assert a["share"] <= 1.0 and not a["ok"]


def test_wrapper_checks_and_kernel_coverage():
    x = torch.zeros((2, 32, 32, 64), dtype=torch.bfloat16)
    wp = torch.zeros((768, 128), dtype=torch.bfloat16)
    for bad_x, bad_w, words in (
        (torch.zeros((2, 31, 32, 64), dtype=torch.bfloat16), wp, "H = 31"),
        (x, torch.zeros((768, 64), dtype=torch.bfloat16), "w_packed"),
        (x[0], wp, "NHWC"),
        (x, wp.float(), "bfloat16"),
    ):
        with pytest.raises(ValueError, match=words):
            H.conv3x3_fwd_hpair(bad_x, bad_w)
    # What the kernel takes: bf16, C 64, W 8-128 (powers of two), any B.
    for b in (1, 3, 4096):
        assert H.kernel_refusal(torch.bfloat16, (b, 32, 32, 64)) is None
    assert H.kernel_refusal(torch.bfloat16, (3, 2, 128, 64)) is None
    assert "float32" in H.kernel_refusal(torch.float32, (4, 32, 32, 64))
    assert "C = 16" in H.kernel_refusal(torch.bfloat16, (2, 8, 16, 16))
    assert "W = 24" in H.kernel_refusal(torch.bfloat16, (2, 8, 24, 64))


def test_hwio_to_oihw_is_the_library_conv():
    """``F.conv2d`` with ``hwio_to_oihw(w)`` on x's NCHW view, padding 1,
    is the plain version with ``pack_weights(w)`` (fp32 sums of bf16
    values; within the agreement's limits)."""
    rng = np.random.default_rng(3)
    x = torch.from_numpy(_x(rng, 2, 8, 16, 16)).to(torch.bfloat16)
    wk = _hwio(rng, 16, 16)
    ref = F.conv2d(x.permute(0, 3, 1, 2).float(),
                   H.hwio_to_oihw(torch.from_numpy(wk)).to(torch.bfloat16).float(), padding=1)
    _assert_agree(H.conv3x3_fwd_hpair(x, H.pack_weights(wk)),
                  ref.permute(0, 2, 3, 1).to(torch.bfloat16))


def test_main_without_a_card_raises():
    if torch.cuda.is_available():
        pytest.skip("a card is present: main([]) runs the probe there (chip_smoke.py phase 35)")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        H.main([])


def test_main_on_the_cpu_prints_the_numerics_line(capsys):
    assert H.main(["--device", "cpu"]) == 0
    lines = capsys.readouterr().out.strip().splitlines()
    assert lines[0].startswith("max abs err: ")
    summary = json.loads(lines[-1])
    assert summary["shape"] == [16, 32, 32, 64] and summary["rel_err"] < H.PROBE_REL_LIMIT
    assert summary["calls"] == 1 and "kernel_ms" not in summary
    # The bounds at the probe's card shape: the packed product's operations
    # (4.123e11 FLOP at 989 TFLOP/s) and the library conv's bytes.
    b = H.bounds_ms(H.PROBE_SHAPE)
    assert b["bound_by"] == "operations" and abs(b["bound_ms"] - 0.41689) < 1e-4
    assert b["library_bound_by"] == "bytes" and abs(b["library_bound_ms"] - 0.32058) < 1e-4


@pytest.mark.cuda
def test_kernel_matches_plain_on_card():
    """The CUDA kernel against its plain version: pack_weights(w) and a
    random w_packed at B 64, B 3 (no tile divides it) and H 2 (a tile
    wider than the image), within the agreement's limits; one launch a
    call; a refused shape raises before any launch."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card and nvcc")
    dev = torch.device("cuda")
    torch.backends.cuda.matmul.allow_tf32 = False
    gen = torch.Generator(device=dev).manual_seed(0)
    H.reset_launch_count()
    calls = 0
    for shape in ((64, 32, 32, 64), (3, 32, 32, 64), (3, 2, 32, 64), (2, 8, 128, 64)):
        x = torch.randn(shape, generator=gen, device=dev).to(torch.bfloat16)
        for wp in (H.pack_weights(0.1 * torch.randn((3, 3, 64, 64), generator=gen, device=dev)),
                   (0.1 * torch.randn((768, 128), generator=gen, device=dev)).to(torch.bfloat16)):
            got = H.conv3x3_fwd_hpair(x, wp)
            calls += 1
            _assert_agree(got, H.conv3x3_fwd_hpair_plain(x, wp))
    torch.cuda.synchronize()
    assert H.launch_count() == calls
    with pytest.raises(ValueError, match="C = 32"):
        H.conv3x3_fwd_hpair(torch.zeros((2, 8, 32, 32), dtype=torch.bfloat16, device=dev),
                            torch.zeros((384, 64), dtype=torch.bfloat16, device=dev))
    assert H.launch_count() == calls
