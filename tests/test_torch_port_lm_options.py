"""The port's remaining one-device LM training options against the JAX
package's: remat (policies ``none`` and ``dots``), residual dropout and
``accum_steps``, and their ``lm_cli`` flags (``scan_layers`` has its own
file, ``test_torch_port_scan_layers.py``).

- Trajectories: 3 AdamW steps of the port's ``LMTrainer`` with remat and
  ``accum_steps=2`` against the JAX ``LMTrainer`` with the same options
  (mesh data=1 seq=1), from the same weights on the same tokens: loss,
  grad_norm and param_norm within rtol 1e-5, parameters as in
  ``test_torch_port_lm.py`` (within lr, within 1e-5 but for one element in
  10,000, 1e-6 on average).
- Within the port: remat and ``dots`` match no remat (losses within rtol
  1e-6, the JAX ``tests/test_remat.py`` bound; here they are bitwise
  equal), MoE included; ``accum_steps=2`` matches the unaccumulated step
  (losses rtol 1e-5, parameters rtol 5e-3 / atol 1e-4, the JAX
  ``tests/test_lm_accum_ckpt.py`` bounds); the MoE statistics are the
  microbatches' mean; a resume under accumulation, remat and dropout is
  bit for bit the uninterrupted run.
- Dropout: rate 0 is bitwise the dropout-free path; masks are fixed per
  step and change with it, rate 0 ignores the step (JAX
  ``tests/test_lm_dropout.py``); remat with dropout gives bitwise the
  gradients without remat; the keep fraction is within 5 binomial
  standard deviations of 1 - rate and kept values are scaled by 1 / (1 -
  rate); with the same masks fed to both (flax's ``nn.Dropout`` patched
  in this test only) the port's loss is within 1e-5 relative of the flax
  model's and its gradients within 2e-5 + 1e-4 relative.
- The phase profiler's LM segments run under dropout (parity exact) and
  refuse ``accum_steps != 1``, as JAX's.
- ``lm_cli``: each new flag runs on the CPU, and the JAX CLI's refusals
  of ``--beam`` and ``--speculative-k`` combinations exit as there.
"""

import json
import math

import numpy as np
import pytest
import torch
import torch.nn.functional as F

from cs744_pytorch_distributed_tutorial_tpu_torch import lm_cli
from cs744_pytorch_distributed_tutorial_tpu_torch.data import synthetic_tokens
from cs744_pytorch_distributed_tutorial_tpu_torch.models import transformer as T
from cs744_pytorch_distributed_tutorial_tpu_torch.models.convert import lm_params_from_jax
from cs744_pytorch_distributed_tutorial_tpu_torch.train.lm import LMConfig, LMTrainer

LR = 1e-3
SMALL = dict(vocab_size=64, num_layers=2, num_heads=4, d_model=32, d_ff=64, max_seq_len=32,
             seq_len=32, global_batch_size=4, use_rope=True, learning_rate=LR)
MODEL = dict(vocab_size=64, num_layers=2, num_heads=4, d_model=32, d_ff=64, max_seq_len=32,
             use_rope=True)


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    """One intra-op thread for these tiny models (the suite's parallel
    workers otherwise stall every tiny op's parallel region)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _tokens(n=12, seed=1):
    return synthetic_tokens(n, SMALL["seq_len"], SMALL["vocab_size"], seed=seed)


def _run(cfg: LMConfig, toks, steps=3, step_indices=None, state_dict=None):
    tr = LMTrainer(cfg)
    tr.init(state_dict=state_dict)
    out = []
    for s in range(steps):
        batch = toks[4 * s: 4 * s + 4] if step_indices is None else toks[:4]
        idx = None if step_indices is None else step_indices[s]
        out.append({k: float(v) for k, v in tr.train_step(*tr.split_batch(batch), idx).items()})
    return tr, out


# ------------------------------------------------------------ against JAX
def test_remat_and_accum_trajectory_matches_jax():
    """Remat (policy none) and accum_steps=2 together, port flash (its
    plain version here) against JAX dense."""
    import jax

    from cs744_pytorch_distributed_tutorial_tpu.parallel import make_mesh
    from cs744_pytorch_distributed_tutorial_tpu.train import LMConfig as JaxConfig
    from cs744_pytorch_distributed_tutorial_tpu.train import LMTrainer as JaxTrainer

    opts = dict(remat=True, accum_steps=2)
    jt = JaxTrainer(JaxConfig(**SMALL, attention_impl="dense", **opts),
                    mesh=make_mesh({"data": 1, "seq": 1}, devices=jax.devices()[:1]))
    params, opt = jt.init()
    port = LMTrainer(LMConfig(**SMALL, attention_impl="flash", device="cpu", **opts))
    port.init(state_dict=lm_params_from_jax(jax.device_get(params)))
    toks = _tokens()
    for step in range(3):
        batch = toks[4 * step: 4 * (step + 1)]
        params, opt, want = jt.train_step(params, opt, *jt.shard_batch(batch), step)
        got = port.train_step(*port.split_batch(batch))
        assert set(got) == set(want) == {"loss", "grad_norm", "param_norm"}
        for key in want:
            assert float(got[key]) == pytest.approx(float(want[key]), rel=1e-5), (step, key)
    want_sd = lm_params_from_jax(jax.device_get(params))
    errs = torch.cat([(want_sd[k] - v).abs().flatten() for k, v in port.model.state_dict().items()])
    assert float(errs.max()) <= LR and float(errs.mean()) <= 1e-6
    assert int((errs > 1e-5).sum()) <= 1e-4 * errs.numel()


def test_dropout_with_the_same_masks_matches_flax(monkeypatch):
    """flax's ``nn.Dropout`` and the port's mask source both replaced by
    the same numpy masks, one per (layer, site) in flax's call order:
    the loss and the gradients of the mean cross-entropy agree (port
    with and without remat)."""
    import flax.linen as fnn
    import jax
    import jax.numpy as jnp
    import optax

    from cs744_pytorch_distributed_tutorial_tpu.models.transformer import (
        TransformerLM as JaxLM,
    )

    rate, b, t = 0.3, 2, 16
    toks = np.random.default_rng(3).integers(0, 64, (b, t + 1)).astype(np.int32)
    rng = np.random.default_rng(4)
    masks = [rng.random((b, t, MODEL["d_model"])) >= rate for _ in range(2 * MODEL["num_layers"])]
    calls = {"n": 0}

    def flax_dropout(self, inputs, deterministic=None, rng=None):
        mask = masks[calls["n"]]
        calls["n"] += 1
        return jnp.where(mask, inputs / (1.0 - self.rate), jnp.zeros_like(inputs))

    monkeypatch.setattr(fnn.Dropout, "__call__", flax_dropout)
    jmodel = JaxLM(**MODEL, attention_impl="dense", dropout_rate=rate)
    x, y = jnp.asarray(toks[:, :-1]), jnp.asarray(toks[:, 1:])
    params = jmodel.init(jax.random.key(0), x)["params"]

    def loss(p):
        logits = jmodel.apply({"params": p}, x, deterministic=False)
        return optax.softmax_cross_entropy_with_integer_labels(logits, y).mean()

    calls["n"] = 0
    want, jgrads = jax.jit(jax.value_and_grad(loss))(params)
    assert calls["n"] == len(masks)
    want_grads = lm_params_from_jax(jgrads)

    def port_mask(key, shape, r, device):
        assert r == rate and tuple(shape) == masks[0].shape
        return torch.from_numpy(masks[2 * key[3] + key[4]])

    monkeypatch.setattr(T, "dropout_mask", port_mask)
    for remat in (False, True):
        model = T.TransformerLM(**MODEL, attention_impl="flash", dropout_rate=rate, remat=remat)
        model.load_state_dict(lm_params_from_jax(params))
        logits = model(torch.from_numpy(toks[:, :-1]).long(), dropout=(0, 0, 0))
        y = torch.from_numpy(toks[:, 1:]).long().flatten()
        got = F.cross_entropy(logits.reshape(-1, 64), y)
        got.backward()
        assert float(got.detach()) == pytest.approx(float(want), rel=1e-5)
        for k, p in model.named_parameters():
            np.testing.assert_allclose(p.grad.numpy(), want_grads[k].numpy(), rtol=1e-4,
                                       atol=2e-5, err_msg=(remat, k))


# ------------------------------------------------------------ remat
@pytest.mark.parametrize("moe", [None, "dropless", "scatter"])
def test_remat_policies_match_no_remat(moe):
    """remat (policy none and dots) takes the unremat'ed trajectory: the
    flash forward, recomputed in the backward, and the MoE statistics,
    read before it."""
    extra = {} if moe is None else dict(moe_experts=4, moe_dispatch=moe)
    toks = _tokens()
    runs = {}
    for label, opts in (("plain", {}), ("none", dict(remat=True)),
                        ("dots", dict(remat=True, remat_policy="dots"))):
        cfg = LMConfig(**SMALL, attention_impl="flash", device="cpu", **extra, **opts)
        tr, steps = _run(cfg, toks)
        runs[label] = (steps, [p.detach() for p in tr.model.parameters()])
    base, base_params = runs["plain"]
    for label in ("none", "dots"):
        steps, params = runs[label]
        for key in base[0]:
            np.testing.assert_allclose([m[key] for m in steps], [m[key] for m in base],
                                       rtol=1e-6, err_msg=(label, key))
        assert all(torch.equal(a, b) for a, b in zip(params, base_params)), label


def test_remat_policy_names():
    with pytest.raises(ValueError, match="remat_policy"):
        T.resolve_remat_policy("everything")
    with pytest.raises(ValueError, match="remat_policy"):
        LMTrainer(LMConfig(**SMALL, device="cpu", remat=True, remat_policy="everything"))
    assert T.resolve_remat_policy("none") is None and T.REMAT_POLICIES == ("none", "dots")


# ------------------------------------------------------------ accum_steps
def test_accum_matches_unaccumulated():
    toks = synthetic_tokens(32, 32, 64, seed=3)
    results = []
    for accum in (1, 2):
        tr = LMTrainer(LMConfig(**{**SMALL, "global_batch_size": 8, "learning_rate": 1e-2},
                                attention_impl="flash", device="cpu", accum_steps=accum))
        _, _, losses = tr.fit(toks, 4)
        results.append((losses, tr.model.state_dict()))
    (l1, p1), (l2, p2) = results
    np.testing.assert_allclose(l1, l2, rtol=1e-5)
    for k in p1:
        np.testing.assert_allclose(p1[k].numpy(), p2[k].numpy(), rtol=5e-3, atol=1e-4, err_msg=k)


def test_accum_must_divide_the_batch():
    with pytest.raises(ValueError, match="accum_steps"):
        LMTrainer(LMConfig(**SMALL, device="cpu", accum_steps=3))
    with pytest.raises(ValueError, match="accum_steps"):
        LMTrainer(LMConfig(**SMALL, device="cpu", accum_steps=0))


def test_accum_averages_the_moe_statistics():
    tr = LMTrainer(LMConfig(**SMALL, attention_impl="flash", device="cpu", moe_experts=4,
                            moe_dispatch="scatter", accum_steps=2))
    tr.init()
    x, y = tr.split_batch(_tokens()[:4])
    halves = []
    for xs, ys in ((x[:2], y[:2]), (x[2:], y[2:])):
        loss, moe = tr.objective(xs, ys)
        halves.append({"loss": loss.detach(), **{k: v.detach() for k, v in moe.items()}})
    got = tr.train_step(x, y)
    for key in ("loss", "moe_aux", "moe_drop", "moe_load_entropy"):
        want = (halves[0][key] + halves[1][key]) / 2
        assert float(got[key]) == pytest.approx(float(want), rel=1e-6, abs=1e-7), key


def test_resume_under_accum_remat_and_dropout_is_exact(tmp_path):
    """Interrupted after 3 of 6 steps and resumed from the disk
    checkpoint: the same losses and state, bit for bit, as the
    uninterrupted run (the masks are keyed by the restored step)."""
    toks = synthetic_tokens(16, 32, 64, seed=9)
    opts = dict(**SMALL, attention_impl="flash", device="cpu", accum_steps=2, remat=True,
                dropout_rate=0.1)
    full = LMTrainer(LMConfig(**opts))
    _, _, want = full.fit(toks, 6)
    cfg = LMConfig(**opts, checkpoint_dir=str(tmp_path / "ck"), checkpoint_every=1)
    _, _, first = LMTrainer(cfg).fit(toks, 3)
    resumed = LMTrainer(cfg)
    _, _, rest = resumed.fit(toks, 6)
    assert first + rest == want
    a, b = full.capture_state(), resumed.capture_state()
    assert all(torch.equal(p, q)
               for p, q in zip(a["params"] + a["opt_nu"], b["params"] + b["opt_nu"]))


# ------------------------------------------------------------ dropout
def test_dropout_rate_zero_is_the_dropout_free_path():
    toks = _tokens()
    tr0, a = _run(LMConfig(**SMALL, attention_impl="flash", device="cpu"), toks)
    tr1, b = _run(LMConfig(**SMALL, attention_impl="flash", device="cpu", dropout_rate=0.0), toks)
    assert a == b
    model = tr0.model
    x = torch.from_numpy(toks[:2, :-1]).long()
    with torch.no_grad():
        assert torch.equal(model(x), model(x, dropout=(0, 5, 0)))


def test_dropout_masks_are_keyed_by_the_step():
    """Same batch each step: equal step indices give equal trajectories,
    a different one a different second loss; at rate 0 the index is
    inert."""
    toks = _tokens()
    cfg = LMConfig(**SMALL, attention_impl="flash", device="cpu", dropout_rate=0.3)
    _, a = _run(cfg, toks, 2, step_indices=[0, 0])
    _, again = _run(cfg, toks, 2, step_indices=[0, 0])
    _, b = _run(cfg, toks, 2, step_indices=[0, 1])
    assert a == again
    assert a[0] == b[0] and a[1]["loss"] != b[1]["loss"]
    off = cfg.replace(dropout_rate=0.0)
    _, c = _run(off, toks, 2, step_indices=[0, 0])
    _, d = _run(off, toks, 2, step_indices=[5, 9])
    assert c == d


@pytest.mark.parametrize("policy", ["none", "dots"])
def test_dropout_with_remat_gives_the_same_gradients(policy):
    gen = torch.Generator().manual_seed(2)
    x = torch.randint(0, 64, (2, 16), generator=gen)
    grads = []
    for remat in (False, True):
        model = T.TransformerLM(**MODEL, attention_impl="flash", dropout_rate=0.3, remat=remat,
                                remat_policy=policy, generator=torch.Generator().manual_seed(1))
        model(x, dropout=(0, 3, 1)).square().mean().backward()
        grads.append([p.grad for p in model.parameters()])
    assert all(torch.equal(a, b) for a, b in zip(*grads))


def test_dropout_keep_fraction_and_scale():
    n, rate = 200_000, 0.3
    keep = T.dropout_mask((0, 1, 0, 2, 1), (n,), rate, torch.device("cpu"))
    assert keep.dtype == torch.bool
    sd = math.sqrt(n * rate * (1 - rate))
    assert abs(int(keep.sum()) - n * (1 - rate)) <= 5 * sd
    again = T.dropout_mask((0, 1, 0, 2, 1), (n,), rate, torch.device("cpu"))
    other = T.dropout_mask((0, 1, 0, 2, 0), (n,), rate, torch.device("cpu"))
    assert torch.equal(keep, again) and not torch.equal(keep, other)
    out = T.dropout(torch.ones(n), rate, (0, 1, 0, 2, 1))
    assert torch.equal(out == 0, ~keep)
    assert torch.allclose(out[keep], torch.tensor(1 / (1 - rate)))
    assert torch.equal(T.dropout(torch.ones(7), 1.0, (0,)), torch.zeros(7))


@pytest.mark.cuda
def test_dropout_with_remat_through_flash_on_card():
    """GPT-2-width blocks (d 768, 12 heads, T 256) in bf16 through the
    flash kernels: dropout with remat (none and dots) gives bitwise the
    gradients dropout without remat gives, and the flash forward runs
    twice a layer under remat."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card and nvcc")
    from cs744_pytorch_distributed_tutorial_tpu_torch.ops import flash_attention as A

    dev = torch.device("cuda")
    x = torch.randint(0, 512, (4, 256), device=dev)
    grads, fwd = [], []
    for remat, policy in ((False, "none"), (True, "none"), (True, "dots")):
        model = T.TransformerLM(vocab_size=512, num_layers=2, num_heads=12, d_model=768,
                                d_ff=3072, max_seq_len=256, use_rope=True, dtype=torch.bfloat16,
                                attention_impl="flash", dropout_rate=0.1, remat=remat,
                                remat_policy=policy,
                                generator=torch.Generator().manual_seed(1)).to(dev)
        A.reset_launch_count()
        model(x, dropout=(0, 7, 0)).float().square().mean().backward()
        torch.cuda.synchronize()
        fwd.append(A.launch_count("fwd"))
        grads.append([p.grad for p in model.parameters()])
    assert fwd == [2, 4, 4]
    for other in grads[1:]:
        assert all(torch.equal(a, b) for a, b in zip(grads[0], other))


# ------------------------------------------------------------ phase segments
def test_phase_segments_run_with_dropout_and_refuse_accum():
    """``profile_lm_phases`` under dropout: the segments and the fused step
    draw the same step's masks (parity exact, the state restored);
    ``accum_steps != 1`` raises JAX's ValueError."""
    from cs744_pytorch_distributed_tutorial_tpu_torch.obs import phases as P

    cfg = LMConfig(**SMALL, attention_impl="flash", device="cpu", dropout_rate=0.2)
    tr = LMTrainer(cfg)
    tr.init()
    x, y = tr.split_batch(_tokens()[:4])
    with torch.no_grad():
        plain = float(tr._loss(x, y, 0.0))
    before = tr.capture_state(clone=True)
    report = P.profile_lm_phases(tr, x, y, iters=1)
    assert report.parity_ok and report.loss_fused == report.loss_segmented
    assert report.loss_fused != plain  # the masks were on
    after = tr.capture_state()
    assert all(torch.equal(a, b) for a, b in zip(before["params"], after["params"]))
    accum = LMTrainer(cfg.replace(accum_steps=2))
    accum.init()
    with pytest.raises(ValueError, match="accum_steps"):
        P.build_lm_segments(accum)


# ------------------------------------------------------------ lm_cli
CLI = ["--num-layers", "2", "--d-model", "32", "--num-heads", "4", "--d-ff", "64",
       "--vocab-size", "64", "--max-seq-len", "48", "--seq-len", "32", "--global-batch-size",
       "4", "--steps", "2", "--num-seqs", "16", "--use-rope", "--attention-impl", "flash",
       "--json", "--device", "cpu"]


@pytest.mark.parametrize("flags", [
    ["--remat"], ["--remat", "--remat-policy", "dots"], ["--scan-layers"],
    ["--dropout-rate", "0.1"], ["--accum-steps", "2"],
    ["--generate", "6", "--beam", "3"],
    ["--generate", "8", "--speculative-k", "2", "--temperature", "0"],
    ["--generate", "8", "--speculative-k", "3", "--draft-layers", "2", "--temperature", "0.8"],
], ids=["remat", "remat-dots", "scan-layers", "dropout", "accum", "beam", "speculative",
        "speculative-sampling"])
def test_cli_new_flags_run_on_cpu(flags, capsys, tmp_path):
    argv = [*CLI, *flags]
    if "--speculative-k" in flags:
        argv += ["--metrics-dir", str(tmp_path)]
    assert lm_cli.main(argv) == 0
    lines = capsys.readouterr().out.strip().splitlines()
    summary = json.loads(lines[-1])
    assert {"vocab_size", "mesh", "steps", "first_loss", "final_loss", "finite", "steps_run",
            "eval", "sample"} <= set(summary)
    assert summary["steps_run"] == 2 and summary["finite"]
    if "--generate" not in flags:
        return
    gen = summary["generation"]
    n = int(flags[flags.index("--generate") + 1])
    assert len(summary["sample"]) == n and gen["batch"] == 1
    if "--beam" in flags:
        assert gen["decoder"] == "beam" and gen["beam"] == 3
        return
    k = int(flags[flags.index("--speculative-k") + 1])
    assert gen["decoder"] == "speculative" and gen["k"] == k and 1 <= gen["target_calls"] < n
    assert any(line.startswith(f"speculative: {gen['target_calls']} target calls for {n} tokens "
                               f"(k={k}, accept rate ") for line in lines)
    events = [json.loads(r) for r in open(tmp_path / "metrics.jsonl")]
    (ev,) = [e for e in events if e.get("event") == "speculative_decode"]
    assert ev["target_calls"] == gen["target_calls"] and ev["accept_rate"] == gen["accept_rate"]
    assert ev["draft_layers"] == int(flags[flags.index("--draft-layers") + 1]) if (
        "--draft-layers" in flags) else ev["draft_layers"] == 1


@pytest.mark.parametrize("flags,match", [
    (["--beam", "2", "--temperature", "0.5"], "--beam is deterministic"),
    (["--beam", "2", "--temperature", "0"], "--beam is deterministic"),
    (["--beam", "2", "--top-k", "5"], "--beam is deterministic"),
    (["--beam", "2", "--top-p", "0.9"], "--beam is deterministic"),
    (["--generate", "4", "--speculative-k", "2", "--beam", "2"], "does not combine with --beam"),
    (["--generate", "4", "--speculative-k", "2", "--top-k", "5"], "temperature-only"),
    (["--generate", "4", "--speculative-k", "2", "--top-p", "0.5"], "temperature-only"),
    (["--generate", "4", "--speculative-k", "2", "--int8-decode", "head"], "int8 decode"),
    (["--generate", "4", "--speculative-k", "2", "--int8-kv-cache"], "int8 decode"),
])
def test_cli_refuses_what_jax_refuses(flags, match):
    with pytest.raises(SystemExit, match=match):
        lm_cli.main([*CLI, *flags])
