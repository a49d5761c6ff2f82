"""The port's pipeline schedules and trainer (``parallel/pipeline.py``)
against the JAX package's, in one process.

The port's stages run in lockstep through ``simulate_pipe`` (no process
group); the JAX functions under ``shard_map`` on 4 of the 8 host devices,
their flash kernels in interpret mode, as ``tests/test_pipeline.py`` runs
them. The same numpy inputs on both sides, fp32, a block stack of 4
layers at d 32, 4 heads, d_ff 64, T 16, vocab 64:

- GPipe (``spmd_pipeline`` and its reverse), the interleaved schedule
  (V 2 over 2 stages) and 1F1B (plain tail and the distributed tail) on
  ``stack_apply`` blocks, dense and flash: the stacked parameters' and
  the inputs' gradients (and 1F1B's loss and tail gradients) at rtol
  1e-5, atol 1e-6; the outputs at rtol 1e-5 with atol 1e-6 x max|JAX
  output| (the outputs reach 8.6, whose float32 spacing is 9.5e-7: a
  handful of near-zero elements of 4,096 differ by up to 2.4e-6 from
  the summation order alone); the hops a step equal to the schedule's
  ticks;
- ``interleave_layers``, ``interleaved_stats`` and ``one_f_one_b_stats``
  equal to JAX's; ``_sharded_ce`` over the pipe axis (and the joint
  form with an explicit offset) equal to the full-vocab CE and its
  gradient;
- ``from_transformer_lm_params`` and the pipeline tree's conversions
  bitwise;
- four simulated stages of ``PipelineLMTrainer`` on each schedule
  against the JAX trainer on 4 devices from one init, 2 AdamW steps:
  losses rtol 1e-5, the parameters as ``test_torch_port_lm_dp4.py``
  holds AdamW's;
- every ``PipelineLMTrainer`` refusal and every ``lm_cli`` pipeline-route
  refusal with JAX's type and message.
"""

import numpy as np
import pytest
import torch

S, M, L, D, HEADS, FF, T, V, MB = 4, 4, 4, 32, 4, 64, 16, 64, 2
TOL = dict(rtol=1e-5, atol=1e-6)
ADAM_OUTLIERS = 1e-4
LR = 1e-3


def _block_stack(n: int, seed: int = 0) -> dict:
    """A stack of n pure-pytree blocks (JAX ``BLOCK_PARAM_NAMES``), numpy."""
    from cs744_pytorch_distributed_tutorial_tpu_torch.parallel.pipeline import BLOCK_PARAM_NAMES

    rng = np.random.default_rng(seed)
    shapes = {"ln1_scale": (D,), "ln1_bias": (D,), "wq": (D, D), "wk": (D, D), "wv": (D, D),
              "wo": (D, D), "ln2_scale": (D,), "ln2_bias": (D,), "w1": (D, FF), "b1": (FF,),
              "w2": (FF, D), "b2": (D,)}
    assert set(shapes) == set(BLOCK_PARAM_NAMES)
    out = {}
    for name in BLOCK_PARAM_NAMES:
        shape = (n, *shapes[name])
        base = 1.0 if name.endswith("scale") else 0.0
        scale = 0.1 if len(shapes[name]) == 1 else shapes[name][0] ** -0.5
        out[name] = (base + scale * rng.standard_normal(shape)).astype(np.float32)
    return out


def _mb(seed: int = 1):
    """Inputs, a cotangent of the outputs at the scale a mean over the
    batch's tokens gives it, targets and a head."""
    rng = np.random.default_rng(seed)
    x = rng.standard_normal((M, MB, T, D)).astype(np.float32)
    ct = (rng.standard_normal((M, MB, T, D)) / (M * MB * T)).astype(np.float32)
    tgt = rng.integers(0, V, (M, MB, T))
    head = (rng.standard_normal((D, V)) * D ** -0.5).astype(np.float32)
    return x, ct, tgt, head


def _jax_mesh(n: int):
    import jax

    from cs744_pytorch_distributed_tutorial_tpu.parallel import make_mesh

    return make_mesh({"pipe": n}, devices=jax.devices()[:n])


def _stages(stack: dict, n: int) -> list[dict]:
    rows = next(iter(stack.values())).shape[0] // n
    return [{k: torch.tensor(v[i * rows:(i + 1) * rows]).requires_grad_(True)
             for k, v in stack.items()} for i in range(n)]


# ------------------------------------------------------------ the schedules
@pytest.mark.parametrize("impl", ["dense", "flash"])
@pytest.mark.parametrize("kind", ["gpipe", "interleaved"])
def test_forward_and_reverse_match_jax(kind, impl):
    import jax
    import jax.numpy as jnp
    from jax.sharding import PartitionSpec as P

    from cs744_pytorch_distributed_tutorial_tpu.parallel import pipeline as JP
    from cs744_pytorch_distributed_tutorial_tpu_torch.parallel import collectives as C
    from cs744_pytorch_distributed_tutorial_tpu_torch.parallel import pipeline as PP

    s, v = (S, 1) if kind == "gpipe" else (2, 2)
    stack = _block_stack(L)
    x, ct, _, _ = _mb()

    def jfn(p, h):
        return JP.stack_apply(p, h, HEADS, impl=impl, interpret=True)

    def run(stacked, mb, g):
        def loss(stacked, mb):
            if kind == "gpipe":
                out = JP.spmd_pipeline(jfn, stacked, mb, axis_name="pipe", num_stages=s,
                                       num_microbatches=M)
            else:
                out = JP.spmd_pipeline_interleaved(jfn, stacked, mb, axis_name="pipe",
                                                   num_stages=s, num_microbatches=M,
                                                   num_chunks=v)
            return (out * g).sum(), out
        (_, out), grads = jax.value_and_grad(loss, argnums=(0, 1), has_aux=True)(stacked, mb)
        return out, grads

    f = jax.jit(jax.shard_map(run, mesh=_jax_mesh(s), in_specs=(P("pipe"), P(), P()),
                              out_specs=(P(), (P("pipe"), P())), check_vma=False))
    want_out, (want_dp, want_dx) = jax.device_get(
        f({k: jnp.asarray(a) for k, a in stack.items()}, jnp.asarray(x), jnp.asarray(ct)))

    def fn(p, h, *_):
        return PP.stack_apply(p, h, HEADS, impl=impl)

    stages = _stages(stack, s)
    mb = torch.tensor(x)
    C.hops.clear()
    if kind == "gpipe":
        fwd = PP.simulate_pipe([PP.spmd_pipeline(fn, stages[i], mb, stage=i, num_stages=s,
                                                 num_microbatches=M) for i in range(s)])
        back = PP.simulate_pipe([PP.spmd_pipeline_backward(tape, torch.tensor(ct))
                                 for _, tape in fwd])
        ticks = M + s - 1
    else:
        fwd = PP.simulate_pipe([PP.spmd_pipeline_interleaved(
            fn, stages[i], mb, stage=i, num_stages=s, num_microbatches=M, num_chunks=v)
            for i in range(s)])
        back = PP.simulate_pipe([PP.spmd_pipeline_interleaved_backward(tape, torch.tensor(ct))
                                 for _, tape in fwd])
        ticks = v * M + s - 1
    assert C.hops["pipe"] == 2 * ticks
    for out, _ in fwd:
        np.testing.assert_allclose(out.numpy(), want_out, rtol=TOL["rtol"],
                                   atol=TOL["atol"] * np.abs(want_out).max())
    for name in stack:
        got = np.concatenate([d_p[name].numpy() for d_p, _ in back])
        np.testing.assert_allclose(got, want_dp[name], **TOL, err_msg=name)
    for _, d_mb in back:
        np.testing.assert_allclose(d_mb.numpy(), want_dx, **TOL)


@pytest.mark.parametrize("impl,dist_tail", [("dense", False), ("dense", True),
                                            ("flash", True)])
def test_one_f_one_b_matches_jax(impl, dist_tail):
    import jax
    import jax.numpy as jnp
    import optax
    from jax import lax
    from jax.sharding import PartitionSpec as P

    from cs744_pytorch_distributed_tutorial_tpu.parallel import pipeline as JP
    from cs744_pytorch_distributed_tutorial_tpu_torch.parallel import collectives as C
    from cs744_pytorch_distributed_tutorial_tpu_torch.parallel import pipeline as PP

    stack = _block_stack(L)
    x, _, tgt, head = _mb()
    vs = V // S

    def jfn(p, h):
        return JP.stack_apply(p, h, HEADS, impl=impl, interpret=True)

    def jpost(pp, y, t):
        if dist_tail:
            w = lax.dynamic_slice_in_dim(pp["head"], lax.axis_index("pipe") * vs, vs, axis=1)
            return JP._sharded_ce(y @ w, t, "pipe")
        return optax.softmax_cross_entropy_with_integer_labels(y @ pp["head"], t).mean()

    def run(stacked, pp, mb, t):
        return JP.one_f_one_b_pipeline(jfn, jpost, stacked, pp, mb, t, axis_name="pipe",
                                       num_stages=S, num_microbatches=M,
                                       distributed_tail=dist_tail)

    f = jax.jit(jax.shard_map(run, mesh=_jax_mesh(S), in_specs=(P("pipe"), P(), P(), P()),
                              out_specs=(P(), P("pipe"), P(), P()), check_vma=False))
    want = jax.device_get(f({k: jnp.asarray(a) for k, a in stack.items()},
                            {"head": jnp.asarray(head)}, jnp.asarray(x), jnp.asarray(tgt)))

    def fn(p, h, *_):
        return PP.stack_apply(p, h, HEADS, impl=impl)

    def post_for(i):
        def post(pp, y, t):
            if dist_tail:
                return PP._sharded_ce(y @ pp["head"][:, i * vs:(i + 1) * vs], t, "pipe",
                                      stage=i)
            return torch.nn.functional.cross_entropy((y @ pp["head"]).reshape(-1, V),
                                                     t.reshape(-1))
        return post

    stages = _stages(stack, S)
    C.hops.clear()
    got = PP.simulate_pipe([PP.one_f_one_b_pipeline(
        fn, post_for(i), stages[i], {"head": torch.tensor(head).requires_grad_(True)},
        torch.tensor(x), torch.tensor(tgt), stage=i, num_stages=S, num_microbatches=M,
        distributed_tail=dist_tail) for i in range(S)])
    assert C.hops["pipe"] == 2 * (M + S - 1)
    for loss, _, d_post, d_in in got:
        np.testing.assert_allclose(float(loss), float(want[0]), **TOL)
        np.testing.assert_allclose(d_post["head"].numpy(), want[2]["head"], **TOL)
        np.testing.assert_allclose(d_in.numpy(), want[3], **TOL)
    for name in stack:
        np.testing.assert_allclose(np.concatenate([g[1][name].numpy() for g in got]),
                                   want[1][name], **TOL, err_msg=name)


@pytest.mark.parametrize("layers,s,v", [(8, 2, 2), (12, 3, 2), (12, 2, 3), (4, 4, 1)])
def test_layouts_and_stats_are_jax_s(layers, s, v):
    from cs744_pytorch_distributed_tutorial_tpu.parallel import pipeline as JP
    from cs744_pytorch_distributed_tutorial_tpu_torch.parallel import pipeline as PP

    for got, want in zip(PP.interleave_layers(layers, s, v), JP.interleave_layers(layers, s, v)):
        np.testing.assert_array_equal(got, want)
    assert PP.interleaved_stats(s, 4, v) == JP.interleaved_stats(s, 4, v)
    assert PP.one_f_one_b_stats(s, 6) == JP.one_f_one_b_stats(s, 6)
    with pytest.raises(ValueError, match="not divisible by num_stages"):
        PP.interleave_layers(layers + 1, s, 2)


@pytest.mark.parametrize("joint", [False, True])
def test_sharded_ce_is_the_full_vocab_ce(joint):
    from cs744_pytorch_distributed_tutorial_tpu_torch.parallel import pipeline as PP
    from cs744_pytorch_distributed_tutorial_tpu_torch.parallel.mesh import Mesh

    rng = np.random.default_rng(5)
    logits = torch.tensor(rng.standard_normal((3, 7, V)).astype(np.float32) * 3)
    tgt = torch.tensor(rng.integers(0, V, (3, 7)))
    full = logits.clone().requires_grad_(True)
    want = torch.nn.functional.cross_entropy(full.reshape(-1, V), tgt.reshape(-1))
    (want_g,) = torch.autograd.grad(want, full)
    vs = V // S
    slices = [logits[..., i * vs:(i + 1) * vs].clone().requires_grad_(True) for i in range(S)]
    axis = ("pipe", "tensor") if joint else "pipe"
    with torch.enable_grad():
        losses = PP.simulate_pipe([PP._sharded_ce(
            slices[i], tgt, axis, shard_offset=i * vs if joint else None, mesh=Mesh.get(),
            stage=i) for i in range(S)])
    for loss in losses:
        np.testing.assert_allclose(float(loss.detach()), float(want.detach()), **TOL)
    got_g = torch.cat([torch.autograd.grad(loss, sl)[0] for loss, sl in zip(losses, slices)],
                      dim=-1)
    np.testing.assert_allclose(got_g.numpy(), want_g.numpy(), **TOL)
    if joint:
        with pytest.raises(ValueError, match="explicit shard_offset"):
            next(PP._sharded_ce(slices[0], tgt, axis, mesh=Mesh.get()))


# ------------------------------------------------------ the tree and its copies
def test_from_transformer_lm_params_and_conversions_are_bitwise():
    import jax
    import jax.numpy as jnp

    from cs744_pytorch_distributed_tutorial_tpu.models.transformer import TransformerLM as JaxLM
    from cs744_pytorch_distributed_tutorial_tpu.parallel import pipeline as JP
    from cs744_pytorch_distributed_tutorial_tpu_torch.models import convert
    from cs744_pytorch_distributed_tutorial_tpu_torch.parallel import pipeline as PP

    for kw in (dict(use_rope=False), dict(use_rope=True, num_kv_heads=2)):
        lm = jax.device_get(JaxLM(vocab_size=V, num_layers=L, num_heads=HEADS, d_model=D,
                                  d_ff=FF, max_seq_len=T, attention_impl="dense", **kw)
                            .init(jax.random.key(0), jnp.zeros((1, T), jnp.int32))["params"])
        tree = jax.device_get(JP.from_transformer_lm_params(lm, L))
        got = PP.from_transformer_lm_params(convert.lm_params_from_jax(lm), L)
        want = convert.pipeline_params_from_jax(tree)
        assert sorted(got) == sorted(want)
        for k in want:
            np.testing.assert_array_equal(got[k].numpy(), want[k].numpy(), err_msg=k)
        back = convert.jax_pipeline_params_from_torch(want)
        flat_a = jax.tree_util.tree_flatten_with_path(tree)[0]
        flat_b = jax.tree_util.tree_flatten_with_path(back)[0]
        assert [p for p, _ in flat_a] == [p for p, _ in flat_b]
        for (path, a), (_, b) in zip(flat_a, flat_b):
            np.testing.assert_array_equal(np.asarray(a), np.asarray(b), err_msg=str(path))


# --------------------------------------------- simulated trainer against JAX
SMALL = dict(vocab_size=V, num_layers=L, num_heads=HEADS, d_model=D, d_ff=FF, max_seq_len=T,
             seq_len=T, global_batch_size=8, num_microbatches=4, learning_rate=LR)


@pytest.mark.parametrize("schedule,kw", [
    ("gpipe", dict(attention_impl="flash")),
    ("1f1b", dict(use_rope=True, remat=True)),
    ("interleaved", dict(num_layers=8, num_virtual_stages=2, grad_clip_norm=0.05)),
])
def test_simulated_stages_train_as_the_jax_trainer(schedule, kw):
    import jax

    from cs744_pytorch_distributed_tutorial_tpu.parallel import make_mesh
    from cs744_pytorch_distributed_tutorial_tpu.parallel import pipeline as JP
    from cs744_pytorch_distributed_tutorial_tpu_torch.models import convert
    from cs744_pytorch_distributed_tutorial_tpu_torch.parallel import pipeline as PP

    cfg = dict(SMALL, pipeline_parallel=S, schedule=schedule, **kw)
    jt = JP.PipelineLMTrainer(JP.PipelineLMConfig(**cfg),
                              mesh=make_mesh({"data": 1, "pipe": S}, devices=jax.devices()[:S]))
    params, opt = jt.init()
    init = jt.host_params(params)
    init = dict(init, blocks=jt.blocks_to_logical(init["blocks"]))
    toks = np.random.default_rng(3).integers(0, V, (16, T + 1))
    want = []
    for step in range(2):
        x, y = jt.shard_batch(toks[step * 8:(step + 1) * 8])
        params, opt, m = jt.train_step(params, opt, x, y, step)
        want.append(float(m["loss"]))
    want_params = convert.pipeline_params_from_jax(jt.host_params(params))

    trs = [PP.PipelineLMTrainer(PP.PipelineLMConfig(**cfg, device="cpu"), stage=i)
           for i in range(S)]
    logical = convert.pipeline_params_from_jax(init)
    for tr in trs:
        tr.init(params=logical)
    got = [float(PP.simulate_train_step(trs, *trs[0].split_batch(toks[s * 8:(s + 1) * 8]))["loss"])
           for s in range(2)]
    np.testing.assert_allclose(got, want, rtol=1e-5)
    have = PP.simulated_host_params(trs)
    gaps = np.concatenate([np.abs(have[k].numpy() - v.numpy()).ravel()
                           for k, v in want_params.items()])
    limit = np.concatenate([TOL["atol"] + TOL["rtol"] * np.abs(v.numpy()).ravel()
                            for v in want_params.values()])
    assert (gaps > limit).sum() <= ADAM_OUTLIERS * gaps.size
    assert gaps.max() <= LR * 2 and gaps.mean() <= 1e-6


# ----------------------------------------------------------------- refusals
REFUSALS = [
    (dict(pipeline_parallel=4, num_layers=6), "num_layers 6 not divisible by pipe axis"),
    (dict(pipeline_parallel=2, data_parallel=2, num_microbatches=3),
     "not divisible by num_microbatches"),
    (dict(pipeline_parallel=2, seq_len=32), "seq_len 32 > max_seq_len"),
    (dict(pipeline_parallel=2, schedule="zb"), "unknown schedule"),
    (dict(pipeline_parallel=2, schedule="interleaved", num_virtual_stages=0),
     "num_virtual_stages must be >= 1"),
    (dict(pipeline_parallel=2, schedule="interleaved", num_virtual_stages=4),
     "pipe \\* num_virtual_stages"),
    (dict(pipeline_parallel=4, schedule="interleaved", num_virtual_stages=1,
          num_microbatches=2), "divisible by the pipe axis"),
    (dict(pipeline_parallel=2, attention_impl="ring"), "without a seq axis"),
    (dict(pipeline_parallel=2, seq_parallel=2, attention_impl="dense"),
     "incompatible with seq_parallel"),
    (dict(pipeline_parallel=2, tensor_parallel=3), "num_heads 4 not divisible by tensor"),
    (dict(pipeline_parallel=2, tensor_parallel=2, num_kv_heads=1),
     "num_kv_heads 1 not divisible"),
    (dict(pipeline_parallel=2, tensor_parallel=2, vocab_size=63),
     "vocab_size 63 not divisible"),
    (dict(pipeline_parallel=2, dropout_rate=1.0), "dropout_rate must be in"),
    (dict(pipeline_parallel=2, data_parallel=2, moe_experts=3, moe_expert_parallel=True),
     "not divisible by the data axis"),
    (dict(pipeline_parallel=2, data_parallel=2, moe_experts=4, moe_expert_parallel=True,
          moe_dispatch="dropless"), "does not compose with moe_expert_parallel"),
    (dict(pipeline_parallel=2, zero1=True, fsdp=True), "mutually exclusive"),
    (dict(pipeline_parallel=2, zero1=True, optimizer="rmsprop"), "unknown optimizer"),
]


@pytest.mark.parametrize("kw,match", REFUSALS)
def test_trainer_refusals_are_jax_s(kw, match):
    import jax

    from cs744_pytorch_distributed_tutorial_tpu.parallel import make_mesh
    from cs744_pytorch_distributed_tutorial_tpu.parallel import pipeline as JP
    from cs744_pytorch_distributed_tutorial_tpu_torch.parallel import pipeline as PP

    cfg = {**SMALL, **kw}
    axes = {"data": cfg.get("data_parallel", 1), "pipe": cfg["pipeline_parallel"]}
    for name in ("seq", "tensor"):
        if cfg.get(f"{name}_parallel", 1) > 1:
            axes[name] = cfg[f"{name}_parallel"]
    mesh = make_mesh(axes, devices=jax.devices()[:int(np.prod(list(axes.values())))])
    with pytest.raises(ValueError, match=match) as want:
        JP.PipelineLMTrainer(JP.PipelineLMConfig(**cfg), mesh=mesh)
    with pytest.raises(ValueError, match=match) as got:
        PP.PipelineLMTrainer(PP.PipelineLMConfig(**cfg, device="cpu"))
    assert str(got.value) == str(want.value)


CLI = ["--num-layers", "4", "--d-model", "32", "--num-heads", "4", "--d-ff", "64",
       "--vocab-size", "64", "--max-seq-len", "16", "--seq-len", "16", "--steps", "1",
       "--num-seqs", "8"]
CLI_REFUSALS = [
    ["--pipeline-parallel", "2", "--generate", "4"],
    ["--pipeline-parallel", "2", "--beam", "2"],
    ["--pipeline-parallel", "2", "--accum-steps", "2"],
    ["--pipeline-parallel", "2", "--label-smoothing", "0.1"],
    ["--pipeline-parallel", "2", "--fused-xent"],
    ["--pipeline-parallel", "2", "--tie-embeddings"],
    ["--pipeline-parallel", "2", "--grad-compress", "int8"],
    ["--pipeline-parallel", "2", "--sync-overlap", "bucket"],
    ["--pipeline-parallel", "2", "--metrics-dir", "m"],
    ["--pipeline-parallel", "2", "--metrics-every", "2"],
    ["--pipeline-parallel", "2", "--num-virtual-stages", "2"],
    ["--num-virtual-stages", "2"],
    ["--pipeline-parallel", "2", "--scan-layers"],
    ["--pipeline-parallel", "2", "--seq-parallel", "2", "--attention-impl", "dense"],
    ["--pipeline-parallel", "2", "--attention-impl", "ulysses"],
]


@pytest.mark.parametrize("flags", CLI_REFUSALS, ids=lambda f: "_".join(f).replace("-", ""))
def test_lm_cli_pipeline_refusals_are_jax_s(flags):
    from cs744_pytorch_distributed_tutorial_tpu import lm_cli as jax_cli
    from cs744_pytorch_distributed_tutorial_tpu_torch import lm_cli

    with pytest.raises(SystemExit) as want:
        jax_cli.main(CLI + flags)
    with pytest.raises(SystemExit) as got:
        lm_cli.main(CLI + ["--device", "cpu"] + flags)
    assert str(got.value) == str(want.value)


def test_lm_cli_pipeline_route_needs_its_world():
    from cs744_pytorch_distributed_tutorial_tpu_torch import lm_cli

    with pytest.raises(SystemExit, match="must equal the world size"):
        lm_cli.main(CLI + ["--device", "cpu", "--pipeline-parallel", "2"])


def test_simulated_stage_refusals():
    from cs744_pytorch_distributed_tutorial_tpu_torch.parallel import pipeline as PP

    cfg = PP.PipelineLMConfig(**SMALL, pipeline_parallel=2, device="cpu")
    with pytest.raises(ValueError, match="outside the pipe axis"):
        PP.PipelineLMTrainer(cfg, stage=2)
    with pytest.raises(ValueError, match="a world of one"):
        PP.PipelineLMTrainer(cfg.replace(zero1=True), stage=0)
    with pytest.raises(ValueError, match="world size 1"):
        PP.PipelineLMTrainer(cfg)
    with pytest.raises(ValueError, match="simulate_pipe"):
        PP.PipelineLMTrainer(cfg, stage=0).train_step(None, None)


# ------------------------------------------------------------ fit on one rank
def _one_rank(**kw):
    from cs744_pytorch_distributed_tutorial_tpu_torch.parallel import pipeline as PP

    cfg = dict(SMALL, num_layers=2, pipeline_parallel=1, num_microbatches=2, **kw)
    return PP.PipelineLMTrainer(PP.PipelineLMConfig(**cfg, device="cpu"))


def test_fit_halts_on_a_non_finite_loss():
    """lr 1e30 blows the parameters up within a few steps: ``fit`` raises
    ``NonFiniteLossError`` (the JAX engines' contract); opted out, it runs
    through."""
    from cs744_pytorch_distributed_tutorial_tpu_torch.utils.failure import NonFiniteLossError

    toks = np.random.default_rng(0).integers(0, V, (16, T + 1))
    with pytest.raises(NonFiniteLossError) as exc:
        _one_rank(learning_rate=1e30).fit(toks, steps=8)
    assert not np.isfinite(exc.value.loss)
    _, _, losses = _one_rank(learning_rate=1e30, halt_on_nonfinite=False).fit(toks, steps=3)
    assert len(losses) == 3


def test_fit_persists_only_certified_checkpoints(tmp_path):
    """A checkpoint due at step k is written only after a later forward
    over its parameters came back finite: the newest checkpoint of a
    diverged run evaluates finite (JAX's divergence-safe order)."""
    from cs744_pytorch_distributed_tutorial_tpu_torch.utils.checkpoint import Checkpointer
    from cs744_pytorch_distributed_tutorial_tpu_torch.utils.failure import NonFiniteLossError

    ck = str(tmp_path / "ckpt")
    toks = np.random.default_rng(0).integers(0, V, (16, T + 1))
    with pytest.raises(NonFiniteLossError) as exc:
        _one_rank(learning_rate=1e30, checkpoint_dir=ck, checkpoint_every=1).fit(toks, steps=8)
    tr = _one_rank()
    tr.init()
    ckpt = Checkpointer(ck)
    state = ckpt.restore_latest(adapt=tr.elastic_state)
    ckpt.close()
    if state is not None:  # a divergence at step 0 persists nothing
        assert state["step"] < exc.value.step
        tr.restore_state(state)
        loss = float(tr.eval_step(*tr.split_batch(toks[:8]))["loss"])
        assert np.isfinite(loss)


def test_evaluate_is_the_held_out_contract():
    tr = _one_rank()
    tr.init()
    toks = np.random.default_rng(1).integers(0, V, (20, T + 1))
    ev = tr.evaluate(toks)
    assert set(ev) == {"loss", "perplexity"}
    assert ev["perplexity"] == pytest.approx(np.exp(ev["loss"]), rel=1e-6)
    assert ev["loss"] == pytest.approx(np.log(V), rel=0.2)
    with pytest.raises(ValueError, match="need at least global_batch_size"):
        tr.evaluate(toks[:4])


# ------------------------------------------------- the mesh and the forward
def _lm_axes4_layouts():
    import importlib.util
    import os

    path = os.path.join(os.path.dirname(os.path.abspath(__file__)), "test_torch_port_lm_axes4.py")
    spec = importlib.util.spec_from_file_location("lm_axes4_layouts", path)
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module.LAYOUTS


@pytest.mark.parametrize("pipe", [1, 2])
def test_mesh_coordinates_are_the_jax_mesh_s(pipe):
    """Every rank of a (data, pipe, seq, tensor) mesh sits where the JAX
    ``make_mesh`` puts its device: with pipe 1 the (data, seq, tensor)
    layouts of ``test_torch_port_lm_axes4.py`` keep their coordinates;
    with pipe 2 the axis sits between data and seq (the JAX pipeline
    engine's order)."""
    import jax

    from cs744_pytorch_distributed_tutorial_tpu.parallel import make_mesh
    from cs744_pytorch_distributed_tutorial_tpu_torch.parallel.mesh import mesh_coords

    for (d, s, t), _ in _lm_axes4_layouts().values():
        if d * pipe * s * t > 8:
            continue
        axes = {"data": d, "pipe": pipe, "seq": s, "tensor": t}
        names = [a for a in axes if a == "data" or axes[a] > 1 or (a == "pipe" and pipe > 1)]
        jm = make_mesh({a: axes[a] for a in names},
                       devices=jax.devices()[:d * pipe * s * t])
        for r, dev in enumerate(jax.devices()[:d * pipe * s * t]):
            at = dict(zip(jm.axis_names, (int(c) for c in np.argwhere(jm.devices == dev)[0])))
            want = {a: at.get(a, 0) for a in ("data", "pipe", "seq", "tensor")}
            assert mesh_coords(r, axes) == want, (axes, r)
            if pipe == 1:
                assert mesh_coords(r, {"data": d, "seq": s, "tensor": t}) == want


@pytest.mark.parametrize("schedule", ["gpipe", "interleaved"])
def test_forward_equals_the_unpipelined_reference(schedule):
    """``simulate_forward`` of four stages (interleaved: V 2, storage
    order) equals ``reference_forward`` on the same global parameters in
    logical order."""
    from cs744_pytorch_distributed_tutorial_tpu_torch.parallel import pipeline as PP

    kw = dict(num_layers=8, num_virtual_stages=2) if schedule == "interleaved" else {}
    cfg = PP.PipelineLMConfig(**{**SMALL, **kw}, pipeline_parallel=S, schedule=schedule,
                              device="cpu")
    trs = [PP.PipelineLMTrainer(cfg, stage=i) for i in range(S)]
    params = trs[0].init_params(5)
    for tr in trs:
        tr.init(params=params)
    tokens = torch.tensor(np.random.default_rng(2).integers(0, V, (8, T)))
    got = PP.simulate_forward(trs, tokens)
    want = trs[0].reference_forward(params, tokens)
    np.testing.assert_allclose(got.numpy(), want.numpy(), rtol=1e-5, atol=1e-5)
    stored = PP.simulated_host_params(trs)
    for k, v in trs[0].blocks_to_logical(stored).items():
        np.testing.assert_array_equal(v.numpy(), params[k].numpy(), err_msg=k)


def test_config_fields_and_defaults_are_jax_s():
    import dataclasses

    from cs744_pytorch_distributed_tutorial_tpu.parallel import pipeline as JP
    from cs744_pytorch_distributed_tutorial_tpu_torch.parallel import pipeline as PP

    want = {f.name: f.default for f in dataclasses.fields(JP.PipelineLMConfig)}
    got = {f.name: f.default for f in dataclasses.fields(PP.PipelineLMConfig)}
    assert got.pop("device") == "cuda"
    assert got == want
