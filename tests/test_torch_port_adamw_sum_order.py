"""AdamW on 4 ranks: the port's update rules fed JAX's own world-mean
gradients give JAX's parameters, every element.

The JAX ``LMTrainer`` (pure data parallelism, AdamW) runs 4 steps of the
tiny LM of ``tests/test_torch_port_zero_lm.py`` on 4 host devices with its
optimizer wrapped to keep the gradient it was given (the ``pmean`` of the
4 devices' gradients, bit for bit what its update read). From the same
initial parameters the port's rules take those gradients:

- ``train/state.py::Optimizer`` (the replicated AdamW, optax's order)
  against the JAX trainer's parameters after every step;
- ``parallel/zero.py::Zero1Adam``'s rule on rows (a world of one: a row
  is the whole flat tensor) against the JAX ``Zero1Adam`` chunk rule fed
  the same gradients.

Both within rtol 1e-5, atol 1e-6 for every element. With each
framework's own 4-rank gradient one element of ``blocks.0.mlp_out.weight``
lands 2.48e-6 from JAX's (``test_torch_port_zero_lm.py``,
``..._lm_dp4.py``): its step-0 gradient nearly cancels across the ranks
(-9.17e-8 in JAX, -8.92e-8 from Gloo's sum), and Adam's first step
divides it by its own magnitude plus eps. The rule is not the cause; the
four-rank sum order is (``ROADMAP.md`` C).
"""

import numpy as np
import pytest
import torch

WORLD, STEPS, BATCH, T, V = 4, 4, 8, 16, 64
SMALL = dict(vocab_size=V, num_layers=2, num_heads=4, d_model=32, d_ff=64, max_seq_len=T,
             seq_len=T, global_batch_size=BATCH, use_rope=True, learning_rate=1e-3,
             attention_impl="dense", data_parallel=WORLD)
TOL = dict(rtol=1e-5, atol=1e-6)


@pytest.fixture(scope="module")
def jax_run():
    """(the parameters before each step and after the last, and each
    step's world-mean gradient), as port ``state_dict``s."""
    import jax
    import jax.numpy as jnp
    import optax
    from jax.sharding import PartitionSpec as P

    from cs744_pytorch_distributed_tutorial_tpu.parallel import make_mesh
    from cs744_pytorch_distributed_tutorial_tpu.train import LMConfig as JaxConfig
    from cs744_pytorch_distributed_tutorial_tpu.train import LMTrainer as JaxTrainer
    from cs744_pytorch_distributed_tutorial_tpu.train.state import make_optimizer
    from cs744_pytorch_distributed_tutorial_tpu_torch.data import synthetic_tokens
    from cs744_pytorch_distributed_tutorial_tpu_torch.models.convert import lm_params_from_jax

    cfg = JaxConfig(**SMALL)
    jt = JaxTrainer(cfg, mesh=make_mesh({"data": WORLD, "seq": 1}, devices=jax.devices()[:WORLD]))
    inner = make_optimizer(cfg)

    def init(params):
        return inner.init(params), jax.tree.map(jnp.zeros_like, params)

    def update(grads, state, params=None):
        updates, inner_state = inner.update(grads, state[0], params)
        return updates, (inner_state, grads)

    jt.tx = optax.GradientTransformation(init, update)
    shapes = jax.eval_shape(lambda: jt._init_model().init(
        jax.random.key(0), jnp.zeros(jt._local_batch_shape(), jnp.int32))["params"])
    jt.opt_specs = optax.tree_map_params(jt.tx, lambda _, spec: spec,
                                         jax.eval_shape(jt.tx.init, shapes), jt.param_specs,
                                         transform_non_params=lambda _: P())
    jt._build_steps()
    toks = synthetic_tokens(STEPS * BATCH, T, V, seed=1)
    params, opt = jt.init()
    traj, grads = [lm_params_from_jax(jax.device_get(params))], []
    for s in range(STEPS):
        batch = jt.shard_batch(toks[s * BATCH:(s + 1) * BATCH])
        params, opt, _ = jt.train_step(params, opt, *batch, s)
        traj.append(lm_params_from_jax(jax.device_get(params)))
        grads.append(lm_params_from_jax(jax.device_get(opt[1])))
    return traj, grads


def _assert_close(got: dict, want: dict, what: str) -> None:
    for name, value in want.items():
        np.testing.assert_allclose(got[name].numpy(), value.numpy(), **TOL,
                                   err_msg=f"{what} {name}")


def test_replicated_adamw_fed_jax_gradients_gives_jax_parameters(jax_run):
    from cs744_pytorch_distributed_tutorial_tpu_torch.train.state import Optimizer

    traj, grads = jax_run
    names = list(traj[0])
    params = [traj[0][n].clone() for n in names]
    tx = Optimizer("adamw", lambda count: SMALL["learning_rate"], 0.9, 1e-4)
    momentum = tx.init(params)
    for s in range(STEPS):
        tx.apply(params, momentum, [grads[s][n] for n in names])
        _assert_close(dict(zip(names, params)), traj[s + 1], f"step {s}")


def test_zero1_adamw_rule_fed_jax_gradients_gives_the_jax_rule_s_parameters(jax_run):
    import jax.numpy as jnp

    from cs744_pytorch_distributed_tutorial_tpu.parallel.zero import Zero1Adam as JaxZero1Adam
    from cs744_pytorch_distributed_tutorial_tpu_torch.parallel.zero import Zero1Adam

    traj, grads = jax_run
    names = list(traj[0])
    lr = SMALL["learning_rate"]
    rows = [traj[0][n].reshape(-1).clone() for n in names]
    rule = Zero1Adam(rows, lambda count: lr, 0.9, 1e-4, 1)
    jrule = JaxZero1Adam(lr, b1=0.9, b2=0.999, eps=1e-8, weight_decay=1e-4, axis_name="data",
                         axis_size=1)
    jp = [jnp.asarray(np.array(r.numpy())) for r in rows]  # copies: rows move in place
    jmu = [jnp.zeros_like(p) for p in jp]
    jnu = [jnp.zeros_like(p) for p in jp]
    jstate = {"count": jnp.zeros((), jnp.int32)}
    for s in range(STEPS):
        g = [grads[s][n].reshape(-1) for n in names]
        scalars = rule.step_scalars()
        torch._foreach_add_(rows, rule._deltas(rows, range(len(rows)), g, scalars))
        rule.count += 1
        count, jlr, c1, c2 = jrule._step_scalars(jstate)
        jstate["count"] = count
        for i, gi in enumerate(g):
            gj = jnp.asarray(np.array(gi.numpy()))
            jmu[i], jnu[i], upd = jrule._adamw_chunk_update(jp[i], jmu[i], jnu[i], gj, c1, c2)
            jp[i] = jp[i] - jlr * upd
        _assert_close({n: r for n, r in zip(names, rows)},
                      {n: torch.from_numpy(np.array(p)) for n, p in zip(names, jp)},
                      f"step {s}")
        # and both stay on the JAX trainer's (optax) trajectory
        _assert_close({n: r.view(traj[s + 1][n].shape) for n, r in zip(names, rows)},
                      traj[s + 1], f"step {s} vs the trainer")
