"""The port's Trainer against the JAX package's Trainer.

tiny_cnn, part-1 semantics (sync none, one replica), the fused optimizer
(the Pallas kernel in interpret mode on the JAX side, the kernel's plain
version on the port's CPU path), augmentation off, lr 0.02, batch 16,
5 steps, from the same carried initialization and the same batches.
Per-step losses agree at rtol 1e-4 and the final parameters at rtol
1e-4, atol 1e-5 (convolution sums in another order, compounding over
five updates).
"""

import jax
import numpy as np
import torch

from cs744_pytorch_distributed_tutorial_tpu.config import TrainConfig as JaxConfig
from cs744_pytorch_distributed_tutorial_tpu.data import synthetic_cifar10 as jax_synthetic
from cs744_pytorch_distributed_tutorial_tpu.parallel import make_mesh
from cs744_pytorch_distributed_tutorial_tpu.parallel.mesh import shard_global_batch
from cs744_pytorch_distributed_tutorial_tpu.train import Trainer as JaxTrainer
from cs744_pytorch_distributed_tutorial_tpu_torch.config import TrainConfig
from cs744_pytorch_distributed_tutorial_tpu_torch.models.convert import (
    jax_from_state_dict,
    state_dict_from_jax,
)
from cs744_pytorch_distributed_tutorial_tpu_torch.train import Trainer

STEPS, BATCH, LR = 5, 16, 0.02
COMMON = dict(
    model="tiny_cnn", sync="none", num_devices=1, global_batch_size=BATCH,
    synthetic_data=True, augment=False, learning_rate=LR, fused_optimizer=True,
)


def _leaves(tree, prefix=""):
    for k in sorted(tree):
        if isinstance(tree[k], dict):
            yield from _leaves(tree[k], f"{prefix}{k}/")
        else:
            yield f"{prefix}{k}", np.asarray(tree[k])


def test_trainer_trajectory_matches_jax():
    ds = jax_synthetic(STEPS * BATCH, 8, seed=0)

    mesh1 = make_mesh({"data": 1}, devices=jax.devices()[:1])
    jtr = JaxTrainer(JaxConfig(**COMMON), mesh=mesh1)
    state = jtr.init()
    init = {
        "params": jax.tree.map(np.asarray, state.params),
        "batch_stats": jax.tree.map(lambda a: np.asarray(a)[0], state.batch_stats),
    }
    key = jax.random.key(0)
    jax_losses = []
    for s in range(STEPS):
        xb, yb = shard_global_batch(
            mesh1,
            ds.train_images[s * BATCH : (s + 1) * BATCH],
            ds.train_labels[s * BATCH : (s + 1) * BATCH],
        )
        state, metrics = jtr.train_step(state, xb, yb, key)
        jax_losses.append(float(metrics["loss"]))

    tr = Trainer(TrainConfig(**COMMON, device="cpu"))
    tr.model.load_state_dict(state_dict_from_jax(init, "tiny_cnn"))
    losses = []
    for s in range(STEPS):
        x = torch.from_numpy(ds.train_images[s * BATCH : (s + 1) * BATCH])
        y = torch.from_numpy(ds.train_labels[s * BATCH : (s + 1) * BATCH].astype(np.int64))
        losses.append(float(tr.train_step(x, y)))
    assert tr.state.step == STEPS

    np.testing.assert_allclose(losses, jax_losses, rtol=1e-4)
    got = jax_from_state_dict(tr.model.state_dict(), "tiny_cnn")["params"]
    want = jax.tree.map(np.asarray, state.params)
    for (name, a), (_, b) in zip(_leaves(got), _leaves(want), strict=True):
        np.testing.assert_allclose(a, b, rtol=1e-4, atol=1e-5, err_msg=name)


def test_fit_learns_on_cpu():
    """fit(): history keys as the JAX engine's, the loss falls, and the
    timing window fills once more than 10 batches ran."""
    cfg = TrainConfig(
        model="tiny_cnn", sync="none", num_devices=1, global_batch_size=32,
        synthetic_data=True, synthetic_train_size=32 * 12, synthetic_test_size=64,
        learning_rate=0.02, epochs=2, log_every=4, device="cpu",
    )
    state, hist = Trainer(cfg).fit()
    assert set(hist) == {"train_loss", "eval", "avg_batch_time"}
    assert state.step == 24
    losses = [loss for (_, _, loss) in hist["train_loss"]]
    assert losses[-1] < losses[0]
    assert hist["avg_batch_time"] is not None and hist["avg_batch_time"] > 0
    assert hist["eval"][-1]["count"] == 64
