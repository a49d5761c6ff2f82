"""Re-mesh on failure: rebuild the world from the surviving ranks.

A port of the JAX package's ``parallel/elastic.py``. The reference hard
codes its world as ``[0, 1, 2, 3]`` (``master/part2a/part2a.py:32``): lose
a rank and the job is dead. Here a device loss shrinks the DATA axis.
In the port one rank drives one device, so losing a device means losing
a rank: ``surviving_mesh`` plans the world over the ranks still alive,
and ``default_remesh`` re-forms the process group over them and builds
a replacement trainer on it, carrying the in-memory snapshot tier
(``utils/memstore.py``) across, so the next ``fit`` restores with no
file read.

The restore onto the smaller world is the trainers' ``elastic_state``
(the JAX package's ``adapt_and_place`` rules): replicated tensors from
any rank, per-replica state sliced, the zero1/fsdp rows re-chunked
through ``parallel/zero.py::make_elastic_adapt``. The data offset is a
function of the step (the loaders' order is a function of seed and
epoch, the LM's batch plan of the step), so the resumed run consumes
exactly the batches the interrupted one never applied.

Only the data axis is elastic: seq and tensor parallelism fix the
per-shard program, so losing a rank from those axes needs a topology
decision the operator must make; this raises instead of guessing.

The process group cannot shrink without every rank taking part (the
survivors agree on the new rendezvous over the old group before it is
destroyed). So this path serves an injected or announced loss, where
every rank is alive to agree: each rank named in ``lost`` leaves the run
(``RankRetired``), the others re-form. A rank that really died is the
supervisor's case (``parallel/multihost.py::launch_local``).
"""

from __future__ import annotations

import math
from typing import Any, Iterable, Mapping

import torch
import torch.distributed as dist

from cs744_pytorch_distributed_tutorial_tpu_torch.parallel import mesh as M
from cs744_pytorch_distributed_tutorial_tpu_torch.parallel.mesh import DATA_AXIS
from cs744_pytorch_distributed_tutorial_tpu_torch.utils.logging import get_logger


class RankRetired(SystemExit):
    """Raised on a rank that a re-mesh left out of the new world: it has
    left the process group. A ``SystemExit`` with code 0, so a worker
    that does not catch it ends cleanly."""

    def __init__(self, rank: int):
        super().__init__(0)
        self.rank = rank


def surviving_mesh(sizes: Mapping[str, int], lost: Iterable[int] = ()
                   ) -> tuple[list[int], dict[str, int]]:
    """The world over the ranks of a mesh of ``sizes`` (axis -> size, data
    outermost, ``parallel/mesh.py``'s rank order) whose ranks are not in
    ``lost``: the surviving global ranks in ascending order (their new
    ranks, the lowest the coordinator) and the axis sizes with the DATA
    axis shrunk to fit. The other axes keep their extent (their product
    must divide the survivor count, or this raises): shrinking seq or
    tensor would change the per-shard program, not just the batch
    layout."""
    sizes = dict(sizes)
    n = math.prod(sizes.values())
    lost_ids = {int(i) for i in lost}
    survivors = [r for r in range(n) if r not in lost_ids]
    if not survivors:
        raise ValueError(f"no devices survive (lost {sorted(lost_ids)})")
    if DATA_AXIS not in sizes:
        raise ValueError(f"mesh has no {DATA_AXIS!r} axis to shrink (axes {list(sizes)})")
    other = math.prod(s for name, s in sizes.items() if name != DATA_AXIS)
    new_data = len(survivors) // other
    if new_data < 1 or len(survivors) % other:
        raise ValueError(
            f"{len(survivors)} surviving devices cannot fill the non-data "
            f"axes (need a multiple of {other}); shrink seq/tensor "
            "parallelism explicitly"
        )
    sizes[DATA_AXIS] = new_data
    return survivors, sizes


def regroup(survivors: list[int]) -> int:
    """Re-form the process group over ``survivors`` (global ranks of the
    current group, ascending): every rank of the current group calls this.
    The lowest survivor hosts the new rendezvous at a free port and tells
    the others over the old group; the old group is destroyed; a rank not
    among the survivors raises ``RankRetired``, the others join the new
    group on their device. Returns this rank's new rank."""
    from cs744_pytorch_distributed_tutorial_tpu_torch.parallel.multihost import (
        runtime_labels,
        set_runtime_labels,
    )

    me = dist.get_rank()
    device = (torch.device("cuda", torch.cuda.current_device())
              if dist.get_backend() == "nccl" else torch.device("cpu"))
    address = [None]
    if me == survivors[0]:
        host = M.coordinator_host()
        address[0] = f"{host}:{M.free_port()}"
    dist.broadcast_object_list(address, src=survivors[0])
    labels = runtime_labels()
    dist.destroy_process_group()
    if me not in survivors:
        raise RankRetired(me)
    new_rank = survivors.index(me)
    M.initialize(address[0], len(survivors), new_rank, device=device)
    set_runtime_labels(process_id=new_rank, process_count=len(survivors),
                       generation=labels["generation"], global_rank=labels["global_rank"])
    return new_rank


def default_remesh(trainer: Any, failure: Any) -> Any:
    """Build a replacement trainer on the surviving world: the ``remesh``
    hook for ``run_with_recovery``, called on every rank.

    ``failure.lost`` names the lost global ranks (empty: nothing is known
    lost, and the trainer is rebuilt on the same world). The new trainer
    keeps the old config except for the world-size field
    (``num_devices`` / ``data_parallel``) and inherits the old trainer's
    ``memstore``, so the first ``fit`` on the new world restores the
    newest in-memory snapshot, re-cut, with no file read. A rank in
    ``lost`` raises ``RankRetired`` once it has left the group."""
    from cs744_pytorch_distributed_tutorial_tpu_torch.train.engine import Trainer
    from cs744_pytorch_distributed_tutorial_tpu_torch.train.lm import LMTrainer

    log = get_logger()
    if isinstance(trainer, LMTrainer):
        sizes = trainer.mesh.sizes
    elif isinstance(trainer, Trainer):
        sizes = {DATA_AXIS: trainer.world_size}
    else:
        raise TypeError(
            f"default_remesh does not know how to rebuild {type(trainer).__name__}; "
            "pass a custom remesh hook to run_with_recovery"
        )
    lost = tuple(getattr(failure, "lost", ()) or ())
    survivors, new_sizes = surviving_mesh(sizes, lost)
    old_world = math.prod(sizes.values())
    log.warning("re-meshing %d -> %d devices (lost %s)", old_world, len(survivors), list(lost))
    if len(survivors) < old_world:
        regroup(survivors)
    memstore = getattr(trainer, "memstore", None)
    if isinstance(trainer, LMTrainer):
        cfg = trainer.cfg.replace(data_parallel=new_sizes[DATA_AXIS])
        return LMTrainer(cfg, memstore=memstore)
    cfg = trainer.cfg.replace(num_devices=len(survivors))
    return Trainer(cfg, memstore=memstore)
