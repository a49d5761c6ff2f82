"""Process-group rendezvous: the reference's ``init_process``.

The reference starts Gloo with MASTER_ADDR/MASTER_PORT and a rank
(``master/part2a/part2a.py:80-85``). Here the address, world size and
rank are passed explicitly to ``dist.init_process_group``: NCCL when the
ranks run on cards, Gloo only when they run on the CPU. Each rank drives
one card, ``cuda:<rank mod visible cards>``.
"""

from __future__ import annotations

import socket

import torch
import torch.distributed as dist


def free_port() -> int:
    """A free TCP port on localhost, for single-host rendezvous."""
    with socket.socket(socket.AF_INET, socket.SOCK_STREAM) as s:
        s.bind(("localhost", 0))
        return s.getsockname()[1]


def rank_device(device: torch.device, rank: int) -> torch.device:
    """The device rank ``rank`` drives."""
    if device.type != "cuda":
        return device
    if device.index is not None:
        return device
    return torch.device("cuda", rank % torch.cuda.device_count())


def initialize(
    master_addr: str | None,
    world_size: int,
    rank: int,
    *,
    device: torch.device,
) -> None:
    """Join the process group. ``master_addr`` is ``host:port`` (or a
    ``tcp://`` URL); ``None`` is allowed for a world of one and picks a
    free localhost port."""
    if dist.is_initialized():
        raise RuntimeError("a torch.distributed process group is already initialized")
    if master_addr is None:
        if world_size != 1:
            raise ValueError(
                f"world size {world_size} needs a coordinator address "
                "(--coordinator host:port), one process per rank"
            )
        master_addr = f"localhost:{free_port()}"
    url = master_addr if "://" in master_addr else f"tcp://{master_addr}"
    if device.type == "cuda":
        torch.cuda.set_device(device)
        backend = "nccl"
    else:
        backend = "gloo"
    dist.init_process_group(backend, init_method=url, world_size=world_size, rank=rank)


def shutdown() -> None:
    if dist.is_initialized():
        dist.destroy_process_group()


def world() -> tuple[int, int]:
    """(world size, rank) of the current process group, (1, 0) without one."""
    if dist.is_initialized():
        return dist.get_world_size(), dist.get_rank()
    return 1, 0
