"""Process-group rendezvous: the reference's ``init_process``.

The reference starts Gloo with MASTER_ADDR/MASTER_PORT and a rank
(``master/part2a/part2a.py:80-85``). Here the address, world size and
rank are passed explicitly to ``dist.init_process_group``: NCCL when the
ranks run on cards, Gloo only when they run on the CPU. Each rank drives
one card, ``cuda:<rank mod visible cards>``.
"""

from __future__ import annotations

import math
import socket

import torch
import torch.distributed as dist


_LOOPBACK = ("localhost", "127.0.0.1", "::1")
_joined: dict[str, str] = {}  # the host of the last rendezvous this process joined


def free_port() -> int:
    """A TCP port free on every local address, for a rendezvous this host
    serves: the TCP store listens on all of them, so a port free only on
    the loopback (an outgoing connection may hold it on another address)
    fails its listen with EADDRINUSE."""
    with socket.socket(socket.AF_INET, socket.SOCK_STREAM) as s:
        s.bind(("", 0))
        return s.getsockname()[1]


def coordinator_host() -> str:
    """The address other ranks reach this host at, for a rendezvous it
    hosts: ``localhost`` when the last process group this process joined
    met on the loopback (one host), else this host's resolved address."""
    if _joined.get("host", "localhost") in _LOOPBACK:
        return "localhost"
    try:
        return socket.gethostbyname(socket.gethostname())
    except OSError:
        return socket.gethostname()


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
    _joined["host"] = url.split("://", 1)[1].rsplit(":", 1)[0].strip("[]")
    if device.type == "cuda":
        torch.cuda.set_device(device)
        backend = "nccl"
    else:
        backend = "gloo"
    dist.init_process_group(backend, init_method=url, world_size=world_size, rank=rank)


def initialize_from_env(device: torch.device) -> tuple[int, int]:
    """Join the process group that torchrun's environment describes
    (``MASTER_ADDR``, ``MASTER_PORT``, ``RANK``, ``WORLD_SIZE``, and
    ``LOCAL_RANK`` for the card): ``init_method="env://"``, the
    counterpart of the JAX package's ``jax.distributed.initialize()``
    with no arguments. A ``cuda`` device without an index becomes
    ``cuda:LOCAL_RANK``; NCCL for a card, Gloo for the CPU. Returns
    (world size, rank)."""
    import os

    if dist.is_initialized():
        raise RuntimeError("a torch.distributed process group is already initialized")
    missing = [k for k in ("MASTER_ADDR", "MASTER_PORT", "RANK", "WORLD_SIZE")
               if not os.environ.get(k)]
    if missing:
        raise ValueError(f"--distributed reads torchrun's environment; {missing} not set")
    if device.type == "cuda":
        if device.index is None:
            device = torch.device("cuda", int(os.environ.get("LOCAL_RANK", "0")))
        torch.cuda.set_device(device)
        backend = "nccl"
    else:
        backend = "gloo"
    _joined["host"] = os.environ["MASTER_ADDR"]
    dist.init_process_group(backend, init_method="env://")
    return dist.get_world_size(), dist.get_rank()


def shutdown() -> None:
    if dist.is_initialized():
        dist.destroy_process_group()


def world() -> tuple[int, int]:
    """(world size, rank) of the current process group, (1, 0) without one."""
    if dist.is_initialized():
        return dist.get_world_size(), dist.get_rank()
    return 1, 0


# ------------------------------------------------------------ the LM's mesh
DATA_AXIS, SEQ_AXIS, TENSOR_AXIS = "data", "seq", "tensor"
AXES = (DATA_AXIS, SEQ_AXIS, TENSOR_AXIS)


def mesh_coords(rank: int, sizes: dict[str, int]) -> dict[str, int]:
    """Rank ``rank``'s coordinates on a (data, seq, tensor) mesh of
    ``sizes``, data outermost: the position the JAX ``make_mesh`` gives
    device ``rank`` (its devices reshaped row-major to the axes' shape)."""
    coords = {}
    for axis in reversed(AXES):
        coords[axis] = rank % sizes[axis]
        rank //= sizes[axis]
    return {axis: coords[axis] for axis in AXES}


class Mesh:
    """The LM trainer's (data, seq, tensor) layout over the process group:
    the world is ``data * seq * tensor`` ranks and rank r sits at
    ``mesh_coords(r)``. Every line of ranks that differ only along a set
    of axes (every set, every line) gets its ``torch.distributed`` group,
    created by every rank in one order; a line of the whole world is the
    default group (``None``). Without a process group the mesh is one
    rank and its groups are never used."""

    _cache: dict = {}

    def __init__(self, data: int = 1, seq: int = 1, tensor: int = 1):
        self.sizes = {DATA_AXIS: data, SEQ_AXIS: seq, TENSOR_AXIS: tensor}
        n, self.rank = world()
        if data * seq * tensor != n:
            raise ValueError(f"mesh data={data} x seq={seq} x tensor={tensor} needs "
                             f"{data * seq * tensor} ranks, the process group has {n}")
        self.world_size = n
        self.coords = mesh_coords(self.rank, self.sizes)
        self._groups: dict[tuple[str, ...], object] = {}
        self._host_group = None
        if n == 1:
            return
        made: dict[tuple[int, ...], object] = {}
        for subset in _subsets():
            for line in self._lines(subset):
                if line not in made:
                    made[line] = None if len(line) == n else dist.new_group(list(line))
            self._groups[subset] = made[self.ranks(*subset)]

    @classmethod
    def get(cls, data: int = 1, seq: int = 1, tensor: int = 1) -> "Mesh":
        """The mesh of these sizes over the current process group, built
        once per group (its groups are collective to create); a new
        process group gets new meshes."""
        group = dist.group.WORLD if dist.is_initialized() else None
        cached = cls._cache.get((data, seq, tensor))
        if cached is None or cached[0] is not group:
            cached = cls._cache[(data, seq, tensor)] = (group, cls(data, seq, tensor))
        return cached[1]

    def _lines(self, subset: tuple[str, ...]):
        """Every line of ``subset``'s axes, as ascending tuples of ranks."""
        lines: dict[tuple, list[int]] = {}
        for r in range(self.world_size):
            c = mesh_coords(r, self.sizes)
            lines.setdefault(tuple(c[a] for a in AXES if a not in subset), []).append(r)
        return [tuple(v) for _, v in sorted(lines.items())]

    def size(self, *axes: str) -> int:
        return math.prod(self.sizes[a] for a in axes)

    def axis_index(self, axis: str) -> int:
        """This rank's coordinate on ``axis`` (JAX's ``lax.axis_index``)."""
        return self.coords[axis]

    def ranks(self, *axes: str) -> tuple[int, ...]:
        """The global ranks of this rank's line along ``axes``, ascending
        (row-major over those axes' coordinates)."""
        return tuple(r for r in range(self.world_size)
                     if all(mesh_coords(r, self.sizes)[a] == self.coords[a]
                            for a in AXES if a not in axes))

    def group(self, *axes: str):
        """The process group of this rank's line along ``axes`` (``None``,
        the default group, when that line is the world)."""
        return self._groups.get(_canonical(axes))

    def host_group(self):
        """The whole world's group for host (CPU) tensors: the default
        group, unless it is NCCL's (card tensors only); then a Gloo group
        over every rank, made at the first call (a collective: every rank
        makes that call at the same point, as the serving engine's
        constructor does)."""
        if self.world_size == 1 or dist.get_backend() != "nccl":
            return None
        if self._host_group is None:
            self._host_group = dist.new_group(backend="gloo")
        return self._host_group

    def peer(self, axis: str, shift: int) -> int:
        """The global rank ``shift`` steps along ``axis`` (cyclic)."""
        c = dict(self.coords)
        c[axis] = (c[axis] + shift) % self.sizes[axis]
        return self.rank_of(c)

    def rank_of(self, coords: dict[str, int]) -> int:
        r = 0
        for axis in AXES:
            r = r * self.sizes[axis] + coords[axis]
        return r


def spec_axes(spec) -> tuple[str, ...]:
    """The axes a parameter's spec (the axis name or None of each
    dimension) splits it over, each once."""
    return tuple(dict.fromkeys(a for a in spec if a is not None))


def _canonical(axes) -> tuple[str, ...]:
    return tuple(a for a in AXES if a in axes)


def _subsets():
    """Every non-empty set of AXES, in a fixed order."""
    return [tuple(a for i, a in enumerate(AXES) if mask >> i & 1) for mask in range(1, 8)]
