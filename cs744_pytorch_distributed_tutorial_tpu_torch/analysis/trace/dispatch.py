"""The recording dispatch mode shared by the trace and memory audits.

The port's twin of the JAX package's ``analysis/trace/jaxpr_utils.py``.
JAX audits the jaxpr its step traces to; the port runs eagerly, so it
records one REAL step as it runs: :class:`StepRecorder` is a
``TorchDispatchMode`` that sees every aten op and every c10d collective
(``c10d.allreduce_``, ``c10d._allgather_base_``, ``c10d.send``, ...)
the step dispatches, DDP's reducer and autograd's backward included. For
each op it records the op, the dtypes of its inputs, the dtypes, shapes
and bytes of its outputs, and the ids of the tensors it consumes and
produces (ids kept through weak references, so a later op's inputs name
their producer). It keeps live-storage accounting: a storage
first seen as an op's output is allocated then, and a finalizer on its
Python object (kept alive exactly as long as the C++ storage) frees it,
so autograd's saved tensors stay counted until backward releases them.

A ``ctypes`` kernel launch is invisible here (``ops/_cost.py``): the
buffers its wrapper allocates through torch are seen, its reads and
writes are not. Every wrapper reports each launch to ``_cost.add`` with
its operands, the tensors whose pointers the kernel was given, and the
recording marks exactly those as read by a kernel (``kernel_reads``).

Collectives map to JAX's classes (``jaxpr_utils.COLLECTIVE_CLASS``)::

    c10d op                                     class          wire bytes a rank
    allreduce_, allreduce_coalesced_            psum           2(n-1)/n x payload
    _allgather_base_, allgather_,
      allgather_into_tensor_coalesced_          all_gather     (n-1) x payload
    _reduce_scatter_base_, reduce_scatter_,
      reduce_scatter_tensor_coalesced_          reduce_scatter (n-1)/n x payload
    alltoall_base_, alltoall_                   all_to_all     (n-1)/n x payload
    gather_ (to a root)                         all_gather     (n-1) x payload
    scatter_ (from the root of the gather_
      just before it)                           (its second leg: not counted)
    send, recv_, recv_any_source_               ppermute       see below
    broadcast_                                  broadcast      (n-1)/n x payload
    reduce_                                     reduce         (n-1)/n x payload

The payload is the op's input: the local shard for an all-gather, the
full buffer for a reduce-scatter, all-to-all or all-reduce, as JAX's
``aval_bytes`` of the eqn's inputs. A rooted ``gather_`` + ``scatter_``
(``collectives.gather_scatter_mean``) is one all_gather: in JAX every
device receives the n-1 other payloads and means them locally; here the
root receives them, means them and scatters the mean back as the op's
second leg. A scalar payload or a group of one is trivial, as in JAX.

Point-to-point traffic is counted by HOP ROUNDS, one mapping for every
strategy: a rank's round is one ``batch_isend_irecv`` call or one lone
``isend``/``irecv``/``send``/``recv``, and it counts as many ppermutes as
the tensors the rank sends or receives in it (the larger of the two). A
step's ppermute count is the largest such sum over the ranks, and its
wire bytes the mean over the ranks of the bytes each sends (JAX prices a
ppermute of ``len(perm)`` edges at ``len(perm)/n`` x payload a device,
which summed is exactly that mean). So the ring (every rank in every
hop), the star (rank 0 in every hop) and the int8 ring (codes and scales,
two tensors a hop) count as JAX's 2(n-1), 2(n-1) and 4(n-1) a unit.
"""

from __future__ import annotations

import contextlib
import dataclasses
import math
import traceback
import weakref
from typing import Iterator

import torch
import torch.distributed as dist
from torch.utils import _pytree as pytree
from torch.utils._python_dispatch import TorchDispatchMode
from torch.utils.weak import WeakIdKeyDictionary

#: c10d op name (``c10d.<name>.default``) -> JAX's canonical class
COLLECTIVE_CLASS = {
    "allreduce_": "psum",
    "allreduce_coalesced_": "psum",
    "_allgather_base_": "all_gather",
    "allgather_": "all_gather",
    "allgather_into_tensor_coalesced_": "all_gather",
    "_reduce_scatter_base_": "reduce_scatter",
    "reduce_scatter_": "reduce_scatter",
    "reduce_scatter_tensor_coalesced_": "reduce_scatter",
    "alltoall_base_": "all_to_all",
    "alltoall_": "all_to_all",
    "gather_": "all_gather",
    "scatter_": "scatter",
    "send": "ppermute",
    "recv_": "ppermute",
    "recv_any_source_": "ppermute",
    "broadcast_": "broadcast",
    "reduce_": "reduce",
    "barrier": "barrier",
}

#: The index of the argument holding each c10d op's payload (its input).
_PAYLOAD_ARG = {
    "_allgather_base_": 1,
    "allgather_": 1,
    "allgather_into_tensor_coalesced_": 1,
    "_reduce_scatter_base_": 1,
    "reduce_scatter_": 1,
    "reduce_scatter_tensor_coalesced_": 1,
    "alltoall_base_": 1,
    "alltoall_": 1,
    "gather_": 1,
    "scatter_": 0,  # each rank's received part
}

#: The JAX package's matmul primitives' eager twins (TA001, TA005).
MATMUL_OPS = {
    "mm", "addmm", "bmm", "baddbmm", "matmul", "convolution", "_convolution",
    "convolution_backward", "cudnn_convolution", "linear", "addbmm",
    "_scaled_dot_product_flash_attention", "_scaled_dot_product_efficient_attention",
    "_scaled_dot_product_cudnn_attention", "_scaled_mm", "_grouped_mm",
}

_P2P = {"send", "recv_", "recv_any_source_"}

#: Outputs of matmuls and of ops materializing at least this many bytes
#: are watched (weakly) to tell whether anything kept them (TA005).
KEEP_MIN_BYTES = 2**20


def _short(func) -> str:
    """``aten.mm.default`` -> ``mm``; ``c10d.allreduce_.default`` -> ``allreduce_``."""
    return func._schema.name.split("::", 1)[-1]


def tensor_bytes(t: torch.Tensor) -> int:
    return t.numel() * t.element_size()


@dataclasses.dataclass(frozen=True)
class Collective:
    """One c10d collective as this rank issued it."""

    op: str  # c10d op name
    cls: str | None  # JAX class; None for a gather's scatter leg
    group_size: int
    payload_bytes: int
    payload_elems: int
    peer: int | None = None  # point-to-point only
    send: bool = False
    round: int | None = None  # point-to-point: the hop round

    @property
    def trivial(self) -> bool:
        """Scalar-payload or group-of-one collectives: loss means,
        telemetry norms, a world of one — excluded from schedule counts,
        as in JAX."""
        return self.payload_elems <= 1 or self.group_size <= 1

    @property
    def wire_bytes(self) -> float:
        """Bytes this rank's op puts on the wire by JAX's per-device
        formulas (point-to-point: what this rank sends)."""
        n = self.group_size
        if n <= 1 or self.cls is None:
            return 0.0
        if self.cls == "psum":
            return 2.0 * (n - 1) / n * self.payload_bytes
        if self.cls == "all_gather":
            return float(n - 1) * self.payload_bytes
        if self.cls in ("reduce_scatter", "all_to_all", "broadcast", "reduce"):
            return (n - 1) / n * self.payload_bytes
        if self.cls == "ppermute":
            return float(self.payload_bytes) if self.send else 0.0
        return 0.0


@dataclasses.dataclass
class OpRecord:
    """One dispatched op."""

    index: int
    name: str
    inputs: list[int]  # tensor ids
    outputs: list[int]
    in_dtypes: list[torch.dtype]
    out_dtypes: list[torch.dtype]
    out_shapes: list[tuple[int, ...]]
    out_bytes: int
    new_bytes: int  # bytes of the storages this op allocated (0 for a view)
    mutates: bool
    collective: Collective | None = None
    upcast_input: bool = False  # an input derived from a bf16 value
    frames: list[tuple[str, str, int]] = dataclasses.field(default_factory=list)


class StepRecorder(TorchDispatchMode):
    """Record every op of the code run under it (``with StepRecorder(args)
    as rec: step()``). ``args`` are the tensors alive before the step
    (its state and inputs): their storages are the argument set and are
    never counted as allocated."""

    def __init__(self, args: Iterator[torch.Tensor] = ()) -> None:
        super().__init__()
        self.ops: list[OpRecord] = []
        self._ids: WeakIdKeyDictionary = WeakIdKeyDictionary()
        self._next_id = 0
        self.kept_refs: dict[int, weakref.ref] = {}  # expensive outputs, watched
        self._upcast: set[int] = set()  # tensor ids derived from bf16 values
        self.arg_storages: dict[int, int] = {}  # id(storage) -> bytes
        self._arg_keepalive = []  # the storages' Python objects, so their ids stay theirs
        for t in args:
            st = t.untyped_storage()
            self.arg_storages.setdefault(id(st), st.nbytes())
            self._arg_keepalive.append(st)
        self._live: dict[int, int] = {}  # id(storage) -> bytes, allocated in the step
        self.kernel_reads: set[int] = set()  # a hand-written kernel's operands
        self.live_bytes = 0
        self.peak_bytes = 0
        self._round = 0
        self._batch: int | None = None
        self._last_rooted: tuple[int, int] | None = None  # (root, group size) of a gather_

    # ------------------------------------------------------------ ids
    def tensor_id(self, t: torch.Tensor) -> int:
        tid = self._ids.get(t)
        if tid is None:
            tid = self._next_id
            self._next_id += 1
            self._ids[t] = tid
        return tid

    def known_id(self, t: torch.Tensor) -> int | None:
        return self._ids.get(t)

    # ------------------------------------------------------------ storages
    def _free(self, key: int) -> None:
        nbytes = self._live.pop(key, None)
        if nbytes is not None:
            self.live_bytes -= nbytes

    def _track(self, t: torch.Tensor) -> int:
        """Count ``t``'s storage as allocated now if it is new; returns
        its bytes then, else 0."""
        if t.device.type == "meta":
            return 0
        try:
            st = t.untyped_storage()
        except (RuntimeError, NotImplementedError):
            return 0
        key = id(st)
        if key in self.arg_storages or key in self._live:
            return 0
        nbytes = st.nbytes()
        if nbytes == 0:
            return 0
        self._live[key] = nbytes
        self.live_bytes += nbytes
        self.peak_bytes = max(self.peak_bytes, self.live_bytes)
        weakref.finalize(st, self._free, key)
        return nbytes

    def kernel_launched(self, operands) -> None:
        """A hand-written kernel launched on ``operands``: each counts as
        read (a tensor the recording never saw has nothing to mark)."""
        for t in operands:
            tid = self.known_id(t)
            if tid is not None:
                self.kernel_reads.add(tid)

    # ------------------------------------------------------------ p2p rounds
    @contextlib.contextmanager
    def p2p_batch(self):
        """Mark the point-to-point ops posted inside as one hop round."""
        self._round += 1
        outer, self._batch = self._batch, self._round
        try:
            yield
        finally:
            self._batch = outer

    # ------------------------------------------------------------ dispatch
    def _collective(self, name: str, args: tuple) -> Collective:
        pg_obj = next((a for a in args if type(a).__name__ == "ScriptObject"), None)
        try:
            group = dist.ProcessGroup.unbox(pg_obj).size() if pg_obj is not None else 1
        except (RuntimeError, AttributeError):
            group = dist.get_world_size() if dist.is_initialized() else 1
        src = args[_PAYLOAD_ARG.get(name, 0)]
        leaves = [t for t in pytree.tree_leaves(src) if isinstance(t, torch.Tensor)]
        payload = sum(tensor_bytes(t) for t in leaves)
        elems = sum(t.numel() for t in leaves)
        cls = COLLECTIVE_CLASS.get(name, name)
        if name in _P2P:
            if self._batch is None:
                self._round += 1
            rnd = self._batch if self._batch is not None else self._round
            return Collective(name, cls, group, payload, elems, peer=int(args[2]),
                              send=name == "send", round=rnd)
        if name == "gather_":
            self._last_rooted = (int(args[3]), group)
        elif name == "scatter_":
            if self._last_rooted == (int(args[3]), group):
                cls = None  # the rooted all_gather's second leg
            self._last_rooted = None
        return Collective(name, cls, group, payload, elems)

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        name = _short(func)
        namespace = func._schema.name.split("::", 1)[0]
        coll = self._collective(name, args) if namespace == "c10d" else None
        in_tensors = [t for t in pytree.tree_leaves((args, kwargs)) if isinstance(t, torch.Tensor)]
        in_ids = [self.tensor_id(t) for t in in_tensors]
        upcast = any(t.dtype == torch.bfloat16 or i in self._upcast
                     for t, i in zip(in_tensors, in_ids))
        out = func(*args, **kwargs)
        out_tensors = [t for t in pytree.tree_leaves(out) if isinstance(t, torch.Tensor)]
        mutates = func._schema.is_mutable or namespace == "c10d"
        rec = OpRecord(
            index=len(self.ops), name=name, inputs=in_ids, outputs=[],
            in_dtypes=[t.dtype for t in in_tensors],
            out_dtypes=[t.dtype for t in out_tensors],
            out_shapes=[tuple(t.shape) for t in out_tensors],
            out_bytes=sum(tensor_bytes(t) for t in out_tensors), new_bytes=0,
            mutates=mutates, collective=coll, upcast_input=upcast,
        )
        for t in out_tensors:
            tid = self.tensor_id(t)
            rec.outputs.append(tid)
            if upcast:
                self._upcast.add(tid)
            if name in MATMUL_OPS or rec.out_bytes >= KEEP_MIN_BYTES:
                self.kept_refs[tid] = weakref.ref(t)
            rec.new_bytes += self._track(t)
        if (upcast and name in MATMUL_OPS
                and any(d == torch.float32 for d in rec.out_dtypes)):
            rec.frames = user_frames()
        self.ops.append(rec)
        return out

    # ------------------------------------------------------------ queries
    def collectives(self) -> list[Collective]:
        return [op.collective for op in self.ops if op.collective is not None]


def user_frames(limit: int = 6) -> list[tuple[str, str, int]]:
    """The calling Python frames outside torch and this module,
    innermost last: ``(file, function, line)``."""
    out = []
    for fr in traceback.extract_stack()[:-2]:
        f = fr.filename
        if "site-packages" in f or "/torch/" in f or f.startswith("<") or f.endswith("dispatch.py"):
            continue
        out.append((f, fr.name, int(fr.lineno or 0)))
    return out[-limit:]


@contextlib.contextmanager
def recording(args: Iterator[torch.Tensor] = ()) -> Iterator[StepRecorder]:
    """Run a block under a :class:`StepRecorder`, ``batch_isend_irecv``
    marked as hop rounds and each hand-written kernel's launch (its
    ``_cost.add`` report) as a read of the operands it names."""
    from cs744_pytorch_distributed_tutorial_tpu_torch.ops import _cost

    rec = StepRecorder(args)
    inner, report = dist.batch_isend_irecv, _cost.add

    def batched(p2p_op_list):
        with rec.p2p_batch():
            return inner(p2p_op_list)

    def launched(flops: float, nbytes: float, operands=()) -> None:
        rec.kernel_launched(operands)
        report(flops, nbytes, operands)

    dist.batch_isend_irecv, _cost.add = batched, launched
    try:
        with rec:
            yield rec
    finally:
        dist.batch_isend_irecv, _cost.add = inner, report


# ------------------------------------------------------------ schedules
def schedule_counts(collectives: list[Collective]) -> dict[str, int]:
    """This rank's non-trivial collective counts by JAX class; the
    point-to-point ops as ppermutes by hop round (see the module
    docstring)."""
    counts: dict[str, int] = {}
    rounds: dict[int, list[int]] = {}
    for c in collectives:
        if c.trivial or c.cls is None:
            continue
        if c.cls == "ppermute":
            sends_recvs = rounds.setdefault(c.round, [0, 0])
            sends_recvs[0 if c.send else 1] += 1
            continue
        counts[c.cls] = counts.get(c.cls, 0) + 1
    hops = sum(max(s, r) for s, r in rounds.values())
    if hops:
        counts["ppermute"] = hops
    return counts


def wire_split(collectives: list[Collective]) -> tuple[float, float]:
    """(this rank's non-trivial collective wire bytes less point-to-point,
    the bytes it sends point-to-point)."""
    coll = sum(c.wire_bytes for c in collectives if not c.trivial and c.cls != "ppermute")
    p2p = sum(c.wire_bytes for c in collectives if not c.trivial and c.cls == "ppermute")
    return coll, p2p


def combine_ranks(per_rank: list[tuple[dict[str, int], float, float]]
                  ) -> tuple[dict[str, int], float]:
    """Every rank's ``(schedule_counts, collective wire, p2p sent)`` ->
    the step's schedule and per-device wire bytes: the collectives as
    rank 0 issued them (TA006 checks that the ranks agree), the ppermutes
    the largest count over the ranks, the point-to-point bytes the mean
    over the ranks of what each sends."""
    counts = {k: v for k, v in per_rank[0][0].items() if k != "ppermute"}
    hops = max((c.get("ppermute", 0) for c, _, _ in per_rank), default=0)
    if hops:
        counts["ppermute"] = hops
    wire = per_rank[0][1] + sum(p for _, _, p in per_rank) / len(per_rank)
    return dict(sorted(counts.items())), wire


def collective_sequence(collectives: list[Collective]) -> list[tuple]:
    """The order-sensitive sequence of this rank's group collectives
    (point-to-point aside; every rank of a group must issue the same):
    ``(class, group size, payload elements)``, scalars included, groups
    of one excluded (TA006 counts a scalar psum in one branch)."""
    return [(c.cls or c.op, c.group_size, c.payload_elems) for c in collectives
            if c.group_size > 1 and c.cls != "ppermute"]


def schedule_counts_of(sequence: list[tuple]) -> dict[str, int]:
    """Class counts of a ``collective_sequence``."""
    counts: dict[str, int] = {}
    for cls, _, _ in sequence:
        counts[cls] = counts.get(cls, 0) + 1
    return dict(sorted(counts.items()))


def p2p_edges(collectives: list[Collective]) -> dict[tuple[str, int], list[int]]:
    """This rank's point-to-point traffic by (direction, peer): the
    payload bytes of each message in order."""
    out: dict[tuple[str, int], list[int]] = {}
    for c in collectives:
        if c.cls == "ppermute" and c.group_size > 1:
            out.setdefault(("send" if c.send else "recv", c.peer), []).append(c.payload_bytes)
    return out


def nbytes_of(tensors) -> int:
    """Bytes of the distinct storages of ``tensors``."""
    seen: dict[int, int] = {}
    for t in tensors:
        st = t.untyped_storage()
        seen.setdefault(id(st), st.nbytes())
    return sum(seen.values())


def leaf_bytes(shape, dtype: torch.dtype) -> int:
    return int(math.prod(shape)) * torch.empty((), dtype=dtype).element_size()


__all__ = [
    "COLLECTIVE_CLASS",
    "Collective",
    "MATMUL_OPS",
    "OpRecord",
    "StepRecorder",
    "collective_sequence",
    "combine_ranks",
    "leaf_bytes",
    "nbytes_of",
    "p2p_edges",
    "recording",
    "schedule_counts",
    "schedule_counts_of",
    "tensor_bytes",
    "user_frames",
    "wire_split",
]

