"""A rank's cost of a traced step, counted over the aten ops it dispatches:
the counterpart of ``src/repro/launch/hlo_cost.py``, which walks XLA's
compiled HLO.

Torch has no compiled module to walk and no scan: a step runs op by op, a
Python loop over L layers dispatches each layer's ops L times, and
:class:`OpCounter` (a ``TorchDispatchMode``) counts them as they come, with
the same :class:`Cost` fields:

  flops             the products' FLOPs, by ``torch.utils.flop_counter``'s
                    formulas (mm, addmm, bmm, baddbmm, convolutions, SDPA);
                    elementwise ops count none
  bytes             each op's tensor operands read once and results written
                    once (views move nothing); an UNFUSED upper bound of the
                    device traffic, not XLA's post-fusion count
  coll / coll_n     result bytes and count of each collective, by kind
                    ("all-reduce", "all-gather", "reduce-scatter",
                    "all-to-all", "broadcast"): the ``_c10d_functional`` ops
                    DTensor issues and the ``c10d`` ops of explicit
                    ``torch.distributed`` calls
  coll_internode    the bytes of ``coll`` whose group spans more than one
                    node (``node_size`` consecutive ranks a node), which
                    run over the slower link between nodes

DTensor ops are not counted as such: the counter hands them on to DTensor
(``NotImplemented``), whose local ops on this rank's shards and whose
collectives come back through it. So the counts are one rank's (``*_dev``
in the dry run), with the compute that every rank of a mesh dimension
repeats on replicated data counted on each. DTensor's sharding propagation
runs each new op once on global shapes to learn its output; those runs
are not counted. Counting an op on DTensors directly would give the
global FLOPs instead (a (256, 4096, 8192) x (8192, 29568) product counted
5.08e14).

Run the step under ``FakeTensorMode`` (``torch._subclasses``): the counts
need shapes only, and nothing is allocated.
"""

from __future__ import annotations

import contextlib
import dataclasses
from collections import defaultdict

import torch
from torch.utils._python_dispatch import TorchDispatchMode
from torch.utils._pytree import tree_flatten

from repro_torch.launch.mesh import H100_GPUS_PER_NODE

__all__ = ["COLLECTIVES", "Cost", "OpCounter", "count"]

#: collective op name (either namespace) -> the kind, as hlo_cost names them
COLLECTIVES = {
    "all_reduce": "all-reduce", "all_reduce_coalesced": "all-reduce", "allreduce_": "all-reduce",
    "allreduce_coalesced_": "all-reduce",
    "all_gather_into_tensor": "all-gather", "all_gather_into_tensor_coalesced": "all-gather",
    "allgather_": "all-gather", "_allgather_base_": "all-gather", "allgather_into_tensor_coalesced_": "all-gather",
    "reduce_scatter_tensor": "reduce-scatter", "reduce_scatter_tensor_coalesced": "reduce-scatter",
    "reduce_scatter_": "reduce-scatter", "_reduce_scatter_base_": "reduce-scatter",
    "all_to_all_single": "all-to-all", "alltoall_": "all-to-all", "alltoall_base_": "all-to-all",
    "broadcast": "broadcast", "broadcast_": "broadcast",
}
_COLLECTIVE_NS = ("_c10d_functional", "c10d")


@dataclasses.dataclass
class Cost:
    flops: float = 0.0
    bytes: float = 0.0
    coll: dict = dataclasses.field(default_factory=lambda: defaultdict(float))
    coll_n: dict = dataclasses.field(default_factory=lambda: defaultdict(float))
    coll_internode: float = 0.0

    def add(self, other: "Cost", mult: float = 1.0) -> None:
        self.flops += other.flops * mult
        self.bytes += other.bytes * mult
        self.coll_internode += other.coll_internode * mult
        for k, v in other.coll.items():
            self.coll[k] += v * mult
        for k, v in other.coll_n.items():
            self.coll_n[k] += v * mult

    @property
    def collective_bytes(self) -> float:
        return float(sum(self.coll.values()))


def _tensor_bytes(tree) -> int:
    return sum(t.numel() * t.element_size() for t in tree_flatten(tree)[0] if isinstance(t, torch.Tensor))


def _group_ranks(args) -> tuple:
    """The global ranks of a collective's process group, found among its
    arguments (a ``_c10d_functional`` op names the group, a ``c10d`` op
    passes it); () where none is found."""
    import torch.distributed as dist
    from torch.distributed.distributed_c10d import _resolve_process_group

    for a in tree_flatten(args)[0]:
        pg = None
        if isinstance(a, str):
            try:
                pg = _resolve_process_group(a)
            except (KeyError, RuntimeError, ValueError):
                continue
        elif isinstance(a, dist.ProcessGroup):
            pg = a
        elif isinstance(a, torch.ScriptObject):  # a c10d op's boxed group (or its ReduceOp)
            try:
                pg = dist.ProcessGroup.unbox(a)
            except RuntimeError:
                continue
        if pg is not None:
            return tuple(dist.get_process_group_ranks(pg))
    return ()


@contextlib.contextmanager
def _dtensor_under_fake(counter: "OpCounter"):
    """DTensor's own bookkeeping, lifted out of the caller's
    ``FakeTensorMode`` and not counted: the sharding propagator working out
    an op's placements and running it on global shapes to learn its output
    (it makes those tensors under a ``FakeTensorMode`` of its own, which
    ``MemTracker`` does not count either), and a strided shard's sizes and
    offsets, which DTensor computes on the host from index tensors."""
    from torch._subclasses.fake_tensor import unset_fake_temporarily
    from torch.distributed.tensor._sharding_prop import ShardingPropagator
    from torch.distributed.tensor.placement_types import _StridedShard

    seams = [(ShardingPropagator, "_propagate_tensor_meta_non_cached"),
             (ShardingPropagator, "propagate_op_sharding_non_cached"),
             (_StridedShard, "local_shard_size_and_offset")]
    origs = [(cls, name, cls.__dict__[name]) for cls, name in seams]

    def lifted(orig):
        def wrapped(*args, **kwargs):
            counter._skip += 1
            try:
                with unset_fake_temporarily():
                    return orig(*args, **kwargs)
            finally:
                counter._skip -= 1

        return wrapped

    for cls, name, orig in origs:
        setattr(cls, name, lifted(orig))
    try:
        yield
    finally:
        for cls, name, orig in origs:
            setattr(cls, name, orig)


class OpCounter(TorchDispatchMode):
    """Counts the ops dispatched under it into ``self.cost`` (module
    docstring). ``by_op`` holds each op's count and FLOPs, for reading a
    trace. Use as a context manager; nest it inside ``FakeTensorMode``.
    ``node_size``: consecutive ranks that share a node (``coll_internode``);
    a group whose ranks cannot be found counts as spanning nodes."""

    def __init__(self, node_size: int = H100_GPUS_PER_NODE) -> None:
        super().__init__()
        self.cost = Cost()
        self.node_size = node_size
        self.by_op: dict = defaultdict(lambda: [0, 0.0])
        self._skip = 0
        self._stack = contextlib.ExitStack()

    def __enter__(self):
        self._stack.enter_context(_dtensor_under_fake(self))
        return super().__enter__()

    def __exit__(self, *exc):
        try:
            return super().__exit__(*exc)
        finally:
            self._stack.close()

    def add_bytes(self, n: float) -> None:
        """Bytes of work done outside torch's dispatch (a kernel given by
        shape only, as the dry run's fused SAGe decode)."""
        self.cost.bytes += float(n)

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        from torch.distributed.tensor import DTensor
        from torch.utils.flop_counter import flop_registry

        kwargs = kwargs or {}
        if any(issubclass(t, DTensor) for t in types):
            return NotImplemented  # DTensor dispatches its local ops back through this mode
        out = func(*args, **kwargs)
        if self._skip or func.namespace == "prim":
            return out
        packet = func._overloadpacket
        if func.namespace in _COLLECTIVE_NS and packet.__name__ in COLLECTIVES:
            kind = COLLECTIVES[packet.__name__]
            n = _tensor_bytes(out)
            self.cost.coll[kind] += n
            self.cost.coll_n[kind] += 1
            ranks = _group_ranks((args, kwargs))
            if len({r // self.node_size for r in ranks}) != 1:
                self.cost.coll_internode += n
        elif func.namespace in _COLLECTIVE_NS:
            return out  # wait_tensor and the like: the collective was counted
        flops = float(flop_registry[packet](*args, **kwargs, out_val=out)) if packet in flop_registry else 0.0
        self.cost.flops += flops
        if not func.is_view:
            self.cost.bytes += _tensor_bytes(args) + _tensor_bytes(kwargs) + _tensor_bytes(out)
        rec = self.by_op[str(packet)]
        rec[0] += 1
        rec[1] += flops
        return out


def count(fn, *args, **kwargs) -> Cost:
    """``fn(*args, **kwargs)`` under an :class:`OpCounter`; its cost."""
    with OpCounter() as c:
        fn(*args, **kwargs)
    return c.cost
