"""Logical-axis sharding rules (DP/TP/EP/SP + SAGe blocks), the port of
``src/repro/distributed/sharding.py``.

Model code annotates activations with *logical* names via :func:`shard_act`;
a thread-installed :class:`Rules` maps them onto the dimensions of a
``torch.distributed.device_mesh.DeviceMesh`` as DTensor placements. With no
rules installed (unit tests, one device), annotations do nothing.

Tensor and sequence parallelism: :func:`distribute_model` turns a model's
parameters into DTensors placed by :func:`param_shardings`; the batch then
enters as a DTensor (``Rules.spec("tokens")``) and the model's torch ops
run on DTensors, whose collectives DTensor issues. Where ``repro`` leaves
XLA to regather, the port's kernel boundaries (``models.layers``,
``ssm``, ``moe``) redistribute their inputs to whole heads
(:func:`heads_layout`) and whole sequences and run the kernel, or its
plain version, on each rank's shard through
``torch.distributed.tensor.experimental.local_map``.

Parameter placements come from the parameter's *name* by pattern
(:func:`param_spec`, the reference's ``_PARAM_RULES`` table), so every
architecture gets Megatron-style TP + EP without per-model tables. The
port's parameters are unstacked (``layers.<i>.…``): a spec applies to the
trailing dimensions, as the reference's leading-``None`` padding of its
stacked leaves does.

The SAGe store shards over *blocks*, the paper's independent unit of
storage, decode and checkpointing (its per-NAND-channel partitions, §5.3).
:class:`BlockMesh` is the store-level mesh: an ordered tuple of devices
and an axis name, the ``i``-th device holding the ``i``-th contiguous
shard of every block-major array (:func:`block_sharding` gives the row
ranges).

``repro``'s ``shard_map`` wrapper has no counterpart here: each rank runs
its local function, and the collectives it needs are written out
(``torch.distributed`` calls on the mesh's process groups).
"""

from __future__ import annotations

import contextlib
import dataclasses
import re
import threading
from typing import Optional

import torch

__all__ = [
    "BLOCK_AXIS", "BlockMesh", "Rules", "all_reduce_axes", "attention_split", "axes_index", "axes_size",
    "batch_partial", "block_axis_name", "block_shard_count", "block_sharding", "block_spec", "block_specs",
    "current_rules", "distribute_model", "full_params", "grad_placed", "heads_layout", "install_rules", "is_dtensor",
    "make_block_mesh", "param_shardings", "param_spec", "placements", "row_out", "shard_act", "tp_rules", "use_rules",
    "whole_seq",
]

_state = threading.local()

BLOCK_AXIS = "blocks"  # the store-level mesh axis (SAGe block partitions)


def indexed_device(d) -> torch.device:
    """``d`` as a torch.device, a CUDA device with its index filled in (so
    ``cuda`` and ``cuda:0`` compare equal)."""
    d = torch.device(d)
    if d.type == "cuda" and d.index is None:
        return torch.device("cuda", torch.cuda.current_device() if torch.cuda.is_available() else 0)
    return d


@dataclasses.dataclass(frozen=True)
class BlockMesh:
    """A 1-D store-level mesh: shard ``i`` of every block-major array lives
    on ``devices[i]``.

    Any list of devices is taken, repeats included: ``BlockMesh([cpu] * 4)``
    shards over four host "devices" (the port's counterpart of ``repro``'s
    forced host devices, ``XLA_FLAGS=--xla_force_host_platform_device_count``),
    and on a machine with one card ``BlockMesh([cuda:0] * 2)`` runs two
    shards on it, each holding and decoding its own rows."""

    devices: tuple
    axis: str = BLOCK_AXIS

    def __post_init__(self) -> None:
        devs = tuple(indexed_device(d) for d in self.devices)
        if not devs:
            raise ValueError("a block mesh needs at least one device")
        if len({d.type for d in devs}) != 1:
            raise ValueError(f"a block mesh's devices must be of one type, got {devs}")
        object.__setattr__(self, "devices", devs)

    @property
    def shards(self) -> int:
        return len(self.devices)


def _visible(device_type: str) -> int:
    if device_type == "cuda":
        return torch.cuda.device_count() if torch.cuda.is_available() else 0
    if device_type == "cpu":
        return 1
    raise ValueError(f"unsupported device type {device_type!r} (use 'cuda' or 'cpu')")


def make_block_mesh(shards: Optional[int] = None, *, axis: str = BLOCK_AXIS, device_type: str = "cuda") -> BlockMesh:
    """1-D store-level mesh over the first ``shards`` visible devices of
    ``device_type`` (every visible one for ``None``); the host counts as one
    CPU device. Asking for more shards than there are devices raises: a
    mesh that repeats a device is built with ``BlockMesh(devices=[...])``."""
    have = _visible(device_type)
    n = have if shards is None else int(shards)
    if not 1 <= n <= have:
        raise ValueError(
            f"cannot build a {n}-shard block mesh with {have} visible {device_type} device(s); "
            f"pass BlockMesh(devices=[...]) to place several shards on one device"
        )
    return BlockMesh(tuple(torch.device(device_type, i) if device_type == "cuda" else torch.device("cpu")
                           for i in range(n)), axis)


def block_axis_name(mesh: BlockMesh) -> str:
    """The block axis of a store-level mesh."""
    return mesh.axis


def block_shard_count(mesh: Optional[BlockMesh]) -> int:
    """Number of block shards a mesh implies (1 for ``None``)."""
    return 1 if mesh is None else mesh.shards


def block_spec(ndim: int, *, axis: str = BLOCK_AXIS) -> tuple:
    """The partition of an ndim block-major array: dim 0 over the block
    axis, the rest whole (``repro``'s ``P(axis, None, ...)``)."""
    return (axis,) + (None,) * (ndim - 1)


def block_sharding(mesh: BlockMesh, n_rows: int) -> tuple[range, ...]:
    """The rows of each shard of an ``n_rows``-row block-major array: the
    rows pad to a multiple of the shard count (zero rows past ``n_rows``)
    and shard ``i`` holds the ``i``-th contiguous run of them."""
    per = -(-int(n_rows) // mesh.shards)
    return tuple(range(i * per, (i + 1) * per) for i in range(mesh.shards))


def block_specs(tree: dict, mesh: BlockMesh) -> dict:
    """Per-array row ranges (:func:`block_sharding`) of a dict of
    block-major arrays."""
    return {k: block_sharding(mesh, v.shape[0]) for k, v in tree.items()}


# --------------------------------------------------------------------------
# model-side rules on a DeviceMesh
# --------------------------------------------------------------------------

def placements(partition: tuple, mesh_dim_names: tuple) -> tuple:
    """DTensor placements, one per mesh dimension, of a partition (one
    entry per tensor dimension: an axis name, a tuple of axis names, or
    None): a mesh dimension named in entry ``i`` shards tensor dim ``i``
    (several mesh dimensions on one tensor dim shard it in mesh order, as a
    ``PartitionSpec`` of an axis tuple does), any other one replicates."""
    from torch.distributed.tensor import Replicate, Shard

    out = [Replicate()] * len(mesh_dim_names)
    for i, ax in enumerate(partition):
        for a in (ax if isinstance(ax, tuple) else (ax,)):
            if a is not None and a in mesh_dim_names:
                out[mesh_dim_names.index(a)] = Shard(i)
    return tuple(out)


@dataclasses.dataclass(frozen=True)
class Rules:
    """Maps logical activation axes to placements on ``mesh`` (a
    ``DeviceMesh`` with ``mesh_dim_names``)."""

    mesh: object
    data_axes: tuple[str, ...] = ("data",)  # pure DP axes ("pod", "data") multi-pod
    model_axis: str = "model"
    seq_shard: bool = False  # SP: shard the activations' seq dim over the model axis
    pure_dp: bool = False  # fold the model axis into DP (small models)
    block_axis: str = BLOCK_AXIS  # SAGe store: leading block dim of reads

    @property
    def axis_names(self) -> tuple:
        return tuple(self.mesh.mesh_dim_names)

    def batch(self):
        """The mesh axes of the activations' batch dim (None: replicated)."""
        axes = tuple(a for a in self.data_axes if a in self.axis_names)
        if self.pure_dp and self.model_axis in self.axis_names:
            axes = axes + (self.model_axis,)
        return axes or None

    def partition(self, name: str) -> tuple:
        """The reference's ``PartitionSpec`` of a logical name, as a tuple
        (one entry per tensor dimension); raises KeyError for an unknown
        name."""
        b = self.batch()
        m = None if self.pure_dp else self.model_axis
        s = m if (self.seq_shard and not self.pure_dp) else None
        table = {
            "act_btd": (b, s, None),  # (B, S, D) between blocks
            "act_heads": (b, None, m),  # (B, S, H*Dh) after attention
            "act_ff": (b, None, m),  # (B, S, FF) inside MLP
            "act_btv": (b, None, m),  # logits (B, S, V)
            "tokens": (b, None),
            "kv_cache": (b, None, m, None),  # (B, T, KV, Dh)
            "kv_cache_seq": (b, m, None, None),  # long-context: shard T
            "ssm_state": (b, m, None, None),  # (B, H, P, N)
            # SAGe store outputs: block-major decode/format arrays (B, ...)
            "sage_blocks": (self.block_axis if self.block_axis in self.axis_names else None,),
        }
        return table[name]

    def spec(self, name: str) -> tuple:
        """DTensor placements of a logical name, one per mesh dimension."""
        return placements(self.partition(name), self.axis_names)


def axes_size(mesh, axes) -> int:
    """The number of ranks along ``axes`` (names of ``mesh``'s dimensions)."""
    names = tuple(mesh.mesh_dim_names)
    n = 1
    for a in axes:
        n *= mesh.size(names.index(a))
    return n


def axes_index(mesh, axes) -> int:
    """This rank's row-major index along ``axes`` (the order in which a
    partition entry of those axes shards a tensor dim)."""
    names = tuple(mesh.mesh_dim_names)
    i = 0
    for a in axes:
        i = i * mesh.size(names.index(a)) + mesh.get_local_rank(a)
    return i


def all_reduce_axes(t: torch.Tensor, mesh, axes, op=None) -> torch.Tensor:
    """``t`` reduced in place over ``mesh``'s dimensions ``axes``, one
    collective on each dimension's process group in turn (a sum or a max
    over the product of the dimensions); returns ``t``."""
    import torch.distributed as dist

    for a in axes:
        dist.all_reduce(t, op=dist.ReduceOp.SUM if op is None else op, group=mesh.get_group(a))
    return t


def install_rules(rules: Optional[Rules]) -> None:
    _state.rules = rules


def current_rules() -> Optional[Rules]:
    return getattr(_state, "rules", None)


@contextlib.contextmanager
def use_rules(rules: Optional[Rules]):
    prev = current_rules()
    install_rules(rules)
    try:
        yield rules
    finally:
        install_rules(prev)


def is_dtensor(x) -> bool:
    from torch.distributed.tensor import DTensor

    return isinstance(x, DTensor)


def tp_rules(*tensors) -> Optional[Rules]:
    """The installed rules when tensor parallelism is engaged for
    ``tensors``: rules are installed and the first tensor is a DTensor;
    else None (the plain path)."""
    r = current_rules()
    return r if r is not None and tensors and is_dtensor(tensors[0]) else None


def heads_layout(rules: Rules, shape: tuple, head_dim: int, split: bool = True, batch: bool = True) -> tuple:
    """Placements that give each rank whole heads of a tensor of ``shape``
    whose dim ``head_dim`` counts heads: dim 0 (the batch, where ``batch``)
    over the batch axes where their size divides it, the heads over the
    model axis where ``split`` and the model size divides the head count,
    every other dim whole (a sharded sequence is gathered: the kernels need
    it all)."""
    b = rules.batch()
    bsize = axes_size(rules.mesh, b or ())
    m = None if rules.pure_dp else rules.model_axis
    part = [None] * len(shape)
    if batch and b and shape[0] % bsize == 0:
        part[0] = b
    if split and m is not None and shape[head_dim] % axes_size(rules.mesh, (m,)) == 0:
        part[head_dim] = m
    return placements(tuple(part), rules.axis_names)


def attention_split(rules: Rules, n_heads: int, n_kv_heads: int) -> tuple[bool, bool]:
    """How the attention cores place heads on the model axis (size m):
    (split_q, split_kv). m divides both head counts: both split. m divides
    the H query heads and each rank's H/m fall in one KV group (H/KV a
    multiple of H/m): the queries split and the KV heads stay whole (each
    rank reads the one its queries share). Otherwise neither splits and
    every model rank computes every head."""
    m = 1 if rules.pure_dp else axes_size(rules.mesh, (rules.model_axis,))
    if m == 1 or n_heads % m:
        return False, False
    if n_kv_heads % m == 0:
        return True, True
    return (n_heads // n_kv_heads) % (n_heads // m) == 0, False


def batch_partial(pl: tuple, rows: tuple) -> tuple:
    """The gradient placements of a tensor placed ``pl`` that a kernel
    boundary (``local_map``) uses with every rank's own rows of the batch,
    a tensor placed ``rows`` (the batch its dim 0): whole (``Replicate``) on
    a mesh dim that shards the rows, its gradient is there a partial sum
    (``Partial``) of each rank's rows."""
    from torch.distributed.tensor import Partial, Replicate, Shard

    return tuple(Partial() if rp == Shard(0) and isinstance(p, Replicate) else p for p, rp in zip(pl, rows))


def _seq_gathered(x, dim: int = 1):
    from torch.distributed.tensor import Replicate, Shard

    pl = tuple(Replicate() if isinstance(p, Shard) and p.dim == dim else p for p in x.placements)
    return x if pl == tuple(x.placements) else x.redistribute(x.device_mesh, pl)


def whole_seq(x, dim: int = 1):
    """``x`` with its sequence dim gathered whole where sequence
    parallelism shards it (a plain tensor as it is): a block's input
    projections then share one all-gather, where each product would
    gather its own (Megatron's SP)."""
    return x if tp_rules(x) is None else _seq_gathered(x, dim)


class _GradFix(torch.autograd.Function):
    """Forward the identity; backward ``fix`` applied to a DTensor gradient."""

    @staticmethod
    def forward(ctx, t, fix):
        ctx.fix = fix
        return t.view_as(t)

    @staticmethod
    def backward(ctx, g):
        return (ctx.fix(g) if is_dtensor(g) else g), None


def row_out(t):
    """The output of a row-parallel product (a sum over the model axis)
    before it meets the sequence-sharded residual stream. Forward it is
    ``t``; its gradient, which DTensor hands back sharded on the sequence,
    is gathered whole first, so that the product's backward does not
    flatten (batch, sequence) over a sharded sequence: a strided shard,
    which the card machine's DTensor (torch 2.11) cannot view. A plain
    tensor passes as it is."""
    return _GradFix.apply(t, _seq_gathered) if tp_rules(t) is not None and t.requires_grad else t


def grad_placed(t):
    """``t``, whose gradient is laid out as ``t`` is before it flows on.
    DTensor hands a product's input gradient back in the layout the
    product chose, which may split heads that ``t``'s reshape keeps whole
    (12 heads of 64 over a model axis of 16); placed as ``t``, the reshape's
    backward views whole heads. A plain tensor passes as it is."""
    if tp_rules(t) is None or not t.requires_grad:
        return t
    mesh, pl = t.device_mesh, tuple(t.placements)
    return _GradFix.apply(t, lambda g: g if tuple(g.placements) == pl else g.redistribute(mesh, pl))


def distribute_model(model, rules: Rules):
    """Make every parameter of ``model`` a DTensor on ``rules.mesh``, placed
    as :func:`param_shardings` says, in place; returns ``model``. Every rank
    passes the same full weights (drawn from one seed, or loaded alike) and
    keeps a copy of its shard of them (a slice would keep the full tensor's
    memory alive): nothing is sent."""
    from torch import nn
    from torch.distributed.tensor import DTensor, distribute_tensor

    places = param_shardings(dict(model.named_parameters()), rules)
    for name, p in list(model.named_parameters()):
        owner, _, leaf = name.rpartition(".")
        mod = model.get_submodule(owner) if owner else model
        dt = distribute_tensor(p.detach(), rules.mesh, places[name], src_data_rank=None)
        dt = DTensor.from_local(dt.to_local().clone(), rules.mesh, dt.placements, run_check=False,
                                shape=dt.shape, stride=dt.stride())
        setattr(mod, leaf, nn.Parameter(dt, requires_grad=p.requires_grad))
    return model


def full_params(model) -> dict:
    """{name: the full tensor} of ``model``'s parameters: DTensors gathered
    whole (a collective: every rank calls it), plain tensors as they are.
    The inverse of :func:`distribute_model`, for comparisons and saving."""
    return {k: (p.full_tensor() if is_dtensor(p) else p).detach() for k, p in model.named_parameters()}


def shard_act(x, name: str):
    """Redistribute a DTensor activation to its logical placements (a dim
    the partition's axes do not divide stays whole, where XLA would pad
    it: decode's batch of 1); does nothing without rules, for a plain
    tensor, an unknown name or a partition longer than ``x``'s rank."""
    from torch.distributed.tensor import DTensor

    r = current_rules()
    if r is None or not isinstance(x, DTensor):
        return x
    try:
        part = r.partition(name)
    except KeyError:
        return x
    if len(part) > x.ndim:
        return x
    part = tuple(None if ax is not None and x.shape[i] % axes_size(r.mesh, ax if isinstance(ax, tuple) else (ax,))
                 else ax for i, ax in enumerate(part))  # a dim its axes do not divide stays whole
    return x.redistribute(r.mesh, placements(part, r.axis_names))


# --------------------------------------------------------------------------
# parameter placements by name pattern
# --------------------------------------------------------------------------

# (pattern, partition of the trailing dims) — first match wins
_PARAM_RULES: list[tuple[str, tuple]] = [
    (r"embed", ("model", None)),  # (V, D) vocab-sharded
    (r"lm_head", (None, "model")),  # (D, V)
    (r"\bwq\b|\bwk\b|\bwv\b", (None, "model")),
    (r"\bbq\b|\bbk\b|\bbv\b", ("model",)),
    (r"\bwo\b", ("model", None)),
    (r"experts.*(up|gate)", ("model", None, None)),  # (E, D, F) EP
    (r"experts.*down", ("model", None, None)),  # (E, F, D) EP
    (r"(shared|mlp|enc_mlp|dec_mlp).*(up|gate)", (None, "model")),
    (r"(shared|mlp|enc_mlp|dec_mlp).*down", ("model", None)),
    (r"router", (None, None)),
    (r"in_(z|x)", (None, "model")),  # mamba d_inner projections
    (r"out_proj", ("model", None)),
    (r"conv_x|ssm_(a|d|dtb)|dt_w", ("model",)),  # per-head / d_inner params
    (r"pos_emb", (None, None)),
    (r".*", ()),  # default: replicate
]


def param_spec(path: str, ndim: int, rules: Rules) -> tuple:
    """The partition of a parameter (one entry per dim) from its name."""
    if rules.pure_dp:
        return ()
    ax: list = []
    for pat, axes in _PARAM_RULES:
        if re.search(pat, path):
            ax = list(axes)
            break
    ax = [None] * (ndim - len(ax)) + [rules.model_axis if a == "model" else a for a in ax]
    return tuple(ax[:ndim])


def param_shardings(named: dict, rules: Rules) -> dict:
    """Placements for every parameter of ``named`` ({name: tensor}, e.g.
    ``dict(model.named_parameters())``), with the reference's divisibility
    fixups: a dim its model-axis size does not divide is replicated."""
    if rules.pure_dp:
        return {k: placements((), rules.axis_names) for k in named}
    msize = rules.mesh.size(rules.axis_names.index(rules.model_axis))
    out = {}
    for k, p in named.items():
        spec = param_spec(k, p.ndim, rules)
        fixed = tuple(None if ax == rules.model_axis and dim % msize else ax for dim, ax in zip(p.shape, spec))
        out[k] = placements(fixed, rules.axis_names)
    return out
