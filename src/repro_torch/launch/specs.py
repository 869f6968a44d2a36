"""Dry-run case construction, the port of ``src/repro/launch/specs.py``:
(arch x shape x mesh) -> (step function, arguments).

The arguments are fake tensors (``torch._subclasses.FakeTensorMode``): call
the builders and the step inside one ``FakeTensorMode``, on a ``"cpu"``
DeviceMesh of a ``"fake"`` process group (``launch/dryrun.py``). Nothing is
allocated and no collective runs, but every op dispatches as on the card,
so the step is the launcher's own code: ``lm.init_params`` draws the
weights, ``distribute_model`` places them by ``param_shardings``, and
``make_train_step``'s parts / ``lm.prefill`` / ``lm.decode_step`` run on
them.

The fake tensors lie on the CPU device, so the kernel wrappers take their
plain versions (they route by device, and raise for ``meta``): B6 and the
attention count the plain arithmetic's FLOPs and bytes, not the CUDA
kernels'. The fused SAGe decode (B5) depends on the data and cannot run
on fake tensors: :func:`build_sage_fused_case` gives its output by shape
and adds its bytes to the counter explicitly.

Placements are DTensor placement tuples, one entry per mesh dimension
(``sharding.placements``), where ``repro`` has ``NamedSharding``s.
"""

from __future__ import annotations

import math

import torch
from torch import nn

from repro_torch.configs.base import ArchConfig, ShapeCell
from repro_torch.distributed.sharding import (
    Rules,
    attention_split,
    axes_size,
    distribute_model,
    placements,
)
from repro_torch.models import lm
from repro_torch.training import steps as TS
from repro_torch.training.optimizer import adamw_init, adamw_update
from repro_torch.training.steps import TrainOptions

BF16 = torch.bfloat16
I32 = torch.int32

__all__ = ["batch_shapes", "batch_sharding", "build_case", "build_dp_compressed_case", "build_sage_fused_case",
           "cache_sharding", "fake_dtensor", "_zero1_sharding"]


def _dsize(rules: Rules) -> int:
    return axes_size(rules.mesh, rules.batch() or ())


def _zero1_sharding(shape: tuple, pshard: tuple, rules: Rules) -> tuple:
    """ZeRO-1: an optimizer moment's placements, those of its parameter
    (``pshard``) with the data axes (``rules.batch()``) also sharding the
    first dim that the parameter's placements leave whole and their size
    divides; the parameter's placements where none does."""
    from torch.distributed.tensor import Shard

    b = rules.batch()
    dsize = _dsize(rules)
    if not b or dsize <= 1:
        return tuple(pshard)
    names = rules.axis_names
    part: list = [None] * len(shape)
    for i, pl in enumerate(pshard):
        if isinstance(pl, Shard):
            part[pl.dim] = names[i] if part[pl.dim] is None else part[pl.dim] + (names[i],)
    for i, (dim, ax) in enumerate(zip(shape, part)):
        if ax is None and dim % dsize == 0:
            part[i] = b
            break
    return placements(tuple(part), names)


def fake_dtensor(shape: tuple, dtype, rules: Rules, pl: tuple):
    """A DTensor of ``shape`` placed ``pl`` on ``rules.mesh`` whose local
    shard is a fresh tensor of its own (made under the caller's
    ``FakeTensorMode``: a fake tensor, no memory)."""
    from torch._subclasses.fake_tensor import unset_fake_temporarily
    from torch.distributed.tensor import DTensor
    from torch.distributed.tensor._utils import compute_local_shape_and_global_offset

    with unset_fake_temporarily():  # the mesh's own coordinates are real tensors
        local, _ = compute_local_shape_and_global_offset(shape, rules.mesh, pl)
    stride = tuple(math.prod(shape[i + 1:]) for i in range(len(shape)))
    return DTensor.from_local(torch.zeros(local, dtype=dtype), rules.mesh, pl, run_check=False,
                              shape=torch.Size(shape), stride=stride)


def batch_shapes(cfg: ArchConfig, cell: ShapeCell) -> dict:
    """{name: (shape, dtype)} of one cell's inputs (before placement)."""
    B, S = cell.global_batch, cell.seq_len
    if cell.kind == "decode":  # one new token against a cache of S
        return {"tokens": ((B, 1), I32)}
    S_img = int(S * cfg.img_frac) if cfg.family == "vlm" else 0
    out = {"tokens": ((B, S - S_img), I32)}
    if cell.kind == "train":
        out["labels"] = ((B, S - S_img), I32)
    if cfg.family == "vlm":
        out["patch_embeds"] = ((B, S_img, cfg.d_model), BF16)
    if cfg.family == "encdec":
        out["frames"] = ((B, S, cfg.d_model), BF16)
    return out


def batch_sharding(batch: dict, rules: Rules) -> dict:
    """Placements of each input: dim 0 over the batch axes where their size
    divides it, the rest whole."""
    b, dsize = rules.batch(), _dsize(rules)
    return {k: placements(((b if b and dsize > 1 and shape[0] % dsize == 0 else None),)
                          + (None,) * (len(shape) - 1), rules.axis_names)
            for k, (shape, _dt) in batch.items()}


def cache_sharding(cache_shapes: dict, rules: Rules, cfg: ArchConfig, *, seq_shard: bool = False) -> dict:
    """Placements of each decode-state leaf ({path: shape}, as
    ``lm.init_cache`` nests them, "/"-joined): the batch over the data axes;
    an SSM state's heads and a conv tail's channels over the model axis
    where its size divides them, as ``repro``'s. A KV cache keeps whole
    heads and whole sequences, as the port's decode attention reads them
    (``layers._per_head``): its KV heads over the model axis where
    ``attention_split`` splits them, otherwise whole (``repro`` shards the
    sequence there, or with ``seq_shard``: the port's decode core needs
    all of it). ``seq_shard`` is taken for the reference's signature."""
    del seq_shard
    b, dsize = rules.batch(), _dsize(rules)
    m = None if rules.pure_dp else rules.model_axis
    msize = 1 if m is None else axes_size(rules.mesh, (m,))
    out = {}
    for path, shape in cache_shapes.items():
        leaf = path.rsplit("/", 1)[-1]
        part: list = [None] * len(shape)

        def put(i, ax, ok=True):
            if ax is not None and ok:
                part[i] = ax

        if leaf in ("k", "v", "xk", "xv"):  # (L, B, T, KV, Dh)
            put(-4, b, dsize > 1 and shape[-4] % dsize == 0)
            put(-2, m, attention_split(rules, cfg.n_heads, cfg.n_kv_heads)[1])
        elif leaf.startswith("conv"):  # (L?, B, w-1, C)
            put(-3, b, dsize > 1 and shape[-3] % dsize == 0)
            put(-1, m, shape[-1] % msize == 0)
        elif leaf == "ssm":  # (L?, B, H, P, N)
            put(-4, b, dsize > 1 and shape[-4] % dsize == 0)
            put(-3, m, shape[-3] % msize == 0)
        out[path] = placements(tuple(part), rules.axis_names)
    return out


def _flat(tree: dict, prefix: str = "") -> dict:
    out = {}
    for k, v in tree.items():
        out.update(_flat(v, f"{prefix}{k}/") if isinstance(v, dict) else {prefix + k: v})
    return out


def _nest(flat: dict) -> dict:
    out: dict = {}
    for k, v in flat.items():
        node = out
        *head, last = k.split("/")
        for p in head:
            node = node.setdefault(p, {})
        node[last] = v
    return out


def _model(cfg: ArchConfig, rules: Rules, dtype=None):
    """A model of ``cfg`` drawn on the (fake) CPU, its parameters DTensors
    placed by ``param_shardings`` (``distribute_model``), in ``dtype``."""
    model = lm.init_params(torch.Generator(), cfg, device="cpu")
    if dtype is not None:  # Module.to cannot swap fake parameters in place
        for name, p in list(model.named_parameters()):
            owner, _, leaf = name.rpartition(".")
            setattr(model.get_submodule(owner) if owner else model, leaf, nn.Parameter(p.detach().to(dtype)))
    return distribute_model(model, rules)


def _zero1_opt(model, rules: Rules) -> dict:
    """AdamW's state with ZeRO-1 moments (:func:`_zero1_sharding`)."""
    named = dict(model.named_parameters())
    mom = {k: fake_dtensor(tuple(p.shape), torch.float32, rules, _zero1_sharding(tuple(p.shape), p.placements, rules))
           for k, p in named.items()}
    return {"m": mom, "v": {k: torch.zeros_like(t) for k, t in mom.items()},
            "step": torch.zeros((), dtype=torch.int32)}


def _batch(cfg: ArchConfig, cell: ShapeCell, rules: Rules) -> dict:
    shapes = batch_shapes(cfg, cell)
    pl = batch_sharding(shapes, rules)
    return {k: fake_dtensor(shape, dt, rules, pl[k]) for k, (shape, dt) in shapes.items()}


def _traced_train_step(cfg: ArchConfig, opts: TrainOptions):
    """``make_train_step``'s step as it runs when the loss is finite: a fake
    loss has no value for the NaN gate to test, so the traced step applies
    the update as a finite one does."""

    def train_step(model, opt: dict, batch: dict):
        loss, metrics, grads = TS._grads(model, cfg, batch, opts)
        grads, new_ef = TS._compress_grads(grads, opts.grad_compress, opt.get("ef"))
        _p, opt, om = adamw_update(opts.adamw, grads, opt, dict(model.named_parameters()))
        if new_ef is not None:
            opt["ef"] = new_ef
        return model, opt, dict(metrics, **om)

    return train_step


def build_case(cfg: ArchConfig, cell: ShapeCell, rules: Rules, opts: TrainOptions = TrainOptions()):
    """(step function, its arguments) of one cell: the train step on f32
    DTensor parameters with ZeRO-1 moments, or a prefill / decode step on
    bf16 serving weights (half the memory, as ``repro`` stores them)."""
    batch = _batch(cfg, cell, rules)
    if cell.kind == "train":
        model = _model(cfg, rules)
        return _traced_train_step(cfg, opts), (model, _zero1_opt(model, rules), batch)
    model = _model(cfg, rules, BF16)
    if cell.kind == "prefill":
        def prefill(model, batch):
            return lm.prefill(model, cfg, batch["tokens"], cell.seq_len, chunk=opts.chunk,
                              patch_embeds=batch.get("patch_embeds"), frames=batch.get("frames"))

        return prefill, (model, batch)
    shapes = {k: tuple(v.shape) for k, v in _flat(lm.init_cache(cfg, cell.global_batch, cell.seq_len,
                                                                device="cpu")).items()}
    pl = cache_sharding(shapes, rules, cfg, seq_shard=cell.seq_len >= 200_000)
    dtypes = {k: (torch.float32 if k.startswith("ssm/") else BF16) for k in shapes}
    cache = _nest({k: fake_dtensor(s, dtypes[k], rules, pl[k]) for k, s in shapes.items()})

    def decode(model, cache, batch):
        return lm.decode_step(model, cfg, batch["tokens"], cache, cell.seq_len - 1)

    return decode, (model, cache, batch)


def build_dp_compressed_case(cfg: ArchConfig, cell: ShapeCell, rules: Rules, opts: TrainOptions, how: str):
    """The pure-DP train step with the compressed gradient all-reduce
    (``distributed/dp_step.py``): plain replicated parameters, every rank
    passing the global batch and keeping its rows."""
    from repro_torch.distributed.dp_step import make_dp_train_step

    if cell.kind != "train" or not rules.pure_dp:
        raise ValueError("dp-compress needs a --pure-dp train cell")
    model = lm.init_params(torch.Generator(), cfg, device="cpu")
    opt = adamw_init(dict(model.named_parameters()))
    if how == "int16_ef":
        opt["ef"] = {k: torch.zeros_like(p) for k, p in model.named_parameters()}
    batch = {k: torch.zeros(shape, dtype=dt) for k, (shape, dt) in batch_shapes(cfg, cell).items()}
    fn = make_dp_train_step(cfg, opts, rules.mesh, rules.batch(), compress=how)
    return fn, (model, opt, batch)


#: the fused case's block capacities, width classes and read length (``repro``'s)
SAGE_CAPS = dict(segs=128, mism=4096, indel=512, multi=128, insb=1024, escb=2048, tokens=16384, window=65536)
SAGE_FIXED_LEN = 150


def _stream_words(caps) -> dict:
    def words(bits):
        return max(2, (bits + 31) // 32 + 1)

    return {"mapg": words(caps.segs * 4), "mapa": words(caps.segs * 20), "leng": words(caps.segs * 1),
            "lena": words(caps.segs * 8), "cntg": words(caps.segs * 4), "cnta": words(caps.segs * 10),
            "mpg": words(caps.mism * 4), "mpa": words(caps.mism * 9), "mbb": words(caps.mism * 2),
            "idg": words(caps.indel * 2), "idl": words(caps.multi * 8), "ibs": words(caps.insb * 2),
            "rfl": words(caps.segs * 3), "esc": words(caps.escb * 3)}


def build_sage_fused_case(cfg: ArchConfig, cell: ShapeCell, rules: Rules, opts: TrainOptions = TrainOptions(),
                          counter=None):
    """The paper's cell: the train step with the SAGe data preparation on
    the device in front of it. The inputs are compressed block streams,
    round-robin over the data axes (the paper's channel layout); each rank
    decodes its blocks into k-mer ids with the fused decode (B5: gather,
    decode and k-mer reformat in one launch), and the ids are the step's
    tokens and labels.

    B5 depends on the data, so it does not run on fake tensors: its output,
    (blocks, tokens // k) int32 k-mer ids, is made by shape, and its bytes
    (every stream word read once, the ids written once) go to ``counter``
    (an ``op_cost.OpCounter``) when one is given."""
    from torch.distributed.tensor import DTensor

    from repro_torch.core.api import pick_k
    from repro_torch.core.format import NDIR, BlockCaps

    if cell.kind != "train":
        raise ValueError("the SAGe-fused case is a train cell")
    B, S = cell.global_batch, cell.seq_len
    k = pick_k(cfg.vocab)
    caps = BlockCaps(**SAGE_CAPS)
    dsize = _dsize(rules)
    nb = math.ceil(B * (S + 1) * k / caps.tokens)
    nb = -(-nb // dsize) * dsize  # a multiple of the data ranks
    bpl = placements((rules.batch(), None), rules.axis_names)
    blocks = {s: fake_dtensor((nb, w), torch.int32, rules, bpl) for s, w in _stream_words(caps).items()}
    blocks["cons"] = fake_dtensor((nb, caps.window // 16), torch.int32, rules, bpl)
    blocks["dir"] = fake_dtensor((nb, NDIR), torch.int32, rules, bpl)
    model = _model(cfg, rules)
    opt = _zero1_opt(model, rules)
    inner = _traced_train_step(cfg, opts)
    tok_pl = rules.spec("tokens")

    def fused(model, opt, blocks):
        local = {s: t.to_local() for s, t in blocks.items()}
        nb_local = local["dir"].shape[0]
        ids = torch.zeros((nb_local, caps.tokens // k), dtype=I32)  # B5's output, by shape
        if counter is not None:
            counter.add_bytes(sum(t.numel() * t.element_size() for t in local.values())
                              + ids.numel() * ids.element_size())
        rows = B // dsize
        flat = torch.clamp(ids.reshape(-1)[: rows * (S + 1)].reshape(rows, S + 1), 0, cfg.vocab - 1)
        tokens = DTensor.from_local(flat, rules.mesh, tok_pl, run_check=False)
        return inner(model, opt, {"tokens": tokens[:, :-1], "labels": tokens[:, 1:]})

    return fused, (model, opt, blocks)
