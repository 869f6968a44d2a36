"""Carry state across from the JAX package.

SAGe's state is the encoded :class:`SageFile` and the prepared
block-major :class:`DeviceBlocks`; the language model that consumes its
tokens has weights and, in training, AdamW's state. These functions read
the JAX package's objects by duck typing (numpy arrays, ``meta.to_json()``,
nested dicts of arrays), so this package never imports it;
``train_state_to_reference`` writes the JAX package's layout back (the
trainer checkpoints it, so either package restores the other's runs).
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from repro_torch.checkpoint.checkpoint import LeafSpec
from repro_torch.core.decode_torch import DeviceBlocks, host_to_tensor, resolve_device
from repro_torch.core.format import BlockCaps, SageFile, SageMeta


def sage_file_from_reference(sf) -> SageFile:
    """This package's SageFile holding the same sections as ``sf`` (a JAX
    package SageFile, or anything with ``meta.to_json()``, ``consensus2b``,
    ``directory`` and ``streams``)."""
    return SageFile(
        meta=SageMeta.from_json(sf.meta.to_json()),
        consensus2b=np.array(sf.consensus2b, dtype=np.uint32),
        directory=np.array(sf.directory, dtype=np.int64),
        streams={k: np.array(v, dtype=np.uint32) for k, v in sf.streams.items()},
    )


def device_blocks_from_reference(db, device="cuda") -> DeviceBlocks:
    """This package's DeviceBlocks on ``device`` from a JAX package
    DeviceBlocks: every array goes through ``np.asarray`` (host numpy or
    device arrays alike), uint32 rows are reinterpreted as int32."""
    dev = resolve_device(device)
    caps = BlockCaps(**{f.name: int(getattr(db.caps, f.name)) for f in dataclasses.fields(BlockCaps)})
    arrays: dict[str, torch.Tensor] = {}
    for k, v in db.arrays.items():
        a = np.asarray(v)[: db.n_blocks]  # drop any shard-padding rows
        arrays[k] = host_to_tensor(a, dev)
    return DeviceBlocks(
        arrays=arrays,
        caps=caps,
        classes={k: tuple(int(w) for w in v) for k, v in db.classes.items()},
        fixed_len=int(db.fixed_len),
        n_blocks=int(db.n_blocks),
        device=dev,
    )


def _stacks(cfg) -> tuple[tuple[str, tuple[int, ...]], ...]:
    """The JAX package's stacked layer trees of ``cfg``: (key, the leading
    axes it stacks a layer parameter on). (L,) under ``layers``, the
    hybrid's (groups, attn_every), and the encdec family's ``enc_layers``
    (n_enc_layers,) and ``dec_layers`` (L,)."""
    if cfg.family == "encdec":
        return ("enc_layers", (cfg.n_enc_layers,)), ("dec_layers", (cfg.n_layers,))
    if cfg.family == "hybrid":
        return (("layers", (cfg.n_layers // cfg.attn_every, cfg.attn_every)),)
    return (("layers", (cfg.n_layers,)),)


def _flat(tree, prefix: str = "") -> list[tuple[str, object]]:
    """A nested dict's leaves as (``.``-joined key, leaf)."""
    if isinstance(tree, dict):
        return [kv for k in tree for kv in _flat(tree[k], f"{prefix}{k}.")]
    return [(prefix[:-1], tree)]


def _nest(flat: dict) -> dict:
    out: dict = {}
    for name, v in flat.items():
        *path, last = name.split(".")
        d = out
        for k in path:
            d = d.setdefault(k, {})
        d[last] = v
    return out


def _layer_name(stack: str, idx: tuple, key: str) -> str:
    return f"{stack}." + "".join(f"{i}." for i in idx) + key


def lm_params_from_reference(cfg, params) -> dict[str, torch.Tensor]:
    """A ``state_dict`` for the model of ``cfg`` (``lm.init_params``)
    holding the JAX package's parameters ``params`` (its nested dict with
    layer parameters stacked on leading axes, ``_stacks``; any arrays
    ``np.asarray`` takes). Stacked layers are unstacked into
    ``layers.<i>.…`` (``layers.<g>.<j>.…``, ``enc_layers.<i>.…``,
    ``dec_layers.<i>.…``); every other leaf (``embed``, ``norm_f``,
    ``lm_head``, the hybrid's ``shared_attn``, the encdec family's
    ``enc_norm_f``, ``pos_emb_enc`` and ``pos_emb_dec``) keeps its
    ``.``-joined key; values stay f32."""
    stacks = dict(_stacks(cfg))

    def t(a) -> torch.Tensor:
        return torch.from_numpy(np.array(a, dtype=np.float32))

    sd = {}
    for top, tree in params.items():
        if top not in stacks:
            sd.update({k: t(a) for k, a in _flat(tree, f"{top}.")})
            continue
        for key, a in _flat(tree):
            a = np.asarray(a)
            for idx in np.ndindex(*stacks[top]):
                sd[_layer_name(top, idx, key)] = t(a[idx])
    return sd


def _to_reference(cfg, named: dict, leaf) -> dict:
    """``named`` ({state-dict name: tensor}) in the JAX package's nested
    layout; ``leaf(t)`` takes one tensor, ``leaf(ts, lead)`` a stack's list
    of tensors to stack on its ``lead`` axes."""
    stacks = _stacks(cfg)
    out = _nest({k: leaf(v) for k, v in named.items() if k.split(".", 1)[0] not in dict(stacks)})
    for top, lead in stacks:
        idx = list(np.ndindex(*lead))
        first = _layer_name(top, idx[0], "")
        keys = [k[len(first):] for k in named if k.startswith(first)]
        out[top] = _nest({k: leaf([named[_layer_name(top, i, k)] for i in idx], lead) for k in keys})
    return out


def _host(t, lead: tuple = ()) -> np.ndarray:
    if isinstance(t, list):
        t = torch.stack([x.detach() for x in t]).reshape(*lead, *t[0].shape)
    return t.detach().cpu().numpy()


def _spec(t, lead: tuple = ()) -> LeafSpec:
    shape = tuple(lead) + tuple(t[0].shape) if isinstance(t, list) else tuple(t.shape)
    return LeafSpec(shape, np.float32)


def train_state_to_reference(cfg, model, opt: dict, *, shapes_only: bool = False) -> dict:
    """``{"params": ..., "opt": {"m", "v", "step"[, "ef"]}}`` as the JAX
    package's trainer holds it: nested dicts under ``repro``'s keys, layers
    stacked on their leading axes, host numpy arrays (a synchronous
    device->host copy). ``shapes_only`` gives ``LeafSpec`` leaves, all a
    restore needs, without copying."""
    leaf = _spec if shapes_only else _host
    ref_opt = {k: _to_reference(cfg, opt[k], leaf) for k in ("m", "v", "ef") if k in opt}
    ref_opt["step"] = LeafSpec((), np.int32) if shapes_only else np.asarray(int(opt["step"]), np.int32)
    return {"params": _to_reference(cfg, dict(model.named_parameters()), leaf), "opt": ref_opt}


def train_state_from_reference(cfg, params, opt) -> tuple[dict, dict]:
    """(``state_dict`` for the model, optimizer state) from the JAX
    package's parameters and AdamW state (nested dicts, layers stacked; any
    arrays ``np.asarray`` takes). The optimizer's moments are keyed by the
    model's parameter names; every tensor is f32 on the CPU, but ``step``
    (int32)."""
    out = {k: lm_params_from_reference(cfg, opt[k]) for k in ("m", "v", "ef") if k in opt}
    out["step"] = torch.tensor(int(np.asarray(opt["step"])), dtype=torch.int32)
    return lm_params_from_reference(cfg, params), out
