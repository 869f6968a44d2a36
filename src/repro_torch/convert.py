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


def _require_ssm(cfg, fn: str) -> None:
    if cfg.family != "ssm":
        raise NotImplementedError(
            f"{fn}: family {cfg.family!r} is not ported yet "
            f"(ROADMAP Queue A, slice 6b part 2: the other LM families and their training)"
        )


def lm_params_from_reference(cfg, params) -> dict[str, torch.Tensor]:
    """A ``state_dict`` for :class:`repro_torch.models.lm.Mamba2LM` holding
    the JAX package's parameters ``params`` of ``cfg`` (its nested dict with
    layers stacked on a leading L axis; any arrays ``np.asarray`` takes).
    Layers are unstacked into ``layers.<i>.…``; values stay f32."""
    _require_ssm(cfg, "lm_params_from_reference")

    def t(a) -> torch.Tensor:
        return torch.from_numpy(np.array(a, dtype=np.float32))

    sd = {"embed": t(params["embed"]), "norm_f": t(params["norm_f"])}
    if not cfg.tie_embeddings:
        sd["lm_head"] = t(params["lm_head"])
    layers = params["layers"]
    for i in range(cfg.n_layers):
        sd[f"layers.{i}.norm1"] = t(np.asarray(layers["norm1"])[i])
        for k, v in layers["ssm"].items():
            sd[f"layers.{i}.ssm.{k}"] = t(np.asarray(v)[i])
    return sd


def _to_reference(cfg, named: dict, leaf) -> dict:
    """``named`` ({state-dict name: tensor}) in the JAX package's nested
    layout; ``leaf`` takes one tensor, or the layers' list of tensors to
    stack on a leading L axis."""
    L = cfg.n_layers
    out = {"embed": leaf(named["embed"]), "norm_f": leaf(named["norm_f"])}
    if not cfg.tie_embeddings:
        out["lm_head"] = leaf(named["lm_head"])
    keys = [k[len("layers.0.ssm."):] for k in named if k.startswith("layers.0.ssm.")]
    out["layers"] = {
        "norm1": leaf([named[f"layers.{i}.norm1"] for i in range(L)]),
        "ssm": {k: leaf([named[f"layers.{i}.ssm.{k}"] for i in range(L)]) for k in keys},
    }
    return out


def _host(t) -> np.ndarray:
    if isinstance(t, list):
        t = torch.stack([x.detach() for x in t])
    return t.detach().cpu().numpy()


def _spec(t) -> LeafSpec:
    shape = (len(t),) + tuple(t[0].shape) if isinstance(t, list) else tuple(t.shape)
    return LeafSpec(shape, np.float32)


def train_state_to_reference(cfg, model, opt: dict, *, shapes_only: bool = False) -> dict:
    """``{"params": ..., "opt": {"m", "v", "step"[, "ef"]}}`` as the JAX
    package's trainer holds it: nested dicts under ``repro``'s keys, layers
    stacked on a leading L axis, host numpy arrays (a synchronous
    device->host copy). ``shapes_only`` gives ``LeafSpec`` leaves, all a
    restore needs, without copying."""
    _require_ssm(cfg, "train_state_to_reference")
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
    _require_ssm(cfg, "train_state_from_reference")
    out = {k: lm_params_from_reference(cfg, opt[k]) for k in ("m", "v", "ef") if k in opt}
    out["step"] = torch.tensor(int(np.asarray(opt["step"])), dtype=torch.int32)
    return lm_params_from_reference(cfg, params), out
