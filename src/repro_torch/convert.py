"""Carry state across from the JAX package.

SAGe's state is the encoded :class:`SageFile` and the prepared
block-major :class:`DeviceBlocks`; the language model that consumes its
tokens has weights. These functions read the JAX package's objects by duck
typing (numpy arrays, ``meta.to_json()``, nested dicts of arrays), so this
package never imports it.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

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


def lm_params_from_reference(cfg, params) -> dict[str, torch.Tensor]:
    """A ``state_dict`` for :class:`repro_torch.models.lm.Mamba2LM` holding
    the JAX package's parameters ``params`` of ``cfg`` (its nested dict with
    layers stacked on a leading L axis; any arrays ``np.asarray`` takes).
    Layers are unstacked into ``layers.<i>.…``; values stay f32."""
    if cfg.family != "ssm":
        raise NotImplementedError(
            f"lm_params_from_reference: family {cfg.family!r} is not ported yet "
            f"(ROADMAP Queue A, slice 6b: LM families, training and checkpoints)"
        )

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
