"""AdamW and its schedule, the port of ``src/repro/training/optimizer.py``:
clipping by the global norm, bias correction from the step, weight decay on
every parameter, linear warmup then cosine decay to ``min_lr_frac``.

The state is ``{"m": {name: f32}, "v": {name: f32}, "step": int32}``, keyed
by the model's parameter names, on the parameters' device. The update runs
in place under ``no_grad`` as ``torch._foreach_*`` calls (a handful of
launches for all parameters); ``torch.optim.AdamW`` is not used, since its
clipping, schedule and decay are not the reference's.
"""

from __future__ import annotations

import dataclasses
import math

import torch

from repro_torch import obs
from repro_torch.distributed.sharding import is_dtensor

F32 = torch.float32


@dataclasses.dataclass(frozen=True)
class AdamWConfig:
    lr: float = 3e-4
    b1: float = 0.9
    b2: float = 0.95
    eps: float = 1e-8
    weight_decay: float = 0.1
    grad_clip: float = 1.0
    warmup_steps: int = 100
    total_steps: int = 10_000
    min_lr_frac: float = 0.1


def schedule(c: AdamWConfig, step) -> torch.Tensor:
    """Linear warmup + cosine decay; ``step`` an integer tensor (or int),
    the learning rate an f32 tensor on its device."""
    step = torch.as_tensor(step).to(F32)
    warm = torch.clamp(step / max(c.warmup_steps, 1), max=1.0)
    t = torch.clamp((step - c.warmup_steps) / max(c.total_steps - c.warmup_steps, 1), 0.0, 1.0)
    cos = 0.5 * (1 + torch.cos(math.pi * t))
    return c.lr * warm * (c.min_lr_frac + (1 - c.min_lr_frac) * cos)


def adamw_init(params: dict) -> dict:
    """Zero moments for ``params`` ({name: tensor}) and step 0; a DTensor
    parameter's moments are DTensors placed as it is."""
    dev = next(iter(params.values())).device
    return {
        "m": {k: torch.zeros_like(p, dtype=F32) for k, p in params.items()},
        "v": {k: torch.zeros_like(p, dtype=F32) for k, p in params.items()},
        "step": torch.zeros((), dtype=torch.int32, device=dev),
    }


def global_norm(tree: dict) -> torch.Tensor:
    """sqrt of the sum of squares over every leaf, in f32. On the card one
    multi-tensor ``_foreach_norm`` (a tree reduction, a few launches for all
    leaves); on the CPU each leaf's ``sum(square(g))``, pairwise-summed as
    the reference computes it (the CPU's ``vector_norm`` and
    ``_foreach_norm`` drift by ~1e-3 relative on a leaf of ~1e8 elements,
    such as qwen2-1.5b's embedding). On DTensor gradients (tensor
    parallelism) the same sum of squares over each leaf's shards, the local
    sums of the leaves that are sharded over the same mesh dimensions added
    first, so one reduction a group gives the global norm: a plain 0-d
    tensor on every rank."""
    gs = [g.to(F32) for g in tree.values()]
    if is_dtensor(gs[0]):
        return torch.sqrt(_sharded_sum_sq(gs))
    if gs[0].is_cuda:
        return torch.linalg.vector_norm(torch.stack(torch._foreach_norm(gs)))
    return torch.sqrt(sum(torch.sum(torch.square(g)) for g in gs))


def _sharded_sum_sq(gs: list) -> torch.Tensor:
    """Σ sum(g²) over DTensor leaves: each leaf's local sum is ``Partial``
    over the mesh dimensions the leaf is sharded on; the leaves of one such
    placement add their local sums, and each group is reduced once."""
    from torch.distributed.tensor import DTensor

    groups: dict = {}
    for g in gs:
        s = torch.sum(torch.square(g))
        key = (id(s.device_mesh), tuple(s.placements))
        groups.setdefault(key, (s.device_mesh, s.placements, []))[2].append(s.to_local())
    return sum(DTensor.from_local(torch.stack(parts).sum(), mesh, pl, run_check=False).full_tensor()
               for mesh, pl, parts in groups.values())


#: parameters' elements a run of ``_foreach`` calls takes at once (1 GiB in
#: f32): bounds the update's temporaries, which would otherwise reach a few
#: times the model's size (~38 GB of them for zamba2-2.7b)
CHUNK_ELEMS = 1 << 28


def _chunks(names: list, params: dict):
    """``names`` split into runs of at most CHUNK_ELEMS elements (a larger
    parameter runs alone)."""
    run, n = [], 0
    for k in names:
        if run and n + params[k].numel() > CHUNK_ELEMS:
            yield run
            run, n = [], 0
        run.append(k)
        n += params[k].numel()
    if run:
        yield run


@torch.no_grad()
def adamw_update(c: AdamWConfig, grads: dict, opt: dict, params: dict):
    """One AdamW step; returns (params, new_opt, metrics).

    ``params`` ({name: tensor}) and the moments of ``opt`` are updated in
    place; the returned ``opt`` holds those moments and a new step. The
    element ops run over runs of parameters (``CHUNK_ELEMS``): the same
    arithmetic on every element, with temporaries the size of a run."""
    step = opt["step"] + 1
    with obs.span("rt.adamw.norm"):
        gn = global_norm(grads)
    lr = schedule(c, step)
    stepf = step.to(F32)
    b1c = 1 - c.b1**stepf
    b2c = 1 - c.b2**stepf
    clip = torch.clamp(c.grad_clip / torch.clamp(gn, min=1e-9), max=1.0) if c.grad_clip else None
    for names in _chunks(list(params), params):
        with obs.span("rt.adamw.chunk"):
            ps = [params[k] for k in names]
            gs = [grads[k].to(F32) for k in names]
            ms = [opt["m"][k] for k in names]
            vs = [opt["v"][k] for k in names]
            if clip is not None:
                gs = torch._foreach_mul(gs, clip)
            torch._foreach_mul_(ms, c.b1)
            torch._foreach_add_(ms, torch._foreach_mul(gs, 1 - c.b1))
            torch._foreach_mul_(vs, c.b2)
            torch._foreach_add_(vs, torch._foreach_mul(torch._foreach_mul(gs, 1 - c.b2), gs))
            del gs
            den = torch._foreach_div(vs, b2c)
            torch._foreach_sqrt_(den)
            torch._foreach_add_(den, c.eps)
            upd = torch._foreach_div(ms, b1c)
            torch._foreach_div_(upd, den)
            del den
            torch._foreach_add_(upd, torch._foreach_mul(ps, c.weight_decay))
            torch._foreach_mul_(upd, lr)
            torch._foreach_sub_(ps, upd)
    return params, {"m": opt["m"], "v": opt["v"], "step": step}, {"grad_norm": gn, "lr": lr}
