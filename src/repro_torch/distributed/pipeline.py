"""GPipe-style pipeline parallelism (PP), the port of
``src/repro/distributed/pipeline.py``.

Layers are split into ``n_stages`` contiguous groups along one dimension of
a ``DeviceMesh``; each rank holds its stage's slice of the stack (what
``repro``'s ``P(axis)`` means), and each microbatch flows stage to stage
with the classic GPipe bubble of ``n_stages - 1`` ticks. ``repro``'s
``ppermute`` ring is a ``batch_isend_irecv`` to rank + 1 and from rank - 1
on the axis's process group (none with one stage), and its final ``psum``
broadcast is a ``broadcast`` from the last stage.
"""

from __future__ import annotations

import torch


def _stage_slice(stacked, sid: int, per_stage: int):
    """This stage's layers of ``stacked`` (a tensor or a dict of tensors
    with the layers on dim 0)."""
    if isinstance(stacked, dict):
        return {k: _stage_slice(v, sid, per_stage) for k, v in stacked.items()}
    return stacked[sid * per_stage:(sid + 1) * per_stage]


def _layer(stacked, i: int):
    if isinstance(stacked, dict):
        return {k: _layer(v, i) for k, v in stacked.items()}
    return stacked[i]


def _n_layers(stacked) -> int:
    while isinstance(stacked, dict):
        stacked = next(iter(stacked.values()))
    return stacked.shape[0]


def pipeline_apply(mesh, axis: str, layer_fn, stacked_params, x: torch.Tensor, n_microbatch: int) -> torch.Tensor:
    """Run ``layer_fn(params_i, h)`` for the layers stacked on dim 0 of
    ``stacked_params`` (the whole stack, a tensor or a dict of tensors;
    each rank runs its stage's slice), pipelined over ``mesh``'s dimension
    ``axis``.

    ``x``: (B, ...), the same on every rank, with ``B % n_microbatch == 0``;
    the layer count must divide into the stages. Every rank returns the
    last stage's output (B, ...)."""
    import torch.distributed as dist

    names = tuple(mesh.mesh_dim_names)
    n_stages = mesh.size(names.index(axis))
    sid = mesh.get_local_rank(axis)
    L = _n_layers(stacked_params)
    if L % n_stages:
        raise ValueError(f"{L} layers do not split into {n_stages} stages")
    B = x.shape[0]
    if B % n_microbatch:
        raise ValueError(f"batch {B} does not split into {n_microbatch} microbatches")
    per_stage = L // n_stages
    local = _stage_slice(stacked_params, sid, per_stage)
    group = mesh.get_group(axis)
    nxt = dist.get_global_rank(group, (sid + 1) % n_stages)
    prv = dist.get_global_rank(group, (sid - 1) % n_stages)

    mb = x.reshape(n_microbatch, B // n_microbatch, *x.shape[1:])
    buf = torch.zeros_like(mb[0])
    outs = torch.zeros_like(mb)
    for t in range(n_microbatch + n_stages - 1):
        if sid == 0 and t < n_microbatch:  # stage 0 ingests microbatch t
            buf = mb[t].clone()
        for i in range(per_stage):
            buf = layer_fn(_layer(local, i), buf)
        emit = t - (n_stages - 1)  # the last stage emits microbatch t - (n_stages - 1)
        if sid == n_stages - 1 and emit >= 0:
            outs[emit] = buf
        if n_stages > 1:  # rotate the activations to the next stage
            recv = torch.empty_like(buf)
            reqs = dist.batch_isend_irecv([dist.P2POp(dist.isend, buf.contiguous(), nxt, group),
                                           dist.P2POp(dist.irecv, recv, prv, group)])
            for r in reqs:
                r.wait()
            buf = recv
    if n_stages > 1:  # every rank gets the last stage's outputs
        dist.broadcast(outs, src=dist.get_global_rank(group, n_stages - 1), group=group)
    return outs.reshape(B, *x.shape[1:])
