"""Data-parallel train step with a COMPRESSED gradient all-reduce, the port of
``src/repro/distributed/dp_step.py``.

Each rank computes the gradients of its rows of the batch with the port's
``loss_fn``, compresses them, all-reduces them over the data axes of the
mesh and takes the mean of the loss; AdamW then runs on the replicated
parameters (pure-DP layouts, the regime where DP gradient traffic
dominates).

``int16_ef`` quantizes ``g + ef`` to ``[-qmax, qmax]``, ``qmax =
max(32767 // ndev, 255)``, with one scale a JAX-package leaf (a layer
parameter shares it across the layers, as its stacked leaf does) shared by
every rank through an all-reduce MAX, sums the integers and keeps the
residual in ``opt["ef"]``. Neither gloo nor NCCL reduces int16, so the
sum travels packed: four quantized values a signed int64 word, the integer
``q0 + q1·2^16 + q2·2^32 + q3·2^48`` (:func:`pack_int16`), over the
concatenation of all leaves (one all-reduce a step). Sums of such
words are the words of the sums, and the balanced base-2^16 digits
(:func:`unpack_int16`) give each sum back exactly while every digit's sum
over any subset of ranks stays in [-32767, 32767]: ``repro``'s own premise
for its int16 psum (ndev <= 128, where ``qmax · ndev <= 32767``), under
which the word stays below 2^63. So the wire carries 2 bytes a gradient
element, as ``repro``'s int16 psum does. ``bf16`` all-reduces the gradients
in bf16 (2 bytes an element).
"""

from __future__ import annotations

import torch

from repro_torch.distributed.sharding import all_reduce_axes, axes_index, axes_size
from repro_torch.training.optimizer import adamw_update
from repro_torch.training.steps import TrainOptions, _grads, _stacked

F32 = torch.float32
DIGIT = 1 << 16


def pack_int16(q: torch.Tensor) -> torch.Tensor:
    """Integers in [-32767, 32767] (any integer dtype) -> int64 words, four
    values a word (the element count pads to a multiple of four with zeros)."""
    q = q.reshape(-1).to(torch.int64)
    pad = (-q.numel()) % 4
    if pad:
        q = torch.cat([q, q.new_zeros(pad)])
    q = q.view(-1, 4)
    return ((q[:, 3] * DIGIT + q[:, 2]) * DIGIT + q[:, 1]) * DIGIT + q[:, 0]


def unpack_int16(x: torch.Tensor, n: int) -> torch.Tensor:
    """The first ``n`` values (int64) of packed words ``x``: balanced
    base-2^16 digits, each in [-2^15, 2^15)."""
    digits = []
    for _ in range(4):
        d = torch.remainder(x + DIGIT // 2, DIGIT) - DIGIT // 2
        digits.append(d)
        x = torch.bitwise_right_shift(x - d, 16)
    return torch.stack(digits, dim=1).reshape(-1)[:n]


def make_dp_train_step(cfg, opts: TrainOptions, mesh, dp_axes: tuple[str, ...], compress: str = "int16_ef"):
    """Returns ``train_step(model, opt, batch) -> (model, opt, metrics)``.

    ``mesh`` is a ``DeviceMesh`` whose dimensions include ``dp_axes``, or
    None for one rank with no process group (the same step, no collective).
    Every rank passes the same global ``batch`` (tensors on the model's
    device) and keeps its rows, ``B / ndev`` of them in the row-major order
    of its coordinates on ``dp_axes``, as ``repro``'s ``P(dp_axes)`` splits
    it. ``opt`` must hold an ``"ef"`` dict for ``int16_ef``
    (``init_train_state`` makes it when ``opts.grad_compress`` is
    ``"int16_ef"``). ``train_step.wire`` holds the last step's all-reduced
    bytes and gradient elements, and for ``int16_ef`` its quantum ``s``
    (``"scale"``: a JAX-package leaf name, as :func:`_stacked` gives it,
    -> 0-d tensor)."""
    if compress not in ("int16_ef", "bf16"):
        raise ValueError(f"compress must be 'int16_ef' or 'bf16', got {compress!r}")
    ndev = 1 if mesh is None else axes_size(mesh, dp_axes)
    qmax = max(32767 // ndev, 255)
    if compress == "int16_ef" and qmax * ndev > 32767:
        raise ValueError(f"int16_ef sums exactly over at most 128 ranks, not {ndev}")
    use_ef = compress == "int16_ef"
    rank = 0 if mesh is None else axes_index(mesh, dp_axes)

    def reduce(t: torch.Tensor, op=None) -> torch.Tensor:
        return t if mesh is None else all_reduce_axes(t, mesh, dp_axes, op)

    def bf16_mean(grads: dict) -> dict:
        names = list(grads)
        flat = reduce(torch.cat([grads[k].reshape(-1).to(torch.bfloat16) for k in names]))
        train_step.wire = {"bytes": flat.numel() * flat.element_size(), "elements": flat.numel()}
        parts = torch.split(flat.to(F32) / ndev, [grads[k].numel() for k in names])
        return {k: t.view(grads[k].shape) for k, t in zip(names, parts)}

    def int16_mean(grads: dict, ef: dict) -> tuple[dict, dict]:
        """The quantize / pack / all-reduce / unpack pass over all leaves at
        once (one flat vector: a few launches, not a few a leaf)."""
        import torch.distributed as dist

        names = list(grads)
        sizes = [grads[k].numel() for k in names]
        xs = torch._foreach_add([grads[k].to(F32) for k in names], [ef[k] for k in names])
        groups = sorted({_stacked(k) for k in names})
        dev = xs[0].device
        group_of = torch.tensor([groups.index(_stacked(k)) for k in names], device=dev)
        peaks = torch.stack(torch._foreach_norm(xs, float("inf")))  # max |x| a leaf
        peak = torch.zeros(len(groups), dtype=F32, device=dev).scatter_reduce(0, group_of, peaks, "amax")
        scales = reduce(peak, None if mesh is None else dist.ReduceOp.MAX) / qmax + 1e-30
        scale = torch.repeat_interleave(scales[group_of], torch.tensor(sizes, device=dev))
        x = torch.cat([t.reshape(-1) for t in xs])
        del xs
        q = torch.clamp(torch.round(x / scale), -qmax, qmax)
        new_ef = x - q * scale
        words = reduce(pack_int16(q))
        train_step.wire = {"bytes": words.numel() * words.element_size(), "elements": x.numel(),
                           "scale": dict(zip(groups, scales.unbind()))}
        del q, x
        out = unpack_int16(words, scale.numel()).to(F32) * scale / ndev
        shapes = [grads[k].shape for k in names]
        return ({k: t.view(sh) for k, t, sh in zip(names, torch.split(out, sizes), shapes)},
                {k: t.view(sh) for k, t, sh in zip(names, torch.split(new_ef, sizes), shapes)})

    def train_step(model, opt: dict, batch: dict):
        B = batch["tokens"].shape[0]
        if B % ndev:
            raise ValueError(f"batch {B} does not split over {ndev} data-parallel ranks")
        rows = B // ndev
        local = {k: v[rank * rows:(rank + 1) * rows] for k, v in batch.items()}
        loss, _m, grads = _grads(model, cfg, local, opts)
        if use_ef:
            grads, new_ef = int16_mean(grads, opt["ef"])
        else:
            grads = bf16_mean(grads)
        loss = reduce(loss.to(F32).clone()) / ndev
        params = dict(model.named_parameters())
        _p, new_opt, om = adamw_update(opts.adamw, grads, {k: v for k, v in opt.items() if k != "ef"}, params)
        if use_ef:
            new_opt["ef"] = new_ef
        return model, new_opt, {"loss": loss, **om}

    train_step.wire = {}
    return train_step
