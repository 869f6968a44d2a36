"""The training step (the port of ``src/repro/training/steps.py``): loss,
gradients, optional gradient compression, AdamW.

``make_train_step`` returns ``train_step(model, opt, batch)``, which updates
the model's parameters and ``opt`` in place and returns them with the
step's metrics. Options, as in the reference:
  * microbatch gradient accumulation (a loop) — the activation-memory knob
  * int16 error-feedback gradient compression (a per-tensor int8-range
    quantisation carried in int16, with the residual kept in ``opt["ef"]``)
  * bf16 gradient rounding
The reference's NaN circuit breaker is in-graph; eager torch checks
``isfinite(loss)`` before it applies anything, so a non-finite loss leaves
the parameters, ``m``, ``v``, ``step`` and ``ef`` untouched.

Spans (``repro_torch.obs``): ``rt.train.step`` around a step, inside it
``rt.train.grads`` (forward and backward), ``rt.train.nan_gate`` (the
host's one blocking sync of a step) and ``rt.train.adamw``;
``rt.train.xent`` around the loss.
"""

from __future__ import annotations

import dataclasses
import re
from typing import Optional

import torch

from repro_torch import obs
from repro_torch.distributed.sharding import is_dtensor
from repro_torch.models import lm
from repro_torch.models.layers import softmax_xent
from repro_torch.training.optimizer import AdamWConfig, adamw_init, adamw_update, global_norm, schedule

F32 = torch.float32


@dataclasses.dataclass(frozen=True)
class TrainOptions:
    remat: bool = True
    remat_policy: str = "nothing"  # nothing | dots
    chunk: int = 1024  # attention block size
    aux_coeff: float = 0.01
    microbatch: int = 0  # 0 = no accumulation
    grad_compress: Optional[str] = None  # None | "bf16" | "int16_ef"
    adamw: AdamWConfig = AdamWConfig()


def loss_fn(model, cfg, batch: dict, opts: TrainOptions):
    """(loss + aux_coeff·aux, {"loss", "aux"}) of ``batch`` (tokens,
    labels and an optional loss_mask, and the vlm family's patch_embeds or
    the encdec family's frames, as tensors on the model's device)."""
    extra = {k: batch[k] for k in ("patch_embeds", "frames") if k in batch}
    logits, aux = lm.forward(model, cfg, batch["tokens"], remat=opts.remat,
                             remat_policy=opts.remat_policy, chunk=opts.chunk, **extra)
    with obs.span("rt.train.xent"):
        loss = softmax_xent(logits, batch["labels"], batch.get("loss_mask"))
    return loss + opts.aux_coeff * aux, {"loss": loss, "aux": aux}


def _grad(loss, leaves: list) -> list:
    """d loss / d leaf, zeros for a leaf the loss does not reach (the encdec
    family's ``norm_f``), as ``jax.grad`` gives them. A DTensor leaf's
    gradient (tensor parallelism) is redistributed to the leaf's own
    placements: one that comes back ``Partial`` over the data axes is
    summed there."""
    gs = torch.autograd.grad(loss, leaves, allow_unused=True)
    return [torch.zeros_like(p) if g is None else _placed_as(g, p) for g, p in zip(gs, leaves)]


def _placed_as(g, p):
    if not is_dtensor(p) or tuple(g.placements) == tuple(p.placements):
        return g
    return g.redistribute(p.device_mesh, p.placements)


def _value(t):
    """A detached value; a DTensor's (tensor parallelism: a loss may be a
    ``Partial`` sum over the ranks' rows) reduced to a plain tensor."""
    t = t.detach()
    return t.full_tensor() if is_dtensor(t) else t


def _microbatch(v, mb: int, i: int):
    """Microbatch ``i`` of ``mb``: rows i·B/mb to (i+1)·B/mb. A DTensor
    batch (tensor parallelism) takes them from each rank's own rows, so
    the rows stay where they are (microbatch i holds other rows than on
    one device; the mean over all microbatches is the same)."""
    if not is_dtensor(v):
        return v.reshape(mb, v.shape[0] // mb, *v.shape[1:])[i]
    from torch.distributed.tensor import DTensor

    loc = v.to_local()
    if loc.shape[0] % mb:
        raise ValueError(f"a rank's {loc.shape[0]} rows do not split into {mb} microbatches")
    n = loc.shape[0] // mb
    return DTensor.from_local(loc[i * n:(i + 1) * n], v.device_mesh, v.placements, run_check=False)


def _grads(model, cfg, batch: dict, opts: TrainOptions):
    """(loss, metrics, {name: f32 gradient}); with ``microbatch`` > 1 the
    batch splits into that many slices whose gradients are averaged."""
    params = dict(model.named_parameters())
    leaves = list(params.values())
    if opts.microbatch and opts.microbatch > 1:
        mb = opts.microbatch
        B = batch["tokens"].shape[0]
        if B % mb:
            raise ValueError(f"batch {B} does not split into {mb} microbatches")
        g_acc = [torch.zeros_like(p, dtype=F32) for p in leaves]
        l_acc = torch.zeros((), dtype=F32, device=leaves[0].device)
        for i in range(mb):
            part = {k: _microbatch(v, mb, i) for k, v in batch.items()}
            loss, _m = loss_fn(model, cfg, part, opts)
            grads = _grad(loss, leaves)
            torch._foreach_add_(g_acc, [g.to(F32) for g in grads])
            l_acc = l_acc + _value(loss)
        g = dict(zip(params, torch._foreach_div(g_acc, mb)))
        return l_acc / mb, {"loss": l_acc / mb}, g
    loss, metrics = loss_fn(model, cfg, batch, opts)
    grads = _grad(loss, leaves)
    metrics = {k: _value(v) if isinstance(v, torch.Tensor) else v for k, v in metrics.items()}
    return _value(loss), metrics, {k: g.to(F32) for k, g in zip(params, grads)}


def _stacked(name: str) -> str:
    """The JAX package's leaf of a parameter: ``layers.<i>.k`` and the
    hybrid's ``layers.<g>.<j>.k`` -> ``layers.k`` (``enc_layers.<i>.k`` ->
    ``enc_layers.k``, ``dec_layers.<i>.k`` -> ``dec_layers.k``);
    ``shared_attn.*`` and the rest are leaves of their own."""
    return re.sub(r"^((?:enc_|dec_)?layers)\.\d+\.(?:\d+\.)?", r"\1.", name)


def _compress_grads(g: dict, how: Optional[str], ef: Optional[dict] = None):
    """Lossy representation of the gradients before the (data-parallel)
    reduction; returns (gradients, error feedback). ``int16_ef``: int8-range
    quantisation carried in int16 (round half to even, as ``jnp.round``)
    with one scale a JAX-package leaf (a layer parameter shares it across
    the layers, and the hybrid's across groups and layers, whose leaf is
    stacked there), the residual fed back into the next step."""
    if how is None:
        return g, ef
    if how == "bf16":
        return {k: x.to(torch.bfloat16).to(F32) for k, x in g.items()}, ef
    if how == "int16_ef":
        xs = {k: x.to(F32) + (ef[k] if ef is not None else 0.0) for k, x in g.items()}
        peak: dict = {}  # one scale for a parameter across the layers, as for its stacked leaf
        for k, xf in xs.items():
            m = xf.abs().max()
            peak[_stacked(k)] = torch.maximum(peak[_stacked(k)], m) if _stacked(k) in peak else m
        new_g, new_ef = {}, {}
        for k, xf in xs.items():
            scale = torch.clamp(peak[_stacked(k)], min=1e-12) / 127.0
            qi = torch.clamp(torch.round(xf / scale), -127, 127).to(torch.int16)
            deq = qi.to(F32) * scale
            new_g[k], new_ef[k] = deq, xf - deq
        return new_g, new_ef
    raise ValueError(how)


def make_train_step(cfg, opts: TrainOptions = TrainOptions()):
    """Returns ``train_step(model, opt, batch) -> (model, opt, metrics)``."""

    def train_step(model, opt: dict, batch: dict):
        with obs.span("rt.train.step"):
            with obs.span("rt.train.grads"):
                loss, metrics, grads = _grads(model, cfg, batch, opts)
            grads, new_ef = _compress_grads(grads, opts.grad_compress, opt.get("ef"))
            with obs.span("rt.train.nan_gate"):  # the host waits here for the step's device work
                finite = bool(torch.isfinite(loss))
            if finite:
                with obs.span("rt.train.adamw"):
                    _p, new_opt, om = adamw_update(opts.adamw, grads, opt, dict(model.named_parameters()))
                if new_ef is not None:
                    new_opt["ef"] = new_ef
                opt = new_opt
            else:  # the NaN gate: nothing is applied
                om = {"grad_norm": global_norm(grads), "lr": schedule(opts.adamw, opt["step"] + 1)}
        return model, opt, dict(metrics, **om)

    return train_step


def init_train_state(gen: torch.Generator, cfg, opts: TrainOptions = TrainOptions(), device="cuda"):
    """(model, opt): a model of ``cfg`` with weights drawn from ``gen`` on
    ``device`` (the card unless the caller asks for the CPU), and zero
    optimizer state."""
    model = lm.init_params(gen, cfg, device=device)
    params = dict(model.named_parameters())
    opt = adamw_init(params)
    if opts.grad_compress == "int16_ef":
        opt["ef"] = {k: torch.zeros_like(p, dtype=F32) for k, p in params.items()}
    return model, opt
