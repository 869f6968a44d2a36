"""One training step of the port on the card held against the same step on
the CPU, shared by tests/test_torch_kernels.py and chip_smoke.py (imports
only the port, so it runs where JAX is not installed).

The step runs with f32 activations (``f32_forward``), so the card and the
CPU differ only by the order of f32 sums, not by where bf16 rounds. The
bounds, per leaf of the JAX package's layout (``train_state_to_reference``):

* loss and grad_norm within 1e-4 relative;
* m and v within 1e-4·max|leaf| (after one step m = (1-b1)·ĝ and
  v = (1-b2)·ĝ², ĝ the clipped gradient);
* each parameter within 1e-4·max|leaf| plus AdamW's own amplification of
  the gradient's error: the first step moves p by lr·ĝ/(|ĝ| + eps), whose
  slope in ĝ is eps/(|ĝ| + eps)², so a gradient error of up to
  τ = 1e-4·max|ĝ| moves p by up to lr·min(2, τ·eps/(|ĝ| + eps)²). Where
  |ĝ| is many eps, that term vanishes; near ĝ = 0 the sign decides.

Where the host cannot hold two f32 train states of a cut (qwen2-vl-72b:
3.37 B parameters a layer-1 cut, ~54 GB each with AdamW's moments),
``grads_of`` / ``compare_grads`` hold the loss and each gradient leaf,
with no AdamW, to the same 1e-4 (relative, and of max|leaf|).
"""

from __future__ import annotations

import contextlib
import copy
import dataclasses
import functools
from typing import Optional

import numpy as np
import torch

from repro_torch.checkpoint.checkpoint import _flatten
from repro_torch.convert import train_state_to_reference
from repro_torch.models import lm
from repro_torch.training import steps as TS
from repro_torch.training.optimizer import AdamWConfig, adamw_init

TOL = 1e-4
ADAMW = AdamWConfig(lr=1e-3, warmup_steps=2, total_steps=8)


@contextlib.contextmanager
def f32_forward():
    """The train step's forward in f32 activations (its default is bf16)."""
    orig = lm.forward
    lm.forward = functools.partial(orig, dtype=torch.float32)
    try:
        yield
    finally:
        lm.forward = orig


def cut_batch(cfg, batch: int, seq: int, seed: int) -> dict:
    """(tokens, labels) int32 from a seeded numpy draw, as the pipeline
    yields them; the vlm family's ``seq`` is split as the JAX package's
    specs split it, int(seq·img_frac) patch embeddings and the rest tokens,
    and the encdec family takes ``seq`` frames beside ``seq`` tokens (f32
    standard normal draws)."""
    r = np.random.default_rng(seed)
    n_img = int(seq * cfg.img_frac) if cfg.family == "vlm" else 0
    t = r.integers(0, cfg.vocab, (batch, seq - n_img + 1)).astype(np.int32)
    out = {"tokens": t[:, :-1], "labels": t[:, 1:]}
    if cfg.family == "vlm":
        out["patch_embeds"] = r.standard_normal((batch, n_img, cfg.d_model)).astype(np.float32)
    if cfg.family == "encdec":
        out["frames"] = r.standard_normal((batch, seq, cfg.d_model)).astype(np.float32)
    return out


def one_step(cfg, model, batch: dict, dev) -> tuple[dict, dict]:
    """One ``make_train_step`` (remat on, f32 activations) on ``dev`` from
    zero AdamW state; returns (metrics as floats, the state as flat
    {name: host array} in the JAX package's layout)."""
    opts = TS.TrainOptions(adamw=ADAMW)
    opt = adamw_init(dict(model.named_parameters()))
    with f32_forward():
        model, opt, m = TS.make_train_step(cfg, opts)(
            model, opt, {k: torch.as_tensor(v).to(dev) for k, v in batch.items()})
    return {k: float(v) for k, v in m.items()}, dict(_flatten(train_state_to_reference(cfg, model, opt)))


def whole_state(cfg, model, opt) -> dict:
    """The train state as ``one_step`` gives it (flat {name: host array} in
    the JAX package's layout), DTensor parameters and moments (tensor
    parallelism) gathered whole: every rank calls it."""
    import types

    from repro_torch.distributed.sharding import full_params, is_dtensor

    def whole(t):
        return (t.full_tensor() if is_dtensor(t) else t).detach()

    plain = types.SimpleNamespace(named_parameters=lambda: full_params(model).items())
    o = {k: {n: whole(t) for n, t in opt[k].items()} for k in ("m", "v")}
    o["step"] = opt["step"]
    return {k: np.array(v) for k, v in _flatten(train_state_to_reference(cfg, plain, o))}  # copies: opt moves in place


def compare_step(card: tuple[dict, dict], cpu: tuple[dict, dict], dev="cpu", step: int = 1,
                 lr_sum: Optional[float] = None) -> dict:
    """Hold the card's step against the CPU's (bounds in the module
    docstring); returns the errors, raises AssertionError past a bound.
    After ``step`` steps from the same state (the metrics those of the last
    step), AdamW's term takes ``lr_sum``, the sum of the steps' learning
    rates (default: the last step's), as
    tests/test_torch_distributed.py's ``dp_close`` does.
    The leaves are compared as f32 tensors (their own dtype; a difference
    of two f32 values and the bounds lose nothing that matters at 1e-4)
    on ``dev``: a full-width cut holds ~1.5e9 values, which the card
    compares in a fraction of the host's time (the same elementwise f32
    arithmetic and exact maxima on either device)."""
    (mc, sc), (mp, sp) = card, cpu
    out = {"tol": TOL, "loss": [mc["loss"], mp["loss"]], "grad_norm": [mc["grad_norm"], mp["grad_norm"]]}
    for k in ("loss", "grad_norm"):
        assert abs(mc[k] - mp[k]) <= TOL * abs(mp[k]), (k, mc[k], mp[k])
    assert sorted(sc) == sorted(sp)
    lr, eps, b1 = mp["lr"] if lr_sum is None else lr_sum, ADAMW.eps, ADAMW.b1
    worst = {}
    for k in sp:
        if k == "opt/step":
            assert int(sc[k]) == int(sp[k]) == step
            continue
        a, b = (torch.from_numpy(np.require(x, np.float32, ["W"])).to(dev) for x in (sc[k], sp[k]))
        top = float(b.abs().max())
        bound = torch.full_like(b, TOL * top)
        if k.startswith("params/"):
            g = torch.from_numpy(np.require(sp["opt/m/" + k[len("params/"):]], np.float32, ["W"])).to(dev) / (1 - b1)
            tau = TOL * float(g.abs().max())
            bound += lr * torch.clamp(tau * eps / (g.abs() + eps) ** 2, max=2.0)
        err = (a - b).abs()
        worst[k] = float(err.max()) / max(top, 1e-30)
        over = err > bound
        assert not bool(over.any()), f"{k}: max err {float(err.max())}, over its bound at {int(over.sum())} elements"
    out["max_rel_err_by_leaf"] = dict(sorted(worst.items(), key=lambda kv: -kv[1])[:6])
    return out


def grads_of(cfg, model, batch: dict, dev) -> tuple[float, dict]:
    """The loss and every parameter's gradient (a dict by name, on ``dev``)
    of ``batch`` on ``dev``, as ``make_train_step`` takes them (remat on,
    f32 activations), with no optimizer."""
    with f32_forward():
        loss, _m, g = TS._grads(model, cfg, {k: torch.as_tensor(v).to(dev) for k, v in batch.items()},
                                TS.TrainOptions(adamw=ADAMW))
    return float(loss), g


def compare_grads(card: tuple[float, dict], cpu: tuple[float, dict], dev="cpu") -> dict:
    """Hold the card's loss and gradients against the CPU's: the loss within
    1e-4 relative, each leaf within 1e-4·max|leaf| (compared on ``dev``);
    returns the errors, raises AssertionError past a bound."""
    (lc, gc), (lp, gp) = card, cpu
    assert abs(lc - lp) <= TOL * abs(lp), (lc, lp)
    assert sorted(gc) == sorted(gp)
    worst = {}
    for k in gp:
        a, b = gc[k].to(dev), gp[k].to(dev)
        top = float(b.abs().max())
        err = float((a - b).abs().max())
        worst[k] = err / max(top, 1e-30)
        assert err <= TOL * top, f"{k}: max err {err} > {TOL} x {top}"
    return {"tol": TOL, "loss": [lc, lp], "max_rel_err_by_leaf": dict(sorted(worst.items(), key=lambda kv: -kv[1])[:6])}


def cut_models(cfg, layers: int, dev, seed: int):
    """A ``layers``-deep cut of ``cfg`` at full width on ``dev`` (the
    encdec family's encoder cut to ``layers`` too) and a copy of it, the
    same weights, on the CPU."""
    cut = dataclasses.replace(cfg, n_layers=layers, **({"n_enc_layers": layers} if cfg.family == "encdec" else {}))
    m_dev = lm.init_params(torch.Generator(device=dev).manual_seed(seed), cut, device=dev)
    return cut, m_dev, copy.deepcopy(m_dev).to("cpu")
