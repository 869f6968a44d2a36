"""The benchmark's weights: made from the seed on the run's device, in f32
(the type the system keeps its parameters in), in one draw for all the
random parameters. The same weights go to the system under test (copied
into its model by name) and to the plain reference."""

from __future__ import annotations

import math

import torch


def make(spec: list, seed: int, device) -> dict:
    """{name: f32 tensor} of a reference's ``param_spec``: one normal draw
    from a generator seeded with ``seed`` on ``device``, cut into the
    random parameters in spec order and scaled; the rest are constants."""
    n = sum(math.prod(shape) for _name, shape, how, _arg in spec if how == "normal")
    gen = torch.Generator(device=device).manual_seed(seed)
    flat = torch.randn(n, generator=gen, dtype=torch.float32, device=device)
    out, at = {}, 0
    for name, shape, how, arg in spec:
        if how == "normal":
            size = math.prod(shape)
            out[name] = flat[at:at + size].view(shape).mul_(arg)
            at += size
        elif how == "zeros":
            out[name] = torch.zeros(shape, device=device)
        elif how == "ones":
            out[name] = torch.ones(shape, device=device)
        elif how == "const":
            out[name] = torch.full(shape, arg, device=device)
        elif how == "log_linspace":
            out[name] = torch.log(torch.linspace(arg[0], arg[1], shape[0], device=device))
        else:
            raise ValueError(f"{name}: unknown init {how!r}")
    return out


@torch.no_grad()
def load_into(model: torch.nn.Module, weights: dict) -> None:
    """Copy ``weights`` into the model's parameters, which must have the
    same names and shapes, before the model's first forward."""
    params = dict(model.named_parameters())
    if set(params) != set(weights):
        raise ValueError(f"the model's parameters and the benchmark's differ: "
                         f"{sorted(set(params) ^ set(weights))[:8]}")
    for name, p in params.items():
        if tuple(p.shape) != tuple(weights[name].shape):
            raise ValueError(f"{name}: the model has {tuple(p.shape)}, the benchmark {tuple(weights[name].shape)}")
        p.copy_(weights[name])
