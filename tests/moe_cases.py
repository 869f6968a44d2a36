"""The MoE router's decisions, recorded in one run and replayed in another,
shared by tests/test_torch_lm.py, tests/test_torch_kernels.py and
chip_smoke.py (imports only the port, so it runs where JAX is not
installed).

Two runs of the same model whose activations differ by rounding (bf16 on
the card against the CPU, or eager torch against XLA) can route a token to
other experts: where the k-th and the (k+1)-th router logits lie closer
together than the two runs' logits differ, each run picks its own. The
token's MoE output then moves by O(1), past any rounding tolerance. So a
comparison of such runs replays the first run's experts in the second
(:func:`replayed`) and holds every other number to its tolerance, and it
checks that each routing decision that differed is such a near tie: the
gap between the second run's k-th largest logit and its smallest logit
among the first run's experts is at most twice the largest difference of
the two runs' logits on that row (the most two rankings of logits that
differ by at most δ can disagree by is 2δ), plus 1e-6 of the logit for
ties that softmax's rounding makes or breaks.
"""

from __future__ import annotations

import contextlib

import torch

from repro_torch.models import moe as M


@contextlib.contextmanager
def recorded(log: list):
    """Within the block, each call of the port's ``moe.route`` appends
    (router logits f32 (B, S, E), top_e (B, S, k)) to ``log``, on the
    device they were made on."""
    orig = M.route

    def rec(p, x, cfg):
        probs, w, e = orig(p, x, cfg)
        log.append(((x @ p["router"].to(x.dtype)).float(), e))
        return probs, w, e

    M.route = rec  # moe_apply looks route up in the module at each call
    try:
        yield log
    finally:
        M.route = orig


@contextlib.contextmanager
def replayed(log: list, stats: dict):
    """Within the block, the port's ``moe.route`` routes call i to the
    experts of ``log[i]`` (another run's routing, :func:`recorded` or the
    JAX package's), with the weights its own probabilities give those
    experts. ``stats`` gets ``decisions`` (tokens routed), ``agreed``
    (tokens whose own top-k set equals the replayed one) and ``worst``
    (the largest gap of a differing token over its 2δ bound, <= 1 when
    every difference is a near tie). Raises AssertionError on a
    difference that is no near tie, or when the calls outnumber ``log``."""
    orig = M.route
    calls = iter(log)
    stats.update(decisions=0, agreed=0, worst=0.0)

    def rep(p, x, cfg):
        entry = next(calls, None)
        assert entry is not None, "more MoE calls than recorded"
        ref_logits, ref_e = (t.to(x.device) for t in entry)
        probs, _w, own_e = orig(p, x, cfg)
        ref_e = ref_e.to(own_e.dtype)
        assert ref_e.shape == own_e.shape, (ref_e.shape, own_e.shape)
        logits = (x @ p["router"].to(x.dtype)).float()
        same = (torch.sort(own_e, dim=-1).values == torch.sort(ref_e, dim=-1).values).all(-1)
        stats["decisions"] += same.numel()
        stats["agreed"] += int(same.sum())
        if not bool(same.all()):
            kth = torch.gather(logits, -1, own_e).amin(-1)
            low = torch.gather(logits, -1, ref_e).amin(-1)
            delta = (logits - ref_logits.float()).abs().amax(-1)
            slack = 2 * delta + 1e-6 * kth.abs()
            ratio = ((kth - low) / torch.clamp(slack, min=1e-30))[~same]
            stats["worst"] = max(stats["worst"], float(ratio.max()))
            assert bool((ratio <= 1).all()), f"a routing difference that is no near tie: {stats}"
        w = torch.gather(probs, -1, ref_e)
        return probs, w / torch.clamp(w.sum(-1, keepdim=True), min=1e-9), ref_e

    M.route = rep
    try:
        yield stats
    finally:
        M.route = orig
    assert next(calls, None) is None, "fewer MoE calls than recorded"


def dropped_share(log: list, cfg) -> float:
    """The share of (token, choice) pairs that the recorded calls' dispatch
    dropped past capacity."""
    drops = sum(int(M.dropped_pairs(e, cfg)) for _l, e in log)
    return drops / max(1, sum(e.numel() for _l, e in log))
