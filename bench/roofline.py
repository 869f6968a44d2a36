"""The benchmark's yardstick for rooflines and MFU: published peaks of one
NVIDIA H100 SXM (data sheet, dense rates, at its 700 W limit) and the
operations and bytes of the work, counted from shapes. Nothing here reads
the program's own estimates (``launch/op_cost.py``)."""

from __future__ import annotations

import importlib

HBM_BYTES_PER_S = 3.35e12  #: HBM3
BF16_FLOPS = 989e12  #: dense bf16 tensor-core rate, the MFU peak
TF32_FLOPS = 495e12
B6_OPS_PER_S = TF32_FLOPS / 3  #: B6's f32-accurate route: three TF32 products (3xTF32) a product


def bound(nbytes: int, ops: int, ops_per_s: float) -> tuple[float, str]:
    """(least milliseconds, what bounds it): bytes over HBM_BYTES_PER_S or
    operations over ``ops_per_s``, the larger. A frozen copy of
    ``chip_smoke.py``'s ``bound`` with the rate given."""
    t_b, t_o = nbytes / HBM_BYTES_PER_S * 1e3, ops / ops_per_s * 1e3
    return (t_b, "bytes") if t_b >= t_o else (t_o, "operations")


def ssd_bound(shape, x_bytes: int) -> tuple[float, str]:
    """B6 forward's least time for one launch at ``shape`` = (batch, chunks,
    Q, heads, P, N): x, dt, a, B, C read once, y, the chunk state and the
    total written once; Q(Q+1)N + Q(Q+1)P + 2QNP f32 operations a (b, chunk,
    head) (C.B^T and M.(x dt) need only their causal half, the state 2QNP)
    at B6_OPS_PER_S. A frozen copy of ``chip_smoke.py``'s ``ssd_bound``."""
    Bb, nc, Q, H, P, N = shape
    rows = Bb * nc * Q * H
    nbytes = 2 * rows * P * x_bytes + 2 * rows * 4 + 2 * rows * N * 4 + Bb * nc * H * (P * N + 1) * 4
    ops = Bb * nc * H * (Q * (Q + 1) * N + Q * (Q + 1) * P + 2 * Q * N * P)
    return bound(nbytes, ops, B6_OPS_PER_S)


def ssd_bwd_bound(shape, x_bytes: int) -> tuple[float, str]:
    """B6 backward's least time for one launch: x, dy, dt, a, B, C, dst and
    dtotal read once, dx, ddt, da, dB and dC written once;
    3Q(Q+1)N + 2Q(Q+1)P + 4QNP f32 operations a (b, chunk, head) at
    B6_OPS_PER_S. A frozen copy of ``chip_smoke.py``'s ``ssd_bwd_bound``."""
    Bb, nc, Q, H, P, N = shape
    rows = Bb * nc * Q * H
    nbytes = 3 * rows * P * x_bytes + 4 * rows * 4 + 4 * rows * N * 4 + Bb * nc * H * (P * N + 1) * 4
    ops = Bb * nc * H * (3 * Q * (Q + 1) * N + 2 * Q * (Q + 1) * P + 4 * Q * N * P)
    return bound(nbytes, ops, B6_OPS_PER_S)


def ssd_shape(cfg: dict, batch: int, seq: int) -> tuple:
    """B6's launch shape for a (batch, seq) input of configuration ``cfg``."""
    Q = min(cfg["ssm_chunk"], seq)
    return (batch, -(-seq // Q), Q, cfg["d_inner"] // cfg["ssm_headdim"], cfg["ssm_headdim"], cfg["ssm_state"])


def mamba2_layer_flops(cfg: dict, batch: int, seq: int) -> int:
    """A Mamba2 block's forward model FLOPs: its projections (2 a weight a
    token) and the SSD as the chunked algorithm needs it, the intra-chunk
    causal products, the chunk states and their read-out (no elementwise
    work)."""
    d, di, H = cfg["d_model"], cfg["d_inner"], cfg["d_inner"] // cfg["ssm_headdim"]
    gn = 2 * cfg["ssm_groups"] * cfg["ssm_state"]
    proj = 2 * batch * seq * (d * (2 * di + gn + H) + di * d)
    Bb, nc, Q, H, P, N = ssd_shape(cfg, batch, seq)
    ssd = Bb * nc * H * (Q * (Q + 1) * N + Q * (Q + 1) * P + 4 * Q * N * P)
    return proj + ssd


def forward_flops(cfg: dict, batch: int, seq: int) -> int:
    """Model FLOPs of one forward pass over (batch, seq) tokens, products
    only, the head's product at every position: the ``forward_flops`` of
    the family's plain reference, ``bench/reference/<family>.py``, which
    counts from the sizes it runs."""
    family = cfg["family"]
    count = getattr(importlib.import_module(f"bench.reference.{family}"), "forward_flops", None)
    if count is None:
        raise ValueError(f"bench/reference/{family}.py has no forward_flops(cfg, batch, seq): "
                         f"no FLOP count for the {family} family")
    return count(cfg, batch, seq)


def train_step_flops(cfg: dict, batch: int, seq: int) -> int:
    """Forward and backward (twice the forward), no recomputation."""
    return 3 * forward_flops(cfg, batch, seq)
