"""Device milliseconds a traced step put down to the torch work around B6
in the SSD: ``rt.ssm.ssd_prep`` (B and C repeated over heads, the f32
casts and copies before B6) and ``rt.ssm.ssd_state`` (the state loop
across chunks, ``y_state``, the sum and the D skip), counting the forward,
the remat's recompute and the backward (``bench/program_spans.py``)."""

from bench import program_spans


def read(rec):
    return program_spans.device_ms(rec, "rt.ssm.ssd_prep", "rt.ssm.ssd_state")
