"""Device milliseconds a traced step put down to the program's
``rt.ssm.gate_norm`` span: the mixer's ``y * silu(z)`` gate and its f32
RMSNorm, counting the forward, the remat's recompute and the backward
(``bench/program_spans.py``)."""

from bench import program_spans


def read(rec):
    return program_spans.device_ms(rec, "rt.ssm.gate_norm")
