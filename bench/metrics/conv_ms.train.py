"""Device milliseconds a traced step put down to the program's
``rt.ssm.conv`` span: the Mamba2 mixer's two 4-tap causal convolutions and
their SiLU, counting the forward, the remat's recompute and the backward
(``bench/program_spans.py``)."""

from bench import program_spans


def read(rec):
    return program_spans.device_ms(rec, "rt.ssm.conv")
