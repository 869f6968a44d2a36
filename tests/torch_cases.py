"""Small encoded read sets shared by the PyTorch-port tests.

Encoded once per process with the JAX package's sequential encoder (no jit
compiles), small enough that every port test file stays well under a
minute. The illumina set carries escape (corner) reads; ont and hifi carry
the indel, multi-base and insertion paths."""

import functools

from repro.core.encoder import SageEncoder
from repro.genomics.synth import make_reference, sample_read_set

PROFILES = ("illumina", "ont", "hifi")
_CASES = {
    "illumina": (dict(depth=3, seed=12), 4096),
    "ont": (dict(depth=1, max_reads=5, seed=11), 8192),
    "hifi": (dict(depth=1, max_reads=4, seed=11), 8192),
}


@functools.lru_cache(maxsize=None)
def reference():
    return make_reference(30_000, seed=3)


@functools.lru_cache(maxsize=None)
def encoded_case(profile: str):
    """(read set, JAX-package SageFile) for ``profile``."""
    kw, token_target = _CASES[profile]
    rs = sample_read_set(reference(), profile, **kw)
    sf = SageEncoder(reference(), token_target=token_target, batched=False).encode(rs)
    return rs, sf
