"""Small encoded read sets shared by the PyTorch-port tests.

Encoded once per process with the JAX package's sequential encoder (no jit
compiles), small enough that every port test file stays well under a
minute. The illumina set carries escape (corner) reads; ont and hifi carry
the indel, multi-base and insertion paths."""

import functools

import numpy as np
import torch

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


def np_out(d):
    """A result dict as numpy arrays (bf16 widened to float32)."""
    out = {}
    for k, v in d.items():
        if isinstance(v, torch.Tensor):
            v = v.float().numpy() if v.dtype == torch.bfloat16 else v.numpy()
        else:
            v = np.asarray(v)
            if v.dtype.name == "bfloat16":
                v = v.astype(np.float32)
        out[k] = v
    return out


def assert_same(ours, theirs):
    """Same keys, shapes and values, bit for bit."""
    a, b = np_out(ours), np_out(theirs)
    assert sorted(a) == sorted(b)
    for k in a:
        assert a[k].shape == b[k].shape, k
        np.testing.assert_array_equal(a[k], b[k], err_msg=k)
