"""Reformat (B3 k-mer, B4 one-hot) of the PyTorch port against the JAX
package's Pallas kernels in interpret mode: bit identity on tokens that
contain N / PAD, ragged C, every k of 1..8, with and without n_tokens."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core.api import kmer_pack as ref_kmer_plain
from repro.core.api import one_hot_bases as ref_one_hot_plain
from repro.kernels.reformat import kmer_pack_pallas, one_hot_pallas

from repro_torch.core import api
from repro_torch.core.decode_torch import reset_trace_counts, trace_counts
from repro_torch.kernels import reformat as RF

C_RAGGED = 1001  # not a multiple of 2..8 or of 16


def _tokens(seed, nb=4, C=C_RAGGED):
    rng = np.random.default_rng(seed)
    toks = rng.integers(0, 4, (nb, C)).astype(np.int8)
    toks[rng.random((nb, C)) < 0.03] = 4  # in-read N
    ntok = np.array([C, C - 37, C // 2, 0][:nb], np.int32)
    for b, n in enumerate(ntok):
        toks[b, n:] = 4  # PAD tail
    return toks, ntok


@pytest.mark.parametrize("with_ntok", [False, True], ids=["pad-only", "n_tokens"])
@pytest.mark.parametrize("k", range(1, 9))
def test_kmer_pack_matches_pallas(k, with_ntok):
    toks, ntok = _tokens(k)
    nt = ntok if with_ntok else None
    theirs = np.asarray(kmer_pack_pallas(jnp.asarray(toks), k, None if nt is None else jnp.asarray(nt), interpret=True))
    ours = api.kmer_pack(torch.as_tensor(toks), k, None if nt is None else torch.as_tensor(nt))
    assert ours.dtype == torch.int32 and ours.shape == (toks.shape[0], C_RAGGED // k)
    np.testing.assert_array_equal(ours.numpy(), theirs)
    np.testing.assert_array_equal(
        ours.numpy(), np.asarray(ref_kmer_plain(jnp.asarray(toks), k, None if nt is None else jnp.asarray(nt)))
    )
    if with_ntok:  # N inside a read is the N-block id, never the pad id
        sp = api.kmer_special_ids(k)
        assert (ours.numpy() == sp["nblk"]).any() and (ours.numpy() == sp["pad"]).any()


@pytest.mark.parametrize("shape", [(1, 64), (4, C_RAGGED), (2, 4096), (0, 77)])
def test_one_hot_matches_pallas(shape):
    rng = np.random.default_rng(shape[1])
    toks = rng.integers(0, 5, shape).astype(np.int8)
    ours = api.one_hot_bases(torch.as_tensor(toks))
    assert ours.dtype == torch.bfloat16 and tuple(ours.shape) == shape + (4,)
    theirs = np.asarray(one_hot_pallas(jnp.asarray(toks), interpret=True), np.float32)
    np.testing.assert_array_equal(ours.float().numpy(), theirs)
    np.testing.assert_array_equal(ours.float().numpy(), np.asarray(ref_one_hot_plain(jnp.asarray(toks)), np.float32))


def test_zero_blocks_give_empty_outputs():
    toks = torch.zeros((0, 1001), dtype=torch.int8)
    for k in (1, 4, 8):
        out = api.kmer_pack(toks, k, torch.zeros((0,), dtype=torch.int32))
        assert out.shape == (0, 1001 // k)
        assert np.asarray(kmer_pack_pallas(jnp.zeros((0, 1001), jnp.int8), k, interpret=True)).shape == out.shape


def test_wrappers_route_cpu_to_plain_and_check_inputs():
    toks, ntok = _tokens(3)
    reset_trace_counts()
    RF.kmer_pack(torch.as_tensor(toks), 4, torch.as_tensor(ntok))
    RF.one_hot(torch.as_tensor(toks))
    assert trace_counts() == {"plain:kmer_pack": 1, "plain:one_hot": 1}
    with pytest.raises(ValueError, match="k must be"):
        RF.kmer_pack(torch.as_tensor(toks), 16)  # ids past 4**15 + 2 overflow int32
    with pytest.raises(ValueError, match="int8"):
        RF.one_hot(torch.as_tensor(toks).to(torch.int32))
