"""Block decode (B2) of the PyTorch port against the JAX package, on the
illumina / ont / hifi cases of torch_cases.py.

The port's plain versions run here (CPU tensors); the JAX side runs its
vmap decoder and its Pallas kernels in interpret mode. Integer paths, so
the bar is bit identity."""

import jax
import numpy as np
import pytest
import torch

from repro.core.decode_jax import (
    decode_blocks_bucketed as ref_bucketed,
    decode_file_jax,
    pad_block_ids as ref_pad_block_ids,
    prepare_device_blocks as ref_prepare,
)
from repro.kernels.sage_decode import sage_decode_arrays as ref_pallas_decode

from repro_torch.convert import device_blocks_from_reference
from repro_torch.core import decode_torch as DT
from repro_torch.kernels import sage_decode as SD

from conftest import multiset
from torch_cases import PROFILES, encoded_case

KEYS = ("tokens", "n_tokens", "read_pos", "read_rev", "read_start", "read_len",
        "read_corner", "n_reads")


def np_tree(d):
    return {k: np.asarray(v) for k, v in d.items()}


def assert_same(ours: dict, theirs: dict, keys=KEYS):
    for k in keys:
        a = ours[k].numpy() if isinstance(ours[k], torch.Tensor) else np.asarray(ours[k])
        b = np.asarray(theirs[k])
        assert a.shape == b.shape and a.dtype == b.dtype, (k, a.shape, b.shape, a.dtype, b.dtype)
        np.testing.assert_array_equal(a, b, err_msg=k)


@pytest.fixture(scope="module", params=PROFILES)
def encoded(request):
    return encoded_case(request.param)


def test_plain_decode_matches_vmap_and_oracle(encoded):
    rs, sf = encoded
    db_ref = ref_prepare(sf)
    theirs = np_tree(decode_file_jax(db_ref))
    db = device_blocks_from_reference(db_ref, "cpu")
    ours = DT.decode_block_arrays(db.arrays, caps=db.caps, classes=db.classes, fixed_len=db.fixed_len)
    assert_same(ours, theirs)
    got = []
    for bi in range(db.n_blocks):
        toks = ours["tokens"][bi].numpy()
        for r in range(int(ours["n_reads"][bi])):
            st, ln = int(ours["read_start"][bi, r]), int(ours["read_len"][bi, r])
            got.append(toks[st : st + ln].astype(np.uint8))
    assert multiset(got) == multiset(rs.reads)


def test_padded_bucket_matches_pallas_with_invalid_lanes(encoded):
    _, sf = encoded
    db_ref = ref_prepare(sf)
    nb = db_ref.n_blocks
    ids = np.array([nb - 1, 0, nb // 2][: max(1, min(3, nb))], dtype=np.int64)
    padded, valid = ref_pad_block_ids(ids)
    assert (valid == 0).any()
    sub_ref = {k: v[padded] for k, v in db_ref.arrays.items()}
    sub_ref["valid"] = valid[:, None].astype(np.int32)
    theirs = np_tree(ref_pallas_decode(sub_ref, caps=db_ref.caps, classes=db_ref.classes,
                                       fixed_len=db_ref.fixed_len, interpret=True))
    db = device_blocks_from_reference(db_ref, "cpu")
    sub = DT.gather_block_arrays(db, padded, valid)
    ours = SD.sage_decode_arrays(sub, caps=db.caps, classes=db.classes, fixed_len=db.fixed_len)
    assert_same(ours, theirs, SD.OUT_KEYS)
    lane = int(np.flatnonzero(valid == 0)[0])
    assert (ours["tokens"][lane] == DT.PAD_BASE).all()
    assert (ours["read_pos"][lane] == -1).all()


def test_invalid_lanes_do_not_depend_on_occupant(encoded):
    _, sf = encoded
    db = device_blocks_from_reference(ref_prepare(sf), "cpu")
    valid = np.array([1, 1, 0, 0], np.int32)
    outs = [DT.decode_blocks_padded(db, np.array([0, 0, occ, occ]), valid)
            for occ in (0, db.n_blocks - 1)]
    assert_same(outs[0], {k: v.numpy() for k, v in outs[1].items()})


def test_bucketed_decode_matches_reference(encoded):
    _, sf = encoded
    db_ref = ref_prepare(sf)
    db = device_blocks_from_reference(db_ref, "cpu")
    nb = db.n_blocks
    ids = (np.arange(5) * 7) % nb
    theirs = np_tree(ref_bucketed(db_ref.to_device(), ids))
    ours = DT.decode_blocks_bucketed(db, ids)
    assert_same(ours, theirs)
    empty = DT.decode_blocks_bucketed(db, np.array([], np.int64))
    assert_same(empty, np_tree(ref_bucketed(db_ref.to_device(), np.array([], np.int64))))


def test_substitution_scatter_targets_are_unique(encoded, monkeypatch):
    """sub_t is a scatter-SET: with two substitutions on one token the
    winner would be unspecified (and could differ between JAX, torch and
    CUDA). Assert the fixtures never hit that case."""
    _, sf = encoded
    db = device_blocks_from_reference(ref_prepare(sf), "cpu")
    orig = DT._scatter
    seen = []

    def checked(size, fill, idx, vals, reduce):
        if reduce == "set":
            for row in idx:
                kept = row[row < size]
                assert kept.unique().numel() == kept.numel()
            seen.append(int((idx < size).sum()))
        return orig(size, fill, idx, vals, reduce)

    monkeypatch.setattr(DT, "_scatter", checked)
    DT.decode_block_arrays(db.arrays, caps=db.caps, classes=db.classes, fixed_len=db.fixed_len)
    assert len(seen) == 1 and seen[0] > 0


def test_extract_fields_wraps_like_int32():
    """A 32-bit field >= 2**31 comes back negative (jnp int32 cast)."""
    import jax.numpy as jnp
    from repro.core.decode_jax import extract_fields as ref_extract

    words = np.array([0x89ABCDEF, 0xFEDCBA98, 0x01234567, 0x80000000], np.uint32)
    starts = np.array([0, 4, 31, 32, 64, 95, 96, 200, -5], np.int32)
    widths = np.array([32, 28, 32, 1, 32, 2, 0, 32, 32], np.int32)
    theirs = np.asarray(jax.jit(ref_extract)(jnp.asarray(words), jnp.asarray(starts), jnp.asarray(widths)))
    ours = DT.extract_fields(DT.host_to_tensor(words, "cpu"), torch.as_tensor(starts), torch.as_tensor(widths))
    np.testing.assert_array_equal(ours.numpy(), theirs)
    assert (theirs < 0).any()
