"""Host layer of the PyTorch port against the JAX package: the container
reader and writer, the sequential encoder, and the state carried across.

Everything here is numpy on both sides, so the bar is byte identity."""

import dataclasses

import numpy as np
import pytest

import repro.core.encoder as ref_encoder
import repro.core.layout as ref_layout
from repro.core.format import SageFile as RefSageFile
from repro.genomics.synth import make_reference, sample_read_set

import repro_torch.core.layout as pt_layout
from repro_torch.convert import device_blocks_from_reference, sage_file_from_reference
from repro_torch.core.encoder import SageEncoder as PtEncoder
from repro_torch.core.format import SageFile
from repro_torch.genomics.synth import ReadSet

from torch_cases import encoded_case


@pytest.fixture(scope="module")
def illumina_encoded():
    return encoded_case("illumina")


def assert_same_file(a, b):
    assert a.meta.to_json() == b.meta.to_json()
    np.testing.assert_array_equal(np.asarray(a.consensus2b), np.asarray(b.consensus2b))
    np.testing.assert_array_equal(np.asarray(a.directory), np.asarray(b.directory))
    assert sorted(a.streams) == sorted(b.streams)
    for k in a.streams:
        np.testing.assert_array_equal(np.asarray(a.streams[k]), np.asarray(b.streams[k]), err_msg=k)


def _write_reference(sf, path, kind):
    if kind == "v1":
        sf.save(path)
    else:
        kw = {"raw_v2": dict(codec=False, align=512), "codec_v2": {},
              "parity_v2": dict(parity="xor", parity_group=4)}[kind]
        ref_layout.write_v2(sf, path, **kw)


@pytest.mark.parametrize("kind", ["v1", "raw_v2", "codec_v2", "parity_v2"])
def test_reader_byte_identical_to_reference(illumina_encoded, tmp_path, kind):
    _, sf = illumina_encoded
    path = tmp_path / ("ds.npz" if kind == "v1" else "ds.sage2")
    _write_reference(sf, path, kind)
    assert pt_layout.container_version(path) == ref_layout.container_version(path)
    ours = pt_layout.open_container(path)
    theirs = ref_layout.open_container(path)
    if kind == "v1":
        assert_same_file(ours, theirs)
        return
    ids = np.array([0, 3, 4, 5, sf.meta.n_blocks - 1])
    np.testing.assert_array_equal(ours.directory, theirs.directory)
    assert ours.meta.to_json() == theirs.meta.to_json()
    a, b = ours.gather_block_arrays(ids), theirs.gather_block_arrays(ids)
    assert sorted(a) == sorted(b)
    for k in a:
        np.testing.assert_array_equal(a[k], b[k], err_msg=k)
        assert a[k].dtype == b[k].dtype
    if kind != "raw_v2":
        np.testing.assert_array_equal(ours.gather_packed(ids), theirs.gather_packed(ids))
        np.testing.assert_array_equal(
            ours.gather_consensus_windows(ids), theirs.gather_consensus_windows(ids)
        )
        np.testing.assert_array_equal(np.asarray(ours._codec_dicts), np.asarray(theirs._codec_dicts))
    assert_same_file(ours.to_sage_file(), theirs.to_sage_file())


@pytest.mark.parametrize("kw", [dict(), dict(codec=False, align=512), dict(parity="xor", parity_group=4)],
                         ids=["codec", "raw", "parity"])
def test_writer_output_identical_and_readable_by_reference(illumina_encoded, tmp_path, kw):
    _, sf = illumina_encoded
    ours, theirs = tmp_path / "pt.sage2", tmp_path / "ref.sage2"
    st_pt = pt_layout.write_v2(sage_file_from_reference(sf), ours, **kw)
    st_ref = ref_layout.write_v2(sf, theirs, **kw)
    assert st_pt == st_ref
    assert ours.read_bytes() == theirs.read_bytes()
    assert_same_file(ref_layout.SageContainerV2.open(ours).to_sage_file(), sf)


def test_lockstep_crc_matches_reference_crc():
    rng = np.random.default_rng(5)
    bufs = [rng.integers(0, 256, n, dtype=np.uint8) for n in (0, 1, 3, 64, 1000, 4099, 17)]
    got = [int(c) for c in pt_layout._crc32c_lockstep(bufs)]
    assert got == [ref_layout.crc32c(b) for b in bufs]
    assert pt_layout.crc32c_many(bufs) == got


ENCODER_SETS = {
    "illumina": dict(profile="illumina", depth=2, seed=41),
    "ont": dict(profile="ont", depth=1, max_reads=4, seed=42),
}


@pytest.mark.parametrize("name", sorted(ENCODER_SETS))
def test_sequential_encoder_writes_reference_sage_file(name):
    ref = make_reference(20_000, seed=40)
    kw = dict(ENCODER_SETS[name])
    rs = sample_read_set(ref, kw.pop("profile"), **kw)
    theirs = ref_encoder.SageEncoder(ref, token_target=4096, batched=False).encode(rs)
    pt_rs = ReadSet(reads=rs.reads, quals=rs.quals, kind=rs.kind, profile=rs.profile)
    ours = PtEncoder(ref, token_target=4096, batched=False).encode(pt_rs)
    assert isinstance(ours, SageFile)
    assert_same_file(ours, theirs)


def test_batched_encoder_not_ported(monkeypatch):
    """The batched encoder is ported (tests/test_torch_encode.py); it is the
    default, runs on the card, and without one raises unless told the CPU:
    it never falls back to the sequential path."""
    import torch

    ref = make_reference(4000, seed=1)
    rs = sample_read_set(ref, "illumina", depth=1, seed=2)
    pt_rs = ReadSet(reads=rs.reads, quals=rs.quals, kind=rs.kind, profile=rs.profile)
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    enc = PtEncoder(ref, token_target=4096)
    assert enc.batched
    with pytest.raises(RuntimeError, match="cuda"):
        enc.encode(pt_rs)
    assert "n_batch_mapped" not in enc.stats
    ours = PtEncoder(ref, token_target=4096, device="cpu").encode(pt_rs)
    assert_same_file(ours, ref_encoder.SageEncoder(ref, token_target=4096).encode(rs))


def test_state_conversion_round_trip(illumina_encoded):
    from repro.core.decode_jax import prepare_device_blocks

    _, sf = illumina_encoded
    ours = sage_file_from_reference(sf)
    assert isinstance(ours, SageFile) and not isinstance(ours, RefSageFile)
    assert_same_file(ours, sf)
    db_ref = prepare_device_blocks(sf)
    db = device_blocks_from_reference(db_ref, "cpu")
    assert db.n_blocks == db_ref.n_blocks and db.fixed_len == db_ref.fixed_len
    assert dataclasses.asdict(db.caps) == dataclasses.asdict(db_ref.caps)
    for k, v in db_ref.arrays.items():
        got = db.arrays[k].numpy()
        np.testing.assert_array_equal(got.view(v.dtype), v, err_msg=k)
