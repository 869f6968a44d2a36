"""The SAGe_ISP consumers of the PyTorch port against the JAX package, on the
CPU: the GenStore-EM exact-match filter, the Myers bit-vector bound, the
store-backed filter and the store-backed mapper, bit for bit on the
same decoded planes and containers."""

import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import SageStore as RefStore
from repro.core.bitio import unpack_2bit
from repro.core.decode_jax import decode_file_jax, prepare_device_blocks
from repro.core.format import D
from repro.core.layout import write_v2
from repro.genomics import filter_jax as FJ
from repro.genomics.mapper import map_store_reads as ref_map_store_reads

from repro_torch.core import SageStore
from repro_torch.genomics import filter_torch as FT
from repro_torch.genomics.mapper import map_store_reads

from torch_cases import encoded_case, reference

PLANES = ("tokens", "read_start", "read_len", "read_pos", "read_rev")


@pytest.fixture(scope="module")
def decoded_blocks():
    """Every block of the Illumina fixture decoded by the JAX package, with
    block-local read positions and consensus windows (numpy)."""
    _, sf = encoded_case("illumina")
    db = prepare_device_blocks(sf)
    out = {k: np.array(v) for k, v in decode_file_jax(db).items()}
    starts = db.arrays["dir"][:, D["cons_start"]].astype(np.int64)
    out["read_pos"] = np.where(out["read_pos"] >= 0, out["read_pos"] - starts[:, None], -1).astype(np.int32)
    wins = np.stack([unpack_2bit(db.arrays["cons"][b], db.caps.window).astype(np.int8)
                     for b in range(db.n_blocks)])
    return out, wins


@pytest.fixture(scope="module")
def codec_path(tmp_path_factory):
    _, sf = encoded_case("illumina")
    path = tmp_path_factory.mktemp("filter") / "ds.sage2"
    write_v2(sf, path)
    return str(path)


def stores(path):
    ours, theirs = SageStore(device="cpu", group_blocks=4), RefStore(group_blocks=4)
    ours.register("ds", path)
    theirs.register("ds", path)
    return ours, theirs


def ref_masks(planes, wins, n_reads=None):
    """JAX exact_match_mask (or filter_block, with ``n_reads``) block by block."""
    masks, counts = [], []
    for b in range(wins.shape[0]):
        dec = {k: jnp.asarray(planes[k][b]) for k in PLANES}
        if n_reads is None:
            masks.append(np.asarray(FJ.exact_match_mask(*(dec[k] for k in PLANES), jnp.asarray(wins[b]))))
        else:
            dec["n_reads"] = jnp.asarray(n_reads[b])
            m, n = FJ.filter_block(dec, jnp.asarray(wins[b]))
            masks.append(np.asarray(m))
            counts.append(int(n))
    return np.stack(masks), counts


def test_exact_match_mask_and_filter_block_match_reference(decoded_blocks):
    out, wins = decoded_blocks
    nr = out["n_reads"]
    R = out["read_start"].shape[1]
    assert (nr < R).any(), "the fixture must hold padded read slots"
    assert (out["read_pos"][np.arange(R)[None] < nr[:, None]] < 0).any(), "and reads with read_pos < 0"
    t = {k: torch.from_numpy(out[k]) for k in (*PLANES, "n_reads")}
    w = torch.from_numpy(wins)
    want, _ = ref_masks(out, wins)
    got = FT.exact_match_mask(*(t[k] for k in PLANES), w)
    np.testing.assert_array_equal(got.numpy(), want)
    for b in (0, wins.shape[0] - 1):  # the one-block form
        one = FT.exact_match_mask(*(t[k][b] for k in PLANES), w[b])
        np.testing.assert_array_equal(one.numpy(), want[b])
    want_f, want_n = ref_masks(out, wins, nr)
    mask, n = FT.filter_block(t, w)
    np.testing.assert_array_equal(mask.numpy(), want_f)
    assert n.tolist() == want_n
    assert 0 < sum(want_n) < int(nr.sum())
    m1, n1 = FT.filter_block({k: v[1] for k, v in t.items()}, w[1])
    np.testing.assert_array_equal(m1.numpy(), want_f[1])
    assert int(n1) == want_n[1]


def test_exact_match_mask_matches_reference_on_hostile_planes():
    """Spans past both ends of the row, negative and overlapping spans,
    positions past the window and negative: the JAX version's clipping."""
    rng = np.random.default_rng(5)
    nb, C, R, W = 3, 64, 10, 48
    planes = {
        "tokens": rng.integers(0, 5, (nb, C)).astype(np.int8),
        "read_start": rng.integers(-10, C + 5, (nb, R)).astype(np.int32),
        "read_len": rng.integers(-3, 20, (nb, R)).astype(np.int32),
        "read_pos": rng.integers(-4, W + 8, (nb, R)).astype(np.int32),
        "read_rev": rng.integers(0, 2, (nb, R)).astype(np.int32),
    }
    wins = rng.integers(0, 4, (nb, W)).astype(np.int8)
    for b in range(nb):  # plant exact spans so some reads prune
        for r in range(0, R, 3):
            s, ln, p = int(planes["read_start"][b, r]), int(planes["read_len"][b, r]), int(planes["read_pos"][b, r])
            for i in range(max(s, 0), min(s + ln, C)):
                planes["tokens"][b, i] = wins[b, min(max(i - s + p, 0), W - 1)]
    want, _ = ref_masks(planes, wins)
    got = FT.exact_match_mask(*(torch.from_numpy(planes[k]) for k in PLANES), torch.from_numpy(wins))
    np.testing.assert_array_equal(got.numpy(), want)
    assert want.any() and not want.all()


@pytest.mark.parametrize("pattern_len", [0, 1, 20, 32])
def test_myers_distance_matches_reference(pattern_len):
    rng = np.random.default_rng(pattern_len)
    B, T = 6, 48
    reads = rng.integers(0, 4, (B, 32)).astype(np.int32)
    texts = rng.integers(0, 4, (B, T)).astype(np.int32)
    texts[:, 8:8 + pattern_len] = reads[:, :pattern_len]  # a planted, then edited, copy
    texts[::2, 12] = (texts[::2, 12] + 1) % 4
    plen = np.full(B, pattern_len, np.int32)
    tlen = np.array([T, T - 5, 30, 9, 0, T], np.int32)  # text_len shorter than the text
    want = [int(FJ.myers_distance(jnp.asarray(reads[b]), jnp.int32(plen[b]), jnp.asarray(texts[b]),
                                  jnp.int32(tlen[b]))) for b in range(B)]
    got = FT.myers_distance(*(torch.from_numpy(a) for a in (reads, plen, texts, tlen)))
    assert got.dtype == torch.int32 and got.tolist() == want
    # the one-read form, with a read array of exactly pattern_len bases
    if pattern_len:
        r = reads[0, :pattern_len]
        one = FT.myers_distance(torch.from_numpy(r), torch.tensor(pattern_len), torch.from_numpy(texts[0]),
                                torch.tensor(T - 3))
        assert int(one) == int(FJ.myers_distance(jnp.asarray(r), jnp.int32(pattern_len),
                                                 jnp.asarray(texts[0]), jnp.int32(T - 3)))


@pytest.mark.parametrize("block_range", [None, (2, 9)], ids=["all", "range"])
def test_filter_store_blocks_matches_reference(codec_path, block_range):
    ours, theirs = stores(codec_path)
    m_o, p_o, t_o = FT.filter_store_blocks(ours.session(), "ds", block_range)
    m_t, p_t, t_t = FJ.filter_store_blocks(theirs.session(), "ds", block_range)
    assert isinstance(m_o, np.ndarray) and m_o.dtype == np.bool_
    np.testing.assert_array_equal(m_o, m_t)
    assert (p_o, t_o) == (p_t, t_t) and 0 < p_o < t_o


@pytest.mark.parametrize("block_range", [None, (1, 6)], ids=["all", "range"])
def test_map_store_reads_matches_reference(codec_path, block_range):
    ours, theirs = stores(codec_path)
    cons = reference()
    rep_o = map_store_reads(ours.session(), "ds", cons, block_range=block_range)
    rep_t = ref_map_store_reads(theirs.session(), "ds", cons, block_range=block_range)
    assert dataclasses.asdict(rep_o) == dataclasses.asdict(rep_t)
    assert rep_o.pruned > 0 and rep_o.mapped > 0
