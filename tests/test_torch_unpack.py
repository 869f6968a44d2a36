"""Codec unpack (B1) of the PyTorch port against the JAX package, on the
illumina / ont / hifi cases of torch_cases.py.

The port's plain version runs here (CPU tensors); the JAX side runs its
jitted unpack and its Pallas kernel in interpret mode. Integer path, so the
bar is bit identity."""

import numpy as np
import pytest
import torch

from repro.core.decode_jax import unpack_block_rows as ref_unpack_rows
from repro.core.layout import SageContainerV2, write_v2
from repro.kernels.sage_decode import sage_unpack_pallas

from repro_torch.core import decode_torch as DT
from repro_torch.core.format import STREAMS
from repro_torch.kernels import sage_decode as SD

from torch_cases import PROFILES, encoded_case


def np_tree(d):
    return {k: np.asarray(v) for k, v in d.items()}


@pytest.fixture(scope="module", params=PROFILES)
def encoded(request):
    return encoded_case(request.param)


@pytest.fixture(scope="module")
def codec_payloads(encoded, tmp_path_factory):
    _, sf = encoded
    path = tmp_path_factory.mktemp("codec") / "ds.sage2"
    write_v2(sf, path)
    r = SageContainerV2.open(path)
    packed = r.gather_packed(np.arange(sf.meta.n_blocks))
    widths = dict(r.layout.widths)
    return sf, packed, np.asarray(r._codec_dicts, np.uint8), widths


def test_plain_unpack_matches_jit_and_pallas(codec_payloads):
    _, packed, dicts, widths = codec_payloads
    wt = tuple((s, int(widths[s])) for s in STREAMS)
    jit = np_tree(ref_unpack_rows(packed, dicts, widths))
    pallas = np_tree(sage_unpack_pallas(packed, dicts, widths, interpret=True))
    ours = SD.unpack_rows_plain(DT.host_to_tensor(packed, "cpu"), torch.as_tensor(dicts), wt)
    for s, _w in wt:
        got = ours[s].numpy().view(np.uint32)
        np.testing.assert_array_equal(got, jit[s], err_msg=s)
        np.testing.assert_array_equal(got, pallas[s], err_msg=s)


def test_unpack_wrapper_routes_cpu_to_plain(codec_payloads):
    _, packed, dicts, widths = codec_payloads
    DT.reset_trace_counts()
    out = DT.unpack_block_rows(DT.host_to_tensor(packed, "cpu"), torch.as_tensor(dicts), widths)
    assert set(out) == set(STREAMS)
    assert DT.trace_counts() == {"plain:sage_unpack": 1}
