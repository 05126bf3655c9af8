"""Anchor the ETC1S container path to the reference itself.

The oracle (tests/oracle_etc1s.py) is an independent transcription of the
reference decoder (/root/reference/src/basis_lz/mod.rs + huffman.rs) sharing
no code with basisu_rs_jax.  These tests compare full-file outputs of the
package against oracle-derived expected values over the synthetic + fuzz
corpus, covering video frames, history-buffer MTF, RLE runs, and the
basis.rs:290 endpoint-count quirk (reference analog: tests/corpus_tests.rs).
"""

import numpy as np
import pytest

from basisu_rs_jax.container.basis import (
    make_etc1s_decoder,
    read_header,
    read_slice_descs,
    read_to_etc1,
    read_to_rgba,
)
from basisu_rs_jax.container.writer import write_etc1s_basis, write_etc1s_basis_fuzz

from oracle_etc1s import (
    OracleError,
    oracle_make_decoder,
    oracle_read_to_etc1,
    oracle_read_to_rgba,
)


def _codebooks(rng, e, s):
    endpoints = np.zeros((e, 4), np.uint8)
    endpoints[:, :3] = rng.integers(0, 32, (e, 3))
    endpoints[:, 3] = rng.integers(0, 8, e)
    selectors = rng.integers(0, 256, (s, 4)).astype(np.uint8)
    return endpoints, selectors


FUZZ_CASES = [
    (0, 0, False),   # no history buffer
    (1, 16, False),  # MTF history
    (2, 64, False),  # max history + RLE runs
    (3, 8, True),    # texture video
    (4, 64, True),   # video + history
    (5, 1, False),
]


@pytest.mark.parametrize("seed,hist,video", FUZZ_CASES)
def test_oracle_agrees_with_frontend_on_fuzz_streams(seed, hist, video):
    """The reference-transcribed oracle and the package front-end must decode
    identical (endpoint, selector) index streams, and the oracle's codebooks
    must reproduce the encoder inputs."""
    rng = np.random.default_rng(100 + seed)
    e, s = int(rng.integers(2, 300)), int(rng.integers(2, 200))
    nbx, nby = int(rng.integers(1, 24)), int(rng.integers(1, 20))
    endpoints, selectors = _codebooks(rng, e, s)
    buf, exp_ep, exp_sel = write_etc1s_basis_fuzz(
        endpoints, selectors, nbx, nby, hist, seed=seed, is_video=video
    )

    odec = oracle_make_decoder(buf)
    assert odec.is_video == video
    # Oracle codebooks reproduce the encoder's inputs.
    got_ep = np.array([c + [i] for c, i in odec.endpoints], np.uint8)
    np.testing.assert_array_equal(got_ep, endpoints)
    got_sel = np.array([sel.rows for sel in odec.selectors], np.uint8)
    np.testing.assert_array_equal(got_sel, selectors)

    # Oracle block indices == encoder's intended stream (and therefore the
    # package front-end, which test_etc1s_fuzz pins to the same expectation).
    h = read_header(buf)
    descs = read_slice_descs(buf, h)
    pairs = odec.decode_blocks(nbx, nby, descs[0].data(buf))
    np.testing.assert_array_equal([p[0] for p in pairs], exp_ep.reshape(-1))
    np.testing.assert_array_equal([p[1] for p in pairs], exp_sel.reshape(-1))

    # Cross-check the package front-end directly against the oracle.
    dec = make_etc1s_decoder(h, buf)
    sl = dec.decode_slice(nbx, nby, descs[0].data(buf))
    np.testing.assert_array_equal(sl.endpoint_index.reshape(-1), [p[0] for p in pairs])
    np.testing.assert_array_equal(sl.selector_index.reshape(-1), [p[1] for p in pairs])


@pytest.mark.parametrize("seed,hist,video", FUZZ_CASES[:4])
def test_read_to_etc1_matches_oracle_full_file(seed, hist, video):
    rng = np.random.default_rng(300 + seed)
    e, s = int(rng.integers(2, 100)), int(rng.integers(2, 80))
    nbx, nby = int(rng.integers(1, 12)), int(rng.integers(1, 10))
    endpoints, selectors = _codebooks(rng, e, s)
    buf, _, _ = write_etc1s_basis_fuzz(
        endpoints, selectors, nbx, nby, hist, seed=seed, is_video=video
    )
    images = read_to_etc1(buf)
    oracle_images = oracle_read_to_etc1(buf)
    assert len(images) == len(oracle_images) == 1
    ow, oh, oblocks = oracle_images[0]
    assert (images[0].w, images[0].h) == (ow, oh)
    np.testing.assert_array_equal(
        images[0].data, np.frombuffer(oblocks, np.uint8)
    )


@pytest.mark.parametrize("seed,hist,video", FUZZ_CASES[:4])
def test_read_to_rgba_matches_oracle_full_file(seed, hist, video):
    rng = np.random.default_rng(500 + seed)
    e, s = int(rng.integers(2, 100)), int(rng.integers(2, 80))
    nbx, nby = int(rng.integers(1, 12)), int(rng.integers(1, 10))
    endpoints, selectors = _codebooks(rng, e, s)
    buf, _, _ = write_etc1s_basis_fuzz(
        endpoints, selectors, nbx, nby, hist, seed=seed, is_video=video
    )
    _, images = read_to_rgba(buf)
    (ow, oh, opixels) = oracle_read_to_rgba(buf)[0]
    expected = np.array(opixels, np.uint8).reshape(-1)
    np.testing.assert_array_equal(images[0].data, expected)


def test_read_to_rgba_alpha_pairing_matches_oracle():
    """RGB+alpha slice pairing (basis.rs:26-53): the alpha pass overwrites A
    with the alpha slice's G channel."""
    rng = np.random.default_rng(7)
    endpoints, selectors = _codebooks(rng, 40, 30)
    nbx, nby = 6, 4
    n = nbx * nby
    slices = []
    for k in range(2):
        slices.append(
            dict(
                ep_idx=rng.integers(0, 40, n),
                sel_idx=rng.integers(0, 30, n),
                nbx=nbx,
                nby=nby,
                orig_width=nbx * 4 - 1,
                orig_height=nby * 4 - 2,
                alpha=(k == 1),
            )
        )
    buf = write_etc1s_basis(endpoints, selectors, slices, has_alpha=True)
    _, images = read_to_rgba(buf)
    oracle_images = oracle_read_to_rgba(buf)
    assert len(images) == len(oracle_images) == 1
    ow, oh, opixels = oracle_images[0]
    assert (images[0].w, images[0].h) == (ow, oh)
    expected = np.array(opixels, np.uint8).reshape(-1)
    np.testing.assert_array_equal(images[0].data, expected)


def test_endpoint_count_quirk_pinned():
    """basis.rs:290-291 passes `total_selectors` as the endpoint count — a
    latent reference quirk.  This build (and the default oracle) use
    `total_endpoints`.  Pin both decisions: on a file where the counts
    differ, the correct path decodes the full codebook; the quirk-faithful
    path decodes the wrong number of endpoints (COMPAT.md item 1)."""
    rng = np.random.default_rng(11)
    E, S = 50, 20  # E != S on purpose
    endpoints, selectors = _codebooks(rng, E, S)
    n = 8 * 4
    slices = [
        dict(
            ep_idx=rng.integers(0, E, n),
            sel_idx=rng.integers(0, S, n),
            nbx=8,
            nby=4,
            orig_width=32,
            orig_height=16,
        )
    ]
    buf = write_etc1s_basis(endpoints, selectors, slices)

    # Correct-count path (ours + default oracle): full codebook, decode ok.
    h = read_header(buf)
    dec = make_etc1s_decoder(h, buf)
    assert len(dec.endpoints) == E
    odec = oracle_make_decoder(buf, quirk_endpoint_count=False)
    assert len(odec.endpoints) == E
    images = read_to_etc1(buf)
    descs = read_slice_descs(buf, h)
    np.testing.assert_array_equal(
        images[0].data,
        np.frombuffer(odec.transcode_to_etc1(8, 4, descs[0].data(buf)), np.uint8),
    )

    # Quirk-faithful path (reference-verbatim): S(=20) endpoints decoded from
    # a 50-endpoint stream -> truncated codebook, and block decode trips on
    # indices >= S (or decodes different colors).  Either failure mode
    # demonstrates the file would NOT round-trip through the reference.
    qdec = oracle_make_decoder(buf, quirk_endpoint_count=True)
    assert len(qdec.endpoints) == S
    with pytest.raises((OracleError, AssertionError)):
        qdec.transcode_to_etc1(8, 4, descs[0].data(buf))

    # The production strict-parity switch mirrors the quirk: same truncated
    # codebook as the quirk-faithful oracle.
    sdec = make_etc1s_decoder(h, buf, endpoint_count_quirk=True)
    assert len(sdec.endpoints) == S
    q = np.array([[*c5, i5] for c5, i5 in qdec.endpoints], np.uint8)
    np.testing.assert_array_equal(np.asarray(sdec.endpoints, np.uint8), q)
