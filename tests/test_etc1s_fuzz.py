"""ETC1S state-machine fuzz: randomized streams exercising every decoder
path (predictors 0-3, history buffer MTF, selector RLE + VLC, texture video)
against the encoder's decoder-simulation, on both front-ends."""

import numpy as np
import pytest

from basisu_rs_jax.container.basis import make_etc1s_decoder, read_header, read_slice_descs
from basisu_rs_jax.container.etc1s_frontend import Etc1sDecoder
from basisu_rs_jax.container.writer import write_etc1s_basis_fuzz


def _codebooks(rng, e, s):
    endpoints = np.zeros((e, 4), np.uint8)
    endpoints[:, :3] = rng.integers(0, 32, (e, 3))
    endpoints[:, 3] = rng.integers(0, 8, e)
    selectors = rng.integers(0, 256, (s, 4)).astype(np.uint8)
    return endpoints, selectors


def test_deep_huffman_tables_decode_correctly():
    """Codebooks large enough for >10-bit code lengths exercise the C++
    front-end's two-level Huffman tables (root + per-prefix subtables;
    native/etc1s.cpp HuffTable) - every code here is 13 bits, so every
    decode takes the subtable path - against the flat-table Python
    front-end."""
    rng = np.random.default_rng(31)
    e, s = 4096, 5000  # equal-length codes: 12 and 13 bits
    endpoints, selectors = _codebooks(rng, e, s)
    nbx, nby = 40, 10
    buf, exp_ep, exp_sel = write_etc1s_basis_fuzz(
        endpoints, selectors, nbx, nby, 16, seed=31
    )
    h = read_header(buf)
    descs = read_slice_descs(buf, h)
    for use_native in (True, False):
        dec = Etc1sDecoder(
            h.total_endpoints, h.total_selectors,
            buf[h.endpoint_cb_file_ofs : h.endpoint_cb_file_ofs + h.endpoint_cb_file_size],
            buf[h.selector_cb_file_ofs : h.selector_cb_file_ofs + h.selector_cb_file_size],
            buf[h.tables_file_ofs : h.tables_file_ofs + h.tables_file_size],
            is_video=False,
            use_native=use_native,
        )
        sl = dec.decode_slice(nbx, nby, descs[0].data(buf))
        np.testing.assert_array_equal(sl.endpoint_index, exp_ep, err_msg=f"native={use_native}")
        np.testing.assert_array_equal(sl.selector_index, exp_sel, err_msg=f"native={use_native}")


def test_internal_asserts_are_catchable_basis_errors():
    """The reference's decode_blocks uses assert!/panic for prediction-edge
    violations and out-of-range decoded indices (mod.rs:303-310, 443-444) -
    the process aborts.  This build surfaces them as Etc1sError, a catchable
    BasisError subclass (COMPAT.md item 5), on both front-ends."""
    from basisu_rs_jax.api import BasisError
    from basisu_rs_jax.container.etc1s_frontend import Etc1sError
    from basisu_rs_jax.container.writer import (
        BitWriterLsb,
        encode_etc1s_endpoint_codebook,
        encode_etc1s_selector_codebook,
        equal_length_sizes,
        write_huffman_table,
    )

    assert issubclass(Etc1sError, BasisError)

    rng = np.random.default_rng(7)
    endpoints, selectors = _codebooks(rng, 4, 4)
    ep_cb = encode_etc1s_endpoint_codebook(endpoints)
    sel_cb = encode_etc1s_selector_codebook(selectors)
    tw = BitWriterLsb()
    pred_enc = write_huffman_table(tw, equal_length_sizes(257))
    write_huffman_table(tw, equal_length_sizes(4))  # delta model
    write_huffman_table(tw, equal_length_sizes(5))  # selector model (S + H + 1)
    write_huffman_table(tw, equal_length_sizes(64))  # history RLE model
    tw.write(13, 0)  # history buffer size 0
    tables = tw.getvalue()

    # pred 0 (left) at column 0 / pred 1 (above) at row 0 / pred 2
    # (above-left, non-video) at the edge: all assert! sites in the reference
    for sym in (0, 1, 2):
        w = BitWriterLsb()
        pred_enc.encode(w, sym)  # block (0,0) takes the symbol's low 2 bits
        payload = w.getvalue()
        for use_native in (True, False):
            dec = Etc1sDecoder(
                4, 4, ep_cb, sel_cb, tables, is_video=False, use_native=use_native
            )
            with pytest.raises(Etc1sError, match="predictor"):
                dec.decode_slice(1, 1, payload)


@pytest.mark.parametrize("seed,hist,video", [
    (0, 0, False),
    (1, 16, False),
    (2, 64, False),
    (3, 8, True),
    (4, 64, True),
    (5, 1, False),
])
def test_etc1s_state_machine_fuzz(seed, hist, video):
    rng = np.random.default_rng(100 + seed)
    e, s = int(rng.integers(2, 300)), int(rng.integers(2, 200))
    nbx, nby = int(rng.integers(1, 24)), int(rng.integers(1, 20))
    endpoints, selectors = _codebooks(rng, e, s)
    buf, exp_ep, exp_sel = write_etc1s_basis_fuzz(
        endpoints, selectors, nbx, nby, hist, seed=seed, is_video=video
    )
    h = read_header(buf)
    descs = read_slice_descs(buf, h)
    for use_native in (True, False):
        dec = Etc1sDecoder(
            h.total_endpoints, h.total_selectors,
            buf[h.endpoint_cb_file_ofs : h.endpoint_cb_file_ofs + h.endpoint_cb_file_size],
            buf[h.selector_cb_file_ofs : h.selector_cb_file_ofs + h.selector_cb_file_size],
            buf[h.tables_file_ofs : h.tables_file_ofs + h.tables_file_size],
            is_video=video,
            use_native=use_native,
        )
        sl = dec.decode_slice(nbx, nby, descs[0].data(buf))
        np.testing.assert_array_equal(sl.endpoint_index, exp_ep, err_msg=f"native={use_native}")
        np.testing.assert_array_equal(sl.selector_index, exp_sel, err_msg=f"native={use_native}")
        np.testing.assert_array_equal(dec.endpoints, endpoints)
        np.testing.assert_array_equal(dec.selectors, selectors)
