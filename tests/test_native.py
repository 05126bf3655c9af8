"""Native (C++) vs pure-Python front-end equivalence.

The C++ runtime (native/etc1s.cpp) must be bit-identical to the Python
reference path on codebooks, slice index streams, and CRC."""

import numpy as np
import pytest

try:
    from basisu_rs_jax import native
except ImportError:  # pragma: no cover
    native = None

from basisu_rs_jax.container.basis import make_etc1s_decoder, read_header, read_slice_descs
from basisu_rs_jax.container.crc import crc16
from basisu_rs_jax.container.etc1s_frontend import Etc1sDecoder
from basisu_rs_jax.container.writer import write_etc1s_basis

needs_native = pytest.mark.skipif(native is None, reason="no C++ toolchain")


@pytest.fixture(scope="module")
def etc1s_file():
    rng = np.random.default_rng(11)
    E, S = 61, 45
    endpoints = np.zeros((E, 4), np.uint8)
    endpoints[:, :3] = rng.integers(0, 32, (E, 3))
    endpoints[:, 3] = rng.integers(0, 8, E)
    selectors = rng.integers(0, 256, (S, 4)).astype(np.uint8)
    nbx, nby = 9, 7
    ep_idx = rng.integers(0, E, nbx * nby).astype(np.uint16)
    sel_idx = rng.integers(0, S, nbx * nby).astype(np.uint16)
    buf = write_etc1s_basis(
        endpoints, selectors,
        [dict(ep_idx=ep_idx, sel_idx=sel_idx, nbx=nbx, nby=nby,
              orig_width=nbx * 4, orig_height=nby * 4)],
    )
    return buf, endpoints, selectors, ep_idx, sel_idx, nbx, nby


@needs_native
def test_native_crc_matches_python():
    rng = np.random.default_rng(0)
    data = bytes(rng.integers(0, 256, 4096, dtype=np.uint8))
    # python table path
    from basisu_rs_jax.container import crc as crcmod

    tbl = crcmod._crc16_table()
    c = 0xFFFF
    for b in data:
        q = (b ^ (c >> 8)) & 0xFF
        c = ((c << 8) & 0xFFFF) ^ int(tbl[q])
    py = (~c) & 0xFFFF
    assert native.crc16_native(data) == py == crc16(data)


@needs_native
def test_native_frontend_matches_python(etc1s_file):
    buf, endpoints, selectors, ep_idx, sel_idx, nbx, nby = etc1s_file
    h = read_header(buf)
    descs = read_slice_descs(buf, h)
    args = (
        h.total_endpoints, h.total_selectors,
        buf[h.endpoint_cb_file_ofs : h.endpoint_cb_file_ofs + h.endpoint_cb_file_size],
        buf[h.selector_cb_file_ofs : h.selector_cb_file_ofs + h.selector_cb_file_size],
        buf[h.tables_file_ofs : h.tables_file_ofs + h.tables_file_size],
    )
    dn = Etc1sDecoder(*args, use_native=True)
    dp = Etc1sDecoder(*args, use_native=False)
    assert dn._native is not None and dp._native is None
    np.testing.assert_array_equal(dn.endpoints, dp.endpoints)
    np.testing.assert_array_equal(dn.selectors, dp.selectors)
    np.testing.assert_array_equal(dn.endpoints, endpoints)
    sn = dn.decode_slice(nbx, nby, descs[0].data(buf))
    sp = dp.decode_slice(nbx, nby, descs[0].data(buf))
    np.testing.assert_array_equal(sn.endpoint_index, sp.endpoint_index)
    np.testing.assert_array_equal(sn.selector_index, sp.selector_index)
    np.testing.assert_array_equal(sn.endpoint_index, ep_idx)
    np.testing.assert_array_equal(sn.selector_index, sel_idx)


@needs_native
def test_native_rejects_global_codebooks():
    from basisu_rs_jax.container.etc1s_frontend import Etc1sError
    from basisu_rs_jax.container.writer import encode_etc1s_endpoint_codebook

    good_endpoints = encode_etc1s_endpoint_codebook(np.zeros((1, 4), np.uint8))
    bad_selectors = bytes([0b001])  # global=1
    with pytest.raises(Etc1sError, match="not supported"):
        Etc1sDecoder(1, 1, good_endpoints, bad_selectors, b"\x00" * 16)


@needs_native
def test_library_path_keyed_by_source(tmp_path, monkeypatch):
    """The shared library is built under native/build/ with a name keyed by
    the source's hash: a library built from other source is never loaded."""
    path = native.library_path()
    assert path.parent == native._DIR / "build" and path.exists()
    other = tmp_path / "etc1s.cpp"
    other.write_bytes(native._SRC.read_bytes() + b"\n// changed\n")
    monkeypatch.setattr(native, "_SRC", other)
    changed = native.library_path()
    assert changed.parent == path.parent and changed.name != path.name
