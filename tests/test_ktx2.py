"""KTX2 emission: header/index/level layout, DFD structure, alignment, CLI.

The reference crate has no KTX2 support (its corpus tests consume KTX v1,
tests/common.rs:15-22); this pins our writer's byte layout against the KTX
File Format Specification 2.0 by hand: identifier, 9-word header, section
index, level index with last-level-first payload placement, and the
mandatory KDFS 1.3 basic descriptor block.
"""

import struct

import numpy as np
import pytest

from basisu_rs_jax.container.ktx2 import write_ktx2
from test_ktx import _basis_with_mips

IDENT = bytes([0xAB, 0x4B, 0x54, 0x58, 0x20, 0x32, 0x30, 0xBB, 0x0D, 0x0A, 0x1A, 0x0A])


def _parse(blob):
    assert blob[:12] == IDENT
    hdr = struct.unpack_from("<9I", blob, 12)
    (dfd_ofs, dfd_len, kvd_ofs, kvd_len, sgd_ofs, sgd_len) = struct.unpack_from(
        "<2I2I2Q", blob, 12 + 36
    )
    n_levels = hdr[7]
    # section index = 4 u32 + 2 u64 = 32 bytes; level index follows
    levels = [
        struct.unpack_from("<3Q", blob, 12 + 36 + 32 + 24 * i) for i in range(n_levels)
    ]
    return hdr, (dfd_ofs, dfd_len, kvd_ofs, kvd_len, sgd_ofs, sgd_len), levels


def test_ktx2_bc7_mip_chain_layout():
    from basisu_rs_jax import read_to_bc7

    images = read_to_bc7(_basis_with_mips())
    chain = images[:2]  # 8x8 + 4x4
    blob = write_ktx2(chain, "bc7")
    hdr, idx, levels = _parse(blob)
    (vk, type_size, w, h, depth, layers, faces, n_levels, sc) = hdr
    assert vk == 145  # VK_FORMAT_BC7_UNORM_BLOCK
    assert (type_size, w, h, depth, layers, faces, n_levels, sc) == (1, 8, 8, 0, 0, 1, 2, 0)

    dfd_ofs, dfd_len, kvd_ofs, kvd_len, sgd_ofs, sgd_len = idx
    assert dfd_ofs == 12 + 36 + 32 + 24 * 2
    assert struct.unpack_from("<I", blob, dfd_ofs)[0] == dfd_len  # dfdTotalSize
    assert kvd_ofs == dfd_ofs + dfd_len
    assert (sgd_ofs, sgd_len) == (0, 0)

    # level payloads: LAST level first in the file, 16-byte aligned, and the
    # index entries point back at the right data
    assert levels[1][0] < levels[0][0]
    for lvl, img in enumerate(chain):
        ofs, length, ulength = levels[lvl]
        assert length == ulength == img.data.size
        assert ofs % 16 == 0
        assert blob[ofs : ofs + length] == np.asarray(img.data, np.uint8).tobytes()
    assert len(blob) == levels[0][0] + levels[0][1]


def test_ktx2_dfd_basic_block():
    from basisu_rs_jax import read_to_etc2

    images = read_to_etc2(_basis_with_mips())
    blob = write_ktx2([images[2]], "etc2")
    hdr, idx, _ = _parse(blob)
    assert hdr[0] == 151  # VK_FORMAT_ETC2_R8G8B8A8_UNORM_BLOCK
    dfd_ofs, dfd_len = idx[0], idx[1]
    total, vendor, ver_size = struct.unpack_from("<3I", blob, dfd_ofs)
    assert total == dfd_len
    assert vendor == 0  # Khronos / basic descriptor
    assert ver_size & 0xFFFF == 2  # versionNumber
    block_size = ver_size >> 16
    assert total == 4 + block_size
    n_samples = (block_size - 24) // 16
    assert n_samples == 2  # EAC alpha sample + ETC2 color sample
    model, primaries, transfer, flags = struct.unpack_from("<4B", blob, dfd_ofs + 12)
    assert model == 161  # KHR_DF_MODEL_ETC2
    bw, bh, bd, b3 = struct.unpack_from("<4B", blob, dfd_ofs + 16)
    assert (bw, bh, bd, b3) == (3, 3, 0, 0)  # 4x4x1 block, dims stored -1
    bytes_planes = struct.unpack_from("<8B", blob, dfd_ofs + 20)
    assert bytes_planes[0] == 16 and not any(bytes_planes[1:])

    # KVD holds the spec-recommended KTXwriter entry
    kvd_ofs, kvd_len = idx[2], idx[3]
    kv_len = struct.unpack_from("<I", blob, kvd_ofs)[0]
    assert blob[kvd_ofs + 4 : kvd_ofs + 4 + kv_len].startswith(b"KTXwriter\x00")


def test_ktx2_rgba_rows_and_alignment():
    from basisu_rs_jax import read_to_rgba

    _, images = read_to_rgba(_basis_with_mips())
    img = images[2]  # 3x3 inside a 4x4 block: exercises stride cropping
    blob = write_ktx2([img], "rgba")
    hdr, idx, levels = _parse(blob)
    assert hdr[0] == 37  # VK_FORMAT_R8G8B8A8_UNORM
    ofs, length, _ = levels[0]
    assert length == 3 * 3 * 4 and ofs % 4 == 0
    data = np.asarray(img.data, np.uint8)
    expect = b"".join(
        data[y * img.stride : y * img.stride + 12].tobytes() for y in range(3)
    )
    assert blob[ofs : ofs + length] == expect


def test_ktx2_rejects_bad_inputs():
    from basisu_rs_jax import read_to_bc7

    images = read_to_bc7(_basis_with_mips())
    with pytest.raises(ValueError):
        write_ktx2([], "bc7")
    with pytest.raises(ValueError, match="mip level 1"):
        write_ktx2([images[0], images[2]], "bc7")  # 8x8 then 3x3: not halving
    with pytest.raises(ValueError, match="format mapping"):
        write_ktx2([images[0]], "uastc")


def test_cli_transcode_ktx2(tmp_path):
    from basisu_rs_jax.__main__ import main

    src = tmp_path / "tex.basis"
    src.write_bytes(_basis_with_mips())
    rc = main(["transcode", str(src), "--target", "bc7", "--container", "ktx2",
               "-o", str(tmp_path)])
    assert rc == 0
    files = sorted(tmp_path.glob("*.ktx2"))
    assert [f.name for f in files] == ["tex_0.bc7.ktx2", "tex_1.bc7.ktx2"]
    hdr, _, _ = _parse(files[0].read_bytes())
    assert hdr[0] == 145 and hdr[7] == 2  # BC7, two mip levels


def test_ktx2_round_trips_through_independent_reader():
    """Round-trip every target's mip chain through tests/ktx2_reader.py - an
    independent spec-first parser with strict structural validation (level
    alignment/coverage/no-overlap, DFD sample layout, KVD entries) - and
    compare payloads byte-for-byte (round-3 verdict stretch item 9)."""
    from basisu_rs_jax import (
        read_to_astc,
        read_to_bc7,
        read_to_etc1,
        read_to_etc2,
        read_to_rgba,
    )
    from ktx2_reader import read_ktx2

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
        chain = images[:2]  # 8x8 + 4x4
        parsed = read_ktx2(write_ktx2(chain, target))
        assert (parsed.width, parsed.height) == (chain[0].w, chain[0].h)
        assert len(parsed.levels) == 2
        assert parsed.kvd["KTXwriter"].rstrip(b"\x00") == b"basisu_rs_jax"
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


def test_ktx2_reader_rejects_corruption():
    """The independent reader's validation actually bites: flip structural
    fields and expect rejection."""
    from basisu_rs_jax import read_to_bc7
    from ktx2_reader import read_ktx2

    images = read_to_bc7(_basis_with_mips())
    blob = bytearray(write_ktx2(images[:2], "bc7"))
    read_ktx2(bytes(blob))  # sanity: intact file parses

    bad = blob.copy()
    bad[0] ^= 1  # identifier
    with pytest.raises(ValueError, match="identifier"):
        read_ktx2(bytes(bad))

    bad = blob.copy()
    struct.pack_into("<I", bad, 12 + 32, 1)  # supercompressionScheme
    with pytest.raises(ValueError, match="supercompression"):
        read_ktx2(bytes(bad))

    bad = blob.copy()
    # corrupt level 0's byteLength in the level index
    ofs0, len0, ulen0 = struct.unpack_from("<3Q", bad, 48 + 32)
    struct.pack_into("<3Q", bad, 48 + 32, ofs0, len0 - 16, ulen0 - 16)
    with pytest.raises(ValueError, match="expected"):
        read_ktx2(bytes(bad))

    bad = blob + b"\x00" * 8  # trailing garbage
    with pytest.raises(ValueError, match="trailing"):
        read_ktx2(bytes(bad))
