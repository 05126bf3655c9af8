"""Container-level integration tests over synthetic .basis files.

The reference's corpus tests need author-local textures (corpus_tests.rs,
ignored in CI); instead we *write* spec-conformant .basis files with the test
writer and check full-file decodes against independently computed expecteds.
"""

import numpy as np
import pytest

from basisu_rs_jax import (
    BasisError,
    read_to_astc,
    read_to_bc7,
    read_to_etc1,
    read_to_etc2,
    read_to_rgba,
    read_to_uastc,
)
from basisu_rs_jax.container.writer import write_etc1s_basis, write_uastc_basis
from basisu_rs_jax.ops import transcode_blocks

ETC1_MODIFIERS = [
    [-8, -2, 2, 8], [-17, -5, 5, 17], [-29, -9, 9, 29], [-42, -13, 13, 42],
    [-60, -18, 18, 60], [-80, -24, 24, 80], [-106, -33, 33, 106], [-183, -47, 47, 183],
]


def _etc1s_expected_rgba(endpoints, selectors, ep_idx, sel_idx, nbx, nby):
    """Independent numpy oracle for the ETC1S->RGBA back-end."""
    n = nbx * nby
    out = np.zeros((n, 16), np.uint32)
    for b in range(n):
        e = endpoints[ep_idx[b]]
        base = [(int(v) << 3) | (int(v) >> 2) for v in e[:3]]
        pal = []
        for k in range(4):
            m = ETC1_MODIFIERS[int(e[3])][k]
            pal.append([min(255, max(0, c + m)) for c in base])
        rows = selectors[sel_idx[b]]
        for y in range(4):
            for x in range(4):
                s = (int(rows[y]) >> (2 * x)) & 3
                r, g, bl = pal[s]
                out[b, y * 4 + x] = r | (g << 8) | (bl << 16) | 0xFF000000
    return out


def _blocks_to_image_words(texels, nbx):
    nby = texels.shape[0] // nbx
    t = texels.reshape(nby, nbx, 4, 4).transpose(0, 2, 1, 3).reshape(-1)
    return t


@pytest.fixture(scope="module")
def uastc_file(golden=None):
    d = np.load("tests/fixtures/golden_blocks.npz")
    blocks = d["bc7_in"][:24]  # 24 blocks -> 6x4 grid
    return blocks, write_uastc_basis(
        [dict(blocks=blocks, nbx=6, nby=4, orig_width=24, orig_height=16)]
    )


def test_uastc_file_round_trip_blocks(uastc_file):
    blocks, buf = uastc_file
    images = read_to_uastc(buf)
    assert len(images) == 1
    np.testing.assert_array_equal(images[0].data.reshape(-1, 16), blocks)
    assert images[0].w == 24 and images[0].h == 16 and images[0].stride == 96


@pytest.mark.parametrize("target,fn,bs", [
    ("bc7", read_to_bc7, 16),
    ("astc", read_to_astc, 16),
    ("etc1", read_to_etc1, 8),
    ("etc2", read_to_etc2, 16),
])
def test_uastc_file_transcode_targets(uastc_file, target, fn, bs):
    blocks, buf = uastc_file
    expected, err = transcode_blocks(blocks, target)
    assert not err.any()
    images = fn(buf)
    np.testing.assert_array_equal(images[0].data.reshape(-1, bs), expected)
    assert images[0].stride == bs * 6


def test_uastc_file_rgba(uastc_file):
    blocks, buf = uastc_file
    texels, err = transcode_blocks(blocks, "rgba")
    header, images = read_to_rgba(buf)
    img = images[0]
    got = img.data.view("<u4").reshape(-1)
    np.testing.assert_array_equal(got, _blocks_to_image_words(texels, 6))


def test_corrupt_data_crc_rejected(uastc_file):
    _, buf = uastc_file
    bad = bytearray(buf)
    bad[-1] ^= 0xFF
    with pytest.raises(BasisError, match="Data CRC16"):
        read_to_bc7(bytes(bad))


def test_corrupt_header_crc_rejected(uastc_file):
    _, buf = uastc_file
    bad = bytearray(buf)
    bad[20] ^= 1  # tex_format byte inside the header CRC span
    with pytest.raises(BasisError, match="Header CRC16"):
        read_to_bc7(bytes(bad))


def test_mutation_fuzz_never_crashes(uastc_file, etc1s_setup):
    """Random single/multi-byte corruptions of valid .basis files must
    either decode or raise BasisError - never raise anything else or abort
    (the reference's corrupt-stream contract: Err, not panic, for malformed
    input reachable through the public API; graceful bit-edge semantics are
    pinned elsewhere).  CRC checks catch most mutations; the interesting
    survivors are mutations inside the CRC-exempt header bytes and
    truncations."""
    _, ubuf = uastc_file
    endpoints, selectors, ep_idx, sel_idx, nbx, nby = etc1s_setup
    ebuf = write_etc1s_basis(
        endpoints,
        selectors,
        [dict(ep_idx=ep_idx, sel_idx=sel_idx, nbx=nbx, nby=nby,
              orig_width=4 * nbx, orig_height=4 * nby)],
    )
    rng = np.random.default_rng(99)
    for buf in (ubuf, ebuf):
        for _ in range(60):
            bad = bytearray(buf)
            for _ in range(int(rng.integers(1, 4))):
                bad[int(rng.integers(0, len(bad)))] ^= int(rng.integers(1, 256))
            try:
                read_to_rgba(bytes(bad))
            except BasisError:
                pass
        for cut in rng.integers(0, len(buf), 20):
            try:
                read_to_rgba(bytes(buf[: int(cut)]))
            except BasisError:
                pass


def test_file_level_invalid_block_messages(uastc_file):
    """read_to_* aborts with the FIRST failing block's own message, exactly
    as the reference's transcode loop propagates it (uastc.rs:148-165 with
    the two per-block Err sites uastc.rs:336 and uastc.rs:364)."""
    from basisu_rs_jax.tables import MODES

    blocks, _ = uastc_file
    # first failing block = invalid mode (MODE_LUT entry 19)
    bad = np.array(blocks, np.uint8)
    bad[3] = 0
    bad[3][0] = 69
    buf = write_uastc_basis([dict(blocks=bad, nbx=6, nby=4, orig_width=24, orig_height=16)])
    for fn in (read_to_bc7, read_to_rgba, read_to_astc, read_to_etc1, read_to_etc2):
        with pytest.raises(BasisError, match="^invalid mode index$"):
            fn(buf)

    # first failing block = out-of-range pattern index (mode 2, pattern 31)
    cfg = MODES[2]
    pat_block = bytearray(16)
    pat_block[0] = 0x1D
    ofs = cfg.field_offsets["pattern"]
    for b in range(5):
        bit = ofs + b
        pat_block[bit // 8] |= 1 << (bit % 8)
    bad2 = np.array(blocks, np.uint8)
    bad2[2] = np.frombuffer(bytes(pat_block), np.uint8)
    bad2[5] = 0
    bad2[5][0] = 69  # later invalid-mode block must NOT win over block 2
    buf2 = write_uastc_basis([dict(blocks=bad2, nbx=6, nby=4, orig_width=24, orig_height=16)])
    with pytest.raises(BasisError, match="^block pattern is not valid$"):
        read_to_bc7(buf2)


def test_bad_sig_rejected(uastc_file):
    _, buf = uastc_file
    bad = b"XX" + buf[2:]
    with pytest.raises(BasisError, match="Sig mismatch"):
        read_to_bc7(bad)


@pytest.fixture(scope="module")
def etc1s_setup():
    rng = np.random.default_rng(42)
    E, S = 47, 31
    endpoints = np.zeros((E, 4), np.uint8)
    endpoints[:, :3] = rng.integers(0, 32, (E, 3))
    endpoints[:, 3] = rng.integers(0, 8, E)
    selectors = rng.integers(0, 256, (S, 4)).astype(np.uint8)
    nbx, nby = 7, 5
    n = nbx * nby
    ep_idx = rng.integers(0, E, n).astype(np.uint16)
    sel_idx = rng.integers(0, S, n).astype(np.uint16)
    return endpoints, selectors, ep_idx, sel_idx, nbx, nby


def test_etc1s_file_rgba(etc1s_setup):
    endpoints, selectors, ep_idx, sel_idx, nbx, nby = etc1s_setup
    buf = write_etc1s_basis(
        endpoints, selectors,
        [dict(ep_idx=ep_idx, sel_idx=sel_idx, nbx=nbx, nby=nby,
              orig_width=nbx * 4, orig_height=nby * 4)],
    )
    header, images = read_to_rgba(buf)
    assert header.total_endpoints == len(endpoints)
    expected = _etc1s_expected_rgba(endpoints, selectors, ep_idx, sel_idx, nbx, nby)
    got = images[0].data.view("<u4").reshape(-1)
    np.testing.assert_array_equal(got, _blocks_to_image_words(expected, nbx))


def test_etc1s_file_etc1(etc1s_setup):
    endpoints, selectors, ep_idx, sel_idx, nbx, nby = etc1s_setup
    buf = write_etc1s_basis(
        endpoints, selectors,
        [dict(ep_idx=ep_idx, sel_idx=sel_idx, nbx=nbx, nby=nby,
              orig_width=nbx * 4, orig_height=nby * 4)],
    )
    images = read_to_etc1(buf)
    out = images[0].data.reshape(-1, 8)
    # independent check of the ETC1S->ETC1 pack (mod.rs:163-181)
    for b in range(nbx * nby):
        e = endpoints[ep_idx[b]]
        assert out[b, 0] == (e[0] << 3) & 0xFF
        assert out[b, 1] == (e[1] << 3) & 0xFF
        assert out[b, 2] == (e[2] << 3) & 0xFF
        assert out[b, 3] == ((e[3] << 5) | (e[3] << 2) | 0b11) & 0xFF


def test_etc1s_mip_chain_single_launch(etc1s_setup, monkeypatch):
    """A 10-level mipmapped ETC1S file issues O(1) device dispatches: every
    slice's index stream shares the file codebooks, so read_to_rgba /
    read_to_etc1 concatenate them into ONE run_etc1s_* call (the per-slice
    loop of basis.rs:26-86 would pay a launch + pow2 pad per mip tail), and
    the split-back outputs stay bit-identical to per-slice decodes."""
    import basisu_rs_jax.container.basis as basis_mod
    from basisu_rs_jax.ops.etc1s import run_etc1s_etc1, run_etc1s_rgba

    endpoints, selectors, _, _, _, _ = etc1s_setup
    rng = np.random.default_rng(11)
    E, S = len(endpoints), len(selectors)
    slices = []
    nbx0, nby0 = 130, 3  # level tails go 130,65,32,...,1: exercises odd pads
    for lvl in range(10):
        w, h = max(1, nbx0 >> lvl), max(1, nby0 >> lvl)
        slices.append(
            dict(ep_idx=rng.integers(0, E, w * h), sel_idx=rng.integers(0, S, w * h),
                 nbx=w, nby=h, orig_width=4 * w, orig_height=4 * h)
        )
    buf = write_etc1s_basis(endpoints, selectors, slices)

    calls = {"rgba": 0, "etc1": 0}
    monkeypatch.setattr(
        basis_mod, "run_etc1s_rgba",
        lambda *a, **k: (calls.__setitem__("rgba", calls["rgba"] + 1),
                         run_etc1s_rgba(*a, **k))[1],
    )
    monkeypatch.setattr(
        basis_mod, "run_etc1s_etc1",
        lambda *a, **k: (calls.__setitem__("etc1", calls["etc1"] + 1),
                         run_etc1s_etc1(*a, **k))[1],
    )
    _, images = read_to_rgba(buf)
    etc1_images = read_to_etc1(buf)
    assert calls == {"rgba": 1, "etc1": 1}
    assert len(images) == 10 and len(etc1_images) == 10

    for img, e1img, s in zip(images, etc1_images, slices):
        ep_idx = np.asarray(s["ep_idx"], np.uint16)
        sel_idx = np.asarray(s["sel_idx"], np.uint16)
        exp = _etc1s_expected_rgba(endpoints, selectors, ep_idx, sel_idx,
                                   s["nbx"], s["nby"])
        np.testing.assert_array_equal(
            img.data.view("<u4").reshape(-1), _blocks_to_image_words(exp, s["nbx"])
        )
        exp_e1 = run_etc1s_etc1(endpoints, selectors, ep_idx, sel_idx)
        np.testing.assert_array_equal(
            e1img.data.reshape(-1),
            np.ascontiguousarray(exp_e1.astype("<u4")).view(np.uint8).reshape(-1),
        )


def test_etc1s_file_with_alpha(etc1s_setup):
    endpoints, selectors, ep_idx, sel_idx, nbx, nby = etc1s_setup
    rng = np.random.default_rng(7)
    a_ep = rng.integers(0, len(endpoints), nbx * nby).astype(np.uint16)
    a_sel = rng.integers(0, len(selectors), nbx * nby).astype(np.uint16)
    buf = write_etc1s_basis(
        endpoints, selectors,
        [
            dict(ep_idx=ep_idx, sel_idx=sel_idx, nbx=nbx, nby=nby,
                 orig_width=nbx * 4, orig_height=nby * 4),
            dict(ep_idx=a_ep, sel_idx=a_sel, nbx=nbx, nby=nby,
                 orig_width=nbx * 4, orig_height=nby * 4, alpha=True),
        ],
        has_alpha=True,
    )
    header, images = read_to_rgba(buf)
    assert len(images) == 1
    rgb = _etc1s_expected_rgba(endpoints, selectors, ep_idx, sel_idx, nbx, nby)
    alpha = _etc1s_expected_rgba(endpoints, selectors, a_ep, a_sel, nbx, nby)
    expected = (rgb & 0x00FFFFFF) | (((alpha >> 8) & 0xFF) << 24)  # G -> A
    got = images[0].data.view("<u4").reshape(-1)
    np.testing.assert_array_equal(got, _blocks_to_image_words(expected, nbx))


def test_etc1s_rgba_stride_is_true_buffer_stride(etc1s_setup):
    """COMPAT.md item 2: we report the decoded buffer's true byte stride
    (4*4*num_blocks_x); the reference reports 4*orig_width (basis.rs:46),
    which disagrees with its own buffer for non-block-aligned widths."""
    endpoints, selectors, ep_idx, sel_idx, nbx, nby = etc1s_setup
    buf = write_etc1s_basis(
        endpoints, selectors,
        [dict(ep_idx=ep_idx, sel_idx=sel_idx, nbx=nbx, nby=nby,
              orig_width=nbx * 4 - 3, orig_height=nby * 4)],  # non-aligned w
    )
    _, images = read_to_rgba(buf)
    img = images[0]
    assert img.w == nbx * 4 - 3
    assert img.stride == 4 * 4 * nbx  # true buffer stride, not 4*orig_width
    assert img.data.size == img.stride * nby * 4


def test_etc1s_unsupported_targets_raise(etc1s_setup):
    """COMPAT.md item 3: ETC1S->{ETC2,ASTC,BC7,UASTC} are unimplemented!()
    panics in the reference (basis.rs:141,171,200,229,258); here they raise
    a catchable BasisError with the shared unsupported-format message."""
    from basisu_rs_jax.container.basis import read_to_astc, read_to_etc2, read_to_uastc

    endpoints, selectors, ep_idx, sel_idx, nbx, nby = etc1s_setup
    buf = write_etc1s_basis(
        endpoints, selectors,
        [dict(ep_idx=ep_idx, sel_idx=sel_idx, nbx=nbx, nby=nby,
              orig_width=nbx * 4, orig_height=nby * 4)],
    )
    for fn in (read_to_etc2, read_to_astc, read_to_bc7, read_to_uastc):
        with pytest.raises(BasisError, match="unsupported texture format"):
            fn(buf)


def test_image_into_rgba_bytes(golden):
    """Image::into_rgba_bytes parity (reference: src/lib.rs:70-79)."""
    from basisu_rs_jax.api import Image, transcode_uastc_blocks

    blocks = golden["rgba_in"][:4]
    texels, err = transcode_uastc_blocks(blocks, "rgba")
    assert not err.any()
    img = Image(w=8, h=8, stride=8, data=texels.reshape(-1))
    b = img.into_rgba_bytes()
    assert (b.w, b.h, b.stride) == (8, 8, 32)
    assert b.data.dtype == np.uint8
    np.testing.assert_array_equal(
        b.data, texels.reshape(-1).astype("<u4").view(np.uint8)
    )
    assert b.into_rgba_bytes() is b  # byte images pass through


def test_file_api_mesh_parity(uastc_file, etc1s_setup):
    """read_to_*(buf, mesh=...) shards the device work over the mesh and
    reproduces the single-device output bit-exactly - UASTC targets, ETC1S
    RGBA with alpha pairing, and ETC1S ETC1."""
    from basisu_rs_jax.parallel.mesh import make_mesh

    mesh = make_mesh(8)

    _, ubuf = uastc_file
    for fn in (read_to_bc7, read_to_etc1, read_to_etc2, read_to_astc):
        plain = fn(ubuf)
        sharded = fn(ubuf, mesh=mesh)
        for a, b in zip(plain, sharded):
            np.testing.assert_array_equal(a.data, b.data)
    _, plain = read_to_rgba(ubuf)
    _, sharded = read_to_rgba(ubuf, mesh=mesh)
    np.testing.assert_array_equal(plain[0].data, sharded[0].data)

    endpoints, selectors, ep_idx, sel_idx, nbx, nby = etc1s_setup
    rng = np.random.default_rng(7)
    a_ep = rng.integers(0, len(endpoints), nbx * nby).astype(np.uint16)
    a_sel = rng.integers(0, len(selectors), nbx * nby).astype(np.uint16)
    ebuf = write_etc1s_basis(
        endpoints, selectors,
        [
            dict(ep_idx=ep_idx, sel_idx=sel_idx, nbx=nbx, nby=nby,
                 orig_width=nbx * 4, orig_height=nby * 4),
            dict(ep_idx=a_ep, sel_idx=a_sel, nbx=nbx, nby=nby,
                 orig_width=nbx * 4, orig_height=nby * 4, alpha=True),
        ],
        has_alpha=True,
    )
    _, plain = read_to_rgba(ebuf)
    _, sharded = read_to_rgba(ebuf, mesh=mesh)
    np.testing.assert_array_equal(plain[0].data, sharded[0].data)

    ebuf1 = write_etc1s_basis(
        endpoints, selectors,
        [dict(ep_idx=ep_idx, sel_idx=sel_idx, nbx=nbx, nby=nby,
              orig_width=nbx * 4, orig_height=nby * 4)],
    )
    plain = read_to_etc1(ebuf1)
    sharded = read_to_etc1(ebuf1, mesh=mesh)
    np.testing.assert_array_equal(plain[0].data, sharded[0].data)


def test_uastc_mip_chain_single_dispatch(golden, monkeypatch):
    """Every slice of a UASTC file (here a 6-level mip chain) goes through
    ONE partitioned dispatch per read_to_* call, split back per slice
    bit-exactly."""
    import basisu_rs_jax.container.basis as basis_mod

    blocks = golden["bc7_in"]
    slices, ofs = [], 0
    for lvl in range(6):
        w = max(1, 32 >> lvl)
        nb = -(-w // 4)
        slices.append(dict(blocks=blocks[ofs : ofs + nb * nb], nbx=nb, nby=nb,
                           orig_width=w, orig_height=w, level_index=lvl, image_index=0))
        ofs += nb * nb
    buf = write_uastc_basis(slices)
    calls = []
    real = basis_mod.transcode_blocks
    monkeypatch.setattr(basis_mod, "transcode_blocks",
                        lambda b, t: (calls.append(len(b)), real(b, t))[1])
    images = read_to_bc7(buf)
    assert calls == [ofs]
    for img, s in zip(images, slices):
        np.testing.assert_array_equal(img.data, real(s["blocks"], "bc7")[0].reshape(-1))


def test_uastc_error_order_across_slices(uastc_file):
    """An invalid block in slice 0 wins over a truncated slice 1, as the
    reference's per-slice loop would report it (basis.rs:92-260); a file
    whose only fault is the truncated slice reports that."""
    blocks, _ = uastc_file
    dims = dict(nbx=6, nby=4, orig_width=24, orig_height=16)
    bad = np.array(blocks, np.uint8)
    bad[0] = 0
    bad[0][0] = 69
    truncated = dict(blocks=np.zeros(16 * 24 - 1, np.uint8), **dims)
    with pytest.raises(BasisError, match="^invalid mode index$"):
        read_to_bc7(write_uastc_basis([dict(blocks=bad, **dims), truncated]))
    with pytest.raises(BasisError, match="divisible by UASTC block size"):
        read_to_bc7(write_uastc_basis([dict(blocks=blocks, **dims), truncated]))
