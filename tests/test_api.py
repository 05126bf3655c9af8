"""Block-level API parity: outputs and error messages."""

import numpy as np
import pytest

import basisu_rs_jax as basisu


def test_block_level_functions_match_golden(golden):
    i = 5
    blk = golden["bc7_in"][i].tobytes()
    assert basisu.transcode_uastc_block_to_bc7(blk) == golden["bc7_out"][i].tobytes()
    idx = np.nonzero(
        (golden["astc_in"] == golden["bc7_in"][i]).all(1)
    )[0][0]
    assert basisu.transcode_uastc_block_to_astc(blk) == golden["astc_out"][idx].tobytes()
    rgba = basisu.unpack_uastc_block_to_rgba(golden["rgba_in"][i].tobytes())
    np.testing.assert_array_equal(rgba, golden["rgba_out"][i])
    e1_i = np.nonzero((golden["etc1_in"] == golden["bc7_in"][i]).all(1))[0]
    if e1_i.size:
        assert basisu.transcode_uastc_block_to_etc1(blk) == golden["etc1_out"][e1_i[0]].tobytes()


def test_invalid_mode_message():
    bad = bytes([69] + [0] * 15)  # MODE_LUT entry 19
    with pytest.raises(basisu.BasisError, match="invalid mode index"):
        basisu.unpack_uastc_block_to_rgba(bad)


def test_invalid_pattern_message():
    # mode 2 with out-of-range 5-bit pattern index (see test_golden_blocks)
    from basisu_rs_jax.tables import MODES

    cfg = MODES[2]
    block = bytearray(16)
    block[0] = 0x1D
    ofs = cfg.field_offsets["pattern"]
    for b in range(5):
        bit = ofs + b
        block[bit // 8] |= 1 << (bit % 8)
    with pytest.raises(basisu.BasisError, match="block pattern is not valid"):
        basisu.transcode_uastc_block_to_bc7(bytes(block))


def test_wrong_block_size_rejected():
    with pytest.raises(basisu.BasisError, match="16 bytes"):
        basisu.unpack_uastc_block_to_rgba(b"\x00" * 15)


def test_odd_orig_size_metadata(tmp_path, golden):
    # orig size smaller than the padded block grid is metadata-only
    from basisu_rs_jax.container.writer import write_uastc_basis

    buf = write_uastc_basis(
        [dict(blocks=golden["bc7_in"][:24], nbx=6, nby=4, orig_width=23, orig_height=13)]
    )
    images = basisu.read_to_bc7(buf)
    assert images[0].w == 23 and images[0].h == 13
    assert images[0].data.size == 24 * 16  # full block grid still present
