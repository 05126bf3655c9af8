"""Golden block parity: all five targets against the reference corpus.

3,040 (input, output) pairs - 32 blocks x 19 modes x 5 targets - ported from
the reference's committed test data (tests/block_test_cases/); the
bit-exactness oracle required by BASELINE.md.
"""

import numpy as np
import pytest

from basisu_rs_jax.ops import transcode_blocks

TARGETS = ["rgba", "astc", "bc7", "etc1", "etc2"]


@pytest.mark.parametrize("target", TARGETS)
def test_golden_blocks_bit_exact(golden, target):
    out, err = transcode_blocks(golden[f"{target}_in"], target)
    assert not err.any()
    expected = golden[f"{target}_out"]
    bad = np.nonzero(np.any(out != expected, axis=1))[0]
    if bad.size:
        i = bad[0]
        raise AssertionError(
            f"{target}: {bad.size}/{len(expected)} blocks mismatch; first bad "
            f"idx {i} mode {golden[f'{target}_mode'][i]}\n"
            f" in: {golden[f'{target}_in'][i].tolist()}\n"
            f"got: {out[i].tolist()}\nexp: {expected[i].tolist()}"
        )


def test_invalid_mode_flagged():
    # A block whose 7-bit code hits MODE_LUT entry 19 must error
    # (reference: uastc.rs:332-336).  Code 69 (0b1000101) -> LUT value 19.
    bad = np.zeros((1, 16), np.uint8)
    bad[0, 0] = 69
    _, err = transcode_blocks(bad, "rgba")
    assert err[0]


def test_invalid_pattern_flagged():
    # Mode 2 (code_size 5, pattern at a known offset) with pattern index >= 30.
    from basisu_rs_jax.ops.dispatch import block_modes
    from basisu_rs_jax.tables import MODES

    cfg = MODES[2]
    block = np.zeros((1, 16), np.uint8)
    # mode 2 code: find a 7-bit code mapping to mode 2 -> LUT value 2 at 0x1D
    block[0, 0] = 0x1D
    assert block_modes(block)[0] == 2
    # set pattern bits (5 bits at field_offsets['pattern']) to 31
    ofs = cfg.field_offsets["pattern"]
    for b in range(5):
        bit = ofs + b
        block[0, bit // 8] |= 1 << (bit % 8)
    _, err = transcode_blocks(block, "rgba")
    assert err[0]
