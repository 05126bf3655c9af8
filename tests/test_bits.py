"""Exhaustive-ish bit I/O property tests.

Mirrors the reference's tier-1 strategy (bitreader.rs:63-99,
bitwriter.rs:118-225: pattern sweeps over offsets x lengths) against an
independent big-int oracle.
"""

import numpy as np
import pytest

import jax.numpy as jnp

from basisu_rs_jax.ops.bits import (
    LaneWriter,
    bitrev,
    bytes_from_lanes_np,
    extract,
    extract_dyn,
    lanes_from_bytes_np,
    mask,
)


def patterns():
    """16 test patterns: alternating bits with segments inverted."""
    base = 0x5555_5555_5555_5555_5555_5555_5555_5555
    out = []
    for i in range(16):
        xor = 0
        for seg in range(4):
            if (i >> seg) & 1:
                xor |= ((1 << 32) - 1) << (32 * seg)
        out.append(base ^ xor)
    return out


def int_to_lanes(v: int) -> np.ndarray:
    return np.array([[(v >> (32 * k)) & 0xFFFFFFFF for k in range(4)]], np.uint32)


@pytest.mark.parametrize("count", [1, 3, 5, 8, 13, 21, 32])
def test_extract_static_matches_oracle(count):
    for p in patterns():
        lanes = jnp.asarray(int_to_lanes(p))
        for offset in range(0, 128 - count + 1, 7):
            got = int(extract(lanes, offset, count)[0])
            assert got == (p >> offset) & mask(count), (offset, count)


def test_extract_past_end_returns_zero_bits():
    # reads beyond bit 128 yield zeros (bitreader.rs:45,55)
    p = (1 << 128) - 1
    lanes = jnp.asarray(int_to_lanes(p))
    assert int(extract(lanes, 120, 8)[0]) == 0xFF
    got = int(extract_dyn(lanes, jnp.array([126]), 8)[0])
    assert got == 0b11  # two real bits, six zeros


@pytest.mark.parametrize("count", [1, 4, 5, 7, 8])
def test_extract_dyn_matches_static(count):
    ps = patterns()
    lanes = jnp.asarray(np.concatenate([int_to_lanes(p) for p in ps], axis=0))
    for offset in range(0, 128 - count + 1, 3):
        offs = jnp.full((len(ps),), offset, jnp.int32)
        d = np.asarray(extract_dyn(lanes, offs, count))
        s = np.asarray(extract(lanes, offset, count))
        np.testing.assert_array_equal(d, s)


def test_extract_bit_dyn_matches_static():
    """extract_bit_dyn == extract(., ., 1) for every offset, under every
    bit_range that contains it (the range only prunes word selects)."""
    from basisu_rs_jax.ops.bits import extract_bit_dyn

    ps = patterns()
    lanes = jnp.asarray(np.concatenate([int_to_lanes(p) for p in ps], axis=0))
    for offset in range(0, 128, 7):
        s = np.asarray(extract(lanes, offset, 1))
        for lo, hi in ((offset, offset + 1), (0, 128), (max(0, offset - 31), min(128, offset + 32))):
            offs = jnp.full((len(ps),), offset, jnp.int32)
            d = np.asarray(extract_bit_dyn(lanes, offs, (lo, hi)))
            np.testing.assert_array_equal(d, s, err_msg=f"offset={offset} range=({lo},{hi})")


def test_writer_static_and_dyn_agree_with_oracle():
    rng = np.random.default_rng(0)
    for _ in range(20):
        fields = []
        ofs = 0
        while ofs < 120:
            count = int(rng.integers(1, 9))
            if ofs + count > 128:
                break
            fields.append((ofs, count, int(rng.integers(0, 1 << count))))
            ofs += count
        expected = 0
        for o, c, v in fields:
            expected |= v << o

        w1 = LaneWriter((1,), 4)
        w2 = LaneWriter((1,), 4)
        for o, c, v in fields:
            w1.put(jnp.full((1,), v, jnp.uint32), o, c)
            w2.put_dyn(jnp.full((1,), v, jnp.uint32), jnp.full((1,), o, jnp.int32), c)
        for w in (w1, w2):
            lanes = np.asarray(w.stack())
            got = sum(int(lanes[0, k]) << (32 * k) for k in range(4))
            assert got == expected


def test_bitrev():
    v = jnp.asarray(np.array([0b10110], np.uint32))
    assert int(bitrev(v, 5)[0]) == 0b01101


def test_bitrev_closed_forms_exhaustive():
    """The per-count closed forms (batch 4) equal the generic per-bit loop
    for every 8-bit input and every count 1..8 - including inputs with
    garbage bits above `count`, which both forms must ignore."""
    v = jnp.asarray(np.arange(256, dtype=np.uint32))
    for count in range(1, 9):
        ref = np.zeros(256, np.uint32)
        for i in range(count):
            ref |= (((np.arange(256) >> i) & 1) << (count - 1 - i)).astype(np.uint32)
        np.testing.assert_array_equal(np.asarray(bitrev(v, count)), ref, err_msg=f"count={count}")


def test_lane_byte_round_trip():
    rng = np.random.default_rng(1)
    b = rng.integers(0, 256, size=(5, 16), dtype=np.uint8)
    lanes = lanes_from_bytes_np(b, 4)
    np.testing.assert_array_equal(bytes_from_lanes_np(lanes), b)


def test_lut_lookup_integer_and_float_tables():
    """Integer tables keep their low 32 bits as int32 (uint32 words with the
    top bit set, int64 sources); float32 tables pass through unchanged."""
    from basisu_rs_jax.ops.bits import lut_lookup

    words = np.array([0, 1, 0xFFFFFFFF, 0x80000000], np.uint32)
    idx = jnp.asarray(np.array([[3, 2], [1, 0]], np.int32))
    got = np.asarray(lut_lookup(words, idx))
    assert got.dtype == np.int32
    np.testing.assert_array_equal(got.view(np.uint32), words[np.asarray(idx)])
    wide = np.array([1 << 40 | 7, -1], np.int64)
    np.testing.assert_array_equal(np.asarray(lut_lookup(wide, jnp.arange(2))), [7, -1])
    f = np.array([0.5, 1 / 3], np.float32)
    got = np.asarray(lut_lookup(f, jnp.asarray([1, 0])))
    assert got.dtype == np.float32
    np.testing.assert_array_equal(got, f[[1, 0]])
