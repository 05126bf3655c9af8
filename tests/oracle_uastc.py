"""Test-only UASTC oracle: an independent transcription of the reference's
UASTC -> RGBA block decoder, used to differential-fuzz the vectorized kernels
over RANDOM blocks (the committed golden corpus covers only 32 blocks per
mode; this closes the field-combination gap).

Transcribed line-by-line from:
  - /root/reference/src/bitreader.rs                 (_OBitReader)
  - /root/reference/src/uastc.rs:237-341             (decode_block_to_rgba,
    decode_mode, decode_compsel, decode_pattern_index, get_pattern)
  - /root/reference/src/uastc.rs:378-394             (anchors, mode 8)
  - /root/reference/src/uastc.rs:585-740             (BISE endpoint decode /
    unquant, weight decode / unquant)
  - /root/reference/src/uastc.rs:176-235             (endpoint pair assembly,
    astc_interpolate)
  - /root/reference/src/uastc.rs:527-577,742-811     (MODES, MODE_LUT,
    patterns, anchors)
  - /root/reference/src/target_formats/astc.rs:300-331 (BISE_RANGES)

This module deliberately shares NO code with basisu_rs_jax (no imports from
the package): it is a second, naive, sequential implementation whose value is
exactly its independence.  Do not refactor it to reuse package helpers.
"""

from __future__ import annotations


class OracleUastcError(Exception):
    """Mirrors the reference's Err(String) sites in the RGBA decode path."""


# -- bitreader.rs ------------------------------------------------------------


class _OBitReader:
    def __init__(self, data: bytes):
        self.data = data
        self.bit_pos = 0

    def peek(self, count: int) -> int:
        assert count <= 32
        byte = self.bit_pos // 8
        bit = self.bit_pos % 8
        result = (self.data[byte] if byte < len(self.data) else 0) >> bit
        read = 8 - bit
        byte += 1
        while read < count:
            result |= (self.data[byte] if byte < len(self.data) else 0) << read
            read += 8
            byte += 1
        return result & ((1 << count) - 1)

    def remove(self, count: int) -> None:
        self.bit_pos += count

    def read(self, count: int) -> int:
        v = self.peek(count)
        self.remove(count)
        return v


# -- uastc.rs:527-557 MODES --------------------------------------------------
# (id, code_size, endpoint_range_index, format, weight_bits, plane_count,
#  subset_count, trans_flags_bits); format: 0=RGB, 1=RGBA, 2=LA

_RGB, _RGBA, _LA = 0, 1, 2

_MODES = [
    (0, 4, 19, _RGB, 4, 1, 1, 15),
    (1, 6, 20, _RGB, 2, 1, 1, 15),
    (2, 5, 8, _RGB, 3, 1, 2, 15),
    (3, 5, 7, _RGB, 2, 1, 3, 15),
    (4, 5, 12, _RGB, 2, 1, 2, 15),
    (5, 5, 20, _RGB, 3, 1, 1, 15),
    (6, 5, 18, _RGB, 2, 2, 1, 15),
    (7, 5, 12, _RGB, 2, 1, 2, 15),
    (8, 5, 0, _RGBA, 0, 1, 1, 0),
    (9, 5, 8, _RGBA, 2, 1, 2, 23),
    (10, 3, 13, _RGBA, 4, 1, 1, 17),
    (11, 2, 13, _RGBA, 2, 2, 1, 17),
    (12, 3, 19, _RGBA, 3, 1, 1, 17),
    (13, 5, 20, _RGBA, 1, 2, 1, 23),
    (14, 5, 20, _RGBA, 2, 1, 1, 23),
    (15, 7, 20, _LA, 4, 1, 1, 23),
    (16, 6, 20, _LA, 2, 1, 2, 23),
    (17, 6, 20, _LA, 2, 2, 1, 23),
    (18, 4, 11, _RGB, 5, 1, 1, 15),
]

# uastc.rs:559-577
_MODE_LUT = [
    11, 0, 10, 3, 11, 15, 12, 7,
    11, 18, 10, 5, 11, 14, 12, 9,
    11, 0, 10, 4, 11, 16, 12, 8,
    11, 18, 10, 6, 11, 2, 12, 13,
    11, 0, 10, 3, 11, 17, 12, 7,
    11, 18, 10, 5, 11, 14, 12, 9,
    11, 0, 10, 4, 11, 1, 12, 8,
    11, 18, 10, 6, 11, 2, 12, 13,
    11, 0, 10, 3, 11, 19, 12, 7,
    11, 18, 10, 5, 11, 14, 12, 9,
    11, 0, 10, 4, 11, 16, 12, 8,
    11, 18, 10, 6, 11, 2, 12, 13,
    11, 0, 10, 3, 11, 17, 12, 7,
    11, 18, 10, 5, 11, 14, 12, 9,
    11, 0, 10, 4, 11, 1, 12, 8,
    11, 18, 10, 6, 11, 2, 12, 13,
]

# astc.rs:309-331 BISE_RANGES: (bits, trits, quints, deq_b, deq_c)
_BISE_RANGES = [
    (1, 0, 0, "         ", 0),
    (0, 1, 0, "         ", 0),
    (2, 0, 0, "         ", 0),
    (0, 0, 1, "         ", 0),
    (1, 1, 0, "000000000", 204),
    (3, 0, 0, "         ", 0),
    (1, 0, 1, "000000000", 113),
    (2, 1, 0, "b000b0bb0", 93),
    (4, 0, 0, "         ", 0),
    (2, 0, 1, "b0000bb00", 54),
    (3, 1, 0, "cb000cbcb", 44),
    (5, 0, 0, "         ", 0),
    (3, 0, 1, "cb0000cbc", 26),
    (4, 1, 0, "dcb000dcb", 22),
    (6, 0, 0, "         ", 0),
    (4, 0, 1, "dcb0000dc", 13),
    (5, 1, 0, "edcb000ed", 11),
    (7, 0, 0, "         ", 0),
    (5, 0, 1, "edcb0000e", 6),
    (6, 1, 0, "fedcb000f", 5),
    (8, 0, 0, "         ", 0),
]

# uastc.rs:742-811 pattern and anchor tables
_PATTERNS_2 = [
    [0,0,1,1,0,0,1,1,0,0,1,1,0,0,1,1], [0,0,0,1,0,0,0,1,0,0,0,1,0,0,0,1],
    [1,0,0,0,1,0,0,0,1,0,0,0,1,0,0,0], [0,0,0,1,0,0,1,1,0,0,1,1,0,1,1,1],
    [1,1,1,1,1,1,1,0,1,1,1,0,1,1,0,0], [0,0,1,1,0,1,1,1,0,1,1,1,1,1,1,1],
    [1,1,1,0,1,1,0,0,1,0,0,0,0,0,0,0], [1,1,1,1,1,1,1,0,1,1,0,0,1,0,0,0],
    [0,0,0,0,0,0,0,0,0,0,0,1,0,0,1,1], [1,1,0,0,1,0,0,0,0,0,0,0,0,0,0,0],
    [0,0,0,0,0,0,0,1,0,1,1,1,1,1,1,1], [1,1,1,1,1,1,1,1,1,1,1,0,1,0,0,0],
    [1,1,1,0,1,0,0,0,0,0,0,0,0,0,0,0], [1,1,1,1,1,1,1,1,0,0,0,0,0,0,0,0],
    [0,0,0,0,1,1,1,1,1,1,1,1,1,1,1,1], [1,1,1,1,1,1,1,1,1,1,1,1,0,0,0,0],
    [1,0,0,0,1,1,1,0,1,1,1,1,1,1,1,1], [1,1,1,1,1,1,1,1,0,1,1,1,0,0,0,1],
    [0,1,1,1,0,0,1,1,0,0,0,1,0,0,0,0], [0,0,1,1,0,0,0,1,0,0,0,0,0,0,0,0],
    [0,0,0,0,1,0,0,0,1,1,0,0,1,1,1,0], [1,1,1,1,1,1,1,1,0,1,1,1,0,0,1,1],
    [1,0,0,0,1,1,0,0,1,1,0,0,1,1,1,0], [0,0,1,1,0,0,0,1,0,0,0,1,0,0,0,0],
    [1,1,1,1,0,1,1,1,0,1,1,1,0,0,1,1], [0,1,1,0,0,1,1,0,0,1,1,0,0,1,1,0],
    [1,1,1,1,0,0,0,0,0,0,0,0,1,1,1,1], [1,0,1,0,1,0,1,0,1,0,1,0,1,0,1,0],
    [1,1,1,1,0,0,0,0,1,1,1,1,0,0,0,0], [1,0,0,1,0,0,1,1,0,1,1,0,1,1,0,0],
]

_PATTERNS_3 = [
    [0,0,0,0,0,0,0,0,1,1,2,2,1,1,2,2], [1,1,1,1,1,1,1,1,0,0,0,0,2,2,2,2],
    [1,1,1,1,0,0,0,0,0,0,0,0,2,2,2,2], [1,1,1,1,2,2,2,2,0,0,0,0,0,0,0,0],
    [1,1,2,0,1,1,2,0,1,1,2,0,1,1,2,0], [0,1,1,2,0,1,1,2,0,1,1,2,0,1,1,2],
    [0,2,1,1,0,2,1,1,0,2,1,1,0,2,1,1], [2,0,0,0,2,0,0,0,2,1,1,1,2,1,1,1],
    [2,0,1,2,2,0,1,2,2,0,1,2,2,0,1,2], [1,1,1,1,0,0,0,0,2,2,2,2,1,1,1,1],
    [0,0,2,2,0,0,1,1,0,0,1,1,0,0,2,2],
]

_PATTERNS_2_3 = [
    [0,0,0,0,1,1,1,1,0,0,0,0,0,0,0,0], [0,0,1,0,0,0,1,0,0,0,1,0,0,0,1,0],
    [1,1,0,0,1,1,0,0,1,0,0,0,0,0,0,0], [0,0,0,0,0,0,0,1,0,0,1,1,0,0,1,1],
    [1,1,1,1,1,1,1,1,0,0,0,0,1,1,1,1], [0,1,0,0,0,1,0,0,0,1,0,0,0,1,0,0],
    [0,0,0,1,0,0,1,1,1,1,1,1,1,1,1,1], [0,1,1,1,0,0,1,1,0,0,1,1,0,0,1,1],
    [1,1,0,0,0,0,0,0,0,0,1,1,1,1,0,0], [0,1,1,1,0,1,1,1,0,0,0,0,0,0,0,0],
    [0,0,0,0,0,0,0,0,1,1,1,0,1,1,1,0], [1,1,0,0,0,0,0,0,0,0,0,0,1,1,0,0],
    [0,1,1,1,0,0,1,1,0,0,0,0,0,0,0,0], [0,0,0,0,0,0,0,1,1,1,1,1,1,1,1,1],
    [1,1,1,1,1,1,1,1,1,1,1,1,0,1,1,0], [1,1,0,0,1,1,0,0,1,1,0,0,1,0,0,0],
    [1,1,1,1,1,1,1,1,1,0,0,0,1,0,0,0], [0,0,1,1,0,1,1,0,1,1,0,0,1,0,0,0],
    [1,1,1,1,0,1,1,1,0,0,0,0,0,0,0,0],
]

_PATTERNS_2_ANCHORS = [
    [0, 2], [0, 3], [1, 0], [0, 3], [7, 0], [0, 2], [3, 0],
    [7, 0], [0, 11], [2, 0], [0, 7], [11, 0], [3, 0], [8, 0],
    [0, 4], [12, 0], [1, 0], [8, 0], [0, 1], [0, 2], [0, 4],
    [8, 0], [1, 0], [0, 2], [4, 0], [0, 1], [4, 0], [1, 0],
    [4, 0], [1, 0],
]

_PATTERNS_3_ANCHORS = [
    [0, 8, 10], [8, 0, 12], [4, 0, 12], [8, 0, 4], [3, 0, 2],
    [0, 1, 3], [0, 2, 1], [1, 9, 0], [1, 2, 0], [4, 0, 8], [0, 6, 2],
]

_PATTERNS_2_3_ANCHORS = [
    [0, 4], [0, 2], [2, 0], [0, 7], [8, 0], [0, 1], [0, 3],
    [0, 1], [2, 0], [0, 1], [0, 8], [2, 0], [0, 1], [0, 7],
    [12, 0], [2, 0], [9, 0], [0, 2], [4, 0],
]

# uastc.rs:697-705 weight unquant LUTs
_WEIGHT_LUTS = {
    1: [0, 64],
    2: [0, 21, 43, 64],
    3: [0, 9, 18, 27, 37, 46, 55, 64],
    4: [0, 4, 8, 12, 17, 21, 25, 29, 35, 39, 43, 47, 52, 56, 60, 64],
    5: [0, 2, 4, 6, 8, 10, 12, 14, 16, 18, 20, 22, 24, 26, 28, 30, 34, 36,
        38, 40, 42, 44, 46, 48, 50, 52, 54, 56, 58, 60, 62, 64],
}


# -- uastc.rs:585-614 unquant_endpoint ---------------------------------------


def _unquant_endpoint(trit_quint: int, bits_val: int, range_index: int) -> int:
    bits, trits, quints, deq_b, deq_c = _BISE_RANGES[range_index]
    quant_bits = bits_val
    if trits == 0 and quints == 0 and bits > 0:
        bits_la = (quant_bits << (8 - bits)) & 0xFFFF
        val = 0
        while bits_la > 0:
            val |= bits_la
            bits_la >>= bits
        return val & 0xFF
    a = 511 if (quant_bits & 1) != 0 else 0
    b = 0
    for j in range(9):
        b = (b << 1) & 0xFFFF
        shift = ord(deq_b[j])
        if shift != ord("0"):
            b |= (quant_bits >> (shift - ord("a"))) & 0x1
    c = deq_c
    d = trit_quint
    val = (d * c + b) & 0xFFFF
    val ^= a
    return ((a & 0x80) | (val >> 2)) & 0xFF


# -- uastc.rs:616-695 decode_endpoints ---------------------------------------


def _decode_endpoints(r: _OBitReader, range_index: int, value_count: int):
    bits, trits, quints, _, _ = _BISE_RANGES[range_index]
    trit_quints = [0] * value_count
    bit_vals = [0] * value_count

    if quints > 0:
        out_pos = 0
        for _ in range(value_count // 3):
            q = r.read(7)
            for _ in range(3):
                trit_quints[out_pos] = q % 5
                q //= 5
                out_pos += 1
        remaining = value_count - out_pos
        if remaining > 0:
            bits_used = {1: 3, 2: 5}[remaining]
            q = r.read(bits_used)
            for _ in range(remaining):
                trit_quints[out_pos] = q % 5
                q //= 5
                out_pos += 1

    if trits > 0:
        out_pos = 0
        for _ in range(value_count // 5):
            t = r.read(8)
            for _ in range(5):
                trit_quints[out_pos] = t % 3
                t //= 3
                out_pos += 1
        remaining = value_count - out_pos
        if remaining > 0:
            bits_used = {1: 2, 2: 4, 3: 5, 4: 7}[remaining]
            t = r.read(bits_used)
            for _ in range(remaining):
                trit_quints[out_pos] = t % 3
                t //= 3
                out_pos += 1

    if bits > 0:
        for i in range(value_count):
            bit_vals[i] = r.read(bits)

    return trit_quints, bit_vals


# -- uastc.rs:721-740 decode_weights -----------------------------------------


def _anchor_indices(mode_id: int, subset_count: int, pat: int):
    if mode_id == 7:
        return _PATTERNS_2_3_ANCHORS[pat]
    if subset_count == 1:
        return [0]
    if subset_count == 2:
        return _PATTERNS_2_ANCHORS[pat]
    return _PATTERNS_3_ANCHORS[pat]


def _decode_weights(r: _OBitReader, mode, pat: int):
    _, _, _, _, weight_bits, plane_count, subset_count, _ = mode
    mode_id = mode[0]
    bits = [weight_bits] * 16
    for anchor in _anchor_indices(mode_id, subset_count, pat):
        bits[anchor] = weight_bits - 1
    weights = []
    for i in range(16):
        for _plane in range(plane_count):
            weights.append(r.read(bits[i]))
    lut = _WEIGHT_LUTS[weight_bits]
    return [lut[w] for w in weights]


# -- uastc.rs:176-235 assembly + interpolation -------------------------------


def _assemble_endpoint_pairs(fmt: int, endpoint_bytes):
    # chunks_exact semantics: a trailing partial chunk is dropped, and (as in
    # the reference's [[Color32; 2]; 3] zip) at most 3 pairs are produced
    pairs = []
    step = {_RGB: 6, _RGBA: 8, _LA: 4}[fmt]
    for i in range(0, len(endpoint_bytes) - step + 1, step):
        if len(pairs) == 3:
            break
        b = endpoint_bytes[i : i + step]
        if fmt == _RGB:
            pairs.append(((b[0], b[2], b[4], 0xFF), (b[1], b[3], b[5], 0xFF)))
        elif fmt == _RGBA:
            pairs.append(((b[0], b[2], b[4], b[6]), (b[1], b[3], b[5], b[7])))
        else:  # LA
            pairs.append(((b[0], b[0], b[0], b[2]), (b[1], b[1], b[1], b[3])))
    return pairs


def _astc_interpolate(l: int, h: int, w: int) -> int:
    # srgb = false path
    l = (l << 8) | l
    h = (h << 8) | h
    k = (l * (64 - w) + h * w + 32) >> 6
    return (k >> 8) & 0xFF


# -- uastc.rs:237-327 decode_block_to_rgba -----------------------------------


def decode_block_to_rgba(block: bytes):
    """16 UASTC block bytes -> list of 16 (r, g, b, a) texels (raster order).

    Raises OracleUastcError exactly at the reference's Err sites."""
    assert len(block) == 16
    r = _OBitReader(block)

    mode_code = r.peek(7)
    mode_index = _MODE_LUT[mode_code]
    if mode_index >= len(_MODES):
        raise OracleUastcError("invalid mode index")
    mode = _MODES[mode_index]
    (mode_id, code_size, range_index, fmt, weight_bits, plane_count,
     subset_count, trans_flags_bits) = mode
    r.remove(code_size)

    if mode_id == 8:
        rgba = (r.read(8), r.read(8), r.read(8), r.read(8))
        return [rgba] * 16

    r.remove(trans_flags_bits)

    # compsel (uastc.rs:343-350)
    if plane_count == 2 and fmt == _LA:
        compsel = 3
    elif plane_count == 2:
        compsel = r.read(2)
    else:
        compsel = 0

    # pattern index (uastc.rs:352-366)
    if mode_id == 7:
        pat, pattern_count = r.read(5), 19
    elif subset_count == 1:
        pat, pattern_count = 0, 1
    elif subset_count == 2:
        pat, pattern_count = r.read(5), 30
    else:
        pat, pattern_count = r.read(4), 11
    if pat >= pattern_count:
        raise OracleUastcError("block pattern is not valid")

    channel_count = {_RGB: 3, _RGBA: 4, _LA: 2}[fmt]
    endpoint_count = channel_count * subset_count * 2

    trit_quints, bit_vals = _decode_endpoints(r, range_index, endpoint_count)
    endpoints = [
        _unquant_endpoint(trit_quints[i], bit_vals[i], range_index)
        for i in range(endpoint_count)
    ]

    weights = _decode_weights(r, mode, pat)

    output = []
    if subset_count == 1:
        e0, e1 = _assemble_endpoint_pairs(fmt, endpoints)[0]
        if plane_count == 1:
            assert len(weights) == 16
            for w in weights:
                output.append(tuple(
                    _astc_interpolate(e0[c], e1[c], w) for c in range(4)
                ))
        else:
            assert len(weights) == 32
            for i in range(16):
                ws = weights[2 * i : 2 * i + 2]
                wc = [ws[1] if compsel == c else ws[0] for c in range(4)]
                output.append(tuple(
                    _astc_interpolate(e0[c], e1[c], wc[c]) for c in range(4)
                ))
    else:
        pairs = _assemble_endpoint_pairs(fmt, endpoints)
        if mode_id == 7:
            pattern = _PATTERNS_2_3[pat]
        elif subset_count == 2:
            pattern = _PATTERNS_2[pat]
        else:
            pattern = _PATTERNS_3[pat]
        assert len(weights) == 16
        for subset, w in zip(pattern, weights):
            e0, e1 = pairs[subset]
            output.append(tuple(
                _astc_interpolate(e0[c], e1[c], w) for c in range(4)
            ))
    return output


# -- bitwriter.rs ------------------------------------------------------------


class _OBitWriterLsb:
    def __init__(self, out: bytearray):
        self.out = out
        self.bit_pos = 0

    def write(self, count: int, v: int) -> None:
        assert count <= 32
        v &= (1 << count) - 1
        byte = self.bit_pos // 8
        bit = self.bit_pos % 8
        if byte < len(self.out):
            self.out[byte] |= (v << bit) & 0xFF
        written = 8 - bit
        byte += 1
        self.bit_pos += count
        while written < count:
            if byte < len(self.out):
                self.out[byte] |= (v >> written) & 0xFF
            written += 8
            byte += 1


class _OBitWriterMsbRevBytes:
    """MSB writer filling the buffer from the end (bitwriter.rs:57-114)."""

    def __init__(self, out: bytearray):
        self.out = out
        self.bit_pos = len(out) * 8

    def write(self, count: int, v: int) -> None:
        assert count <= 32
        v &= (1 << count) - 1
        self.bit_pos -= count
        byte = self.bit_pos // 8
        bit = self.bit_pos % 8
        if 0 <= byte < len(self.out):
            self.out[byte] |= (v << bit) & 0xFF
        written = 8 - bit
        byte += 1
        while written < count:
            if 0 <= byte < len(self.out):
                self.out[byte] |= (v >> written) & 0xFF
            written += 8
            byte += 1

    def write_rev_bits(self, count: int, v: int) -> None:
        # v.reverse_bits() >> (32 - count); count == 0 is a no-op write
        rev = int(f"{v & 0xFFFFFFFF:032b}"[::-1], 2)
        self.write(count, rev >> (32 - count) if count else rev)


# -- astc.rs:183-217,247-264,332-354 writer tables ---------------------------

_UASTC_TO_ASTC_BLOCK_MODE_13 = [
    0x0242, 0x0042, 0x0853, 0x1042, 0x0842, 0x0053, 0x0442, 0x0842, 0,
    0x0842, 0x0242, 0x0442, 0x0053, 0x0441, 0x0042, 0x0242, 0x0842, 0x0442,
    0x0253, 0,
]

_PATTERNS_2_ASTC_INDEX_10 = [
    28, 20, 16, 29, 91, 9, 107, 72, 149, 204, 50, 114, 496, 17, 78, 39, 252,
    828, 43, 156, 116, 210, 476, 273, 684, 359, 246, 195, 694, 524,
]

_PATTERNS_3_ASTC_INDEX_10 = [260, 74, 32, 156, 183, 15, 745, 0, 335, 902, 254]

_PATTERNS_2_3_ASTC_INDEX_10 = [
    36, 48, 61, 137, 161, 183, 226, 281, 302, 307, 479, 495, 593, 594, 605,
    799, 812, 988, 993,
]

_ASTC_QUINT_ENCODE_LUT = [
    0x00, 0x01, 0x02, 0x03, 0x04, 0x08, 0x09, 0x0A, 0x0B, 0x0C, 0x10, 0x11,
    0x12, 0x13, 0x14, 0x18, 0x19, 0x1A, 0x1B, 0x1C, 0x05, 0x0D, 0x15, 0x1D,
    0x06, 0x20, 0x21, 0x22, 0x23, 0x24, 0x28, 0x29, 0x2A, 0x2B, 0x2C, 0x30,
    0x31, 0x32, 0x33, 0x34, 0x38, 0x39, 0x3A, 0x3B, 0x3C, 0x25, 0x2D, 0x35,
    0x3D, 0x0E, 0x40, 0x41, 0x42, 0x43, 0x44, 0x48, 0x49, 0x4A, 0x4B, 0x4C,
    0x50, 0x51, 0x52, 0x53, 0x54, 0x58, 0x59, 0x5A, 0x5B, 0x5C, 0x45, 0x4D,
    0x55, 0x5D, 0x16, 0x60, 0x61, 0x62, 0x63, 0x64, 0x68, 0x69, 0x6A, 0x6B,
    0x6C, 0x70, 0x71, 0x72, 0x73, 0x74, 0x78, 0x79, 0x7A, 0x7B, 0x7C, 0x65,
    0x6D, 0x75, 0x7D, 0x1E, 0x66, 0x67, 0x46, 0x47, 0x26, 0x6E, 0x6F, 0x4E,
    0x4F, 0x2E, 0x76, 0x77, 0x56, 0x57, 0x36, 0x7E, 0x7F, 0x5E, 0x5F, 0x3E,
    0x27, 0x2F, 0x37, 0x3F, 0x1F,
]

_ASTC_TRIT_ENCODE_LUT = [
    0x00, 0x01, 0x02, 0x04, 0x05, 0x06, 0x08, 0x09, 0x0A, 0x10, 0x11, 0x12,
    0x14, 0x15, 0x16, 0x18, 0x19, 0x1A, 0x03, 0x07, 0x0B, 0x13, 0x17, 0x1B,
    0x0C, 0x0D, 0x0E, 0x20, 0x21, 0x22, 0x24, 0x25, 0x26, 0x28, 0x29, 0x2A,
    0x30, 0x31, 0x32, 0x34, 0x35, 0x36, 0x38, 0x39, 0x3A, 0x23, 0x27, 0x2B,
    0x33, 0x37, 0x3B, 0x2C, 0x2D, 0x2E, 0x40, 0x41, 0x42, 0x44, 0x45, 0x46,
    0x48, 0x49, 0x4A, 0x50, 0x51, 0x52, 0x54, 0x55, 0x56, 0x58, 0x59, 0x5A,
    0x43, 0x47, 0x4B, 0x53, 0x57, 0x5B, 0x4C, 0x4D, 0x4E, 0x80, 0x81, 0x82,
    0x84, 0x85, 0x86, 0x88, 0x89, 0x8A, 0x90, 0x91, 0x92, 0x94, 0x95, 0x96,
    0x98, 0x99, 0x9A, 0x83, 0x87, 0x8B, 0x93, 0x97, 0x9B, 0x8C, 0x8D, 0x8E,
    0xA0, 0xA1, 0xA2, 0xA4, 0xA5, 0xA6, 0xA8, 0xA9, 0xAA, 0xB0, 0xB1, 0xB2,
    0xB4, 0xB5, 0xB6, 0xB8, 0xB9, 0xBA, 0xA3, 0xA7, 0xAB, 0xB3, 0xB7, 0xBB,
    0xAC, 0xAD, 0xAE, 0xC0, 0xC1, 0xC2, 0xC4, 0xC5, 0xC6, 0xC8, 0xC9, 0xCA,
    0xD0, 0xD1, 0xD2, 0xD4, 0xD5, 0xD6, 0xD8, 0xD9, 0xDA, 0xC3, 0xC7, 0xCB,
    0xD3, 0xD7, 0xDB, 0xCC, 0xCD, 0xCE, 0x60, 0x61, 0x62, 0x64, 0x65, 0x66,
    0x68, 0x69, 0x6A, 0x70, 0x71, 0x72, 0x74, 0x75, 0x76, 0x78, 0x79, 0x7A,
    0x63, 0x67, 0x6B, 0x73, 0x77, 0x7B, 0x6C, 0x6D, 0x6E, 0xE0, 0xE1, 0xE2,
    0xE4, 0xE5, 0xE6, 0xE8, 0xE9, 0xEA, 0xF0, 0xF1, 0xF2, 0xF4, 0xF5, 0xF6,
    0xF8, 0xF9, 0xFA, 0xE3, 0xE7, 0xEB, 0xF3, 0xF7, 0xFB, 0xEC, 0xED, 0xEE,
    0x1C, 0x1D, 0x1E, 0x3C, 0x3D, 0x3E, 0x5C, 0x5D, 0x5E, 0x9C, 0x9D, 0x9E,
    0xBC, 0xBD, 0xBE, 0xDC, 0xDD, 0xDE, 0x1F, 0x3F, 0x5F, 0x9F, 0xBF, 0xDF,
    0x7C, 0x7D, 0x7E,
]


# -- astc.rs:8-181 convert_block_from_uastc ----------------------------------


def _decode_weights_raw(r: _OBitReader, mode, pat: int):
    """decode_weights without unquantization: the consumer-order raw values."""
    mode_id, _, _, _, weight_bits, plane_count, subset_count, _ = mode
    bits = [weight_bits] * 16
    for anchor in _anchor_indices(mode_id, subset_count, pat):
        bits[anchor] = weight_bits - 1
    out = []
    for i in range(16):
        for _plane in range(plane_count):
            out.append(r.read(bits[i]))
    return out


def convert_block_to_astc(block: bytes) -> bytes:
    """16 UASTC block bytes -> 16 ASTC block bytes (astc.rs:8-181)."""
    assert len(block) == 16
    r = _OBitReader(block)

    mode_code = r.peek(7)
    mode_index = _MODE_LUT[mode_code]
    if mode_index >= len(_MODES):
        raise OracleUastcError("invalid mode index")
    mode = _MODES[mode_index]
    (mode_id, code_size, range_index, fmt, weight_bits, plane_count,
     subset_count, trans_flags_bits) = mode
    r.remove(code_size)

    output = bytearray(16)
    w = _OBitWriterLsb(output)

    if mode_id == 8:
        rgba = [r.read(8) for _ in range(4)]
        w.write(12, 0b1101_1111_1100)
        w.write(20, 0x000F_FFFF)
        w.write(32, 0xFFFF_FFFF)
        for c in rgba:
            w.write(16, (c << 8) | c)
        return bytes(output)

    r.remove(trans_flags_bits)

    if plane_count == 2 and fmt == _LA:
        compsel = 3
    elif plane_count == 2:
        compsel = r.read(2)
    else:
        compsel = 0

    if mode_id == 7:
        pat, pattern_count = r.read(5), 19
    elif subset_count == 1:
        pat, pattern_count = 0, 1
    elif subset_count == 2:
        pat, pattern_count = r.read(5), 30
    else:
        pat, pattern_count = r.read(4), 11
    if pat >= pattern_count:
        raise OracleUastcError("block pattern is not valid")

    channel_count = {_RGB: 3, _RGBA: 4, _LA: 2}[fmt]
    endpoint_count = channel_count * subset_count * 2

    trit_quints, bit_vals = _decode_endpoints(r, range_index, endpoint_count)
    # the reference's fixed [QuantEndpoint; 18]: defaults beyond value_count
    trit_quints = trit_quints + [0] * (18 - len(trit_quints))
    bit_vals = bit_vals + [0] * (18 - len(bit_vals))

    invert_subset_weights = [False, False, False]
    if fmt != _LA:  # mode.has_blue()
        eps = endpoint_count // subset_count
        for subset in range(subset_count):
            lo = subset * eps
            e = [
                _unquant_endpoint(trit_quints[lo + i], bit_vals[lo + i], range_index)
                for i in range(6)
            ]
            s0 = e[0] + e[2] + e[4]
            s1 = e[1] + e[3] + e[5]
            if s0 > s1:
                invert_subset_weights[subset] = True
                for p in range(lo, lo + eps, 2):
                    trit_quints[p], trit_quints[p + 1] = (
                        trit_quints[p + 1],
                        trit_quints[p],
                    )
                    bit_vals[p], bit_vals[p + 1] = bit_vals[p + 1], bit_vals[p]

    # block mode + config bits
    w.write(13, _UASTC_TO_ASTC_BLOCK_MODE_13[mode_id])
    if mode_id == 7:
        astc_pat = _PATTERNS_2_3_ASTC_INDEX_10[pat]
    elif subset_count == 1:
        astc_pat = None
    elif subset_count == 2:
        astc_pat = _PATTERNS_2_ASTC_INDEX_10[pat]
    else:
        astc_pat = _PATTERNS_3_ASTC_INDEX_10[pat]
    if astc_pat is not None:
        w.write(10, astc_pat)
        w.write(2, 0b00)
    cem = {_RGB: 8, _RGBA: 12, _LA: 4}[fmt]
    w.write(4, cem)

    # endpoints (over the full padded 18-entry array, as the reference does)
    bits, trits, quints, _, _ = _BISE_RANGES[range_index]
    if quints > 0:
        for lo in range(0, 18, 3):
            chunk_tq = trit_quints[lo : lo + 3]
            q_lut_id = 0
            for tq in reversed(chunk_tq):
                q_lut_id = q_lut_id * 5 + tq
            q = _ASTC_QUINT_ENCODE_LUT[q_lut_id]
            w.write(bits, bit_vals[lo])
            w.write(3, q)
            w.write(bits, bit_vals[lo + 1] if lo + 1 < 18 else 0)
            w.write(2, q >> 3)
            w.write(bits, bit_vals[lo + 2] if lo + 2 < 18 else 0)
            w.write(2, q >> 5)
    elif trits > 0:
        for lo in range(0, 18, 5):
            chunk_tq = trit_quints[lo : lo + 5]
            t_lut_id = 0
            for tq in reversed(chunk_tq):
                t_lut_id = t_lut_id * 3 + tq
            t = _ASTC_TRIT_ENCODE_LUT[t_lut_id]
            w.write(bits, bit_vals[lo])
            w.write(2, t)
            w.write(bits, bit_vals[lo + 1] if lo + 1 < 18 else 0)
            w.write(2, t >> 2)
            w.write(bits, bit_vals[lo + 2] if lo + 2 < 18 else 0)
            w.write(1, t >> 4)
            w.write(bits, bit_vals[lo + 3] if lo + 3 < 18 else 0)
            w.write(2, t >> 5)
            w.write(bits, bit_vals[lo + 4] if lo + 4 < 18 else 0)
            w.write(1, t >> 7)
    else:
        for i in range(18):
            w.write(bits, bit_vals[i])

    # weights + CCS from the end
    wrev = _OBitWriterMsbRevBytes(output)
    raw_weights = _decode_weights_raw(r, mode, pat)
    if subset_count == 1:
        inv = invert_subset_weights[0]
        for weight in raw_weights:
            wrev.write_rev_bits(weight_bits, ~weight if inv else weight)
    else:
        if mode_id == 7:
            pattern = _PATTERNS_2_3[pat]
        elif subset_count == 2:
            pattern = _PATTERNS_2[pat]
        else:
            pattern = _PATTERNS_3[pat]
        for i, weight in enumerate(raw_weights):
            texel_id = i // plane_count
            subset = pattern[texel_id]
            inv = invert_subset_weights[subset]
            wrev.write_rev_bits(weight_bits, ~weight if inv else weight)
    if plane_count != 1:
        wrev.write(2, compsel)

    return bytes(output)


# -- target_formats/etc.rs ---------------------------------------------------

_SELECTOR_ID_TO_ETC1 = [0b11, 0b10, 0b00, 0b01]

_ETC1_MODIFIERS = [
    [-8, -2, 2, 8], [-17, -5, 5, 17], [-29, -9, 9, 29], [-42, -13, 13, 42],
    [-60, -18, 18, 60], [-80, -24, 24, 80], [-106, -33, 33, 106],
    [-183, -47, 47, 183],
]

_ETC2_ALPHA_MODIFIERS = [
    [-3, -6, -9, -15, 2, 5, 8, 14], [-3, -7, -10, -13, 2, 6, 9, 12],
    [-2, -5, -8, -13, 1, 4, 7, 12], [-2, -4, -6, -13, 1, 3, 5, 12],
    [-3, -6, -8, -12, 2, 5, 7, 11], [-3, -7, -9, -11, 2, 6, 8, 10],
    [-4, -7, -8, -11, 3, 6, 7, 10], [-3, -5, -8, -11, 2, 4, 7, 10],
    [-2, -6, -8, -10, 1, 5, 7, 9], [-2, -5, -8, -10, 1, 4, 7, 9],
    [-2, -4, -8, -10, 1, 3, 7, 9], [-2, -5, -7, -10, 1, 4, 6, 9],
    [-3, -4, -7, -10, 2, 3, 6, 9], [-1, -2, -3, -10, 0, 1, 2, 9],
    [-4, -6, -8, -9, 3, 5, 7, 8], [-3, -5, -7, -9, 2, 4, 6, 8],
]


class _OSelector:
    """etc.rs:343-395 (only the etc1_bytes wire half is consumed)."""

    def __init__(self):
        self.etc1_bytes = [0, 0, 0, 0]

    def set_selector(self, x: int, y: int, val: int) -> None:
        mod_id = _SELECTOR_ID_TO_ETC1[val]
        pixel_id = x * 4 + y
        ms_byte_id = 1 - pixel_id // 8
        ls_byte_id = ms_byte_id + 2
        bit_id = pixel_id % 8
        self.etc1_bytes[ls_byte_id] &= ~(1 << bit_id) & 0xFF
        self.etc1_bytes[ls_byte_id] |= (mod_id % 2) << bit_id
        self.etc1_bytes[ms_byte_id] &= ~(1 << bit_id) & 0xFF
        self.etc1_bytes[ms_byte_id] |= (mod_id // 2) << bit_id


def _color_5_to_8(c):
    return [(x << 3) | (x >> 2) for x in c[:3]] + [255]


def _color_4_to_8(c):
    return [(x << 4) | x for x in c[:3]] + [255]


def _apply_mod_to_base_color(base, inten: int):
    return [
        [max(0, min(255, base[c] + m)) for c in range(3)] + [255]
        for m in _ETC1_MODIFIERS[inten]
    ]


_ETC_S_DIVS = [1, 3, 9]

# apply_etc1_bias special-case rows (etc.rs:205-240): bias -> (subblock,
# channel) -> delta; biases not listed use ((bias // S_DIVS[c]) % 3) - 1.
_ETC_BIAS_SPECIAL = {
    2: lambda sb, c: 0 if sb == 1 else (-1 if c == 0 else 0),
    5: lambda sb, c: 0 if sb == 1 else (-1 if c == 1 else 0),
    6: lambda sb, c: 0 if sb == 1 else (-1 if c == 2 else 0),
    7: lambda sb, c: 0 if sb == 1 else (1 if c == 0 else 0),
    11: lambda sb, c: 0 if sb == 1 else (1 if c == 1 else 0),
    15: lambda sb, c: 0 if sb == 1 else (1 if c == 2 else 0),
    18: lambda sb, c: (-1 if c == 0 else 0) if sb == 1 else 0,
    19: lambda sb, c: (-1 if c == 1 else 0) if sb == 1 else 0,
    20: lambda sb, c: (-1 if c == 2 else 0) if sb == 1 else 0,
    21: lambda sb, c: (1 if c == 0 else 0) if sb == 1 else 0,
    24: lambda sb, c: (1 if c == 1 else 0) if sb == 1 else 0,
    8: lambda sb, c: (1 if c == 2 else 0) if sb == 1 else 0,
    10: lambda sb, c: -2,
    27: lambda sb, c: 0 if sb == 1 else -1,
    28: lambda sb, c: -1 if sb == 1 else 1,
    29: lambda sb, c: 1 if sb == 1 else 0,
    30: lambda sb, c: -1 if sb == 1 else 0,
    31: lambda sb, c: 0 if sb == 1 else 1,
}


def _apply_etc1_bias(block_color, bias: int, limit: int, subblock: int):
    out = list(block_color)
    for c in range(3):
        if bias in _ETC_BIAS_SPECIAL:
            delta = _ETC_BIAS_SPECIAL[bias](subblock, c)
        else:
            delta = (bias // _ETC_S_DIVS[c]) % 3 - 1
        v = out[c]
        if v == 0:
            if delta == -2:
                v += 3
            else:
                v += delta + 1
        elif v == limit:
            v += delta - 1
        else:
            v += delta
            if v < 0 or v > limit:
                v = (v - delta) - delta
        assert 0 <= v <= limit
        out[c] = v
    return out


def _write_solid_etc2_alpha_block(value: int) -> bytes:
    return bytes([
        value, (1 << 4) | 13,
        0b10010010, 0b01001001, 0b00100100,
        0b10010010, 0b01001001, 0b00100100,
    ])


def _write_etc2_alpha_block(etc2tm: int, rgba) -> bytes:
    import numpy as _np

    if etc2tm == 0:
        return _write_solid_etc2_alpha_block(255)
    min_alpha = min(c[3] for c in rgba)
    max_alpha = max(c[3] for c in rgba)
    if min_alpha == max_alpha:
        return _write_solid_etc2_alpha_block(min_alpha)

    table_index = etc2tm & 15
    multiplier = etc2tm >> 4
    mod_table = _ETC2_ALPHA_MODIFIERS[table_index]
    mod_min = mod_table[3]
    mod_max = mod_table[7]
    rng = mod_max - mod_min

    # f32 lerp + round (half away from zero; the lerp result is >= 0 here)
    f32 = _np.float32
    amt = f32(-mod_min) / f32(rng)
    lerped = f32(min_alpha) * (f32(1.0) - amt) + f32(max_alpha) * amt
    center = int(_np.trunc(lerped + f32(0.5)))

    values = [max(0, min(255, center + m * multiplier)) for m in mod_table]

    selectors = 0
    for i, c in enumerate(rgba):
        a = c[3]
        best_selector = min(range(8), key=lambda j: abs(values[j] - a))
        x, y = i // 4, i % 4
        pid = y * 4 + x
        selectors |= best_selector << (45 - pid * 3)

    out = bytearray(8)
    out[0] = center & 0xFF
    out[1] = etc2tm
    out[2:8] = selectors.to_bytes(8, "big")[2:8]
    return bytes(out)


def _convert_block_to_etc(block: bytes, with_alpha: bool) -> bytes:
    """etc.rs:32-202 convert_block_from_uastc; returns 8 (ETC1) or 16 (ETC2:
    alpha block then RGB block) bytes."""
    r = _OBitReader(block)

    mode_code = r.peek(7)
    mode_index = _MODE_LUT[mode_code]
    if mode_index >= len(_MODES):
        raise OracleUastcError("invalid mode index")
    mode = _MODES[mode_index]
    (mode_id, code_size, _range_index, fmt, _weight_bits, _plane_count,
     _subset_count, trans_flags_bits) = mode
    r.remove(code_size)

    output = bytearray(8)
    w = _OBitWriterLsb(output)

    if mode_id == 8:
        if with_alpha:
            rgba8 = [r.read(8) for _ in range(4)]
            alpha_block = _write_solid_etc2_alpha_block(rgba8[3])
        else:
            r.remove(32)
            alpha_block = b""
        # decode_mode8_etc1_flags (uastc.rs:400-409)
        etc1d = r.read(1)
        etc1i = r.read(3)
        etc1s = r.read(2)
        etc1r = r.read(5)
        etc1g = r.read(5)
        etc1b = r.read(5)
        if not etc1d:
            w.write(8, (etc1r << 4) | etc1r)
            w.write(8, (etc1g << 4) | etc1g)
            w.write(8, (etc1b << 4) | etc1b)
        else:
            w.write(8, etc1r << 3)
            w.write(8, etc1g << 3)
            w.write(8, etc1b << 3)
        w.write(8, (etc1i << 5) | (etc1i << 2) | (etc1d << 1))
        selector = _SELECTOR_ID_TO_ETC1[etc1s]
        s_lo = selector & 1
        s_hi = selector >> 1
        w.write(16, (0 - s_hi) & 0xFFFF)
        w.write(16, (0 - s_lo) & 0xFFFF)
        return alpha_block + bytes(output)

    # decode_trans_flags (uastc.rs:411-436)
    _bc1h0 = r.read(1)
    if not 10 <= mode_id <= 12:
        _bc1h1 = r.read(1)
    etc1f = r.read(1)
    etc1d = r.read(1)
    etc1i0 = r.read(3)
    etc1i1 = r.read(3)
    etc1bias = None if 10 <= mode_id <= 12 else r.read(5)
    has_alpha = fmt in (_RGBA, _LA)
    etc2tm = r.read(8) if has_alpha else 0

    rgba = list(decode_block_to_rgba(block))

    alpha_block = _write_etc2_alpha_block(etc2tm, rgba) if with_alpha else b""

    if not etc1f:
        # transpose so the two subblocks are rgba[0..8] / rgba[8..16]
        for y in range(3):
            for x in range(y + 1, 4):
                a, b = y * 4 + x, x * 4 + y
                rgba[a], rgba[b] = rgba[b], rgba[a]

    color_bits = 5 if etc1d else 4
    limit = (1 << color_bits) - 1

    avg_colors = []
    for sb in range(2):
        subblock = rgba[8 * sb : 8 * sb + 8]
        sums = [sum(c[ch] for c in subblock) for ch in range(3)]
        avg_colors.append([(s * limit + 1020) // (8 * 255) for s in sums])

    if etc1bias is not None:
        c0 = _apply_etc1_bias(avg_colors[0], etc1bias, limit, 0)
        c1 = _apply_etc1_bias(avg_colors[1], etc1bias, limit, 1)
    else:
        c0, c1 = avg_colors

    if not etc1d:
        w.write(8, (c0[0] << 4) | c1[0])
        w.write(8, (c0[1] << 4) | c1[1])
        w.write(8, (c0[2] << 4) | c1[2])
        block_colors = [
            _apply_mod_to_base_color(_color_4_to_8(c0), etc1i0),
            _apply_mod_to_base_color(_color_4_to_8(c1), etc1i1),
        ]
    else:
        d = [max(-4, min(3, c1[ch] - c0[ch])) for ch in range(3)]
        w.write(8, (c0[0] << 3) | (d[0] & 0b111))
        w.write(8, (c0[1] << 3) | (d[1] & 0b111))
        w.write(8, (c0[2] << 3) | (d[2] & 0b111))
        c1d = [c0[ch] + d[ch] for ch in range(3)]
        block_colors = [
            _apply_mod_to_base_color(_color_5_to_8(c0), etc1i0),
            _apply_mod_to_base_color(_color_5_to_8(c1d), etc1i1),
        ]

    w.write(8, (etc1i0 << 5) | (etc1i1 << 2) | (etc1d << 1) | etc1f)

    LUM_FACTORS = [108, 366, 38]
    sel = _OSelector()
    for sb in range(2):
        bc = block_colors[sb]
        block_lums = [
            sum(bc[k][ch] * LUM_FACTORS[ch] for ch in range(3)) for k in range(4)
        ]
        lum_01 = (block_lums[0] + block_lums[1]) // 2
        lum_12 = (block_lums[1] + block_lums[2]) // 2
        lum_23 = (block_lums[2] + block_lums[3]) // 2
        for i in range(8):
            c = rgba[8 * sb + i]
            lum = sum(c[ch] * LUM_FACTORS[ch] for ch in range(3))
            s = int(lum >= lum_01) + int(lum >= lum_12) + int(lum >= lum_23)
            x = i & 0b11
            y = 2 * sb + (i >> 2)
            if etc1f:
                sel.set_selector(x, y, s)
            else:
                sel.set_selector(y, x, s)

    w.write(32, int.from_bytes(bytes(sel.etc1_bytes), "little"))
    return alpha_block + bytes(output)


def convert_block_to_etc1(block: bytes) -> bytes:
    return _convert_block_to_etc(block, with_alpha=False)


def convert_block_to_etc2(block: bytes) -> bytes:
    return _convert_block_to_etc(block, with_alpha=True)


# -- target_formats/bc7.rs ---------------------------------------------------

# (id, pat_bits, endpoint_count, color_bits, alpha_bits, weight_bits,
#  plane_count, subset_count, p_bits, sp_bits)  (bc7.rs:569-579)
_BC7_MODES = [
    (0, 4, 18, 4, 0, 3, 1, 3, 1, 0),
    (1, 6, 12, 6, 0, 3, 1, 2, 0, 1),
    (2, 6, 18, 5, 0, 2, 1, 3, 0, 0),
    (3, 6, 12, 7, 0, 2, 1, 2, 1, 0),
    (4, 0, 8, 5, 6, 2, 2, 1, 0, 0),
    (5, 0, 8, 7, 8, 2, 2, 1, 0, 0),
    (6, 0, 8, 7, 7, 4, 1, 1, 1, 0),
    (7, 6, 16, 5, 5, 2, 1, 2, 1, 0),
]

_UASTC_TO_BC7_MODES = [6, 3, 1, 2, 3, 6, 5, 2, 0, 7, 6, 5, 6, 5, 6, 6, 7, 5, 6, 0]

_PATTERNS_2_BC7_INDEX_INV = [
    (0, False), (1, False), (2, True), (3, False), (4, True), (5, False),
    (6, True), (7, True), (8, False), (9, True), (10, False), (11, True),
    (12, True), (13, True), (14, False), (15, True), (17, True), (18, True),
    (19, False), (20, False), (21, False), (22, True), (23, True),
    (24, False), (25, True), (26, False), (29, True), (32, True), (33, True),
    (52, True),
]

_PATTERNS_3_BC7_INDEX_PERM = [
    (4, 0), (8, 5), (9, 5), (10, 2), (11, 2), (12, 0), (13, 4), (20, 1),
    (35, 1), (36, 5), (57, 0),
]

_PATTERNS_3_BC7_TO_ASTC_PERMUTATIONS = [
    [0, 1, 2], [2, 0, 1], [1, 2, 0], [2, 1, 0], [0, 2, 1], [1, 0, 2],
]

_PATTERNS_2_3_BC7_INDEX_PERM = [
    (10, 4), (11, 4), (0, 3), (2, 4), (8, 5), (13, 4), (1, 2), (33, 2),
    (40, 3), (20, 4), (21, 0), (58, 3), (3, 0), (32, 2), (59, 1), (34, 3),
    (20, 1), (14, 4), (31, 3),
]

_PATTERNS_2_3_BC7_TO_ASTC_PERMUTATIONS = [
    [0, 0, 1], [1, 1, 0], [0, 1, 1], [1, 0, 0], [0, 1, 0], [1, 0, 1],
]

_PATTERNS_2_BC7 = [
    [0,0,1,1,0,0,1,1,0,0,1,1,0,0,1,1], [0,0,0,1,0,0,0,1,0,0,0,1,0,0,0,1],
    [0,1,1,1,0,1,1,1,0,1,1,1,0,1,1,1], [0,0,0,1,0,0,1,1,0,0,1,1,0,1,1,1],
    [0,0,0,0,0,0,0,1,0,0,0,1,0,0,1,1], [0,0,1,1,0,1,1,1,0,1,1,1,1,1,1,1],
    [0,0,0,1,0,0,1,1,0,1,1,1,1,1,1,1], [0,0,0,0,0,0,0,1,0,0,1,1,0,1,1,1],
    [0,0,0,0,0,0,0,0,0,0,0,1,0,0,1,1], [0,0,1,1,0,1,1,1,1,1,1,1,1,1,1,1],
    [0,0,0,0,0,0,0,1,0,1,1,1,1,1,1,1], [0,0,0,0,0,0,0,0,0,0,0,1,0,1,1,1],
    [0,0,0,1,0,1,1,1,1,1,1,1,1,1,1,1], [0,0,0,0,0,0,0,0,1,1,1,1,1,1,1,1],
    [0,0,0,0,1,1,1,1,1,1,1,1,1,1,1,1], [0,0,0,0,0,0,0,0,0,0,0,0,1,1,1,1],
    [0,1,1,1,0,0,0,1,0,0,0,0,0,0,0,0], [0,0,0,0,0,0,0,0,1,0,0,0,1,1,1,0],
    [0,1,1,1,0,0,1,1,0,0,0,1,0,0,0,0], [0,0,1,1,0,0,0,1,0,0,0,0,0,0,0,0],
    [0,0,0,0,1,0,0,0,1,1,0,0,1,1,1,0], [0,0,0,0,0,0,0,0,1,0,0,0,1,1,0,0],
    [0,1,1,1,0,0,1,1,0,0,1,1,0,0,0,1], [0,0,1,1,0,0,0,1,0,0,0,1,0,0,0,0],
    [0,0,0,0,1,0,0,0,1,0,0,0,1,1,0,0], [0,1,1,0,0,1,1,0,0,1,1,0,0,1,1,0],
    [0,0,0,0,1,1,1,1,1,1,1,1,0,0,0,0], [0,1,0,1,0,1,0,1,0,1,0,1,0,1,0,1],
    [0,0,0,0,1,1,1,1,0,0,0,0,1,1,1,1], [0,1,1,0,1,1,0,0,1,0,0,1,0,0,1,1],
]

_PATTERNS_3_BC7 = [
    [0,0,0,0,0,0,0,0,1,1,2,2,1,1,2,2], [0,0,0,0,0,0,0,0,1,1,1,1,2,2,2,2],
    [0,0,0,0,1,1,1,1,1,1,1,1,2,2,2,2], [0,0,0,0,1,1,1,1,2,2,2,2,2,2,2,2],
    [0,0,1,2,0,0,1,2,0,0,1,2,0,0,1,2], [0,1,1,2,0,1,1,2,0,1,1,2,0,1,1,2],
    [0,1,2,2,0,1,2,2,0,1,2,2,0,1,2,2], [0,1,1,1,0,1,1,1,0,2,2,2,0,2,2,2],
    [0,1,2,0,0,1,2,0,0,1,2,0,0,1,2,0], [0,0,0,0,1,1,1,1,2,2,2,2,0,0,0,0],
    [0,0,2,2,0,0,1,1,0,0,1,1,0,0,2,2],
]

_PATTERNS_2_3_BC7 = [
    [0,0,0,0,1,1,1,1,2,2,2,2,2,2,2,2], [0,0,1,2,0,0,1,2,0,0,1,2,0,0,1,2],
    [0,0,1,1,0,0,1,1,0,2,2,1,2,2,2,2], [0,0,0,0,2,0,0,1,2,2,1,1,2,2,1,1],
    [0,0,0,0,0,0,0,0,1,1,1,1,2,2,2,2], [0,1,2,2,0,1,2,2,0,1,2,2,0,1,2,2],
    [0,0,0,1,0,0,1,1,2,2,1,1,2,2,2,1], [0,2,2,2,0,0,2,2,0,0,1,2,0,0,1,1],
    [0,0,1,1,1,1,2,2,2,2,0,0,0,0,1,1], [0,1,1,1,0,1,1,1,0,2,2,2,0,2,2,2],
    [0,0,0,1,0,0,0,1,2,2,2,1,2,2,2,1], [0,0,2,2,1,1,2,2,1,1,2,2,0,0,2,2],
    [0,2,2,2,0,0,2,2,0,0,1,1,0,1,1,1], [0,0,0,0,0,0,0,2,1,1,2,2,1,2,2,2],
    [0,0,0,0,0,0,0,0,0,0,0,0,2,1,1,2], [0,0,1,1,0,0,1,2,0,0,2,2,0,2,2,2],
    [0,1,1,1,0,1,1,1,0,2,2,2,0,2,2,2], [0,0,1,1,0,1,1,2,1,1,2,2,1,2,2,2],
    [0,0,0,0,2,0,0,0,2,2,1,1,2,2,2,1],
]

_PATTERNS_2_BC7_ANCHORS = [
    [0, 15], [0, 15], [0, 15], [0, 15], [0, 15], [0, 15], [0, 15], [0, 15],
    [0, 15], [0, 15], [0, 15], [0, 15], [0, 15], [0, 15], [0, 15], [0, 15],
    [0, 15], [0, 2], [0, 8], [0, 2], [0, 2], [0, 8], [0, 8], [0, 15],
    [0, 2], [0, 8], [0, 2], [0, 2], [0, 8], [0, 8], [0, 2], [0, 2],
    [0, 15], [0, 15], [0, 6], [0, 8], [0, 2], [0, 8], [0, 15], [0, 15],
    [0, 2], [0, 8], [0, 2], [0, 2], [0, 2], [0, 15], [0, 15], [0, 6],
    [0, 6], [0, 2], [0, 6], [0, 8], [0, 15], [0, 15], [0, 2], [0, 2],
    [0, 15], [0, 15], [0, 15], [0, 15], [0, 15], [0, 2], [0, 2], [0, 15],
]

_PATTERNS_3_BC7_ANCHORS = [
    [0, 3, 15], [0, 3, 8], [0, 15, 8], [0, 15, 3], [0, 8, 15], [0, 3, 15],
    [0, 15, 3], [0, 15, 8], [0, 8, 15], [0, 8, 15], [0, 6, 15], [0, 6, 15],
    [0, 6, 15], [0, 5, 15], [0, 3, 15], [0, 3, 8], [0, 3, 15], [0, 3, 8],
    [0, 8, 15], [0, 15, 3], [0, 3, 15], [0, 3, 8], [0, 6, 15], [0, 10, 8],
    [0, 5, 3], [0, 8, 15], [0, 8, 6], [0, 6, 10], [0, 8, 15], [0, 5, 15],
    [0, 15, 10], [0, 15, 8], [0, 8, 15], [0, 15, 3], [0, 3, 15], [0, 5, 10],
    [0, 6, 10], [0, 10, 8], [0, 8, 9], [0, 15, 10], [0, 15, 6], [0, 3, 15],
    [0, 15, 8], [0, 5, 15], [0, 15, 3], [0, 15, 6], [0, 15, 6], [0, 15, 8],
    [0, 3, 15], [0, 15, 3], [0, 5, 15], [0, 5, 15], [0, 5, 15], [0, 8, 15],
    [0, 5, 15], [0, 10, 15], [0, 5, 15], [0, 10, 15], [0, 8, 15], [0, 13, 15],
    [0, 15, 3], [0, 12, 15], [0, 3, 15], [0, 3, 8],
]

_BC7ENC_MODE_5_OPTIMAL_INDEX = 1
_BC7ENC_MODE_6_OPTIMAL_INDEX = 5

_BC7_WEIGHTS2 = [0, 21, 43, 64]
_BC7_WEIGHTS4 = [0, 4, 9, 13, 17, 21, 26, 30, 34, 38, 43, 47, 51, 55, 60, 64]


def _build_optimal_tables():
    """Brute-force builds of BC7_MODE_5_OPTIMAL_ENDPOINTS (bc7.rs:1214-1250)
    and BC7_MODE_6_OPTIMAL_ENDPOINTS (bc7.rs:1158-1212): the reference's own
    tests assert the committed tables equal these builds, so generating is
    equivalent to transcribing them (and far less error-prone)."""
    import numpy as _np

    l = _np.arange(128)[:, None]
    h = _np.arange(128)[None, :]
    invalid = (h < l) * (1 << 40)

    # mode 5: BC7 777, weight index 1 of WEIGHTS2
    w = _BC7_WEIGHTS2[_BC7ENC_MODE_5_OPTIMAL_INDEX]
    low = (l << 1) | (l >> 6)
    high = (h << 1) | (h >> 6)
    k5 = (low * (64 - w) + high * w + 32) >> 6

    # mode 6: BC7 777.1 with lp = 0, weight index 5 of WEIGHTS4
    w = _BC7_WEIGHTS4[_BC7ENC_MODE_6_OPTIMAL_INDEX]
    low = l << 1
    high = h << 1
    k6 = (low * (64 - w) + high * w + 32) >> 6

    def best(k, c):
        err = (k - c) ** 2 + invalid
        i = int(err.argmin())  # first minimal in (l-major, h-minor) order
        return (i // 128, i % 128)

    mode5 = [best(k5, c) for c in range(256)]
    mode6 = [(0, 0)] + [best(k6, c) for c in range(256)]
    return mode5, mode6


_OPTIMAL_TABLES = None


def _optimal_tables():
    global _OPTIMAL_TABLES
    if _OPTIMAL_TABLES is None:
        _OPTIMAL_TABLES = _build_optimal_tables()
    return _OPTIMAL_TABLES


def _convert_weights_to_bc7(weights, uastc_weight_bits, bc7_weight_bits):
    luts = {
        (1, 2): [0, 3],
        (2, 4): [0, 5, 10, 15],
        (3, 4): [0, 2, 4, 6, 9, 11, 13, 15],
        (5, 4): [0, 0, 1, 1, 2, 2, 3, 3, 4, 4, 5, 5, 6, 6, 6, 7, 8, 9, 9, 9,
                 10, 10, 11, 11, 12, 12, 13, 13, 14, 14, 15, 15],
    }
    if uastc_weight_bits == bc7_weight_bits:
        return list(weights)
    lut = luts[(uastc_weight_bits, bc7_weight_bits)]
    return [lut[w] for w in weights]


def _determine_pbits(total_comps, comp_bits, endpoint_pair, shared: bool):
    """bc7.rs:408-553: f32 p-bit search; mutates endpoint_pair in place."""
    import numpy as _np

    f32 = _np.float32
    total_bits = comp_bits + 1
    iscalep = (1 << total_bits) - 1
    scalep = f32(iscalep)

    xl = [f32(endpoint_pair[0][c]) / f32(255.0) for c in range(4)]
    xh = [f32(endpoint_pair[1][c]) / f32(255.0) for c in range(4)]

    best_err = f32(1e9)
    best_err0 = f32(1e9)
    best_err1 = f32(1e9)
    s_bit = 0
    p_bits = [0, 0]
    out_lo = [0, 0, 0, 0]
    out_hi = [0, 0, 0, 0]

    for p in range(2):
        x_min = []
        x_max = []
        for c in range(4):
            t = int((xl[c] * scalep - f32(p)) / f32(2.0) + f32(0.5))  # trunc
            x_min.append(max(p, min(iscalep - 1 + p, t * 2 + p)))
            t = int((xh[c] * scalep - f32(p)) / f32(2.0) + f32(0.5))
            x_max.append(max(p, min(iscalep - 1 + p, t * 2 + p)))

        scaled_low = []
        scaled_high = []
        for c in range(4):
            s = (x_min[c] << (8 - total_bits)) & 0xFF
            scaled_low.append(s | (s >> total_bits))
            s = (x_max[c] << (8 - total_bits)) & 0xFF
            scaled_high.append(s | (s >> total_bits))

        if shared:
            err = f32(0.0)
            for i in range(total_comps):
                err += (f32(scaled_low[i]) / f32(255.0) - xl[i]) ** 2 + (
                    f32(scaled_high[i]) / f32(255.0) - xh[i]
                ) ** 2
            if err < best_err:
                best_err = err
                s_bit = p
                out_lo = [x >> 1 for x in x_min]
                out_hi = [x >> 1 for x in x_max]
        else:
            err0 = f32(0.0)
            err1 = f32(0.0)
            for i in range(total_comps):
                err0 += (f32(scaled_low[i]) - xl[i] * f32(255.0)) ** 2
                err1 += (f32(scaled_high[i]) - xh[i] * f32(255.0)) ** 2
            if err0 < best_err0:
                best_err0 = err0
                p_bits[0] = p
                out_lo = [x >> 1 for x in x_min]
            if err1 < best_err1:
                best_err1 = err1
                p_bits[1] = p
                out_hi = [x >> 1 for x in x_max]

    endpoint_pair[0] = out_lo
    endpoint_pair[1] = out_hi
    return [s_bit, s_bit] if shared else p_bits


def convert_block_to_bc7(block: bytes) -> bytes:
    """16 UASTC block bytes -> 16 BC7 block bytes (bc7.rs:9-310)."""
    assert len(block) == 16
    r = _OBitReader(block)

    mode_code = r.peek(7)
    mode_index = _MODE_LUT[mode_code]
    if mode_index >= len(_MODES):
        raise OracleUastcError("invalid mode index")
    mode = _MODES[mode_index]
    (mode_id, code_size, range_index, fmt, uastc_weight_bits, plane_count,
     subset_count, trans_flags_bits) = mode
    r.remove(code_size)

    output = bytearray(16)
    w = _OBitWriterLsb(output)

    if mode_id == 8:
        rgba8 = [r.read(8) for _ in range(4)]
        mode5_tab, mode6_tab = _optimal_tables()
        # mode_6_optimal_endpoint_err: only c==0 (p=1) / c==255 (p=0) err 1
        best_err0 = sum(1 for c in rgba8 if c == 255)
        best_err1 = sum(1 for c in rgba8 if c == 0)
        if best_err0 > 0 and best_err1 > 0:
            bmode = 5
            endpoint = [[0] * 4, [0] * 4]
            for c in range(3):
                endpoint[0][c] = mode5_tab[rgba8[c]][0]
                endpoint[1][c] = mode5_tab[rgba8[c]][1]
            endpoint[0][3] = rgba8[3]
            endpoint[1][3] = rgba8[3]
            p01 = [0, 0]
            wts = [_BC7ENC_MODE_5_OPTIMAL_INDEX, 0]
        else:
            bmode = 6
            best_p = best_err1 < best_err0
            endpoint = [[0] * 4, [0] * 4]
            for c in range(4):
                lo, hi = mode6_tab[rgba8[c] + (0 if best_p else 1)]
                endpoint[0][c] = lo
                endpoint[1][c] = hi
            p01 = [int(best_p), int(best_p)]
            wts = [_BC7ENC_MODE_6_OPTIMAL_INDEX, _BC7ENC_MODE_6_OPTIMAL_INDEX]

        bc7 = _BC7_MODES[bmode]
        _, _, _, color_bits, alpha_bits, bweight_bits, bplanes, _, _, _ = bc7
        w.write(bmode + 1, 1 << bmode)
        if bmode == 5:
            w.write(2, 0)
        for channel in range(4):
            bit_count = color_bits if channel != 3 else alpha_bits
            w.write(bit_count, endpoint[0][channel])
            w.write(bit_count, endpoint[1][channel])
        if bmode == 6:
            w.write(2, (p01[1] << 1) | p01[0])
        for weight in wts[:bplanes]:
            w.write(bweight_bits - 1, weight)
            for _ in range(15):
                w.write(bweight_bits, weight)
        return bytes(output)

    bc7_mode_index = _UASTC_TO_BC7_MODES[mode_id]
    (_, pat_bits, bc7_endpoint_count, color_bits, alpha_bits, bweight_bits,
     bplanes, bsubsets, bp_bits, bsp_bits) = _BC7_MODES[bc7_mode_index]

    r.remove(trans_flags_bits)

    if plane_count == 2 and fmt == _LA:
        compsel = 3
    elif plane_count == 2:
        compsel = r.read(2)
    else:
        compsel = 0

    if mode_id == 7:
        uastc_pat, pattern_count = r.read(5), 19
    elif subset_count == 1:
        uastc_pat, pattern_count = 0, 1
    elif subset_count == 2:
        uastc_pat, pattern_count = r.read(5), 30
    else:
        uastc_pat, pattern_count = r.read(4), 11
    if uastc_pat >= pattern_count:
        raise OracleUastcError("block pattern is not valid")

    bc7_endpoints_per_channel = 2 * bsubsets
    bc7_channel_count = bc7_endpoint_count // bc7_endpoints_per_channel

    channel_count = {_RGB: 3, _RGBA: 4, _LA: 2}[fmt]
    endpoint_count = channel_count * subset_count * 2
    trit_quints, bit_vals = _decode_endpoints(r, range_index, endpoint_count)
    unquant = [0] * 18
    for i in range(endpoint_count):
        unquant[i] = _unquant_endpoint(trit_quints[i], bit_vals[i], range_index)
    pairs = _assemble_endpoint_pairs(fmt, unquant)
    endpoints = [[list(p[0]), list(p[1])] for p in pairs]
    while len(endpoints) < 3:
        endpoints.append([[0, 0, 0, 0], [0, 0, 0, 0]])

    raw = _decode_weights_raw(r, mode, uastc_pat)
    weights = [[0] * 16, [0] * 16]
    if plane_count == 1:
        weights[0] = _convert_weights_to_bc7(raw, uastc_weight_bits, bweight_bits)
    else:
        weights[0] = _convert_weights_to_bc7(raw[0::2], uastc_weight_bits, bweight_bits)
        weights[1] = _convert_weights_to_bc7(raw[1::2], uastc_weight_bits, bweight_bits)

    w.write(bc7_mode_index + 1, 1 << bc7_mode_index)

    bc7_anchors = [0]

    if bsubsets != 1:
        if mode_id == 1:
            index, _ = _PATTERNS_2_BC7_INDEX_INV[0]
            pattern = _PATTERNS_2_BC7[uastc_pat]
            anchors = _PATTERNS_2_BC7_ANCHORS[index]
            perm = [0, 0]
            bc7_pat = index
        elif mode_id == 7:
            index, p = _PATTERNS_2_3_BC7_INDEX_PERM[uastc_pat]
            perm = _PATTERNS_2_3_BC7_TO_ASTC_PERMUTATIONS[p]
            pattern = _PATTERNS_2_3_BC7[uastc_pat]
            anchors = _PATTERNS_3_BC7_ANCHORS[index]
            bc7_pat = index
        elif subset_count == 2:
            index, inv = _PATTERNS_2_BC7_INDEX_INV[uastc_pat]
            pattern = _PATTERNS_2_BC7[uastc_pat]
            anchors = _PATTERNS_2_BC7_ANCHORS[index]
            perm = [1, 0] if inv else [0, 1]
            bc7_pat = index
        else:
            index, p = _PATTERNS_3_BC7_INDEX_PERM[uastc_pat]
            perm = _PATTERNS_3_BC7_TO_ASTC_PERMUTATIONS[p]
            pattern = _PATTERNS_3_BC7[uastc_pat]
            anchors = _PATTERNS_3_BC7_ANCHORS[index]
            bc7_pat = index
        bc7_anchors = anchors

        w.write(pat_bits, bc7_pat)

        permuted = [endpoints[perm[i]] for i in range(len(perm))]
        endpoints = [
            [list(pair[0]), list(pair[1])] for pair in permuted
        ] + endpoints[len(perm):]

        weight_mask = (1 << bweight_bits) - 1
        weight_msb_mask = 1 << (bweight_bits - 1)
        invert_subset = [False] * 3
        for k, anchor in enumerate(anchors):
            invert_subset[k] = (weights[0][anchor] & weight_msb_mask) != 0
        for k in range(bsubsets):
            if invert_subset[k]:
                endpoints[k][0], endpoints[k][1] = endpoints[k][1], endpoints[k][0]
        for i in range(16):
            if invert_subset[pattern[i]]:
                weights[0][i] = ~weights[0][i] & weight_mask
    else:
        weight_mask = (1 << bweight_bits) - 1
        weight_msb_mask = 1 << (bweight_bits - 1)
        if plane_count == 1:
            if weights[0][0] & weight_msb_mask:
                endpoints[0][0], endpoints[0][1] = endpoints[0][1], endpoints[0][0]
                weights[0] = [~x & weight_mask for x in weights[0]]
        else:
            invert_plane = [
                bool(weights[0][0] & weight_msb_mask),
                bool(weights[1][0] & weight_msb_mask),
            ]
            pair = endpoints[0]
            for e in pair:
                e[compsel], e[3] = e[3], e[compsel]
            if invert_plane[0]:
                pair[0], pair[1] = pair[1], pair[0]
            if invert_plane[0] != invert_plane[1]:
                pair[0][3], pair[1][3] = pair[1][3], pair[0][3]
            for k in range(2):
                if invert_plane[k]:
                    weights[k] = [~x & weight_mask for x in weights[k]]
            w.write(2, (compsel + 1) & 0b11)
            if bc7_mode_index == 4:
                w.write(1, 0)

    sub_endpoints = endpoints[:bsubsets]

    p01 = [[0, 0], [0, 0], [0, 0]]
    if bp_bits != 0:
        for k in range(bsubsets):
            p01[k] = _determine_pbits(
                bc7_channel_count, color_bits, sub_endpoints[k], shared=False
            )
    elif bsp_bits != 0:
        for k in range(bsubsets):
            p01[k] = _determine_pbits(
                bc7_channel_count, color_bits, sub_endpoints[k], shared=True
            )
    else:
        def scale(e, bits):
            return (e * ((1 << bits) - 1) + 127) // 255

        for pair in sub_endpoints:
            for e in pair:
                for c in range(3):
                    e[c] = scale(e[c], color_bits)
                e[3] = scale(e[3], alpha_bits)

    for channel in range(bc7_channel_count):
        bit_count = color_bits if channel != 3 else alpha_bits
        for pair in sub_endpoints:
            w.write(bit_count, pair[0][channel])
            w.write(bit_count, pair[1][channel])

    if bp_bits != 0:
        for k in range(bsubsets):
            w.write(2, (p01[k][1] << 1) | p01[k][0])
    elif bsp_bits != 0:
        w.write(2, (p01[1][0] << 1) | p01[0][0])

    bit_counts = [bweight_bits] * 16
    for anchor in bc7_anchors:
        bit_counts[anchor] -= 1
    for plane_weights in weights[:bplanes]:
        for i in range(16):
            w.write(bit_counts[i], plane_weights[i])

    return bytes(output)


def mode_code_bits(mode_id: int):
    """(code, code_size) whose low code_size bits force mode_id regardless of
    the remaining peeked bits (derived by exhaustive check over MODE_LUT)."""
    code_size = _MODES[mode_id][1]
    for code in range(1 << code_size):
        if all(
            _MODE_LUT[(ext << code_size | code) & 0x7F] == mode_id
            for ext in range(1 << (7 - code_size))
        ):
            return code, code_size
    raise AssertionError(f"no stable code for mode {mode_id}")
