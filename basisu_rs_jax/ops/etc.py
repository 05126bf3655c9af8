"""UASTC -> ETC1 / ETC2 transcode, vectorized per mode.

Mirrors `convert_block_from_uastc` in the reference's ETC backend
(src/target_formats/etc.rs:32-341): the only UASTC path that composes the full
RGBA decode with an encode stage - per-subblock average colors, hint-driven
bias nudges, luminance-projection selector re-derivation, and the EAC alpha
block for ETC2.  Also hosts the shared ETC helpers used by the ETC1S backend
(palette construction, selector wire format; etc.rs:343-468).
"""

from __future__ import annotations

import jax.numpy as jnp
import numpy as np

from ..tables import MODE8_ETC1_FLAGS_OFFSET, MODE8_RGBA_OFFSET, ModeCfg, np_tables
from .bits import lane_shape, lut_lookup, LaneWriter, U32, extract, mask
from .rgba import uastc_to_rgba_channels

I32 = jnp.int32

LUM_FACTORS = (108, 366, 38)


# ---------------------------------------------------------------------------
# shared ETC helpers (etc.rs:343-468)
# ---------------------------------------------------------------------------


def color_5_to_8(c):
    return (c << 3) | (c >> 2)


def color_4_to_8(c):
    return (c << 4) | c


def etc1_palette(base_rgb, inten):
    """4-color ETC1 palette for a subblock: clamp(base + modifier) per level.

    base_rgb: [r,g,b] int32[N] (0..255); inten: int32[N] 0..7.
    Returns [level k][channel c] nested list (etc.rs:420-431).

    Every modifier row is [-big, -small, small, big], so one gather of the
    packed (small | big<<8) magnitudes replaces four table lookups; the
    signs are static per level."""
    mods = np_tables()["ETC1_MODIFIERS"]  # [8, 4] int32, rows [-b,-s,s,b]
    assert (mods[:, 0] == -mods[:, 3]).all() and (mods[:, 1] == -mods[:, 2]).all()
    packed = (mods[:, 2] | (mods[:, 3] << 8)).astype(np.int32)  # [8]
    w = lut_lookup(packed, inten)
    small = w & 255
    big = w >> 8
    # one-SIDED clamps: base is 0..255 and the modifier sign is static per
    # level, so subtracting can only undershoot 0 and adding can only
    # overshoot 255 - max/min instead of a two-op clip
    return [
        [jnp.maximum(base_rgb[c] - big, 0) for c in range(3)],
        [jnp.maximum(base_rgb[c] - small, 0) for c in range(3)],
        [jnp.minimum(base_rgb[c] + small, 255) for c in range(3)],
        [jnp.minimum(base_rgb[c] + big, 255) for c in range(3)],
    ]


def selector_ms_ls(sel):
    """ETC1 wire bits of a 2-bit selector, arithmetically (no gather):
    mod_id = SELECTOR_ID_TO_ETC1[sel] = [3, 2, 0, 1][sel], split into its
    MSB [1,1,0,0] = !(sel>>1) and LSB [1,0,0,1] = !((sel>>1)^(sel&1))."""
    hi = (sel >> 1) & 1
    ms = hi ^ 1
    ls = (hi ^ sel ^ 1) & 1
    return ms, ls


def selector_wire_bits_from(ms, ls, pixel_id: int):
    """Place a texel's wire bits in the 32-bit ETC1 selector word at static
    pixel_id (column-major x*4+y; etc.rs:363-393).

    ETC1 wire format: byte0 = MSBs of pixels 8..15, byte1 = MSBs of 0..7,
    byte2/3 = LSBs likewise; bit index = pixel_id % 8."""
    ms_byte = 1 - pixel_id // 8
    ls_byte = ms_byte + 2
    bit = pixel_id % 8
    return (ms.astype(U32) << (8 * ms_byte + bit)) | (ls.astype(U32) << (8 * ls_byte + bit))


def selector_wire_bits(sel, pixel_id: int):
    ms, ls = selector_ms_ls(sel)
    return selector_wire_bits_from(ms, ls, pixel_id)


# ---------------------------------------------------------------------------
# trans flags (uastc.rs:411-441)
# ---------------------------------------------------------------------------


def decode_trans_flags(cfg: ModeCfg, lanes):
    ofs = cfg.field_offsets["trans_flags"]
    out = {}
    out["bc1h0"] = extract(lanes, ofs, 1).astype(I32)
    ofs += 1
    if not 10 <= cfg.id <= 12:
        out["bc1h1"] = extract(lanes, ofs, 1).astype(I32)
        ofs += 1
    else:
        out["bc1h1"] = jnp.zeros(lane_shape(lanes), I32)
    out["etc1f"] = extract(lanes, ofs, 1).astype(I32)
    out["etc1d"] = extract(lanes, ofs + 1, 1).astype(I32)
    out["etc1i0"] = extract(lanes, ofs + 2, 3).astype(I32)
    out["etc1i1"] = extract(lanes, ofs + 5, 3).astype(I32)
    ofs += 8
    if not 10 <= cfg.id <= 12:
        out["etc1bias"] = extract(lanes, ofs, 5).astype(I32)
        ofs += 5
    else:
        out["etc1bias"] = None
    if cfg.has_alpha:
        out["etc2tm"] = extract(lanes, ofs, 8).astype(I32)
    else:
        out["etc2tm"] = jnp.zeros(lane_shape(lanes), I32)
    return out


# ---------------------------------------------------------------------------
# EAC alpha block (etc.rs:261-341)
# ---------------------------------------------------------------------------

_SOLID_ALPHA_LANE0_HI = 0x92 << 16 | 0x49 << 24  # mod table 13, multiplier 1
_SOLID_ALPHA_LANE1 = 0x24 | 0x92 << 8 | 0x49 << 16 | 0x24 << 24


def eac_center(min_a, max_a, frac):
    """round(lerp(min, max, frac)) in f32, round half away from zero (always
    >= 0 here), etc.rs:301-307.  A GPU compiler may contract either product
    with the add into an FMA; that moves the lerp by an ulp for some inputs
    but never the rounded centre - exhaustively over every (min, max, table
    row) in tests/test_tables.py."""
    f32 = jnp.float32
    lerped = min_a.astype(f32) * (f32(1.0) - frac) + max_a.astype(f32) * frac
    return jnp.trunc(lerped + f32(0.5)).astype(I32)


def _solid_alpha_lanes(value):
    """Solid EAC block: value byte, table 13 / multiplier 1, all weights 4."""
    lane0 = value.astype(U32) | U32(0x1D << 8) | U32(_SOLID_ALPHA_LANE0_HI)
    lane1 = jnp.full(value.shape, _SOLID_ALPHA_LANE1, U32)
    return lane0, lane1


def write_etc2_alpha_block(etc2tm, texels):
    """Returns (lane0, lane1) of the 8-byte EAC alpha block."""
    t = np_tables()
    shape = etc2tm.shape
    alphas = [texels[i][3] for i in range(16)]

    min_a = alphas[0]
    max_a = alphas[0]
    for a in alphas[1:]:
        min_a = jnp.minimum(min_a, a)
        max_a = jnp.maximum(max_a, a)

    solid0_255, solid1_255 = _solid_alpha_lanes(jnp.full(shape, 255, I32))
    solid0_min, solid1_min = _solid_alpha_lanes(min_a)

    # general path
    tbl_idx = etc2tm & 15
    mult = etc2tm >> 4
    # The 8 per-table modifiers ride TWO packed gathers instead of eight:
    # each row's modifiers are biased +15 (range -15..14 -> 0..29) and
    # packed 4-per-word as 8-bit fields; the bias folds into the center
    # term once per block (values come out as (center - 15*mult) + u*mult).
    mods_np = t["ETC2_ALPHA_MODIFIERS"] + 15  # [16, 8], 0..29
    packed_mods = [
        np.ascontiguousarray(
            mods_np[:, 4 * h] | (mods_np[:, 4 * h + 1] << 8)
            | (mods_np[:, 4 * h + 2] << 16) | (mods_np[:, 4 * h + 3] << 24)
        )
        for h in range(2)
    ]
    w01 = [lut_lookup(p, tbl_idx) for p in packed_mods]
    frac = lut_lookup(t["ETC2_ALPHA_FRACTION"], tbl_idx)

    center = eac_center(min_a, max_a, frac)

    cbase = center - 15 * mult
    values = [
        jnp.clip(cbase + ((w01[j >> 2] >> (8 * (j & 3))) & 255) * mult, 0, 255)
        for j in range(8)
    ]

    # Selector search as a rank count over the value-sorted candidate order
    # [3,2,1,0,4,5,6,7] (modifier rows are strictly decreasing then strictly
    # increasing, so W is monotone up to clipping): 7 midpoint compares per
    # texel instead of 8 packed |dist| mins.  Iterator::min_by_key's
    # first-minimal-j tie rule (etc.rs:315-323) fixes each threshold's
    # direction (>= where the smaller j sits at the higher rank, > where it
    # sits lower) and leaves exactly two duplicate-run shapes the count
    # can't see: mult == 0 (all eight equal) and W3 == W4 (center == 0 with
    # modifier 0 in the table, ranks 0..4 equal), both of which resolve to
    # j = 0.  Equivalence with the packed-min form is pinned exhaustively
    # over all (table, mult, center, alpha) in tests/test_tables.py.
    order = (3, 2, 1, 0, 4, 5, 6, 7)
    W = [values[p] for p in order]
    S = [W[k - 1] + W[k] for k in range(1, 8)]
    # pre-halved thresholds fold the per-texel doubling (a2 = 2a) into the
    # per-block midpoints: 2a >= S  <=>  a >= (S+1)>>1,  2a > S  <=>
    # a >= (S+2)>>1 (S >= 0)
    T = [(S[k] + 1) >> 1 for k in (0, 1, 2)] + [(S[k] + 2) >> 1 for k in (3, 4, 5, 6)]
    # Duplicate-run fixup folded INTO the thresholds (per BLOCK) instead of
    # a 4-op mask chain per texel: the two collapse shapes force rank 3
    # (which maps to j = 0) for every affected alpha.
    # - mult == 0 (all eight candidates equal): T[0..2] := 0 (a >= 0 always,
    #   rank >= 3) and T[3..6] := 256 (never hit, rank <= 3).
    # - W3 == W4 (center == 0 with modifier 0: candidates j = 0..4 equal, so
    #   min_by_key's first-j rule gives j = 0 below the rank-5 threshold):
    #   T[0..2] := 0 and T[3] := T[4], making rank 4 unreachable and ranks
    #   0..3 collapse to 3, while ranks 5..7 keep their thresholds.
    # Exhaustive equivalence with the reference min_by_key (all table x
    # mult x center x alpha) is pinned in tests/test_tables.py.
    kill_all = mult == 0
    kill_lo = kill_all | (W[3] == W[4])
    T = [jnp.where(kill_lo, 0, T[k]) for k in (0, 1, 2)] + T[3:]
    for k in (4, 5, 6):
        T[k] = jnp.where(kill_all, 256, T[k])
    T[3] = jnp.where(kill_lo, T[4], T[3])

    # Selector bits accumulate at their NATURAL big-endian positions in a
    # logical 48-bit payload (vh = bits 32..47, vl = bits 0..31), then ONE
    # byte reversal maps them onto the little-endian output lanes - cheaper
    # than splitting each 3-bit field at byte boundaries per texel.
    vh = jnp.zeros(shape, U32)
    vl = jnp.zeros(shape, U32)
    for i in range(16):
        a = alphas[i]
        # rank r = #{k: a >= T[k]} by 3-level branchless binary search over
        # the sorted thresholds (the >= indicator is monotone in k, so the
        # search is duplicate-safe): 3 compares + 4 threshold selects replace
        # the 7-compare/6-add counting form.  r = 4*b2 + 2*b1 + b0; the
        # rank->candidate map (r<4 ? 3-r : r) becomes where(b2, 4+u, 3-u)
        # with u = 2*b1 + b0, and r<=4 becomes !b2 | u==0.  Exhaustive
        # equivalence with the reference's min_by_key in test_tables.
        b2 = a >= T[3]
        b1 = a >= jnp.where(b2, T[5], T[1])
        t0 = jnp.where(b2, jnp.where(b1, T[6], T[4]), jnp.where(b1, T[2], T[0]))
        b0 = a >= t0
        u = (b1.astype(I32) << 1) | b0.astype(I32)
        # rank->candidate map b2 ? 4 + u : 3 - u collapses to u ^ (3 + b2):
        # 3 - u == u ^ 3 for u in 0..3, and 4 + u == u ^ 4.  The duplicate-
        # run collapses are already folded into the thresholds above.
        best_j = (u ^ (3 + b2.astype(I32))).astype(U32)
        # transposed pixel order (etc.rs:325-327)
        x, y = i // 4, i % 4
        pid = y * 4 + x
        s = 45 - pid * 3  # field position in the big-endian 48-bit payload
        if s >= 32:
            vh = vh | (best_j << (s - 32))
        elif s == 30:  # the one field straddling the 32-bit split
            vl = vl | (best_j << s)  # bit 32 self-truncates in uint32
            vh = vh | (best_j >> (32 - s))
        else:
            vl = vl | (best_j << s)

    # block byte b holds payload bits (47-8b)..(40-8b): bytes 2..3 come
    # from vh, bytes 4..7 are bswap32(vl)
    lane0 = (
        (center.astype(U32) & 0xFF)
        | (etc2tm.astype(U32) << 8)
        | ((vh & 0xFF00) << 8)
        | ((vh & 0xFF) << 24)
    )
    lane1 = (
        ((vl & 0xFF) << 24)
        | ((vl & 0xFF00) << 8)
        | ((vl >> 8) & 0xFF00)
        | (vl >> 24)
    )
    lane0 = jnp.where(min_a == max_a, solid0_min, lane0)
    lane1 = jnp.where(min_a == max_a, solid1_min, lane1)
    lane0 = jnp.where(etc2tm == 0, solid0_255, lane0)
    lane1 = jnp.where(etc2tm == 0, solid1_255, lane1)
    return lane0, lane1


# ---------------------------------------------------------------------------
# bias application (etc.rs:113-120, 203-259)
# ---------------------------------------------------------------------------


def _packed_bias_deltas(bias):
    """ONE gather for all six (subblock, channel) bias deltas: values are
    -2..1, biased +2 into 2-bit fields of a single 32-entry packed word."""
    deltas = np_tables()["ETC_BIAS_DELTAS"].astype(np.int32) + 2  # 0..3
    packed = np.zeros(32, np.int32)
    for sb in range(2):
        for c in range(3):
            packed |= deltas[:, sb, c] << (2 * (3 * sb + c))
    return lut_lookup(packed, bias)


def _apply_etc1_bias(color, packed_deltas, limit, subblock: int):
    """color: [3] list of int32[N]; packed_deltas: int32[N] from
    _packed_bias_deltas; limit: int32[N] (15/31)."""
    out = []
    for c in range(3):
        field = (packed_deltas >> (2 * (3 * subblock + c))) & 3  # delta + 2
        v = color[c]
        plain = v + field - 2
        # v == 0 wrapping rule: delta + 1 except delta == -2 -> 3, which is
        # exactly (delta + 1) & 3 = (field - 1) & 3 over delta in -2..1
        at_zero = (field - 1) & 3
        at_limit = plain - 1  # v + delta - 1
        # The in-range branch is only selected for v in 1..limit-1, where
        # plain <= limit always holds (delta <= 1, v <= limit-1) and
        # plain < 0 only as plain == -1 (delta == -2, v == 1), where the
        # reference's v - delta is v + 2 - the generic two-sided range check
        # is statically dead on the high side.
        checked = jnp.where(plain < 0, v + 2, plain)
        res = jnp.where(v == 0, at_zero, jnp.where(v == limit, at_limit, checked))
        out.append(res)
    return out


# ---------------------------------------------------------------------------
# main paths
# ---------------------------------------------------------------------------


def _mode8_etc1_lanes(lanes):
    """Mode 8: ETC1 block straight from the hint flags (etc.rs:43-75)."""
    shape = lane_shape(lanes)
    O = MODE8_ETC1_FLAGS_OFFSET
    d = extract(lanes, O, 1).astype(I32)
    i = extract(lanes, O + 1, 3).astype(I32)
    s = extract(lanes, O + 4, 2).astype(I32)
    r = extract(lanes, O + 6, 5).astype(I32)
    g = extract(lanes, O + 11, 5).astype(I32)
    b = extract(lanes, O + 16, 5).astype(I32)

    # The flag fields are 5 bits wide even in individual (d == 0) mode, where
    # the wire byte is (c << 4) | c: the reference's write_u8 TRUNCATES the
    # 9-bit value of a c >= 16 to its low 8 bits (etc.rs:54-57) - mask here
    # so the dropped bit can't bleed into the next byte of the packed word.
    byte0 = jnp.where(d == 0, ((r << 4) | r) & 0xFF, r << 3)
    byte1 = jnp.where(d == 0, ((g << 4) | g) & 0xFF, g << 3)
    byte2 = jnp.where(d == 0, ((b << 4) | b) & 0xFF, b << 3)
    byte3 = (i << 5) | (i << 2) | (d << 1)
    lane0 = (
        byte0.astype(U32)
        | (byte1.astype(U32) << 8)
        | (byte2.astype(U32) << 16)
        | (byte3.astype(U32) << 24)
    )
    ms, ls = selector_ms_ls(s)
    lane1 = (U32(0xFFFF) * ms.astype(U32)) | ((U32(0xFFFF) * ls.astype(U32)) << 16)
    return lane0, lane1


def _etc_rgb_lanes(cfg: ModeCfg, lanes, flags, texels):
    """The 8-byte ETC1 RGB block for non-mode-8 blocks (etc.rs:78-200).

    The reference transposes the texel grid when !flip (etc.rs:86-95); here
    the transpose never materializes: subblock sums come from shared 2x2-quad
    partial sums selected per orientation, and the selector stage reads each
    texel's luminance through a per-position flip select."""
    shape = lane_shape(lanes)
    etc1f = flags["etc1f"]
    etc1d = flags["etc1d"]
    # hoist the per-block flag masks: they are reused by every subblock /
    # texel select below
    fm = etc1f == 1
    dm = etc1d == 1

    limit = jnp.where(dm, 31, 15)

    # subblock channel sums via 2x2 quad partial sums (texels are raster
    # order: i = y*4 + x).  flip=1 subblocks are row pairs, flip=0 column
    # pairs; both orientations share the quads.  LA modes share ONE array
    # object across r/g/b (uastc_to_rgba_channels), so the three channel
    # sums are identical - compute once and alias.
    gray = all(texels[i][0] is texels[i][1] is texels[i][2] for i in range(16))
    nch = 1 if gray else 3
    avgs = []
    quads = []  # [qy][qx][c]
    for qy in range(2):
        row = []
        for qx in range(2):
            ids = [(2 * qy + dy) * 4 + 2 * qx + dx for dy in (0, 1) for dx in (0, 1)]
            row.append(
                [texels[ids[0]][c] + texels[ids[1]][c] + texels[ids[2]][c] + texels[ids[3]][c]
                 for c in range(nch)]
            )
        quads.append(row)
    for sb in range(2):
        avg = []
        for c in range(nch):
            row_sum = quads[sb][0][c] + quads[sb][1][c]  # flip: row pair sb
            col_sum = quads[0][sb][c] + quads[1][sb][c]  # !flip: column pair sb
            ssum = jnp.where(fm, row_sum, col_sum)
            # (sum*limit + 1020) // 2040; numerator <= 64260, where
            # floor(n/2040) == (n*32897)>>26 exactly (int32-safe) - avoids
            # XLA's generic integer division sequence
            avg.append(((ssum * limit + 1020) * 32897) >> 26)
        avgs.append(avg * 3 if gray else avg)

    if flags["etc1bias"] is not None:
        packed_deltas = _packed_bias_deltas(flags["etc1bias"])
        c0 = _apply_etc1_bias(avgs[0], packed_deltas, limit, 0)
        c1 = _apply_etc1_bias(avgs[1], packed_deltas, limit, 1)
    else:
        c0, c1 = avgs

    # color bytes + palette bases (etc.rs:122-149)
    d = [jnp.clip(c1[c] - c0[c], -4, 3) for c in range(3)]
    bytes_ind = [(c0[c] << 4) | c1[c] for c in range(3)]
    bytes_diff = [(c0[c] << 3) | (d[c] & 7) for c in range(3)]
    c1_diff = [c0[c] + d[c] for c in range(3)]

    base0 = [jnp.where(dm, color_5_to_8(c0[c]), color_4_to_8(c0[c])) for c in range(3)]
    base1 = [
        jnp.where(dm, color_5_to_8(c1_diff[c]), color_4_to_8(c1[c])) for c in range(3)
    ]
    pal0 = etc1_palette(base0, flags["etc1i0"])
    pal1 = etc1_palette(base1, flags["etc1i1"])

    color_bytes = [jnp.where(dm, bytes_diff[c], bytes_ind[c]) for c in range(3)]
    byte3 = (flags["etc1i0"] << 5) | (flags["etc1i1"] << 2) | (etc1d << 1) | etc1f
    lane0 = (
        color_bytes[0].astype(U32)
        | (color_bytes[1].astype(U32) << 8)
        | (color_bytes[2].astype(U32) << 16)
        | (byte3.astype(U32) << 24)
    )

    # selector re-derivation by luminance projection (etc.rs:160-196).
    # Structural fact that removes all per-texel flip routing: in BOTH
    # orientations, ORIGINAL texel u's wire bits land at pixel id
    # transpose(u).  Flip iterates texels pos in raster order and calls
    # set_selector(x, y) = transpose(pos) with u = pos; !flip reads the
    # transposed texel u = transpose(pos) and writes set_selector(y, x) =
    # pos = transpose(u).  So the WRITE position is static per texel, and
    # the orientation only selects WHICH subblock's thresholds texel u
    # compares against: its row pair u//8 under flip, its column pair
    # (u%4)//2 otherwise.  Those agree on the diagonal quads and differ on
    # the two off-diagonal quads, so the per-texel selects collapse to
    # 2 quads x 3 thresholds once per block.
    #
    # Grayscale texels (LA modes share one object across r/g/b) collapse
    # the dot to t * (108+366+38) = t << 9.
    lums_o = [
        texels[i][0] << 9
        if texels[i][0] is texels[i][1] and texels[i][1] is texels[i][2]
        else texels[i][0] * LUM_FACTORS[0]
        + texels[i][1] * LUM_FACTORS[1]
        + texels[i][2] * LUM_FACTORS[2]
        for i in range(16)
    ]
    # Palette luminances at HALF scale (factors 54/183/19; all full factors
    # are even so halves are exact): the reference's threshold
    # (lum_k + lum_{k+1}) >> 1 over even full-scale lums equals the plain
    # half-scale sum, dropping the shift.  Texel lums stay full scale.
    th_sb = []
    for pal in (pal0, pal1):
        lums = [
            pal[k][0] * (LUM_FACTORS[0] // 2)
            + pal[k][1] * (LUM_FACTORS[1] // 2)
            + pal[k][2] * (LUM_FACTORS[2] // 2)
            for k in range(4)
        ]
        th_sb.append((lums[0] + lums[1], lums[1] + lums[2], lums[2] + lums[3]))
    # off-diagonal quads: thresholds selected once per quad, not per texel
    th_quad = {
        (0, 0): th_sb[0],
        (1, 1): th_sb[1],
        (0, 1): tuple(jnp.where(fm, th_sb[0][k], th_sb[1][k]) for k in range(3)),
        (1, 0): tuple(jnp.where(fm, th_sb[1][k], th_sb[0][k]) for k in range(3)),
    }
    lane1 = jnp.zeros(shape, U32)
    for u in range(16):
        th01, th12, th23 = th_quad[(u // 8, (u % 4) // 2)]
        lum = lums_o[u]
        # Palette lums are non-decreasing in k (modifier rows ascend, clip
        # is monotone), so the threshold hits are nested: c1 >= c2 >= c3
        # with sel = c1+c2+c3.  The wire bits collapse to boolean forms of
        # the hits directly - ms = !c2, ls = c3 | !c1 (truth table =
        # selector_ms_ls); the negated hits are computed by flipping the
        # compare direction, not with `not` ops.
        ms = lum < th12  # !c2
        c3 = lum >= th23
        ls = c3 | (lum < th01)  # c3 | !c1
        lane1 = lane1 | selector_wire_bits_from(ms, ls, (u % 4) * 4 + u // 4)
    return lane0, lane1


def uastc_to_etc1_mode(cfg: ModeCfg, lanes):
    """uint32[N,4] UASTC lanes -> (list of 2 ETC1 output words, err[N])."""
    if cfg.id == 8:
        lane0, lane1 = _mode8_etc1_lanes(lanes)
        return [lane0, lane1], jnp.zeros(lane_shape(lanes), bool)
    flags = decode_trans_flags(cfg, lanes)
    texels, err = uastc_to_rgba_channels(cfg, lanes, need_alpha=False)
    lane0, lane1 = _etc_rgb_lanes(cfg, lanes, flags, texels)
    return [lane0, lane1], err


def uastc_to_etc2_mode(cfg: ModeCfg, lanes):
    """uint32[N,4] UASTC lanes -> (list of 4 ETC2 output words: EAC alpha
    block then ETC1 RGB block, err[N])."""
    if cfg.id == 8:
        a = extract(lanes, MODE8_RGBA_OFFSET + 24, 8).astype(I32)
        a0, a1 = _solid_alpha_lanes(a)
        r0, r1 = _mode8_etc1_lanes(lanes)
        return [a0, a1, r0, r1], jnp.zeros(lane_shape(lanes), bool)
    flags = decode_trans_flags(cfg, lanes)
    texels, err = uastc_to_rgba_channels(cfg, lanes)
    if cfg.has_alpha:
        a0, a1 = write_etc2_alpha_block(flags["etc2tm"], texels)
    else:
        # RGB modes decode alpha = 255 everywhere and carry no etc2tm hint
        # (decode_trans_flags leaves it 0), so the EAC block is statically
        # the solid-255 block (etc.rs:263-267) - skip the whole search.
        a0, a1 = _solid_alpha_lanes(jnp.full(lane_shape(lanes), 255, I32))
    r0, r1 = _etc_rgb_lanes(cfg, lanes, flags, texels)
    return [a0, a1, r0, r1], err
