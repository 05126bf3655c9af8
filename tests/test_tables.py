"""Table integrity tests: structural invariants the reference pins with its
own unit tests (BC7 optimal-endpoint LUT validity, header field order), plus
cross-checks between the scalar and vectorized dequantization paths."""

import numpy as np

from basisu_rs_jax.container.basis import Header, SliceDesc
from basisu_rs_jax.container.crc import crc16
from basisu_rs_jax.tables import (
    BISE_RANGES,
    MODES,
    bc7_mode_5_optimal_endpoints,
    bc7_mode_6_optimal_endpoints,
    pbit_luts,
    unquant_endpoint_scalar,
)


def _interp(lo7, hi7, w, expand):
    low, high = expand(lo7), expand(hi7)
    return (low * (64 - w) + high * w + 32) >> 6


def test_bc7_mode5_optimal_endpoints_are_lossless():
    """BC7 777 with weight index 1 can hit every byte exactly
    (reference pins this in bc7.rs:1243-1244)."""
    t = bc7_mode_5_optimal_endpoints()
    for c in range(256):
        lo, hi = int(t[c, 0]), int(t[c, 1])
        assert lo <= hi
        k = _interp(lo, hi, 21, lambda v: (v << 1) | (v >> 6))
        assert k == c, (c, lo, hi, k)


def test_bc7_mode6_optimal_endpoints_err_structure():
    """777.1: only the extremes are lossy, by exactly 1
    (reference: bc7.rs:1133-1136, 1192-1195)."""
    t = bc7_mode_6_optimal_endpoints()
    for c in range(256):
        # p = 0 entries live at index c+1
        lo, hi = int(t[c + 1, 0]), int(t[c + 1, 1])
        k = _interp(lo, hi, 21, lambda v: (v << 1) | 0)
        assert abs(k - c) == (1 if c == 255 else 0)
        # p = 1 entry for c exists at index c (shifted-table identity)
        lo1, hi1 = int(t[c, 0]), int(t[c, 1])
        k1 = _interp(lo1, hi1, 21, lambda v: (v << 1) | 1)
        assert abs(k1 - c) == (1 if c == 0 else 0)


def test_unquant_endpoint_scalar_vs_vectorized():
    from basisu_rs_jax.ops.uastc_decode import unquant_endpoint
    import jax.numpy as jnp

    for ri, rng in enumerate(BISE_RANGES):
        tq_max = 3 if rng.trits else (5 if rng.quints else 1)
        for tq in range(tq_max):
            bits = np.arange(1 << rng.bits, dtype=np.int32)
            vec = np.asarray(unquant_endpoint(jnp.full_like(jnp.asarray(bits), tq), jnp.asarray(bits), ri))
            ref = np.array([unquant_endpoint_scalar(tq, int(b), ri) for b in bits])
            np.testing.assert_array_equal(vec, ref, err_msg=f"range {ri} tq {tq}")


def test_weight_unquant_formulas_match_reference_luts():
    from basisu_rs_jax.ops.uastc_decode import unquant_weight
    import jax.numpy as jnp

    luts = {
        1: [0, 64],
        2: [0, 21, 43, 64],
        3: [0, 9, 18, 27, 37, 46, 55, 64],
        4: [0, 4, 8, 12, 17, 21, 25, 29, 35, 39, 43, 47, 52, 56, 60, 64],
        5: [0, 2, 4, 6, 8, 10, 12, 14, 16, 18, 20, 22, 24, 26, 28, 30, 34, 36,
            38, 40, 42, 44, 46, 48, 50, 52, 54, 56, 58, 60, 62, 64],
    }
    for wb, lut in luts.items():
        w = jnp.arange(len(lut))
        np.testing.assert_array_equal(np.asarray(unquant_weight(w, wb)), lut)


def test_bc7_weight_remap_matches_reference_luts():
    from basisu_rs_jax.ops.bc7 import remap_weight_to_bc7
    import jax.numpy as jnp

    cases = {
        (1, 2): [0, 3],
        (2, 4): [0, 5, 10, 15],
        (3, 4): [0, 2, 4, 6, 9, 11, 13, 15],
        (5, 4): [0, 0, 1, 1, 2, 2, 3, 3, 4, 4, 5, 5, 6, 6, 6, 7, 8, 9, 9, 9,
                 10, 10, 11, 11, 12, 12, 13, 13, 14, 14, 15, 15],
    }
    for (ub, bb), lut in cases.items():
        w = jnp.arange(len(lut))
        np.testing.assert_array_equal(np.asarray(remap_weight_to_bc7(w, ub, bb)), lut)


def test_pbit_luts_match_numpy_reference():
    """Spot-check the f32 p-bit LUTs against a direct scalar transcription of
    the reference math in numpy float32 (bc7.rs:437-456)."""
    for tb in (5, 6, 7, 8):
        xq, err_u, err_s = pbit_luts(tb)
        iscalep = (1 << tb) - 1
        for p in (0, 1):
            for v in (0, 1, 17, 127, 254, 255):
                xl = np.float32(v) / np.float32(255)
                t = np.float32(xl * np.float32(iscalep))
                q = int(np.float32((t - np.float32(p)) / np.float32(2) + np.float32(0.5)))
                x = min(max(q * 2 + p, p), iscalep - 1 + p)
                assert xq[p][v] == x >> 1


def test_mode_bit_budgets():
    """Every non-void mode's fields must fit in 128 bits exactly as laid out."""
    for cfg in MODES:
        if cfg.id == 8:
            continue
        weights_bits = 0
        wb = cfg.weight_bits
        # anchors cost 1 bit less each; subset_count anchors (mode 7 has 2)
        n_anchors = {1: 1, 2: 2, 3: 3}[cfg.subset_count]
        weights_bits = cfg.plane_count * (16 * wb) - cfg.plane_count * n_anchors
        total = cfg.field_offsets["weights"] + weights_bits
        assert total <= 128, (cfg.id, total)


def test_header_field_order():
    """Byte-ramp header parse (mirrors the reference's test, basis.rs:578-620)."""
    b = bytes(range(Header.FILE_SIZE))
    h = Header.from_file_bytes(b)
    assert h.sig == 0x0100
    assert h.data_size == int.from_bytes(bytes([8, 9, 10, 11]), "little")
    assert h.total_slices == int.from_bytes(bytes([14, 15, 16]), "little")
    assert h.tex_format == 20
    assert h.total_endpoints == int.from_bytes(bytes([39, 40]), "little")
    assert h.endpoint_cb_file_size == int.from_bytes(bytes([45, 46, 47]), "little")
    assert h.extended_file_size == int.from_bytes(bytes([73, 74, 75, 76]), "little")

    s = SliceDesc.from_file_bytes(bytes(range(SliceDesc.FILE_SIZE)))
    assert s.image_index == int.from_bytes(bytes([0, 1, 2]), "little")
    assert s.level_index == 3 and s.flags == 4
    assert s.orig_width == int.from_bytes(bytes([5, 6]), "little")
    assert s.slice_data_crc16 == int.from_bytes(bytes([21, 22]), "little")


def test_crc16_known_answers():
    # CRC-16/GENIBUS check value for "123456789" is 0xD64E
    assert crc16(b"123456789") == 0xD64E
    assert crc16(b"") == 0


def test_xq_mulshift_constants_exhaustive():
    """Exhaustive proof behind _XQ_MULSHIFT (ops/bc7.py): for every
    total_bits and endpoint byte e, the single mul-shifts on e reproduce
    q1 = floor(e*iscalep/510) and q0 = floor((e*iscalep + 255)/510), the
    clamps commute with halving (iscalep odd), and the clamped half-values
    equal the reference-derived p-bit LUTs (pbit_luts) directly - so x is
    never materialized in the search."""
    import numpy as np

    from basisu_rs_jax.ops.bc7 import _XQ_MULSHIFT
    from basisu_rs_jax.tables.bc7_tables import pbit_luts

    e = np.arange(256, dtype=np.int64)
    for tb, ((K1, S1), (K0, B0, S0)) in _XQ_MULSHIFT.items():
        isc = (1 << tb) - 1
        m = e * isc
        np.testing.assert_array_equal((e * K1) >> S1, m // 510)
        np.testing.assert_array_equal((e * K0 + B0) >> S0, (m + 255) // 510)
        assert e[-1] * K0 + B0 < 2**31 and e[-1] * K1 < 2**31  # int32-safe
        h = isc >> 1
        q0c = np.minimum((e * K0 + B0) >> S0, h)
        q1c = np.minimum((e * K1) >> S1, h)
        # clamp/halving commutation: x0 = 2*q0c, x1 = 2*q1c + 1
        np.testing.assert_array_equal(2 * q0c, np.minimum(2 * ((m + 255) // 510), isc - 1))
        np.testing.assert_array_equal(2 * q1c + 1, np.minimum(2 * (m // 510) + 1, isc))
        # ...and the half-values ARE the reference LUTs' x >> 1
        xq, _, _ = pbit_luts(tb)
        np.testing.assert_array_equal(q0c, xq[0])
        np.testing.assert_array_equal(q1c, xq[1])


def test_scale_ep_mulshift_exhaustive():
    """Exhaustive proof behind _SCALE_EP_MULSHIFT (ops/bc7.py): for every
    endpoint width and byte e, (e*K + B) >> S == floor((e*mask + 127)/255)
    (bc7.rs:262-272), with int31-safe products."""
    import numpy as np

    from basisu_rs_jax.ops.bc7 import _SCALE_EP_MULSHIFT

    e = np.arange(256, dtype=np.int64)
    for nbits, (K, B, S) in _SCALE_EP_MULSHIFT.items():
        msk = (1 << nbits) - 1
        np.testing.assert_array_equal((e * K + B) >> S, (e * msk + 127) // 255)
        assert e[-1] * K + B < 2**31


def test_pbit_unique_error_terms_are_integers():
    """Exhaustive proof backing the int32 unique-p-bit search (ops/bc7.py):
    for every total_bits, p and endpoint byte v, the reference's f32 error
    term (scaled - fl(fl(v/255)*255))^2 equals the integer (scaled - v)^2
    exactly, and 4-term sums stay below 2^24 (f32-exact range) - so the f32
    fold is bit-equivalent to integer arithmetic."""
    import numpy as np

    from basisu_rs_jax.tables.bc7_tables import pbit_luts

    v = np.arange(256)
    # fl(fl(v/255) * 255) == v exactly (IEEE single)
    roundtrip = ((v.astype(np.float32) / np.float32(255)) * np.float32(255)).astype(np.float32)
    np.testing.assert_array_equal(roundtrip, v.astype(np.float32))

    for tb in range(4, 9):
        xq, err_u, _ = pbit_luts(tb)
        for p in (0, 1):
            x = 2 * xq[p].astype(np.int64) + p
            if tb < 8:
                s0 = (x << (8 - tb)) & 0xFF
                scaled = s0 | (s0 >> tb)
            else:
                scaled = x
            int_term = (scaled - v) ** 2
            assert (int_term <= 255 * 255).all()  # 4 terms < 2^24
            np.testing.assert_array_equal(err_u[p], int_term.astype(np.float32))
            # gather-free quantization (ops/bc7.py _xq_pair): the f32
            # quantization equals clamp(2*floor((v*iscalep+255-255p)/510)+p,
            # p, iscalep-1+p), with floor(n/510) = ((n>>1)*32897)>>23
            iscalep = (1 << tb) - 1
            n = v.astype(np.int64) * iscalep + 255 - 255 * p
            q = ((n >> 1) * 32897) >> 23
            assert ((n >> 1) * 32897 < 2**31).all()  # int32-safe on device
            x_int = np.minimum(2 * q + p, iscalep - 1 + p)
            np.testing.assert_array_equal(x_int >> 1, xq[p])


def test_astc_interpolate_equal_endpoints_is_identity():
    """Exhaustive proof behind ops/rgba's constant-channel folding: the
    ASTC fixed-point lerp of equal endpoints returns the endpoint for every
    (value, weight) pair, so trace-time object-identical endpoint channels
    (RGB alpha, LA r/g/b replication) need no interpolation at all."""
    import numpy as np

    l = np.arange(256)[:, None]
    w = np.arange(65)[None, :]
    L0 = (l << 14) + (l << 6) + 32  # interp_hoist with d = h - l = 0
    got = (L0 + 0 * w) >> 14
    np.testing.assert_array_equal(got, np.broadcast_to(l, got.shape))


def test_etc1_selector_boolean_forms():
    """The nested-threshold boolean forms in ops/etc._etc_rgb_lanes (ms=!c2,
    ls=c3|!c1) must match selector_ms_ls over all four nested hit patterns
    (c1>=c2>=c3, sel=c1+c2+c3)."""
    import jax.numpy as jnp
    import numpy as np

    from basisu_rs_jax.ops.etc import selector_ms_ls

    for c1, c2, c3 in [(0, 0, 0), (1, 0, 0), (1, 1, 0), (1, 1, 1)]:
        sel = jnp.asarray([c1 + c2 + c3])
        ms_ref, ls_ref = selector_ms_ls(sel)
        assert int(ms_ref[0]) == (1 - c2)
        assert int(ls_ref[0]) == (c3 | (1 - c1))


def test_eac_rank_selector_matches_packed_min():
    """Exhaustive proof for ops/etc.write_etc2_alpha_block's rank-count
    selector search: over ALL (table, multiplier, center, alpha) combos it
    equals the packed-min transcription of the reference's min_by_key
    (etc.rs:315-323), including first-minimal-j tie resolution and every
    clipping-induced duplicate-run shape."""
    import numpy as np

    from basisu_rs_jax.tables import np_tables

    mods = np_tables()["ETC2_ALPHA_MODIFIERS"]
    perm = [3, 2, 1, 0, 4, 5, 6, 7]
    center = np.arange(256)[:, None]
    a = np.arange(256)[None, :]
    for t in range(16):
        for mult in range(16):
            vals = [np.clip(center + mods[t, j] * mult, 0, 255) for j in range(8)]
            ref = np.abs(vals[0] - a) << 3
            for j in range(1, 8):
                ref = np.minimum(ref, (np.abs(vals[j] - a) << 3) | j)
            ref_j = ref & 7

            W = [vals[p] for p in perm]
            r = np.zeros_like(ref_j)
            for k in range(1, 4):
                r = r + (2 * a >= W[k - 1] + W[k])
            for k in range(4, 8):
                r = r + (2 * a > W[k - 1] + W[k])
            got = np.where(r < 4, 3 - r, r)
            got = np.where((mult == 0) | ((W[3] == W[4]) & (r <= 4)), 0, got)
            np.testing.assert_array_equal(got, ref_j, err_msg=f"table {t} mult {mult}")

            # the shipped binary-search form (ops/etc.write_etc2_alpha_block):
            # pre-halved thresholds, 3-level search, where(b2, 4+u, 7-(4+u))
            S = [W[k - 1] + W[k] for k in range(1, 8)]
            T = [(S[k] + 1) >> 1 for k in (0, 1, 2)] + [
                (S[k] + 2) >> 1 for k in (3, 4, 5, 6)
            ]
            b2 = a >= T[3]
            b1 = a >= np.where(b2, T[5], T[1])
            t0 = np.where(b2, np.where(b1, T[6], T[4]), np.where(b1, T[2], T[0]))
            b0 = a >= t0
            u = (b1.astype(np.int64) << 1) | b0
            v = 4 + u
            bs = np.where(b2, v, 7 - v)
            zero = (mult == 0) | ((W[3] == W[4]) & (~b2 | (u == 0)))
            bs = np.where(zero, 0, bs)
            np.testing.assert_array_equal(bs, ref_j, err_msg=f"bsearch table {t} mult {mult}")

            # the SHIPPED round-5 form: duplicate-run fixups folded into the
            # per-block thresholds (T[0..2] := 0 and T[3] := T[4] when the
            # low ranks collapse; T[4..6] := 256 when mult == 0), forcing
            # rank 3 (-> j = 0) with NO per-texel mask chain
            kill_all = mult == 0
            kill_lo = kill_all | (W[3] == W[4])
            Tf = [np.where(kill_lo, 0, T[k]) for k in (0, 1, 2)] + list(T[3:])
            for k in (4, 5, 6):
                Tf[k] = np.where(kill_all, 256, Tf[k])
            Tf[3] = np.where(kill_lo, Tf[4], Tf[3])
            b2 = a >= Tf[3]
            b1 = a >= np.where(b2, Tf[5], Tf[1])
            t0 = np.where(b2, np.where(b1, Tf[6], Tf[4]), np.where(b1, Tf[2], Tf[0]))
            b0 = a >= t0
            u = (b1.astype(np.int64) << 1) | b0
            got5 = u ^ (3 + b2.astype(np.int64))
            np.testing.assert_array_equal(got5, ref_j, err_msg=f"folded table {t} mult {mult}")


def test_astc_interpolate_factored_form():
    """Exhaustive proof for ops/uastc_decode.astc_interpolate: for all
    l, h in 0..255 and w in 0..64, ((l*257)*(64-w) + (h*257)*w + 32) >> 14
    == (L0 + D*w) >> 14 with the per-block halves L0 = 257*64*l + 32 and
    D = 257*(h-l) (interp_hoist/interp_eval), int32-safe and the summed
    numerator non-negative (so the device's arithmetic shift floors)."""
    import numpy as np

    l, h, w = np.meshgrid(
        np.arange(256), np.arange(256), np.arange(65), indexing="ij"
    )
    l = l.astype(np.int64)
    h = h.astype(np.int64)
    ref = ((l * 257) * (64 - w) + (h * 257) * w + 32) >> 14
    d = h - l
    L0 = (l << 14) + (l << 6) + 32
    D = (d << 8) + d
    n = L0 + D * w
    assert n.min() >= 32 and n.max() < 2**31 and np.abs(D * w).max() < 2**31
    got = n >> 14
    np.testing.assert_array_equal(got, ref)


def test_bise_digit_division_mulshift_exact():
    """Exhaustive proof for ops/uastc_decode.decode_endpoints' constant
    divisions: (g*171)>>9 == g//3 and (g*205)>>10 == g//5 for every possible
    BISE digit-group value (groups are at most 8 bits wide)."""
    import numpy as np

    g = np.arange(256)
    np.testing.assert_array_equal((g * 171) >> 9, g // 3)
    np.testing.assert_array_equal((g * 205) >> 10, g // 5)


def test_unquant_weight_wb4_correction_closed_form():
    """(w>=4) + 2*(w>=8) + (w>=12) == q + (q>>1) with q = w>>2, for all
    w in 0..15 (ops/uastc_decode.unquant_weight weight_bits=4)."""
    for w in range(16):
        q = w >> 2
        assert (w >= 4) + 2 * (w >= 8) + (w >= 12) == q + (q >> 1)


def test_bc7_anchor_msb_statically_zero():
    """Proof backing ops/bc7.py's dead-code elimination of the anchor-MSB
    endpoint swap: an anchor texel's weight is decoded with wb-1 bits
    (uastc.rs:727-740), and for every (uastc_wb -> bc7_wb) remap used by any
    mode, no (wb-1)-bit input maps to a value with the BC7 MSB set - so the
    reference's inversion test (bc7.rs:178,190-195,228-235) is always false
    for subset 0 (whose anchor is texel 0) and for both planes of
    single-subset modes."""
    import numpy as np

    from basisu_rs_jax.ops.bc7 import remap_weight_to_bc7
    from basisu_rs_jax.tables import BC7_MODES, MODES, np_tables

    t = np_tables()
    pairs = set()
    for cfg in MODES:
        if cfg.id == 8:
            continue
        bm = BC7_MODES[int(t["UASTC_TO_BC7_MODES"][cfg.id])]
        pairs.add((cfg.weight_bits, bm.weight_bits))
    assert pairs  # at least one mode mapping exists
    for uwb, bwb in sorted(pairs):
        anchor_max = (1 << (uwb - 1)) - 1  # anchors store uwb-1 bits
        w = np.arange(anchor_max + 1)
        out = remap_weight_to_bc7(w, uwb, bwb)
        assert (out >= 0).all() and (out < (1 << (bwb - 1))).all(), (uwb, bwb, out)


def test_remap_preserves_msb():
    """Proof backing fam_bc7_inv_relpos_packed: every (uastc_wb -> bc7_wb)
    weight remap used by any mode preserves the MSB - the raw stored top bit
    of a full-width weight IS the post-remap BC7 MSB, so the anchor-driven
    inversion bit (bc7.rs:171-195) can be read straight out of the lanes at
    a per-pattern bit position."""
    import numpy as np

    from basisu_rs_jax.ops.bc7 import remap_weight_to_bc7
    from basisu_rs_jax.tables import BC7_MODES, MODES, np_tables

    t = np_tables()
    pairs = set()
    for cfg in MODES:
        if cfg.id == 8:
            continue
        bm = BC7_MODES[int(t["UASTC_TO_BC7_MODES"][cfg.id])]
        pairs.add((cfg.weight_bits, bm.weight_bits))
    for uwb, bwb in sorted(pairs):
        w = np.arange(1 << uwb)
        out = remap_weight_to_bc7(w, uwb, bwb)
        assert np.array_equal((w >> (uwb - 1)) & 1, (out >> (bwb - 1)) & 1), (uwb, bwb)


def test_bc7_inv_relpos_matches_decoded_weights():
    """The packed inv-bit position table locates exactly the decoded BC7
    anchor texel's weight MSB for every (family, mode, pattern): cross-check
    rel positions against the decode-layout arithmetic and the valid flag
    against UASTC-anchor coincidence."""
    import numpy as np

    from basisu_rs_jax.tables import (
        MODES,
        fam_anchors_before,
        fam_bc7_inv_relpos_packed,
        get_family,
    )

    for m in (1, 2, 3, 4, 7):
        cfg = MODES[m]
        fam = get_family(cfg)
        wb = cfg.weight_bits
        ab = fam_anchors_before(fam.name)
        packed = fam_bc7_inv_relpos_packed(fam.name, wb)
        nsub = fam.bc7_anchors.shape[1] if fam.bc7_anchors.ndim == 2 else 1
        for p in range(fam.count):
            uanch = {int(x) for x in fam.anchors[p]}
            for k in range(1, {"2": 2, "3": 3, "23": 3, "m1": 2}[fam.name]):
                entry = (int(packed[p]) >> (8 * (k - 1))) & 0xFF
                a = int(fam.bc7_anchors[p][k])
                # stored field of texel a starts at wb*a - anchors_before(a);
                # its full-width MSB is wb-1 bits above that
                assert entry & 63 == wb * a - int(ab[p, a]) + wb - 1
                assert (entry >> 7) == (0 if a in uanch else 1)


def test_bc7_weight_remap_range():
    """Every remap output fits in bc7 weight_bits for every full-width input
    (backs the mask-free weight emission in ops/bc7.py)."""
    import numpy as np

    from basisu_rs_jax.ops.bc7 import remap_weight_to_bc7
    from basisu_rs_jax.tables import BC7_MODES, MODES, np_tables

    t = np_tables()
    for cfg in MODES:
        if cfg.id == 8:
            continue
        bm = BC7_MODES[int(t["UASTC_TO_BC7_MODES"][cfg.id])]
        w = np.arange(1 << cfg.weight_bits)
        out = remap_weight_to_bc7(w, cfg.weight_bits, bm.weight_bits)
        assert (out >= 0).all() and (out < (1 << bm.weight_bits)).all(), cfg.id
