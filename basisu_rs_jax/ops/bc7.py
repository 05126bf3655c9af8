"""UASTC -> BC7 block repack, vectorized per mode.

Mirrors `convert_block_from_uastc` (reference: src/target_formats/bc7.rs:9-310):
mode-mapped repack with endpoint permutation, anchor-driven endpoint swap +
weight inversion, p-bit determination, and field emission.  The reference's
f32 p-bit search (bc7.rs:408-553) is reproduced bit-exactly: unique p-bits
collapse to pure int32 arithmetic, and shared p-bits gather their f32 error
terms from reference-transcribed tables, leaving only f32 adds and compares
in the reference's summation order.
"""

from __future__ import annotations

import jax.numpy as jnp
import numpy as np

from ..tables import (
    BC7_MODES,
    ModeCfg,
    bc7_mode_5_optimal_packed,
    bc7_mode_6_optimal_packed,
    get_family,
    np_tables,
)
from ..tables.bc7_tables import pbit_luts
from .bits import lane_shape, lut_lookup, LaneWriter, U32, mask
from .uastc_decode import (
    assemble_endpoint_pairs,
    decode_fields,
    decode_mode8_rgba,
)

I32 = jnp.int32


def _take(table_np, idx):
    return lut_lookup(table_np, idx)


def remap_weight_to_bc7(w, uastc_bits: int, bc7_bits: int):
    """Closed forms of convert_weights_to_bc7's LUTs (bc7.rs:377-398)."""
    if uastc_bits == bc7_bits:
        return w
    if (uastc_bits, bc7_bits) == (1, 2):
        return 3 * w
    if (uastc_bits, bc7_bits) == (2, 4):
        return 5 * w
    if (uastc_bits, bc7_bits) == (3, 4):
        return 2 * w + (w >= 4)
    if (uastc_bits, bc7_bits) == (5, 4):
        # [0,0,1,1,...]: floor(w/2) with two spec deviations (bc7.rs:381-384)
        return (w >> 1) - (w == 14) + (w == 17)
    raise ValueError((uastc_bits, bc7_bits))


# ---------------------------------------------------------------------------
# p-bit determination (bc7.rs:408-553)
#
# Unique p-bits run in PURE int32: the reference's f32 error terms are
# (scaled - fl(fl(v/255)*255))^2, and fl(fl(v/255)*255) == v exactly for every
# v in 0..255 (IEEE single; exhaustively pinned by
# tests/test_tables.py::test_pbit_unique_error_terms_are_integers), so each
# term is an integer <= 255^2 and partial sums of <= 4 terms stay below 2^24 -
# the f32 fold is bit-equivalent to integer arithmetic.  Shared p-bits must
# keep f32: their terms divide scaled/255 (bc7.rs:444), which does NOT
# collapse to integers (see determine_shared_pbits).
# ---------------------------------------------------------------------------


def _fold_add_f32(terms):
    """Left-fold f32 addition in the reference's accumulation order."""
    acc = terms[0]
    for t in terms[1:]:
        acc = acc + t
    return acc


# Direct mul-shift forms of the two p-candidate quantizations, per
# total_bits tb with iscalep = 2^tb - 1:
#   q1 = floor(e*iscalep/510)         = (e*K1) >> S1
#   q0 = floor((e*iscalep + 255)/510) = (e*K0 + B0) >> S0
# exhaustively pinned over e in 0..255 for every tb by tests/test_tables.py
# (products int31-safe).  Entries: tb -> ((K1, S1), (K0, B0, S0)).
_XQ_MULSHIFT = {
    4: ((1928, 16), (1928, 32765, 16)),
    5: ((3983, 16), (3984, 32765, 16)),
    6: ((8096, 16), (8096, 32765, 16)),
    7: ((16320, 16), (16320, 32765, 16)),
    8: ((32768, 16), (32768, 32768, 16)),
}

# floor((e*mask + 127)/255) = (e*K + B) >> S per endpoint width, for the
# no-p-bit scale path (bc7.rs:262-272); pinned in test_tables.
_SCALE_EP_MULSHIFT = {
    4: (962, 8156, 14),
    5: (1992, 8156, 14),
    6: (4048, 8156, 14),
    7: (8160, 8156, 14),
}


def _xq_pair(total_bits: int, e):
    """Both p-candidates' quantized values for endpoint byte e, as CLAMPED
    HALF-values (q0c, q1c) with x0 = 2*q0c and x1 = 2*q1c + 1, gather-free.

    The reference's f32 quantization x = clamp(trunc((fl(e/255)*scalep - p)/2
    + 0.5)*2 + p, ...) (bc7.rs:437-441, 506-516) is exactly x = clamp(
    2*floor((e*iscalep + 255 - 255p)/510) + p, p, iscalep-1+p) for every
    (total_bits, p, e); the floors collapse to single mul-shifts on e
    (_XQ_MULSHIFT, pinned in tests/test_tables.py).  Since iscalep is odd,
    the clamps commute with halving (min(2q, iscalep-1) = 2*min(q, h) and
    min(2q+1, iscalep) = 2*min(q, h) + 1 for h = iscalep >> 1), so x is
    never materialized: emission wants the half-values and _scaled_half
    re-derives the 8-bit replication from them directly."""
    (K1, S1), (K0, B0, S0) = _XQ_MULSHIFT[total_bits]
    h = mask(total_bits) >> 1
    q0c = jnp.minimum((e * K0 + B0) >> S0, h).astype(I32)
    q1c = jnp.minimum((e * K1) >> S1, h).astype(I32)
    return q0c, q1c


def _scaled_half(total_bits: int, qc, p: int):
    """Bit-replicate x = 2*qc + p to 8 bits without materializing x.
    x <= iscalep, so x << (8 - total_bits) <= 256 - 2^(8-total_bits) never
    wraps u8 (bc7.rs:522's wrapping_shr(8) is a no-op at total_bits = 8)."""
    if total_bits < 8:
        s0 = qc << (9 - total_bits)
        if p:
            s0 = s0 | (1 << (8 - total_bits))
        return s0 | (s0 >> total_bits)
    return (qc << 1) | p if p else qc << 1


def _select_quantized(xpairs, pb, total_comps):
    m = pb == 1  # hoisted: one compare shared across channels
    # xpairs hold half-values: exactly the (x >> 1) the emission wants
    sel = [
        jnp.where(m, xpairs[c][1], xpairs[c][0]) for c in range(total_comps)
    ]
    # untouched channels are never emitted (emission loops over cc only)
    return sel + [jnp.zeros_like(sel[0])] * (4 - total_comps)


def determine_unique_pbits(total_comps: int, comp_bits: int, e_lo, e_hi):
    """e_lo/e_hi: [4] lists of int32[N] 0..255.  Returns quantized endpoint
    lists (>>1 values) and (pb_lo, pb_hi) int32[N].  Entirely gather-free
    integer arithmetic (see _xq_pair and the module note)."""
    tb = comp_bits + 1
    x_lo = [_xq_pair(tb, e_lo[c]) for c in range(total_comps)]
    x_hi = [_xq_pair(tb, e_hi[c]) for c in range(total_comps)]
    errs = {}
    for p in (0, 1):
        el = eh = 0
        for c in range(total_comps):
            a = _scaled_half(tb, x_lo[c][p], p) - e_lo[c]
            el = el + a * a
            b = _scaled_half(tb, x_hi[c][p], p) - e_hi[c]
            eh = eh + b * b
        errs[p] = (el, eh)
    pb_lo = (errs[1][0] < errs[0][0]).astype(I32)
    pb_hi = (errs[1][1] < errs[0][1]).astype(I32)
    return (
        _select_quantized(x_lo, pb_lo, total_comps),
        _select_quantized(x_hi, pb_hi, total_comps),
        pb_lo,
        pb_hi,
    )


def determine_shared_pbits(total_comps: int, comp_bits: int, e_lo, e_hi):
    """Shared p-bits keep the reference's IEEE-f32 error comparison: ties in
    the integer sums are resolved by last-ulp f32 rounding.  Each term
    (fl(scaled/255) - fl(v/255))^2 (bc7.rs:444) is a pure function of
    (total_bits, p, v), so it is gathered from the reference-transcribed
    table (tables/bc7_tables.pbit_luts) and only f32 additions run on the
    device, in the reference's accumulation order.  No f32 multiply is left
    for a compiler to contract into an FMA: a fused `bl*bl + bh*bh` changes
    the sum for some endpoint pairs (exhaustively shown in
    tests/test_fma.py)."""
    tb = comp_bits + 1
    x_lo = [_xq_pair(tb, e_lo[c]) for c in range(total_comps)]
    x_hi = [_xq_pair(tb, e_hi[c]) for c in range(total_comps)]
    _, _, err_s = pbit_luts(tb)
    errs = {}
    for p in (0, 1):
        terms = [
            _take(err_s[p], e_lo[c]) + _take(err_s[p], e_hi[c])
            for c in range(total_comps)
        ]
        errs[p] = _fold_add_f32(terms)
    sb = (errs[1] < errs[0]).astype(I32)
    return (
        _select_quantized(x_lo, sb, total_comps),
        _select_quantized(x_hi, sb, total_comps),
        sb,
        sb,
    )


# ---------------------------------------------------------------------------
# mode 8 (void extent) -> BC7 mode 5/6 solid color (bc7.rs:18-58, 312-375)
# ---------------------------------------------------------------------------


def _mode8_to_bc7(lanes):
    rgba = decode_mode8_rgba(lanes)  # [r,g,b,a] int32[N]
    shape = rgba[0].shape

    # mode 6 per-p error: only extremes are lossy (bc7.rs:1133-1136)
    err0 = sum((c == 255).astype(I32) for c in rgba)  # p_bit = 0
    err1 = sum((c == 0).astype(I32) for c in rgba)  # p_bit = 1
    use5 = (err0 > 0) & (err1 > 0)
    best_p = (err1 < err0).astype(I32)

    # packed (lo | hi << 7) endpoint tables: the packed word IS the emission
    # bit layout (lo at +0, hi at +7), so each channel costs ONE gather and
    # ONE 14-bit deposit instead of two of each
    m5p = bc7_mode_5_optimal_packed()  # [256]
    m6p = bc7_mode_6_optimal_packed()  # [257]

    # --- mode 5 layout: 6 mode bits, 2 rotation, 3x7x2 color, 8x2 alpha,
    #     2x(1+15x2) weights
    w5 = LaneWriter(shape, 4)
    w5.put_const(1 << 5, 0, 6)
    ofs = 8  # rotation bits are 0
    for c in range(3):
        w5.put(_take(m5p, rgba[c]), ofs, 14)
        ofs += 14
    w5.put(rgba[3] * 0x101, ofs, 16)  # alpha lo == hi: both bytes, one put
    ofs += 16
    # color weights: all BC7ENC_MODE_5_OPTIMAL_INDEX (=1) - constant bits
    w5.put_const(1, ofs, 1)
    ofs += 1
    for _ in range(15):
        w5.put_const(1, ofs, 2)
        ofs += 2
    # alpha weights: all 0 (nothing to write)

    # --- mode 6 layout: 7 mode bits, 4x7x2 endpoints, 2 p-bits, 1x(3+15x4)
    idx6 = best_p  # table index c + (1 - p)  (bc7.rs:1126-1131)
    w6 = LaneWriter(shape, 4)
    w6.put_const(1 << 6, 0, 7)
    ofs = 7
    for c in range(4):
        i = rgba[c] + (1 - idx6)
        w6.put(_take(m6p, i), ofs, 14)
        ofs += 14
    w6.put(best_p * 3, ofs, 2)  # (p << 1) | p
    ofs += 2
    w6.put_const(5, ofs, 3)
    ofs += 3
    for _ in range(15):
        w6.put_const(5, ofs, 4)
        ofs += 4

    # select per word
    out = [jnp.where(use5, a, b) for a, b in zip(w5.lanes, w6.lanes)]
    return out, jnp.zeros(shape, bool)


# ---------------------------------------------------------------------------
# general path
# ---------------------------------------------------------------------------


def uastc_to_bc7_mode(cfg: ModeCfg, lanes):
    """uint32[N,4] UASTC lanes -> (list of 4 BC7 output words, err[N])."""
    if cfg.id == 8:
        return _mode8_to_bc7(lanes)

    t = np_tables()
    bc7_idx = int(t["UASTC_TO_BC7_MODES"][cfg.id])
    bm = BC7_MODES[bc7_idx]
    cc = bm.channel_count
    wb7 = bm.weight_bits
    wmask7 = mask(wb7)
    shape = lane_shape(lanes)

    f = decode_fields(cfg, lanes)
    pairs = assemble_endpoint_pairs(cfg, f.endpoints)  # [uastc subset][2][4]

    # weights, remapped to the BC7 scale (bc7.rs:87-103)
    if cfg.plane_count == 1:
        w = [[remap_weight_to_bc7(f.weights[i], cfg.weight_bits, wb7) for i in range(16)]]
    else:
        w = [
            [remap_weight_to_bc7(f.weights[2 * i], cfg.weight_bits, wb7) for i in range(16)],
            [remap_weight_to_bc7(f.weights[2 * i + 1], cfg.weight_bits, wb7) for i in range(16)],
        ]

    writer = LaneWriter(shape, 4)
    writer.put_const(1 << bc7_idx, 0, bc7_idx + 1)
    ofs = bc7_idx + 1

    nsub7 = bm.subset_count
    bc7_anchor_vals = None  # per-subset anchor texel (subset 0 -> 0)
    e_lo = [[None] * 4 for _ in range(nsub7)]
    e_hi = [[None] * 4 for _ in range(nsub7)]

    if nsub7 != 1:
        fam = get_family(cfg)
        bc7_pat = _take(fam.bc7_index, f.pat)
        pat_packed = _take(fam.bc7_pat_packed, f.pat)
        subs7 = [(pat_packed >> (2 * i)) & 3 for i in range(16)]
        perm_packed = _take(fam.perm_packed, f.pat)

        writer.put(bc7_pat, ofs, bm.pat_bits)
        ofs += bm.pat_bits

        # permute endpoints: BC7 subset j <- UASTC subset perm[j] (bc7.rs:163-169).
        # The permutation masks are per-block: hoist one compare set per j and
        # share it across all 8 (lo/hi x channel) selects; channels whose
        # endpoint objects are identical across subsets (RGB alpha) skip the
        # select entirely.
        for j in range(nsub7):
            pj = (perm_packed >> (4 * j)) & 15
            pj_m = [pj == s for s in range(1, cfg.subset_count)]
            for k, dst in ((0, e_lo), (1, e_hi)):
                for c in range(4):
                    if all(
                        pairs[s][k][c] is pairs[0][k][c]
                        for s in range(cfg.subset_count)
                    ):
                        dst[j][c] = pairs[0][k][c]
                        continue
                    v = pairs[0][k][c]
                    for s in range(1, cfg.subset_count):
                        v = jnp.where(pj_m[s - 1], pairs[s][k][c], v)
                    dst[j][c] = v

        # swap endpoints + invert weights where the anchor MSB is set
        # (bc7.rs:171-195).  Subset 0 is statically exempt: its BC7 anchor is
        # texel 0 (BC7 partition tables put texel 0 in subset 0), which is
        # also the UASTC anchor of its own subset and therefore decoded with
        # wb-1 bits (uastc.rs:727-740) - and no weight remap maps a
        # (wb-1)-bit value onto the BC7 MSB (checked per remap in
        # test_tables), so the reference's test at bc7.rs:178 is always
        # false for j == 0.
        #
        # For j >= 1 the driving bit is read STRAIGHT OUT OF THE LANES: the
        # BC7 MSB equals the raw stored MSB for every remap
        # (test_remap_preserves_msb), and its bit position is a per-pattern
        # constant - one packed gather + a never-straddling 1-bit dynamic
        # read replaces the 16-way dynamic select over the decoded weights.
        from ..tables import fam_bc7_inv_relpos_packed
        from .bits import extract_bit_dyn

        relpos_np = fam_bc7_inv_relpos_packed(fam.name, cfg.weight_bits)
        base_w = cfg.field_offsets["weights"]
        inv_packed = _take(relpos_np, f.pat)
        inv = [None]
        for s in range(1, nsub7):
            entry = (inv_packed >> (8 * (s - 1))) & 0xFF
            rel_s = (relpos_np >> (8 * (s - 1))) & 63  # static bounds (numpy)
            bit = extract_bit_dyn(
                lanes,
                (entry & 63) + base_w,
                (base_w + int(rel_s.min()), base_w + int(rel_s.max()) + 1),
            )
            inv.append((bit & (entry >> 7).astype(U32)).astype(bool))
        for j in range(1, nsub7):
            for c in range(4):
                lo, hi = e_lo[j][c], e_hi[j][c]
                if lo is hi:
                    continue  # constant channel: swap is the identity
                e_lo[j][c] = jnp.where(inv[j], hi, lo)
                e_hi[j][c] = jnp.where(inv[j], lo, hi)
        # invert = conditional bit-flip: w ^ (inv * wmask) beats the
        # compare/not/select chain, and the subset masks hoist per texel
        inv_masks = [None] + [inv[s].astype(I32) * wmask7 for s in range(1, nsub7)]
        for i in range(16):
            s_i = subs7[i]
            if nsub7 == 2:
                # subs7 values are 0/1: the mask select is one multiply
                m = inv_masks[1] * s_i
            else:
                m = jnp.where(s_i == 1, inv_masks[1], 0)
                for s in range(2, nsub7):
                    m = jnp.where(s_i == s, inv_masks[s], m)
            w[0][i] = w[0][i] ^ m
    else:
        # Single-subset: the anchor-MSB endpoint swap + weight inversion
        # (bc7.rs:171-246) is statically DEAD on every plane: the anchor is
        # texel 0, decoded with wb-1 bits (uastc.rs:727-740; both planes of a
        # dual-plane anchor lose a bit), and no weight remap maps a
        # (wb-1)-bit value onto the BC7 MSB (checked per remap in
        # test_tables::test_bc7_anchor_msb_statically_zero), so the
        # reference's inversion test is always false here.
        for c in range(4):
            e_lo[0][c] = pairs[0][0][c]
            e_hi[0][c] = pairs[0][1][c]
        if cfg.plane_count == 2:
            # channel rotation: swap compsel channel with alpha (bc7.rs:216-219);
            # one hoisted compare set shared by the lo/hi rotations
            cs = f.compsel
            cs_m = [cs == c for c in range(3)]
            for dst in (e_lo[0], e_hi[0]):
                old = list(dst)
                for c in range(3):
                    dst[c] = jnp.where(cs_m[c], old[3], old[c])
                a = jnp.where(cs_m[0], old[0], old[3])  # cs == 3 -> alpha stays
                for c in range(1, 3):
                    a = jnp.where(cs_m[c], old[c], a)
                dst[3] = a
            writer.put(((cs + 1) & 3).astype(U32), ofs, 2)
            ofs += 2
            if bm.id == 4:
                ofs += 1  # index selection bit, always 0 (bc7.rs:241-244)

    # ---- p-bits / endpoint scaling (bc7.rs:249-274) ----
    pb = []
    if bm.p_bits:
        for j in range(nsub7):
            lo, hi, p0, p1 = determine_unique_pbits(cc, bm.color_bits, e_lo[j], e_hi[j])
            e_lo[j], e_hi[j] = lo, hi
            pb.append((p0, p1))
    elif bm.sp_bits:
        for j in range(nsub7):
            lo, hi, p0, p1 = determine_shared_pbits(cc, bm.color_bits, e_lo[j], e_hi[j])
            e_lo[j], e_hi[j] = lo, hi
            pb.append((p0, p1))
    else:
        def scale_ep(e, nbits):
            # (e*mask + 127) // 255 (bc7.rs:262-272).  mask==255 is the
            # identity; otherwise the whole round-scale collapses to ONE
            # mul-add-shift on e: (e*K + B) >> S with per-width constants
            # pinned exhaustively in test_tables
            # (test_scale_ep_mulshift_exhaustive); products int31-safe.
            if nbits == 8:
                return e
            K, B, S = _SCALE_EP_MULSHIFT[nbits]
            return ((e * K + B) >> S).astype(I32)

        for j in range(nsub7):
            for c in range(3):
                e_lo[j][c] = scale_ep(e_lo[j][c], bm.color_bits)
                e_hi[j][c] = scale_ep(e_hi[j][c], bm.color_bits)
            if cc == 4:  # alpha is never emitted when cc == 3
                e_lo[j][3] = scale_ep(e_lo[j][3], bm.alpha_bits)
                e_hi[j][3] = scale_ep(e_hi[j][3], bm.alpha_bits)

    # ---- endpoint emission (bc7.rs:276-286) ----
    # lo and hi are adjacent fields and both < 2^bits (quantized/scaled
    # above), so each pair packs into ONE deposit
    for c in range(cc):
        bits = bm.color_bits if c != 3 else bm.alpha_bits
        for j in range(nsub7):
            writer.put(e_lo[j][c] | (e_hi[j][c] << bits), ofs, 2 * bits)
            ofs += 2 * bits

    if bm.p_bits:
        for j in range(nsub7):
            writer.put((pb[j][1] << 1) | pb[j][0], ofs, 2)
            ofs += 2
    elif bm.sp_bits:
        writer.put((pb[1][0] << 1) | pb[0][0], ofs, 2)
        ofs += 2

    # ---- weight emission (bc7.rs:296-307) ----
    # Anchor texels are stored with one less bit; inversion guarantees their
    # MSB is 0, so depositing the full wb7-bit value never overlaps.
    if nsub7 == 1:
        # Weights are adjacent fields and in-range (remap ranges pinned in
        # test_tables::test_bc7_weight_remap_range; the anchor's missing MSB
        # is statically zero, test_bc7_anchor_msb_statically_zero), so pack
        # up to 32 bits of them per deposit: one shift+or per extra weight
        # replaces a whole masked put.
        for plane_w in w:
            group, gofs, gbits = None, 0, 0
            for i in range(16):
                bits_i = wb7 - 1 if i == 0 else wb7
                if group is not None and gbits + bits_i <= 32:
                    group = group | (plane_w[i].astype(U32) << U32(gbits))
                    gbits += bits_i
                else:
                    if group is not None:
                        writer.put(group, gofs, gbits)
                    group, gofs, gbits = plane_w[i].astype(U32), ofs, bits_i
                ofs += bits_i
            writer.put(group, gofs, gbits)
    else:
        from ..tables import fam_bc7_anchors_before, fam_bc7_weight_preshift_packed

        # Each texel's weight lands inside a STATIC window
        # [ofs + wb7*i - maxab_i, ofs + wb7*i + wb7): pre-shift the value by
        # (maxab_i - ab_i) - gathered directly as a packed table, saving the
        # per-texel subtraction - and emit with one static put.  Weights are
        # already < 2^wb7 (every remap's range is checked in test_tables and
        # the inversion xor preserves the width), so no mask; the shifted
        # value's zero bits outside its true range OR harmlessly into
        # neighbors.  Texels whose anchors-before count is constant across
        # the family's patterns (the first few and trailing columns) emit at
        # a fully static position.
        ab_tab = fam_bc7_anchors_before(fam.name)  # [count, 16] numpy
        ps_packed = None
        for i in range(16):
            col = ab_tab[:, i]
            maxab = int(col.max())
            if maxab == int(col.min()):
                writer.put(w[0][i], ofs + wb7 * i - maxab, wb7)
            else:
                if ps_packed is None:
                    ps_packed = _take(fam_bc7_weight_preshift_packed(fam.name), f.pat)
                ps = ((ps_packed >> (2 * i)) & 3).astype(U32)
                writer.put(w[0][i].astype(U32) << ps, ofs + wb7 * i - maxab, wb7 + maxab)
        ofs += 16 * wb7 - nsub7

    return writer.lanes, f.err
