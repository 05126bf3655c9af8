"""Mode-specialized, vectorized UASTC block field decoding.

Each function takes a static `ModeCfg` plus a `uint32[N, 4]` lane tensor and
returns per-block field tensors.  Because kernels are specialized per mode,
every bit offset below is a Python int computed at trace time; the only
dynamic offsets are the weight positions of multi-subset modes, where anchor
texels (read with one less bit) depend on the block's pattern index.

Reference behavior being mirrored (file:line cites into /root/reference):
  - mode decode via 7-bit LUT: src/uastc.rs:329-341
  - component selector / pattern index: src/uastc.rs:343-366
  - BISE endpoint decode (quint/trit groups + raw bits): src/uastc.rs:616-695
  - endpoint dequantization: src/uastc.rs:585-614
  - weight decode with per-pattern anchors: src/uastc.rs:721-740
  - weight unquantization LUTs: src/uastc.rs:697-719
"""

from __future__ import annotations

from dataclasses import dataclass, field

import jax.numpy as jnp

from ..tables import BISE_RANGES, LA, ModeCfg, get_family
from .bits import lane_shape, lut_lookup, U32, extract, extract_dyn, mask

I32 = jnp.int32


@dataclass
class Fields:
    """Decoded per-block fields for one mode (all jnp arrays, batch dim N)."""

    err: object  # bool[N] - invalid pattern index
    compsel: object  # int32[N], 0..3
    pat: object  # int32[N], clamped to a valid pattern index
    endpoints: list  # E x int32[N], dequantized 0..255
    quant_tq: list  # E x int32[N], raw trit/quint digit
    quant_bits: list  # E x int32[N], raw bit part
    weights: list  # (16*planes) x int32[N], raw quantized weights (decode order)
    anchors: list  # nsub x int32[N] anchor texel indices (static 0 if single subset)
    invert_info: dict = field(default_factory=dict)


def _bise_layout(cfg: ModeCfg):
    """Static (kind, offset, width, digit_divisor, members) read plan for the
    quint/trit digit section, plus the offset where raw bits start."""
    rng = BISE_RANGES[cfg.endpoint_range_index]
    e = cfg.endpoint_count
    ofs = cfg.field_offsets["endpoints"]
    groups = []
    if rng.quints:
        full, rem = e // 3, e % 3
        for _ in range(full):
            groups.append((5, ofs, 7, 3))
            ofs += 7
        if rem:
            w = {1: 3, 2: 5}[rem]
            groups.append((5, ofs, w, rem))
            ofs += w
    if rng.trits:
        full, rem = e // 5, e % 5
        for _ in range(full):
            groups.append((3, ofs, 8, 5))
            ofs += 8
        if rem:
            w = {1: 2, 2: 4, 3: 5, 4: 7}[rem]
            groups.append((3, ofs, w, rem))
            ofs += w
    return groups, ofs, rng


def decode_endpoints(cfg: ModeCfg, lanes):
    """Returns (quant_tq, quant_bits, unquant) lists of int32[N] (length E)."""
    groups, bits_ofs, rng = _bise_layout(cfg)
    e = cfg.endpoint_count

    # floor(g/3) = (g*171)>>9 and floor(g/5) = (g*205)>>10, exact for every
    # group value (g <= 255; pinned exhaustively in test_tables) - `g // base`
    # would lower to the backend's generic integer-division sequence
    div_ms = {3: (171, 9), 5: (205, 10)}
    tq = []
    for base, ofs, width, members in groups:
        g = extract(lanes, ofs, width).astype(I32)
        # incremental divmod: one constant-divide per digit, remainder by
        # multiply-subtract (uastc.rs:634-683 digit order).  After the
        # divisions the final quotient is < 2*base for every group width, so
        # its mod reduces to a conditional subtract.
        m, sh = div_ms[base]
        for k in range(members):
            if k == members - 1:
                tq.append(g - base * (g >= base))
            else:
                q = (g * m) >> sh
                tq.append(g - q * base)
                g = q
    if not tq:
        tq = [jnp.zeros(lane_shape(lanes), I32)] * e

    qbits = []
    for i in range(e):
        if rng.bits:
            qbits.append(extract(lanes, bits_ofs + i * rng.bits, rng.bits).astype(I32))
        else:
            qbits.append(jnp.zeros(lane_shape(lanes), I32))

    unquant = [unquant_endpoint(tq[i], qbits[i], cfg.endpoint_range_index) for i in range(e)]
    return tq, qbits, unquant


def unquant_endpoint(trit_quint, bits, range_index: int):
    """Vectorized ASTC endpoint dequantization (reference: uastc.rs:585-614).

    Pure-bit ranges use cheap bit replication.  Trit/quint ranges whose
    (trit_quint, bits) -> value LUT has at most 128 entries use the LUT;
    larger ranges keep the scatter/mul/xor arithmetic."""
    rng = BISE_RANGES[range_index]
    if rng.trits == 0 and rng.quints == 0 and rng.bits > 0:
        if rng.bits == 8:
            return bits  # the 8-bit range replicates to itself
        # bit replication; every term is < 256 (first term is
        # bits << (8 - width) with bits < 2^width), so no final mask
        sh = 8 - rng.bits
        val = bits << sh
        sh -= rng.bits
        while sh > -rng.bits:
            val = val | (bits << sh if sh >= 0 else bits >> -sh)
            sh -= rng.bits
        return val
    from ..tables.bise import unquant_lut

    lut = unquant_lut(range_index)
    if len(lut) <= 128:
        return lut_lookup(lut, (trit_quint << rng.bits) | bits)
    a = (bits & 1) * 511
    # scatter bits of `bits` into b, pairs grouped by displacement
    # (out_bit - in_bit): one shift+and per group instead of 3 ops per pair
    # (the B-patterns replicate runs of bits, so 5-6 pairs collapse to 2-3
    # groups for every large range)
    groups: dict[int, int] = {}
    for out_bit, in_bit in rng.scatter_pairs:
        d = out_bit - in_bit
        groups[d] = groups.get(d, 0) | (1 << out_bit)
    b = None
    for d, m in groups.items():
        t = ((bits << d) if d >= 0 else (bits >> -d)) & m
        b = t if b is None else (b | t)
    val = (trit_quint * rng.deq_c + b) ^ a
    return (a & 0x80) | (val >> 2)


def decode_compsel(cfg: ModeCfg, lanes):
    if cfg.plane_count == 2 and cfg.format == LA:
        return jnp.full(lane_shape(lanes), 3, I32)  # LA always selects alpha
    if cfg.compsel_bits:
        return extract(lanes, cfg.field_offsets["compsel"], 2).astype(I32)
    return jnp.zeros(lane_shape(lanes), I32)


def decode_pattern(cfg: ModeCfg, lanes):
    """Returns (pat_clamped, err).  err=True marks an out-of-range pattern
    index (reference returns an error for the block, uastc.rs:361-365)."""
    if cfg.pattern_bits == 0:
        z = jnp.zeros(lane_shape(lanes), I32)
        return z, jnp.zeros(lane_shape(lanes), bool)
    pat = extract(lanes, cfg.field_offsets["pattern"], cfg.pattern_bits).astype(I32)
    err = pat >= cfg.pattern_count
    return jnp.minimum(pat, cfg.pattern_count - 1), err


def decode_anchors(cfg: ModeCfg, pat):
    """Anchor texel indices, one per subset (dynamic via the pattern tables
    for multi-subset modes; texel 0 for single-subset modes)."""
    fam = get_family(cfg)
    if fam is None or cfg.subset_count == 1 and cfg.id != 7:
        # Single-subset (incl. mode 1, whose *read* anchor list is [0]).
        return [jnp.zeros_like(pat)]
    packed = lut_lookup(fam.anchors_packed, pat)
    return [(packed >> (4 * k)) & 15 for k in range(fam.nsub)]


def decode_weights(cfg: ModeCfg, lanes, pat):
    """Raw quantized weights in decode order (k = plane_count*i + plane).

    Anchor texels are stored with one less bit (MSB implicitly 0,
    reference: uastc.rs:727-740)."""
    wb = cfg.weight_bits
    planes = cfg.plane_count
    base = cfg.field_offsets["weights"]
    anchors = decode_anchors(cfg, pat)
    multi = cfg.subset_count > 1 or cfg.id == 7

    weights = []
    if not multi:
        # Anchor is texel 0: fully static layout.
        ofs = base
        for i in range(16):
            bits_i = wb - 1 if i == 0 else wb
            for p in range(planes):
                weights.append(extract(lanes, ofs, bits_i).astype(I32))
                ofs += bits_i
        return weights, anchors

    # Multi-subset: anchor positions depend on the block's pattern, shifting
    # every later texel's offset down by the anchors-before count (0..nsub).
    # Every multi-subset mode is single-plane, so each texel's wb bits live
    # inside a STATIC window [base + wb*i - maxab_i, base + wb*i + wb): one
    # static extract + a tiny variable right-shift replaces the
    # word-select/funnel-shift chain of a fully dynamic extract.
    from ..tables import (
        fam_anchor_mask,
        fam_anchors_before,
        fam_anchors_before_packed,
        fam_weight_offsets_packed,
        get_family,
    )

    fam = get_family(cfg)

    if planes == 1:
        ab_tab = fam_anchors_before(fam.name)  # [count, 16] numpy
        ab_packed = lut_lookup(fam_anchors_before_packed(fam.name), pat)
        n_anch = fam.anchors.shape[1]
        # Per-position anchors-before counts: extracted ONCE each and shared
        # with the next texel's is-anchor delta (the old code re-extracted
        # ab[i+1] per texel), and folded to Python ints
        # where the column is constant across the family's patterns - always
        # for i <= 1 (texel 0 is every pattern's first-subset anchor) and for
        # the tail columns once all anchors have passed.
        abs_: list = []
        for i in range(16):
            lo, hi = int(ab_tab[:, i].min()), int(ab_tab[:, i].max())
            abs_.append(lo if lo == hi else (ab_packed >> (2 * i)) & 3)
        abs_.append(n_anch)
        for i in range(16):
            ab, maxab = abs_[i], int(ab_tab[:, i].max())
            ia = abs_[i + 1] - ab  # is-anchor: consecutive counts differ by 1
            if isinstance(ia, int):
                wmask = mask(wb) >> ia
            else:
                wmask = (U32(mask(wb)) >> ia.astype(U32)).astype(I32)
            if isinstance(ab, int):
                # constant anchors-before: fully static offset
                raw = extract(lanes, base + wb * i - ab, wb).astype(I32)
            else:
                # texel bits live in the static window
                # [base + wb*i - maxab, base + wb*i + wb); wmask clears
                # everything at/above bit wb - ia, subsuming the old
                # explicit mask(wb) AND
                win = extract(lanes, base + wb * i - maxab, wb + maxab)
                raw = (win >> (U32(maxab) - ab.astype(U32))).astype(I32)
            weights.append(raw & wmask)
        return weights, anchors

    amask = lut_lookup(fam_anchor_mask(fam.name), pat)

    # General dual-plane fallback (no current mode is both multi-subset and
    # dual-plane; kept for spec completeness): fully dynamic offsets.
    offs_words = [
        lut_lookup(fam_weight_offsets_packed(fam.name, wb, planes)[:, k], pat)
        for k in range(4)
    ]
    max_anchors = len(anchors)
    for i in range(16):
        ia = (amask >> i) & 1
        bits_i = wb - ia  # dynamic
        texel_ofs = base + ((offs_words[i // 4] >> (8 * (i % 4))) & 0xFF)
        wmask = (U32(mask(wb)) >> ia.astype(U32)).astype(I32)
        # static bounds: anchors_before_i <= min(i, max_anchors), so the
        # dynamic offset spans only a few bits -> 1-2 touched words
        ofs_min = base + planes * (wb * i) - planes * min(i, max_anchors)
        for p in range(planes):
            ofs = texel_ofs + p * bits_i
            ofs_max = base + planes * (wb * i) + p * wb
            raw = extract_dyn(lanes, ofs, wb, bit_range=(ofs_min, ofs_max)).astype(I32)
            weights.append(raw & wmask)
    return weights, anchors


def unquant_weight(w, weight_bits: int):
    """Quantized weight -> 0..64 scale, closed forms of the reference LUTs
    (uastc.rs:697-719)."""
    if weight_bits == 1:
        return w * 64
    if weight_bits == 2:
        return 21 * w + (w >= 2)
    if weight_bits == 3:
        return 9 * w + (w >= 4)
    if weight_bits == 4:
        # correction (w>=4) + 2*(w>=8) + (w>=12) == q + (q>>1) for q = w>>2
        q = w >> 2
        return 4 * w + q + (q >> 1)
    if weight_bits == 5:
        return 2 * w + 2 * (w >= 16)
    raise ValueError(weight_bits)


def interp_hoist(l, h):
    """Per-block halves of the factored ASTC lerp: (L0, D) with
    L0 = 257*64*l + 32 and D = 257*(h-l), as shift-adds.  interp_eval
    then needs ONE multiply, one add and one shift per texel."""
    d = h - l
    return (l << 14) + (l << 6) + 32, (d << 8) + d


def interp_eval(L0, D, w):
    """(L0 + D*w) >> 14 - the per-texel half of the factored ASTC lerp.
    The sum is 257*(l*64 + (h-l)*w) + 32 in [32, 4194272]: int32-safe and
    non-negative, so the shift is a floor."""
    return (L0 + D * w) >> 14


def astc_interpolate(l, h, w):
    """Fixed-point ASTC interpolation, srgb=false path (uastc.rs:218-235).
    l, h: 0..255 int32; w: 0..64 int32.

    The reference computes ((l*257)*(64-w) + (h*257)*w + 32) >> 14.  The
    numerator factors as (257*64*l + 32) + 257*(h-l)*w: hoisting
    L0 = 257*64*l + 32 and D = 257*(h-l) per endpoint pair (per BLOCK)
    leaves one multiply, one add and one shift per texel - exhaustively
    pinned against the reference form in test_tables.  Batch callers
    (ops/rgba.py) hoist via interp_hoist once per endpoint pair."""
    L0, D = interp_hoist(l, h)
    return interp_eval(L0, D, w)


def assemble_endpoint_pairs(cfg: ModeCfg, endpoints):
    """[subset][lo/hi][channel rgba] nested list of int32[N]
    (reference: uastc.rs:176-216)."""
    pairs = []
    full = jnp.full_like(endpoints[0], 255)
    if cfg.format == 0:  # RGB
        per = 6
        for s in range(cfg.subset_count):
            b = endpoints[s * per : (s + 1) * per]
            pairs.append([[b[0], b[2], b[4], full], [b[1], b[3], b[5], full]])
    elif cfg.format == 1:  # RGBA
        per = 8
        for s in range(cfg.subset_count):
            b = endpoints[s * per : (s + 1) * per]
            pairs.append([[b[0], b[2], b[4], b[6]], [b[1], b[3], b[5], b[7]]])
    else:  # LA
        per = 4
        for s in range(cfg.subset_count):
            b = endpoints[s * per : (s + 1) * per]
            pairs.append([[b[0], b[0], b[0], b[2]], [b[1], b[1], b[1], b[3]]])
    return pairs


def decode_fields(cfg: ModeCfg, lanes) -> Fields:
    """Full non-mode-8 field decode."""
    assert cfg.id != 8
    compsel = decode_compsel(cfg, lanes)
    pat, err = decode_pattern(cfg, lanes)
    tq, qbits, unq = decode_endpoints(cfg, lanes)
    weights, anchors = decode_weights(cfg, lanes, pat)
    return Fields(
        err=err,
        compsel=compsel,
        pat=pat,
        endpoints=unq,
        quant_tq=tq,
        quant_bits=qbits,
        weights=weights,
        anchors=anchors,
    )


def subsets_for_texels(cfg: ModeCfg, pat):
    """texel -> subset assignment, list of 16 int32[N]
    (reference: uastc.rs:368-376)."""
    fam = get_family(cfg)
    if fam is None or cfg.id == 1:
        z = jnp.zeros_like(pat)
        return [z] * 16
    packed = lut_lookup(fam.pat_packed, pat)
    return [(packed >> (2 * i)) & 3 for i in range(16)]


def decode_mode8_rgba(lanes):
    """Void-extent solid color, channels (r, g, b, a) int32[N]
    (reference: uastc.rs:387-394)."""
    from ..tables import MODE8_RGBA_OFFSET as O

    return [extract(lanes, O + 8 * c, 8).astype(I32) for c in range(4)]
