"""Static tables for the Basis Universal batch transcoder.

Raw format constants live in `generated_tables` (extracted from the reference
sources by tools/extract_tables.py); this module wraps them into numpy arrays
and *packed* per-pattern metadata words so that device kernels can resolve all
pattern-dependent values with a single small-table lookup per block.
"""

from __future__ import annotations

from dataclasses import dataclass
from functools import lru_cache

import numpy as np

from . import generated_tables as G
from .bise import BISE_RANGES, BiseRange, unquant_endpoint_scalar
from .modes import (
    ASTC_BLOCK_SIZE,
    BC7_BLOCK_SIZE,
    ETC1_BLOCK_SIZE,
    ETC2_BLOCK_SIZE,
    LA,
    MODE8_ETC1_FLAGS_OFFSET,
    MODE8_RGBA_OFFSET,
    MODES,
    RGB,
    RGBA,
    UASTC_BLOCK_SIZE,
    ModeCfg,
)
from .bc7_tables import (
    BC7_MODES,
    BC7ENC_MODE_5_OPTIMAL_INDEX,
    BC7ENC_MODE_6_OPTIMAL_INDEX,
    Bc7Mode,
    bc7_mode_5_optimal_endpoints,
    bc7_mode_6_optimal_endpoints,
    bc7_mode_5_optimal_packed,
    bc7_mode_6_optimal_packed,
    pbit_luts,
)

__all__ = [
    "ASTC_BLOCK_SIZE",
    "BC7_BLOCK_SIZE",
    "BC7_MODES",
    "BC7ENC_MODE_5_OPTIMAL_INDEX",
    "BC7ENC_MODE_6_OPTIMAL_INDEX",
    "BISE_RANGES",
    "BiseRange",
    "Bc7Mode",
    "ETC1_BLOCK_SIZE",
    "ETC2_BLOCK_SIZE",
    "LA",
    "MODE8_ETC1_FLAGS_OFFSET",
    "MODE8_RGBA_OFFSET",
    "MODES",
    "ModeCfg",
    "PatternFamily",
    "RGB",
    "RGBA",
    "UASTC_BLOCK_SIZE",
    "bc7_mode_5_optimal_endpoints",
    "bc7_mode_6_optimal_endpoints",
    "bc7_mode_5_optimal_packed",
    "bc7_mode_6_optimal_packed",
    "etc_bias_deltas",
    "get_family",
    "np_tables",
    "pbit_luts",
    "unquant_endpoint_scalar",
]


def _pack2(rows) -> np.ndarray:
    """Pack rows of 16 two-bit values into one uint32 per row (texel i at bits 2i)."""
    rows = np.asarray(rows, np.uint32)
    shifts = (np.arange(16, dtype=np.uint32) * 2)[None, :]
    return np.bitwise_or.reduce(rows << shifts, axis=1).astype(np.uint32)


def _pack_nibbles(rows) -> np.ndarray:
    """Pack short rows of values < 16 into one uint32 per row (4 bits each)."""
    rows = np.asarray(rows, np.uint32)
    shifts = (np.arange(rows.shape[1], dtype=np.uint32) * 4)[None, :]
    return np.bitwise_or.reduce(rows << shifts, axis=1).astype(np.uint32)


@dataclass(frozen=True)
class PatternFamily:
    """Per-pattern metadata for one multi-subset mode family, pre-packed for
    single-lookup consumption by kernels.

    UASTC side (used when *reading* the block):
      pat_texels / pat_packed: texel -> subset map (ASTC order)
      anchors: [count, nsub] anchor weight indices (read with 1 less bit)
    BC7 side (used when *writing* BC7 blocks):
      bc7_index: BC7 partition index written to the output
      bc7_pat_texels / bc7_pat_packed: texel -> BC7 subset map
      bc7_anchors: [count, 3] BC7 anchor texels (subset 0 anchor is always 0)
      perm: [count, 3] endpoint permutation, BC7 subset j <- UASTC subset perm[j]
    ASTC side:
      astc_index10: 10-bit ASTC partition seed
    """

    name: str
    count: int
    nsub: int
    pat_texels: np.ndarray
    pat_packed: np.ndarray
    anchors: np.ndarray
    anchors_packed: np.ndarray
    astc_index10: np.ndarray
    bc7_index: np.ndarray
    bc7_pat_texels: np.ndarray
    bc7_pat_packed: np.ndarray
    bc7_anchors: np.ndarray
    bc7_anchors_packed: np.ndarray
    perm: np.ndarray
    perm_packed: np.ndarray


def _family(name, nsub, pats, anchors, astc10, bc7_meta, bc7_pats, bc7_anchor_tab, perms):
    pats = np.asarray(pats, np.uint8)
    anchors = np.asarray(anchors, np.uint8)
    count = len(pats)
    bc7_index = np.asarray([m[0] for m in bc7_meta], np.uint8)
    bc7_pats = np.asarray(bc7_pats, np.uint8)
    bc7_anchors = np.asarray([bc7_anchor_tab[i] for i in bc7_index], np.uint8)
    if bc7_anchors.shape[1] == 2:  # pad to 3 columns (unused subset)
        bc7_anchors = np.concatenate([bc7_anchors, np.zeros((count, 1), np.uint8)], axis=1)
    perm = np.asarray(perms, np.uint8)
    if perm.shape[1] == 2:
        perm = np.concatenate([perm, np.zeros((count, 1), np.uint8)], axis=1)
    return PatternFamily(
        name=name,
        count=count,
        nsub=nsub,
        pat_texels=pats,
        pat_packed=_pack2(pats),
        anchors=anchors,
        anchors_packed=_pack_nibbles(anchors),
        astc_index10=np.asarray(astc10, np.uint16),
        bc7_index=bc7_index,
        bc7_pat_texels=bc7_pats,
        bc7_pat_packed=_pack2(bc7_pats),
        bc7_anchors=bc7_anchors,
        bc7_anchors_packed=_pack_nibbles(bc7_anchors),
        perm=perm,
        perm_packed=_pack_nibbles(perm),
    )


@lru_cache(maxsize=None)
def _families() -> dict:
    perm2 = [([1, 0] if inv else [0, 1]) for _, inv in G.PATTERNS_2_BC7_INDEX_INV]
    perm3 = [G.PATTERNS_3_BC7_TO_ASTC_PERMUTATIONS[p] for _, p in G.PATTERNS_3_BC7_INDEX_PERM]
    perm23 = [G.PATTERNS_2_3_BC7_TO_ASTC_PERMUTATIONS[p] for _, p in G.PATTERNS_2_3_BC7_INDEX_PERM]
    fams = {
        "2": _family(
            "2", 2, G.PATTERNS_2, G.PATTERNS_2_ANCHORS, G.PATTERNS_2_ASTC_INDEX_10,
            G.PATTERNS_2_BC7_INDEX_INV, G.PATTERNS_2_BC7, G.PATTERNS_2_BC7_ANCHORS, perm2,
        ),
        "3": _family(
            "3", 3, G.PATTERNS_3, G.PATTERNS_3_ANCHORS, G.PATTERNS_3_ASTC_INDEX_10,
            G.PATTERNS_3_BC7_INDEX_PERM, G.PATTERNS_3_BC7, G.PATTERNS_3_BC7_ANCHORS, perm3,
        ),
        # Mode 7: 2 UASTC subsets drawn from the 2/3 common-partition table,
        # mapped onto 3-subset BC7 mode 2 (reference: bc7.rs:128-137).
        "23": _family(
            "23", 2, G.PATTERNS_2_3, G.PATTERNS_2_3_ANCHORS, G.PATTERNS_2_3_ASTC_INDEX_10,
            G.PATTERNS_2_3_BC7_INDEX_PERM, G.PATTERNS_2_3_BC7, G.PATTERNS_3_BC7_ANCHORS, perm23,
        ),
        # Mode 1: single UASTC subset mapped onto 2-subset BC7 mode 3 with
        # partition 0 and both BC7 subsets fed the same endpoints
        # (reference: bc7.rs:119-127).
        "m1": _family(
            "m1", 1, [G.PATTERNS_2_BC7[0]], [[0]], [0],
            [G.PATTERNS_2_BC7_INDEX_INV[0]], [G.PATTERNS_2_BC7[0]],
            G.PATTERNS_2_BC7_ANCHORS, [[0, 0]],
        ),
    }
    return fams


def get_family(mode: ModeCfg) -> PatternFamily | None:
    """The pattern family a mode draws its partitions from, or None for
    single-subset modes (reference: uastc.rs:352-385)."""
    if mode.id == 1:
        return _families()["m1"]
    if mode.id == 7:
        return _families()["23"]
    if mode.subset_count == 1:
        return None
    return _families()["2" if mode.subset_count == 2 else "3"]


@lru_cache(maxsize=None)
def fam_anchor_mask(fam_name: str) -> np.ndarray:
    """uint32 [count]: bit i set iff texel i is an anchor of the pattern."""
    fam = _families()[fam_name]
    out = np.zeros(fam.count, np.uint32)
    for p in range(fam.count):
        for a in fam.anchors[p]:
            out[p] |= np.uint32(1) << int(a)
    return out


@lru_cache(maxsize=None)
def fam_anchors_before(fam_name: str) -> np.ndarray:
    """int64 [count, 16]: UASTC-side anchors_before_i per pattern and texel
    (anchor weights are stored with one less bit, uastc.rs:727-740)."""
    fam = _families()[fam_name]
    i = np.arange(16)
    return (fam.anchors[:, :, None].astype(np.int64) < i[None, None, :]).sum(1)


@lru_cache(maxsize=None)
def fam_anchors_before_packed(fam_name: str) -> np.ndarray:
    """uint32 [count]: fam_anchors_before packed 2 bits per texel."""
    ab = fam_anchors_before(fam_name)
    assert (ab <= 3).all()
    packed = np.zeros(ab.shape[0], np.uint32)
    for t in range(16):
        packed |= ab[:, t].astype(np.uint32) << (2 * t)
    return packed


@lru_cache(maxsize=None)
def fam_weight_offsets_packed(fam_name: str, weight_bits: int, plane_count: int) -> np.ndarray:
    """uint32 [count, 4]: per-pattern weight bit offsets (relative to the
    weight section start) of each texel, 8 bits per texel, 4 texels per word.

    offset_i = plane_count * (weight_bits*i - anchors_before_i); anchors are
    stored with one less bit (uastc.rs:727-740)."""
    fam = _families()[fam_name]
    i = np.arange(16)
    ab = fam_anchors_before(fam_name)  # [count, 16]
    offs = plane_count * (weight_bits * i[None, :] - ab)  # [count, 16]
    assert (offs >= 0).all() and (offs < 256).all()
    packed = np.zeros((fam.count, 4), np.uint32)
    for k in range(4):
        for j in range(4):
            packed[:, k] |= (offs[:, 4 * k + j].astype(np.uint32)) << (8 * j)
    return packed


@lru_cache(maxsize=None)
def fam_bc7_anchors_before(fam_name: str) -> np.ndarray:
    """int64 [count, 16]: BC7-side anchors_before_i per pattern and texel
    (anchor texels are written with one less bit; subset-0 anchor is 0)."""
    fam = _families()[fam_name]
    i = np.arange(16)
    nsub = {"2": 2, "3": 3, "23": 3, "m1": 2}[fam_name]
    anch = fam.bc7_anchors[:, :nsub].astype(np.int64)  # includes a0 = 0
    return (anch[:, :, None] < i[None, None, :]).sum(1)  # [count, 16]


@lru_cache(maxsize=None)
def fam_bc7_anchors_before_packed(fam_name: str) -> np.ndarray:
    """uint32 [count]: fam_bc7_anchors_before packed 2 bits per texel."""
    ab = fam_bc7_anchors_before(fam_name)
    assert (ab <= 3).all()
    packed = np.zeros(ab.shape[0], np.uint32)
    for t in range(16):
        packed |= ab[:, t].astype(np.uint32) << (2 * t)
    return packed


@lru_cache(maxsize=None)
def fam_bc7_inv_relpos_packed(fam_name: str, weight_bits: int) -> np.ndarray:
    """uint32 [count]: per-pattern (rel_bitpos | valid<<7) bytes, one per BC7
    subset k >= 1, locating the single stored weight bit that drives the
    reference's anchor-MSB endpoint swap + weight inversion (bc7.rs:171-195).

    rel_bitpos (relative to the mode's weight-section start) is the raw MSB
    of BC7 anchor texel a's stored field: weight_bits*a - anchors_before(a)
    + weight_bits - 1.  Every weight remap used by a multi-subset mode
    preserves the MSB (w >= 2^(wb-1) <=> remap(w) >= 2^(wb7-1), pinned by
    test_tables::test_remap_preserves_msb), so the raw stored bit IS the BC7
    MSB - one dynamic 1-bit lane read replaces a 16-way dynamic select over
    the decoded weights.  valid = 0 when the BC7 anchor coincides with a
    UASTC anchor: its field is stored with one less bit, so its full-width
    MSB is statically zero (the batch-proven anchor-MSB lemma) and the byte's
    rel points at the next field's bit, which the valid mask discards."""
    fam = _families()[fam_name]
    ab = fam_anchors_before(fam_name)
    nsub = {"2": 2, "3": 3, "23": 3, "m1": 2}[fam_name]
    out = np.zeros(fam.count, np.uint32)
    for p in range(fam.count):
        uanch = {int(x) for x in fam.anchors[p]}
        for k in range(1, nsub):
            a = int(fam.bc7_anchors[p][k])
            rel = weight_bits * a - int(ab[p, a]) + weight_bits - 1
            assert 0 <= rel < 64
            valid = 0 if a in uanch else 1
            out[p] |= np.uint32(rel | (valid << 7)) << (8 * (k - 1))
    return out


@lru_cache(maxsize=None)
def fam_bc7_weight_preshift_packed(fam_name: str) -> np.ndarray:
    """uint32 [count]: per-texel BC7 weight-emission pre-shift
    (max-anchors-before-over-patterns minus anchors-before), packed 2 bits
    per texel - the shift that places a weight inside its static emission
    window directly, saving the per-texel subtraction."""
    ab = fam_bc7_anchors_before(fam_name)
    ps = ab.max(axis=0, keepdims=True) - ab
    assert (ps <= 3).all() and (ps >= 0).all()
    packed = np.zeros(ab.shape[0], np.uint32)
    for t in range(16):
        packed |= ps[:, t].astype(np.uint32) << (2 * t)
    return packed


@lru_cache(maxsize=None)
def etc_bias_deltas() -> np.ndarray:
    """[32 bias, 2 subblock, 3 channel] int8 ETC1 bias nudges
    (reference: src/target_formats/etc.rs:203-234)."""
    d = np.zeros((32, 2, 3), np.int8)
    s_divs = (1, 3, 9)
    for bias in range(32):
        for sb in range(2):
            for c in range(3):
                special = {
                    2: 0 if sb else (-1 if c == 0 else 0),
                    5: 0 if sb else (-1 if c == 1 else 0),
                    6: 0 if sb else (-1 if c == 2 else 0),
                    7: 0 if sb else (1 if c == 0 else 0),
                    11: 0 if sb else (1 if c == 1 else 0),
                    15: 0 if sb else (1 if c == 2 else 0),
                    18: (-1 if c == 0 else 0) if sb else 0,
                    19: (-1 if c == 1 else 0) if sb else 0,
                    20: (-1 if c == 2 else 0) if sb else 0,
                    21: (1 if c == 0 else 0) if sb else 0,
                    24: (1 if c == 1 else 0) if sb else 0,
                    8: (1 if c == 2 else 0) if sb else 0,
                    10: -2,
                    27: 0 if sb else -1,
                    28: -1 if sb else 1,
                    29: 1 if sb else 0,
                    30: -1 if sb else 0,
                    31: 0 if sb else 1,
                }
                d[bias, sb, c] = special.get(bias, ((bias // s_divs[c]) % 3) - 1)
    return d


@lru_cache(maxsize=None)
def np_tables() -> dict:
    """All shared numpy constant arrays, keyed by name."""
    etc2_mod = np.asarray(G.ETC2_ALPHA_MODIFIERS, np.int32)
    mod_min = etc2_mod[:, 3].astype(np.float32)
    mod_range = (etc2_mod[:, 7] - etc2_mod[:, 3]).astype(np.float32)
    return {
        "MODE_LUT": np.asarray(G.MODE_LUT, np.uint8),
        "ASTC_QUINT_ENCODE": np.asarray(G.ASTC_QUINT_ENCODE_LUT, np.uint8),
        "ASTC_TRIT_ENCODE": np.asarray(G.ASTC_TRIT_ENCODE_LUT, np.uint8),
        "UASTC_TO_ASTC_BLOCK_MODE_13": np.asarray(G.UASTC_TO_ASTC_BLOCK_MODE_13, np.uint16),
        "UASTC_TO_BC7_MODES": np.asarray(G.UASTC_TO_BC7_MODES, np.uint8),
        "ETC1_MODIFIERS": np.asarray(G.ETC1_MODIFIERS, np.int32),
        "ETC2_ALPHA_MODIFIERS": etc2_mod,
        # fl(-mod_min / range) per EAC table row (etc.rs:305), IEEE f32.
        "ETC2_ALPHA_FRACTION": (-mod_min / mod_range).astype(np.float32),
        "SELECTOR_ID_TO_ETC1": np.array([0b11, 0b10, 0b00, 0b01], np.uint8),
        "ETC_BIAS_DELTAS": etc_bias_deltas(),
    }
