"""Vectorized bit-field access over batches of 128-bit blocks.

A batch of N blocks is a `uint32[N, W]` tensor of little-endian words (W=4 for
16-byte blocks, W=2 for 8-byte ETC1 blocks).  These helpers replace the
reference's sequential bit reader/writers (src/bitreader.rs, src/bitwriter.rs)
with branchless lane arithmetic: *static* offsets (known at trace time, the
common case once kernels are specialized per UASTC mode) compile to plain
shifts, while *dynamic* offsets (pattern-dependent weight positions) use a
4-way word select + funnel shift.

Semantics match the reference bit-exactly:
  - reads past the end of the block return zero bits (bitreader.rs:45,55)
  - writes past the end are dropped (bitwriter.rs:34)
"""

from __future__ import annotations

import jax.numpy as jnp

U32 = jnp.uint32


def mask(count: int) -> int:
    return (1 << count) - 1


def lane_shape(lanes):
    """Batch shape of a `uint32[..., W]` lane bundle."""
    return lanes.shape[:-1]


def lane_count(lanes) -> int:
    return lanes.shape[-1]


def lane(lanes, w: int):
    return lanes[..., w]


def lanes_from_bytes_np(blocks_u8, word_count: int):
    """numpy uint8 [N, word_count*4] -> uint32 [N, word_count] (host helper)."""
    import numpy as np

    b = np.asarray(blocks_u8, np.uint8).reshape(-1, word_count, 4).astype(np.uint32)
    return (b[..., 0] | (b[..., 1] << 8) | (b[..., 2] << 16) | (b[..., 3] << 24)).astype(np.uint32)


def bytes_from_lanes_np(lanes):
    """numpy uint32 [N, W] -> uint8 [N, W*4] (host helper)."""
    import numpy as np

    lanes = np.asarray(lanes, np.uint32)
    out = np.empty(lanes.shape + (4,), np.uint8)
    for k in range(4):
        out[..., k] = (lanes >> (8 * k)) & 0xFF
    return out.reshape(lanes.shape[0], 4 * lanes.shape[1])


def extract(lanes, offset: int, count: int):
    """Static-offset extract of `count` bits at `offset` from uint32[..., W]
    lanes."""
    assert 0 <= count <= 32
    if count == 0:
        return jnp.zeros(lane_shape(lanes), U32)
    W = lane_count(lanes)
    w, b = offset // 32, offset % 32
    lo = lane(lanes, w) if w < W else jnp.zeros(lane_shape(lanes), U32)
    val = lo >> U32(b)
    if b + count > 32 and w + 1 < W:
        val = val | (lane(lanes, w + 1) << U32(32 - b))
    if count < 32:
        val = val & U32(mask(count))
    return val


def extract_dyn(lanes, offset, count: int, bit_range=None):
    """Dynamic-offset extract: `offset` is a traced int32/uint32 array
    broadcastable to the lane batch shape. `count` static, <= 32.

    bit_range=(lo, hi): static bounds on the offset value (hi exclusive of
    the last read bit).  Anchor-induced offset variation is only a few bits,
    so the touched words are usually 1-2 of the 4 - the hint prunes the
    word-select chain accordingly."""
    assert 0 < count <= 32
    W = lane_count(lanes)
    if bit_range is not None:
        wlo = max(bit_range[0] // 32, 0)
        whi = min((bit_range[1] + count - 1) // 32, W - 1)
    else:
        wlo, whi = 0, W - 1
    offset = offset.astype(U32)
    w = offset >> U32(5)
    b = offset & U32(31)
    zero = jnp.zeros(jnp.broadcast_shapes(lane_shape(lanes), w.shape), U32)
    if wlo == whi:
        lo = lane(lanes, wlo)
        hi = lane(lanes, wlo + 1) if wlo + 1 < W else zero
    else:
        lo = zero
        hi = zero
        for k in range(wlo, min(whi + 1, W)):
            lk = lane(lanes, k)
            lo = jnp.where(w == k, lk, lo)
        for k in range(wlo + 1, min(whi + 2, W)):
            hi = jnp.where(w == k - 1, lane(lanes, k), hi)
    val = (lo >> b) | jnp.where(b == 0, U32(0), hi << ((U32(32) - b) & U32(31)))
    if count < 32:
        val = val & U32(mask(count))
    return val


def extract_bit_dyn(lanes, offset, bit_range):
    """Single dynamic bit as uint32 0/1.  A 1-bit read never straddles a
    word, so the funnel half of extract_dyn drops away: word-select within
    the static bit_range, one variable shift, one AND."""
    wlo, whi = bit_range[0] // 32, (bit_range[1] - 1) // 32
    offset = offset.astype(U32)
    v = lane(lanes, wlo)
    if whi > wlo:
        w = offset >> U32(5)
        for k in range(wlo + 1, whi + 1):
            v = jnp.where(w == k, lane(lanes, k), v)
    return (v >> (offset & U32(31))) & U32(1)


class LaneWriter:
    """OR-accumulates bit fields into W uint32 output lanes.

    Mirrors BitWriterLsb semantics; `rev` deposits mirror BitWriterMsbRevBytes'
    `write_u*_rev_bits` (astc.rs weight emission): the value's low `count` bits
    are bit-reversed and the field placed at [end - count, end) growing
    downward from `end`.
    """

    def __init__(self, shape, word_count: int):
        self.W = word_count
        self.shape = shape
        # lanes materialize lazily: the first deposit into a word IS the
        # word (no OR against an initial zeros plane), and constant bits
        # accumulate in a Python int per word (put_const), folded in with
        # ONE scalar OR per touched word when .lanes is read.
        self._lanes = [None] * word_count
        self._const = [0] * word_count

    @property
    def lanes(self):
        out = []
        for l, c in zip(self._lanes, self._const):
            if l is None:
                out.append(
                    jnp.full(self.shape, c, U32) if c else jnp.zeros(self.shape, U32)
                )
            else:
                out.append(l | U32(c) if c else l)
        return out

    def _or(self, w: int, expr) -> None:
        self._lanes[w] = expr if self._lanes[w] is None else self._lanes[w] | expr

    # -- static offset ------------------------------------------------------
    def put(self, value, offset: int, count: int) -> None:
        if count == 0:
            return
        assert count <= 32
        value = value.astype(U32) & U32(mask(count)) if count < 32 else value.astype(U32)
        w, b = offset // 32, offset % 32
        if w < self.W:
            self._or(w, value << U32(b))
        if b + count > 32 and w + 1 < self.W:
            self._or(w + 1, value >> U32(32 - b))

    def put_const(self, value: int, offset: int, count: int) -> None:
        """Static bits at a static offset: zero traced ops per call - the
        bits land in the per-word Python accumulator (mode/markers/constant
        weights used to cost a jnp.full + shift + OR each)."""
        if count == 0:
            return
        assert count <= 32
        value &= mask(count) if count < 32 else 0xFFFFFFFF
        w, b = offset // 32, offset % 32
        if w < self.W:
            self._const[w] |= (value << b) & 0xFFFFFFFF
        if b + count > 32 and w + 1 < self.W:
            self._const[w + 1] |= value >> (32 - b)

    # -- dynamic offset -----------------------------------------------------
    def put_dyn(self, value, offset, count: int, bit_range=None) -> None:
        """bit_range=(lo, hi): static bounds on `offset` (see extract_dyn)."""
        assert 0 < count <= 32
        if bit_range is not None:
            wlo = max(bit_range[0] // 32, 0)
            whi = min((bit_range[1] + count - 1) // 32, self.W - 1)
        else:
            wlo, whi = 0, self.W - 1
        value = value.astype(U32) & U32(mask(count)) if count < 32 else value.astype(U32)
        offset = offset.astype(U32)
        w = offset >> U32(5)
        b = offset & U32(31)
        lo = value << b
        hi = jnp.where(b == 0, U32(0), value >> ((U32(32) - b) & U32(31)))
        if wlo == whi:
            self._or(wlo, lo)
            if wlo + 1 < self.W:
                self._or(wlo + 1, hi)
            return
        for k in range(wlo, min(whi + 1, self.W)):
            self._or(k, jnp.where(w == k, lo, U32(0)))
        for k in range(wlo + 1, min(whi + 2, self.W)):
            self._or(k, jnp.where(w == k - 1, hi, U32(0)))

    def stack(self):
        return jnp.stack(self.lanes, axis=-1)


def bitrev(value, count: int):
    """Reverse the low `count` bits of `value` (count static, <= 8).
    High bits of `value` are ignored.  Closed per-count forms: the generic
    per-bit loop costs 4 ops/bit, which dominated ASTC weight emission
    (16-32 reversals per block)."""
    v = value
    if count == 1:
        return v & U32(1)
    if count == 2:
        return ((v & U32(1)) << U32(1)) | ((v >> U32(1)) & U32(1))
    if count == 3:
        return ((v & U32(1)) << U32(2)) | (v & U32(2)) | ((v >> U32(2)) & U32(1))
    if count == 4:
        return (
            ((v & U32(1)) << U32(3))
            | ((v & U32(2)) << U32(1))
            | ((v >> U32(1)) & U32(2))
            | ((v >> U32(3)) & U32(1))
        )
    if count == 5:
        return (
            ((v & U32(1)) << U32(4))
            | ((v & U32(2)) << U32(2))
            | (v & U32(4))
            | ((v >> U32(2)) & U32(2))
            | ((v >> U32(4)) & U32(1))
        )
    out = jnp.zeros_like(value)
    for i in range(count):
        out = out | (((value >> U32(i)) & U32(1)) << U32(count - 1 - i))
    return out


def lut_lookup(table_np, idx):
    """table_np: small constant 1-D numpy array; idx: traced integer array.
    Returns int32 (integer tables) or float32 values.  XLA folds the table
    into the module as a constant and fuses the gather into the kernel."""
    import numpy as np

    a = np.ascontiguousarray(table_np)
    if a.dtype != np.float32:
        a = a.astype(np.int64).astype(np.int32)  # preserves low 32 bits
    return jnp.take(jnp.asarray(a), idx.astype(jnp.int32), axis=0)
