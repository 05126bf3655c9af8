"""Huffman + host bit-I/O tests: encoder/decoder round trips, canonical code
assignment, error paths (mirroring the reference's validation behavior)."""

import numpy as np
import pytest

from basisu_rs_jax.container.huffman import (
    HuffmanDecodingTable,
    HuffmanError,
    read_huffman_table,
)
from basisu_rs_jax.container.writer import CanonicalEncoder, equal_length_sizes, write_huffman_table
from basisu_rs_jax.utils.bitio import BitReaderLsb, BitWriterLsb


def random_code_sizes(rng, n_syms: int) -> list[int]:
    """Generate a Kraft-complete code-length assignment via Huffman building."""
    freqs = rng.integers(1, 1000, n_syms)
    # simple Huffman: repeatedly merge two smallest
    import heapq

    heap = [(int(f), [i]) for i, f in enumerate(freqs)]
    depth = [0] * n_syms
    heapq.heapify(heap)
    while len(heap) > 1:
        fa, a = heapq.heappop(heap)
        fb, b = heapq.heappop(heap)
        for s in a + b:
            depth[s] += 1
        heapq.heappush(heap, (fa + fb, a + b))
    return [max(1, min(d, 16)) for d in depth] if n_syms > 1 else [1]


@pytest.mark.parametrize("n_syms", [1, 2, 7, 40, 300])
def test_encode_decode_round_trip(n_syms):
    rng = np.random.default_rng(n_syms)
    sizes = equal_length_sizes(n_syms)
    w = BitWriterLsb()
    enc = write_huffman_table(w, sizes)
    syms = rng.integers(0, n_syms, 200)
    for s in syms:
        enc.encode(w, int(s))
    data = w.getvalue()

    r = BitReaderLsb(data)
    table = read_huffman_table(r)
    got = [table.decode_symbol(r) for _ in range(200)]
    assert got == [int(s) for s in syms]


def test_huffman_random_tree_round_trip():
    rng = np.random.default_rng(7)
    for trial in range(5):
        n = int(rng.integers(2, 60))
        sizes = random_code_sizes(rng, n)
        table = HuffmanDecodingTable.from_sizes(sizes)
        enc = CanonicalEncoder(sizes)
        w = BitWriterLsb()
        syms = rng.integers(0, n, 64)
        for s in syms:
            enc.encode(w, int(s))
        r = BitReaderLsb(w.getvalue())
        got = [table.decode_symbol(r) for _ in range(64)]
        assert got == [int(s) for s in syms]


def test_decode_unassigned_code_errors():
    # one symbol of size 2: codes 01,10,11 are unassigned
    table = HuffmanDecodingTable.from_sizes([2])
    r = BitReaderLsb(b"\xFF")
    with pytest.raises(HuffmanError, match="No matching code"):
        table.decode_symbol(r)


def test_bit_reader_past_end_zero_bits():
    r = BitReaderLsb(b"\xFF")
    assert r.read(8) == 0xFF
    assert r.read(16) == 0  # past the end (bitreader.rs:45 semantics)


def test_bit_writer_round_trip():
    rng = np.random.default_rng(0)
    w = BitWriterLsb()
    fields = []
    for _ in range(100):
        count = int(rng.integers(1, 25))
        v = int(rng.integers(0, 1 << count))
        fields.append((count, v))
        w.write(count, v)
    r = BitReaderLsb(w.getvalue())
    for count, v in fields:
        assert r.read(count) == v


def test_pack_codes_lsb_matches_bit_writer():
    """The writer's bulk code packer emits exactly the stream a
    BitWriterLsb writing the same codes one by one holds (length-0 codes
    emit nothing)."""
    from basisu_rs_jax.container.writer import pack_codes_lsb

    rng = np.random.default_rng(3)
    sizes = rng.integers(0, 17, 5000)
    codes = rng.integers(0, 1 << 16, 5000) & ((1 << sizes) - 1)
    w = BitWriterLsb()
    for c, n in zip(codes, sizes):
        if n:
            w.write(int(n), int(c))
    assert pack_codes_lsb(codes, sizes) == w.getvalue()
    assert pack_codes_lsb(np.zeros(0), np.zeros(0)) == b""
