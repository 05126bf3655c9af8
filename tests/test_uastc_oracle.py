"""Randomized differential fuzz of the UASTC transcode kernels against the
reference-transcribed oracle (tests/oracle_uastc.py).

The committed golden corpus pins 32 blocks per mode; random blocks cover the
field combinations those 32 can't (all BISE trit/quint group remainders,
anchor-weight positions, pattern indices, compsel values, blue-contract
inversions, invalid patterns).  Reference loops being mirrored:
decode_block_to_rgba (/root/reference/src/uastc.rs:237-327) and the
per-target convert_block_from_uastc writers.
"""

import numpy as np
import pytest

from basisu_rs_jax.ops import transcode_blocks

from oracle_uastc import (
    OracleUastcError,
    convert_block_to_astc,
    convert_block_to_bc7,
    convert_block_to_etc1,
    convert_block_to_etc2,
    decode_block_to_rgba,
    mode_code_bits,
)


def _rgba_words(block: bytes) -> np.ndarray:
    texels = decode_block_to_rgba(block)
    return np.array(
        [r | (g << 8) | (b << 16) | (a << 24) for (r, g, b, a) in texels],
        np.uint32,
    )


_ORACLES = {
    "rgba": _rgba_words,
    "astc": lambda block: np.frombuffer(convert_block_to_astc(block), np.uint8),
    "etc1": lambda block: np.frombuffer(convert_block_to_etc1(block), np.uint8),
    "etc2": lambda block: np.frombuffer(convert_block_to_etc2(block), np.uint8),
    "bc7": lambda block: np.frombuffer(convert_block_to_bc7(block), np.uint8),
}


def _check_against_oracle(blocks: np.ndarray, target: str):
    out, err = transcode_blocks(blocks, target)
    oracle = _ORACLES[target]
    for i in range(len(blocks)):
        try:
            words = oracle(bytes(blocks[i]))
        except OracleUastcError as e:
            assert err[i], f"block {i}: oracle errors ({e}) but kernel did not"
            continue
        assert not err[i], f"block {i}: kernel errors but oracle decodes"
        np.testing.assert_array_equal(
            out[i], words, err_msg=f"block {i} bytes {blocks[i].tolist()}"
        )


@pytest.mark.parametrize("target", sorted(_ORACLES))
def test_uniform_random_blocks_match_oracle(target):
    """Uniform random bytes: every mode (valid and invalid) in ratio of its
    MODE_LUT share; errors must agree exactly with the oracle's Err sites."""
    rng = np.random.default_rng(0xBA515)
    blocks = rng.integers(0, 256, size=(2048, 16), dtype=np.uint8)
    _check_against_oracle(blocks, target)


@pytest.mark.parametrize("target", sorted(_ORACLES))
@pytest.mark.parametrize("mode_id", range(19))
def test_per_mode_random_blocks_match_oracle(mode_id, target):
    """Dense per-mode coverage: random payload bits under a forced mode code
    (a code whose every 7-bit extension maps to the mode)."""
    rng = np.random.default_rng(0xC0DE + mode_id)
    blocks = rng.integers(0, 256, size=(512, 16), dtype=np.uint8)
    code, code_size = mode_code_bits(mode_id)
    keep = 0xFF & ~((1 << min(code_size, 8)) - 1)
    blocks[:, 0] = (blocks[:, 0] & keep) | (code & 0xFF)
    _check_against_oracle(blocks, target)


@pytest.mark.parametrize("target", ["rgba", "bc7"])
def test_all_modes_fn_matches_partitioned_fuzz(target):
    """The single-graph all-modes path (jit entries / sharded step /
    tiny batches) agrees with the partitioned per-mode path - and hence the
    oracle - on random blocks including invalid ones."""
    import jax.numpy as jnp

    from basisu_rs_jax.ops.bits import bytes_from_lanes_np, lanes_from_bytes_np
    from basisu_rs_jax.ops.dispatch import transcode_all_modes_fn

    rng = np.random.default_rng(0xA11)
    blocks = rng.integers(0, 256, size=(512, 16), dtype=np.uint8)
    ref_out, ref_err = transcode_blocks(blocks, target)

    out, err = transcode_all_modes_fn(target)(jnp.asarray(lanes_from_bytes_np(blocks, 4)))
    out, err = np.asarray(out), np.asarray(err)
    np.testing.assert_array_equal(err, ref_err)
    ok = ~ref_err
    if target == "rgba":
        np.testing.assert_array_equal(out[ok], ref_out[ok])
    else:
        np.testing.assert_array_equal(bytes_from_lanes_np(out)[ok], ref_out[ok])
