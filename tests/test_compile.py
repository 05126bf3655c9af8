"""Trace-ability checks: every kernel for every (target, mode) pair must
trace abstractly (the build's analog of the reference's no_std compile-only
crate, SURVEY.md C25), plus a consistency fuzz on random blocks (the
per-mode kernels and the all-modes graph must agree bit-for-bit on
arbitrary, including garbage, inputs)."""

import numpy as np
import pytest

import jax
import jax.numpy as jnp

from basisu_rs_jax.ops.bits import lanes_from_bytes_np
from basisu_rs_jax.ops.dispatch import _REGISTRY, _ensure_registered, block_modes
from basisu_rs_jax.tables import MODES

TARGETS = ["rgba", "astc", "bc7", "etc1", "etc2"]


def test_all_kernels_trace():
    _ensure_registered()
    dummy = jax.ShapeDtypeStruct((64, 4), jnp.uint32)
    for target in TARGETS:
        fn, out_words = _REGISTRY[target]
        for cfg in MODES:
            words, err = jax.eval_shape(lambda l, c=cfg, f=fn: f(c, l), dummy)
            assert len(words) == out_words, (target, cfg.id)
            assert err.shape == (64,)


def test_all_modes_fn_traces():
    from basisu_rs_jax.ops.dispatch import transcode_all_modes_fn

    dummy = jax.ShapeDtypeStruct((32, 4), jnp.uint32)
    for target in TARGETS:
        out, err = jax.eval_shape(transcode_all_modes_fn(target), dummy)
        assert out.shape[0] == 32


@pytest.mark.parametrize("target", ["bc7", "etc2"])
def test_fuzz_mode_kernels_vs_all_modes_graph(target):
    """Random (often garbage) block contents: each jitted per-mode kernel
    (dispatch._mode_kernel, the shipped path) agrees with the same mode's
    rows of the all-modes graph, outputs and error flags alike."""
    from basisu_rs_jax.ops.dispatch import _mode_kernel, transcode_all_modes_fn

    rng = np.random.default_rng(123)
    blocks = rng.integers(0, 256, (64, 16), dtype=np.uint8)
    # force a spread of valid mode codes so every-ish kernel sees fuzz input
    blocks[:, 0] = rng.integers(0, 128, 64)
    modes = block_modes(blocks)
    lanes = lanes_from_bytes_np(blocks, 4)
    all_out, all_err = transcode_all_modes_fn(target)(jnp.asarray(lanes))
    for mode_id in np.unique(modes):
        if mode_id == 19:
            continue
        idx = np.nonzero(modes == mode_id)[0]
        o, e = _mode_kernel(target, int(mode_id))(jnp.asarray(lanes[idx]))
        np.testing.assert_array_equal(np.asarray(e), np.asarray(all_err)[idx])
        ok = ~np.asarray(e)
        np.testing.assert_array_equal(np.asarray(o)[ok], np.asarray(all_out)[idx][ok])


def test_etc1s_kernels_trace():
    """Every ETC1S kernel kind (incl. the fused rgba_alpha pair) traces
    abstractly with its output width."""
    from basisu_rs_jax.ops.etc1s import KERNELS

    book = jax.ShapeDtypeStruct((16, 4), jnp.uint8)
    idx = jax.ShapeDtypeStruct((64,), jnp.int32)
    for kind, (fn, out_words) in KERNELS.items():
        table = jax.ShapeDtypeStruct((16,), jnp.uint32) if kind == "etc1" else book
        n_idx = 4 if kind == "rgba_alpha" else 2
        out = jax.eval_shape(fn, book, table, *[idx] * n_idx)
        assert out.shape == (64, out_words), kind
