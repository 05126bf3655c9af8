"""ETC1S device back-end (ops/etc1s) against the plain per-block reference
(tests/etc1s_reference.py): the codebook-table kernels, bucket padding of
codebooks and index streams, the fused RGB + alpha pairing, and the sharded
form of the pairing."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from basisu_rs_jax.ops.etc1s import (
    KERNELS,
    etc1s_etc1_kernel,
    run_etc1s_etc1,
    run_etc1s_rgba,
    selector_wire_words_np,
)
from etc1s_reference import alpha_reference, rgba_alpha_reference, rgba_reference


def _setup(e=200, s=150, n=1000, seed=5):
    rng = np.random.default_rng(seed)
    endpoints = np.zeros((e, 4), np.uint8)
    endpoints[:, :3] = rng.integers(0, 32, (e, 3))
    endpoints[:, 3] = rng.integers(0, 8, e)
    selectors = rng.integers(0, 256, (s, 4)).astype(np.uint8)
    ep_idx = rng.integers(0, e, n).astype(np.uint16)
    sel_idx = rng.integers(0, s, n).astype(np.uint16)
    return endpoints, selectors, ep_idx, sel_idx


def _plain(fn, endpoints, table, ep_idx, sel_idx):
    return np.asarray(
        fn(
            jnp.asarray(endpoints), jnp.asarray(table),
            jnp.asarray(ep_idx.astype(np.int32)), jnp.asarray(sel_idx.astype(np.int32)),
        )
    )


def _composed(endpoints, selectors, ep_idx, sel_idx, a_ep, a_sel):
    return np.asarray(rgba_alpha_reference(endpoints, selectors, ep_idx, sel_idx, a_ep, a_sel))


_REFERENCES = {"rgba": rgba_reference, "alpha": alpha_reference}


@pytest.mark.parametrize("n", [1, 17, 1000])
@pytest.mark.parametrize("kind", ["rgba", "alpha"])
def test_table_kernel_matches_per_block_reference(kind, n):
    """Palette tables per codebook entry + one gather per texel equal the
    per-block palette build and 4-way select, for every selector level and
    intensity (codebooks of 200 / 150 random entries)."""
    endpoints, selectors, ep_idx, sel_idx = _setup(n=n, seed=20 + n)
    got = _plain(jax.jit(KERNELS[kind][0]), endpoints, selectors, ep_idx, sel_idx)
    want = np.asarray(_REFERENCES[kind](endpoints, selectors, ep_idx, sel_idx))
    np.testing.assert_array_equal(got, want)


def test_table_kernels_cover_every_level_and_intensity():
    """Every (intensity, base colour corner, selector level) combination:
    endpoint entries at the clamp edges, selector rows holding each level
    at each texel."""
    endpoints = np.array([[r, g, b, i] for i in range(8) for r, g, b in
                          ((0, 0, 0), (31, 31, 31), (0, 31, 15), (16, 1, 30))], np.uint8)
    selectors = np.array([[v * 0x55] * 4 for v in range(4)] + [[0x1B, 0xE4, 0x4E, 0xB1]], np.uint8)
    ep_idx, sel_idx = np.meshgrid(np.arange(len(endpoints)), np.arange(len(selectors)))
    ep_idx, sel_idx = ep_idx.reshape(-1), sel_idx.reshape(-1)
    for kind, ref in _REFERENCES.items():
        got = _plain(KERNELS[kind][0], endpoints, selectors, ep_idx, sel_idx)
        np.testing.assert_array_equal(got, np.asarray(ref(endpoints, selectors, ep_idx, sel_idx)))


@pytest.mark.parametrize("n", [1, 1000, 1024])
def test_run_etc1s_rgba_padding_matches_plain_kernel(n):
    """Codebooks (200 / 150 entries) and index streams pad to power-of-two
    buckets; the padded rows never leak into the result."""
    endpoints, selectors, ep_idx, sel_idx = _setup(n=n)
    got = run_etc1s_rgba(endpoints, selectors, ep_idx, sel_idx)
    assert got.shape == (n, 16)
    np.testing.assert_array_equal(got, np.asarray(rgba_reference(endpoints, selectors, ep_idx, sel_idx)))


def test_run_etc1s_etc1_matches_plain_kernel():
    endpoints, selectors, ep_idx, sel_idx = _setup(seed=7)
    wire = selector_wire_words_np(selectors)
    got = run_etc1s_etc1(endpoints, selectors, ep_idx, sel_idx)
    np.testing.assert_array_equal(got, _plain(etc1s_etc1_kernel, endpoints, wire, ep_idx, sel_idx))


def test_run_etc1s_rgba_alpha_fused_matches_composed():
    """The alpha-paired entry (one jit over both slices) equals rgba +
    alpha + merge bit-exactly, on the host and as a device array."""
    endpoints, selectors, ep_idx, sel_idx = _setup(seed=8)
    _, _, a_ep, a_sel = _setup(seed=9)
    ref = _composed(endpoints, selectors, ep_idx, sel_idx, a_ep, a_sel)
    got = run_etc1s_rgba(endpoints, selectors, ep_idx, sel_idx, (a_ep, a_sel))
    np.testing.assert_array_equal(got, ref)
    dev = run_etc1s_rgba(endpoints, selectors, ep_idx, sel_idx, (a_ep, a_sel), device=True)
    assert isinstance(dev, jax.Array)
    np.testing.assert_array_equal(np.asarray(dev), ref)


def test_sharded_etc1s_rgba_alpha_matches_composed():
    """kind='rgba_alpha' through the mesh (N not divisible by the mesh)
    equals the composed single-device result."""
    from basisu_rs_jax.parallel.mesh import make_mesh, sharded_etc1s_transcode

    endpoints, selectors, ep_idx, sel_idx = _setup(seed=10, n=700)
    _, _, a_ep, a_sel = _setup(seed=11, n=700)
    ref = _composed(endpoints, selectors, ep_idx, sel_idx, a_ep, a_sel)
    got = sharded_etc1s_transcode(
        "rgba_alpha", endpoints, selectors, ep_idx, sel_idx, make_mesh(8),
        extra_idx=(a_ep, a_sel),
    )
    np.testing.assert_array_equal(got, ref)
