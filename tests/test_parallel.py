"""Multi-chip sharding: the sharded transcode paths on a virtual 8-device CPU
mesh must agree bit-for-bit with the single-device path."""

import numpy as np

import jax
import pytest

from basisu_rs_jax.ops import transcode_blocks
from basisu_rs_jax.ops.bits import bytes_from_lanes_np, lanes_from_bytes_np
from basisu_rs_jax.parallel.mesh import (
    make_mesh,
    shard_blocks,
    sharded_mode_step,
    sharded_transcode,
    sharded_transcode_step,
)


def test_sharded_step_matches_single_device(golden):
    assert len(jax.devices()) == 8, "conftest should provide 8 virtual CPU devices"
    mesh = make_mesh(8)
    step = sharded_transcode_step("bc7", mesh)

    blocks = golden["bc7_in"][:256]
    lanes = lanes_from_bytes_np(blocks, 4)
    out, err_count = step(shard_blocks(lanes, mesh))
    assert int(err_count) == 0

    expected, err = transcode_blocks(blocks, "bc7")
    assert not err.any()
    got = bytes_from_lanes_np(np.asarray(out)[: len(blocks)])
    np.testing.assert_array_equal(got, expected)


@pytest.mark.parametrize("target", ["bc7", "rgba", "astc", "etc1", "etc2"])
def test_sharded_mode_transcode_matches_single_device(golden, target):
    """Production path: per-mode kernels inside shard_map, bit-parity with the
    single-device partitioned path over the full golden mode mix."""
    mesh = make_mesh(8)
    blocks = golden[f"{target}_in"]
    out, err = sharded_transcode(blocks, target, mesh)
    assert not err.any()
    expected, err1 = transcode_blocks(blocks, target)
    assert not err1.any()
    np.testing.assert_array_equal(out, expected)


def test_sharded_mode_transcode_flags_invalid_blocks(golden):
    mesh = make_mesh(8)
    blocks = golden["rgba_in"][:64].copy()
    blocks[5, 0] = 69  # MODE_LUT entry 19 -> invalid mode
    out, err = sharded_transcode(blocks, "rgba", mesh)
    assert err.sum() == 1 and err[5]


def test_sharded_mode_step_matches_golden_and_counts_errors(golden):
    """One mode's sharded step: per-shard outputs equal the golden corpus,
    error flags stay per block, and the psum'd count sees every shard."""
    from basisu_rs_jax.ops.dispatch import block_modes

    mesh = make_mesh(8)
    idx = np.nonzero(block_modes(golden["bc7_in"]) == 2)[0]
    blocks = golden["bc7_in"][idx].copy()  # 32 blocks, 4 per shard
    # mode-2 pattern index >= 30 is invalid (uastc.rs:364): break the last
    # block of two different shards
    from basisu_rs_jax.tables import MODES

    ofs = MODES[2].field_offsets["pattern"]
    for b in (3, 31):
        for bit in range(ofs, ofs + 5):
            blocks[b, bit // 8] |= 1 << (bit % 8)
    out, err, total = sharded_mode_step("bc7", 2, mesh)(
        shard_blocks(lanes_from_bytes_np(blocks, 4), mesh)
    )
    err = np.asarray(err)
    assert err[3] and err[31] and int(total) == int(err.sum()) == 2
    ok = ~err
    np.testing.assert_array_equal(
        bytes_from_lanes_np(np.asarray(out))[ok], golden["bc7_out"][idx][ok]
    )


def test_sharded_step_counts_errors(golden):
    mesh = make_mesh(8)
    step = sharded_transcode_step("rgba", mesh)
    blocks = golden["rgba_in"][:64].copy()
    blocks[3, 0] = 69  # MODE_LUT entry 19 -> invalid mode
    blocks[10, 0] = 69
    lanes = lanes_from_bytes_np(blocks, 4)
    _, err_count = step(shard_blocks(lanes, mesh))
    assert int(err_count) == 2


# ---------------------------------------------------------------------------
# ETC1S sharding: replicated codebooks, sharded index streams
# ---------------------------------------------------------------------------


def _random_etc1s_inputs(seed, n=1000, n_endpoints=37, n_selectors=53):
    rng = np.random.default_rng(seed)
    endpoints = np.stack(
        [
            rng.integers(0, 32, n_endpoints, dtype=np.uint8),
            rng.integers(0, 32, n_endpoints, dtype=np.uint8),
            rng.integers(0, 32, n_endpoints, dtype=np.uint8),
            rng.integers(0, 8, n_endpoints, dtype=np.uint8),
        ],
        axis=-1,
    )
    selectors = rng.integers(0, 256, (n_selectors, 4), dtype=np.uint8)
    ep_idx = rng.integers(0, n_endpoints, n, dtype=np.int32)
    sel_idx = rng.integers(0, n_selectors, n, dtype=np.int32)
    return endpoints, selectors, ep_idx, sel_idx


@pytest.mark.parametrize("kind", ["rgba", "alpha", "etc1"])
def test_sharded_etc1s_matches_single_device(kind):
    """The mesh path (codebooks replicated, indices sharded over 8 devices,
    N not divisible by the mesh) agrees bit-exactly with the single-device
    per-block reference (the ETC1 kernel for 'etc1')."""
    import jax.numpy as jnp

    from basisu_rs_jax.ops import etc1s as E
    from basisu_rs_jax.parallel.mesh import sharded_etc1s_transcode

    endpoints, selectors, ep_idx, sel_idx = _random_etc1s_inputs(0xE7C15 + len(kind))
    mesh = make_mesh(8)
    got = sharded_etc1s_transcode(kind, endpoints, selectors, ep_idx, sel_idx, mesh)

    if kind == "etc1":
        expected = E.etc1s_etc1_kernel(
            jnp.asarray(endpoints), jnp.asarray(E.selector_wire_words_np(selectors)),
            jnp.asarray(ep_idx), jnp.asarray(sel_idx),
        )
    else:
        from etc1s_reference import alpha_reference, rgba_reference

        ref = rgba_reference if kind == "rgba" else alpha_reference
        expected = ref(endpoints, selectors, ep_idx, sel_idx)
    expected = np.asarray(expected)
    np.testing.assert_array_equal(got, expected)


def test_make_mesh_refuses_silent_cpu_fallback(monkeypatch):
    """make_mesh must never silently downgrade to virtual CPU devices when
    the default backend is short of chips: raise unless the caller opts in
    with allow_cpu_fallback=True, and warn loudly even then."""
    import basisu_rs_jax.parallel.mesh as mesh_mod

    real_devices = jax.devices
    cpu = real_devices("cpu")

    def fake(platform=None):
        # Simulate a 1-chip default backend next to the 8-device CPU host.
        return real_devices("cpu") if platform else cpu[:1]

    monkeypatch.setattr(mesh_mod.jax, "devices", fake)
    with pytest.raises(ValueError, match="allow_cpu_fallback"):
        make_mesh(8)
    with pytest.warns(UserWarning, match="virtual CPU"):
        m = make_mesh(8, allow_cpu_fallback=True)
    assert m.devices.size == 8


def test_make_mesh_raises_when_no_backend_has_enough_devices():
    with pytest.raises(ValueError):
        make_mesh(64, allow_cpu_fallback=True)
