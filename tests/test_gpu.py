"""Bit parity on an attached NVIDIA GPU.

Every test here takes the `gpu` fixture (tests/conftest.py), which skips it
unless JAX's default device is a GPU.  On a machine with the card:

    JAX_PLATFORMS=cuda python -m pytest -m gpu tests/

chip_smoke.py runs them in its last phase.
"""

import numpy as np
import pytest

pytestmark = pytest.mark.gpu

TARGETS = ("bc7", "rgba", "astc", "etc1", "etc2")


def test_default_device_is_gpu(gpu):
    assert gpu.platform == "gpu"


@pytest.mark.parametrize("target", TARGETS)
def test_mode_kernels_match_golden_on_gpu(gpu, golden, target):
    """All 19 per-mode kernels of one target, compiled for the card."""
    from basisu_rs_jax.ops.bits import bytes_from_lanes_np, lanes_from_bytes_np
    from basisu_rs_jax.ops.dispatch import _bucket, _mode_kernel, block_modes

    blocks = golden[f"{target}_in"]
    expected = golden[f"{target}_out"]
    modes = block_modes(blocks)
    for mode in range(19):
        idx = np.nonzero(modes == mode)[0]
        lanes = np.zeros((_bucket(len(idx)), 4), np.uint32)
        lanes[: len(idx)] = lanes_from_bytes_np(blocks[idx], 4)
        out, err = _mode_kernel(target, mode)(lanes)
        assert not np.asarray(err)[: len(idx)].any(), f"mode {mode}"
        out = np.asarray(out)[: len(idx)]
        got = out if target == "rgba" else bytes_from_lanes_np(out)
        np.testing.assert_array_equal(got, expected[idx], err_msg=f"mode {mode}")


def _etc1s_inputs(seed, e=16128, s=16128, n=50_000):
    rng = np.random.default_rng(seed)
    endpoints = np.zeros((e, 4), np.uint8)
    endpoints[:, :3] = rng.integers(0, 32, (e, 3))
    endpoints[:, 3] = rng.integers(0, 8, e)
    selectors = rng.integers(0, 256, (s, 4)).astype(np.uint8)
    idx = [rng.integers(0, m, n) for m in (e, s, e, s)]
    return endpoints, selectors, idx


def test_etc1s_kinds_and_fused_pairing_on_gpu(gpu):
    """run_etc1s_rgba (plain and alpha-paired) and run_etc1s_etc1 on the
    card equal the same calls on the host CPU backend."""
    import jax

    from basisu_rs_jax.ops.etc1s import run_etc1s_etc1, run_etc1s_rgba

    endpoints, selectors, (ep, sel, a_ep, a_sel) = _etc1s_inputs(3)
    calls = (
        lambda: run_etc1s_rgba(endpoints, selectors, ep, sel),
        lambda: run_etc1s_rgba(endpoints, selectors, ep, sel, (a_ep, a_sel)),
        lambda: run_etc1s_etc1(endpoints, selectors, ep, sel),
    )
    on_gpu = [c() for c in calls]
    with jax.default_device(jax.devices("cpu")[0]):
        on_cpu = [c() for c in calls]
    for g, c in zip(on_gpu, on_cpu):
        np.testing.assert_array_equal(g, c)


def test_etc1s_table_kernels_match_per_block_reference_on_gpu(gpu):
    """The codebook-table kernels against the per-block palette reference,
    both compiled for the card, at codebooks of 16,128 entries."""
    import jax

    from basisu_rs_jax.ops.etc1s import KERNELS
    from etc1s_reference import alpha_reference, rgba_alpha_reference, rgba_reference

    endpoints, selectors, idx = _etc1s_inputs(5)
    for kind, ref in (("rgba", rgba_reference), ("alpha", alpha_reference),
                      ("rgba_alpha", rgba_alpha_reference)):
        args = (endpoints, selectors, *idx[: 4 if kind == "rgba_alpha" else 2])
        np.testing.assert_array_equal(
            np.asarray(jax.jit(KERNELS[kind][0])(*args)), np.asarray(jax.jit(ref)(*args)),
            err_msg=kind,
        )


def test_sharded_paths_on_gpu(gpu, golden):
    """The sharded UASTC and ETC1S paths over every attached card equal the
    single-device path."""
    from basisu_rs_jax.ops import transcode_blocks
    from basisu_rs_jax.ops.etc1s import run_etc1s_rgba
    from basisu_rs_jax.parallel.mesh import make_mesh, sharded_etc1s_transcode, sharded_transcode

    mesh = make_mesh()
    out, err = sharded_transcode(golden["bc7_in"], "bc7", mesh)
    assert not err.any()
    np.testing.assert_array_equal(out, golden["bc7_out"])
    endpoints, selectors, (ep, sel, a_ep, a_sel) = _etc1s_inputs(4)
    got = sharded_etc1s_transcode(
        "rgba_alpha", endpoints, selectors, ep, sel, mesh, extra_idx=(a_ep, a_sel)
    )
    np.testing.assert_array_equal(got, run_etc1s_rgba(endpoints, selectors, ep, sel, (a_ep, a_sel)))


def test_f32_sites_exact_on_gpu(gpu):
    """The two f32 computations left on the device, under whatever FMA
    contraction the GPU compiler applies: the shared p-bit search against
    its LUT reimplementation, and the EAC centre over all inputs."""
    import test_fma
    import test_pbits

    test_pbits.test_determine_shared_pbits_matches_lut_reimplementation()
    test_fma.test_eac_centre_jit_matches_host()
