"""Golden parity for the FULL 5x19 (target, mode) matrix, one case per
shipped per-mode kernel (ops/dispatch._mode_kernel) at the bucketed group
size dispatch gives it, on the test backend.
tests/test_gpu.py runs the same matrix on an attached GPU.  Reference
analog: tests/transcode_uastc_block.rs:35-78 runs every mode for every
target.
"""

import numpy as np
import pytest

from basisu_rs_jax.ops.bits import bytes_from_lanes_np, lanes_from_bytes_np
from basisu_rs_jax.ops.dispatch import _bucket, _mode_kernel, block_modes

TARGETS = ("bc7", "rgba", "astc", "etc1", "etc2")
ALL_PAIRS = [(t, m) for t in TARGETS for m in range(19)]


@pytest.mark.parametrize("target,mode", ALL_PAIRS)
def test_mode_kernel_matches_golden(golden, target, mode):
    idx = np.nonzero(block_modes(golden[f"{target}_in"]) == mode)[0]
    assert len(idx) > 0, f"golden corpus has no mode-{mode} blocks"
    lanes = np.zeros((_bucket(len(idx)), 4), np.uint32)
    lanes[: len(idx)] = lanes_from_bytes_np(golden[f"{target}_in"][idx], 4)
    out, err = _mode_kernel(target, mode)(lanes)
    assert not np.asarray(err)[: len(idx)].any()
    out = np.asarray(out)[: len(idx)]
    expected = golden[f"{target}_out"][idx]
    if target == "rgba":
        np.testing.assert_array_equal(out, expected)
    else:
        np.testing.assert_array_equal(bytes_from_lanes_np(out), expected)
