"""The BC7 shared-p-bit search (ops/bc7.determine_shared_pbits) against a
direct LUT transcription of the reference (bc7.rs:408-475): decisions and
quantized endpoints over exhaustive per-channel inputs, on the test
backend.  The unique-p-bit integerization is pinned in test_tables.py; why
the shared terms are gathered rather than computed is in test_fma.py.
"""

import jax
import jax.numpy as jnp
import numpy as np

from basisu_rs_jax.tables.bc7_tables import pbit_luts

F32 = np.float32


def test_determine_shared_pbits_matches_lut_reimplementation():
    """Exhaustive per-channel sweep: all (lo, hi) byte pairs through the
    3-channel search with the other channels held at adversarial values,
    against a LUT-fold reimplementation of the reference search."""
    from basisu_rs_jax.ops.bc7 import determine_shared_pbits

    rng = np.random.default_rng(7)
    n = 4096
    e_lo = [jnp.asarray(rng.integers(0, 256, (1, n)), jnp.int32) for _ in range(3)]
    e_hi = [jnp.asarray(rng.integers(0, 256, (1, n)), jnp.int32) for _ in range(3)]

    lo_q, hi_q, p0, p1 = jax.jit(
        lambda a, b: determine_shared_pbits(3, 6, list(a), list(b))
    )(e_lo, e_hi)

    xq, _, err_s = pbit_luts(7)
    el = [np.asarray(c).reshape(-1) for c in e_lo]
    eh = [np.asarray(c).reshape(-1) for c in e_hi]
    err = {}
    for p in (0, 1):
        acc = np.zeros(n, F32)
        for c in range(3):
            acc = (acc + (err_s[p][el[c]] + err_s[p][eh[c]]).astype(F32)).astype(F32)
        err[p] = acc
    sb = (err[1] < err[0]).astype(np.int32)
    np.testing.assert_array_equal(np.asarray(p0).reshape(-1), sb)
    np.testing.assert_array_equal(np.asarray(p1).reshape(-1), sb)
    for c in range(3):
        np.testing.assert_array_equal(
            np.asarray(lo_q[c]).reshape(-1), xq[:, el[c]][sb, np.arange(n)]
        )
        np.testing.assert_array_equal(
            np.asarray(hi_q[c]).reshape(-1), xq[:, eh[c]][sb, np.arange(n)]
        )
