"""Bit parity under FMA contraction.

A GPU compiler may contract an f32 multiply and the add that consumes it
into one fused multiply-add, rounding once instead of twice.  Every f32
multiply left on the device has to give the reference's result either way:

- the EAC centre lerp (ops/etc.eac_center): either product may fuse with
  the add; proven here, exhaustively over every (min, max, table row), that
  the rounded centre never changes;
- the BC7 shared p-bit error terms: a fused `bl*bl + bh*bh` DOES change the
  sum for some endpoint pairs, so the device gathers the whole squared term
  from the reference-transcribed table and only adds (pinned below: no f32
  multiply is left in the search).

fma32 computes the correctly rounded f32 of a*b + c on the host: the
product of two f32 values is exact in f64, TwoSum gives the exact residual
of the f64 sum, and the residual breaks f32 ties that the f64 sum hides.
"""

from fractions import Fraction

import jax
import jax.numpy as jnp
import numpy as np

from basisu_rs_jax.ops.etc import eac_center
from basisu_rs_jax.tables import np_tables
from basisu_rs_jax.tables.bc7_tables import pbit_luts

F32 = np.float32


def fma32(a, b, c):
    """Correctly rounded float32 a*b + c, elementwise (float32 arrays)."""
    p = a.astype(np.float64) * b.astype(np.float64)  # exact: 24+24 bits
    c64 = c.astype(np.float64)
    s = p + c64
    bb = s - p
    err = (p - (s - bb)) + (c64 - bb)  # TwoSum: p + c == s + err exactly
    r = s.astype(F32)
    d = s - r.astype(np.float64)
    nb = np.nextafter(r, np.where(d > 0, np.inf, -np.inf).astype(F32))
    tie = (d != 0) & (np.abs(d) == np.abs(nb.astype(np.float64) - s))
    # at an f32 tie the exact value lies on the side of the residual
    beyond = tie & (err != 0) & (np.sign(err) == np.sign(d))
    short = tie & (err != 0) & (np.sign(err) != np.sign(d))
    out = np.where(beyond, nb, r)
    return np.where(short, r, out)


def _fma32_exact(a, b, c):
    t = Fraction(float(a)) * Fraction(float(b)) + Fraction(float(c))
    r = F32(float(t))  # nearest f64, then f32: may double-round; fix below
    cands = [np.nextafter(r, F32(-np.inf)), r, np.nextafter(r, F32(np.inf))]
    dist = [abs(Fraction(float(x)) - t) for x in cands]
    best = min(dist)
    ties = [x for x, d in zip(cands, dist) if d == best]
    if len(ties) > 1:  # round half to even
        return next(x for x in ties if not (x.view(np.int32) & 1))
    return ties[0]


def test_fma32_matches_exact_rational_rounding():
    rng = np.random.default_rng(5)
    a = rng.integers(0, 256, 2000).astype(F32) * F32(1 / 3)
    b = rng.random(2000).astype(F32)
    c = (rng.random(2000) * 256).astype(F32)
    # ties: a*b lands exactly halfway between two f32 neighbours of c
    a[:4], b[:4], c[:4] = F32(1), F32(2.0**-24), F32(1)
    a[4:8], b[4:8], c[4:8] = F32(3), F32(2.0**-24), F32(1)
    got = fma32(a, b, c)
    want = np.array([_fma32_exact(x, y, z) for x, y, z in zip(a, b, c)], F32)
    np.testing.assert_array_equal(got.view(np.int32), want.view(np.int32))


def _eac_inputs():
    mn = np.repeat(np.arange(256), 256).astype(F32)
    mx = np.tile(np.arange(256), 256).astype(F32)
    return mn, mx


def test_eac_centre_is_contraction_invariant():
    """All 256 x 256 x 16 (min, max, table row) inputs: separate roundings
    and both FMA contractions give the same rounded centre."""
    mn, mx = _eac_inputs()
    centre = lambda lerp: np.trunc((lerp + F32(0.5)).astype(F32)).astype(np.int32)
    for f in np_tables()["ETC2_ALPHA_FRACTION"].astype(F32):
        fa = np.full_like(mn, f)
        oa = np.full_like(mn, (F32(1) - f).astype(F32))
        lo, hi = (mn * oa).astype(F32), (mx * fa).astype(F32)
        sep = centre((lo + hi).astype(F32))
        np.testing.assert_array_equal(centre(fma32(mn, oa, hi)), sep)
        np.testing.assert_array_equal(centre(fma32(mx, fa, lo)), sep)


def test_eac_centre_jit_matches_host():
    mn, mx = _eac_inputs()
    fracs = np_tables()["ETC2_ALPHA_FRACTION"].astype(F32)
    got = np.asarray(
        jax.jit(jax.vmap(eac_center, in_axes=(None, None, 0)))(
            jnp.asarray(mn.astype(np.int32)), jnp.asarray(mx.astype(np.int32)),
            jnp.asarray(fracs[:, None]),
        )
    )
    for k, f in enumerate(fracs):
        lerp = ((mn * (F32(1) - f)).astype(F32) + (mx * f).astype(F32)).astype(F32)
        want = np.trunc((lerp + F32(0.5)).astype(F32)).astype(np.int32)
        np.testing.assert_array_equal(got[k], want, err_msg=f"table row {k}")


def test_fused_shared_pbit_sum_would_differ():
    """Why the shared p-bit terms are gathered: with the squares computed on
    the device, contracting `bl*bl + bh*bh` changes the f32 sum for some
    (p, lo, hi) endpoint triples (BC7 mode 1 is the only shared-p-bit mode,
    total_bits 7)."""
    tb = 7
    xq, _, err_s = pbit_luts(tb)
    v = np.arange(256)
    xl = (v.astype(F32) / F32(255)).astype(F32)
    changed = 0
    for p in (0, 1):
        x = xq[p].astype(np.int64) * 2 + p
        scaled = ((x << (8 - tb)) & 0xFF) | (((x << (8 - tb)) & 0xFF) >> tb)
        b = ((scaled.astype(F32) / F32(255)).astype(F32) - xl).astype(F32)
        np.testing.assert_array_equal((b * b).astype(F32), err_s[p])
        bl, bh = np.repeat(b, 256), np.tile(b, 256)
        sl, sh = np.repeat(err_s[p], 256), np.tile(err_s[p], 256)
        sep = (sl + sh).astype(F32)
        changed += int((fma32(bl, bl, sh) != sep).sum() + (fma32(bh, bh, sl) != sep).sum())
    assert changed > 0


def test_shared_pbit_search_has_no_f32_multiply():
    from basisu_rs_jax.ops.bc7 import determine_shared_pbits

    e = [jax.ShapeDtypeStruct((8,), jnp.int32)] * 3
    jaxpr = jax.make_jaxpr(lambda a, b: determine_shared_pbits(3, 6, list(a), list(b)))(e, e)
    muls = [
        eqn for eqn in jaxpr.jaxpr.eqns
        if eqn.primitive.name == "mul" and eqn.outvars[0].aval.dtype == jnp.float32
    ]
    assert not muls
