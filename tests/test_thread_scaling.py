"""The C++ ETC1S front-end must parallelize across threads (ctypes releases
the GIL; the decode handle is read-only during decode_slice, all mutable
state is per-call local - native/etc1s.cpp:265-300)."""

import os
import time
from concurrent.futures import ThreadPoolExecutor

import numpy as np
import pytest

native = pytest.importorskip("basisu_rs_jax.native")

from basisu_rs_jax.container.basis import read_header, read_slice_descs
from basisu_rs_jax.container.writer import write_etc1s_basis_fuzz


@pytest.fixture(scope="module")
def slice_setup():
    rng = np.random.default_rng(3)
    e, s = 200, 150
    endpoints = np.zeros((e, 4), np.uint8)
    endpoints[:, :3] = rng.integers(0, 32, (e, 3))
    endpoints[:, 3] = rng.integers(0, 8, e)
    selectors = rng.integers(0, 256, (s, 4)).astype(np.uint8)
    nbx, nby = 160, 160  # 25.6k blocks ~ 1ms/decode on one core
    buf, _, _ = write_etc1s_basis_fuzz(endpoints, selectors, nbx, nby, 32, seed=9)
    h = read_header(buf)
    desc = read_slice_descs(buf, h)[0]
    models = native.NativeEtc1sModels(
        buf[h.tables_file_ofs : h.tables_file_ofs + h.tables_file_size],
        h.total_endpoints,
        h.total_selectors,
        False,
    )
    return models, nbx, nby, desc.data(buf)


def _task(models, nbx, nby, data, reps=40):
    for _ in range(reps):
        ep, sel = models.decode_slice(nbx, nby, data)
    return ep[0]


def test_native_decode_releases_the_gil(slice_setup):
    """Runs on any core count, including 1-CPU hosts: with the interpreter's
    switch interval set far beyond the test's duration, a pure-Python
    spinner thread can make progress ONLY if the native call actually drops
    the GIL (no preemption will ever hand it over; a GIL-holding native
    call would freeze the counter for the whole measurement loop).  A plain
    end-to-end counter with the default 5ms switch interval is vacuous: the
    spinner catches up whenever preemption lands between calls."""
    import sys
    import threading

    models, nbx, nby, data = slice_setup
    _task(models, nbx, nby, data, reps=4)  # warm

    stop = False
    count = 0

    def spin():
        nonlocal count
        while not stop:
            count += 1
            if not (count & 0xFFFF):
                time.sleep(0)  # periodic voluntary yield so the main thread
                # can ever reacquire the GIL under the huge switch interval

    old = sys.getswitchinterval()
    sys.setswitchinterval(300.0)
    try:
        spinner = threading.Thread(target=spin)
        spinner.start()
        time.sleep(0.05)  # sleep releases the GIL: spinner enters its loop
        start = count
        for _ in range(100):
            models.decode_slice(nbx, nby, data)
        grown = count - start
    finally:
        stop = True
        sys.setswitchinterval(old)
        spinner.join()
    assert grown > 1000, f"spinner starved during native decode (grew {grown})"


def test_native_decode_single_core_floor(slice_setup):
    """Perf guard for the C++ front-end's algorithmic shape: the round-3
    loop (fast 8-byte-window bit reads, fused Huffman entries, arithmetic-
    mask endpoint selects) measures ~105 Mblk/s/core on an otherwise-idle
    2.7 GHz shared vCPU.  The floor asserted here is 35 Mblk/s - low enough
    to ride out ~3x noisy-neighbor contention on CI, high enough to catch a
    real regression to scalar-bit-loop behavior (the round-2 loop measured
    ~65, contended runs of it ~25).  BASISU_PERF_STRICT=1 raises the bar to
    75 Mblk/s for on-demand verification on a quiet core."""
    models, nbx, nby, data = slice_setup
    n = nbx * nby
    _task(models, nbx, nby, data, reps=4)  # warm
    best = float("inf")
    for _ in range(10):
        t0 = time.perf_counter()
        models.decode_slice(nbx, nby, data)
        best = min(best, time.perf_counter() - t0)
    rate = n / best / 1e6
    floor = 75.0 if os.environ.get("BASISU_PERF_STRICT") else 35.0
    assert rate > floor, f"native decode_slice at {rate:.1f} Mblk/s/core (floor {floor})"


def _measure_ratio(models, nbx, nby, data, reps=8):
    """Decode/calib ratio, interleaved best-of-`reps` with MATCHED region
    lengths (~0.4 ms each: short regions slot between preemptions, so
    best-of-N finds an uninterrupted window for both sides even on a fully
    contended core; mismatched lengths were measured to skew the ratio 2x).
    Machine speed divides out."""
    from basisu_rs_jax.native import calib_native

    n = nbx * nby
    CAL = 50_000  # ~0.35 ms: same region length as one slice decode
    models.decode_slice(nbx, nby, data)
    calib_native(CAL)
    best_c = best_k = float("inf")
    for _ in range(reps):
        t0 = time.perf_counter()
        models.decode_slice(nbx, nby, data)
        best_c = min(best_c, time.perf_counter() - t0)
        t0 = time.perf_counter()
        calib_native(CAL)
        best_k = min(best_k, time.perf_counter() - t0)
    return (n / best_c) / (CAL / best_k)


def test_native_decode_contention_aware_ratio_guard(slice_setup):
    """Contention-aware perf guard (round-3 verdict: the absolute 35 Mblk/s
    floor has a 3x cushion a real 2x regression would sail through).

    Metric: decode rate vs a fixed decode-profile C calibration loop
    (native.calib_native - L1 table walk, data-dependent branch, bit
    mixing); see _measure_ratio.  Measured band on the 1-vCPU builder host:
    0.68-0.75 quiet AND under a spinning competitor process.

    The operating band derives from a PER-MACHINE pinned quiet ratio
    (tests/perf_band.py, cached in .jax_cache/): floor = 0.63 x quiet, so any
    in-band measurement halves to below the floor and a genuine 2x decode
    slowdown trips under ANY contention level.  A measurement above the
    ceiling (legitimate speedup or new hardware) re-measures and RE-PINS
    the cache mechanically instead of failing CI."""
    import warnings

    import perf_band

    models, nbx, nby, data = slice_setup
    quiet = perf_band.load_quiet()
    ratio = _measure_ratio(models, nbx, nby, data)
    verdict = perf_band.evaluate_guard(ratio, quiet)
    if verdict == "repin":
        # confirm with a fresh, longer measurement before moving the pin
        ratio2 = _measure_ratio(models, nbx, nby, data, reps=16)
        if perf_band.evaluate_guard(ratio2, quiet) == "repin":
            perf_band.save_quiet(ratio2)
            warnings.warn(
                f"decode/calib ratio {ratio2:.3f} above the pinned band for "
                f"quiet={quiet:.3f}: legitimate speedup or new hardware; "
                f"band re-pinned to {perf_band.band_path()}"
            )
            return
        verdict = perf_band.evaluate_guard(ratio2, quiet)
        ratio = ratio2
    floor, ceil = perf_band.derive_band(quiet)
    assert verdict == "ok", (
        f"decode/calib ratio {ratio:.3f} below floor {floor:.3f} (pinned "
        f"quiet {quiet:.3f}): the native front-end regressed algorithmically"
    )


def test_guard_band_simulated_speedup_and_regression(tmp_path, monkeypatch):
    """Round-4 verdict item 7 done-criteria, timing-free: the guard logic
    passes (via mechanical re-pin) on a simulated 1.3x decode speedup and
    still fails on a simulated 2x regression."""
    import perf_band

    monkeypatch.setattr(
        perf_band, "band_path", lambda: tmp_path / "perf_band_test.json"
    )
    perf_band.save_quiet(0.70)
    quiet = perf_band.load_quiet()
    assert quiet == 0.70

    # in-band measurement: plain pass
    assert perf_band.evaluate_guard(0.72, quiet) == "ok"
    # 1.3x speedup: re-pin, not a CI failure
    assert perf_band.evaluate_guard(0.70 * 1.3, quiet) == "repin"
    perf_band.save_quiet(0.70 * 1.3)
    # ...and the new pin governs subsequent runs
    new_quiet = perf_band.load_quiet()
    assert new_quiet == pytest.approx(0.91)
    assert perf_band.evaluate_guard(0.91, new_quiet) == "ok"
    # 2x regression: fails under the original pin AND under the new one
    assert perf_band.evaluate_guard(0.70 / 2, quiet) == "fail"
    assert perf_band.evaluate_guard(0.91 / 2, new_quiet) == "fail"
    # a 2x regression of any IN-BAND measurement trips structurally
    floor, ceil = perf_band.derive_band(new_quiet)
    assert ceil / 2 < floor


def test_guard_band_fallback_matches_round4_hardcode():
    """With no per-machine pin, the derived band reproduces the round-4
    hard-coded [0.45, 0.90) within a few percent, so behavior on fresh
    checkouts is unchanged."""
    import perf_band

    floor, ceil = perf_band.derive_band(perf_band.FALLBACK_QUIET)
    assert floor == pytest.approx(0.45, abs=0.02)
    assert ceil == pytest.approx(0.90, abs=0.03)


@pytest.mark.skipif((os.cpu_count() or 1) < 4, reason="needs >= 4 cores")
def test_native_decode_scales_across_threads(slice_setup):
    models, nbx, nby, data = slice_setup
    n_tasks, workers = 8, 4
    _task(models, nbx, nby, data, reps=4)  # warm (code page-in)

    t0 = time.perf_counter()
    for _ in range(n_tasks):
        _task(models, nbx, nby, data)
    serial = time.perf_counter() - t0

    with ThreadPoolExecutor(workers) as pool:
        t0 = time.perf_counter()
        list(pool.map(lambda _: _task(models, nbx, nby, data), range(n_tasks)))
        parallel = time.perf_counter() - t0

    speedup = serial / parallel
    assert speedup > 1.5, f"expected >1.5x scaling with {workers} threads, got {speedup:.2f}x"
