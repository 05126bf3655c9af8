#!/usr/bin/env python
"""Single-core throughput of the native ETC1S entropy front-end
(etc1s_decode_slice), in Mblocks/s.

This is the host side of the ETC1S pipeline budget: the sequential
prediction/entropy state machine runs one slice per core while the device
kernels (ops/etc1s.py) consume the emitted index tensors.  Run before/after
native/etc1s.cpp changes:

    python tools/bench_etc1s_host.py [--blocks 1048576] [--reps 5]
"""

from __future__ import annotations

import argparse
import sys
import time
from pathlib import Path

import numpy as np

sys.path.insert(0, str(Path(__file__).parent.parent))


def make_slice(nbx: int, nby: int, e: int = 512, s: int = 384, hist: int = 32,
               seed: int = 9):
    from basisu_rs_jax.container.basis import read_header, read_slice_descs
    from basisu_rs_jax.container.writer import write_etc1s_basis_fuzz
    from basisu_rs_jax import native

    rng = np.random.default_rng(seed)
    endpoints = np.zeros((e, 4), np.uint8)
    endpoints[:, :3] = rng.integers(0, 32, (e, 3))
    endpoints[:, 3] = rng.integers(0, 8, e)
    selectors = rng.integers(0, 256, (s, 4)).astype(np.uint8)
    buf, exp_ep, exp_sel = write_etc1s_basis_fuzz(
        endpoints, selectors, nbx, nby, hist, seed=seed
    )
    h = read_header(buf)
    desc = read_slice_descs(buf, h)[0]
    models = native.NativeEtc1sModels(
        buf[h.tables_file_ofs : h.tables_file_ofs + h.tables_file_size],
        h.total_endpoints, h.total_selectors, False,
    )
    return models, desc.data(buf), exp_ep, exp_sel


def aggregate_rate(workers: int, n_blocks: int = 1 << 18, tasks_per_worker: int = 4,
                   reps: int = 3):
    """Aggregate front-end Mblocks/s with `workers` threads decoding
    independent slices concurrently (the cores x slices axis: the BasisLZ
    state machine is serial WITHIN a slice, so host scale comes from slices
    across GIL-released cores — basis_lz/mod.rs:188-458 is the serial
    contract).  Each worker owns its own slice payload; the codebook handle
    is shared (read-only during decode_slice, native/etc1s.cpp).
    Best-of-`reps` over the timed region: on a small shared host a single
    pass is dominated by scheduling noise (round-4 verdict item 4 - same
    code measured 45 and 98 Mblk/s run to run)."""
    from concurrent.futures import ThreadPoolExecutor

    nbx = 512
    nby = max(1, n_blocks // nbx)
    n = nbx * nby
    models, data, exp_ep, _ = make_slice(nbx, nby)
    ep, _ = models.decode_slice(nbx, nby, data)
    np.testing.assert_array_equal(ep, exp_ep)

    n_tasks = workers * tasks_per_worker

    def task(_):
        models.decode_slice(nbx, nby, data)

    best = float("inf")
    with ThreadPoolExecutor(workers) as pool:
        list(pool.map(task, range(workers)))  # warm all threads
        for _ in range(reps):
            t0 = time.perf_counter()
            list(pool.map(task, range(n_tasks)))
            best = min(best, time.perf_counter() - t0)
    return n_tasks * n / best


def scaling_curve(max_workers: int, n_blocks: int = 1 << 18):
    """[(workers, aggregate Mblk/s)] for 1,2,4,... up to max_workers."""
    points = []
    w = 1
    while w <= max_workers:
        points.append((w, aggregate_rate(w, n_blocks)))
        w *= 2
    if points[-1][0] != max_workers:
        points.append((max_workers, aggregate_rate(max_workers, n_blocks)))
    return points


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--blocks", type=int, default=1 << 20)
    ap.add_argument("--reps", type=int, default=5)
    ap.add_argument(
        "--workers", type=int, default=0,
        help="also measure the many-worker aggregate scaling curve up to N "
        "threads (0 = skip; use e.g. the machine core count)",
    )
    args = ap.parse_args()

    nbx = 1024
    nby = args.blocks // nbx
    models, data, exp_ep, exp_sel = make_slice(nbx, nby)
    n = nbx * nby

    # correctness anchor before timing
    ep, sel = models.decode_slice(nbx, nby, data)
    np.testing.assert_array_equal(ep, exp_ep)
    np.testing.assert_array_equal(sel, exp_sel)

    best = float("inf")
    for _ in range(args.reps):
        t0 = time.perf_counter()
        models.decode_slice(nbx, nby, data)
        best = min(best, time.perf_counter() - t0)
    print(f"{n} blocks, best of {args.reps}: {n / best / 1e6:.1f} Mblk/s/core")

    if args.workers:
        base = None
        for w, rate in scaling_curve(args.workers, min(args.blocks, 1 << 18)):
            base = base or rate
            print(
                f"  {w:3d} worker(s): {rate / 1e6:7.1f} Mblk/s aggregate "
                f"({rate / base / w * 100:5.1f}% of linear)"
            )
    return 0


if __name__ == "__main__":
    sys.exit(main())
