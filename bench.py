#!/usr/bin/env python
"""Throughput of the shipped transcode path on the attached accelerator.

Prints ONE JSON line naming the device (JAX platform, kind and count, and
nvidia-smi's card name and power limit) with the warm rate of each path:

  - UASTC -> {bc7, astc, rgba, etc1, etc2}: the golden block corpus (32
    blocks of each of the 19 modes) tiled to BENCH_N blocks, through
    models.UastcTranscoder.transcode_async (host mode partition, H2D, one
    kernel per mode), outputs left on the device;
  - ETC1S -> {rgba, rgba+alpha, etc1}: BENCH_N blocks of random indices
    into 16,128-entry codebooks (upstream basisu's cluster limit), through
    ops.etc1s.run_etc1s_* with device-resident outputs.

Each rate is texels over the best of BENCH_REPS wall times, each time
ending in block_until_ready.  Compilation is warmed first and reported
apart.  With no accelerator the script exits 1 and prints an error line:
it never measures the CPU.

  python bench.py                 # BENCH_N=524288 BENCH_REPS=5

The default size puts each mode group in the same 32768-block bucket as a
2048x2048 texture with its mip chain, so the programs chip_smoke.py compiles
for its corpus are the ones timed here.
"""

from __future__ import annotations

import json
import os
import sys
import time
from pathlib import Path

import numpy as np

FIXTURE = Path(__file__).parent / "tests" / "fixtures" / "golden_blocks.npz"
CODEBOOK = 16128


def golden_batch(n_blocks: int) -> np.ndarray:
    blocks = np.load(FIXTURE)["bc7_in"]
    reps = -(-n_blocks // len(blocks))
    return np.tile(blocks, (reps, 1))[:n_blocks]


def _best_of(fn, reps: int) -> tuple[float, float]:
    """(first call seconds, best warm seconds) of fn(), which returns device
    arrays; every call ends in block_until_ready."""
    import jax

    t0 = time.perf_counter()
    jax.block_until_ready(fn())
    first = time.perf_counter() - t0
    best = float("inf")
    for _ in range(reps):
        t0 = time.perf_counter()
        jax.block_until_ready(fn())
        best = min(best, time.perf_counter() - t0)
    return first, best


def run(n_blocks: int, reps: int) -> dict:
    from basisu_rs_jax.models import UastcTranscoder
    from basisu_rs_jax.ops.etc1s import run_etc1s_etc1, run_etc1s_rgba

    texels = n_blocks * 16
    rates, compile_s = {}, {}
    blocks = golden_batch(n_blocks)
    for target in ("bc7", "astc", "rgba", "etc1", "etc2"):
        tr = UastcTranscoder(target)
        first, best = _best_of(
            lambda: [g[2] for g in tr.transcode_async(blocks).groups], reps
        )
        rates[f"uastc_{target}_mtexels_s"] = texels / best / 1e6
        compile_s[f"uastc_{target}"] = first - best

    rng = np.random.default_rng(5)
    endpoints = np.zeros((CODEBOOK, 4), np.uint8)
    endpoints[:, :3] = rng.integers(0, 32, (CODEBOOK, 3))
    endpoints[:, 3] = rng.integers(0, 8, CODEBOOK)
    selectors = rng.integers(0, 256, (CODEBOOK, 4)).astype(np.uint8)
    ep, sel, a_ep, a_sel = (rng.integers(0, CODEBOOK, n_blocks) for _ in range(4))
    for name, fn in (
        ("rgba", lambda: run_etc1s_rgba(endpoints, selectors, ep, sel, device=True)),
        ("rgba_alpha", lambda: run_etc1s_rgba(
            endpoints, selectors, ep, sel, (a_ep, a_sel), device=True)),
        ("etc1", lambda: run_etc1s_etc1(endpoints, selectors, ep, sel, device=True)),
    ):
        first, best = _best_of(fn, reps)
        rates[f"etc1s_{name}_mtexels_s"] = texels / best / 1e6
        compile_s[f"etc1s_{name}"] = first - best
    return {"rates": rates, "first_call_minus_warm_s": compile_s}


def main() -> int:
    from basisu_rs_jax.utils.compile_cache import configure
    from basisu_rs_jax.utils.device import (
        NoAcceleratorError,
        nvidia_smi_name_power,
        require_accelerator,
    )

    try:
        device = require_accelerator()
    except NoAcceleratorError as e:
        print(json.dumps({"ok": False, "error": str(e)}))
        return 1
    configure()
    n_blocks = int(os.environ.get("BENCH_N", 1 << 19))
    reps = int(os.environ.get("BENCH_REPS", 5))
    result = run(n_blocks, reps)
    print(json.dumps({
        "ok": True,
        "device": device,
        "card": nvidia_smi_name_power(),
        "n_blocks": n_blocks,
        "reps": reps,
        **result,
    }))
    return 0


if __name__ == "__main__":
    sys.exit(main())
