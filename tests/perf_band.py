"""Per-machine calibration band for the decode/calib contention guard.

Round-4 verdict item 7: the asserted ratio band used to be a hard-coded
[0.45, 0.90) calibrated to one host; new hardware or a legitimate decode
speedup failed CI by design with the re-pin procedure buried in a
docstring.  This module makes the re-pin mechanical:

- The quiet decode/calib ratio for THIS machine is cached in the
  checkout's `.jax_cache/perf_band_<machine>.json`.
- The operating band derives from the cached quiet ratio:
  floor = 0.63 x quiet (a genuine 2x decode regression lands at
  0.5 x quiet, safely below), ceiling = 1.25 x quiet (observed
  run-to-run spread on the builder host is 0.68-0.75, ~ +/-5%).
- A measurement ABOVE the ceiling is a legitimate speedup (or a calib
  regression): the guard re-measures, RE-PINS the cache to the new
  quiet ratio, and passes with a warning - instead of failing CI.
  A measurement BELOW the floor is an algorithmic regression and fails.

The decision logic is pure (`evaluate_guard`) so the speedup/regression
responses are unit-tested with simulated ratios, no timing involved.
"""

from __future__ import annotations

import json
import os
from pathlib import Path

# Fallback quiet ratio when no per-machine pin exists yet: the round-4
# builder host measured 0.68-0.75 quiet and under contention; 0.70 derives
# the old hard-coded band (floor 0.434 ~ 0.45, ceiling 0.875 ~ 0.90).
FALLBACK_QUIET = 0.70
FLOOR_FRAC = 0.63  # 2x regression -> 0.5 x quiet < 0.63 x quiet: trips
CEIL_FRAC = 1.25  # beyond run-to-run spread: triggers mechanical re-pin
# Structural guarantee: CEIL_FRAC / 2 < FLOOR_FRAC, so a genuine 2x decode
# slowdown of ANY in-band measurement lands below the floor.


def _machine_slug() -> str:
    """Stable identity for the cache file: CPU model + core count."""
    model = "unknown"
    try:
        for line in Path("/proc/cpuinfo").read_text().splitlines():
            if line.lower().startswith("model name"):
                model = line.split(":", 1)[1].strip()
                break
    except OSError:
        pass
    raw = f"{model}_{os.cpu_count() or 1}c"
    return "".join(ch if ch.isalnum() else "_" for ch in raw)[:80]


def band_path() -> Path:
    return (
        Path(__file__).resolve().parents[1]
        / ".jax_cache"
        / f"perf_band_{_machine_slug()}.json"
    )


def load_quiet() -> float:
    """Cached quiet ratio for this machine, or the fallback pin."""
    try:
        return float(json.loads(band_path().read_text())["quiet_ratio"])
    except (OSError, ValueError, KeyError):
        return FALLBACK_QUIET


def save_quiet(ratio: float) -> None:
    p = band_path()
    p.parent.mkdir(parents=True, exist_ok=True)
    p.write_text(json.dumps({"quiet_ratio": round(ratio, 4)}))


def derive_band(quiet: float) -> tuple[float, float]:
    return (FLOOR_FRAC * quiet, CEIL_FRAC * quiet)


def evaluate_guard(ratio: float, quiet: float) -> str:
    """Pure guard decision for a measured decode/calib ratio against the
    pinned quiet ratio: 'fail' (regression), 'ok' (in band), or 'repin'
    (legitimate speedup / new hardware - caller re-pins the cache)."""
    floor, ceil = derive_band(quiet)
    if ratio <= floor:
        return "fail"
    if ratio >= ceil:
        return "repin"
    return "ok"
