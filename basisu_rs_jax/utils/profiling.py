"""Lightweight profiling: per-stage wall times and texel-rate counters.

The reference has no tracing/profiling subsystem (SURVEY.md section 5); this
build's analog is (a) these per-kernel counters and (b) optional JAX
profiler traces around the hot paths (`trace(path)` wraps
jax.profiler.trace for TensorBoard-compatible dumps).
"""

from __future__ import annotations

import contextlib
import threading
import time
from collections import defaultdict
from dataclasses import dataclass, field

_LOCK = threading.Lock()  # stages may close on pipeline worker threads


@dataclass
class StageStats:
    calls: int = 0
    seconds: float = 0.0
    texels: int = 0

    @property
    def mtexels_per_s(self) -> float:
        return self.texels / self.seconds / 1e6 if self.seconds else 0.0


@dataclass
class Profiler:
    """Accumulates per-stage timings; cheap enough to leave always-on."""

    enabled: bool = True
    stats: dict = field(default_factory=lambda: defaultdict(StageStats))

    @contextlib.contextmanager
    def stage(self, name: str, texels: int = 0):
        if not self.enabled:
            yield
            return
        t0 = time.perf_counter()
        try:
            yield
        finally:
            dt = time.perf_counter() - t0
            with _LOCK:
                s = self.stats[name]
                s.calls += 1
                s.seconds += dt
                s.texels += texels

    def report(self) -> str:
        lines = []
        for name, s in sorted(self.stats.items()):
            rate = f"  {s.mtexels_per_s:9.1f} Mtex/s" if s.texels else ""
            lines.append(f"{name:32s} {s.calls:6d} calls  {s.seconds*1e3:9.2f} ms{rate}")
        return "\n".join(lines)


@contextlib.contextmanager
def trace(log_dir: str | None):
    """Optional jax profiler trace (TensorBoard format)."""
    if not log_dir:
        yield
        return
    import jax

    with jax.profiler.trace(log_dir):
        yield
