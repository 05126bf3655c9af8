#!/usr/bin/env python
"""Jaxpr equation counts for the per-mode transcode lane functions.

The op side of a kernel roofline.  For each (target, mode) the lane
function is traced exactly as ops/dispatch._mode_kernel runs it, and the
closed jaxpr's equations are counted, excluding shape/dtype plumbing
(convert_element_type, reshape, broadcast_in_dim, squeeze) that lowers to
no arithmetic.  Every counted equation is elementwise over the block axis,
so the count is element-ops per block.

--stages attributes every equation to the innermost basisu_rs_jax source
line via jaxpr source_info and buckets them by the per-target stage line
ranges below, giving the per-stage irreducibility tables without touching
shipped code.

ETC1S kernels: targets named `etc1s_<kind>` (kind in rgba, alpha, etc1,
rgba_alpha) count the ops/etc1s kernel of that kind per block.

Usage:
  python tools/count_eqns.py                  # per-mode counts, all targets
  python tools/count_eqns.py bc7              # one target
  python tools/count_eqns.py bc7 --stages     # per-stage attribution
  python tools/count_eqns.py --mix            # bench-mix weighted means
                                               # (the golden corpus tiles 32
                                               # blocks x 19 modes uniformly)
  python tools/count_eqns.py etc1s_rgba       # ETC1S kernel body
"""

from __future__ import annotations

import sys
from collections import Counter
from pathlib import Path

sys.path.insert(0, str(Path(__file__).parent.parent))

import jax

jax.config.update("jax_platforms", "cpu")  # trace-only: no device needed

import numpy as np

from basisu_rs_jax.ops.dispatch import _REGISTRY, _ensure_registered
from basisu_rs_jax.tables import MODES

ROWS = 8
# Primitives that lower to layout/dtype plumbing, not arithmetic.
FREE = {"convert_element_type", "reshape", "broadcast_in_dim", "squeeze"}


def _sub_jaxprs(eqn):
    """Sub-jaxprs referenced from an equation's params (pjit/cond/scan/...)."""
    out = []
    from jax.extend import core as jex_core

    for v in eqn.params.values():
        vals = v if isinstance(v, (list, tuple)) else [v]
        for item in vals:
            if isinstance(item, jex_core.ClosedJaxpr):
                out.append(item.jaxpr)
            elif isinstance(item, jex_core.Jaxpr):
                out.append(item)
    return out


def _iter_eqns(jaxpr):
    """Leaf equations, recursing into sub-jaxprs (the call equation itself
    is not yielded, its body is)."""
    for eqn in jaxpr.eqns:
        subs = _sub_jaxprs(eqn)
        if subs:
            for sub in subs:
                yield from _iter_eqns(sub)
        else:
            yield eqn


def _count_jaxpr(jaxpr) -> Counter:
    c = Counter()
    for eqn in _iter_eqns(jaxpr):
        c[eqn.primitive.name] += 1
    return c


def _pkg_frame(eqn, want: str = "line"):
    """Innermost basisu_rs_jax frame that created eqn, as
    (file, line) for want='line', (file, function) for want='func'."""
    tb = eqn.source_info.traceback
    if tb is None:
        return ("?", 0)
    for frame in tb.frames:  # innermost first
        fn = frame.file_name
        if "basisu_rs_jax" in fn:
            if want == "func":
                return (Path(fn).name, frame.function_name)
            return (Path(fn).name, frame.line_num)
    return ("?", 0)


def trace_mode(target: str, mode_id: int):
    """Closed jaxpr of the lane function over a [ROWS, 4] lane batch."""
    # JAX caches traced library-internal implementations process-wide with
    # the source_info of their FIRST call site; without this, a later
    # trace's equations attribute to whichever earlier (target, mode)
    # first exercised the same jnp op shapes.
    jax.clear_caches()
    _ensure_registered()
    fn, _ = _REGISTRY[target]
    cfg = MODES[mode_id]
    return jax.make_jaxpr(lambda lanes: fn(cfg, lanes))(np.zeros((ROWS, 4), np.uint32)).jaxpr


def eqns_for(target: str, mode_id: int) -> int:
    c = _count_jaxpr(trace_mode(target, mode_id))
    return sum(n for prim, n in c.items() if prim not in FREE)


def eqns_for_etc1s(kind: str) -> int:
    """Non-FREE eqns per block of the ops/etc1s kernel of `kind`."""
    from basisu_rs_jax.ops.etc1s import KERNELS

    jax.clear_caches()
    fn, _ = KERNELS[kind]
    book = np.zeros((16, 4), np.uint8)
    table = np.zeros(16, np.uint32) if kind == "etc1" else book
    idx = [np.zeros(ROWS, np.int32)] * (4 if kind == "rgba_alpha" else 2)
    jaxpr = jax.make_jaxpr(fn)(book, table, *idx).jaxpr
    return sum(1 for eqn in _iter_eqns(jaxpr) if eqn.primitive.name not in FREE)


# Per-target stage buckets: (stage name, file, [inclusive line ranges]).
# Line ranges track the current source; --stages prints any unattributed
# remainder so drift is visible, not silent.
def _stage_buckets(target: str):
    common = [
        ("field decode (BISE/weights/pairs)", "uastc_decode.py", None),
        ("bit I/O + table plumbing", "bits.py", None),
    ]
    per_target = {
        "bc7": [("bc7: all", "bc7.py", None)],
        "etc1": [("etc: all", "etc.py", None)],
        "etc2": [("etc: all", "etc.py", None)],
        "rgba": [("rgba: all", "rgba.py", None)],
        "astc": [("astc: all", "astc.py", None)],
    }
    return common + per_target[target]


def stage_table(target: str, mode_id: int, granularity: str = "file"):
    """Eqn counts grouped by source file, file:line, or file:function
    (granularity in {'file', 'line', 'func'}), FREE primitives excluded."""
    by_loc: Counter = Counter()
    for eqn in _iter_eqns(trace_mode(target, mode_id)):
        if eqn.primitive.name in FREE:
            continue
        if granularity == "func":
            by_loc[_pkg_frame(eqn, "func")] += 1
        else:
            f, ln = _pkg_frame(eqn)
            by_loc[(f, ln if granularity == "line" else 0)] += 1
    return by_loc


def main(argv):
    etc1s = [a for a in argv if a.startswith("etc1s_")]
    for t in etc1s:
        print(f"{t}: {eqns_for_etc1s(t[len('etc1s_'):])} eqns/blk")
    argv = [a for a in argv if a not in etc1s]
    if etc1s and not [a for a in argv if not a.startswith("--")]:
        return
    targets = [a for a in argv if not a.startswith("--")] or [
        "rgba", "astc", "bc7", "etc1", "etc2"
    ]
    stages = "--stages" in argv
    lines = "--lines" in argv
    mix = "--mix" in argv
    n_modes = 19
    for target in targets:
        per_mode = {}
        for m in range(n_modes):
            try:
                per_mode[m] = eqns_for(target, m)
            except Exception as e:  # e.g. mode invalid for target
                per_mode[m] = None
                print(f"{target} mode {m:2d}: trace failed: {e}")
        row = " ".join(
            f"{m}:{v}" for m, v in per_mode.items() if v is not None
        )
        print(f"{target}: {row}")
        if mix:
            vals = [v for v in per_mode.values() if v is not None]
            print(
                f"{target}: bench-mix mean {sum(vals)/len(vals):.0f} eqns/blk "
                f"(uniform over {len(vals)} modes)"
            )
        if stages or lines:
            for m, v in per_mode.items():
                if v is None:
                    continue
                tbl = stage_table(target, m, "line" if lines else "file")
                parts = ", ".join(
                    (f"{f}:{ln}" if ln else f) + f"={n}"
                    for (f, ln), n in tbl.most_common(40 if lines else 10)
                )
                print(f"  {target} mode {m:2d} ({v} eqns): {parts}")


if __name__ == "__main__":
    main(sys.argv[1:])
