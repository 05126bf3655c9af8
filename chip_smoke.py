#!/usr/bin/env python
"""Smoke run of the transcoder on one NVIDIA GPU, at deployment size.

Drives the shipped paths through the entry points a user calls and checks
every output bit for bit against the repository's references:

  1. device       nvidia-smi's card name and power limit (from a child that
                  does not import JAX), JAX's device kind, and the native
                  C++ front-end (a pure-Python fallback fails the phase);
  2. golden       the 3,040 golden pairs (608 blocks x 5 targets) through
                  ops.dispatch.transcode_blocks and through
                  parallel.mesh.sharded_transcode on a 1-device mesh;
  3. fuzz         seeded random blocks (4,096 uniform + 64 per forced mode)
                  per target against tests/oracle_uastc.py, error sites
                  included, and the f32 checks of tests/test_pbits.py and
                  tests/test_fma.py with the card as the backend;
  4. etc1s        synthetic .basis files (container/writer.py) with
                  16,128-entry codebooks, full mip chains and alpha-paired
                  slices through read_to_rgba / read_to_etc1, against the
                  same decode on the host CPU backend; one small file against
                  tests/oracle_etc1s.py;
  5. corpus       16 UASTC textures of 2048x2048 with full mip chains
                  (5.59 M blocks) through read_to_{bc7,astc,rgba,etc1,etc2},
                  models.CorpusTranscoder and models.BasisCorpusPipeline, and
                  8 ETC1S 2048x2048 textures with mips and alpha slices;
                  every output checked; compile time, warm time and peak
                  device memory printed;
  6. gpu-tests    the `gpu`-marked pytest tests, in this process.

Each phase prints one line with its result, its compile time and its run
time.  The last line is one JSON object,
{"ok": true, "device": {"platform": "gpu", "kind": ..., "count": 1}}; when
any phase fails, or JAX finds no GPU, it is {"ok": false, ...} and the exit
code is 1.

  python chip_smoke.py [--seed N]
  python chip_smoke.py --four-cards   # only: read_to_*(mesh=), sharded_*,
                                      # CLI --mesh 4 on four GPUs vs one
"""

from __future__ import annotations

import argparse
import contextlib
import io
import json
import sys
import tempfile
import threading
import time
import traceback
from concurrent.futures import ThreadPoolExecutor
from dataclasses import dataclass
from pathlib import Path

ROOT = Path(__file__).resolve().parent
TARGETS = ("bc7", "astc", "rgba", "etc1", "etc2")


@dataclass(frozen=True)
class Sizes:
    fuzz_uniform: int = 4096
    fuzz_per_mode: int = 64
    codebook: int = 16128  # upstream basisu's endpoint / selector cluster limit
    etc1s_parity_side: int = 1024
    uastc_textures: int = 16
    uastc_side: int = 2048
    etc1s_textures: int = 8
    etc1s_side: int = 2048


FULL = Sizes()


class CompileClock:
    """Seconds JAX spent tracing, lowering and compiling, from its own
    monitoring events, so a phase's compile time prints apart from its run
    time."""

    _EVENTS = (
        "/jax/core/compile/jaxpr_trace_duration",
        "/jax/core/compile/jaxpr_to_mlir_module_duration",
        "/jax/core/compile/backend_compile_duration",
    )

    def __init__(self):
        import jax

        self.seconds = 0.0
        self._lock = threading.Lock()
        jax.monitoring.register_event_duration_secs_listener(self._on_event)

    def _on_event(self, event, duration, **_):
        if event in self._EVENTS:
            with self._lock:
                self.seconds += duration


class Runner:
    def __init__(self, clock: CompileClock | None):
        self.clock = clock
        self.failed: list[str] = []

    def _compile_s(self) -> float:
        return self.clock.seconds if self.clock else 0.0

    def phase(self, name: str, fn, *args, warm=None):
        """Run warm() (the phase's compiles, possibly on several threads),
        then fn(*args).  Compile time is the warm-up's wall time plus any
        compile inside fn; run time is the rest of fn's wall time."""
        t0 = time.perf_counter()
        t1 = t0
        late = 0.0
        try:
            if warm is not None:
                warm()
            t1 = time.perf_counter()
            c1 = self._compile_s()
            detail = fn(*args)
            late = self._compile_s() - c1
            status = "ok"
        except Exception as e:  # noqa: BLE001 - reported, and fails the run
            traceback.print_exc()
            detail = f"{type(e).__name__}: {e}"
            status = "FAIL"
            self.failed.append(name)
        t2 = time.perf_counter()
        print(
            f"[{name}] {status}: {detail} | compile {t1 - t0 + late:.1f} s, "
            f"run {t2 - t1 - late:.1f} s",
            flush=True,
        )
        return status == "ok"


def warm_programs(items) -> None:
    """Compile and run once each per-mode program (target, mode, rows, mesh
    or None) on a thread pool: XLA compiles outside the interpreter lock, so
    the programs of a phase build in parallel."""
    import os

    import jax
    import numpy as np
    from jax.sharding import NamedSharding, PartitionSpec as P

    from basisu_rs_jax.ops.dispatch import _mode_kernel
    from basisu_rs_jax.parallel.mesh import BLOCK_AXIS, sharded_mode_step

    def build(item):
        target, mode, rows, mesh = item
        x = np.zeros((rows, 4), np.uint32)
        if mesh is None:
            jax.block_until_ready(_mode_kernel(target, mode)(x))
        else:
            x = jax.device_put(x, NamedSharding(mesh, P(BLOCK_AXIS, None)))
            jax.block_until_ready(sharded_mode_step(target, mode, mesh)(x))

    with ThreadPoolExecutor(os.cpu_count() or 1) as pool:
        list(pool.map(build, items))


def mode_buckets(blocks) -> dict:
    """{mode: padded group size} that dispatch gives the UASTC batch
    `blocks`."""
    import numpy as np

    from basisu_rs_jax.ops.dispatch import _bucket, block_modes

    counts = np.bincount(block_modes(blocks), minlength=20)[:19]
    return {m: _bucket(int(c)) for m, c in enumerate(counts) if c}


# ---------------------------------------------------------------------------
# shared data builders
# ---------------------------------------------------------------------------


def mip_chain(side: int):
    """[(width, height, nbx, nby)] from side x side down to 1 x 1."""
    levels, w = [], side
    while True:
        nb = -(-w // 4)
        levels.append((w, w, nb, nb))
        if w == 1:
            return levels
        w = max(1, w // 2)


def golden():
    import numpy as np

    return np.load(ROOT / "tests" / "fixtures" / "golden_blocks.npz")


def random_codebooks(rng, e: int, s: int):
    import numpy as np

    endpoints = np.zeros((e, 4), np.uint8)
    endpoints[:, :3] = rng.integers(0, 32, (e, 3))
    endpoints[:, 3] = rng.integers(0, 8, e)
    selectors = rng.integers(0, 256, (s, 4)).astype(np.uint8)
    return endpoints, selectors


def etc1s_file(rng, endpoints, selectors, side: int, alpha: bool) -> bytes:
    """A .basis ETC1S texture with a full mip chain (and, with alpha, an
    alpha slice after every RGB slice), random indices from rng."""
    from basisu_rs_jax.container.writer import write_etc1s_basis

    slices = []
    for level, (w, h, nbx, nby) in enumerate(mip_chain(side)):
        for is_alpha in ((False, True) if alpha else (False,)):
            slices.append(dict(
                ep_idx=rng.integers(0, len(endpoints), nbx * nby),
                sel_idx=rng.integers(0, len(selectors), nbx * nby),
                nbx=nbx, nby=nby, orig_width=w, orig_height=h,
                image_index=0, level_index=level, alpha=is_alpha,
            ))
    return write_etc1s_basis(endpoints, selectors, slices, has_alpha=alpha)


@dataclass
class UastcTexture:
    buf: bytes
    choice: object  # golden row of every block, mip levels concatenated
    levels: list


def uastc_corpus(seed: int, n: int, side: int) -> list[UastcTexture]:
    """n textures of side x side with full mip chains; every block is one of
    the 608 golden inputs (a seeded choice), so every output is known."""
    import numpy as np

    from basisu_rs_jax.container.writer import write_uastc_basis

    g_in = golden()["bc7_in"]
    rng = np.random.default_rng(seed)
    levels = mip_chain(side)
    total = sum(nbx * nby for _, _, nbx, nby in levels)
    out = []
    for _ in range(n):
        choice = rng.integers(0, len(g_in), total)
        blocks = g_in[choice]
        slices, ofs = [], 0
        for level, (w, h, nbx, nby) in enumerate(levels):
            slices.append(dict(
                blocks=blocks[ofs : ofs + nbx * nby], nbx=nbx, nby=nby,
                orig_width=w, orig_height=h, image_index=0, level_index=level,
            ))
            ofs += nbx * nby
        out.append(UastcTexture(write_uastc_basis(slices), choice, levels))
    return out


def raster_rgba(words, nbx: int):
    """[N, 16] packed RGBA texel words of a slice -> raster RGBA bytes."""
    import numpy as np

    nby = len(words) // nbx
    t = words.reshape(nby, nbx, 4, 4).transpose(0, 2, 1, 3)
    return np.ascontiguousarray(t.reshape(nby * 4, nbx * 4)).astype("<u4").view(np.uint8).reshape(-1)


def expected_images(tex: UastcTexture, target: str) -> list:
    """Per mip level, the image bytes read_to_<target> must return."""
    g_out = golden()[f"{target}_out"][tex.choice]
    out, ofs = [], 0
    for _, _, nbx, nby in tex.levels:
        part = g_out[ofs : ofs + nbx * nby]
        ofs += nbx * nby
        out.append(raster_rgba(part, nbx) if target == "rgba" else part.reshape(-1))
    return out


def read_images(target: str, buf: bytes, mesh=None) -> list:
    import basisu_rs_jax as b

    reader = getattr(b, f"read_to_{target}")
    kwargs = {} if mesh is None else {"mesh": mesh}
    result = reader(buf, **kwargs)
    return result[1] if target == "rgba" else result


def check_images(got: list, want: list, label: str) -> None:
    import numpy as np

    if len(got) != len(want):
        raise AssertionError(f"{label}: {len(got)} images, expected {len(want)}")
    for i, (g, w) in enumerate(zip(got, want)):
        g = g.data if hasattr(g, "data") else g
        if not np.array_equal(np.asarray(g).reshape(-1), np.asarray(w).reshape(-1)):
            raise AssertionError(f"{label}: image {i} differs")


# ---------------------------------------------------------------------------
# phases
# ---------------------------------------------------------------------------


def phase_device(card: str | None, device: dict) -> str:
    if not card:
        raise RuntimeError("nvidia-smi reported no card name and power limit")
    try:
        from basisu_rs_jax import native
    except ImportError as e:
        raise RuntimeError(f"native C++ front-end did not load: {e}") from None
    from basisu_rs_jax.container import crc

    if crc._native_crc16 is None:
        raise RuntimeError("CRC-16 fell back to the pure-Python path")
    return f"{card} | {device['kind']} | native front-end loaded ({native.library_path().name})"


def warm_golden() -> None:
    """The plain and 1-device-sharded per-mode programs at the golden
    blocks' group sizes (the gpu tests reuse them)."""
    from basisu_rs_jax.parallel.mesh import make_mesh

    mesh = make_mesh(1)
    buckets = mode_buckets(golden()["bc7_in"])
    warm_programs([(t, m, rows, on) for t in TARGETS for m, rows in buckets.items()
                   for on in (None, mesh)])


def phase_golden() -> str:
    import numpy as np

    from basisu_rs_jax.ops import transcode_blocks
    from basisu_rs_jax.parallel.mesh import make_mesh, sharded_transcode

    g = golden()
    mesh = make_mesh(1)
    plain = sharded = total = 0
    for target in TARGETS:
        want = g[f"{target}_out"]
        for path, fn in (("plain", transcode_blocks),
                         ("sharded", lambda b, t: sharded_transcode(b, t, mesh))):
            out, err = fn(g[f"{target}_in"], target)
            n_ok = int(np.sum(np.all(out == want, axis=1) & ~err))
            if path == "plain":
                plain += n_ok
            else:
                sharded += n_ok
        total += len(want)
    if plain != total or sharded != total:
        raise AssertionError(f"plain {plain}/{total}, sharded {sharded}/{total} golden pairs match")
    return f"{plain}/{total} golden pairs on the plain path, {sharded}/{total} on the sharded path (1-device mesh)"


def fuzz_blocks(seed: int, sizes: Sizes):
    import numpy as np
    from oracle_uastc import mode_code_bits

    rng = np.random.default_rng(seed)
    parts = [rng.integers(0, 256, (sizes.fuzz_uniform, 16), dtype=np.uint8)]
    for mode_id in range(19):
        b = rng.integers(0, 256, (sizes.fuzz_per_mode, 16), dtype=np.uint8)
        code, code_size = mode_code_bits(mode_id)
        keep = 0xFF & ~((1 << min(code_size, 8)) - 1)
        b[:, 0] = (b[:, 0] & keep) | (code & 0xFF)
        parts.append(b)
    return np.concatenate(parts)


def warm_fuzz(seed: int, sizes: Sizes) -> None:
    buckets = mode_buckets(fuzz_blocks(seed, sizes))
    warm_programs([(t, m, rows, None) for t in TARGETS for m, rows in buckets.items()])


def phase_fuzz(seed: int, sizes: Sizes) -> str:
    import numpy as np
    from oracle_uastc import OracleUastcError
    from test_uastc_oracle import _ORACLES

    import test_fma
    import test_pbits
    from basisu_rs_jax.ops import transcode_blocks

    blocks = fuzz_blocks(seed, sizes)
    n_err = bad = 0
    for target in TARGETS:
        out, err = transcode_blocks(blocks, target)
        for i in range(len(blocks)):
            try:
                want = _ORACLES[target](bytes(blocks[i]))
            except OracleUastcError:
                n_err += 1
                bad += not err[i]
                continue
            bad += bool(err[i]) or not np.array_equal(out[i], want)
    if bad:
        raise AssertionError(f"{bad} of {len(blocks) * len(TARGETS)} block results disagree with oracle_uastc")
    test_pbits.test_determine_shared_pbits_matches_lut_reimplementation()
    test_fma.test_eac_centre_jit_matches_host()
    return (
        f"{len(blocks)} seeded blocks x {len(TARGETS)} targets agree with oracle_uastc "
        f"({n_err} error sites agree); shared p-bit search and EAC centre exact on the device"
    )


def phase_etc1s(seed: int, sizes: Sizes) -> str:
    import jax
    import numpy as np
    from oracle_etc1s import oracle_read_to_etc1, oracle_read_to_rgba

    rng = np.random.default_rng(seed + 1)
    endpoints, selectors = random_codebooks(rng, sizes.codebook, sizes.codebook)
    cpu = jax.devices("cpu")[0]
    n_blocks = 0
    for alpha in (True, False):
        buf = etc1s_file(rng, endpoints, selectors, sizes.etc1s_parity_side, alpha)
        got = (read_images("rgba", buf), read_images("etc1", buf))
        with jax.default_device(cpu):
            want = (read_images("rgba", buf), read_images("etc1", buf))
        for g, w, label in zip(got, want, ("read_to_rgba", "read_to_etc1")):
            check_images(g, [img.data for img in w], f"{label} alpha={alpha}")
        n_blocks += sum(img.data.size for img in got[1]) // 8
    # one small file against the independent sequential oracle
    e_small, s_small = random_codebooks(rng, 64, 48)
    buf = etc1s_file(rng, e_small, s_small, 64, alpha=True)
    rgba = read_images("rgba", buf)
    check_images(rgba, [np.array(p, np.uint8).reshape(-1) for _, _, p in oracle_read_to_rgba(buf)],
                 "oracle read_to_rgba")
    etc1 = read_images("etc1", buf)
    check_images(etc1, [np.frombuffer(b, np.uint8) for _, _, b in oracle_read_to_etc1(buf)],
                 "oracle read_to_etc1")
    return (
        f"{sizes.codebook}+{sizes.codebook}-entry codebooks, {sizes.etc1s_parity_side}^2 mip chains "
        f"with and without alpha pairing ({n_blocks} ETC1 blocks): device == host CPU backend; "
        "64^2 alpha file == oracle_etc1s"
    )


@dataclass
class Corpus:
    uastc: list  # UastcTexture
    etc1s: list  # ETC1S .basis bytes, alpha-paired, full mip chains


def build_corpus(seed: int, sizes: Sizes, out: dict) -> str:
    """The phase-5 corpus, made from seeds on the host (set-up, not timed
    with the transcode)."""
    import numpy as np

    uastc = uastc_corpus(seed + 2, sizes.uastc_textures, sizes.uastc_side)
    rng = np.random.default_rng(seed + 3)
    endpoints, selectors = random_codebooks(rng, sizes.codebook, sizes.codebook)
    etc1s = [etc1s_file(rng, endpoints, selectors, sizes.etc1s_side, alpha=True)
             for _ in range(sizes.etc1s_textures)]
    out["corpus"] = Corpus(uastc, etc1s)
    mb = (sum(len(t.buf) for t in uastc) + sum(len(b) for b in etc1s)) / 1e6
    return (
        f"{sizes.uastc_textures} UASTC + {sizes.etc1s_textures} ETC1S .basis files "
        f"of {sizes.uastc_side}^2 / {sizes.etc1s_side}^2 with full mip chains, {mb:.1f} MB"
    )


def warm_corpus(corpus: Corpus) -> None:
    """Compile every program the corpus phase runs: the per-mode programs
    at one texture's and at the whole corpus's group sizes, and the ETC1S
    readers."""
    import numpy as np

    g_in = golden()["bc7_in"]
    one = mode_buckets(g_in[corpus.uastc[0].choice])
    whole = mode_buckets(g_in[np.concatenate([t.choice for t in corpus.uastc])])
    warm_programs([(t, m, rows, None) for t in TARGETS for m, rows in one.items()]
                  + [("bc7", m, rows, None) for m, rows in whole.items()])
    read_images("rgba", corpus.etc1s[0])
    read_images("etc1", corpus.etc1s[0])


def _timed_passes(fn) -> tuple[float, float]:
    """(checked pass s, warm unchecked pass s) of fn(check: bool)."""
    t0 = time.perf_counter()
    fn(True)
    first = time.perf_counter() - t0
    t0 = time.perf_counter()
    fn(False)
    return first, time.perf_counter() - t0


def phase_corpus(corpus: Corpus, sizes: Sizes) -> str:
    import jax
    import numpy as np

    from basisu_rs_jax.models import BasisCorpusPipeline, CorpusTranscoder

    n_blocks = sum(len(t.choice) for t in corpus.uastc)
    parts = []
    for target in TARGETS:
        def run(check, target=target):
            for i, tex in enumerate(corpus.uastc):
                imgs = read_images(target, tex.buf)
                if check:
                    check_images(imgs, expected_images(tex, target), f"read_to_{target} texture {i}")
        _, warm = _timed_passes(run)
        parts.append(f"{target} {warm:.2f} s ({n_blocks / warm / 1e6:.2f} Mblk/s)")

    slices = [
        np.frombuffer(img.data, np.uint8).reshape(-1, 16)
        for tex in corpus.uastc for img in read_images("uastc", tex.buf)
    ]
    t0 = time.perf_counter()
    outs = CorpusTranscoder("bc7").transcode_slices(slices)
    t_ct = time.perf_counter() - t0
    check_images(outs, [w for tex in corpus.uastc for w in expected_images(tex, "bc7")],
                 "CorpusTranscoder bc7")
    with tempfile.TemporaryDirectory() as td:
        paths = []
        for i, tex in enumerate(corpus.uastc):
            path = Path(td) / f"u{i}.basis"
            path.write_bytes(tex.buf)
            paths.append(path)
        pipe = BasisCorpusPipeline("etc2", workers=8)
        t0 = time.perf_counter()
        results = list(pipe.run(paths))
        t_pipe = time.perf_counter() - t0
        if pipe.errors or len(results) != len(corpus.uastc):
            raise AssertionError(f"pipeline: {len(results)} results, errors {pipe.errors[:2]}")
        for r, tex in zip(results, corpus.uastc):
            check_images(r.images, expected_images(tex, "etc2"), f"pipeline {r.path}")

    cpu = jax.devices("cpu")[0]
    e_blocks = 0
    for i, buf in enumerate(corpus.etc1s):
        got = (read_images("rgba", buf), read_images("etc1", buf))
        with jax.default_device(cpu):
            want = (read_images("rgba", buf), read_images("etc1", buf))
        for g, w, label in zip(got, want, ("rgba", "etc1")):
            check_images(g, [img.data for img in w], f"ETC1S {label} texture {i}")
        e_blocks += sum(img.data.size for img in got[1]) // 8

    def run_etc1s(check):
        for buf in corpus.etc1s:
            read_images("rgba", buf)
            read_images("etc1", buf)

    _, e_warm = _timed_passes(run_etc1s)
    peak = jax.devices()[0].memory_stats() or {}
    return (
        f"UASTC {len(corpus.uastc)} x {sizes.uastc_side}^2 + mips = {n_blocks} blocks, "
        "warm read_to_*: " + ", ".join(parts)
        + f"; CorpusTranscoder bc7 {t_ct:.2f} s; BasisCorpusPipeline etc2 {t_pipe:.2f} s; "
        f"ETC1S {len(corpus.etc1s)} x {sizes.etc1s_side}^2 + mips, alpha-paired "
        f"({e_blocks} ETC1 blocks): warm read_to_rgba+etc1 {e_warm:.2f} s; every output "
        f"verified; peak_bytes_in_use {peak.get('peak_bytes_in_use')}"
    )


class _Tally:
    def __init__(self):
        self.passed = self.failed = self.skipped = 0

    def pytest_runtest_logreport(self, report):
        if report.when == "call" and report.passed:
            self.passed += 1
        elif report.failed:
            self.failed += 1
        elif report.skipped:
            self.skipped += 1


def phase_gpu_tests() -> str:
    import pytest

    tally = _Tally()
    rc = pytest.main(
        ["-q", "-m", "gpu", "-p", "no:cacheprovider", str(ROOT / "tests")],
        plugins=[tally],
    )
    if rc != 0 or tally.failed or tally.skipped or not tally.passed:
        raise AssertionError(
            f"pytest rc {rc}: {tally.passed} passed, {tally.failed} failed, {tally.skipped} skipped"
        )
    return f"{tally.passed} gpu-marked tests passed"


def warm_four_cards(corpus: Corpus) -> None:
    """The per-mode programs of the four-card phase at one texture's group
    sizes, on one card and on four."""
    from basisu_rs_jax.parallel.mesh import make_mesh

    mesh = make_mesh(4)
    one = mode_buckets(golden()["bc7_in"][corpus.uastc[0].choice])
    warm_programs([(t, m, rows, on) for t in TARGETS for m, rows in one.items()
                   for on in (None, mesh)])


def _both(label: str, one_fn, four_fn, times: dict):
    """Run the one-card and four-card forms, time each, return both."""
    t0 = time.perf_counter()
    one = one_fn()
    t1 = time.perf_counter()
    four = four_fn()
    t2 = time.perf_counter()
    prev = times.get(label, (0.0, 0.0))
    times[label] = (prev[0] + t1 - t0, prev[1] + t2 - t1)
    return one, four


def phase_four_cards(corpus: Corpus, sizes: Sizes) -> str:
    """The four user paths on a 4-GPU mesh - read_to_*(mesh=), which runs
    sharded_transcode (UASTC) and sharded_etc1s_transcode (ETC1S), those
    two directly, and the CLI's --mesh 4 - against the same work on one
    card, on the phase-5 corpus."""
    import numpy as np

    from basisu_rs_jax.__main__ import main as cli_main
    from basisu_rs_jax.container import basis as basis_mod
    from basisu_rs_jax.ops import transcode_blocks
    from basisu_rs_jax.ops.etc1s import run_etc1s_etc1, run_etc1s_rgba
    from basisu_rs_jax.parallel.mesh import make_mesh, sharded_etc1s_transcode, sharded_transcode

    mesh = make_mesh(4)
    times: dict = {}
    g_in = golden()["bc7_in"]
    blocks = g_in[corpus.uastc[0].choice]
    for target in TARGETS:
        one, four = _both(f"sharded_transcode {target}", lambda: transcode_blocks(blocks, target),
                          lambda: sharded_transcode(blocks, target, mesh), times)
        for a, b in zip(one, four):
            if not np.array_equal(a, b):
                raise AssertionError(f"sharded_transcode {target} differs from one card")
    for target in TARGETS:
        for i, tex in enumerate(corpus.uastc):
            one, four = _both(f"read_to_{target}", lambda: read_images(target, tex.buf),
                              lambda: read_images(target, tex.buf, mesh), times)
            check_images(four, [img.data for img in one], f"read_to_{target}(mesh) texture {i}")
            if i == 0:
                check_images(one, expected_images(tex, target), f"read_to_{target} texture 0")
    for target in ("rgba", "etc1"):
        for i, buf in enumerate(corpus.etc1s):
            one, four = _both(f"ETC1S read_to_{target}", lambda: read_images(target, buf),
                              lambda: read_images(target, buf, mesh), times)
            check_images(four, [img.data for img in one], f"ETC1S read_to_{target}(mesh) {i}")

    buf = corpus.etc1s[0]
    header = basis_mod.read_header(buf)
    dec = basis_mod.make_etc1s_decoder(header, buf)
    streams = [dec.decode_slice(d.num_blocks_x, d.num_blocks_y, d.data(buf))
               for d in basis_mod.read_slice_descs(buf, header)]
    ep, sel = (np.concatenate([getattr(s, f) for s in streams[0::2]])
               for f in ("endpoint_index", "selector_index"))
    a_ep, a_sel = (np.concatenate([getattr(s, f) for s in streams[1::2]])
                   for f in ("endpoint_index", "selector_index"))
    books = (dec.endpoints, dec.selectors)
    for kind, single, extra in (
        ("rgba", lambda: run_etc1s_rgba(*books, ep, sel), ()),
        ("rgba_alpha", lambda: run_etc1s_rgba(*books, ep, sel, (a_ep, a_sel)), (a_ep, a_sel)),
        ("etc1", lambda: run_etc1s_etc1(*books, ep, sel), ()),
    ):
        one, four = _both(f"sharded_etc1s_transcode {kind}", single,
                          lambda: sharded_etc1s_transcode(kind, *books, ep, sel, mesh,
                                                          extra_idx=extra), times)
        if not np.array_equal(one, four):
            raise AssertionError(f"sharded_etc1s_transcode {kind} differs from one card")

    with tempfile.TemporaryDirectory() as td:
        for label, data, targets in (("uastc", corpus.uastc[0].buf, ("bc7", "rgba")),
                                     ("etc1s", corpus.etc1s[0], ("rgba", "etc1"))):
            src = Path(td) / f"{label}.basis"
            src.write_bytes(data)
            for target in targets:
                outs = []
                for mesh_n in (0, 4):
                    out = Path(td) / f"{label}_{target}_{mesh_n}"
                    argv = ["transcode", "--target", target, str(src), "-o", str(out)]
                    if mesh_n:
                        argv += ["--mesh", str(mesh_n)]
                    with contextlib.redirect_stdout(io.StringIO()):  # per-file lines
                        rc = cli_main(argv)
                    if rc != 0:
                        raise AssertionError(f"CLI {' '.join(argv)} failed")
                    outs.append({q.name: q.read_bytes() for q in sorted(out.iterdir())})
                if outs[0] != outs[1]:
                    raise AssertionError(f"CLI --mesh 4 output differs for {label} -> {target}")
    return "all paths match one card bit for bit; seconds one card / four cards: " + ", ".join(
        f"{k} {a:.2f}/{b:.2f}" for k, (a, b) in times.items()
    )


# ---------------------------------------------------------------------------


def _fail(msg: str, device=None) -> int:
    out = {"ok": False, "error": msg}
    if device:
        out["device"] = device
    print(json.dumps(out), flush=True)
    return 1


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--four-cards", action="store_true",
                    help="run only the 4-GPU mesh paths against one card")
    args = ap.parse_args(argv)

    try:
        import jax

        sys.path[:0] = [str(ROOT), str(ROOT / "tests")]
        from basisu_rs_jax.utils.compile_cache import configure
        from basisu_rs_jax.utils.device import jax_device, nvidia_smi_name_power
    except ImportError as e:
        return _fail(f"cannot import the transcoder: {e}")

    device = jax_device()
    if device["platform"] != "gpu":
        return _fail(f"JAX found no GPU (default platform {device['platform']!r})", device)
    want = 4 if args.four_cards else 1
    if device["count"] < want:
        return _fail(f"need {want} GPU(s), JAX sees {device['count']}", device)
    configure()
    card = nvidia_smi_name_power()
    print(card, flush=True)
    print(f"JAX {jax.__version__}: {device}", flush=True)

    run = Runner(CompileClock())
    data: dict = {}
    if args.four_cards:
        run.phase("corpus-data", build_corpus, args.seed, FULL, data)
        if "corpus" in data:
            run.phase("four-cards", phase_four_cards, data["corpus"], FULL,
                      warm=lambda: warm_four_cards(data["corpus"]))
    else:
        run.phase("device", phase_device, card, device)
        run.phase("golden", phase_golden, warm=warm_golden)
        run.phase("fuzz", phase_fuzz, args.seed, FULL, warm=lambda: warm_fuzz(args.seed, FULL))
        run.phase("etc1s", phase_etc1s, args.seed, FULL)
        run.phase("corpus-data", build_corpus, args.seed, FULL, data)
        if "corpus" in data:
            run.phase("corpus", phase_corpus, data["corpus"], FULL,
                      warm=lambda: warm_corpus(data["corpus"]))
        run.phase("gpu-tests", phase_gpu_tests)
    if run.failed:
        return _fail(f"phases failed: {', '.join(run.failed)}", device)
    print(json.dumps({"ok": True, "device": {
        "platform": device["platform"], "kind": device["kind"], "count": device["count"],
    }}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
