"""High-level transcoder pipelines.

This is the production layer a pipeline integrates with: it owns device
placement, mode partitioning, multi-slice batching, optional mesh sharding,
and profiling counters.  The file-level `read_to_*` functions are thin
wrappers for reference-API parity; these classes are the batch surface for
corpus-scale work.
"""

from __future__ import annotations

from dataclasses import dataclass

import jax.numpy as jnp
import numpy as np

from ..api import BasisError
from ..ops.bits import bytes_from_lanes_np, lanes_from_bytes_np
from ..ops.dispatch import (
    INVALID_MODE,
    _REGISTRY,
    _bucket,
    _ensure_registered,
    _mode_kernel,
    block_modes,
)
from ..utils.profiling import Profiler

@dataclass
class TranscodeResult:
    """Device-side result of a batch transcode: per-mode groups + scatter
    metadata.  `gather()` materializes host output in original block order."""

    n: int
    out_words: int
    target: str
    groups: list  # (host indices, valid_count, device out, device err)
    invalid: np.ndarray

    def gather(self):
        out = np.zeros((self.n, self.out_words), np.uint32)
        err = self.invalid.copy()
        for idx, m, o, e in self.groups:
            out[idx] = np.asarray(o)[:m]
            err[idx] |= np.asarray(e)[:m]
        if self.target == "rgba":
            return out, err
        return bytes_from_lanes_np(out), err


class UastcTranscoder:
    """Mode-partitioned batch transcoder for UASTC blocks.

    Keeps per-mode kernels warm, dispatches all groups asynchronously, and
    reports per-stage throughput via `.profiler`.
    """

    def __init__(self, target: str):
        _ensure_registered()
        if target not in _REGISTRY:
            raise BasisError(f"unknown target {target!r}")
        self.target = target
        self.out_words = _REGISTRY[target][1]
        self.profiler = Profiler()

    def transcode_async(self, blocks_u8: np.ndarray) -> TranscodeResult:
        """Partition + dispatch; returns without waiting for device work."""
        blocks_u8 = np.ascontiguousarray(blocks_u8, np.uint8).reshape(-1, 16)
        n = blocks_u8.shape[0]
        with self.profiler.stage("host/partition", texels=n * 16):
            modes = block_modes(blocks_u8)
            lanes = lanes_from_bytes_np(blocks_u8, 4)
            order = np.argsort(modes, kind="stable")
            sorted_modes = modes[order]
            boundaries = np.searchsorted(sorted_modes, np.arange(20))
        groups = []
        with self.profiler.stage("device/dispatch", texels=n * 16):
            for mode_id in range(19):
                lo, hi = boundaries[mode_id], boundaries[mode_id + 1]
                if lo == hi:
                    continue
                idx = order[lo:hi]
                # power-of-two buckets, as in dispatch.transcode_blocks:
                # each new group size would otherwise compile a new kernel
                group = np.zeros((_bucket(hi - lo), 4), np.uint32)
                group[: hi - lo] = lanes[idx]
                o, e = _mode_kernel(self.target, mode_id)(jnp.asarray(group))
                groups.append((idx, hi - lo, o, e))
        return TranscodeResult(n, self.out_words, self.target, groups, modes == INVALID_MODE)

    def transcode(self, blocks_u8: np.ndarray):
        """Synchronous host-to-host transcode: (out, err) numpy arrays."""
        res = self.transcode_async(blocks_u8)
        with self.profiler.stage("host/gather", texels=res.n * 16):
            return res.gather()

class CorpusTranscoder:
    """Multi-file / multi-slice (mipmapped) batch pipeline.

    Concatenates the blocks of many slices into one large batch so that small
    mip levels ride along with base levels in the same per-mode kernels, then
    splits results back per slice.  Slice boundaries are host metadata only -
    the device sees one dense batch.
    """

    def __init__(self, target: str):
        self.inner = UastcTranscoder(target)

    def transcode_slices(self, slices: list[np.ndarray]):
        """slices: list of uint8 [n_i, 16] block arrays.
        Returns list of per-slice outputs (same dtype rules as transcode)."""
        counts = [np.asarray(s).reshape(-1, 16).shape[0] for s in slices]
        batch = np.concatenate([np.asarray(s).reshape(-1, 16) for s in slices], axis=0)
        out, err = self.inner.transcode(batch)
        if err.any():
            raise BasisError(f"{int(err.sum())} invalid blocks in corpus batch")
        outs = []
        ofs = 0
        for c in counts:
            outs.append(out[ofs : ofs + c])
            ofs += c
        return outs

    @property
    def profiler(self) -> Profiler:
        return self.inner.profiler


@dataclass
class Etc1sFileWork:
    """One .basis file's decoded ETC1S state, ready for cross-file batching:
    its codebook pair plus per-slice index streams (and, for the RGBA
    target, the optional paired alpha-slice streams)."""

    endpoints: np.ndarray  # [E, 4] uint8
    selectors: np.ndarray  # [S, 4] uint8 packed selector rows
    slices: list  # [(ep_idx, sel_idx)] int arrays, one per slice
    alpha_slices: list | None = None  # parallel list for RGBA alpha pairing


def _batch_etc1s_files(files: list, with_alpha: bool):
    """Concatenate many files' codebooks + index streams into ONE gather
    space: file f's indices shift by its codebook base, so the palette
    gather cannot tell the batch from a single huge file.  Returns
    (endpoints, selectors, ep_idx, sel_idx, alpha_pair_or_None, counts)
    with counts = per-(file, slice) block counts in input order."""
    ep_books, sel_books = [], []
    ep_base = sel_base = 0
    eps, sels, a_eps, a_sels, counts = [], [], [], [], []
    for fw in files:
        e = np.asarray(fw.endpoints, np.uint8)
        s = np.asarray(fw.selectors, np.uint8)
        ep_books.append(e)
        sel_books.append(s)
        a_slices = fw.alpha_slices if with_alpha else [None] * len(fw.slices)
        if with_alpha and (fw.alpha_slices is None or len(fw.alpha_slices) != len(fw.slices)):
            raise BasisError("alpha_slices must pair 1:1 with slices")
        for (ep_i, sel_i), a in zip(fw.slices, a_slices):
            ep_i = np.asarray(ep_i, np.int32)
            sel_i = np.asarray(sel_i, np.int32)
            if with_alpha and (len(a[0]) != len(ep_i) or len(a[1]) != len(sel_i)):
                raise BasisError("RGB slice and Alpha slice have different dimensions")
            counts.append(len(ep_i))
            eps.append(ep_i + ep_base)
            sels.append(sel_i + sel_base)
            if with_alpha:
                a_eps.append(np.asarray(a[0], np.int32) + ep_base)
                a_sels.append(np.asarray(a[1], np.int32) + sel_base)
        ep_base += e.shape[0]
        sel_base += s.shape[0]
    endpoints = np.concatenate(ep_books, axis=0)
    selectors = np.concatenate(sel_books, axis=0)
    alpha = (np.concatenate(a_eps), np.concatenate(a_sels)) if with_alpha else None
    return endpoints, selectors, np.concatenate(eps), np.concatenate(sels), alpha, counts


class Etc1sMultiCorpusTranscoder:
    """Cross-FILE ETC1S batching: slices from MANY .basis files, each with
    its own codebook pair, ride one device launch per target (two for the
    RGBA target when the corpus mixes alpha-paired and RGB-only files -
    alpha pairing selects the fused kernel, which needs a uniform batch).

    This removes the per-file launch floor of corpus work: the reference
    decodes file by file (basis.rs:8-86); Etc1sCorpusTranscoder batches the
    slices WITHIN one file (shared codebook); this class batches the corpus.
    Codebooks concatenate along the entry axis and every file's index
    streams shift by its codebook base - the palette gather cannot tell the
    difference (parity pinned in tests/test_pipeline.py)."""

    def __init__(self, target: str = "rgba"):
        if target not in ("rgba", "etc1"):
            raise BasisError(f"unsupported ETC1S corpus target {target!r}")
        self.target = target
        self.profiler = Profiler()

    def transcode_files(self, files: list, device: bool = False) -> list:
        """files: list of Etc1sFileWork.  Returns one list per file of
        per-slice outputs (uint32 [n_i, 16] packed RGBA or [n_i, 2] ETC1
        lanes), in input order.  device=True keeps outputs device-resident
        (no D2H) for on-device downstream consumers."""
        from ..ops.etc1s import run_etc1s_etc1, run_etc1s_rgba

        if not files:
            return []
        # A zero-slice file contributes nothing to any launch (and an
        # all-empty group would hit np.concatenate([]) in the batcher):
        # answer [] for it and batch only the files with work.
        work = [fw for fw in files if fw.slices]
        if not work:
            return [[] for _ in files]
        if self.target == "etc1":
            groups = [(work, False)]
        else:
            with_a = [fw for fw in work if fw.alpha_slices is not None]
            without_a = [fw for fw in work if fw.alpha_slices is None]
            groups = [(g, bool(a)) for g, a in ((with_a, True), (without_a, False)) if g]

        out_by_id = {}
        for group, with_alpha in groups:
            endpoints, selectors, ep, sel, alpha, counts = _batch_etc1s_files(
                group, with_alpha
            )
            n = sum(counts)
            with self.profiler.stage(f"device/etc1s_{self.target}", texels=n * 16):
                if self.target == "rgba":
                    out = run_etc1s_rgba(endpoints, selectors, ep, sel, alpha, device=device)
                else:
                    out = run_etc1s_etc1(endpoints, selectors, ep, sel, device=device)
            ofs = k = 0
            for fw in group:
                per_slice = []
                for _ in fw.slices:
                    per_slice.append(out[ofs : ofs + counts[k]])
                    ofs += counts[k]
                    k += 1
                out_by_id[id(fw)] = per_slice
        return [out_by_id[id(fw)] if fw.slices else [] for fw in files]


class Etc1sCorpusTranscoder:
    """ETC1S analog of CorpusTranscoder: many slices whose index streams
    share ONE codebook pair (a .basis file's endpoints/selectors) batch into
    a single device dispatch per target, then split back per slice.  The
    file-level readers (container/basis.py read_to_rgba / read_to_etc1) use
    the same batching inline; this class is the corpus-scale surface for
    pipelines that hold decoded index streams directly.
    Reference being batched: the per-slice loops of basis.rs:26-86.
    """

    def __init__(self, endpoints: np.ndarray, selectors: np.ndarray, target: str = "rgba"):
        if target not in ("rgba", "etc1"):
            raise BasisError(f"unsupported ETC1S corpus target {target!r}")
        self.endpoints = np.asarray(endpoints, np.uint8)
        self.selectors = np.asarray(selectors, np.uint8)
        self.target = target
        self.profiler = Profiler()

    def transcode_slices(self, slices: list, alpha_slices: list | None = None):
        """slices: list of (ep_idx, sel_idx) int index arrays (one per slice);
        alpha_slices: optional parallel list for the RGBA target's paired
        alpha pass (same lengths as `slices`).
        Returns a list of per-slice outputs: uint32 [n_i, 16] packed RGBA
        texels, or uint32 [n_i, 2] ETC1 lanes."""
        from ..ops.etc1s import run_etc1s_etc1, run_etc1s_rgba

        counts = [len(ep) for ep, _ in slices]
        n = sum(counts)
        ep = np.concatenate([np.asarray(e) for e, _ in slices])
        sel = np.concatenate([np.asarray(s) for _, s in slices])
        with self.profiler.stage(f"device/etc1s_{self.target}", texels=n * 16):
            if self.target == "rgba":
                alpha_pass = None
                if alpha_slices is not None:
                    a_counts = [len(e) for e, _ in alpha_slices]
                    if a_counts != counts:
                        raise BasisError(
                            "RGB slice and Alpha slice have different dimensions"
                        )
                    alpha_pass = (
                        np.concatenate([np.asarray(e) for e, _ in alpha_slices]),
                        np.concatenate([np.asarray(s) for _, s in alpha_slices]),
                    )
                out = run_etc1s_rgba(self.endpoints, self.selectors, ep, sel, alpha_pass)
            else:
                out = run_etc1s_etc1(self.endpoints, self.selectors, ep, sel)
        outs = []
        ofs = 0
        for c in counts:
            outs.append(out[ofs : ofs + c])
            ofs += c
        return outs
