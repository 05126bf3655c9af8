"""Corpus pipeline: overlapped host parse + device transcode over many files.

The production data-path for asset corpora / ML pipelines: a thread pool runs
the host-side stages (file read, container parse, ETC1S entropy front-end -
all GIL-releasing numpy/C++ work) while the main thread streams dense block
batches to the device kernels.  Progress is checkpointable: the pipeline can
be resumed from a `done` set (the analog of checkpoint/resume for a
single-pass batch workload).
"""

from __future__ import annotations

from concurrent.futures import ThreadPoolExecutor
from dataclasses import dataclass, field
from pathlib import Path

import numpy as np

from ..api import BasisError
from ..container import basis as basis_mod
from ..utils.profiling import Profiler
from .transcoder import UastcTranscoder


@dataclass
class FileResult:
    path: str
    images: list  # list of Image
    texels: int


@dataclass
class PipelineState:
    """Resumable progress marker."""

    done: set = field(default_factory=set)

    def mark(self, path: str) -> None:
        self.done.add(str(path))

    def pending(self, paths) -> list:
        return [p for p in paths if str(p) not in self.done]


class BasisCorpusPipeline:
    """Transcode a corpus of .basis files with host/device overlap.

    UASTC files route through the mode-partitioned batch transcoder; ETC1S
    files run the sequential front-end on worker threads and the palette
    kernels on device.  Files that fail validation are reported, not fatal.
    """

    def __init__(self, target: str, workers: int = 4, mesh=None):
        self.target = target
        self.workers = workers
        self.mesh = mesh  # optional jax.sharding.Mesh for multi-chip runs
        self.transcoder = UastcTranscoder(target) if target != "_parse_only" else None
        self.profiler = Profiler()

    # -- host-side stage (runs on worker threads) ---------------------------
    def _parse(self, path):
        with self.profiler.stage("host/parse+crc"):
            buf = Path(path).read_bytes()
            header = basis_mod.read_header(buf)
            if not basis_mod.check_file_checksum(buf, header):
                raise BasisError("Data CRC16 failed")
        return path, buf, header

    # -- full pipeline ------------------------------------------------------
    def run(self, paths, state: PipelineState | None = None):
        """Yields FileResult per file (skipping state.done); errors yield
        (path, exception) tuples via the `errors` list attribute."""
        state = state or PipelineState()
        todo = state.pending(paths)
        self.errors: list = []

        readers = {
            "rgba": basis_mod.read_to_rgba,
            "astc": basis_mod.read_to_astc,
            "bc7": basis_mod.read_to_bc7,
            "etc1": basis_mod.read_to_etc1,
            "etc2": basis_mod.read_to_etc2,
            "uastc": basis_mod.read_to_uastc,
        }
        reader = readers[self.target]

        with ThreadPoolExecutor(self.workers) as pool:
            parsed = pool.map(self._guard(self._parse), todo)
            for item in parsed:
                if isinstance(item, tuple) and len(item) == 2 and isinstance(item[1], Exception):
                    self.errors.append(item)
                    continue
                path, buf, header = item
                try:
                    # read_to_* spans host container parse + (for ETC1S) the
                    # entropy front-end + device kernels; label it honestly.
                    with self.profiler.stage("file/transcode"):
                        if self.mesh is not None and self.target != "uastc":
                            result = reader(buf, mesh=self.mesh)
                        else:
                            result = reader(buf)
                    images = result[1] if self.target == "rgba" else result
                    texels = sum(int(i.w) * int(i.h) for i in images)
                    state.mark(path)
                    yield FileResult(str(path), images, texels)
                except Exception as e:  # noqa: BLE001 - per-file isolation
                    self.errors.append((str(path), e))

    @staticmethod
    def _guard(fn):
        def wrapped(path):
            try:
                return fn(path)
            except Exception as e:  # noqa: BLE001
                return (str(path), e)

        return wrapped
