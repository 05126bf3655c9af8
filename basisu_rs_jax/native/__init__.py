"""Native (C++) host runtime: CRC-16 and the ETC1S entropy front-end.

Self-bootstrapping: the shared library is compiled from the committed
etc1s.cpp with g++ on first import, into build/ beside the source, under a
name keyed by a hash of the source and flags - a library built from other
source is never loaded.  If no toolchain is available the import fails and
callers fall back to the pure-Python implementations, which are the
behavioral reference.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import subprocess
from pathlib import Path

import numpy as np

_DIR = Path(__file__).parent
_SRC = _DIR / "etc1s.cpp"
_FLAGS = ("-O3", "-fPIC", "-shared", "-std=c++17")


def library_path() -> Path:
    key = hashlib.sha256(_SRC.read_bytes() + " ".join(_FLAGS).encode()).hexdigest()
    return _DIR / "build" / f"_etc1s-{key[:16]}.so"


def _build(so: Path) -> None:
    so.parent.mkdir(exist_ok=True)
    # build under a private name, then rename: concurrent importers (test
    # workers, pipeline processes) never load a half-written library
    tmp = so.with_name(f"{so.name}.{os.getpid()}.tmp")
    try:
        subprocess.run(
            ["g++", *_FLAGS, "-o", str(tmp), str(_SRC)], check=True, capture_output=True
        )
        os.replace(tmp, so)
    finally:
        tmp.unlink(missing_ok=True)


def _load() -> ctypes.CDLL:
    so = library_path()
    if not so.exists():
        _build(so)
    lib = ctypes.CDLL(str(so))
    lib.basisu_crc16.restype = ctypes.c_uint16
    lib.basisu_crc16.argtypes = [ctypes.c_char_p, ctypes.c_size_t, ctypes.c_uint16]
    lib.etc1s_decode_endpoints.restype = ctypes.c_int
    lib.etc1s_decode_endpoints.argtypes = [
        ctypes.c_char_p, ctypes.c_size_t, ctypes.c_int, ctypes.c_void_p,
    ]
    lib.etc1s_decode_selectors.restype = ctypes.c_int
    lib.etc1s_decode_selectors.argtypes = [
        ctypes.c_char_p, ctypes.c_size_t, ctypes.c_int, ctypes.c_void_p,
    ]
    lib.etc1s_create.restype = ctypes.c_void_p
    lib.etc1s_create.argtypes = [
        ctypes.c_char_p, ctypes.c_size_t, ctypes.c_int, ctypes.c_int, ctypes.c_int,
    ]
    lib.etc1s_destroy.argtypes = [ctypes.c_void_p]
    lib.etc1s_history_size.restype = ctypes.c_uint32
    lib.etc1s_history_size.argtypes = [ctypes.c_void_p]
    lib.etc1s_decode_slice.restype = ctypes.c_int
    lib.etc1s_decode_slice.argtypes = [
        ctypes.c_void_p, ctypes.c_char_p, ctypes.c_size_t,
        ctypes.c_int, ctypes.c_int, ctypes.c_void_p, ctypes.c_void_p,
    ]
    lib.etc1s_calib.restype = ctypes.c_uint64
    lib.etc1s_calib.argtypes = [ctypes.c_uint64]
    return lib


if os.environ.get("BASISU_NO_NATIVE"):
    raise ImportError("native runtime disabled via BASISU_NO_NATIVE")

try:
    _LIB = _load()
except (subprocess.CalledProcessError, OSError, FileNotFoundError) as e:  # pragma: no cover
    raise ImportError(f"native runtime unavailable: {e}") from e


class NativeError(ValueError):
    pass


_ERRORS = {
    -2: "Code lengths are invalid, codes don't fit into 16 bits",
    -3: "No matching code found in the decoding table",
    -4: "invalid repeat code in code-length stream",
    -5: "VLC overflow",
    -6: "Global/hybrid selector codebooks are not supported",
    -7: "predictor references out-of-bounds neighbor",
    -8: "history buffer reference invalid",
    -9: "decoded index out of codebook range",
}


def _check(rc: int) -> None:
    if rc != 0:
        raise NativeError(_ERRORS.get(rc, f"native error {rc}"))


def crc16_native(data, crc: int = 0) -> int:
    buf = bytes(data)
    return int(_LIB.basisu_crc16(buf, len(buf), crc))


def calib_native(iters: int) -> int:
    """Fixed decode-profile integer workload (GIL held briefly by ctypes, the
    loop itself is pure C): the machine-speed denominator for the
    contention-aware front-end perf guard."""
    return int(_LIB.etc1s_calib(iters))


def decode_endpoints_native(num_endpoints: int, data: bytes) -> np.ndarray:
    out = np.zeros((num_endpoints, 4), np.uint8)
    _check(
        _LIB.etc1s_decode_endpoints(
            bytes(data), len(data), num_endpoints, out.ctypes.data_as(ctypes.c_void_p)
        )
    )
    return out


def decode_selectors_native(num_selectors: int, data: bytes) -> np.ndarray:
    out = np.zeros((num_selectors, 4), np.uint8)
    _check(
        _LIB.etc1s_decode_selectors(
            bytes(data), len(data), num_selectors, out.ctypes.data_as(ctypes.c_void_p)
        )
    )
    return out


class NativeEtc1sModels:
    """Owns the native decoder handle (Huffman models + history config)."""

    def __init__(self, tables: bytes, num_endpoints: int, num_selectors: int, is_video: bool):
        self._h = _LIB.etc1s_create(
            bytes(tables), len(tables), num_endpoints, num_selectors, int(is_video)
        )
        if not self._h:
            raise NativeError("failed to parse ETC1S Huffman tables")

    @property
    def history_size(self) -> int:
        return int(_LIB.etc1s_history_size(self._h))

    def decode_slice(self, nbx: int, nby: int, data: bytes):
        n = nbx * nby
        ep = np.zeros(n, np.uint16)
        sel = np.zeros(n, np.uint16)
        _check(
            _LIB.etc1s_decode_slice(
                self._h, bytes(data), len(data), nbx, nby,
                ep.ctypes.data_as(ctypes.c_void_p), sel.ctypes.data_as(ctypes.c_void_p),
            )
        )
        return ep, sel

    def __del__(self):
        h = getattr(self, "_h", None)
        # _LIB can already be torn down to None at interpreter exit
        if h and _LIB is not None:
            _LIB.etc1s_destroy(h)
            self._h = None
