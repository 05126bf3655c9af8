"""Public API surface mirroring the reference crate (src/lib.rs:29-79).

Block-level functions raise `BasisError` exactly where the reference returns
`Err` (invalid mode index, invalid pattern index).  The batch function is the
extension: it transcodes N blocks in one call via mode-partitioned device
kernels.
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np

from .ops import transcode_blocks


class BasisError(ValueError):
    """Transcode/parse failure (reference: Error = String, src/lib.rs:26)."""


@dataclass
class Image:
    """Decoded image plane (reference: src/lib.rs:63-79).

    `stride` is in elements of `data` per row; `data` is a flat numpy array
    (uint8 bytes for block formats and RGBA byte output).
    """

    w: int
    h: int
    stride: int
    data: np.ndarray

    def into_rgba_bytes(self) -> "Image":
        """Image of packed RGBA u32 texel words -> Image of RGBA bytes
        (reference: Image<Color32>::into_rgba_bytes, src/lib.rs:70-79).

        The container-level `read_to_rgba` already yields byte images; this
        accessor covers block-level results (uint32 words from
        `unpack_uastc_block_to_rgba` / batch 'rgba' output).  Byte images
        pass through unchanged."""
        if self.data.dtype == np.uint8:
            return self
        data = np.ascontiguousarray(self.data.astype("<u4")).view(np.uint8).reshape(-1)
        return Image(w=self.w, h=self.h, stride=self.stride * 4, data=data)


def _one_block(data) -> np.ndarray:
    arr = np.frombuffer(bytes(data), np.uint8) if not isinstance(data, np.ndarray) else data
    arr = arr.astype(np.uint8).reshape(-1)
    if arr.size != 16:
        raise BasisError("UASTC block must be 16 bytes")
    return arr[None, :]


def transcode_uastc_blocks(blocks, target: str):
    """Batch transcode: uint8 [N,16] UASTC blocks -> (out, err mask).

    target in {'rgba','astc','bc7','etc1','etc2'}; out is uint32 [N,16]
    packed texels for 'rgba', else uint8 block bytes.
    """
    return transcode_blocks(blocks, target)


def _single(data, target: str):
    block = _one_block(data)
    out, err = transcode_blocks(block, target)
    if err[0]:
        # distinguish the reference's two block-level failure modes
        # (uastc.rs:336 "invalid mode index", uastc.rs:364 "block pattern is
        # not valid")
        from .ops.dispatch import INVALID_MODE, block_modes

        if block_modes(block)[0] == INVALID_MODE:
            raise BasisError("invalid mode index")
        raise BasisError("block pattern is not valid")
    return out[0]


def unpack_uastc_block_to_rgba(data) -> np.ndarray:
    """16-byte UASTC block -> 16 packed RGBA u32 texels (lib.rs:29-31)."""
    return _single(data, "rgba")


def transcode_uastc_block_to_astc(data) -> bytes:
    return _single(data, "astc").tobytes()


def transcode_uastc_block_to_bc7(data) -> bytes:
    return _single(data, "bc7").tobytes()


def transcode_uastc_block_to_etc1(data) -> bytes:
    return _single(data, "etc1").tobytes()


def transcode_uastc_block_to_etc2(data) -> bytes:
    return _single(data, "etc2").tobytes()
