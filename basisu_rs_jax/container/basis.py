""".basis container parsing and file-level orchestration.

Mirrors the reference container layer (src/basis.rs): signature + 77-byte
header with u24 fields, CRC-16/GENIBUS header and data checksums, 23-byte
slice descriptors, and the six `read_to_*` entry points that route slices
through the UASTC or ETC1S back-ends.

Execution model: this layer is pure host code; it slices byte ranges and
dispatches dense block tensors to the device kernels.
"""

from __future__ import annotations

import struct
from dataclasses import dataclass
from enum import IntEnum

import numpy as np

from ..api import BasisError, Image
from ..ops import transcode_blocks
from ..ops.etc1s import run_etc1s_etc1, run_etc1s_rgba
from ..tables import (
    ASTC_BLOCK_SIZE,
    BC7_BLOCK_SIZE,
    ETC1_BLOCK_SIZE,
    ETC2_BLOCK_SIZE,
    UASTC_BLOCK_SIZE,
)
from .crc import crc16
from .etc1s_frontend import Etc1sDecoder

SIG = 0x4273
ETC1S_BLOCK_SIZE = 8


class TextureType(IntEnum):
    Type2D = 0
    Type2DArray = 1
    CubemapArray = 2
    VideoFrames = 3
    Volume = 4


class TexFormat(IntEnum):
    ETC1S = 0
    UASTC4x4 = 1


class HeaderFlags(IntEnum):
    ETC1S = 1
    YFlipped = 2
    HasAlphaSlices = 4


class SliceDescFlags(IntEnum):
    HasAlpha = 1
    FrameIsIFrame = 2


def _u24(b: bytes, ofs: int) -> int:
    return b[ofs] | (b[ofs + 1] << 8) | (b[ofs + 2] << 16)


@dataclass
class Header:
    """77-byte .basis file header (reference: basis.rs:417-517)."""

    FILE_SIZE = 77

    sig: int
    ver: int
    header_size: int
    header_crc16: int
    data_size: int
    data_crc16: int
    total_slices: int
    total_images: int
    tex_format: int
    flags: int
    tex_type: int
    us_per_frame: int
    reserved: int
    userdata0: int
    userdata1: int
    total_endpoints: int
    endpoint_cb_file_ofs: int
    endpoint_cb_file_size: int
    total_selectors: int
    selector_cb_file_ofs: int
    selector_cb_file_size: int
    tables_file_ofs: int
    tables_file_size: int
    slice_desc_file_ofs: int
    extended_file_ofs: int
    extended_file_size: int

    @property
    def has_alpha(self) -> bool:
        return bool(self.flags & HeaderFlags.HasAlphaSlices)

    @property
    def has_y_flipped(self) -> bool:
        return bool(self.flags & HeaderFlags.YFlipped)

    def texture_format(self) -> TexFormat:
        try:
            return TexFormat(self.tex_format)
        except ValueError:
            raise BasisError("Unknown texture format") from None

    @classmethod
    def from_file_bytes(cls, b: bytes) -> "Header":
        assert len(b) >= cls.FILE_SIZE
        sig, ver, header_size, header_crc = struct.unpack_from("<4H", b, 0)
        (data_size,) = struct.unpack_from("<I", b, 8)
        (data_crc,) = struct.unpack_from("<H", b, 12)
        total_slices = _u24(b, 14)
        total_images = _u24(b, 17)
        tex_format = b[20]
        (flags,) = struct.unpack_from("<H", b, 21)
        tex_type = b[23]
        us_per_frame = _u24(b, 24)
        reserved, ud0, ud1 = struct.unpack_from("<3I", b, 27)
        (total_endpoints, endpoint_ofs) = struct.unpack_from("<HI", b, 39)
        endpoint_size = _u24(b, 45)
        (total_selectors, selector_ofs) = struct.unpack_from("<HI", b, 48)
        selector_size = _u24(b, 54)
        tables_ofs, tables_size, slice_ofs, ext_ofs, ext_size = struct.unpack_from("<5I", b, 57)
        return cls(
            sig, ver, header_size, header_crc, data_size, data_crc, total_slices,
            total_images, tex_format, flags, tex_type, us_per_frame, reserved, ud0,
            ud1, total_endpoints, endpoint_ofs, endpoint_size, total_selectors,
            selector_ofs, selector_size, tables_ofs, tables_size, slice_ofs,
            ext_ofs, ext_size,
        )


@dataclass
class SliceDesc:
    """23-byte slice descriptor (reference: basis.rs:519-572)."""

    FILE_SIZE = 23

    image_index: int
    level_index: int
    flags: int
    orig_width: int
    orig_height: int
    num_blocks_x: int
    num_blocks_y: int
    file_ofs: int
    file_size: int
    slice_data_crc16: int

    @property
    def has_alpha(self) -> bool:
        return bool(self.flags & SliceDescFlags.HasAlpha)

    def data(self, buf: bytes) -> bytes:
        return buf[self.file_ofs : self.file_ofs + self.file_size]

    @classmethod
    def from_file_bytes(cls, b: bytes) -> "SliceDesc":
        assert len(b) >= cls.FILE_SIZE
        image_index = _u24(b, 0)
        level_index, flags = b[3], b[4]
        ow, oh, nbx, nby = struct.unpack_from("<4H", b, 5)
        fo, fs = struct.unpack_from("<2I", b, 13)
        (crc,) = struct.unpack_from("<H", b, 21)
        return cls(image_index, level_index, flags, ow, oh, nbx, nby, fo, fs, crc)


def check_file_sig(buf: bytes) -> bool:
    return struct.unpack_from("<H", buf, 0)[0] == SIG


def read_header(buf: bytes) -> Header:
    """Parse + validate the header (reference: basis.rs:307-336)."""
    if len(buf) < 2 or not check_file_sig(buf):
        raise BasisError("Sig mismatch, not a Basis Universal file")
    if len(buf) < Header.FILE_SIZE:
        raise BasisError(
            f"Expected at least {Header.FILE_SIZE} byte header, got {len(buf)} bytes"
        )
    header = Header.from_file_bytes(buf)
    if header.header_size != Header.FILE_SIZE:
        raise BasisError(
            f"File specified unexpected header size, expected {Header.FILE_SIZE}, "
            f"got {header.header_size}"
        )
    if crc16(buf[8 : Header.FILE_SIZE]) != header.header_crc16:
        raise BasisError("Header CRC16 failed")
    return header


def check_file_checksum(buf: bytes, header: Header) -> bool:
    return crc16(buf[Header.FILE_SIZE :]) == header.data_crc16


def read_slice_descs(buf: bytes, header: Header) -> list[SliceDesc]:
    start = header.slice_desc_file_ofs
    descs = []
    for i in range(header.total_slices):
        ofs = start + i * SliceDesc.FILE_SIZE
        if len(buf) - ofs < SliceDesc.FILE_SIZE:
            raise BasisError(
                f"Expected {SliceDesc.FILE_SIZE} byte slice desc at pos {ofs}, "
                f"only {len(buf) - ofs} bytes remain"
            )
        descs.append(SliceDesc.from_file_bytes(buf[ofs:]))
    return descs


def make_etc1s_decoder(
    header: Header, buf: bytes, *, endpoint_count_quirk: bool = False
) -> Etc1sDecoder:
    """Build the BasisLZ decoder from header-addressed byte ranges
    (reference: basis.rs:262-298).

    NB: the reference passes `total_selectors` for the endpoint count
    (basis.rs:290, a latent quirk); by default we use `total_endpoints`,
    which is what files produced by the official encoder require.  Pass
    endpoint_count_quirk=True for strict bug-for-bug parity with the
    reference on files where the counts differ (COMPAT.md item 1)."""
    ep = buf[header.endpoint_cb_file_ofs : header.endpoint_cb_file_ofs + header.endpoint_cb_file_size]
    sel = buf[header.selector_cb_file_ofs : header.selector_cb_file_ofs + header.selector_cb_file_size]
    tables = buf[header.tables_file_ofs : header.tables_file_ofs + header.tables_file_size]
    is_video = header.tex_type == TextureType.VideoFrames
    n_endpoints = header.total_selectors if endpoint_count_quirk else header.total_endpoints
    return Etc1sDecoder(
        n_endpoints, header.total_selectors, ep, sel, tables, is_video
    )


def _validated(buf: bytes) -> tuple[Header, list[SliceDesc]]:
    header = read_header(buf)
    if not check_file_checksum(buf, header):
        raise BasisError("Data CRC16 failed")
    return header, read_slice_descs(buf, header)


def _uastc_slice_blocks(desc: SliceDesc, buf: bytes) -> np.ndarray:
    data = np.frombuffer(desc.data(buf), np.uint8)
    if data.size % UASTC_BLOCK_SIZE:
        raise BasisError("data length is not divisible by UASTC block size (16)")
    return data.reshape(-1, UASTC_BLOCK_SIZE)


def _check_errs(err: np.ndarray, blocks: np.ndarray) -> None:
    """Raise with the reference's message for the FIRST failing block.

    The reference's transcode loop (uastc.rs:148-165) aborts read_to_* with
    the first failing block's own error - "invalid mode index" (uastc.rs:336)
    or "block pattern is not valid" (uastc.rs:364), the only two per-block
    Err sites.  The kernels report a boolean per block; the message is
    re-derived host-side from the first failing block's mode code."""
    if err.any():
        from ..ops.dispatch import INVALID_MODE, block_modes

        first = int(np.argmax(err))
        if block_modes(blocks[first : first + 1])[0] == INVALID_MODE:
            raise BasisError("invalid mode index")
        raise BasisError("block pattern is not valid")


def _transcode_uastc_blocks(blocks, target, mesh):
    if mesh is None:
        return transcode_blocks(blocks, target)
    from ..parallel.mesh import sharded_transcode

    return sharded_transcode(blocks, target, mesh)


def _transcode_uastc_slices(descs, buf, target, mesh) -> list[np.ndarray]:
    """Every slice of a file (mip levels, faces, layers) in ONE partitioned
    dispatch, split back per slice: one set of mode launches per file, and
    group sizes that hit the same compiled kernels for every file of one
    shape.  The first failing block in slice order raises, as the
    reference's per-slice loop would (basis.rs:92-260)."""
    parts, length_err = [], None
    for d in descs:
        try:
            parts.append(_uastc_slice_blocks(d, buf))
        except BasisError as e:  # raised after the slices before it
            length_err = e
            break
    out = []
    if parts:
        blocks = np.concatenate(parts)
        out, err = _transcode_uastc_blocks(blocks, target, mesh)
        _check_errs(err, blocks)
        out = np.split(out, np.cumsum([len(b) for b in parts])[:-1])
    if length_err is not None:
        raise length_err
    return out


def _run_etc1s_rgba(endpoints, selectors, ep_idx, sel_idx, alpha_pass, mesh):
    if mesh is None:
        return run_etc1s_rgba(endpoints, selectors, ep_idx, sel_idx, alpha_pass)
    from ..parallel.mesh import sharded_etc1s_transcode

    if alpha_pass is not None:
        return sharded_etc1s_transcode(
            "rgba_alpha", endpoints, selectors, ep_idx, sel_idx, mesh,
            extra_idx=alpha_pass,
        )
    return sharded_etc1s_transcode("rgba", endpoints, selectors, ep_idx, sel_idx, mesh)


def _run_etc1s_etc1(endpoints, selectors, ep_idx, sel_idx, mesh):
    if mesh is None:
        return run_etc1s_etc1(endpoints, selectors, ep_idx, sel_idx)
    from ..parallel.mesh import sharded_etc1s_transcode

    return sharded_etc1s_transcode("etc1", endpoints, selectors, ep_idx, sel_idx, mesh)


def read_to_rgba(buf: bytes, mesh=None):
    """-> (Header, [Image]) of RGBA bytes (reference: basis.rs:8-90).

    mesh: optional jax.sharding.Mesh - device work shards over its block
    axis (parallel/mesh.py); None runs on the default single device."""
    header, descs = _validated(buf)
    fmt = header.texture_format()
    images: list[Image] = []

    if fmt == TexFormat.ETC1S:
        if header.has_alpha and header.total_slices % 2 != 0:
            raise BasisError("File has alpha, but slice count is odd")
        dec = make_etc1s_decoder(header, buf)
        pair = 2 if header.has_alpha else 1
        # The host state machine runs serially per slice (format-mandated),
        # but the codebooks are file-wide: concatenate every slice's index
        # stream and issue ONE device launch per file instead of one per
        # slice (mip tails would otherwise each pay a launch + pow2 pad).
        rgb_descs = []
        ep_parts, sel_parts, a_ep_parts, a_sel_parts = [], [], [], []
        for i in range(0, len(descs), pair):
            rgb_desc = descs[i]
            if header.has_alpha:
                alpha_desc = descs[i + 1]
                if not alpha_desc.has_alpha:
                    raise BasisError("Expected slice with alpha")
                if (
                    alpha_desc.num_blocks_x != rgb_desc.num_blocks_x
                    or alpha_desc.num_blocks_y != rgb_desc.num_blocks_y
                ):
                    raise BasisError("RGB slice and Alpha slice have different dimensions")
                a = dec.decode_slice(
                    alpha_desc.num_blocks_x, alpha_desc.num_blocks_y, alpha_desc.data(buf)
                )
                a_ep_parts.append(a.endpoint_index)
                a_sel_parts.append(a.selector_index)
            s = dec.decode_slice(rgb_desc.num_blocks_x, rgb_desc.num_blocks_y, rgb_desc.data(buf))
            ep_parts.append(s.endpoint_index)
            sel_parts.append(s.selector_index)
            rgb_descs.append(rgb_desc)
        if rgb_descs:
            alpha_pass = None
            if header.has_alpha:
                alpha_pass = (np.concatenate(a_ep_parts), np.concatenate(a_sel_parts))
            texels = _run_etc1s_rgba(
                dec.endpoints,
                dec.selectors,
                np.concatenate(ep_parts),
                np.concatenate(sel_parts),
                alpha_pass,
                mesh,
            )
            ofs = 0
            for rgb_desc in rgb_descs:
                n = rgb_desc.num_blocks_x * rgb_desc.num_blocks_y
                data = _blocks_to_image_bytes(texels[ofs : ofs + n], rgb_desc.num_blocks_x)
                ofs += n
                # Rows of the decoded buffer are 4*num_blocks_x pixels wide
                # (mod.rs:131); we report that true byte stride rather than
                # the reference's orig_width-based value (basis.rs:46).
                images.append(
                    Image(
                        w=rgb_desc.orig_width,
                        h=rgb_desc.orig_height,
                        stride=4 * 4 * rgb_desc.num_blocks_x,
                        data=data,
                    )
                )
        return header, images

    if fmt == TexFormat.UASTC4x4:
        for desc, texels in zip(descs, _transcode_uastc_slices(descs, buf, "rgba", mesh)):
            data = _blocks_to_image_bytes(texels, desc.num_blocks_x)
            images.append(
                Image(
                    w=desc.orig_width,
                    h=desc.orig_height,
                    stride=4 * desc.num_blocks_x * 4,
                    data=data,
                )
            )
        return header, images

    raise BasisError("unsupported texture format")


def _blocks_to_image_bytes(texels: np.ndarray, num_blocks_x: int) -> np.ndarray:
    """[N,16] packed RGBA texel words -> flat RGBA byte image in raster order."""
    n = texels.shape[0]
    nby = n // num_blocks_x
    t = texels.reshape(nby, num_blocks_x, 4, 4)  # [by, bx, y, x]
    t = t.transpose(0, 2, 1, 3).reshape(nby * 4, num_blocks_x * 4)
    return t.astype("<u4").view(np.uint8).reshape(-1)


def _read_to_blocks(buf: bytes, target: str, block_size: int, mesh=None):
    """Shared UASTC path of read_to_{etc1,etc2,astc,bc7} (basis.rs:92-260)."""
    header, descs = _validated(buf)
    fmt = header.texture_format()
    images: list[Image] = []

    if fmt == TexFormat.UASTC4x4:
        for desc, out in zip(descs, _transcode_uastc_slices(descs, buf, target, mesh)):
            images.append(
                Image(
                    w=desc.orig_width,
                    h=desc.orig_height,
                    stride=block_size * desc.num_blocks_x,
                    data=out.reshape(-1),
                )
            )
        return header, images
    return header, None


def read_to_etc1(buf: bytes, mesh=None) -> list[Image]:
    header, images = _read_to_blocks(buf, "etc1", ETC1_BLOCK_SIZE, mesh)
    if images is not None:
        return images
    if header.texture_format() != TexFormat.ETC1S:
        raise BasisError("unsupported texture format")
    if header.has_alpha and header.total_slices % 2 != 0:
        raise BasisError("File has alpha, but slice count is odd")
    descs = read_slice_descs(buf, header)
    dec = make_etc1s_decoder(header, buf)
    images = []
    # one device launch per file: the codebooks are shared, so every
    # slice's index stream concatenates into a single kernel dispatch
    ep_parts, sel_parts = [], []
    for desc in descs:
        s = dec.decode_slice(desc.num_blocks_x, desc.num_blocks_y, desc.data(buf))
        ep_parts.append(s.endpoint_index)
        sel_parts.append(s.selector_index)
    if descs:
        out = _run_etc1s_etc1(
            dec.endpoints,
            dec.selectors,
            np.concatenate(ep_parts),
            np.concatenate(sel_parts),
            mesh,
        )
        ofs = 0
        for desc in descs:
            n = desc.num_blocks_x * desc.num_blocks_y
            images.append(
                Image(
                    w=desc.orig_width,
                    h=desc.orig_height,
                    stride=ETC1S_BLOCK_SIZE * desc.num_blocks_x,
                    data=np.ascontiguousarray(out[ofs : ofs + n].astype("<u4"))
                    .view(np.uint8)
                    .reshape(-1),
                )
            )
            ofs += n
    return images


def read_to_etc2(buf: bytes, mesh=None) -> list[Image]:
    header, images = _read_to_blocks(buf, "etc2", ETC2_BLOCK_SIZE, mesh)
    if images is None:
        raise BasisError("unsupported texture format")
    return images


def read_to_astc(buf: bytes, mesh=None) -> list[Image]:
    header, images = _read_to_blocks(buf, "astc", ASTC_BLOCK_SIZE, mesh)
    if images is None:
        raise BasisError("unsupported texture format")
    return images


def read_to_bc7(buf: bytes, mesh=None) -> list[Image]:
    header, images = _read_to_blocks(buf, "bc7", BC7_BLOCK_SIZE, mesh)
    if images is None:
        raise BasisError("unsupported texture format")
    return images


def read_to_uastc(buf: bytes) -> list[Image]:
    """Raw UASTC block passthrough (reference: basis.rs:175-202)."""
    header, descs = _validated(buf)
    if header.texture_format() != TexFormat.UASTC4x4:
        raise BasisError("unsupported texture format")
    images = []
    for desc in descs:
        images.append(
            Image(
                w=desc.orig_width,
                h=desc.orig_height,
                stride=UASTC_BLOCK_SIZE * desc.num_blocks_x,
                data=np.frombuffer(desc.data(buf), np.uint8).copy(),
            )
        )
    return images
