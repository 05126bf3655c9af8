"""basisu_rs_jax: a batch Basis Universal texture transcoder on JAX.

A from-scratch rebuild of the basisu_rs reference's capabilities as a batch
transcoder for ML/asset pipelines: .basis container parsing and BasisLZ
entropy decode run on host; the per-4x4-block hot loops (UASTC field decode,
ETC1S dequant, repacking into BC7/ASTC/ETC1/ETC2/RGBA32) run as vectorized
int32 lane kernels compiled by XLA for the accelerator (an NVIDIA GPU),
sharded across devices by slice.

Public API mirrors the reference crate surface (src/lib.rs:20-53):
  block level:  unpack_uastc_block_to_rgba, transcode_uastc_block_to_*
  batch level:  transcode_uastc_blocks (the batch extension)
  file level:   read_to_rgba/etc1/etc2/uastc/astc/bc7, Header, Image
"""

from .api import (
    BasisError,
    Image,
    transcode_uastc_block_to_astc,
    transcode_uastc_block_to_bc7,
    transcode_uastc_block_to_etc1,
    transcode_uastc_block_to_etc2,
    transcode_uastc_blocks,
    unpack_uastc_block_to_rgba,
)
from .container.basis import (
    Header,
    SliceDesc,
    read_to_astc,
    read_to_bc7,
    read_to_etc1,
    read_to_etc2,
    read_to_rgba,
    read_to_uastc,
)

__version__ = "0.1.0"

__all__ = [
    "BasisError",
    "Header",
    "Image",
    "SliceDesc",
    "read_to_astc",
    "read_to_bc7",
    "read_to_etc1",
    "read_to_etc2",
    "read_to_rgba",
    "read_to_uastc",
    "transcode_uastc_block_to_astc",
    "transcode_uastc_block_to_bc7",
    "transcode_uastc_block_to_etc1",
    "transcode_uastc_block_to_etc2",
    "transcode_uastc_blocks",
    "unpack_uastc_block_to_rgba",
]
