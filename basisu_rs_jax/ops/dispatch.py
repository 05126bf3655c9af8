"""Batch transcode dispatch: host-side mode partitioning + per-mode kernels.

The execution model (SURVEY.md section 7): blocks are independent
16-byte records, so a batch is partitioned by UASTC mode on host (a cheap
numpy pass over the first byte), each contiguous mode group runs through a
mode-specialized jitted kernel (all bit offsets static), and results scatter
back into place.  This replaces the reference's sequential per-block loop
(src/uastc.rs:157-165) with data-parallel device execution.

Two paths are exposed:
  - `transcode_blocks`: numpy in/out, partitioned per-mode (the fast path)
  - `transcode_all_modes_fn`: a single jittable function covering all 19
    modes via masked select (used for whole-graph jit/sharding entry points)
"""

from __future__ import annotations

from functools import lru_cache

import jax
import jax.numpy as jnp
import numpy as np

from ..tables import MODES, np_tables
from .bits import bytes_from_lanes_np, lanes_from_bytes_np

INVALID_MODE = 19

# target -> (per-mode lane fn, output word count)
#   lane fn: (cfg, lanes[N,4]) -> (out[N, W], err[N])
_REGISTRY: dict = {}


def _ensure_registered() -> None:
    if _REGISTRY:
        return
    from . import astc, bc7, etc, rgba

    # one dict.update: a thread that finds the registry non-empty never
    # sees it half filled
    _REGISTRY.update({
        "rgba": (rgba.uastc_to_rgba_mode, 16),
        "bc7": (bc7.uastc_to_bc7_mode, 4),
        "astc": (astc.uastc_to_astc_mode, 4),
        "etc1": (etc.uastc_to_etc1_mode, 2),
        "etc2": (etc.uastc_to_etc2_mode, 4),
    })


def block_modes(blocks_u8: np.ndarray) -> np.ndarray:
    """UASTC mode id (0..18, or 19=invalid) per block, from the 7-bit code."""
    lut = np_tables()["MODE_LUT"]
    return lut[np.asarray(blocks_u8, np.uint8)[:, 0] & 0x7F]


@lru_cache(maxsize=None)
def _mode_kernel(target: str, mode_id: int):
    """Jitted uint32[N,4] -> (uint32[N,W], err bool[N]) for one (target,
    mode): the lane function with every bit offset static, left to XLA to
    fuse (its constant tables become module constants)."""
    _ensure_registered()
    fn, _ = _REGISTRY[target]
    cfg = MODES[mode_id]

    def stacked(lanes):
        words, err = fn(cfg, lanes)
        return jnp.stack(words, axis=-1), err

    return jax.jit(stacked)


def _bucket(n: int) -> int:
    """Pad group sizes to power-of-two buckets to bound recompilation."""
    size = 8
    while size < n:
        size *= 2
    return size


def partitioned_transcode(blocks_u8, target: str, pad_group, run_group):
    """Shared host orchestration for the partitioned paths (plain and
    mesh-sharded): partition by mode, zero-pad each group via pad_group(m),
    dispatch all groups asynchronously through run_group(mode_id, group) ->
    (out, err) device arrays, then scatter results back into original block
    order.  Output dtype rule: uint32 texel words for 'rgba', block bytes
    otherwise."""
    _ensure_registered()
    _, out_words = _REGISTRY[target]
    blocks_u8 = np.ascontiguousarray(blocks_u8, np.uint8).reshape(-1, 16)
    n = blocks_u8.shape[0]
    modes = block_modes(blocks_u8)
    lanes = lanes_from_bytes_np(blocks_u8, 4)

    out = np.zeros((n, out_words), np.uint32)
    err = modes == INVALID_MODE

    pending = []
    for mode_id in np.unique(modes):
        if mode_id == INVALID_MODE:
            continue
        idx = np.nonzero(modes == mode_id)[0]
        m = len(idx)
        group = np.zeros((pad_group(m), 4), np.uint32)
        group[:m] = lanes[idx]
        o, e = run_group(int(mode_id), group)
        pending.append((idx, m, o, e))

    for idx, m, o, e in pending:
        out[idx] = np.asarray(o)[:m]
        err[idx] |= np.asarray(e)[:m]

    if target == "rgba":
        return out, err
    return bytes_from_lanes_np(out), err


def transcode_blocks(blocks_u8, target: str):
    """numpy uint8 [N,16] UASTC blocks -> (out, err) numpy arrays.

    out: uint32 [N,16] for target 'rgba', else uint8 [N, 4*W] block bytes.
    err: bool [N], True where the reference would return Err (invalid mode
    or pattern index).

    All mode groups are dispatched asynchronously before any result is
    pulled back, so device work overlaps across groups.
    """
    return partitioned_transcode(
        blocks_u8,
        target,
        _bucket,
        lambda mode_id, group: _mode_kernel(target, mode_id)(group),
    )


@lru_cache(maxsize=None)
def transcode_all_modes_fn(target: str):
    """A single jittable fn: lanes uint32[N,4] -> (out uint32[N,W], err[N]).

    Computes every mode's result and selects by the per-block mode id.  This
    is ~19x the arithmetic of the partitioned path but forms one static graph,
    which is what jit/pjit entry points and tiny batches want.
    """
    _ensure_registered()
    fn, out_words = _REGISTRY[target]
    lut = jnp.asarray(np_tables()["MODE_LUT"].astype(np.int32))

    def run(lanes):
        mode = jnp.take(lut, (lanes[:, 0] & 0x7F).astype(jnp.int32), axis=0)
        out = jnp.zeros((lanes.shape[0], out_words), jnp.uint32)
        err = mode == INVALID_MODE
        for cfg in MODES:
            words, e = fn(cfg, lanes)
            sel = mode == cfg.id
            out = jnp.where(sel[:, None], jnp.stack(words, axis=-1), out)
            err = jnp.where(sel, e, err)
        return out, err

    return run
