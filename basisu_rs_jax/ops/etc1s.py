"""ETC1S device back-end: codebook tables + per-texel gathers.

Consumes the dense tensors emitted by the host front-end
(container/etc1s_frontend.py): endpoint codebook [E,4] (r5,g5,b5,inten3),
selector codebook [S,4] row bytes, and per-block (endpoint, selector) index
streams.  Mirrors the per-block closures of the reference:
  - RGBA back-end: src/basis_lz/mod.rs:97-151
  - ETC1 back-end: src/basis_lz/mod.rs:153-186
"""

from __future__ import annotations

from functools import lru_cache

import jax
import jax.numpy as jnp
import numpy as np

from ..tables import np_tables
from .bits import U32
from .dispatch import _bucket
from .etc import color_5_to_8, etc1_palette

I32 = jnp.int32


def selector_wire_words_np(selector_rows: np.ndarray) -> np.ndarray:
    """Precompute the 32-bit ETC1 wire word per selector codebook entry.

    selector_rows: uint8 [S, 4], row y holds x's 2-bit value at bits 2x.
    Wire format per Selector::set_selector (etc.rs:374-393)."""
    sel_to_etc1 = np_tables()["SELECTOR_ID_TO_ETC1"].astype(np.uint32)
    rows = selector_rows.astype(np.uint32)
    out = np.zeros(rows.shape[0], np.uint32)
    for x in range(4):
        for y in range(4):
            val = (rows[:, y] >> (2 * x)) & 3
            mod_id = sel_to_etc1[val]
            pid = x * 4 + y
            ms_byte = 1 - pid // 8
            ls_byte = ms_byte + 2
            bit = pid % 8
            out |= (mod_id >> 1) << (8 * ms_byte + bit)
            out |= (mod_id & 1) << (8 * ls_byte + bit)
    return out


def _codebook_tables(endpoints, selectors):
    """Per-entry tables, built once per launch over the codebooks rather
    than once per block:
      rgb  uint32 [E*4]: packed R | G<<8 | B<<16 of entry e's palette level
           k at e*4 + k (etc.rs:420-431);
      selw uint32 [S]: each selector row's 4 bytes packed little-endian, so
           texel t = 4y + x has its 2-bit level at bits 2t."""
    ep = endpoints.astype(I32)
    pal = etc1_palette([color_5_to_8(ep[:, c]) for c in range(3)], ep[:, 3])
    rgb = jnp.stack(
        [p[0].astype(U32) | (p[1].astype(U32) << 8) | (p[2].astype(U32) << 16) for p in pal],
        axis=-1,
    ).reshape(-1)
    s = selectors.astype(U32)
    selw = s[:, 0] | (s[:, 1] << 8) | (s[:, 2] << 16) | (s[:, 3] << 24)
    return rgb, selw


def _texel_values(table, selw, ep_idx, sel_idx):
    """-> [N, 16]: table[ep_idx*4 + level of texel t] per block.  The
    front-end checks every index against its codebook, so the gathers
    clip: jnp.take's default "fill" writes an [N, 16] bounds mask through
    device memory."""
    rows = jnp.take(selw, sel_idx, axis=0, mode="clip")
    level = (rows[:, None] >> (2 * jnp.arange(16, dtype=U32))) & U32(3)
    return jnp.take(table, ep_idx[:, None] * 4 + level.astype(I32), axis=0, mode="clip")


def etc1s_rgba_kernel(endpoints, selectors, ep_idx, sel_idx):
    """-> uint32 [N, 16] packed RGBA texels (alpha = 255; mod.rs:97-151)."""
    rgb, selw = _codebook_tables(endpoints, selectors)
    return _texel_values(rgb | U32(0xFF000000), selw, ep_idx, sel_idx)


def etc1s_alpha_kernel(endpoints, selectors, ep_idx, sel_idx):
    """-> uint32 [N, 16] alpha bytes: the G channel of the selected palette
    color (mod.rs:139-143)."""
    rgb, selw = _codebook_tables(endpoints, selectors)
    return _texel_values((rgb >> 8) & U32(0xFF), selw, ep_idx, sel_idx)


def etc1s_etc1_kernel(endpoints, selector_wire, ep_idx, sel_idx):
    """-> uint32 [N, 2] ETC1 block lanes (mod.rs:163-181)."""
    ep = jnp.take(endpoints.astype(I32), ep_idx, axis=0)
    inten = ep[:, 3].astype(U32)
    lane0 = (
        (ep[:, 0].astype(U32) << 3)
        | ((ep[:, 1].astype(U32) << 3) << 8)
        | ((ep[:, 2].astype(U32) << 3) << 16)
        | (((inten << 5) | (inten << 2) | U32(0b11)) << 24)
    )
    lane1 = jnp.take(selector_wire, sel_idx, axis=0)
    return jnp.stack([lane0, lane1], axis=-1)


def etc1s_rgba_alpha_kernel(endpoints, selectors, ep_idx, sel_idx, a_ep_idx, a_sel_idx):
    """Paired RGB + alpha slices -> uint32 [N, 16] final packed RGBA: the
    alpha byte is the G channel of the alpha slice's palette color
    (basis.rs:26-50, mod.rs:139-143).  One jit: a few small fusions build
    the codebook tables, and the two gathers and their OR form the fusion
    that writes the output, so no [N, 16] intermediate reaches device
    memory (PERF.md, ETC1S pairing)."""
    rgb, selw = _codebook_tables(endpoints, selectors)
    return (_texel_values(rgb, selw, ep_idx, sel_idx)
            | _texel_values((rgb & U32(0xFF00)) << 16, selw, a_ep_idx, a_sel_idx))


# kind -> (kernel, output words per block); the kernel takes the endpoint
# codebook, the selector table (row bytes, or ETC1 wire words for 'etc1')
# and one (ep_idx, sel_idx) pair per slice it reads
KERNELS = {
    "rgba": (etc1s_rgba_kernel, 16),
    "alpha": (etc1s_alpha_kernel, 16),
    "etc1": (etc1s_etc1_kernel, 2),
    "rgba_alpha": (etc1s_rgba_alpha_kernel, 16),
}


@lru_cache(maxsize=None)
def _jitted(kind):
    return jax.jit(KERNELS[kind][0])


def pad_rows(a, rows: int, dtype):
    """Zero-pad `a` along axis 0 to `rows` (codebooks and index streams are
    padded to power-of-two buckets so varied file sizes hit a bounded set
    of compiled shapes; padded indices read entry 0 and are sliced off)."""
    a = np.asarray(a)
    out = np.zeros((rows,) + a.shape[1:], dtype)
    out[: len(a)] = a
    return out


def _run(kind, endpoints_np, table_np, idx_streams, device):
    n = len(idx_streams[0])
    n_pad = _bucket(n)
    out = _jitted(kind)(
        jnp.asarray(pad_rows(endpoints_np, _bucket(len(endpoints_np)), np.uint8)),
        jnp.asarray(pad_rows(table_np, _bucket(len(table_np)), table_np.dtype)),
        *[jnp.asarray(pad_rows(i, n_pad, np.int32)) for i in idx_streams],
    )[:n]
    return out if device else np.asarray(out)


def run_etc1s_rgba(endpoints_np, selectors_np, ep_idx_np, sel_idx_np, alpha_pass=None,
                   device=False):
    """Host entry: decode an ETC1S slice to packed RGBA texels.

    alpha_pass: optional (ep_idx, sel_idx) of the paired alpha slice; its
    G channel replaces the alpha byte (basis.rs:26-50 pairing).
    device=True keeps the result as a device array (no D2H) for pipelines
    whose downstream consumer is on-device - e.g. an ML input pipeline
    feeding decoded texels straight into a training step."""
    selectors_np = np.asarray(selectors_np, np.uint8)
    if alpha_pass is None:
        return _run("rgba", endpoints_np, selectors_np, (ep_idx_np, sel_idx_np), device)
    return _run(
        "rgba_alpha", endpoints_np, selectors_np,
        (ep_idx_np, sel_idx_np, *alpha_pass), device,
    )


def run_etc1s_etc1(endpoints_np, selectors_np, ep_idx_np, sel_idx_np, device=False):
    wire_np = selector_wire_words_np(selectors_np)
    return _run("etc1", endpoints_np, wire_np, (ep_idx_np, sel_idx_np), device)
