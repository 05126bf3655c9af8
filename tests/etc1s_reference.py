"""Per-block ETC1S palette decode, written straight from the reference's
closures (src/basis_lz/mod.rs:97-151): gather the block's endpoint and
selector rows, build its 4-level palette, select per texel.  The device
kernels of ops/etc1s.py build palette tables per codebook entry instead;
this form is the plain reference they are held to."""

import jax.numpy as jnp

from basisu_rs_jax.ops.bits import U32
from basisu_rs_jax.ops.etc import color_5_to_8, etc1_palette

I32 = jnp.int32


def _palette_for_blocks(endpoints, ep_idx):
    """4 levels x 3 channels of int32[N]."""
    ep = jnp.take(jnp.asarray(endpoints).astype(I32), jnp.asarray(ep_idx, I32), axis=0)
    return etc1_palette([color_5_to_8(ep[:, c]) for c in range(3)], ep[:, 3])


def _levels(selectors, sel_idx):
    """-> 16 int32[N] 2-bit levels, texel t = 4y + x."""
    rows = jnp.take(jnp.asarray(selectors).astype(I32), jnp.asarray(sel_idx, I32), axis=0)
    return [(rows[:, y] >> (2 * x)) & 3 for y in range(4) for x in range(4)]


def _select(values, level):
    out = values[0]
    for k in range(1, 4):
        out = jnp.where(level == k, values[k], out)
    return out


def rgba_reference(endpoints, selectors, ep_idx, sel_idx):
    """-> uint32 [N, 16] packed RGBA texels, alpha 255."""
    pal = _palette_for_blocks(endpoints, ep_idx)
    words = [p[0].astype(U32) | (p[1].astype(U32) << 8) | (p[2].astype(U32) << 16)
             | U32(0xFF000000) for p in pal]
    return jnp.stack([_select(words, s) for s in _levels(selectors, sel_idx)], axis=-1)


def alpha_reference(endpoints, selectors, ep_idx, sel_idx):
    """-> uint32 [N, 16]: the G channel of the selected palette color
    (mod.rs:139-143)."""
    pal = _palette_for_blocks(endpoints, ep_idx)
    greens = [p[1].astype(U32) for p in pal]
    return jnp.stack([_select(greens, s) for s in _levels(selectors, sel_idx)], axis=-1)


def rgba_alpha_reference(endpoints, selectors, ep_idx, sel_idx, a_ep_idx, a_sel_idx):
    """RGB slice + paired alpha slice composed on the host (basis.rs:26-50)."""
    rgba = rgba_reference(endpoints, selectors, ep_idx, sel_idx)
    a = alpha_reference(endpoints, selectors, a_ep_idx, a_sel_idx)
    return (rgba & U32(0x00FFFFFF)) | (a << U32(24))
