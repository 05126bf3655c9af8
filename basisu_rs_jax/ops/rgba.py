"""UASTC -> RGBA32 unpack, vectorized per mode.

Mirrors `decode_block_to_rgba` (reference: src/uastc.rs:237-327): decode mode
fields, dequantize endpoints/weights, then per-texel fixed-point ASTC
interpolation with single/dual-plane routing and multi-subset pattern lookup.
Output texels are packed little-endian RGBA words (Color32::to_rgba_u32,
src/color.rs:22-24).
"""

from __future__ import annotations

import jax.numpy as jnp

from ..tables import ModeCfg
from .bits import lane_shape, U32
from .uastc_decode import (
    assemble_endpoint_pairs,
    decode_fields,
    decode_mode8_rgba,
    interp_eval,
    interp_hoist,
    subsets_for_texels,
    unquant_weight,
)

I32 = jnp.int32


def pack_rgba(r, g, b, a):
    return (
        r.astype(U32)
        | (g.astype(U32) << U32(8))
        | (b.astype(U32) << U32(16))
        | (a.astype(U32) << U32(24))
    )


def uastc_to_rgba_channels(cfg: ModeCfg, lanes, need_alpha: bool = True):
    """Returns (texels, err): texels = list of 16 per-texel [r,g,b,a] int32[N].

    need_alpha=False skips the per-texel alpha interpolation entirely
    (texels carry None in slot 3) - the ETC1 target never reads it."""
    if cfg.id == 8:
        rgba = decode_mode8_rgba(lanes)
        err = jnp.zeros(lane_shape(lanes), bool)
        return [rgba] * 16, err

    f = decode_fields(cfg, lanes)
    wq = [unquant_weight(w, cfg.weight_bits) for w in f.weights]
    pairs = assemble_endpoint_pairs(cfg, f.endpoints)

    # Channels that share endpoint *objects* are trace-time dedupable:
    # assemble_endpoint_pairs reuses one `full` array for RGB alpha and the
    # same luminance arrays across LA's r/g/b, so an identity-keyed memo
    # folds their interpolations into one (or none: equal endpoints make
    # the ASTC lerp the identity - pinned exhaustively in test_tables).
    # The caches keep the keyed operands alive so the id() keys can't be
    # reused by a freed array within a texel's lifetime.
    #
    # The (L0, D) halves of the factored lerp (interp_hoist) are per-BLOCK
    # quantities: `pre` hoists them once per endpoint pair instead of once
    # per texel, leaving one multiply + add + shift per texel.
    pre = {}

    def interp(cache, l, h, w):
        if l is h:
            return l
        pkey = (id(l), id(h))
        if pkey not in pre:
            pre[pkey] = (*interp_hoist(l, h), l, h)
        L0, D, _, _ = pre[pkey]
        key = (id(l), id(h), id(w))
        if key not in cache:
            cache[key] = (interp_eval(L0, D, w), w)
        return cache[key][0]

    # LA dual-plane forces compsel = alpha (uastc.rs:343-350, mirrored by
    # decode_compsel): the plane routing is static, no per-channel select.
    from ..tables.modes import LA

    static_cs = 3 if (cfg.plane_count == 2 and cfg.format == LA) else None
    channels = (0, 1, 2, 3) if need_alpha else (0, 1, 2)

    def pad(px):
        return px if need_alpha else px + [None]

    texels = []
    if cfg.subset_count == 1:
        e0, e1 = pairs[0]
        if cfg.plane_count == 1:
            for i in range(16):
                w = wq[i]
                cache = {}
                texels.append(pad([interp(cache, e0[c], e1[c], w) for c in channels]))
        else:
            # compsel masks are per-block: hoist the four compares out of the
            # texel loop
            cs_mask = (
                None if static_cs is not None else [f.compsel == c for c in range(4)]
            )
            for i in range(16):
                w0, w1 = wq[2 * i], wq[2 * i + 1]
                px = []
                cache = {}
                for c in channels:
                    if e0[c] is e1[c]:
                        px.append(e0[c])
                        continue
                    if static_cs is not None:
                        wc = w1 if c == static_cs else w0
                    else:
                        wc = jnp.where(cs_mask[c], w1, w0)
                    px.append(interp(cache, e0[c], e1[c], wc))
                texels.append(pad(px))
    else:
        subsets = subsets_for_texels(cfg, f.pat)
        # hoist the per-subset (L0, D) factored-lerp halves once per block;
        # the per-texel where-chains then select between these instead of
        # the raw endpoints, leaving one multiply + add + shift per texel
        hoisted = [
            [interp_hoist(pairs[s][0][c], pairs[s][1][c]) for c in range(4)]
            for s in range(cfg.subset_count)
        ]
        L0s = [[hoisted[s][c][0] for c in range(4)] for s in range(cfg.subset_count)]
        Ds = [[hoisted[s][c][1] for c in range(4)] for s in range(cfg.subset_count)]
        for i in range(16):
            s_i = subsets[i]
            # one subset-mask set per texel, shared by every channel's
            # where-chain (and by both lerp halves)
            s_mask = [s_i == s for s in range(1, cfg.subset_count)]
            w = wq[i]
            px = []
            for c in channels:
                if all(
                    pairs[s][k][c] is pairs[0][0][c]
                    for s in range(cfg.subset_count)
                    for k in (0, 1)
                ):
                    px.append(pairs[0][0][c])  # constant channel (RGB alpha)
                    continue
                # per-channel where-chains are fresh objects - no cross-
                # channel sharing to memoize here
                L0c = L0s[0][c]
                Dc = Ds[0][c]
                for s in range(1, cfg.subset_count):
                    L0c = jnp.where(s_mask[s - 1], L0s[s][c], L0c)
                    Dc = jnp.where(s_mask[s - 1], Ds[s][c], Dc)
                px.append(interp_eval(L0c, Dc, w))
            texels.append(pad(px))
    return texels, f.err


def uastc_to_rgba_mode(cfg: ModeCfg, lanes):
    """uint32[N,4] UASTC lanes -> (list of 16 packed RGBA texel words, err[N])."""
    texels, err = uastc_to_rgba_channels(cfg, lanes)
    return [pack_rgba(*px) for px in texels], err
