"""models layer: batch transcoder + multi-slice corpus pipeline."""

import numpy as np

from basisu_rs_jax.models import CorpusTranscoder, UastcTranscoder
from basisu_rs_jax.ops import transcode_blocks


def test_uastc_transcoder_matches_dispatch(golden):
    blocks = golden["bc7_in"][:128]
    t = UastcTranscoder("bc7")
    out, err = t.transcode(blocks)
    ref, ref_err = transcode_blocks(blocks, "bc7")
    np.testing.assert_array_equal(out, ref)
    np.testing.assert_array_equal(err, ref_err)
    assert t.profiler.stats["host/partition"].calls == 1


def test_corpus_transcoder_multislice(golden):
    # simulate a mipmapped asset: slices of decreasing size
    blocks = golden["astc_in"]
    slices = [blocks[:96], blocks[96:120], blocks[120:126], blocks[126:128]]
    c = CorpusTranscoder("astc")
    outs = c.transcode_slices(slices)
    ref, _ = transcode_blocks(blocks[:128], "astc")
    got = np.concatenate(outs, axis=0)
    np.testing.assert_array_equal(got, ref)
    assert [len(o) for o in outs] == [96, 24, 6, 2]


def test_etc1s_corpus_transcoder_matches_per_slice():
    """Etc1sCorpusTranscoder: concatenated multi-slice dispatch splits back
    bit-identically to per-slice run_etc1s_* calls, for both targets and
    the paired-alpha RGBA path."""
    from basisu_rs_jax.models import Etc1sCorpusTranscoder
    from basisu_rs_jax.ops.etc1s import run_etc1s_etc1, run_etc1s_rgba

    rng = np.random.default_rng(21)
    E, S = 60, 40
    endpoints = np.zeros((E, 4), np.uint8)
    endpoints[:, :3] = rng.integers(0, 32, (E, 3))
    endpoints[:, 3] = rng.integers(0, 8, E)
    selectors = rng.integers(0, 256, (S, 4)).astype(np.uint8)

    sizes = [200, 50, 12, 1]
    slices = [
        (rng.integers(0, E, n).astype(np.uint16), rng.integers(0, S, n).astype(np.uint16))
        for n in sizes
    ]
    alpha = [
        (rng.integers(0, E, n).astype(np.uint16), rng.integers(0, S, n).astype(np.uint16))
        for n in sizes
    ]

    rgba = Etc1sCorpusTranscoder(endpoints, selectors, "rgba")
    for a_arg in (None, alpha):
        outs = rgba.transcode_slices(slices, a_arg)
        assert [len(o) for o in outs] == sizes
        for (ep, sel), out, i in zip(slices, outs, range(len(sizes))):
            ap = alpha[i] if a_arg is not None else None
            np.testing.assert_array_equal(
                out, run_etc1s_rgba(endpoints, selectors, ep, sel, ap)
            )

    etc1 = Etc1sCorpusTranscoder(endpoints, selectors, "etc1")
    outs = etc1.transcode_slices(slices)
    for (ep, sel), out in zip(slices, outs):
        np.testing.assert_array_equal(out, run_etc1s_etc1(endpoints, selectors, ep, sel))
