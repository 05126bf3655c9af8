"""Corpus pipeline: mixed UASTC/ETC1S corpus, error isolation, resume."""

import numpy as np

from basisu_rs_jax.container.writer import write_etc1s_basis, write_uastc_basis
from basisu_rs_jax.models.pipeline import BasisCorpusPipeline, PipelineState


def _make_corpus(tmp_path, golden):
    paths = []
    # two UASTC files
    for i, n in enumerate((24, 48)):
        buf = write_uastc_basis(
            [dict(blocks=golden["bc7_in"][:n], nbx=n // 4, nby=4,
                  orig_width=n, orig_height=16)]
        )
        p = tmp_path / f"u{i}.basis"
        p.write_bytes(buf)
        paths.append(p)
    # one ETC1S file
    rng = np.random.default_rng(0)
    E, S = 17, 11
    endpoints = np.zeros((E, 4), np.uint8)
    endpoints[:, :3] = rng.integers(0, 32, (E, 3))
    endpoints[:, 3] = rng.integers(0, 8, E)
    selectors = rng.integers(0, 256, (S, 4)).astype(np.uint8)
    n = 6 * 4
    buf = write_etc1s_basis(
        endpoints, selectors,
        [dict(ep_idx=rng.integers(0, E, n).astype(np.uint16),
              sel_idx=rng.integers(0, S, n).astype(np.uint16),
              nbx=6, nby=4, orig_width=24, orig_height=16)],
    )
    p = tmp_path / "e0.basis"
    p.write_bytes(buf)
    paths.append(p)
    # one corrupt file
    bad = tmp_path / "bad.basis"
    bad.write_bytes(b"XX" + buf[2:])
    paths.append(bad)
    return paths


def test_pipeline_rgba_corpus(tmp_path, golden):
    paths = _make_corpus(tmp_path, golden)
    pipe = BasisCorpusPipeline("rgba", workers=2)
    results = list(pipe.run(paths))
    assert len(results) == 3  # corrupt file isolated
    assert len(pipe.errors) == 1 and "bad.basis" in pipe.errors[0][0]
    assert all(r.texels > 0 for r in results)


def test_pipeline_resume(tmp_path, golden):
    paths = _make_corpus(tmp_path, golden)[:3]
    state = PipelineState()
    pipe = BasisCorpusPipeline("bc7", workers=2)
    first = list(pipe.run(paths[:2], state))
    assert len(first) == 2
    # resume: only the ETC1S file remains, and ETC1S->bc7 is unsupported
    # (the reference hits unimplemented! there, basis.rs:258), so it lands
    # in the error list rather than being re-processed.
    rest = list(pipe.run(paths, state))
    assert len(rest) == 0
    assert len(pipe.errors) == 1


def test_pipeline_bc7_matches_direct(tmp_path, golden):
    from basisu_rs_jax.ops import transcode_blocks

    buf = write_uastc_basis(
        [dict(blocks=golden["bc7_in"][:24], nbx=6, nby=4, orig_width=24, orig_height=16)]
    )
    p = tmp_path / "x.basis"
    p.write_bytes(buf)
    pipe = BasisCorpusPipeline("bc7")
    (res,) = list(pipe.run([p]))
    expected, _ = transcode_blocks(golden["bc7_in"][:24], "bc7")
    np.testing.assert_array_equal(res.images[0].data.reshape(-1, 16), expected)


def test_pipeline_mesh_matches_plain(tmp_path, golden):
    """mesh= on the pipeline shards per-file device work, bit-exactly."""
    from basisu_rs_jax.parallel.mesh import make_mesh

    paths = _make_corpus(tmp_path, golden)[:3]
    plain = {r.path: r for r in BasisCorpusPipeline("rgba", workers=2).run(paths)}
    meshed = BasisCorpusPipeline("rgba", workers=2, mesh=make_mesh(8))
    results = list(meshed.run(paths))
    assert len(results) == len(plain) == 3
    for r in results:
        for a, b in zip(r.images, plain[r.path].images):
            np.testing.assert_array_equal(a.data, b.data)


def _rand_etc1s_file(rng, E, S, slice_lens, alpha=False):
    from basisu_rs_jax.models import Etc1sFileWork

    endpoints = np.zeros((E, 4), np.uint8)
    endpoints[:, :3] = rng.integers(0, 32, (E, 3))
    endpoints[:, 3] = rng.integers(0, 8, E)
    selectors = rng.integers(0, 256, (S, 4)).astype(np.uint8)
    slices = [
        (rng.integers(0, E, n).astype(np.int32), rng.integers(0, S, n).astype(np.int32))
        for n in slice_lens
    ]
    alpha_slices = None
    if alpha:
        alpha_slices = [
            (rng.integers(0, E, n).astype(np.int32), rng.integers(0, S, n).astype(np.int32))
            for n in slice_lens
        ]
    return Etc1sFileWork(endpoints, selectors, slices, alpha_slices)


def test_multifile_etc1s_matches_per_file():
    """Cross-file batched ETC1S == per-file transcode, bit-exactly, for both
    targets, mixed codebook sizes and mixed alpha/non-alpha files."""
    from basisu_rs_jax.models import Etc1sCorpusTranscoder, Etc1sMultiCorpusTranscoder

    rng = np.random.default_rng(42)
    files = [
        _rand_etc1s_file(rng, 17, 11, (24, 6), alpha=False),
        _rand_etc1s_file(rng, 33, 29, (40,), alpha=True),
        _rand_etc1s_file(rng, 5, 7, (12, 12, 3), alpha=False),
        _rand_etc1s_file(rng, 64, 48, (16,), alpha=True),
    ]

    for target in ("rgba", "etc1"):
        multi = Etc1sMultiCorpusTranscoder(target).transcode_files(files)
        for fw, got_slices in zip(files, multi):
            per_file = Etc1sCorpusTranscoder(fw.endpoints, fw.selectors, target)
            want = per_file.transcode_slices(
                fw.slices, fw.alpha_slices if target == "rgba" else None
            )
            assert len(got_slices) == len(want)
            for g, w in zip(got_slices, want):
                np.testing.assert_array_equal(np.asarray(g), np.asarray(w))


def test_multifile_etc1s_alpha_mismatch_raises():
    from basisu_rs_jax.api import BasisError
    from basisu_rs_jax.models import Etc1sFileWork, Etc1sMultiCorpusTranscoder

    rng = np.random.default_rng(3)
    fw = _rand_etc1s_file(rng, 9, 9, (8,), alpha=True)
    fw.alpha_slices = [(fw.alpha_slices[0][0][:4], fw.alpha_slices[0][1][:4])]
    try:
        Etc1sMultiCorpusTranscoder("rgba").transcode_files([fw])
        raise AssertionError("expected BasisError")
    except BasisError as e:
        assert "different dimensions" in str(e)


def test_multifile_etc1s_empty_and_selector_mismatch():
    """ADVICE r4: empty corpus returns [] for every target (no concatenate
    crash); a mismatched alpha SELECTOR stream (a[1]) raises the same
    BasisError as a mismatched endpoint stream."""
    from basisu_rs_jax.api import BasisError
    from basisu_rs_jax.models import Etc1sMultiCorpusTranscoder

    for target in ("rgba", "etc1"):
        assert Etc1sMultiCorpusTranscoder(target).transcode_files([]) == []

    rng = np.random.default_rng(4)
    fw = _rand_etc1s_file(rng, 9, 9, (8,), alpha=True)
    a_ep, a_sel = fw.alpha_slices[0]
    fw.alpha_slices = [(a_ep, a_sel[:4])]  # ep stream matches, sel stream short
    try:
        Etc1sMultiCorpusTranscoder("rgba").transcode_files([fw])
        raise AssertionError("expected BasisError")
    except BasisError as e:
        assert "different dimensions" in str(e)


def test_multifile_etc1s_zero_slice_files():
    """A file with no slices answers [] (it must not reach the batcher's
    np.concatenate), both alone and mixed with files that have work —
    outputs for the working files are unaffected and stay in input order."""
    from basisu_rs_jax.models import (
        Etc1sCorpusTranscoder,
        Etc1sFileWork,
        Etc1sMultiCorpusTranscoder,
    )

    rng = np.random.default_rng(11)
    empty = Etc1sFileWork(
        np.zeros((3, 4), np.uint8), np.zeros((3, 4), np.uint8), slices=[]
    )
    full = _rand_etc1s_file(rng, 9, 9, (8, 5), alpha=False)
    for target in ("rgba", "etc1"):
        tr = Etc1sMultiCorpusTranscoder(target)
        assert tr.transcode_files([empty]) == [[]]
        got = tr.transcode_files([empty, full, empty])
        assert got[0] == [] and got[2] == []
        want = Etc1sCorpusTranscoder(full.endpoints, full.selectors, target
                                     ).transcode_slices(full.slices)
        for g, w in zip(got[1], want):
            np.testing.assert_array_equal(np.asarray(g), np.asarray(w))


def test_transcode_async_buckets_group_sizes(golden):
    """Group sizes pad to power-of-two buckets (as dispatch.transcode_blocks
    does), so batches whose mode groups differ in size reuse one compiled
    kernel per bucket instead of compiling per size."""
    from basisu_rs_jax.models import UastcTranscoder
    from basisu_rs_jax.ops.dispatch import _mode_kernel, block_modes

    blocks = golden["bc7_in"][block_modes(golden["bc7_in"]) == 3]  # 32 blocks
    tr = UastcTranscoder("bc7")
    kernel = _mode_kernel("bc7", 3)
    tr.transcode(blocks[:9])  # first use of the 16-block bucket
    before = kernel._cache_size()
    for n in (10, 13, 16):
        res = tr.transcode_async(blocks[:n])
        ((_, m, o, _),) = res.groups
        assert m == n and o.shape == (16, 4)
        out, err = res.gather()
        assert not err.any()
        np.testing.assert_array_equal(out, golden["bc7_out"][block_modes(golden["bc7_in"]) == 3][:n])
    assert kernel._cache_size() == before


def test_multifile_etc1s_device_resident():
    """transcode_files(device=True) returns device arrays (no forced D2H)
    with values identical to the host path."""
    import jax

    from basisu_rs_jax.models import Etc1sMultiCorpusTranscoder

    rng = np.random.default_rng(11)
    files = [_rand_etc1s_file(rng, 17, 11, (24, 6), alpha=False)]
    host = Etc1sMultiCorpusTranscoder("rgba").transcode_files(files)
    dev = Etc1sMultiCorpusTranscoder("rgba").transcode_files(files, device=True)
    for h_slices, d_slices in zip(host, dev):
        for h, d in zip(h_slices, d_slices):
            assert isinstance(d, jax.Array)
            np.testing.assert_array_equal(np.asarray(d), np.asarray(h))
