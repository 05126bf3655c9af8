"""CLI smoke tests (in-process; conftest already forces the CPU backend)."""

import json

import numpy as np

from basisu_rs_jax.__main__ import main
from basisu_rs_jax.container.writer import write_uastc_basis


def _make_file(tmp_path, golden):
    buf = write_uastc_basis(
        [dict(blocks=golden["bc7_in"][:24], nbx=6, nby=4, orig_width=24, orig_height=16)]
    )
    f = tmp_path / "t.basis"
    f.write_bytes(buf)
    return f


def test_cli_info(tmp_path, golden, capsys):
    f = _make_file(tmp_path, golden)
    assert main(["info", str(f)]) == 0
    out = json.loads(capsys.readouterr().out)
    assert out["format"] == "UASTC4x4"
    assert out["data_crc_ok"] is True
    assert out["slices"][0]["blocks"] == [6, 4]


def test_cli_transcode(tmp_path, golden, capsys):
    f = _make_file(tmp_path, golden)
    out_dir = tmp_path / "out"
    assert main(["transcode", str(f), "--target", "bc7", "-o", str(out_dir)]) == 0
    data = np.fromfile(out_dir / "t_0.bc7.bin", np.uint8).reshape(-1, 16)
    from basisu_rs_jax.ops import transcode_blocks

    expected, _ = transcode_blocks(golden["bc7_in"][:24], "bc7")
    np.testing.assert_array_equal(data, expected)
    meta = json.loads((out_dir / "t_0.bc7.json").read_text())
    assert meta == {"w": 24, "h": 16, "stride": 96, "target": "bc7"}


def test_cli_transcode_mesh(tmp_path, golden):
    """--mesh N shards the transcode over an N-device mesh, bit-exactly."""
    f = _make_file(tmp_path, golden)
    out_dir = tmp_path / "out_mesh"
    assert main(
        ["transcode", str(f), "--target", "bc7", "--mesh", "8", "-o", str(out_dir)]
    ) == 0
    data = np.fromfile(out_dir / "t_0.bc7.bin", np.uint8).reshape(-1, 16)
    from basisu_rs_jax.ops import transcode_blocks

    expected, _ = transcode_blocks(golden["bc7_in"][:24], "bc7")
    np.testing.assert_array_equal(data, expected)


def test_cli_transcode_mesh_too_large_errors(tmp_path, golden, capsys):
    """--mesh N beyond the attached device count must error out, never
    silently transcode on virtual CPU devices."""
    f = _make_file(tmp_path, golden)
    rc = main(["transcode", str(f), "--target", "bc7", "--mesh", "999", "-o", str(tmp_path)])
    assert rc == 2
    err = capsys.readouterr().err
    assert "--mesh 999" in err and "999-device mesh" in err
