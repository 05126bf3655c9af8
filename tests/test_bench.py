"""bench.py and utils/device.py: every measurement names its device, and
no measurement path falls back to the CPU."""

import json
import os
import stat
import subprocess
import sys
from pathlib import Path

import pytest

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))

import bench  # noqa: E402
from basisu_rs_jax.utils import device  # noqa: E402


def test_require_accelerator_refuses_cpu():
    assert device.jax_device()["platform"] == "cpu"
    with pytest.raises(device.NoAcceleratorError, match="never fall back"):
        device.require_accelerator()


def test_bench_refuses_cpu(capsys):
    assert bench.main() == 1
    last = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert last["ok"] is False and "no accelerator" in last["error"]


def test_bench_script_exits_nonzero_on_cpu():
    r = subprocess.run(
        [sys.executable, str(ROOT / "bench.py")], cwd=ROOT,
        env=dict(os.environ, JAX_PLATFORMS="cpu"), capture_output=True, text=True,
        timeout=120,
    )
    assert r.returncode == 1
    assert json.loads(r.stdout.strip().splitlines()[-1])["ok"] is False


def test_nvidia_smi_name_power(tmp_path, monkeypatch):
    """The card line comes verbatim from nvidia-smi's CSV query; without
    nvidia-smi there is no card line, never an invented one."""
    monkeypatch.setenv("PATH", str(tmp_path))
    assert device.nvidia_smi_name_power() is None
    fake = tmp_path / "nvidia-smi"
    fake.write_text(
        "#!/bin/sh\n"
        '[ "$1" = "--query-gpu=name,power.limit" ] && [ "$2" = "--format=csv,noheader" ] '
        '&& echo "NVIDIA H100 80GB HBM3, 700.00 W" && exit 0\nexit 9\n'
    )
    fake.chmod(fake.stat().st_mode | stat.S_IXUSR)
    assert device.nvidia_smi_name_power() == "NVIDIA H100 80GB HBM3, 700.00 W"


def test_golden_batch_tiles_the_mode_mix():
    from basisu_rs_jax.ops.dispatch import _bucket, block_modes
    import numpy as np

    blocks = bench.golden_batch(1 << 19)
    counts = np.bincount(block_modes(blocks), minlength=20)
    assert counts[19] == 0 and (counts[:19] > 0).all()
    # every mode group of the default size lands in one bucket size
    assert {_bucket(c) for c in counts[:19]} == {1 << 15}
