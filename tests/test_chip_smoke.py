"""chip_smoke.py: its refusal to run without a GPU, and its phases
rehearsed on the CPU at a tiny size (the card runs them at full size)."""

import json
import os
import shutil
import subprocess
import sys
from pathlib import Path

import pytest

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))

import chip_smoke  # noqa: E402

TINY = chip_smoke.Sizes(
    fuzz_uniform=96, fuzz_per_mode=4, codebook=300, etc1s_parity_side=64,
    uastc_textures=2, uastc_side=64, etc1s_textures=1, etc1s_side=32,
)


def _run_script(script: Path, cwd: Path):
    env = dict(os.environ, JAX_PLATFORMS="cpu")
    r = subprocess.run(
        [sys.executable, str(script)], cwd=cwd, env=env,
        capture_output=True, text=True, timeout=120,
    )
    return r.returncode, r.stdout.strip().splitlines()


def test_refuses_cpu_only_run():
    rc, lines = _run_script(ROOT / "chip_smoke.py", ROOT)
    assert rc != 0
    last = json.loads(lines[-1])
    assert last["ok"] is False and last["device"]["platform"] == "cpu"


def test_refuses_outside_the_repo(tmp_path):
    shutil.copy(ROOT / "chip_smoke.py", tmp_path)
    rc, lines = _run_script(tmp_path / "chip_smoke.py", tmp_path)
    assert rc != 0
    assert json.loads(lines[-1])["ok"] is False


def test_mip_chain_block_count():
    levels = chip_smoke.mip_chain(2048)
    assert levels[0] == (2048, 2048, 512, 512) and levels[-1] == (1, 1, 1, 1)
    assert sum(nbx * nby for *_, nbx, nby in levels) == 349_527


@pytest.mark.parametrize("phase", ["golden", "fuzz", "etc1s", "corpus", "four-cards"])
def test_phase_rehearsal_on_cpu(phase):
    """Each phase at a tiny size on the CPU (four-cards on 4 of the 8
    virtual devices), warm-ups included."""
    sys.path.insert(0, str(ROOT / "tests"))
    runner = chip_smoke.Runner(None)
    data = {}
    if phase in ("corpus", "four-cards"):
        assert runner.phase("corpus-data", chip_smoke.build_corpus, 7, TINY, data)
    args = {
        "golden": (chip_smoke.phase_golden,),
        "fuzz": (chip_smoke.phase_fuzz, 7, TINY),
        "etc1s": (chip_smoke.phase_etc1s, 7, TINY),
        "corpus": (chip_smoke.phase_corpus, data.get("corpus"), TINY),
        "four-cards": (chip_smoke.phase_four_cards, data.get("corpus"), TINY),
    }[phase]
    warm = {
        "golden": chip_smoke.warm_golden,
        "fuzz": lambda: chip_smoke.warm_fuzz(7, TINY),
        "corpus": lambda: chip_smoke.warm_corpus(data["corpus"]),
        "four-cards": lambda: chip_smoke.warm_four_cards(data["corpus"]),
    }.get(phase)
    assert runner.phase(phase, *args, warm=warm), runner.failed
